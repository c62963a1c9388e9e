"""Builds the port's CUDA kernels and loads them with ctypes.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` launcher and is compiled
on first use, by ``nvcc`` for ``sm_90a``, into its own shared library under
``build/nsof_tpu_torch/`` at the repository root.  A library's file name
carries a hash of its source and flags, so an edited source is rebuilt and
a stale one is never loaded.  :func:`build_all` starts one ``nvcc`` per
source, all at once, and waits for them.

The module also keeps the launch counters: each kernel wrapper adds one to
its entry in :data:`LAUNCHES` where it launches its kernel, and nowhere
else, so a caller can show which kernels a run went through; :data:`COUNTS`
holds the work of steps that launch no kernel of their own.  A source may
hold several launchers (the float32 forms beside the bfloat16 ones), each
with its own counter; K4 also counts which of its two designs each launch
took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "nsof_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no fused multiply-add contraction: the kernels then round like their
    # plain PyTorch versions, which run one operation per rounding
    "--fmad=false",
    # report each kernel's registers, stack frame and spills (BUILD_INFO)
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)
# the sources, csrc/<name>.cu, one library each
KERNELS = (
    "crop_windows", "poly_expansion", "update_matrices_sep",
    "fused_box_update", "update_matrices", "box_solve", "device_scan", "nms",
    "seg_head", "poly_expansion_level", "pyramid_blur", "scatter_window",
)
# one counter per kernel wrapper
LAUNCH_KEYS = (
    "crop_windows",                # K1
    "poly_expansion",              # K2
    "update_matrices_sep",         # K3, bf16 M
    "update_matrices_sep_f32",     # K3, f32 M (kernel_mode='fused_f32')
    "fused_box_update",            # K4, bf16 M
    "fused_box_update_f32",        # K4, f32 M (kernel_mode='fused_f32')
    "fused_box_update_strip",      # K4 launches of either M type on the strip design
    "fused_box_update_tile",       # K4 launches of either M type on the tile design
    "update_matrices_sep_level",   # K5, the pallas_sep route's update
    "box_solve",                   # K6
    "update_matrices",             # K7, the pallas route's update
    "device_scan",                 # K8, the stream's device scan (no TPU kernel)
    "nms",                         # K9, the YOLO post step's NMS (no TPU kernel)
    "seg_head",                    # K10, the main path's seg head (no TPU kernel)
    "poly_expansion_level",        # K11, the level route's expansion (no TPU kernel)
    "pyramid_blur",                # K12, the pyramid's pad and blur (no TPU kernel)
    "scatter_window",              # K13, the seg step's scatter (no TPU kernel)
)

LAUNCHES = {name: 0 for name in LAUNCH_KEYS}
# the work of steps that launch no kernel of their own, counted where it
# is done: the frames the SAM ground-truth step encodes and the box prompts
# it decodes (data/gt_tooling.py::sam_gt_batch); RAFT's refinements whose
# update block ran channels-last (models/raft.py::RAFT.forward); the rows
# the deep ROI steps ran their backend on and the inactive rows they
# skipped (pipelines/deep_flow.py::_deep_roi_gate)
COUNTS = {"sam_frames": 0, "sam_boxes": 0, "raft_update_nhwc": 0, "deep_flow_rows": 0,
          "deep_flow_rows_skipped": 0}
# per source built in this process: ptxas's resource lines of each kernel
BUILD_INFO: dict[str, list[str]] = {}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}
_lock = threading.Lock()


def resolve_device(device) -> "torch.device":
    """The device an entry point runs on: ``device`` if given, else the
    CUDA device.  Raises ``RuntimeError`` when none was given and there is
    no CUDA device — nothing falls back to the CPU unasked."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def reset_launches() -> None:
    """Zero :data:`LAUNCHES` and :data:`COUNTS`."""
    for counter in (LAUNCHES, COUNTS):
        for name in counter:
            counter[name] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return str(pathlib.Path(home) / "bin" / "nvcc")


def _lib_path(name: str, csrc: pathlib.Path = CSRC) -> pathlib.Path:
    src = (csrc / f"{name}.cu").read_bytes()
    for header in sorted(csrc.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build_all(names=KERNELS, csrc: pathlib.Path = CSRC) -> dict[str, float]:
    """Compile every library that is missing, one ``nvcc`` per source of
    ``csrc``, all started together.  Returns the seconds each build took (0
    when the library was already there) and keeps ptxas's resource lines in
    :data:`BUILD_INFO`.  Raises ``RuntimeError`` if a build fails or
    ``nvcc`` cannot be started."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    secs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name, csrc)
        secs[name] = 0.0
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        try:
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        except OSError as err:
            for proc, _, _ in procs.values():
                proc.kill()
                proc.wait()
            raise RuntimeError(
                f"cannot start nvcc ({nvcc}) to build {name}: {err}"
            ) from err
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        BUILD_INFO[name] = [line.strip() for line in log.splitlines()
                            if "Used" in line or "stack frame" in line
                            or "Compiling entry" in line]
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if missing."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as err:
                raise RuntimeError(
                    f"cannot load kernel library {path}: {err}"
                ) from err
            _libs[name] = lib
        return lib


def launcher(name: str, n_ptr: int, n_int: int, symbol: str | None = None,
             n_float: int = 0):
    """The ctypes launcher ``symbol`` (default ``nsof_<name>``) in the
    library of source ``name``: ``n_ptr`` pointers, ``n_int`` ints,
    ``n_float`` floats, then the stream; it returns cudaError_t."""
    symbol = symbol or f"nsof_{name}"
    fn = _fns.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[symbol] = fn
    return fn


def check(status: int, name: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaError_t``."""
    if status != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError_t {status}"
        )


def main(argv=None) -> None:
    """``python -m nsof_tpu_torch._build [--csrc DIR]``: build the kernels
    of ``DIR`` (default: this package's ``csrc``) and print, per source,
    one JSON line with its build seconds and ptxas's resource lines."""
    import argparse
    import json

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--csrc", type=pathlib.Path, default=CSRC)
    args = ap.parse_args(argv)
    names = [n for n in KERNELS if (args.csrc / f"{n}.cu").exists()]
    secs = build_all(names, args.csrc.resolve())
    for name in names:
        print(json.dumps({"source": str(args.csrc / f"{name}.cu"),
                          "seconds": round(secs[name], 3),
                          "ptxas": BUILD_INFO.get(name, [])}), flush=True)


if __name__ == "__main__":
    main()
