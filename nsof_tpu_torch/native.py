"""The native event binner (``native/event_binner.cpp``), built with ``g++``
and bound with ctypes.

The port's own loader: it builds the repository's C++ source on first use
into ``build/nsof_tpu_torch/`` beside the CUDA kernels (:data:`_build.
BUILD_DIR`), the file name carrying a hash of the source and the flags.
:func:`bin_events_native` keeps the JAX package's contract (``nsof_tpu/
native/event_binner.py``): the dense per-slice tensors, or None when there
is nothing the C++ path bins.  It also takes the window anchor and count
that the chunked drivers pass (``t_origin``, ``n_slices``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

from nsof_tpu_torch import _build

SOURCE = pathlib.Path(__file__).resolve().parent.parent / "native" / "event_binner.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None


def _lib_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode())
    return _build.BUILD_DIR / f"libevent_binner_{digest.hexdigest()[:16]}.so"


def get_library() -> Optional[ctypes.CDLL]:
    """The loaded binner, compiled first if missing; None when it cannot be
    built or loaded (the reason is in :func:`build_error`).  Tried once per
    process."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            so = _lib_path()
            if not so.exists():
                so.parent.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                               check=True, capture_output=True, text=True, timeout=120)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
        except (OSError, subprocess.SubprocessError) as err:
            stderr = getattr(err, "stderr", None)
            _error = f"{err}{': ' + stderr if stderr else ''}"
            return None
        i32p, i64p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
        u8p, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
        lib.bin_events_dense.argtypes = [i32p, i32p, i32p, i64p, i64, i64, i64, i64, i64,
                                         u8p, u8p, u8p, i32p, i32p]
        lib.bin_events_dense.restype = ctypes.c_int
        _lib = lib
        return _lib


def build_error() -> Optional[str]:
    """Why :func:`get_library` returned None, if it did."""
    return _error


def native_available() -> bool:
    return get_library() is not None


def bin_events_native(x, y, p, t_us, slice_us: int, height: int, width: int,
                      t_origin: Optional[int] = None,
                      n_slices: Optional[int] = None) -> Optional[dict]:
    """Dense per-slice tensors via the C++ binner, or None when it is not
    available or there is nothing it bins (an empty stream without
    ``t_origin``, or no whole window).

    By default windows start at the first event and their count follows the
    stream's span, as in ``bin_events``.  ``t_origin`` anchors them there
    instead and ``n_slices`` fixes their count, as the numpy path does:
    events before ``t_origin`` are dropped, and the C++ binner, which
    anchors at its first event, is given an event at ``t_origin`` outside
    the grid, which it anchors on and then skips.
    """
    lib = get_library()
    if not len(x) == len(y) == len(p) == len(t_us):
        raise ValueError("x, y, p and t_us must have one entry per event")
    t64 = np.ascontiguousarray(t_us, np.int64)
    x32 = np.ascontiguousarray(x, np.int32)
    y32 = np.ascontiguousarray(y, np.int32)
    p32 = np.ascontiguousarray(p, np.int32)
    if lib is None or (t64.size == 0 and t_origin is None):
        return None
    if t_origin is not None:
        keep = t64 >= t_origin
        t64 = np.concatenate([[np.int64(t_origin)], t64[keep]])
        x32 = np.concatenate([[np.int32(-1)], x32[keep]])
        y32 = np.concatenate([[np.int32(-1)], y32[keep]])
        p32 = np.concatenate([[np.int32(-1)], p32[keep]])
    if n_slices is None:
        t_rel_end = int(t64[-1] - t64[0])
        nt = len(range(0, t_rel_end + slice_us, slice_us)) - 1
    else:
        nt = int(n_slices)
    if nt <= 0:
        return None
    h, w = height, width
    counts = np.empty((nt, h, w), np.uint8)
    on = np.empty((nt, h, w), np.uint8)
    off = np.empty((nt, h, w), np.uint8)
    t_first = np.empty(nt, np.int32)
    t_last = np.empty(nt, np.int32)

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    rc = lib.bin_events_dense(
        ptr(x32, ctypes.c_int32), ptr(y32, ctypes.c_int32), ptr(p32, ctypes.c_int32),
        ptr(t64, ctypes.c_int64), x32.size, slice_us, h, w, nt,
        ptr(counts, ctypes.c_uint8), ptr(on, ctypes.c_uint8), ptr(off, ctypes.c_uint8),
        ptr(t_first, ctypes.c_int32), ptr(t_last, ctypes.c_int32),
    )
    if rc != 0:
        return None
    return {
        "counts": counts,
        "on_any": on.astype(bool),
        "off_any": off.astype(bool),
        "t_first": t_first,
        "t_last": t_last,
        "nt": nt,
    }
