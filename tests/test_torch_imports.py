"""The port stands alone: it imports neither ``jax`` nor ``nsof_tpu``, nor
OpenCV, Pillow or ``transformers`` at module level (none is installed beside
its GPU runtime; ``cv2`` is imported only inside the calls that read a
JPEG frame: ``data/scenes.py::_load_cv2``, ``data/gt_tooling.py::_read_rgb``,
and by the visualiser's MP4 writers), runs on the card
unless the caller asks for the CPU (the deep backends included), and a
kernel wrapper on a CUDA tensor launches its kernel or raises."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.config import DATASETS
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.device import event_sim as tev
from nsof_tpu_torch.device import frame_sim as tfs
from nsof_tpu_torch.ops import canny as tcanny
from nsof_tpu_torch.ops import roi as troi
from nsof_tpu_torch.ops.farneback import farneback, farneback_batch
from nsof_tpu_torch.parallel import train as ptrain
from nsof_tpu_torch.data.scenes import SceneData
from nsof_tpu_torch.models.flowformer import FlowFormer, FlowFormerConfig
from nsof_tpu_torch.models.raft import RAFT, RaftConfig
from nsof_tpu_torch.models import yolov8
from nsof_tpu_torch.models import owlvit as towl
from nsof_tpu_torch.models import sam as tsam
from nsof_tpu_torch.data import gt_tooling as tgt
from nsof_tpu_torch.ops import components as tcomp
from nsof_tpu_torch.pipelines import deep_flow as tdeep
from nsof_tpu_torch.pipelines import detection as tdetect
from nsof_tpu_torch.pipelines import prediction as tpred
from nsof_tpu_torch.pipelines import runner as trunner
from nsof_tpu_torch.pipelines import segmentation as tseg
from nsof_tpu_torch.pipelines import separate as tsep
from nsof_tpu_torch.pipelines import stream as tstream
from nsof_tpu_torch.pipelines import tracking as ttrk
from nsof_tpu_torch.pipelines.segmentation import seg_batch_fast
from nsof_tpu_torch.serve import app as tapp
from nsof_tpu_torch.serve.engine import BatchingEngine
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "nsof_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = {"jax", "jaxlib", "nsof_tpu", "flax", "optax"} & set(_imported_roots(path))
    assert not bad, f"{path.name} imports {bad}"


def _image_library_imports(path):
    """(enclosing function or None, root) of each import of ``cv2`` or
    ``PIL`` in ``path``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    found = []

    def visit(node, func):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(child, child.name)
                continue
            names = []
            if isinstance(child, ast.Import):
                names = [a.name for a in child.names]
            elif isinstance(child, ast.ImportFrom) and child.module and child.level == 0:
                names = [child.module]
            found.extend((func, n.split(".")[0]) for n in names
                         if n.split(".")[0] in ("cv2", "PIL"))
            visit(child, func)

    visit(tree, None)
    return found


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_image_library_at_module_level(path):
    """OpenCV and Pillow are not installed beside the port's GPU runtime: no
    module imports them when it is imported, and only ``load_scene`` (the
    reference's JPEG scenes), ``generate_gt_masks``'s reader of a non-PNG
    frame (``_read_rgb``) and the visualiser's MP4 writers
    (``require_cv2``) import ``cv2`` at all."""
    found = _image_library_imports(path)
    rel = str(path.relative_to(ROOT))
    allowed = {"nsof_tpu_torch/data/scenes.py": [("_load_cv2", "cv2")],
               "nsof_tpu_torch/data/gt_tooling.py": [("_read_rgb", "cv2")],
               "nsof_tpu_torch/utils/visualize.py": [("require_cv2", "cv2")]}.get(rel, [])
    assert all(f in allowed for f in found), f"{rel} imports {found}"


TRAINING_FILES = ["train/__init__.py", "train/loss.py", "train/optim.py", "train/trainer.py",
                  "train/curriculum.py", "train/evaluate.py", "parallel/train.py",
                  "data/flow_datasets.py", "data/imgproc.py", "utils/ppm.py"]


@pytest.mark.parametrize("rel", TRAINING_FILES)
def test_training_modules_are_scanned(rel):
    """The training slice's modules are among the files scanned above, and
    import no image library at all (OpenCV's calls are numpy there)."""
    path = ROOT / "nsof_tpu_torch" / rel
    assert path in PORT_FILES
    assert not _image_library_imports(path)
    assert not {"jax", "jaxlib", "nsof_tpu", "flax", "optax", "orbax"} & set(_imported_roots(path))


DETECTION_FILES = ["models/yolov8.py", "pipelines/detection.py", "utils/visualize.py",
                   "utils/colormaps.py", "data/gt_tooling.py", "device/io.py", "cli.py",
                   "models/sam.py", "models/owlvit.py", "ops/resize.py"]


@pytest.mark.parametrize("rel", DETECTION_FILES)
def test_detection_modules_are_scanned(rel):
    """The detection and ground-truth tooling slices' modules are among the
    files scanned above and import no image or plotting library (OpenCV,
    Pillow, matplotlib), no h5py and no ``transformers`` at module level;
    ``utils/visualize.py`` imports ``cv2`` only inside ``require_cv2``, for
    the MP4 writers, and ``data/gt_tooling.py`` only inside ``_read_rgb``,
    for a non-PNG frame (``transformers`` inside the Hugging Face classes)."""
    path = ROOT / "nsof_tpu_torch" / rel
    assert path in PORT_FILES
    tree = ast.parse(path.read_text(), filename=str(path))
    top = set()
    for node in tree.body:
        if isinstance(node, ast.Import):
            top |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            top.add(node.module.split(".")[0])
    assert not {"cv2", "PIL", "matplotlib", "h5py", "ultralytics", "transformers"} & top, top
    allowed = {"utils/visualize.py": [("require_cv2", "cv2")],
               "data/gt_tooling.py": [("_read_rgb", "cv2")]}.get(rel, [])
    assert all(f in allowed for f in _image_library_imports(path))


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import nsof_tpu_torch, nsof_tpu_torch.pipelines.segmentation\n"
        "import nsof_tpu_torch.pipelines.tracking, nsof_tpu_torch.pipelines.prediction\n"
        "import nsof_tpu_torch.ops.farneback_fast, nsof_tpu_torch._build\n"
        "import nsof_tpu_torch.device, nsof_tpu_torch.native, nsof_tpu_torch.ops.canny\n"
        "import nsof_tpu_torch.pipelines.stream, nsof_tpu_torch.pipelines.separate\n"
        "import nsof_tpu_torch.pipelines.runner, nsof_tpu_torch.serve.engine\n"
        "import nsof_tpu_torch.serve.app, nsof_tpu_torch.cli, nsof_tpu_torch.utils.timing\n"
        "import nsof_tpu_torch.utils.flow_viz, nsof_tpu_torch.data.gt_tooling\n"
        "import nsof_tpu_torch.data.scenes, nsof_tpu_torch.models.raft\n"
        "import nsof_tpu_torch.models.convert, nsof_tpu_torch.models.flowformer.convert\n"
        "import nsof_tpu_torch.ops.correlation, nsof_tpu_torch.pipelines.deep_flow\n"
        "import nsof_tpu_torch.train, nsof_tpu_torch.train.curriculum\n"
        "import nsof_tpu_torch.train.evaluate, nsof_tpu_torch.train.trainer\n"
        "import nsof_tpu_torch.parallel.train, nsof_tpu_torch.data.flow_datasets\n"
        "import nsof_tpu_torch.data.imgproc, nsof_tpu_torch.utils.ppm, nsof_tpu_torch.__main__\n"
        "import nsof_tpu_torch.models.yolov8, nsof_tpu_torch.pipelines.detection\n"
        "import nsof_tpu_torch.utils.visualize, nsof_tpu_torch.utils.colormaps\n"
        "import nsof_tpu_torch.models.sam, nsof_tpu_torch.models.owlvit\n"
        "import nsof_tpu_torch.data.gt_tooling, nsof_tpu_torch.ops.resize\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'nsof_tpu', 'cv2', 'PIL', 'matplotlib', 'h5py', 'transformers')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DATASETS["tabletennis"]
    mem = np.zeros((1, 16, 16), np.uint8)
    frames = np.zeros((1, 160, 160), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        seg_batch_fast(mem, frames, frames, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tff.farneback_fast(frames, frames)


ENTRY_POINTS = {
    "farneback": lambda c, m, f, g, **kw: farneback(f[0], f[0], **kw),
    "farneback_batch": lambda c, m, f, g, **kw: farneback_batch(f, f, **kw),
    "seg_batch": lambda c, m, f, g, **kw: tseg.seg_batch(m, f, f, c, **kw),
    "seg_step": lambda c, m, f, g, **kw: tseg.seg_step(m[0], f[0], f[0], c, **kw),
    "seg_step_full": lambda c, m, f, g, **kw: tseg.seg_step_full(f[0], f[0], c, **kw),
    "seg_stages": lambda c, m, f, g, **kw: tseg.seg_stages(c, **kw),
    "tracking_batch_fast":
        lambda c, m, f, g, **kw: ttrk.tracking_batch_fast(m, f, f, c, **kw),
    "tracking_step": lambda c, m, f, g, **kw: ttrk.tracking_step(m[0], f[0], f[0], c, **kw),
    "tracking_step_full": lambda c, m, f, g, **kw: ttrk.tracking_step_full(f[0], f[0], c, **kw),
    "tracking_stages": lambda c, m, f, g, **kw: ttrk.tracking_stages(c, **kw),
    "prediction_batch_fast":
        lambda c, m, f, g, **kw: tpred.prediction_batch_fast(m, f, f, g, c, **kw),
    "prediction_step":
        lambda c, m, f, g, **kw: tpred.prediction_step(m[0], f[0], f[0], g[0], c, **kw),
    "prediction_step_full":
        lambda c, m, f, g, **kw: tpred.prediction_step_full(f[0], f[0], g[0], c, **kw),
    "prediction_stages": lambda c, m, f, g, **kw: tpred.prediction_stages(c, **kw),
    "separate_flow_field":
        lambda c, m, f, g, **kw: tsep.separate_flow_field(m[0], f[0], f[0], c, **kw),
    "seg_step_separate":
        lambda c, m, f, g, **kw: tsep.seg_step_separate(m[0], f[0], f[0], c, **kw),
    "tracking_step_separate":
        lambda c, m, f, g, **kw: tsep.tracking_step_separate(m[0], f[0], f[0], c, **kw),
    "prediction_step_separate":
        lambda c, m, f, g, **kw: tsep.prediction_step_separate(m[0], f[0], f[0], g[0], c, **kw),
    "canny_edges": lambda c, m, f, g, **kw: tcanny.canny_edges(m[0], **kw),
    "canny_roi_boxes": lambda c, m, f, g, **kw: tcanny.canny_roi_boxes(m[0], 160, 160, 10, 10,
                                                                       **kw),
    "compress_frames": lambda c, m, f, g, **kw: tfs.compress_frames(f, 10, 10, **kw),
    "simulate_frames": lambda c, m, f, g, **kw: tfs.simulate_frames(m.repeat(2, 0), SIM, **kw),
    "simulate_frames_fast":
        lambda c, m, f, g, **kw: tfs.simulate_frames_fast(m.repeat(2, 0), SIM, **kw),
    "simulate_events": lambda c, m, f, g, **kw: tev.simulate_events(BINNED, **kw),
    "simulate_events_stream": lambda c, m, f, g, **kw: tev.simulate_events_stream(
        *([np.array([1, 2])] * 3), np.array([0, 1500]), **kw),
    "stream_masks": lambda c, m, f, g, **kw: tstream.stream_masks(f.repeat(2, 0), c, SIM, **kw),
    "stream_masks_chunked":
        lambda c, m, f, g, **kw: tstream.stream_masks_chunked(f.repeat(3, 0), c, SIM, 1, **kw),
    "stream_masks_from_events": lambda c, m, f, g, **kw: tstream.stream_masks_from_events(
        *([np.array([1, 2])] * 3), np.array([0, 1500]), f.repeat(2, 0), [0, 2000], c,
        (16, 16), **kw),
    "BatchingEngine": lambda c, m, f, g, **kw: BatchingEngine(c, max_batch=1, **kw).shutdown(),
    "DeepBackend.from_raft": lambda c, m, f, g, **kw: _raft_backend(**kw),
    "DeepBackend.from_flowformer": lambda c, m, f, g, **kw: tdeep.DeepBackend.from_flowformer(
        FlowFormer(FlowFormerConfig(encoder_depth=1, decoder_depth=1)), **kw),
    "deep_roi_flow_step": lambda c, m, f, g, **kw: tdeep.deep_roi_flow_step(
        m[0], g[0], g[0], c, _raft_backend(**kw)),
    "deep_roi_flow_batch": lambda c, m, f, g, **kw: tdeep.deep_roi_flow_batch(
        m, g, g, c, _raft_backend(**kw)),
    "deep_full_flow_step": lambda c, m, f, g, **kw: tdeep.deep_full_flow_step(
        g[0], g[0], c, _raft_backend(**kw)),
    "BatchingEngine.for_deep_backend": lambda c, m, f, g, **kw: BatchingEngine.for_deep_backend(
        c, _raft_backend(**kw), max_batch=1).shutdown(),
    "DemoService": lambda c, m, f, g, **kw: tapp.DemoService(**kw),
    "make_server": lambda c, m, f, g, **kw: tapp.make_server(**kw).server_close(),
    "run_segmentation": lambda c, m, f, g, **kw: trunner.run_segmentation(_scene(c, m, f, g),
                                                                          **kw),
    "run_tracking": lambda c, m, f, g, **kw: trunner.run_tracking(_scene(c, m, f, g), **kw),
    "run_prediction": lambda c, m, f, g, **kw: trunner.run_prediction(_scene(c, m, f, g), **kw),
    "create_train_state": lambda c, m, f, g, **kw: ptrain.create_train_state(0, cfg=TINY_RAFT,
                                                                             **kw),
    "make_train_step": lambda c, m, f, g, **kw: ptrain.make_train_step(
        *ptrain.create_train_state(0, "cpu", cfg=TINY_RAFT)[:2], **kw),
    "create_flowformer_state": lambda c, m, f, g, **kw: ptrain.create_flowformer_state(
        0, cfg=FlowFormerConfig(encoder_depth=1, decoder_depth=1), **kw),
    "TorchYoloDetector": lambda c, m, f, g, **kw: _yolo(**kw)(g[0]),
    "SamPredictor": lambda c, m, f, g, **kw: tsam.SamPredictor(_tiny_sam(), **kw).set_image(
        g[0, :48, :64]),
    "TorchSamSegmenter": lambda c, m, f, g, **kw: tgt.TorchSamSegmenter(_tiny_sam(), **kw)(
        g[0, :48, :64], "object"),
    "TorchOwlVitBoxProposer": lambda c, m, f, g, **kw: tgt.TorchOwlVitBoxProposer.from_params(
        towl.TINY_OWLVIT, towl.synthetic_owlvit_state_dict(towl.TINY_OWLVIT),
        tgt.toy_tokenizer(99, 16), **kw)(g[0, :48, :64], "object"),
    "run_detection": lambda c, m, f, g, **kw: tdetect.run_detection(
        _scene(c, m, f, g), tdetect.ThresholdBlobDetector(), **kw),
}


def _yolo(**kw):
    """YOLOv8n on synthetic weights at imgsz 64, on ``kw``'s device."""
    cfg = yolov8.YoloConfig()
    state = yolov8.convert_yolov8(yolov8.synthetic_state_dict(cfg), cfg)
    return tdetect.TorchYoloDetector(state, cfg, imgsz=64, **kw)


TINY_RAFT = RaftConfig(small=True, iters=1)


def _tiny_sam():
    model = tsam.Sam(tsam.TINY_SAM)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in tsam.synthetic_sam_state_dict(tsam.TINY_SAM).items()})
    return model


def _raft_backend(**kw):
    """RAFT-small, one iteration, as a deep backend on ``kw``'s device."""
    return tdeep.DeepBackend.from_raft(RAFT(RaftConfig(small=True, iters=1)), iters=1, **kw)


def _scene(cfg, mem, frames, frames_bgr):
    """A scene of three blank frames (two pairs' inputs, one pair run)."""
    return SceneData(cfg, frames_bgr.repeat(3, 0), frames.repeat(3, 0), mem.repeat(3, 0), None,
                     ["0.png", "1.png", "2.png"])
# the device and stream entry points on the 16×16 grid of 160×160 frames
SIM = tfs.FrameSimConfig(m=10, n=10, n_substeps=2)
BINNED = tev.bin_events(np.array([1, 2]), np.array([1, 2]), np.array([1, 0]),
                        np.array([0, 1500]), 1000, 16, 16, use_native=False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_needs_cuda_or_cpu(monkeypatch, name):
    """Each entry point of the exact path, the tracking and prediction
    paths, the device layer, the stream, the separate regions, the Canny
    gate, the scene runners, the batching engine, the demo server and the
    deep backends (whose steps run on their backend's device) raises
    without a CUDA device unless it is given ``device='cpu'``, and then
    runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DATASETS["tabletennis"]
    args = (cfg, np.zeros((1, 16, 16), np.uint8), np.zeros((1, 160, 160), np.uint8),
            np.zeros((1, 160, 160, 3), np.uint8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](*args)
    ENTRY_POINTS[name](*args, device="cpu")


HF_ENTRY_POINTS = {
    "OwlVitBoxProposer": tgt.OwlVitBoxProposer,
    "TransformersSamSegmenter": tgt.TransformersSamSegmenter,
    "TorchOwlVitBoxProposer": tgt.TorchOwlVitBoxProposer,
    "TorchSamSegmenter.for_checkpoint": tgt.TorchSamSegmenter.for_checkpoint,
    "lang_sam_segmenter": lambda name, **kw: tgt.lang_sam_segmenter(name, name, **kw),
}


@pytest.mark.parametrize("name", sorted(HF_ENTRY_POINTS))
def test_weight_readers_need_cuda_or_cpu(monkeypatch, tmp_path, name):
    """The ground-truth tooling's constructors that read weights from local
    files raise without a CUDA device unless given ``device='cpu'``, before
    they look for the weights; given it, they raise ``OSError`` on a missing
    model without importing ``transformers`` (``tests/test_torch_owlvit.py``
    runs the Hugging Face classes from local directories)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setitem(sys.modules, "transformers", None)  # importing it raises ImportError
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HF_ENTRY_POINTS[name](missing)
    with pytest.raises(OSError):
        HF_ENTRY_POINTS[name](missing, device="cpu")


def test_cli_deep_needs_cuda_or_cpu(monkeypatch, tmp_path):
    """The CLI's ``deep``, ``train`` and ``validate`` run on the CUDA device
    by default and raise without one (``tests/test_torch_cli.py`` and
    ``tests/test_torch_train_evaluate.py`` run them with ``--device cpu``)."""
    from nsof_tpu_torch import cli as tcli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("raft", "flowformer"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main(["deep", "--data-root", str(tmp_path), "--backend", backend])
    # the training slice's subcommands too
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["train", "--data-root", str(tmp_path), "--stage", "chairs"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcli.main(["validate", "--dataset", "chairs", "--data-root", str(tmp_path)])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_wrappers_raise_without_kernel_library(cuda_device, monkeypatch, tmp_path):
    """With no library to load and no nvcc to build one, every wrapper
    raises on a CUDA tensor instead of falling back to its plain version."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_fns", {})
    dev = cuda_device
    b, hk, wk, hp, wp = 2, 40, 50, 64, 64
    img = torch.zeros((b, hk, wk), device=dev)
    r0 = torch.zeros((b, 5, hp, wp), device=dev)
    r1 = torch.zeros((b, 5, hp + 16, wp + 32), device=dev)
    bsc = tff.border_scale(hk, wk, str(dev))
    m = torch.zeros((b, 5, hp, wp), device=dev, dtype=torch.bfloat16)
    m32 = torch.zeros((b, 5, hp, wp), device=dev)
    lvl0 = torch.zeros((b, 5, hk, wk), device=dev)
    lvl1 = torch.zeros((b, 5, hk + 8, wk + 8), device=dev)
    calls = [
        lambda: troi.crop_windows_batch(
            torch.zeros((b, 64, 64), dtype=torch.uint8, device=dev),
            torch.zeros(b, dtype=torch.int32, device=dev),
            torch.zeros(b, dtype=torch.int32, device=dev), 16, 16),
        lambda: tff.poly_expansion(img, 5, 1.2, hp, wp),
        lambda: tff.update_matrices_sep(img, img, r0, r1, bsc, 3),
        lambda: tff.update_matrices_sep(img, img, r0, r1, bsc, 3,
                                        out_dtype=torch.float32),
        lambda: tff.fused_box_update(m, r0, r1, bsc, 15, 3, "matrices"),
        lambda: tff.fused_box_update(m32, r0, r1, bsc, 15, 3, "matrices"),
        lambda: tff.update_matrices(img, img, lvl0, lvl1, bsc, 3, separable=True),
        lambda: tff.update_matrices(img, img, lvl0, lvl1, bsc, 3),
        lambda: tff.box_solve(lvl0, 3),
        lambda: tfs.scan_device(torch.zeros((3, 6, 8), device=dev), tfs.FrameSimConfig(),
                                torch.zeros((6, 8), device=dev)),
        lambda: tcomp.nms_batch(torch.zeros((2, 5, 4), device=dev), torch.ones((2, 5), device=dev),
                                torch.ones((2, 5), dtype=torch.bool, device=dev), 0.45),
    ]
    for call in calls:
        with pytest.raises(RuntimeError):
            call()


@pytest.mark.cuda
@pytest.mark.parametrize("radius,winsize", [(3, 3), (8, 21)])
def test_level_route_kernels_match_plain(cuda_device, radius, winsize):
    """K5, K7 and K6 on the card equal their plain versions (built with
    --fmad=false, summed in the same order), at radius 8 and m = 10 too,
    beyond the TPU kernels' halo."""
    gen = torch.Generator().manual_seed(radius)
    b, h, w, pad = 3, 45, 70, radius + 1
    r0 = (torch.rand((b, 5, h, w), generator=gen) * 100).to(cuda_device)
    r1p = (torch.rand((b, 5, h + 2 * pad, w + 2 * pad), generator=gen) * 100).to(cuda_device)
    dx, dy = ((torch.rand((b, h, w), generator=gen) * 6 - 3).to(cuda_device)
              for _ in range(2))
    bsc = tff.border_scale(h, w, str(cuda_device))
    for sep in (True, False):
        got = tff.update_matrices(dx, dy, r0, r1p, bsc, radius, separable=sep)
        ref = tff._update_matrices_plain(dx, dy, r0, r1p, bsc, radius, separable=sep)
        torch.testing.assert_close(got, ref, rtol=0, atol=0)
    got = tff.box_solve(got, winsize)
    ref = tff._box_solve_plain(ref, winsize)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
