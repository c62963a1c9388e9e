"""The port's evaluation (``nsof_tpu_torch/train/evaluate.py``) and the
CLI's ``validate`` against the JAX package's, on synthetic Sintel and KITTI
layouts written with OpenCV (frames of 60×90, not a multiple of 8, so the
/8 padding is exercised; KITTI's 16-bit flow with a valid mask).

- ``validate_pairs`` with one numpy flow function (a per-pixel function of
  the frames) given to both packages: EPE, F1 and the pair count equal.
- ``create_sintel_submission``: the same ``.flo`` files, byte for byte;
  ``create_kitti_submission``: the same flow and valid mask read back by the
  JAX reader (the PNG bytes differ: another zlib stream).
- The CLI's ``validate --backend farneback`` (the port's exact Farnebäck on
  gray from the port's colour conversion, ``--device cpu``) against the JAX
  CLI's (OpenCV's gray, the JAX Farnebäck): EPE and F1 within 1e-3
  relative (the two Farnebäcks' flows are ≤ 1e-4 px apart,
  ``tests/test_torch_farneback_exact.py``), the same count; ``--submission``
  writes the same files.
- ``validate --backend raft --ckpt`` on a training checkpoint of the port:
  the EPE of ``validate_pairs`` over the checkpoint's model as a backend;
  ``--ckpt`` with another backend, and a directory holding no checkpoint,
  raise.
"""

import json

import numpy as np
import pytest
import torch

from nsof_tpu import cli as jcli
from nsof_tpu.data import flow_datasets as jfd
from nsof_tpu.train import evaluate as jev
from nsof_tpu_torch import cli as tcli
from nsof_tpu_torch.data import flow_datasets as tfd
from nsof_tpu_torch.models.raft import RaftConfig
from nsof_tpu_torch.parallel import train as ptrain
from nsof_tpu_torch.pipelines.deep_flow import DeepBackend
from nsof_tpu_torch.train import evaluate as tev
from nsof_tpu_torch.train.trainer import save_checkpoint
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

cv2 = pytest.importorskip("cv2")

H, W = 60, 90


def _textured(rng, h, w):
    img = rng.integers(40, 200, (h, w), np.uint8)
    img = cv2.GaussianBlur(img, (5, 5), 1.5)
    return np.stack([img, np.roll(img, 3, 1), img[::-1]], -1)


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(5)
    shift = (2, 1)
    base = _textured(rng, H + 32, W + 32)
    for split in ("training", "test"):
        scene = root / "sintel" / split / "clean" / "alley_1"
        scene.mkdir(parents=True)
        for i in range(3):
            crop = base[16 - i * shift[1]: 16 - i * shift[1] + H,
                        16 - i * shift[0]: 16 - i * shift[0] + W]
            cv2.imwrite(str(scene / f"frame_{i:04d}.png"), crop)
    fdir = root / "sintel" / "training" / "flow" / "alley_1"
    fdir.mkdir(parents=True)
    gt = np.zeros((H, W, 2), np.float32)
    gt[..., 0], gt[..., 1] = shift
    for i in range(1, 3):
        noisy = gt + rng.normal(0, 1, gt.shape).astype(np.float32)
        jfd.write_flo(fdir / f"frame_{i:04d}.flo", noisy)
    for split in ("training", "testing"):
        (root / "kitti" / split / "image_2").mkdir(parents=True)
        for i in range(2):
            for t in (10, 11):
                cv2.imwrite(str(root / "kitti" / split / "image_2" / f"{i:06d}_{t}.png"),
                            _textured(rng, H, W))
    (root / "kitti" / "training" / "flow_occ").mkdir()
    for i in range(2):
        jfd.write_kitti_flow(root / "kitti" / "training" / "flow_occ" / f"{i:06d}_10.png",
                             rng.normal(0, 4, (H, W, 2)).astype(np.float32),
                             rng.random((H, W)) > 0.4)
    return root


def flow_fn(i1, i2):
    """A per-pixel function of the frames, [1, H', W', 2]."""
    d = (i2 - i1).mean(-1) / 16.0
    return np.stack([d, np.cos(i1[..., 0] / 40.0) * 4], -1).astype(np.float32)


def test_validate_pairs_matches_jax(layout):
    for scan_j, scan_t in ((lambda: jfd.scan_sintel(layout / "sintel"),
                            lambda: tfd.scan_sintel(layout / "sintel")),
                           (lambda: jfd.scan_kitti(layout / "kitti"),
                            lambda: tfd.scan_kitti(layout / "kitti"))):
        want = jev.validate_pairs(flow_fn, scan_j())
        got = tev.validate_pairs(flow_fn, scan_t())
        assert got == want and got["n"] == 2 and got["f1"] > 0
    assert tev.validate_pairs(flow_fn, tfd.scan_kitti(layout / "kitti"), max_pairs=1)["n"] == 1


def test_submissions_match_jax(layout, tmp_path):
    assert jev.create_sintel_submission(flow_fn, layout / "sintel", tmp_path / "j") == 2
    assert tev.create_sintel_submission(flow_fn, layout / "sintel", tmp_path / "t") == 2
    for name in ("frame_0000.flo", "frame_0001.flo"):
        assert ((tmp_path / "t" / "clean" / "alley_1" / name).read_bytes()
                == (tmp_path / "j" / "clean" / "alley_1" / name).read_bytes())
    assert jev.create_kitti_submission(flow_fn, layout / "kitti", tmp_path / "jk") == 2
    assert tev.create_kitti_submission(flow_fn, layout / "kitti", tmp_path / "tk") == 2
    for name in ("000000_10.png", "000001_10.png"):
        got = jfd.read_kitti_flow(tmp_path / "tk" / name)
        want = jfd.read_kitti_flow(tmp_path / "jk" / name)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("dataset", ["sintel", "kitti"])
def test_cli_validate_farneback(layout, capsys, dataset):
    args = ["validate", "--dataset", dataset, "--data-root", str(layout / dataset)]
    assert jcli.main(args) == 0
    want = _last_json(capsys)
    assert tcli.main(args + ["--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert got["n"] == want["n"] == 2 and got["dataset"] == dataset
    for k in ("epe", "f1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)


def test_cli_submission(layout, tmp_path, capsys):
    args = ["validate", "--dataset", "sintel", "--data-root", str(layout / "sintel"),
            "--submission"]
    assert tcli.main(args + ["--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    assert _last_json(capsys) == {"written": 2, "out": str(tmp_path / "t")}
    assert jcli.main(args + ["--out", str(tmp_path / "j")]) == 0
    for i in range(2):
        got = tfd.read_flo(tmp_path / "t" / "clean" / "alley_1" / f"frame_{i:04d}.flo")
        want = jfd.read_flo(tmp_path / "j" / "clean" / "alley_1" / f"frame_{i:04d}.flo")
        assert np.abs(got - want).max() < 1e-3


def test_cli_validate_a_training_checkpoint(layout, tmp_path, capsys):
    cfg = RaftConfig(small=True)
    model, _, state = ptrain.create_train_state(3, "cpu", cfg=cfg)
    save_checkpoint(tmp_path / "ckpt", 7, state)
    args = ["validate", "--dataset", "sintel", "--data-root", str(layout / "sintel"),
            "--backend", "raft", "--small", "--ckpt", str(tmp_path / "ckpt"), "--iters", "2",
            "--device", "cpu"]
    assert tcli.main(args) == 0
    got = _last_json(capsys)
    backend = DeepBackend.from_raft(model, iters=2, device="cpu")
    want = tev.validate_pairs(
        lambda a, b: backend.apply(torch.from_numpy(a), torch.from_numpy(b)),
        tfd.scan_sintel(layout / "sintel"))
    assert got == {"dataset": "sintel", **want}
    base = ["validate", "--dataset", "sintel", "--data-root", str(layout / "sintel"),
            "--device", "cpu"]
    with pytest.raises(ValueError, match="--ckpt restores RAFT"):
        tcli.main(base + ["--ckpt", str(tmp_path / "ckpt")])
    (tmp_path / "none").mkdir()
    with pytest.raises(FileNotFoundError, match="no training checkpoint"):
        tcli.main(base + ["--backend", "raft", "--small", "--ckpt", str(tmp_path / "none")])
