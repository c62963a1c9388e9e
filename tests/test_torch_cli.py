"""The port's CLI (``python -m nsof_tpu_torch.cli``) against the JAX
package's CLI on the same tiny inputs, both run in-process with their
``main(argv)``, the port with ``--device cpu``.

Nine 160×160 PNG frames of a bright 48×48 box moving (2, 3) px a frame over
a random texture, made with numpy from a seed:

- ``stream --preset grasp`` (the port with ``--kernel-mode xla``, the JAX
  package's route off the TPU; both packages' grasp preset given warp
  radius 1 for the test, since the JAX 'xla' route's compile time grows
  with its (2r+2)² warp taps): every mask file equal.
- ``flow --preset grasp`` on three of the frames: the flow images within
  one level, ≥ 99.5 % equal (the exact flows are ≤ 8.5e-5 px apart, the
  JAX function jitted; each image is normalised by its largest radius, so
  values near a floor's boundary move by one level).
- ``framesim --m 40 --n 40``: ``w_final`` within 1e-6 and ``resistances``
  within 2e-5 relative (``tests/test_torch_device.py``'s bounds).
- ``eventsim --synthetic --no-video``: ``w_final`` within 1e-6,
  ``resistances`` within 2e-6 relative, the metadata sidecar equal.

Measured on the CPU: masks equal, flow images 99.84 % and 99.77 % equal,
framesim ``w_final`` 8.6e-7 off, eventsim ``w_final`` equal.  Also: JPEG
frames and ``eventsim`` without ``--no-video`` raise, and ``train`` (the
training slice, not ported) is an unknown command.

``deep`` on a 600×600 scene of PNG frames (uavnew2's shape, a 15×15 state
matrix) with one reference-format RAFT-small checkpoint given to both
CLIs (``--torch-ckpt``, iters 2): the port's ``track`` records (activity,
region percentage, boxes) equal the JAX CLI's; ``seg`` and ``predict`` give
the same activity and region percentages; ``--ckpt`` raises naming the
training slice.  Measured: records equal.  ``load_scene`` reads that
scene (frames and gray masks as PNG) with the port's codec into the same
arrays as the JAX package's through OpenCV.
"""

import dataclasses
import gzip
import json
import shutil

import numpy as np
import pytest
import scipy.io
import torch

from nsof_tpu import cli as jcli
from nsof_tpu import config as jconfig
from nsof_tpu_torch import cli as tcli
from nsof_tpu_torch import config as tconfig
from nsof_tpu_torch.models.raft import RAFT, RaftConfig
from nsof_tpu_torch.utils.png import decode_png, encode_png
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

N_FRAMES = 9


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    base = (rng.random((160, 160)) * 96).astype(np.uint8)
    for sub, n in (("frames", N_FRAMES), ("three", 3)):
        (root / sub).mkdir()
        for i in range(n):
            f = base.copy()
            y, x = 40 + 2 * i, 30 + 3 * i
            f[y : y + 48, x : x + 48] = 230
            (root / sub / f"{i}.png").write_bytes(encode_png(f))
    return root


@pytest.fixture
def radius_1(monkeypatch):
    for pkg in (jconfig, tconfig):
        cut = dataclasses.replace(pkg.DATASETS["grasp"], warp_radius=1)
        monkeypatch.setitem(pkg.DATASETS, "grasp", cut)


def _read(path):
    return decode_png(path.read_bytes(), gray=True)


def test_stream_masks_equal(frames, radius_1):
    args = ["stream", "--frames", str(frames / "frames"), "--preset", "grasp"]
    assert jcli.main(args + ["--out", str(frames / "stream_jax")]) == 0
    assert tcli.main(args + ["--out", str(frames / "stream_torch"), "--device", "cpu",
                             "--kernel-mode", "xla"]) == 0
    names = sorted(p.name for p in (frames / "stream_jax").iterdir())
    assert names == sorted(p.name for p in (frames / "stream_torch").iterdir())
    assert names == [f"mask_{i}.png" for i in range(1, N_FRAMES)]
    for name in names:
        np.testing.assert_array_equal(_read(frames / "stream_torch" / name),
                                      _read(frames / "stream_jax" / name), name)
    assert any(_read(frames / "stream_torch" / n).any() for n in names)


def test_flow_images(frames):
    args = ["flow", "--frames", str(frames / "three"), "--preset", "grasp"]
    assert jcli.main(args + ["--out", str(frames / "flow_jax")]) == 0
    assert tcli.main(args + ["--out", str(frames / "flow_torch"), "--device", "cpu"]) == 0
    for i in range(2):
        name = f"flow_{i}.png"
        got = decode_png((frames / "flow_torch" / name).read_bytes()).astype(np.int64)
        ref = decode_png((frames / "flow_jax" / name).read_bytes()).astype(np.int64)
        diff = np.abs(got - ref).max(axis=-1)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.995, name


def test_framesim(frames):
    args = ["framesim", "--frames", str(frames / "frames"), "--m", "40", "--n", "40"]
    assert jcli.main(args + ["--out", str(frames / "jax.npz")]) == 0
    assert tcli.main(args + ["--out", str(frames / "torch.npz"), "--device", "cpu"]) == 0
    got, ref = np.load(frames / "torch.npz"), np.load(frames / "jax.npz")
    assert sorted(got.files) == sorted(ref.files)
    assert got["w_final"].shape == (4, 4)
    np.testing.assert_allclose(got["w_final"], ref["w_final"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["resistances"], ref["resistances"], rtol=2e-5, atol=0)


def test_eventsim_synthetic(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert jcli.main(["eventsim", "--synthetic", "--no-video"]) == 0
    for suffix in (".V1.npz", ".V1.json.gz"):
        shutil.move(f"synthetic{suffix}", f"jax{suffix}")
    assert tcli.main(["eventsim", "--synthetic", "--no-video", "--device", "cpu"]) == 0
    got, ref = np.load("synthetic.V1.npz"), np.load("jax.V1.npz")
    assert sorted(got.files) == sorted(ref.files)
    np.testing.assert_allclose(got["w_final"], ref["w_final"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["resistances"], ref["resistances"], rtol=2e-6, atol=0)
    with gzip.open("synthetic.V1.json.gz", "rt") as g, gzip.open("jax.V1.json.gz", "rt") as r:
        assert json.load(g) == json.load(r)


def test_refusals(frames, tmp_path, monkeypatch):
    (tmp_path / "jpeg").mkdir()
    (tmp_path / "jpeg" / "0.jpg").write_bytes(b"\xff\xd8\xff\xe0")
    with pytest.raises(ValueError, match="JPEG"):
        tcli.main(["stream", "--frames", str(tmp_path / "jpeg"), "--device", "cpu"])
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="--no-video"):
        tcli.main(["eventsim", "--synthetic", "--device", "cpu"])
    with pytest.raises(SystemExit):
        tcli.main(["train"])


def _png_scene(root):
    """A uavnew2-shaped scene of PNG frames (600×600, a texture moving (3, 6)
    px a frame) and a 15×15 state matrix with a 4×5-cell active block."""
    scene = root / "uavnew2"
    (scene / "RGB").mkdir(parents=True)
    rng = np.random.default_rng(0)
    base = (rng.random((640, 640, 3)) * 255).astype(np.uint8)
    names = [f"{t}.png" for t in range(4)]
    for t, name in enumerate(names):
        img = base[10 + 3 * t: 610 + 3 * t, 12 + 6 * t: 612 + 6 * t]
        (scene / "RGB" / name).write_bytes(encode_png(img))
    (scene / "gtmask").mkdir()
    for t, name in enumerate(names):  # gray masks with a soft edge, as JPEG-made ones have
        gt = np.zeros((600, 600), np.uint8)
        gt[200 + 3 * t: 320 + 3 * t, 250: 400] = 255
        gt[199 + 3 * t, 250: 400] = 120 + 10 * t
        (scene / "gtmask" / name).write_bytes(encode_png(gt))
    (scene / "imgs.txt").write_text("\n".join(names) + "\n")
    mem = np.full((15, 15, 4), 1e-12)
    mem[5:9, 4:9, :] = 1e-5
    scipy.io.savemat(scene / "constructed_3D_matrix.mat", {"constructed3DMatrix": mem})


def test_load_scene_reads_png_scenes_as_opencv_does(tmp_path):
    """The port's ``load_scene`` reads a PNG scene with its own codec; the
    JAX package's reads it through OpenCV: every array equal."""
    from nsof_tpu.data.scenes import load_scene as jax_load_scene
    from nsof_tpu_torch.data.scenes import load_scene

    _png_scene(tmp_path)
    got, want = load_scene(tmp_path, "uavnew2"), jax_load_scene(tmp_path, "uavnew2")
    for key in ("frames_bgr", "frames_gray", "mem_gray", "gt_masks"):
        np.testing.assert_array_equal(getattr(got, key), np.asarray(getattr(want, key)),
                                      err_msg=key)
    assert got.names == want.names and got.num_pairs == want.num_pairs == 2


def test_cli_deep_on_a_png_scene(tmp_path, capsys):
    """The port's ``deep`` against the JAX CLI's on one scene and one
    reference-format RAFT-small checkpoint (iters 2): the same records
    (activity, region percentage, tracking boxes); seg and predict run;
    ``--ckpt`` raises naming the training slice."""
    _png_scene(tmp_path)
    torch.manual_seed(0)
    ckpt = tmp_path / "raft-small.pth"
    torch.save(RAFT(RaftConfig(small=True, corr_radius=3)).state_dict(), ckpt)
    common = ["deep", "--data-root", str(tmp_path), "--scene", "uavnew2", "--iters", "2",
              "--torch-ckpt", str(ckpt)]
    assert jcli.main(common + ["--task", "track", "--out", str(tmp_path / "jax")]) == 0
    want = json.loads((tmp_path / "jax" / "deep_track.json").read_text())
    for task in ("track", "seg", "predict"):
        out = tmp_path / f"port_{task}"
        assert tcli.main(common + ["--task", task, "--out", str(out), "--device", "cpu"]) == 0
        got = json.loads((out / f"deep_{task}.json").read_text())
        assert len(got) == len(want) == 2 and all(r["active"] for r in got)
        for g, w in zip(got, want):
            assert (g["frame"], g["active"], g["region_pct"]) == (
                w["frame"], w["active"], w["region_pct"])
            if task == "track":
                assert g["boxes"] == w["boxes"] and g["boxes"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["pairs"] == 2
    with pytest.raises(NotImplementedError, match="training slice"):
        tcli.main(common + ["--ckpt", str(tmp_path), "--device", "cpu"])
