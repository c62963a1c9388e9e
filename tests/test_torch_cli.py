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
  ``resistances`` within 2e-6 relative, the metadata sidecar equal; with
  h5py hidden the port's npz is equal to its run with h5py (the stream
  simulated in memory, no HDF5 written), and ``--h5`` raises naming h5py.
- ``eventsim`` with its MP4 (OpenCV is installed here), then ``visualize``
  on its npz against the JAX CLI's: keyframes equal.

Measured on the CPU: masks equal, flow images 99.84 % and 99.77 % equal,
framesim ``w_final`` 8.6e-7 off, eventsim ``w_final`` equal.  Also: JPEG
frames, and ``eventsim`` without ``--no-video`` where OpenCV is hidden, raise; ``--mesh`` whose dp·tp
is not ``WORLD_SIZE`` (1 outside ``torchrun``) raises, and ``train --stage chairs --small --steps 1`` runs on a
FlyingChairs-shaped layout (``.ppm`` frames, ``.flo`` flows) with the
chairs stage cut to 64×96 crops and batch 2, writing its checkpoint.

``deep`` on a 600×600 scene of PNG frames (uavnew2's shape, a 15×15 state
matrix) with one reference-format RAFT-small checkpoint given to both
CLIs (``--torch-ckpt``, iters 2): the port's ``track`` records (activity,
region percentage, boxes) equal the JAX CLI's; ``seg`` and ``predict`` give
the same activity and region percentages; ``--ckpt`` runs ``deep`` on the
checkpoint ``train`` wrote, with that checkpoint's weights.  Measured:
records equal.  ``load_scene`` reads that
scene (frames and gray masks as PNG) with the port's codec into the same
arrays as the JAX package's through OpenCV.
"""

import argparse
import contextlib
import dataclasses
import gzip
import io
import json
import pathlib
import shutil
import sys

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


def test_eventsim_without_h5py(tmp_path, monkeypatch):
    """With h5py hidden, ``eventsim --synthetic --no-video`` simulates the
    stream in memory: the same npz and metadata as with h5py, and no HDF5."""
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["eventsim", "--synthetic", "--no-video", "--device", "cpu"]) == 0
    assert pathlib.Path("synthetic.hdf5").exists()
    for suffix in (".V1.npz", ".V1.json.gz", ".hdf5"):
        shutil.move(f"synthetic{suffix}", f"with_h5py{suffix}")
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert tcli.main(["eventsim", "--synthetic", "--no-video", "--device", "cpu"]) == 0
    assert not pathlib.Path("synthetic.hdf5").exists()
    got, ref = np.load("synthetic.V1.npz"), np.load("with_h5py.V1.npz")
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        np.testing.assert_array_equal(got[k], ref[k])
    with gzip.open("synthetic.V1.json.gz", "rt") as g, gzip.open("with_h5py.V1.json.gz") as r:
        assert json.load(g) == json.load(r)
    with pytest.raises(RuntimeError, match="h5py"):
        tcli.main(["eventsim", "--h5", "with_h5py.hdf5", "--no-video", "--device", "cpu"])


def test_eventsim_video_and_visualize(tmp_path, monkeypatch):
    """``eventsim`` without ``--no-video`` writes its MP4 where OpenCV is
    installed; ``visualize`` on its npz writes the keyframes the JAX CLI's
    ``visualize`` writes (the manifest equal but for the npz path, the
    pixels equal), the final-state and colorbar images."""
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["eventsim", "--synthetic", "--slice_us", "20000", "--device", "cpu"]) == 0
    assert pathlib.Path("synthetic.V1.mp4").stat().st_size > 0
    (tmp_path / "jax").mkdir()
    shutil.copy("synthetic.V1.npz", "jax/synthetic.V1.npz")
    shutil.copy("synthetic.V1.json.gz", "jax/synthetic.V1.json.gz")
    args = ["--mode", "delta", "--value", "state", "--key-every", "5"]
    assert tcli.main(["visualize", "synthetic.V1.npz", *args]) == 0
    assert jcli.main(["visualize", "jax/synthetic.V1.npz", *args]) == 0
    got = json.loads(pathlib.Path("synthetic.V1_keyframes/manifest.json").read_text())
    ref = json.loads(pathlib.Path("jax/synthetic.V1_keyframes/manifest.json").read_text())
    assert got.pop("source_npz") == "synthetic.V1.npz"
    ref.pop("source_npz")
    assert got == ref and len(got["frames"]) == 11  # 51 frames, every 5th
    for frame in got["frames"]:
        g = decode_png((tmp_path / "synthetic.V1_keyframes" / frame["path"]).read_bytes())
        r = decode_png((tmp_path / "jax/synthetic.V1_keyframes" / frame["path"]).read_bytes())
        np.testing.assert_array_equal(g, r)
    assert pathlib.Path("synthetic.V1.w_final.png").exists()
    assert pathlib.Path("synthetic.V1.colorbar.png").exists()


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train --stage chairs --small --steps 1`` on a FlyingChairs-shaped
    layout of three synthetic pairs, the chairs stage cut to 64×96 crops and
    batch 2; returns (checkpoint root, the printed line)."""
    from nsof_tpu_torch.data import flow_datasets as tfd
    from nsof_tpu_torch.train import curriculum
    from nsof_tpu_torch.utils.ppm import encode_ppm

    root = tmp_path_factory.mktemp("train")
    data = root / "FlyingChairs_release" / "data"
    data.mkdir(parents=True)
    pairs = tfd.synthetic_affine_dataset(np.random.default_rng(0), n=3, size=(96, 128))
    for i, (a, b, flow) in enumerate(pairs):
        (data / f"{i:05d}_img1.ppm").write_bytes(encode_ppm(a))
        (data / f"{i:05d}_img2.ppm").write_bytes(encode_ppm(b))
        tfd.write_flo(data / f"{i:05d}_flow.flo", flow)
    cut = tuple(dataclasses.replace(s, image_size=(64, 96), batch_size=2)
                for s in curriculum.RAFT_STANDARD_STAGES)
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(curriculum, "RAFT_STANDARD_STAGES", cut)
        rc = tcli.main(["train", "--data-root", str(root), "--ckpt-root", str(root / "ckpt"),
                        "--stage", "chairs", "--small", "--steps", "1", "--device", "cpu"])
    return rc, root / "ckpt", out.getvalue()


def test_refusals(frames, tmp_path, monkeypatch, trained):
    (tmp_path / "jpeg").mkdir()
    (tmp_path / "jpeg" / "0.jpg").write_bytes(b"\xff\xd8\xff\xe0")
    with pytest.raises(ValueError, match="JPEG"):
        tcli.main(["stream", "--frames", str(tmp_path / "jpeg"), "--device", "cpu"])
    monkeypatch.chdir(tmp_path)
    with monkeypatch.context() as mp:  # the MP4 preview needs OpenCV
        mp.setitem(sys.modules, "cv2", None)
        with pytest.raises(RuntimeError, match="OpenCV"):
            tcli.main(["eventsim", "--synthetic", "--device", "cpu"])
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        tcli.main(["train", "--data-root", str(tmp_path), "--mesh", "2x1", "--device", "cpu"])
    # the training slice runs: one step of the chairs stage, one checkpoint
    rc, ckpt, printed = trained
    assert rc == 0 and json.loads(printed.strip().splitlines()[-1]) == {"stages": ["chairs"]}
    assert sorted(p.name for p in (ckpt / "chairs").iterdir()) == ["1", "metrics.jsonl"]


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


def test_cli_deep_on_a_png_scene(tmp_path, capsys, trained):
    """The port's ``deep`` against the JAX CLI's on one scene and one
    reference-format RAFT-small checkpoint (iters 2): the same records
    (activity, region percentage, tracking boxes); seg and predict run;
    ``--ckpt`` runs on the port's training checkpoint."""
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
    # the training checkpoint: deep runs RAFT-small with its weights
    ckpt = trained[1] / "chairs"
    saved = torch.load(ckpt / "1" / "state.pt", weights_only=True)["model"]
    model = tcli._raft_model(argparse.Namespace(torch_ckpt=None, small=True, iters=2,
                                                ckpt=str(ckpt)))
    assert all(torch.equal(v, saved[k]) for k, v in model.state_dict().items())
    assert tcli.main(["deep", "--data-root", str(tmp_path), "--scene", "uavnew2", "--iters", "2",
                      "--task", "track", "--ckpt", str(ckpt), "--out", str(tmp_path / "ckpt"),
                      "--device", "cpu"]) == 0
    got = json.loads((tmp_path / "ckpt" / "deep_track.json").read_text())
    assert len(got) == 2 and all(r["active"] for r in got)
