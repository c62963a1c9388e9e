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
frames and ``eventsim`` without ``--no-video`` raise, and the JAX CLI's
``deep`` is an unknown command.
"""

import dataclasses
import gzip
import json
import shutil

import numpy as np
import pytest

from nsof_tpu import cli as jcli
from nsof_tpu import config as jconfig
from nsof_tpu_torch import cli as tcli
from nsof_tpu_torch import config as tconfig
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
        tcli.main(["deep"])
