"""The port's visualiser (``nsof_tpu_torch/utils/visualize.py``) against the
JAX package's, which draws with matplotlib (and OpenCV for the MP4), on
seeded event-simulation results.

- ``visualize_npz``: the keyframe PNGs' RGBA pixels equal
  ``plt.imsave``'s, and ``manifest.json`` is equal (but for the npz path),
  in every mode and value space and with log scaling.  The ``w_final`` and
  colorbar images differ on purpose: the port writes the colormapped array
  alone, no axes, title or labels; the test checks their shape and that
  ``w_final``'s pixels are viridis over its range.
- The colormap tables equal matplotlib's byte tables and OpenCV's JET, and
  the MP4's frames are OpenCV's ``applyColorMap`` of the same values.
- Without OpenCV, ``save_mp4`` and ``write_video`` raise ``RuntimeError``
  naming it; with it, the MP4 is written.
"""

import json
import pathlib
import sys

import matplotlib
import numpy as np
import pytest
from PIL import Image

from nsof_tpu.utils import visualize as jvis
from nsof_tpu_torch.device import EventSimConfig, io
from nsof_tpu_torch.utils import colormaps
from nsof_tpu_torch.utils import visualize as tvis
from nsof_tpu_torch.utils.png import decode_png


def _npz(root: pathlib.Path, seed: int = 0) -> pathlib.Path:
    """An eventsim-shaped result: 7 frames of 12×16 resistances falling
    from 2e6 towards 2e5 unevenly, w_final in [0, 1], and the metadata
    sidecar (r_on 2e5, r_off 2e6, fps 250)."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    decay = np.cumprod(rng.uniform(0.6, 1.0, (7, 12, 16)), axis=0)
    res = (2e5 + 1.8e6 * decay).astype(np.float32)
    res[0] = 2e6
    npz = root / "sim.V1.npz"
    np.savez_compressed(npz, w_final=rng.random((12, 16)), resistances=res)
    io.save_sim_metadata(npz.with_suffix(".json.gz"), EventSimConfig(version=1), 4000)
    return npz


def _rgba(path) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGBA"))


@pytest.mark.parametrize("mode,value,use_log", [("abs", "resistance", False),
                                                ("delta", "state", False),
                                                ("rel", "resistance", True),
                                                ("delta", "resistance", True)])
def test_keyframes_equal_matplotlib(tmp_path, mode, value, use_log):
    ref = jvis.visualize_npz(_npz(tmp_path / "jax"), mode=mode, value=value, use_log=use_log,
                             key_every=2)
    got = tvis.visualize_npz(_npz(tmp_path / "port"), mode=mode, value=value,
                             use_log=use_log, key_every=2)
    assert set(got) == set(ref) == {"w_final", "keyframes", "colorbar"}
    jm = json.loads((pathlib.Path(ref["keyframes"]) / "manifest.json").read_text())
    tm = json.loads((pathlib.Path(got["keyframes"]) / "manifest.json").read_text())
    assert tm.pop("source_npz") == str(tmp_path / "port" / "sim.V1.npz")
    jm.pop("source_npz")
    assert tm == jm and len(tm["frames"]) == 4
    for frame in tm["frames"]:
        g = _rgba(pathlib.Path(got["keyframes"]) / frame["path"])
        r = _rgba(pathlib.Path(ref["keyframes"]) / frame["path"])
        assert g.shape == r.shape == (12, 16, 4)
        np.testing.assert_array_equal(g, r)
    # the deliberate differences: the bare colormapped arrays
    w = np.load(tmp_path / "port" / "sim.V1.npz")["w_final"]
    np.testing.assert_array_equal(
        _rgba(got["w_final"]),
        matplotlib.colormaps["viridis"](matplotlib.colors.Normalize()(w), bytes=True))
    assert decode_png(pathlib.Path(got["colorbar"]).read_bytes()).shape == (60, 600, 3)


def test_colormap_rgba_edges_equal_matplotlib(tmp_path):
    """Values below and above the range, NaN, an exact 1.0 and an integer
    array map as ``plt.imsave`` maps them."""
    x = np.array([[-1.0, 0.0, 0.25, np.nan], [0.5, 0.999, 1.0, 3.0]], np.float32)
    for arr, vmin, vmax in ((x, 0.0, 1.0), (x.astype(np.float64), -0.5, 2.0),
                            (np.arange(12, dtype=np.int16).reshape(3, 4), 2.0, 9.0)):
        matplotlib.pyplot.imsave(tmp_path / "ref.png", arr, cmap="inferno", vmin=vmin, vmax=vmax)
        np.testing.assert_array_equal(tvis.colormap_rgba(arr, colormaps.INFERNO_RGB, vmin, vmax),
                                      _rgba(tmp_path / "ref.png"))


def test_tables_equal_matplotlib_and_opencv():
    import cv2

    for name, table in (("inferno", colormaps.INFERNO_RGB), ("viridis", colormaps.VIRIDIS_RGB)):
        ref = matplotlib.colormaps[name](np.arange(256), bytes=True)[:, :3]
        np.testing.assert_array_equal(table, ref)
    u8 = np.arange(256, dtype=np.uint8)[:, None]
    np.testing.assert_array_equal(colormaps.JET_BGR,
                                  cv2.applyColorMap(u8, cv2.COLORMAP_JET)[:, 0])
    frame = np.random.default_rng(1).normal(size=(9, 11)).astype(np.float32)
    np.testing.assert_array_equal(tvis._render_frame_u8(frame, -1.0, 2.0),
                                  jvis._render_frame_u8(frame, -1.0, 2.0))


def test_mp4_needs_opencv(tmp_path, monkeypatch):
    npz = _npz(tmp_path)
    out = tvis.visualize_npz(npz, save_mp4=True, save_colorbar=False)
    assert pathlib.Path(out["mp4"]).stat().st_size > 0
    tvis.write_video(list(np.load(npz)["resistances"]), tmp_path / "v.mp4", fps=30.0)
    assert (tmp_path / "v.mp4").stat().st_size > 0
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="OpenCV"):
        tvis.visualize_npz(npz, save_mp4=True)
    with pytest.raises(RuntimeError, match="OpenCV"):
        tvis.write_video([np.zeros((4, 4))], tmp_path / "w.mp4", fps=30.0)
