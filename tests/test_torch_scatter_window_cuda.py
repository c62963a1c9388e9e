"""K13, the seg step's scatter (``csrc/scatter_window.cu``), against its plain
version ``ops/roi.py::scatter_seg_windows_plain``, bit for bit.

On the card (marked ``cuda``): every ``chip_smoke.K13_CASES`` case with and
without the flow, one launch a call, the flow compared as int32 bits so that
signed zeros count (the cells' shapes at B = 128, 1920×1080 and 801²;
tabletennis' 160² and uav's 161² windows on their own frames and on a
480×640 frame, with origins at each frame edge, past it and negative; a
zero-area box, boxes past the window, inactive samples with and without a
box; odd widths, where no row is 16-byte aligned; a width of 1; B = 1; frames
below a tile); ``return_flow=False`` allocates and writes no flow;
``seg_batch_fast`` at the grasp and autodriving presets launches K13 once a
call, and its outputs equal those with the plain scatter put in.

On the CPU (unmarked): the wrapper on CPU tensors is the scatter that
``seg_batch_fast`` had (the mask window into a zero frame; the negated flow,
zeroed outside the box and for inactive samples, into another), with and
without ``return_flow``; the kernel's index arithmetic, mirrored in numpy
(tiles of 4096 pixels, the divisions by multiply-high and shift, the
regions, the tiles that only store zeros), equals the plain version;
``seg_batch_fast`` calls the wrapper once a call; CPU tensors launch
nothing; the wrapper's refusals raise before any launch.

The card's tests need no jax: ``python -m pytest --noconftest -m cuda
tests/test_torch_scatter_window_cuda.py``.  Skipped without a CUDA device.
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import K13_CASES, bits_equal, frame_inputs, k13_inputs, scatter_inputs
from nsof_tpu_torch import _build
from nsof_tpu_torch.config import DATASETS
from nsof_tpu_torch.ops import roi as troi
from nsof_tpu_torch.pipelines import segmentation as tseg

TILE = 4096  # the kernel's output pixels a block

# K13_CASES cut to the CPU: (B, H, W, wh, ww, boxes, planes)
CPU_CASES = {
    "grasp_cut": (8, 96, 54, 96, 54, ("cells", 8), "canvas"),
    "autodriving_cut": (8, 81, 81, 81, 81, ("cells", 20), "dense"),
    "tabletennis_own_frame": (8, 160, 160, 160, 160, ("cells", 10), "canvas"),
    "uav_win_on_60x80": (12, 60, 80, 41, 41, "edges", "canvas"),
    "tabletennis_win_on_60x80": (12, 60, 80, 40, 40, "edges", "dense"),
    "odd_widths": (11, 37, 53, 21, 33, "edges", "canvas"),
    "width_1": (8, 30, 1, 10, 1, "edges", "dense"),
    "b1": (1, 81, 81, 81, 81, ("cells", 20), "dense"),
    "tiny_frames": (50, 7, 9, 5, 6, "edges", "dense"),
}


def cpu_inputs(name: str, seed: int = 0):
    return scatter_inputs(*CPU_CASES[name], seed=seed + len(name), dev="cpu")


def old_scatter(mask_win, dx, dy, box, active, oys, oxs, h, w, return_flow):
    """The scatter as ``seg_batch_fast`` wrote it before K13, line for line."""
    b = mask_win.shape[0]
    wh, ww = mask_win.shape[1:]
    inbox = troi.window_box_mask(box, oys, oxs, wh, ww) & active[:, None, None]
    mask = troi.scatter_window(torch.zeros((b, h, w), dtype=torch.uint8), mask_win, box,
                               oys, oxs)
    if not return_flow:
        return mask, None
    flow_win = torch.stack([-dx, -dy], dim=-1)
    flow_win = torch.where(inbox[..., None], flow_win, torch.zeros_like(flow_win))
    return mask, troi.scatter_window(torch.zeros((b, h, w, 2), dtype=torch.float32),
                                     flow_win, box, oys, oxs)


# -- the kernel's arithmetic, mirrored -----------------------------------------

def make_div(d: int) -> tuple[int, int, int]:
    """The kernel's make_div: (d, mul, shr) with x / d = umulhi(x, mul) >> shr
    for 0 ≤ x < 2^31 (d = 1 passed through)."""
    if d == 1:
        return 1, 0, 0
    p = 31 + (d - 1).bit_length()  # 31 + ceil(log2 d)
    return d, ((1 << p) + d - 1) // d, p - 32


def divide(x: np.ndarray, div) -> np.ndarray:
    d, mul, shr = div
    if d == 1:
        return x
    return ((x.astype(np.uint64) * np.uint64(mul)) >> np.uint64(32 + shr)).astype(np.int64)


def regions(box, oys, oxs, active, h, w, wh, ww) -> dict:
    """The kernel's region_of for every sample."""
    oy, ox = oys.astype(np.int64), oxs.astype(np.int64)
    cy = np.minimum(np.maximum(np.where(oy < 0, oy + h, oy), 0), h - wh)
    cx = np.minimum(np.maximum(np.where(ox < 0, ox + w, ox), 0), w - ww)
    bx = box.astype(np.int64)
    r0, r1 = np.maximum(0, bx[:, 1] - oy), np.minimum(wh, bx[:, 3] - oy)
    c0, c1 = np.maximum(0, bx[:, 0] - ox), np.minimum(ww, bx[:, 2] - ox)
    some = (r0 < r1) & (c0 < c1)
    pick = lambda v: np.where(some, v, 0)  # noqa: E731
    return {"y0": pick(cy + r0), "y1": pick(cy + r1), "x0": pick(cx + c0),
            "x1": pick(cx + c1), "cy": cy, "cx": cx, "active": active.astype(bool)}


def k13_mirror(mask_win, dx, dy, box, active, oys, oxs, h, w, return_flow, tile=TILE,
               stats=None):
    """K13's tiling in numpy: each output pixel's tile, its sample and row and
    column by the kernel's divisions from the tile's first pixel, the tile's
    zero flags, then the select.  Checks the kernel's indices, regions and
    zero tiles; the stores' grouping into 16-byte words is the card's test.
    ``stats`` (a dict) gets the count of tiles that store only zeros in the
    mask and of tiles across two or more samples."""
    b, wh, ww = mask_win.shape
    hw, n = h * w, b * h * w
    g = regions(box.numpy(), oys.numpy(), oxs.numpy(), active.numpy(), h, w, wh, ww)
    p = np.arange(n, dtype=np.int64)
    p0 = p // tile * tile
    b0 = p0 // hw
    r0 = p0 - b0 * hw
    r = r0 + (p - p0)
    assert r.max() < 2**31
    db = divide(r, make_div(hw))
    rr = r - db * hw
    y = divide(rr, make_div(w))
    x = rr - y * w
    s = b0 + db
    # the tile's flags, from its first sample's region
    rl = r0 + (np.minimum(p0 + tile, n) - 1 - p0)
    one = rl < hw
    ya, yb = r0 // w, rl // w
    zm = one & ((g["y0"][b0] == g["y1"][b0]) | (yb < g["y0"][b0]) | (ya >= g["y1"][b0]))
    zf = zm | (one & ~g["active"][b0])
    if stats is not None:
        first = p == p0
        stats["zero_mask_tiles"] = int((zm & first).sum())
        stats["split_tiles"] = int((~one & first).sum())
    inside = ((y >= g["y0"][s]) & (y < g["y1"][s]) & (x >= g["x0"][s]) & (x < g["x1"][s]))
    wy = np.clip(y - g["cy"][s], 0, wh - 1)
    wx = np.clip(x - g["cx"][s], 0, ww - 1)
    mw = mask_win.numpy()
    mask = np.where(~zm & inside, mw[s, wy, wx], 0).astype(np.uint8).reshape(b, h, w)
    if not return_flow:
        return torch.from_numpy(mask), None
    on = ~zf & inside & g["active"][s]
    flow = np.zeros((n, 2), np.float32)
    for c, d in enumerate((dx.numpy(), dy.numpy())):
        flow[:, c] = np.where(on, np.negative(d[s, wy, wx]), np.float32(0))
    return torch.from_numpy(mask), torch.from_numpy(flow.reshape(b, h, w, 2))


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("return_flow", [True, False], ids=["flow", "mask_only"])
@pytest.mark.parametrize("name", sorted(CPU_CASES))
def test_wrapper_on_cpu_is_the_old_scatter(name, return_flow):
    args = cpu_inputs(name)
    mask, flow = troi.scatter_seg_windows(*args, return_flow)
    want_mask, want_flow = old_scatter(*args, return_flow)
    assert bits_equal(mask, want_mask)
    if return_flow:
        assert bits_equal(flow, want_flow)
        if flow.numel() >= 20000:
            assert bool((flow.view(torch.int32) == -2**31).any()), "a −0.0 in the flow"
    else:
        assert flow is None


@pytest.mark.parametrize("tile", [TILE, 64, 16])
@pytest.mark.parametrize("name", sorted(CPU_CASES))
def test_k13_mirror_equals_plain(name, tile):
    args = cpu_inputs(name, seed=tile)
    stats = {}
    for return_flow in (True, False):
        got = k13_mirror(*args, return_flow, tile=tile, stats=stats)
        want = troi.scatter_seg_windows_plain(*args, return_flow)
        assert bits_equal(got[0], want[0])
        assert (got[1] is None) if not return_flow else bits_equal(got[1], want[1])
    if name.endswith("_cut") and tile != 16:
        # the cells' boxes leave whole tiles to store zeros, and tiles span samples
        assert stats["zero_mask_tiles"] > 0 if tile == 64 else stats["split_tiles"] > 0


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 9, 53, 160, 801, 1080, 641601, 2073600,
                               2**20 + 1, 2**30 - 1, 2**30])
def test_division_by_multiply_high(d):
    """The kernel's divisions are exact below 2^31 (the largest offset it
    divides is H·W + 4096 ≤ 2^30 + 4096)."""
    rng = np.random.default_rng(d)
    x = np.concatenate([np.arange(0, 5000), rng.integers(0, 2**31, 20000),
                        np.arange(2**31 - 3000, 2**31),
                        ((np.arange(1, 2000)[:, None] * d) + np.array([-1, 0, 1])).ravel()])
    x = x[(x >= 0) & (x < 2**31)].astype(np.int64)
    assert np.array_equal(divide(x, make_div(d)), x // d)


@pytest.mark.parametrize("name", ["grasp_cut", "autodriving_cut"])
def test_cells_inputs_have_inactive_samples(name):
    """The cut cells' inputs hold an inactive sample (a zero box) and active
    ones whose boxes cover part of the frame, as the cells' do."""
    mask_win, dx, dy, box, active, oys, oxs, h, w = cpu_inputs(name)
    assert not bool(active.all()) and bool(active.any())
    area = ((box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1])).float() / (h * w)
    assert float(area.max()) < 1 and float(area[active].min()) > 0
    assert float(area[~active].max()) == 0


@pytest.mark.parametrize("return_flow", [True, False])
def test_seg_batch_fast_calls_the_wrapper_once(monkeypatch, return_flow):
    calls = []
    wrapped = troi.scatter_seg_windows

    def counted(*args):
        calls.append(args[-1])
        return wrapped(*args)

    monkeypatch.setattr(troi, "scatter_seg_windows", counted)
    cfg = _cut_cfg()
    mem, prev, nxt = frame_inputs(3, 0, "cpu", cfg.image_h, cfg.image_w, cfg.roi.memsize,
                                  (slice(1, 3), slice(2, 4)))
    out = tseg.seg_batch_fast(mem, prev, nxt, cfg, return_flow=return_flow, device="cpu")
    assert calls == [return_flow]
    assert ("flow" in out) == return_flow and out["mask"].shape == (3, 120, 160)


def test_cpu_tensors_launch_nothing():
    _build.reset_launches()
    args = cpu_inputs("odd_widths")
    troi.scatter_seg_windows(*args, True)
    assert not any(_build.LAUNCHES.values())


def _cut_cfg():
    cfg = dataclasses.replace(DATASETS["grasp"], name="cut120", image_h=120, image_w=160,
                              window_h=64, window_w=96, warp_radius=3)
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=20))


def _bad_args(case: str):
    mask_win, dx, dy, box, active, oys, oxs, h, w = cpu_inputs("odd_widths")
    a = dict(mask_win=mask_win, dx=dx, dy=dy, box=box, active=active, oys=oys, oxs=oxs,
             h=h, w=w)
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731
    changes = {
        "mask_dtype": {"mask_win": mask_win.to(torch.int32)},
        "mask_rank": {"mask_win": mask_win[0]},
        "mask_strides": {"mask_win": mask_win.transpose(1, 2).contiguous().transpose(1, 2)},
        "window_past_frame": {"h": mask_win.shape[1] - 1},
        "frame_too_large": {"h": 2**15 + 1, "w": 2**15},
        "box_dtype": {"box": box.long()},
        "box_shape": {"box": box[:, :3].contiguous()},
        "box_strides": {"box": box.t().contiguous().t()},
        "oys_device": {"oys": meta(oys)},
        "oxs_dtype": {"oxs": oxs.float()},
        "active_dtype": {"active": active.to(torch.uint8)},
        "dx_dtype": {"dx": dx.double()},
        "dy_shape": {"dy": dy[:, :-1]},
        "dx_device": {"dx": meta(dx)},
        "strides_differ": {"dx": dx.contiguous()},
        "row_strides": {"dx": dx.transpose(1, 2).contiguous().transpose(1, 2),
                        "dy": dy.transpose(1, 2).contiguous().transpose(1, 2)},
    }
    a.update(changes[case])
    return a


@pytest.mark.parametrize("case", ["mask_dtype", "mask_rank", "mask_strides", "window_past_frame",
                                  "frame_too_large", "box_dtype", "box_shape", "box_strides",
                                  "oys_device", "oxs_dtype", "active_dtype", "dx_dtype",
                                  "dy_shape", "dx_device", "strides_differ", "row_strides"])
def test_wrapper_checks_raise(case):
    """The wrapper refuses what K13 does not take, before any launch."""
    _build.reset_launches()
    a = _bad_args(case)
    with pytest.raises(ValueError):
        troi.scatter_seg_windows(a["mask_win"], a["dx"], a["dy"], a["box"], a["active"],
                                 a["oys"], a["oxs"], a["h"], a["w"], True)
    assert _build.LAUNCHES["scatter_window"] == 0


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("return_flow", [True, False], ids=["flow", "mask_only"])
@pytest.mark.parametrize("name", list(K13_CASES))
def test_k13_matches_plain(cuda_device, name, return_flow):
    args = k13_inputs(name, cuda_device)
    torch.cuda.synchronize()
    _build.reset_launches()
    before = torch.cuda.memory_allocated()
    mask, flow = troi.scatter_seg_windows(*args, return_flow)
    allocated = torch.cuda.memory_allocated() - before
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {"scatter_window": 1}
    want_mask, want_flow = troi.scatter_seg_windows_plain(*args, return_flow)
    assert bits_equal(mask, want_mask)
    if return_flow:
        assert bits_equal(flow, want_flow)
    else:
        # the mask frame alone: no flow frame allocated or written
        assert flow is None and allocated < mask.numel() + (1 << 20)


def _seg_inputs(cfg, b, dev):
    cells = (slice(1, 3), slice(2, 5)) if cfg.name == "grasp" else (slice(1, 3), slice(1, 3))
    mem, prev, nxt = frame_inputs(b, 0, dev, cfg.image_h, cfg.image_w, cfg.roi.memsize,
                                  cells)
    mem[-1] = 0  # one inactive sample
    return mem, prev, nxt


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["grasp", "autodriving"])
def test_seg_batch_fast_takes_k13_once(cuda_device, monkeypatch, cell):
    cfg = DATASETS[cell]
    mem, prev, nxt = _seg_inputs(cfg, 4, cuda_device)
    torch.cuda.synchronize()
    _build.reset_launches()
    got = tseg.seg_batch_fast(mem, prev, nxt, cfg, return_flow=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["scatter_window"] == 1

    monkeypatch.setattr(troi, "scatter_seg_windows", troi.scatter_seg_windows_plain)
    _build.reset_launches()
    want = tseg.seg_batch_fast(mem, prev, nxt, cfg, return_flow=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["scatter_window"] == 0
    for key in ("mask", "flow", "box", "any_active", "region_pct"):
        assert bits_equal(got[key], want[key]), key
    assert got["any_active"][:-1].all() and not got["any_active"][-1]
    assert got["mask"].any()
