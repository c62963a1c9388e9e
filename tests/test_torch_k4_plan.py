"""K4's wrapper on the CPU: the strip design's picker
(``farneback_fast.k4_plan``), its mirror of the kernel's shared memory, the
launch it hands the kernel and the counters of the two designs.  The kernel
itself runs only on the card (``test_torch_kernels_cuda.py``, which also
holds the mirror to the kernel's own plan)."""

import pytest
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.config import DATASETS
from nsof_tpu_torch.ops import farneback_fast as tff
from nsof_tpu_torch.ops.farneback import _cv_round, _effective_levels

H100_SMS = 132
M_DTYPES = [torch.bfloat16, torch.float32]


def preset_canvases(name: str) -> list[tuple[int, int]]:
    """The fused route's canvases of a preset's window, in both
    orientations (grasp's recordings are 1920×1080 and 1080×1920)."""
    cfg = DATASETS[name]
    p = cfg.fb
    out = set()
    for h, w in (cfg.win_shape, cfg.win_shape[::-1]):
        for k in range(_effective_levels(h, w, p.levels, p.pyr_scale) + 1):
            out.add((tff._canvas(_cv_round(h * p.pyr_scale**k)),
                     tff._canvas(_cv_round(w * p.pyr_scale**k))))
    return sorted(out)


@pytest.mark.parametrize("m_dtype", M_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("emit", ["matrices", "flow"])
@pytest.mark.parametrize("name", ["grasp", "uavnew2", "tabletennis"])
def test_presets_take_the_strip_design(name, emit, m_dtype):
    """Every canvas of the presets takes the strip design, its rings within
    a block's shared memory, but float32 M's next system: one such block
    fills an SM's shared memory, so it takes the tile design."""
    cfg = DATASETS[name]
    canvases = preset_canvases(name)
    if name == "grasp":  # the benchmark cells' canvases
        assert {(1088, 1920), (544, 960), (288, 480)} <= set(canvases)
    for hp, wp in canvases:
        for b in (1, 2, 128):
            plan = tff.k4_plan(cfg.fb.winsize, cfg.warp_radius, emit, m_dtype, hp, wp, b,
                               H100_SMS)
            if m_dtype == torch.float32 and emit == "matrices":
                assert plan == tff.K4_TILE_PLAN
                lay = tff._k4_strip_layout(cfg.fb.winsize, cfg.warp_radius, False, 4)
                assert 2 * (lay["bytes"] + tff.K4_BLOCK_SMEM_RESERVED) > tff.K4_SM_SMEM_BYTES
                continue
            assert 1 <= plan.walk <= hp // 32, (hp, wp, b)
            assert 0 < plan.smem <= 232448
            mm = cfg.fb.winsize // 2
            ext = 0 if emit == "flow" else cfg.warp_radius + 1
            assert plan.ring_m_rows == 32 + 2 * ext + 2 * mm
            assert plan.ring_r1_rows == (0 if emit == "flow" else 32 + 2 * cfg.warp_radius + 1)


def test_grasp_layout_bytes():
    """The mirror's sums at grasp's window and radius, reckoned by hand:
    M's ring 54 rows × 5 × 48 bf16 (columns X0-8 … X0+39), r1's ring 39 ×
    5 × 40 floats (columns X0-4 … X0+35), column sums 40 × 5 × 48, the flow
    72 × 32."""
    lay = tff._k4_strip_layout(15, 3, False, 2)
    assert lay["bytes"] == 54 * 240 * 2 + 39 * 200 * 4 + 40 * 240 * 4 + 72 * 32 * 4 == 104736
    assert tff._k4_strip_layout(15, 3, True, 2)["bytes"] == 46 * 240 * 2 + 32 * 240 * 4
    # two such blocks share an SM, four of the flow emit's
    assert 2 * (104736 + tff.K4_BLOCK_SMEM_RESERVED) <= tff.K4_SM_SMEM_BYTES
    assert 4 * (52800 + tff.K4_BLOCK_SMEM_RESERVED) <= tff.K4_SM_SMEM_BYTES


@pytest.mark.parametrize("emit", ["matrices", "flow"])
def test_grasp_cells_take_the_longest_walks(emit):
    """At B = 128 grasp's canvases give more strips than block slots: every
    block walks as far as ``K4_WALK_MAX`` lets it, the walks of a strip
    balanced (34 row blocks: 9, 9, 9, 7 for the next system; 17: 9, 8)."""
    cap = tff.K4_WALK_MAX[emit]
    for hp, wp in ((1088, 1920), (544, 960), (288, 480)):
        plan = tff.k4_plan(15, 3, emit, torch.bfloat16, hp, wp, 128, H100_SMS)
        blocks = hp // 32
        assert plan.walk == -(-blocks // -(-blocks // cap)) <= cap


def test_small_canvas_takes_short_walks():
    """tabletennis's 160×160 at B = 2: 5 strips of 5 row blocks, fewer
    than the card's slots, so a block takes one row block and the grid
    fills the card; on one SM the walk crosses every row block the cap
    allows."""
    plan = tff.k4_plan(4, 5, "matrices", torch.bfloat16, 160, 160, 2, H100_SMS)
    assert plan.walk == 1
    plan = tff.k4_plan(15, 3, "matrices", torch.bfloat16, 160, 200, 2, 1)
    assert plan.walk == 5


@pytest.mark.parametrize("m_dtype", M_DTYPES, ids=["bf16", "f32"])
def test_other_cases_take_the_tile_design(m_dtype):
    """The strip design has no instance for windows other than 5 and 15
    (the widest, 63, could not hold its rings) nor, for the next system,
    for radii other than 3 and 5; a canvas width that is no multiple of a
    16-byte copy takes the tile design too; beyond 63 the picker raises as
    the kernel would."""
    for winsize, radius in ((63, 7), (17, 7), (15, 7), (5, 1)):
        assert tff.k4_plan(winsize, radius, "matrices", m_dtype, 64, 96, 3,
                           H100_SMS) == tff.K4_TILE_PLAN
    assert tff.k4_plan(15, 7, "flow", m_dtype, 64, 96, 3, H100_SMS).walk >= 1
    assert tff.k4_plan(15, 3, "matrices", m_dtype, 64, 90, 3, H100_SMS) == tff.K4_TILE_PLAN
    with pytest.raises(ValueError, match="63"):
        tff.k4_plan(65, 3, "matrices", m_dtype, 64, 96, 3, H100_SMS)


def test_launch_keys_and_reset():
    for key in ("fused_box_update_strip", "fused_box_update_tile"):
        assert key in _build.LAUNCH_KEYS and key in _build.LAUNCHES
        _build.LAUNCHES[key] += 3
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values())


@pytest.fixture
def fake_kernel(monkeypatch):
    """The wrapper's launches recorded instead of run (CPU tensors stand for
    the card's: the wrapper reads only their shapes and addresses)."""
    calls = []

    def launcher(name, n_ptr, n_int, symbol=None, n_float=0):
        assert (name, n_ptr, n_int) == ("fused_box_update", 5, 11)

        def fn(*args):
            calls.append((symbol, args))
            return 0
        return fn

    monkeypatch.setattr(_build, "launcher", launcher)
    monkeypatch.setattr(tff, "_stream", lambda t: 0)
    monkeypatch.setattr(tff, "_sm_count", lambda index: H100_SMS)
    _build.reset_launches()
    yield calls
    _build.reset_launches()


def operands(m_dtype, hp=64, wp=96, b=3, offset=0):
    mr, mc = tff.R1_MARGIN
    n = b * 5 * hp * wp
    m = torch.zeros(n + offset, dtype=m_dtype)[offset:].view(b, 5, hp, wp)
    r0 = torch.zeros((b, 5, hp, wp))
    r1 = torch.zeros((b, 5, hp + 2 * mr, wp + 2 * mc))
    return m, r0, r1, tff.border_scale(40, 50, "cpu")


@pytest.mark.parametrize("m_dtype", M_DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("emit", ["matrices", "flow"])
def test_wrapper_hands_the_plan_to_the_kernel(fake_kernel, emit, m_dtype):
    m, r0, r1, bsc = operands(m_dtype)
    out = tff._fused_box_update_cuda(m, r0, r1, bsc, 15, 3, emit, tff.R1_MARGIN)
    plan = tff.k4_plan(15, 3, emit, m_dtype, 64, 96, 3, H100_SMS)
    (symbol, args), = fake_kernel
    key = "fused_box_update" if m_dtype == torch.bfloat16 else "fused_box_update_f32"
    assert symbol == f"nsof_{key}"
    assert (plan.walk == 0) == (m_dtype == torch.float32 and emit == "matrices")
    assert args[5:16] == (3, 40, 50, 64, 96, 8, 16, 15, 3, int(emit == "flow"), plan.walk)
    assert out.shape == (3, 2 if emit == "flow" else 5, 64, 96)
    design = "fused_box_update_strip" if plan.walk else "fused_box_update_tile"
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {key: 1, design: 1}


def test_wrapper_counts_the_tile_design(fake_kernel):
    """A forced tile plan, an M whose rows cannot take 16-byte copies (its
    address 2 bytes off) and an r1 margin whose columns cannot (18) all
    launch the tile design."""
    m, r0, r1, bsc = operands(torch.bfloat16)
    tff._fused_box_update_cuda(m, r0, r1, bsc, 15, 3, "matrices", tff.R1_MARGIN,
                               plan=tff.K4_TILE_PLAN)
    m, r0, r1, bsc = operands(torch.bfloat16, offset=1)
    assert m.is_contiguous() and m.data_ptr() % 16
    tff._fused_box_update_cuda(m, r0, r1, bsc, 15, 3, "matrices", tff.R1_MARGIN)
    m, r0, _, bsc = operands(torch.bfloat16)
    r1 = torch.zeros((3, 5, 64 + 16, 96 + 36))
    tff._fused_box_update_cuda(m, r0, r1, bsc, 15, 3, "matrices", (8, 18))
    assert [args[15] for _, args in fake_kernel] == [0, 0, 0]
    assert _build.LAUNCHES["fused_box_update_tile"] == 3
    assert _build.LAUNCHES["fused_box_update_strip"] == 0
