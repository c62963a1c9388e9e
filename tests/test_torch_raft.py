"""The port's RAFT (``nsof_tpu_torch/models/raft.py``) and windowed
correlation (``nsof_tpu_torch/ops/correlation.py``) against the JAX
package's.

The whole model: RAFT-basic and RAFT-small at 64×96, B = 2, iters 3, in
both corr modes, under one set of seeded random weights
(``tests/torch_deep_weights.py``), carried both ways: the Flax tree into
the port by ``params_from_jax``, and the port's own random ``state_dict()``
into Flax by the JAX package's ``convert_raft``.  Held to 1e-3 px max on
the full-resolution and the 1/8 flow; the port's train mode is the list of
its per-iteration flows.

The building blocks, at ragged sizes (so the ceil-mode pyramid edge-pads):
the all-pairs volume and its pyramid, ``corr_lookup`` (coordinates inside
and outside the map), the alternate lookup against the all-pairs one
(1e-4 px), the plain and the row-tiled windowed correlation (several
tiles), the fmap pyramid, ``bilinear_sample``, the convex and the
bilinear 8× upsampling, ``pad_to_multiple``/``unpad`` and
``forward_interpolate``.

Measured here: the flow within 1.3e-5 px of Flax for RAFT-basic and
5.2e-5 px for RAFT-small (both corr modes; flows up to 14 and 22 px), the
1/8 flow within 7.2e-6 px; the other direction (the port's default
initialisation, flows ≈ 1–1.6 px) within 8.0e-6 px.  The port's two corr
modes under one set of weights differ by 8.9e-7 px (basic) and 7.6e-6 px
(small); the blocks are held to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.models import raft as jraft
from nsof_tpu.models.convert import convert_raft
from nsof_tpu.ops import correlation as jcorr
from nsof_tpu_torch.models import raft as traft
from nsof_tpu_torch.models.convert import params_from_jax
from nsof_tpu_torch.ops import correlation as tcorr
from tests.torch_deep_weights import frame_pair, raft_params
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

FLOW_TOL = 1e-3  # px, the model against Flax
ALT_TOL = 1e-4  # px, alternate against all-pairs
BLOCK_TOL = 1e-5  # the building blocks against JAX
ITERS = 3
CASES = {f"{kind}-{mode}": (kind == "small", mode)
         for kind in ("basic", "small") for mode in ("allpairs", "alternate")}


def _cfgs(small: bool, mode: str):
    kw = dict(small=small, iters=ITERS, corr_mode=mode, corr_radius=3 if small else 4)
    return jraft.RaftConfig(**kw), traft.RaftConfig(**kw)


_jitted = {}


def _jax_flow(jcfg, params, a, b):
    """The JAX model's (1/8 flow, flow) in test mode, one compile a config."""
    if jcfg not in _jitted:
        model = jraft.RAFT(jcfg)
        _jitted[jcfg] = jax.jit(lambda p, x, y: model.apply({"params": p}, x, y, iters=ITERS,
                                                          test_mode=True))
    lo, up = _jitted[jcfg](params, a, b)
    return np.asarray(lo), np.asarray(up)


def _port_flow(model, a, b, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(a), torch.from_numpy(b), iters=ITERS, **kw)


@pytest.fixture(scope="module")
def pair():
    return frame_pair(2, 64, 96)


_params = {}


def _params_for(jcfg):
    """One random tree per model size: the parameters do not depend on the
    corr mode, so the all-pairs model's shapes serve both."""
    key = (jcfg.small, jcfg.corr_radius)
    if key not in _params:
        _params[key] = raft_params(dataclasses.replace(jcfg, corr_mode="allpairs"), seed=0)
    return _params[key]


@pytest.mark.parametrize("case", sorted(CASES))
def test_raft_matches_flax_both_ways(case, pair):
    small, mode = CASES[case]
    jcfg, tcfg = _cfgs(small, mode)
    a, b = pair
    params = _params_for(jcfg)
    lo, up = _jax_flow(jcfg, params, a, b)
    model = traft.RAFT(tcfg)
    model.load_state_dict(params_from_jax(params, tcfg))
    tlo, tup = _port_flow(model, a, b, test_mode=True)
    assert tup.shape == up.shape == (2, 64, 96, 2) and tlo.shape == lo.shape == (2, 8, 12, 2)
    assert np.abs(up).max() > 1.0  # a flow to compare, not zeros
    np.testing.assert_allclose(tup.numpy(), up, rtol=0, atol=FLOW_TOL)
    np.testing.assert_allclose(tlo.numpy(), lo, rtol=0, atol=FLOW_TOL)

    # the port's own random weights through the JAX converter
    torch.manual_seed(1)
    model = traft.RAFT(tcfg)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    _, up2 = _jax_flow(jcfg, convert_raft(state, jcfg), a, b)
    _, tup2 = _port_flow(model, a, b, test_mode=True)
    np.testing.assert_allclose(tup2.numpy(), up2, rtol=0, atol=FLOW_TOL)


@pytest.mark.parametrize("small", [False, True], ids=["basic", "small"])
def test_train_mode_is_the_per_iteration_flows(small, pair):
    """Train mode returns ``iters`` flows; flow k is the test-mode flow after
    k + 1 iterations (the JAX scan's stacked outputs)."""
    torch.manual_seed(2)
    model = traft.RAFT(traft.RaftConfig(small=small, iters=ITERS))
    a, b = (torch.from_numpy(x) for x in pair)
    with torch.no_grad():
        flows = model(a, b, iters=ITERS)
        assert len(flows) == ITERS
        for k, f in enumerate(flows):
            torch.testing.assert_close(f, model(a, b, iters=k + 1, test_mode=True)[1],
                                       rtol=0, atol=0)


@pytest.mark.parametrize("small", [False, True], ids=["basic", "small"])
def test_alternate_model_equals_allpairs_model(small, pair):
    """One set of weights, both corr modes: the flows agree to ALT_TOL."""
    torch.manual_seed(3)
    flows = []
    for mode in ("allpairs", "alternate"):
        _, tcfg = _cfgs(small, mode)
        if not flows:
            model = traft.RAFT(tcfg)
        model.cfg = tcfg
        flows.append(_port_flow(model, *pair, test_mode=True)[1])
    torch.testing.assert_close(flows[1], flows[0], rtol=0, atol=ALT_TOL)


@pytest.mark.parametrize("small", [False, True], ids=["basic", "small"])
def test_bfloat16_compute_dtype(small, pair):
    """``compute_dtype=torch.bfloat16`` runs the encoders and the update
    block under autocast: the flow stays float32, moves (so autocast took
    effect) and stays within 5 % of the float32 flow's largest value
    (measured 0.6 % basic, 2.5 % small)."""
    torch.manual_seed(4)
    cfg = traft.RaftConfig(small=small, iters=ITERS)
    f32 = traft.RAFT(cfg)
    bf16 = traft.RAFT(dataclasses.replace(cfg, compute_dtype=torch.bfloat16))
    bf16.load_state_dict(f32.state_dict())
    want = _port_flow(f32, *pair, test_mode=True)[1]
    got = _port_flow(bf16, *pair, test_mode=True)[1]
    assert got.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert 0 < err < 0.05 * want.abs().max().item()


def _fmaps(seed, b=2, h=7, w=9, c=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, c)).astype(np.float32),
            rng.standard_normal((b, h, w, c)).astype(np.float32))


def _coords(seed, b=2, h=7, w=9, spread=3.0):
    """Target coordinates around the grid, some beyond the map's edge."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([xs, ys], -1)[None].repeat(b, 0)
    return (base + rng.uniform(-spread, spread, base.shape)).astype(np.float32)


def test_corr_pyramid_and_lookup_match_jax():
    f1, f2 = _fmaps(0)
    corr = jraft.all_pairs_correlation(jnp.asarray(f1), jnp.asarray(f2))
    tc = traft.all_pairs_correlation(torch.from_numpy(f1), torch.from_numpy(f2))
    np.testing.assert_allclose(tc.numpy(), np.asarray(corr), rtol=0, atol=BLOCK_TOL)
    jp = jraft.build_corr_pyramid(corr, 4)
    tp = traft.build_corr_pyramid(tc, 4)
    assert [tuple(t.shape) for t in tp] == [tuple(j.shape[:3]) for j in jp] == [
        (126, 7, 9), (126, 4, 5), (126, 2, 3), (126, 1, 2)]
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t.numpy(), np.asarray(j)[..., 0], rtol=0, atol=BLOCK_TOL)
    coords = _coords(1)
    for radius in (1, 4):
        jl = jraft.corr_lookup(jp, jnp.asarray(coords), radius)
        tl = traft.corr_lookup(tp, torch.from_numpy(coords), radius)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=BLOCK_TOL)


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(9)
    img = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    x = rng.uniform(-2, 10, (2, 5, 4)).astype(np.float32)
    y = rng.uniform(-2, 8, (2, 5, 4)).astype(np.float32)
    want = jraft.bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y))
    got = traft.bilinear_sample(*(torch.from_numpy(v) for v in (img, x, y)))
    assert got.shape == want.shape == (2, 5, 4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=BLOCK_TOL)


def test_alternate_lookup_equals_allpairs_and_jax():
    f1, f2 = _fmaps(2)
    coords = _coords(3)
    t1, t2, tcrd = (torch.from_numpy(x) for x in (f1, f2, coords))
    tp = traft.build_corr_pyramid(traft.all_pairs_correlation(t1, t2), 4)
    allpairs = traft.corr_lookup(tp, tcrd, 3)
    fp = traft.build_fmap_pyramid(t2, 4)
    jfp = jraft.build_fmap_pyramid(jnp.asarray(f2), 4)
    for t, j in zip(fp, jfp):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=BLOCK_TOL)
    alt = traft.alternate_corr_lookup(t1, fp, tcrd, 3)
    torch.testing.assert_close(alt, allpairs, rtol=0, atol=ALT_TOL)
    jalt = jraft.alternate_corr_lookup(jnp.asarray(f1), jfp, jnp.asarray(coords), 3)
    np.testing.assert_allclose(alt.numpy(), np.asarray(jalt), rtol=0, atol=BLOCK_TOL)


@pytest.mark.parametrize("pooled", [False, True], ids=["same_res", "pooled"])
def test_windowed_correlation_plain_and_tiled(pooled):
    """The plain form against JAX's ``windowed_correlation``; the tiled form
    (a tile of one query row here, so seven tiles) against the plain one and
    against JAX's ``windowed_correlation_mxu``."""
    f1, f2 = _fmaps(4)
    if pooled:
        f2 = f2[:, ::2, ::2]
    coords = _coords(5) / (2.0 if pooled else 1.0)
    t1, t2, tcrd = (torch.from_numpy(np.ascontiguousarray(x)) for x in (f1, f2, coords))
    plain = tcorr.windowed_correlation(t1, t2, tcrd, 2)
    jplain = jcorr.windowed_correlation(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords), 2)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jplain), rtol=0, atol=BLOCK_TOL)
    row_bytes = 4 * 2 * 9 * f2.shape[1] * f2.shape[2]
    tiled = tcorr.windowed_correlation_tiled(t1, t2, tcrd, 2, tile_bytes=row_bytes)
    torch.testing.assert_close(tiled, plain, rtol=0, atol=BLOCK_TOL)
    jmxu = jcorr.windowed_correlation_mxu(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(coords),
                                          2, tile=16)
    np.testing.assert_allclose(tiled.numpy(), np.asarray(jmxu), rtol=0, atol=BLOCK_TOL)


def test_upsampling_matches_jax():
    rng = np.random.default_rng(6)
    flow = rng.standard_normal((2, 5, 7, 2)).astype(np.float32) * 3
    mask = rng.standard_normal((2, 5, 7, 576)).astype(np.float32)
    jconv = jraft.upsample_flow_convex(jnp.asarray(flow), jnp.asarray(mask))
    tconv = traft.upsample_flow_convex(torch.from_numpy(flow).permute(0, 3, 1, 2),
                                       torch.from_numpy(mask).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tconv.permute(0, 2, 3, 1).numpy(), np.asarray(jconv), rtol=0,
                               atol=BLOCK_TOL)
    jbil = jraft.upflow8(jnp.asarray(flow))
    tbil = traft.upflow8(torch.from_numpy(flow).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tbil.permute(0, 2, 3, 1).numpy(), np.asarray(jbil), rtol=0,
                               atol=BLOCK_TOL)


@pytest.mark.parametrize("shape", [(2, 37, 53, 3), (45, 30, 2), (19, 21)])
def test_pad_to_multiple_and_unpad_match_jax(shape):
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    jpad, jpads = jraft.pad_to_multiple(jnp.asarray(img))
    tpad, tpads = traft.pad_to_multiple(torch.from_numpy(img))
    assert tpads == jpads
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    if img.ndim >= 3:
        np.testing.assert_array_equal(traft.unpad(tpad, tpads).numpy(), img)


def test_forward_interpolate_matches_jax():
    rng = np.random.default_rng(8)
    flow = (rng.standard_normal((12, 17, 2)) * 3).astype(np.float32)
    np.testing.assert_array_equal(traft.forward_interpolate(torch.from_numpy(flow)),
                                  jraft.forward_interpolate(flow))
    np.testing.assert_array_equal(traft.forward_interpolate(np.full((4, 4, 2), 50, np.float32)),
                                  np.zeros((4, 4, 2), np.float32))


def test_config_matches_jax():
    # `remat` only changes JAX's backward pass; the port is inference only
    # and leaves it out until it trains
    for small in (False, True):
        j, t = jraft.RaftConfig(small=small), traft.RaftConfig(small=small)
        assert (t.hidden_dim, t.context_dim) == (j.hidden_dim, j.context_dim)
        fields = {f.name for f in dataclasses.fields(j)} - {"remat"}
        assert fields == {f.name for f in dataclasses.fields(t)}
        assert all(getattr(j, f) == getattr(t, f) for f in fields - {"compute_dtype"})
        assert not j.remat
    assert traft.NORM_EPS == jraft.NORM_EPS
