"""The port's data-parallel segmentation (``parallel/inference.py``) and
row-sharded Farnebäck (``parallel/spatial.py``) against the JAX package's.

- ``make_sharded_seg_batch`` in 4 gloo ranks (a 2 × 2 ('data', 'model')
  mesh: the 'model' ranks compute the same rows) on the tabletennis preset
  cut to 96×128 (memsize 16, warp radius 1), B = 8, bench.py-style inputs (a
  shifted texture, a 2×2 active block, one sample with no active cell, one
  saturated): in ``'xla'`` its masks ≥ 99.5 % equal to JAX's
  ``make_sharded_seg_batch`` on ``make_mesh(1)`` (JAX's 'xla' route, run in
  process) and its boxes and ``any_active`` equal; in ``'xla'`` and
  ``'fused'`` bit for bit the port's unsharded ``seg_batch_fast``;
  ``any_active`` comes back bool (it crosses gloo as uint8); a batch that
  does not divide over 'data' raises ``ValueError``.
- ``halo_exchange_rows`` in 4 gloo ranks against JAX's on a virtual
  4-device mesh: every slab's halo rows equal (float32; and uint8 slabs
  in the ``[rows, B, W]`` layout of the batch form against the numpy rule).
- ``make_spatial_flow`` at 128×64, 1 pyramid level, halo 16, 4 ranks; and
  ``make_spatial_flow_batch`` on a 2 × 2 ('data', 'space') mesh, B = 2: in
  the interior band (rows halo … H − halo) within the exact path's bounds
  (max 1e-2 px, mean 5e-4 px) of JAX's, and of the port's unsharded
  ``farneback``; the batch form within 1e-4 of the one-pair form per pair.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from nsof_tpu.config import DATASETS
from nsof_tpu.parallel.inference import make_sharded_seg_batch
from nsof_tpu.parallel.mesh import make_mesh
from nsof_tpu_torch.config import config_from_dict
from nsof_tpu_torch.ops.farneback import FarnebackParams, farneback
from nsof_tpu_torch.parallel.spatial import halo_exchange_rows
from nsof_tpu_torch.pipelines.segmentation import seg_batch_fast
from tests.conftest import run_in_cpu_subprocess
from tests.torch_dist import run_ranks
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

H, W, MEMSIZE, B, RADIUS = 96, 128, 16, 8, 1
SP_PARAMS = (0.5, 1, 5, 1, 5, 1.1)
SP_H, SP_W, SP_HALO = 128, 64, 16
FLOW_MAX, FLOW_MEAN = 1e-2, 5e-4


def _seg_cfg():
    cfg = dataclasses.replace(DATASETS["tabletennis"], image_h=H, image_w=W, window_h=64,
                              window_w=96, warp_radius=RADIUS)
    return dataclasses.replace(cfg, roi=dataclasses.replace(cfg.roi, memsize=MEMSIZE))


def _seg_inputs():
    rng = np.random.default_rng(0)
    base = rng.random((H + 64, W + 64)).astype(np.float32) * 255
    prev = np.stack([base[16 + v % 5:16 + v % 5 + H, 16:16 + W] for v in range(B)])
    nxt = np.stack([base[18 + v % 5:18 + v % 5 + H, 15:15 + W] for v in range(B)])
    mem = np.zeros((B, H // MEMSIZE, W // MEMSIZE), np.uint8)
    for i in range(B):
        y, x = rng.integers(0, 4), rng.integers(0, 6)
        mem[i, y:y + 2, x:x + 2] = 255
    mem[0] = 0
    mem[1] = 255
    return mem, prev.astype(np.uint8), nxt.astype(np.uint8)


@pytest.fixture(scope="module")
def seg_runs(tmp_path_factory):
    cfg = _seg_cfg()
    mem, prev, nxt = _seg_inputs()
    ref = make_sharded_seg_batch(make_mesh(1), cfg, warp_radius=RADIUS, kernel_mode="xla")(
        jnp.asarray(mem), jnp.asarray(prev), jnp.asarray(nxt))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    path = tmp_path_factory.mktemp("seg") / "inputs.npz"
    np.savez(path, mem=mem, prev=prev, next=nxt)
    port = run_ranks(4, "seg", inputs=str(path), cfg=dataclasses.asdict(cfg), radius=RADIUS,
                     model_parallel=2)
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    one = {mode: {k: v.numpy() for k, v in seg_batch_fast(mem, prev, nxt, tcfg, RADIUS, mode,
                                                             device="cpu").items()}
           for mode in ("xla", "fused")}
    return ref, port, one


def test_sharded_seg_matches_jax(seg_runs):
    ref, port, _ = seg_runs
    assert port["xla_mask"].shape == ref["mask"].shape == (B, H, W)
    assert (port["xla_mask"] == ref["mask"]).mean() >= 0.995
    assert (ref["mask"] > 0).any()
    np.testing.assert_array_equal(port["xla_box"], ref["box"])
    np.testing.assert_array_equal(port["xla_any_active"], ref["any_active"])
    assert not ref["any_active"][0] and ref["any_active"][1:].all()


@pytest.mark.parametrize("mode", ["xla", "fused"])
def test_sharded_seg_bit_equal_to_unsharded(seg_runs, mode):
    _, port, one = seg_runs
    for key in ("mask", "box", "any_active"):
        np.testing.assert_array_equal(port[f"{mode}_{key}"], one[mode][key], key)
    assert str(port["any_active_dtype"]) == "torch.bool"


def test_sharded_seg_refuses_a_ragged_batch(seg_runs):
    assert "does not divide over the 2 ranks of 'data'" in str(seg_runs[1]["odd_batch"])


@pytest.fixture(scope="module")
def halo_runs():
    n, hs, w, r = 4, 4, 3, 2
    proc = run_in_cpu_subprocess(
        f"""
        import json, numpy as np, jax
        from jax.sharding import Mesh, PartitionSpec as P
        from jax.experimental.shard_map import shard_map
        from nsof_tpu.parallel.spatial import halo_exchange_rows

        n, hs, w, r = {n}, {hs}, {w}, {r}
        x = np.arange(n * hs * w, dtype=np.float32).reshape(n * hs, w)
        mesh = Mesh(np.array(jax.devices()), ("space",))
        fn = shard_map(lambda a: halo_exchange_rows(a, r, "space", n), mesh=mesh,
                       in_specs=P("space", None), out_specs=P("space", None), check_rep=False)
        print(json.dumps(np.asarray(jax.jit(fn)(x)).reshape(n, hs + 2 * r, w).tolist()))
        """, n_devices=n, timeout=120)
    want = np.array(__import__("json").loads(proc.stdout.strip().splitlines()[-1]), np.float32)
    return want, run_ranks(n, "halo", n_rows=hs, width=w, halo=r), (n, hs, w, r)


def test_halo_rows_match_jax(halo_runs):
    want, port, _ = halo_runs
    np.testing.assert_array_equal(port["got"], want)


def test_halo_rows_uint8_batch_layout(halo_runs):
    """The ``[rows, B, W]`` slabs of the batch form: neighbours' rows inside,
    ``x[1:halo+1]`` flipped at the first rank, its mirror at the last."""
    _, port, (n, hs, _, r) = halo_runs
    x8 = port["x8"]
    for i in range(n):
        lo, hi = i * hs, (i + 1) * hs
        got = port["got8"][i]
        np.testing.assert_array_equal(got[r:-r], x8[lo:hi])
        np.testing.assert_array_equal(got[:r], x8[lo - r:lo] if i else x8[r:0:-1])
        np.testing.assert_array_equal(got[-r:], x8[hi:hi + r] if i < n - 1
                                      else x8[hi - 2:hi - 2 - r:-1])


def test_halo_needs_more_rows_than_halo():
    import torch

    with pytest.raises(ValueError, match="must exceed halo"):
        halo_exchange_rows(torch.zeros(2, 3), 2, None)


def _sp_inputs():
    rng = np.random.default_rng(1)
    import scipy.ndimage as ndi

    base = ndi.gaussian_filter(rng.uniform(0, 255, (SP_H + 8, SP_W + 8)).astype(np.float32), 3.0)
    prev, nxt = base[4:4 + SP_H, 4:4 + SP_W], base[6:6 + SP_H, 3:3 + SP_W]
    bprev = rng.uniform(0, 255, (2, SP_H, SP_W)).astype(np.float32)
    bnxt = rng.uniform(0, 255, (2, SP_H, SP_W)).astype(np.float32)
    return np.ascontiguousarray(prev), np.ascontiguousarray(nxt), bprev, bnxt


@pytest.fixture(scope="module")
def spatial_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sp")
    prev, nxt, bprev, bnxt = _sp_inputs()
    np.savez(tmp / "inputs.npz", prev=prev, next=nxt, bprev=bprev, bnext=bnxt)
    run_in_cpu_subprocess(
        f"""
        import numpy as np, jax
        from jax.sharding import Mesh
        from nsof_tpu.ops.farneback import FarnebackParams
        from nsof_tpu.parallel.spatial import make_spatial_flow, make_spatial_flow_batch
        jax.config.update("jax_default_matmul_precision", "highest")

        p = FarnebackParams{SP_PARAMS}
        z = np.load("{tmp / 'inputs.npz'}")
        devs = np.array(jax.devices())
        flow = make_spatial_flow(Mesh(devs, ("space",)), p, {SP_HALO})(z["prev"], z["next"])
        batch = make_spatial_flow_batch(Mesh(devs.reshape(2, 2), ("data", "space")), p,
                                        {SP_HALO})(z["bprev"], z["bnext"])
        np.savez("{tmp / 'jax.npz'}", flow=np.asarray(flow), batch=np.asarray(batch))
        """, n_devices=4, timeout=300)
    with np.load(tmp / "jax.npz") as z:
        ref = dict(z)
    port = run_ranks(4, "spatial", inputs=str(tmp / "inputs.npz"), params=list(SP_PARAMS),
                     halo=SP_HALO)
    one = farneback(prev, nxt, FarnebackParams(*SP_PARAMS), device="cpu").numpy()
    return ref, port, one


def _interior_close(got, want):
    band = slice(SP_HALO, SP_H - SP_HALO)
    err = np.abs(got[..., band, :, :] - want[..., band, :, :])
    assert err.max() <= FLOW_MAX and err.mean() <= FLOW_MEAN, (err.max(), err.mean())


def test_spatial_flow_matches_jax(spatial_runs):
    ref, port, _ = spatial_runs
    assert port["flow"].shape == ref["flow"].shape == (SP_H, SP_W, 2)
    _interior_close(port["flow"], ref["flow"])


def test_spatial_flow_matches_unsharded(spatial_runs):
    _, port, one = spatial_runs
    _interior_close(port["flow"], one)


def test_spatial_batch_matches_jax_and_per_pair(spatial_runs):
    ref, port, _ = spatial_runs
    assert port["batch"].shape == ref["batch"].shape == (2, SP_H, SP_W, 2)
    _interior_close(port["batch"], ref["batch"])
    assert np.abs(port["batch"] - port["per_pair"]).max() <= 1e-4
