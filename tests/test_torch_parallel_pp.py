"""The port's pipeline parallelism (``parallel/pipeline.py``) against the JAX
package's, the JAX side on a virtual CPU mesh in a subprocess
(``run_in_cpu_subprocess``), the port's in gloo ranks (``tests/torch_dist.py``).

- ``pipeline_stages``: 4 distinct tanh-linear stages × 6 microbatches with a
  per-microbatch scale in ``micro_consts`` (JAX's
  ``test_pipeline_stages_match_sequential``, in float64 on both sides),
  within 1e-6 of JAX's and of the sequential composition; a dict
  activation of two leaves through tied stages; one stage (JAX's
  single-stage test) equal to the map.
- ``make_raft_pp_flow``: RAFT-small, S = 2 stages of 2 iterations, M = 2
  microbatches of B = 1 at 32×48, seeded Flax weights carried by
  ``params_from_jax``: within 1e-3 px of JAX's pipelined flow, and within
  2e-4 px of the port's own unsharded test-mode forward (RAFT-basic too,
  whose convex-upsampling mask rides the activation).
- iterations that do not divide over the stages raise ``ValueError`` and
  ``corr_mode='alternate'`` ``NotImplementedError``, as in JAX
  (``tests/test_pipeline_pp.py``).
"""

import numpy as np
import pytest
import torch

from nsof_tpu.models import raft as jraft
from nsof_tpu_torch.models import raft as traft
from nsof_tpu_torch.models.convert import params_from_jax
from tests.conftest import run_in_cpu_subprocess
from tests.torch_deep_weights import raft_params
from tests.torch_dist import run_ranks
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

S, M, D = 4, 6, 8
PP_S, PP_M, PP_B, PP_H, PP_W, PP_ITERS = 2, 2, 1, 32, 48, 4
PP_JAX_TOL, PP_PORT_TOL = 1e-3, 2e-4


@pytest.fixture(scope="module")
def combinator(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    rng = np.random.default_rng(0)
    # float64 on both sides: the combinator adds no arithmetic, so the two
    # packages' tanh and product roundings (≈ 2e-6 apart in float32 after 4
    # stages) must not hide what it does
    inputs = {"Ws": rng.normal(size=(S, D, D)), "bs": rng.normal(size=(S, D)),
              "xs": rng.normal(size=(M, 3, D)), "scale": rng.uniform(0.5, 1.5, (M, 1, 1))}
    np.savez(tmp / "inputs.npz", **inputs)
    run_in_cpu_subprocess(
        f"""
        import numpy as np, jax, jax.numpy as jnp
        from jax.sharding import Mesh
        from nsof_tpu.parallel.pipeline import pipeline_stages
        jax.config.update("jax_enable_x64", True)

        z = np.load("{tmp / 'inputs.npz'}")
        mesh = Mesh(np.array(jax.devices()[:{S}]), ("stage",))

        def stage_fn(params, const, act):
            w, b = params
            return jnp.tanh(act @ w + b) * const

        out = pipeline_stages(mesh, stage_fn, (jnp.asarray(z["Ws"]), jnp.asarray(z["bs"])),
                              jnp.asarray(z["xs"]), jnp.asarray(z["scale"]))
        np.save("{tmp / 'jax.npy'}", np.asarray(out))
        """, n_devices=S, timeout=120)
    port = run_ranks(S, "pipeline", inputs=str(tmp / "inputs.npz"))
    return inputs, np.load(tmp / "jax.npy"), port


def test_pipeline_stages_match_jax_and_sequential(combinator):
    inputs, want, port = combinator
    np.testing.assert_allclose(port["out"], want, rtol=0, atol=1e-6)
    ref = inputs["xs"]
    for s in range(S):
        ref = np.tanh(ref @ inputs["Ws"][s] + inputs["bs"][s]) * inputs["scale"]
    np.testing.assert_allclose(port["out"], ref, rtol=0, atol=1e-6)


def test_pipeline_dict_activation_and_single_stage(combinator):
    inputs, _, port = combinator
    xs = inputs["xs"]
    a, b = xs.copy(), np.zeros_like(xs)
    for _ in range(S):
        a, b = a * 2.0, b + a
    np.testing.assert_allclose(port["dict_a"], a, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port["dict_b"], b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port["single"], xs * 2.0, rtol=0, atol=0)


def test_raft_pp_validates_like_jax(combinator):
    port = combinator[2]
    assert "divide" in str(port["not_divisible"])
    assert "alternate" in str(port["alternate"])


@pytest.fixture(scope="module")
def raft_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("raft_pp")
    rng = np.random.default_rng(0)
    img1 = rng.integers(0, 256, (PP_M, PP_B, PP_H, PP_W, 3)).astype(np.float32)
    img2 = rng.integers(0, 256, (PP_M, PP_B, PP_H, PP_W, 3)).astype(np.float32)
    inputs = tmp / "inputs.npz"
    np.savez(inputs, img1=img1, img2=img2)
    weights = {}
    for kind in ("small", "basic"):
        params = raft_params(jraft.RaftConfig(small=kind == "small", iters=PP_ITERS), seed=0)
        weights[kind] = params_from_jax(params, traft.RaftConfig(small=kind == "small"))
        torch.save(weights[kind], f"{inputs}.{kind}.pt")
    run_in_cpu_subprocess(
        f"""
        import numpy as np, jax, jax.numpy as jnp
        from jax.sharding import Mesh
        from nsof_tpu.models.raft import RaftConfig
        from nsof_tpu.parallel.pipeline import make_raft_pp_flow
        from tests.torch_deep_weights import raft_params
        jax.config.update("jax_default_matmul_precision", "highest")

        cfg = RaftConfig(small=True, iters={PP_ITERS})
        z = np.load("{inputs}")
        mesh = Mesh(np.array(jax.devices()[:{PP_S}]), ("stage",))
        out = make_raft_pp_flow(mesh, cfg)({{"params": raft_params(cfg, seed=0)}},
                                           jnp.asarray(z["img1"]), jnp.asarray(z["img2"]))
        np.save("{tmp / 'jax.npy'}", np.asarray(out))
        """, n_devices=PP_S, timeout=300)
    port = run_ranks(PP_S, "raft_pp", inputs=str(inputs), kinds=["small", "basic"],
                     iters=PP_ITERS)
    one = {}
    for kind in ("small", "basic"):
        model = traft.RAFT(traft.RaftConfig(small=kind == "small", iters=PP_ITERS))
        model.load_state_dict(weights[kind])
        model.eval()
        with torch.no_grad():
            one[kind] = np.stack([model(torch.from_numpy(img1[m]), torch.from_numpy(img2[m]),
                                        test_mode=True)[1].numpy() for m in range(PP_M)])
    return np.load(tmp / "jax.npy"), port, one


def test_raft_pp_matches_jax(raft_runs):
    want, port, _ = raft_runs
    assert port["small"].shape == want.shape == (PP_M, PP_B, PP_H, PP_W, 2)
    assert np.abs(port["small"] - want).max() <= PP_JAX_TOL
    assert np.abs(want).max() > 1e-2


@pytest.mark.parametrize("kind", ["small", "basic"])
def test_raft_pp_matches_unsharded_forward(raft_runs, kind):
    _, port, one = raft_runs
    assert port[kind].shape == one[kind].shape
    assert np.abs(port[kind] - one[kind]).max() <= PP_PORT_TOL
