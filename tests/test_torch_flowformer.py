"""The port's FlowFormer (``nsof_tpu_torch/models/flowformer/``) against the
JAX package's.

The whole model at reduced depth (``encoder_depth=1, decoder_depth=2``; the
widths are things_eval's: Twins-SVT-large's first two stages, 8 latent
tokens of 128, vert_c_dim 64, GMA) at 64×96, under seeded random weights
(``tests/torch_deep_weights.py``) carried both ways: the Flax tree into the
port by ``params_from_jax`` (which stacks the GSA's k and v into the fused
``kv``), and the port's own random ``state_dict()`` into Flax by the JAX
package's ``convert_flowformer``.  Held to 1e-3 px max.  Also
small_things_eval's structure (RAFT BasicEncoder backbones, 4 tokens of
32) at the same depth, with vert_c_dim 64 where the preset has 0, at which
the JAX model fails to initialise; the Twins backbone
alone at a size whose stage-1 grid is not a multiple of the 7-pixel
window; train mode; tiled inference's grid, weights and blend; the
experiment presets; FlowFormer as the backend of the batched deep step.

Measured here: 9.7e-5 px (things_eval widths, flows up to 21 px), 7.2e-5
px (basic backbones, up to 16 px), 1.7e-6 px the other way (the port's
default initialisation, flows ≈ 0.9 px); the Twins features within 8.4e-6
(features up to 13).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsof_tpu.models.flowformer import config as jconfig
from nsof_tpu.models.flowformer import model as jmodel
from nsof_tpu.models.flowformer.convert import convert_flowformer
from nsof_tpu.models.flowformer.twins import TwinsSVTLarge2Stage as JTwins
from nsof_tpu_torch.models.flowformer import config as tconfig
from nsof_tpu_torch.models.flowformer import model as tmodel
from nsof_tpu_torch.models.flowformer.convert import params_from_jax
from nsof_tpu_torch.models.flowformer.twins import TwinsSVTLarge2Stage
from tests.torch_deep_weights import flowformer_params, frame_pair, random_params
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

FLOW_TOL = 1e-3  # px
FEAT_TOL = 1e-4  # Twins features
REDUCED = dict(encoder_depth=1, decoder_depth=2)
# small_things_eval's structure but vert_c_dim 64: the JAX model cannot be
# initialised at its vert_c_dim 0 (a Dense of 0 features)
SMALL = dict(cost_latent_token_num=4, cost_latent_dim=32, cnet="basic", fnet="basic",
             **REDUCED)
VARIANTS = {"things_eval": REDUCED, "basic_backbones": SMALL}


def _jax_flow(jcfg, params, a, b):
    model = jmodel.FlowFormer(jcfg)
    return np.asarray(jax.jit(lambda p, x, y: model.apply({"params": p}, x, y, test_mode=True))(
        params, a, b))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flowformer_matches_flax(variant):
    jcfg = jconfig.FlowFormerConfig(**VARIANTS[variant])
    tcfg = tconfig.FlowFormerConfig(**VARIANTS[variant])
    a, b = frame_pair(1, 64, 96)
    params = flowformer_params(jcfg, seed=0)
    up = _jax_flow(jcfg, params, a, b)
    model = tmodel.FlowFormer(tcfg)
    model.load_state_dict(params_from_jax(params, tcfg))
    with torch.no_grad():
        tup = model(torch.from_numpy(a), torch.from_numpy(b), test_mode=True)
    assert tup.shape == up.shape == (1, 64, 96, 2)
    assert np.abs(up).max() > 1.0
    np.testing.assert_allclose(tup.numpy(), up, rtol=0, atol=FLOW_TOL)


def test_port_weights_through_the_jax_converter():
    jcfg = jconfig.FlowFormerConfig(**REDUCED)
    a, b = frame_pair(1, 64, 96, seed=2)
    torch.manual_seed(0)
    model = tmodel.FlowFormer(tconfig.FlowFormerConfig(**REDUCED))
    with torch.no_grad():
        model.memory_decoder.update_block.aggregator.gamma.fill_(0.3)  # GMA on
        tup = model(torch.from_numpy(a), torch.from_numpy(b), test_mode=True)
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    up = _jax_flow(jcfg, convert_flowformer(state, jcfg), a, b)
    np.testing.assert_allclose(tup.numpy(), up, rtol=0, atol=FLOW_TOL)


def test_twins_backbone_matches_flax():
    """72×104: stage 1 is 18×26, padded to 21×28 for the 7×7 windows."""
    rng = np.random.default_rng(3)
    x = (rng.random((2, 72, 104, 3)) * 2 - 1).astype(np.float32)
    jnet = JTwins()
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params = random_params(shapes["params"], seed=4)
    want = np.asarray(jax.jit(lambda p, v: jnet.apply({"params": p}, v))(params, x))
    state = params_from_jax({"context_encoder": params, **_rest_of_model()},
                            tconfig.FlowFormerConfig(**REDUCED))
    net = TwinsSVTLarge2Stage()
    net.load_state_dict({k[len("context_encoder."):]: v for k, v in state.items()
                         if k.startswith("context_encoder.")})
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert got.shape == want.shape == (2, 9, 13, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FEAT_TOL)


def _rest_of_model():
    """The parameters of a reduced model other than its context encoder
    (``params_from_jax`` converts whole models only)."""
    params = flowformer_params(jconfig.FlowFormerConfig(**REDUCED), seed=5)
    return {k: v for k, v in params.items() if k != "context_encoder"}


def test_train_mode_is_the_per_step_flows():
    torch.manual_seed(6)
    model = tmodel.FlowFormer(tconfig.FlowFormerConfig(**REDUCED))
    a, b = (torch.from_numpy(x) for x in frame_pair(1, 64, 96))
    with torch.no_grad():
        flows = model(a, b)
        assert len(flows) == REDUCED["decoder_depth"]
        torch.testing.assert_close(flows[-1], model(a, b, test_mode=True), rtol=0, atol=0)


def test_bfloat16_compute_dtype():
    """``compute_dtype=torch.bfloat16``: autocast over the whole model, the
    flow float32, moved but within 5 % of the float32 flow's largest value
    (measured 0.7 %)."""
    torch.manual_seed(7)
    f32 = tmodel.FlowFormer(tconfig.FlowFormerConfig(**REDUCED))
    bf16 = tmodel.FlowFormer(tconfig.FlowFormerConfig(compute_dtype=torch.bfloat16, **REDUCED))
    bf16.load_state_dict(f32.state_dict())
    a, b = (torch.from_numpy(x) for x in frame_pair(1, 64, 96))
    with torch.no_grad():
        want, got = f32(a, b, test_mode=True), bf16(a, b, test_mode=True)
    assert got.dtype == torch.float32
    err = (got - want).abs().max().item()
    assert 0 < err < 0.05 * want.abs().max().item()


@pytest.mark.parametrize("shape,patch", [((480, 1280), (432, 960)), ((436, 1024), (432, 960)),
                                         ((64, 96), (64, 96)), ((100, 150), (64, 96))])
def test_tiled_inference_matches_jax(shape, patch):
    hws = tmodel.compute_grid_indices(shape, patch)
    assert hws == jmodel.compute_grid_indices(shape, patch)
    np.testing.assert_array_equal(tmodel.compute_weight(hws, shape, patch),
                                  jmodel.compute_weight(hws, shape, patch))
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, (1, *shape, 3)).astype(np.uint8)
    b = rng.integers(0, 256, (1, *shape, 3)).astype(np.uint8)

    def fake(x, y):  # a flow that depends on the tile's content
        return np.stack([x[..., 0] - y[..., 1], x[..., 2] * 0.5], -1).astype(np.float32)

    got = tmodel.tiled_flow(lambda x, y: torch.from_numpy(fake(x, y)), a, b, patch)
    np.testing.assert_allclose(got, jmodel.tiled_flow(fake, a, b, patch), rtol=1e-6, atol=1e-4)


def test_deep_roi_flow_batch_on_flowformer():
    """FlowFormer as the deep backend of ``deep_roi_flow_batch`` on
    ``tests/test_torch_deep_flow.py``'s three samples, against the JAX step:
    boxes, activity equal, flows within 1e-3 px, masks ≥ 99.5 % equal."""
    from nsof_tpu.pipelines import deep_flow as jdf
    from nsof_tpu_torch.pipelines import deep_flow as tdf
    from tests.test_torch_deep_flow import BATCH_KEYS, JCFG, TCFG, _close, _inputs

    params = flowformer_params(jconfig.FlowFormerConfig(**REDUCED), seed=1)
    model = tmodel.FlowFormer(tconfig.FlowFormerConfig(**REDUCED))
    model.load_state_dict(params_from_jax(params, model.cfg))
    jbe = jdf.DeepBackend.from_flowformer(jmodel.FlowFormer(jconfig.FlowFormerConfig(**REDUCED)),
                                          params)
    tbe = tdf.DeepBackend.from_flowformer(model, device="cpu")
    mem, prev, nxt, _ = _inputs()
    want = jax.jit(lambda m, p, n: jdf.deep_roi_flow_batch(m, p, n, JCFG, jbe))(mem, prev, nxt)
    _close(tdf.deep_roi_flow_batch(mem, prev, nxt, TCFG, tbe), want, BATCH_KEYS)


# JAX's model config also carries a `dropout` that no preset turns on and
# copies of the trainer block, which the port keeps on the experiment alone
TRAINING_ONLY = {"dropout", "gamma", "max_flow", "canonical_lr",
                 "adamw_decay", "clip", "num_steps", "epsilon"}


def test_config_and_presets_match_jax():
    # the port's one more field, `gsa_pad`, defaults to the JAX model's 'same'
    fields = {f.name for f in dataclasses.fields(jconfig.FlowFormerConfig)} - TRAINING_ONLY
    assert fields | {"gsa_pad"} == {f.name for f in dataclasses.fields(tconfig.FlowFormerConfig)}
    assert sorted(tconfig.FF_EXPERIMENTS) == sorted(jconfig.FF_EXPERIMENTS)
    for name, j in jconfig.FF_EXPERIMENTS.items():
        t = tconfig.get_experiment(name)
        for f in dataclasses.fields(j):
            if f.name == "model":
                assert all(getattr(t.model, g) == getattr(j.model, g)
                           for g in fields - {"compute_dtype"}), name
                assert (j.model.dropout, j.model.remat, t.model.remat) == (0.0, False, False), name
                assert t.model.gsa_pad == "same", name
                assert all(getattr(j.model, g) == getattr(j, g)
                           for g in TRAINING_ONLY - {"dropout"}), name
            else:
                assert getattr(t, f.name) == getattr(j, f.name), (name, f.name)
    assert (tconfig.TRAIN_SIZE, tconfig.TILE_MIN_OVERLAP) == (jconfig.TRAIN_SIZE,
                                                              jconfig.TILE_MIN_OVERLAP)
    with pytest.raises(KeyError, match="unknown FlowFormer experiment"):
        tconfig.get_experiment("nope")
