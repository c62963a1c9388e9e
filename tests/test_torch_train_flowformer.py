"""One FlowFormer train step of the port (``make_flowformer_step``) against
the JAX package's on a one-device CPU mesh, with the twins backbone group
(``twins_lr_factor=0.05``).

FlowFormer with RAFT-encoder backbones (``feat_encoder``,
``context_encoder``: the group the factor applies to), 4 latent tokens of
32, encoder depth 1, decoder depth 2, at 64×96, B = 2, from seeded random
Flax weights carried into the port by ``params_from_jax``; the batch of
``tests/torch_train_common.py``.  As in ``tests/test_torch_train_step.py``,
the JAX step's optimizer is ``optax.chain(record,
flowformer_optimizer(...))``, so one compiled step
gives the loss, the metrics (the ``{t}-th-5px`` buckets included), the
gradients and the updated parameters.  Held to the bounds of
``tests/torch_train_common.py`` (measured: the gradients 7.7e-4 apart in
L2, the largest difference 2.2e-3 of the model's largest gradient, on the
motion encoder's ``convc1``, as far as the port's float32 gradient is from
its float64 one; parameters within 2·lr₀ of each group).  Also
``FlowFormerConfig.remat`` (the same gradients within 1e-6), and the twins
group: the parameters the port's ``flowformer_optimizer`` puts in the
backbone group are exactly those optax labels 'backbone', read from optax's
first update on unit gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nsof_tpu.models.flowformer import config as jconfig
from nsof_tpu.models.flowformer import model as jmodel
from nsof_tpu.parallel import train as jtrain
from nsof_tpu.parallel.mesh import make_mesh
from nsof_tpu.train.optim import flowformer_optimizer as jax_ff_optimizer
from nsof_tpu_torch.models.flowformer import config as tconfig
from nsof_tpu_torch.models.flowformer import model as tmodel
from nsof_tpu_torch.models.flowformer.convert import params_from_jax
from nsof_tpu_torch.parallel import train as ttrain
from nsof_tpu_torch.train.loss import flowformer_sequence_loss
from nsof_tpu_torch.train.optim import flowformer_optimizer
from tests.torch_deep_weights import flowformer_params
from tests.torch_train_common import LOSS_RTOL, grad_errors, make_batch, record_grads
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

CFG = dict(cost_latent_token_num=4, cost_latent_dim=32, cnet="basic", fnet="basic",
           encoder_depth=1, decoder_depth=2)
OPT = dict(lr=2.5e-4, num_steps=100, wdecay=1e-4, twins_lr_factor=0.05)


@pytest.fixture(scope="module")
def jax_step():
    """(Flax params, batch, metrics, grads, updated params)."""
    jcfg = jconfig.FlowFormerConfig(**CFG)
    params = flowformer_params(jcfg, seed=0)
    batch = make_batch()
    tx = optax.chain(record_grads(), jax_ff_optimizer(**OPT))
    state = jtrain.TrainState(jax.tree.map(jnp.array, params), tx.init(params),
                              jnp.zeros((), jnp.int32))
    step = jtrain.make_flowformer_step(jmodel.FlowFormer(jcfg), tx, make_mesh(1))
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return (params, batch, {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, new.opt_state[0]), jax.tree.map(np.asarray, new.params))


def _port(params, **cfg):
    tcfg = tconfig.FlowFormerConfig(**CFG, **cfg)
    model = tmodel.FlowFormer(tcfg)
    model.load_state_dict(params_from_jax(params, tconfig.FlowFormerConfig(**CFG)))
    return model, flowformer_optimizer(model, **OPT)


def test_flowformer_step_matches_jax(jax_step):
    params, batch, metrics, grads, new_params = jax_step
    tcfg = tconfig.FlowFormerConfig(**CFG)
    want_g = params_from_jax(grads, tcfg)
    want_p = params_from_jax(new_params, tcfg)

    # the gradients, from a backward pass of the port's model alone
    model, _ = _port(params)
    b = ttrain.to_device(batch, torch.device("cpu"))
    loss, _ = flowformer_sequence_loss(model(b["image1"], b["image2"]), b["flow"], b["valid"])
    loss.backward()
    named = dict(model.named_parameters())
    grad_errors(named, want_g)

    # the step: loss, metrics, updated parameters, each group's rate
    model, tx = _port(params)
    lr0 = tx.lrs()
    assert lr0 == pytest.approx([OPT["lr"] / 25, OPT["lr"] * 0.05 / 25], rel=1e-6)
    step = ttrain.make_flowformer_step(model, tx, "cpu")
    state, got = step(ttrain.TrainState(model, tx), batch)
    assert state.step == 1 and sorted(got) == sorted(metrics)
    for k, v in metrics.items():
        if np.isnan(v):
            assert np.isnan(float(got[k])), k
        else:
            np.testing.assert_allclose(float(got[k]), v, rtol=LOSS_RTOL, err_msg=k)
    backbone = {id(p) for p in tx.optimizer.param_groups[1]["params"]}
    assert 0 < len(backbone) < len(named)
    for name, p in model.named_parameters():
        ref = want_p[name].numpy()
        rate = lr0[1] if id(p) in backbone else lr0[0]
        err = np.abs(p.detach().numpy() - ref).max()
        assert err <= 2 * rate + 1e-6 * np.abs(ref).max(), (name, err)


def test_flowformer_remat_gradients_equal(jax_step):
    params, batch = jax_step[:2]
    b = ttrain.to_device(batch, torch.device("cpu"))
    grads = []
    for remat in (False, True):
        model, _ = _port(params, remat=remat)
        assert model.cfg.remat == remat
        loss, _ = flowformer_sequence_loss(model(b["image1"], b["image2"]), b["flow"],
                                           b["valid"])
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        assert (grads[1][name] - g).abs().max().item() <= 1e-6, name


def test_twins_group_is_optax_backbone_label(jax_step):
    """The parameters the port puts in the backbone group are exactly those
    optax's ``multi_transform`` labels 'backbone': with unit gradients and
    no decay, optax's first update is -lr₀ on every element of the main
    group and -0.05·lr₀ on the backbone's (to 1e-3: the clipped gradient is
    ≈ 1e-3, so eps moves g/(|g| + eps) by 1e-5)."""
    params = jax_step[0]
    tx = jax_ff_optimizer(**dict(OPT, wdecay=0.0))

    def first_update(p):
        return tx.update(jax.tree.map(jnp.ones_like, p), tx.init(p), p)[0]

    lr0 = OPT["lr"] / 25
    ratio = jax.tree.map(lambda u: np.asarray(u) / -lr0, jax.jit(first_update)(params))
    assert all(np.allclose(r, 0.05, rtol=1e-3) or np.allclose(r, 1.0, rtol=1e-3)
               for r in jax.tree.leaves(ratio))
    labels = jax.tree.map(
        lambda r: np.full(r.shape, float(np.allclose(r, 0.05, rtol=1e-3)), np.float32), ratio)
    want = params_from_jax(labels, tconfig.FlowFormerConfig(**CFG))
    model, tx = _port(params)
    backbone = {id(p) for p in tx.optimizer.param_groups[1]["params"]}
    for name, p in model.named_parameters():
        label = want[name]
        assert bool(label.all()) or not bool(label.any()), name
        assert (id(p) in backbone) == bool(label.all()), name
    assert 0 < len(backbone) < len(list(model.parameters()))
