"""One RAFT train step of the port (``nsof_tpu_torch/parallel/train.py``)
against the JAX package's ``make_train_step`` on a one-device CPU mesh.

RAFT-small and RAFT-basic at 64×96, B = 2, 2 iterations, from one set of
seeded random Flax weights (``tests/torch_deep_weights.py``) carried into
the port by ``params_from_jax``; one batch made with numpy from a seed (a
texture and its shifted copy, the flow the shift plus noise, a tenth of the
pixels invalid).  The JAX step runs with ``optax.chain(record, raft_optimizer)``
where ``record`` keeps the incoming gradients in its state and passes them
on, so the one compiled step gives the loss, the metrics, the gradients and
the updated parameters.  ``params_from_jax`` is linear (transposes, splits,
concatenations), so it carries the Flax gradient tree onto the port's
``.grad``s too.

Held to the bounds of ``tests/torch_train_common.py``, and the count of
parameter elements that step the other way to ≤ 0.5 %.

Measured here: loss 2e-7 relative apart, metrics equal to 4e-7; the
gradients within 1e-5 of each tensor's largest (RAFT-small, but for the
zero-gradient biases) and within 2.1e-4 of the model's largest (RAFT-basic's
feature encoder, as its own float64 gradient), the whole gradient 3.1e-4
apart in L2 (RAFT-basic); parameters within 2·lr₀, with 0.01 % (small) and
0.11 % (basic) of the elements past 1e-6·max |p|.  Also ``remat=True`` against
``remat=False`` in the port: the loss equal and the gradients within 1e-6
(``tests/test_training.py``'s check of the JAX package), and the step's
metrics are 0-dim tensors that the loop reads in one transfer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nsof_tpu.models import raft as jraft
from nsof_tpu.parallel import train as jtrain
from nsof_tpu.parallel.mesh import make_mesh
from nsof_tpu.train.optim import raft_optimizer as jax_raft_optimizer
from nsof_tpu_torch.models import raft as traft
from nsof_tpu_torch.models.convert import params_from_jax
from nsof_tpu_torch.parallel import train as ttrain
from nsof_tpu_torch.train.optim import raft_optimizer
from tests.torch_deep_weights import raft_params
from tests.torch_train_common import LOSS_RTOL, grad_errors, make_batch, record_grads
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

ITERS = 2
LR, NUM_STEPS = 4e-4, 100
FLIP_FRACTION = 5e-3
KINDS = ("small", "basic")


def _cfgs(kind):
    kw = dict(small=kind == "small", iters=ITERS, corr_radius=3 if kind == "small" else 4)
    return jraft.RaftConfig(**kw), traft.RaftConfig(**kw)


@pytest.fixture(scope="module")
def jax_steps():
    """Per kind: (Flax params, batch, loss, metrics, grads, updated params)."""
    out = {}
    batch = make_batch()
    for kind in KINDS:
        jcfg, _ = _cfgs(kind)
        params = raft_params(jcfg, seed=0)
        tx = optax.chain(record_grads(), jax_raft_optimizer(lr=LR, num_steps=NUM_STEPS))
        # copies: the step donates its state, which may alias numpy memory
        state = jtrain.TrainState(jax.tree.map(jnp.array, params), tx.init(params),
                                  jnp.zeros((), jnp.int32))
        step = jtrain.make_train_step(jraft.RAFT(jcfg), tx, make_mesh(1), iters=ITERS)
        new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        out[kind] = (params, batch, {k: float(v) for k, v in metrics.items()},
                     jax.tree.map(np.asarray, new.opt_state[0]),
                     jax.tree.map(np.asarray, new.params))
    return out


def _port(kind, params):
    _, tcfg = _cfgs(kind)
    model = traft.RAFT(tcfg)
    model.load_state_dict(params_from_jax(params, tcfg))
    tx = raft_optimizer(model, lr=LR, num_steps=NUM_STEPS)
    return model, tx, tcfg


@pytest.mark.parametrize("kind", KINDS)
def test_loss_and_metrics_match_jax(kind, jax_steps):
    params, batch, metrics, _, _ = jax_steps[kind]
    model, tx, _ = _port(kind, params)
    step = ttrain.make_train_step(model, tx, "cpu", iters=ITERS)
    state, got = step(ttrain.TrainState(model, tx), batch)
    assert state.step == 1
    assert sorted(got) == sorted(metrics) == ["1px", "3px", "5px", "epe", "loss"]
    assert all(v.ndim == 0 for v in got.values())
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=LOSS_RTOL, err_msg=k)
    assert metrics["loss"] > 1.0


@pytest.mark.parametrize("kind", KINDS)
def test_gradients_match_jax(kind, jax_steps):
    params, batch, _, grads, _ = jax_steps[kind]
    model, tx, tcfg = _port(kind, params)
    want = params_from_jax(grads, tcfg)
    b = ttrain.to_device(batch, torch.device("cpu"))
    from nsof_tpu_torch.train.loss import sequence_loss

    loss, _ = sequence_loss(model(b["image1"], b["image2"], iters=ITERS), b["flow"], b["valid"])
    loss.backward()
    names = dict(model.named_parameters())
    assert len(names) > 50
    grad_errors(names, want)


@pytest.mark.parametrize("kind", KINDS)
def test_updated_parameters_match_jax(kind, jax_steps):
    params, batch, _, _, new_params = jax_steps[kind]
    model, tx, tcfg = _port(kind, params)
    lr0 = tx.lrs()[0]
    assert lr0 == pytest.approx(LR / 25, rel=1e-6)
    ttrain.make_train_step(model, tx, "cpu", iters=ITERS)(ttrain.TrainState(model, tx), batch)
    want = params_from_jax(new_params, tcfg)
    flipped = total = 0
    for name, p in model.named_parameters():
        got, ref = p.detach().numpy(), want[name].numpy()
        scale = np.abs(ref).max()
        err = np.abs(got - ref)
        assert err.max() <= 2 * lr0 + 1e-6 * scale, (name, err.max())
        flipped += int((err > 1e-6 * scale).sum())
        total += err.size
    assert flipped <= FLIP_FRACTION * total, (flipped, total)


@pytest.mark.parametrize("kind", KINDS)
def test_remat_gradients_equal(kind):
    """``remat=True`` recomputes each refinement step in the backward pass:
    the same loss and gradients within 1e-6 of the stored-activation run."""
    _, tcfg = _cfgs(kind)
    batch = ttrain.to_device(make_batch(seed=5), torch.device("cpu"))
    from nsof_tpu_torch.train.loss import sequence_loss

    grads, losses = [], []
    for remat in (False, True):
        torch.manual_seed(0)
        model = traft.RAFT(dataclasses.replace(tcfg, remat=remat))
        loss, _ = sequence_loss(model(batch["image1"], batch["image2"], iters=ITERS),
                                batch["flow"], batch["valid"])
        loss.backward()
        losses.append(float(loss))
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert losses[0] == losses[1]
    for name, g in grads[0].items():
        assert (grads[1][name] - g).abs().max().item() <= 1e-6, name
