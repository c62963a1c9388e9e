"""Shared pieces of the port's train-step parity tests
(``tests/test_torch_train_step.py``, ``tests/test_torch_train_flowformer.py``):
the batch, the optax probe that records the gradients, and the bounds.

- loss and every metric: LOSS_RTOL relative;
- each gradient tensor: max |Δ| ≤ GRAD_RTOL · max |g| of that tensor +
  GRAD_ATOL · max |g| of the model, and the whole gradient's relative L2
  distance ≤ GRAD_L2.  The model-wide term covers what float32 cannot
  resolve: the biases in front of an instance norm have a gradient of 0
  that both packages compute as rounding noise (≈ 1e-7 of the model's
  largest), and some tensors' gradients are sums that cancel far below
  their terms, where the port's own float32 gradient is as far from its
  float64 gradient as from the JAX package's: 2.1e-4 of the model's largest
  (RAFT-basic's feature encoder), 2.2e-3 (FlowFormer's motion encoder
  ``convc1``, behind the cost-memory attention); the L2 distances measured
  3.1e-4 (RAFT-basic) and 7.7e-4 (FlowFormer);
- each parameter after the update: max |Δ| ≤ 2·lr₀ + 1e-6·max |p|, where
  lr₀ is the first update's rate of the parameter's group: Adam's first
  step moves each element by lr₀·g/(|g| + eps) ≈ ±lr₀, so an element whose
  gradient is rounding noise may step the other way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from tests.torch_deep_weights import frame_pair

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
GRAD_ATOL = 5e-3
GRAD_L2 = 2e-3


def make_batch(b=2, h=64, w=96, seed=3):
    """A train batch from a seed: a texture and its shifted copy, the flow
    the shift plus noise, a tenth of the pixels invalid."""
    i1, i2 = frame_pair(b, h, w, seed=seed, shift=(2, 3))
    rng = np.random.default_rng(seed)
    flow = np.empty((b, h, w, 2), np.float32)
    flow[..., 0], flow[..., 1] = 3.0, 2.0
    flow += rng.normal(0, 0.5, flow.shape).astype(np.float32)
    valid = (rng.random((b, h, w)) > 0.1).astype(np.float32)
    return {"image1": i1.astype(np.float32), "image2": i2.astype(np.float32),
            "flow": flow, "valid": valid}


def record_grads():
    """An optax transformation that keeps the incoming updates (the
    gradients) as its state and passes them on unchanged."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def grad_errors(named, want) -> float:
    """Assert each port gradient of ``named`` (name → parameter) against
    ``want`` (name → tensor) to the bounds above; returns the relative L2
    distance."""
    top = max(np.abs(want[n].numpy()).max() for n in named)
    sq_err = sq_ref = 0.0
    for name, p in named.items():
        got, ref = p.grad.numpy(), want[name].numpy()
        err = np.abs(got - ref).max()
        assert err <= GRAD_RTOL * np.abs(ref).max() + GRAD_ATOL * top, (name, err, top)
        sq_err += float(((got - ref) ** 2).sum())
        sq_ref += float((ref ** 2).sum())
    l2 = float(np.sqrt(sq_err / sq_ref))
    assert l2 <= GRAD_L2
    return l2
