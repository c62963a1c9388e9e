"""Seeded random weights for the deep backends' parity tests: one Flax
parameter tree (from numpy) that the JAX model runs as it is and the port
runs through ``params_from_jax``.

Kernels are N(0, 1/fan_in) (Flax's default LeCun-normal scale, so the
activations stay in range through the encoders), LayerNorm and GroupNorm
scales 1 + N(0, 0.1²), biases, GMA's gamma and the rest N(0, 0.1²), the
latent tokens N(0, 1): every tensor differs from its default, so a tensor
carried to the wrong place shows in the flow.
"""

import jax
import jax.numpy as jnp
import numpy as np

from nsof_tpu.models.flowformer import FlowFormer as JFlowFormer
from nsof_tpu.models.raft import RAFT as JRAFT


def random_params(shapes, seed: int):
    rng = np.random.default_rng(seed)

    def fill(path, spec):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(spec.shape)
                    / np.sqrt(np.prod(spec.shape[:-1]))).astype(np.float32)
        if name == "scale":
            return (1 + 0.1 * rng.standard_normal(spec.shape)).astype(np.float32)
        if name == "latent_tokens":
            return rng.standard_normal(spec.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(spec.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def raft_params(cfg, seed: int = 0):
    """A JAX RAFT(cfg) parameter tree of seeded numpy arrays."""
    x = jnp.zeros((1, 64, 64, 3))
    shapes = jax.eval_shape(lambda: JRAFT(cfg).init(jax.random.PRNGKey(0), x, x, iters=1))
    return random_params(shapes["params"], seed)


def flowformer_params(cfg, seed: int = 0):
    """A JAX FlowFormer(cfg) parameter tree of seeded numpy arrays."""
    x = jnp.zeros((1, 64, 96, 3))
    shapes = jax.eval_shape(lambda: JFlowFormer(cfg).init(jax.random.PRNGKey(0), x, x))
    return random_params(shapes["params"], seed)


def frame_pair(b: int, h: int, w: int, seed: int = 1, shift=(2, 3)):
    """``b`` uint8 RGB frame pairs ``[b, h, w, 3]``: a random texture and
    the same texture moved by ``shift`` (rows, columns)."""
    rng = np.random.default_rng(seed)
    base = (rng.random((b, h + 8, w + 8, 3)) * 255).astype(np.uint8)
    dy, dx = shift
    return (np.ascontiguousarray(base[:, 4:4 + h, 4:4 + w]),
            np.ascontiguousarray(base[:, 4 - dy:4 - dy + h, 4 - dx:4 - dx + w]))
