"""The port's training losses, schedule and optimizers
(``nsof_tpu_torch/train/{loss,optim}.py``) against the JAX package's
(``nsof_tpu/train/{loss,optim}.py``, optax).

- Both sequence losses on the same seeded predictions: the loss and EPE
  within 1e-6 relative of a float64 numpy evaluation and 2e-6 of the JAX
  package's (whose float32 sums are up to 1.1e-6 from the float64 value on
  these inputs; the port's 4e-8), the 1/3/5 px fractions (counts over the
  valid count) equal, an empty ``{t}-th-5px`` bucket NaN in both, ground
  truth past ``max_flow`` masked.
- The one-cycle schedule at every update count 0 … num_steps + 110 for two
  ``num_steps``: 1e-7 relative to optax's (the port evaluates it in float32
  as optax does; measured equal).
- The optimizers fed the same gradient arrays for 3 updates: every
  parameter within 1e-6 of its tensor's largest |p| (measured 6e-8), with
  the gradients' global norm above the clip (scaled) and below it
  (untouched), and ``flowformer_optimizer(twins_lr_factor=0.05)``.
(The twins group on a whole FlowFormer: ``tests/test_torch_train_flowformer.py``.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from nsof_tpu.train import loss as jloss
from nsof_tpu.train import optim as joptim
from nsof_tpu_torch.train import loss as tloss
from nsof_tpu_torch.train import optim as toptim
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

LOSS_RTOL = 2e-6  # against JAX
EXACT_RTOL = 1e-6  # against float64
SCHED_RTOL = 1e-7
PARAM_TOL = 1e-6


def _loss_inputs(seed, offset=0.0, b=2, h=24, w=32, n=4):
    rng = np.random.default_rng(seed)
    gt = (offset + rng.normal(size=(b, h, w, 2)) * 8.0).astype(np.float32)
    preds = [gt + rng.normal(size=gt.shape).astype(np.float32) * (4 - i) for i in range(n)]
    valid = (rng.random((b, h, w)) > 0.2).astype(np.float32)
    gt[0, :3] = 450.0  # past MAX_FLOW: masked out
    return preds, gt, valid


# fast_only: every |gt| > 20 px, so each {t}-th-5px bucket is empty
CASES = {"mixed": (0, 0.0), "fast_only": (1, 60.0)}


def _float64_loss(which, preds, gt, valid, gamma):
    """(loss, epe) of core/loss.py (FlowFormer) or train.py (RAFT) in float64."""
    gt = gt.astype(np.float64)
    v = (valid >= 0.5) & (np.sqrt((gt ** 2).sum(-1)) < 400)
    n = len(preds)
    if which == "raft":
        terms = [np.abs(p - gt).sum(-1)[v].sum() / v.sum() for p in preds]
    else:
        terms = [(v[..., None] * np.abs(p - gt)).mean() for p in preds]
    loss = sum(gamma ** (n - i - 1) * t for i, t in enumerate(terms))
    return loss, np.sqrt(((preds[-1] - gt) ** 2).sum(-1))[v].mean()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("which", ["raft", "flowformer"])
def test_losses_match_jax(which, case):
    preds, gt, valid = _loss_inputs(*CASES[case])
    jfn = jloss.sequence_loss if which == "raft" else jloss.flowformer_sequence_loss
    tfn = tloss.sequence_loss if which == "raft" else tloss.flowformer_sequence_loss
    jl, jm = jfn([jnp.asarray(p) for p in preds], jnp.asarray(gt), jnp.asarray(valid), gamma=0.85)
    tl, tm = tfn([torch.from_numpy(p) for p in preds], torch.from_numpy(gt),
                 torch.from_numpy(valid), gamma=0.85)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    exact_loss, exact_epe = _float64_loss(which, preds, gt, valid, 0.85)
    np.testing.assert_allclose(float(tl), exact_loss, rtol=EXACT_RTOL)
    np.testing.assert_allclose(float(tm["epe"]), exact_epe, rtol=EXACT_RTOL)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        want, got = float(jm[k]), float(tm[k])
        if k.endswith("px") and not k.endswith("-th-5px"):
            assert got == want, k  # count / valid count
        elif np.isnan(want):
            assert np.isnan(got), k
        else:
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL, err_msg=k)
    if which == "flowformer":
        assert all(np.isnan(float(tm[f"{t}-th-5px"])) == (case == "fast_only")
                   for t in (5, 10, 20))


def test_max_flow_masks_ground_truth():
    preds, gt, valid = _loss_inputs(0)
    far = [torch.from_numpy(p) for p in preds]
    _, m = tloss.sequence_loss(far, torch.from_numpy(gt), torch.from_numpy(valid))
    valid[0, :3] = 0  # the rows past MAX_FLOW, masked by hand
    _, m2 = tloss.sequence_loss(far, torch.from_numpy(gt), torch.from_numpy(valid))
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m2.items()}


@pytest.mark.parametrize("num_steps", [100, 1_000])
def test_schedule_matches_optax_at_every_step(num_steps):
    lr = 4e-4
    jsched = joptim._onecycle(lr, num_steps)
    tsched = toptim.onecycle_schedule(lr, num_steps)
    counts = np.arange(num_steps + 111)
    want = np.array([float(jsched(jnp.asarray(c, jnp.int32))) for c in counts])
    got = np.array([tsched(int(c)) for c in counts])
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL, atol=0)
    peak = int(0.05 * (num_steps + 100))
    assert got[0] == pytest.approx(lr / 25, rel=1e-6) and got[peak] == pytest.approx(lr, rel=1e-6)
    assert got[-1] == pytest.approx(lr * 1e-4, rel=1e-6)


def _tree(seed, norm):
    """A Flax-style parameter tree and a gradient tree of global norm ``norm``."""
    rng = np.random.default_rng(seed)
    shapes = {"feat_encoder": {"conv": {"kernel": (3, 3, 4, 8), "bias": (8,)}},
              "context_encoder": {"norm": {"scale": (8,)}},
              "memory_decoder": {"proj": {"kernel": (8, 6), "bias": (6,)}}}
    params = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    grads = [jax.tree.map(lambda p: rng.normal(size=p.shape).astype(np.float32), params)
             for _ in range(3)]
    for g in grads:
        total = np.sqrt(sum((x ** 2).sum() for x in jax.tree.leaves(g)))
        for leaf in jax.tree.leaves(g):
            leaf *= norm / total
    return params, grads


def _module(tree) -> nn.Module:
    m = nn.Module()
    for k, v in tree.items():
        if isinstance(v, dict):
            m.add_module(k, _module(v))
        else:
            m.register_parameter(k, nn.Parameter(torch.from_numpy(np.array(v))))
    return m


@pytest.mark.parametrize("norm", [10.0, 0.5])
@pytest.mark.parametrize("which", ["raft", "flowformer_twins"])
def test_optimizer_updates_match_optax(which, norm):
    params, grads = _tree(7, norm)
    kw = dict(lr=1e-3, num_steps=50, wdecay=1e-2)
    if which == "raft":
        jtx, make = joptim.raft_optimizer(**kw), lambda m: toptim.raft_optimizer(m, **kw)
    else:
        jtx = joptim.flowformer_optimizer(twins_lr_factor=0.05, **kw)
        make = lambda m: toptim.flowformer_optimizer(m, twins_lr_factor=0.05, **kw)  # noqa: E731
    state, jp = jtx.init(params), params
    model = _module(params)
    tx = make(model)
    for g in grads:
        upd, state = jtx.update(g, state, jp)
        jp = optax.apply_updates(jp, upd)
        for name, p in model.named_parameters():
            leaf = g
            for part in name.split("."):
                leaf = leaf[part]
            p.grad = torch.from_numpy(np.array(leaf))
        tx.step()
    flat = {".".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    for name, p in model.named_parameters():
        ref = flat[name]
        assert np.abs(p.detach().numpy() - ref).max() <= PARAM_TOL * np.abs(ref).max(), name
        assert not np.array_equal(ref, np.asarray(_lookup(params, name))), name


def _lookup(tree, name):
    for part in name.split("."):
        tree = tree[part]
    return tree


def test_clip_scales_only_above_the_norm():
    for norm, scale in ((4.0, 0.25), (0.5, 1.0)):
        p = nn.Parameter(torch.zeros(4))
        p.grad = torch.full((4,), norm / 2)
        got = toptim.clip_grad_global_norm_([p], 1.0)
        assert float(got) == pytest.approx(norm)
        torch.testing.assert_close(p.grad, torch.full((4,), norm / 2 * scale))
