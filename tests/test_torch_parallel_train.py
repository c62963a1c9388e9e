"""The port's train steps on a mesh (``nsof_tpu_torch/parallel/train.py``)
against the JAX package's global-batch steps, and ``train --mesh`` in the CLI.

- RAFT-basic, dp = 2 × tp = 2 in 4 gloo ranks, against JAX's
  ``make_train_step`` on ``make_mesh(1)`` (what GSPMD computes for the global
  batch), from one set of seeded Flax weights (``params_from_jax``), 64×96,
  B = 4, 2 iterations.  The batch's two 'data' shards have different valid
  counts (a tenth and a half of their pixels invalid), so a mean of the
  shards' masked means would miss the global loss.  Held: the loss and
  metrics within LOSS_RTOL, the gradients the clip sees (summed over 'data',
  the tp shards gathered) to ``tests/torch_train_common.py``'s bounds, the
  clip's global norm (every shard counted once) within 1e-5 of optax's
  ``global_norm`` of JAX's gradients, and the parameters after the update
  within 2·lr₀ + 1e-6·max |p| (≤ 0.5 % of the elements past 1e-6·max |p|);
  its checkpoint (tp shards and AdamW moments gathered, written by rank 0)
  restores on the mesh bit for bit and on one device.
- FlowFormer (the cut of ``tests/test_torch_train_flowformer.py``), dp = 2
  in 2 gloo ranks, B = 4, against ``make_flowformer_step``: loss, metrics
  (the ``{t}-th-5px`` buckets' counts are global too) and parameters.
- ``train --mesh 2x1`` through the CLI's ``main`` in 2 gloo ranks (the
  chairs stage cut to 64×96 crops and batch 2, as ``tests/test_torch_cli.py``
  cuts it): its checkpoint restores on one device, within the update bound
  of the one-device CLI run on the same data; ``--mesh`` whose dp·tp is not
  ``WORLD_SIZE`` raises ``ValueError``.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nsof_tpu.models import raft as jraft
from nsof_tpu.models.flowformer import config as jconfig
from nsof_tpu.models.flowformer import model as jmodel
from nsof_tpu.parallel import train as jtrain
from nsof_tpu.parallel.mesh import make_mesh
from nsof_tpu.train.optim import flowformer_optimizer as jax_ff_optimizer
from nsof_tpu.train.optim import raft_optimizer as jax_raft_optimizer
from nsof_tpu_torch import cli as tcli
from nsof_tpu_torch.models import raft as traft
from nsof_tpu_torch.models.convert import params_from_jax
from nsof_tpu_torch.models.flowformer import config as tconfig
from nsof_tpu_torch.models.flowformer.convert import params_from_jax as ff_params_from_jax
from nsof_tpu_torch.parallel import train as ttrain
from nsof_tpu_torch.train import curriculum
from nsof_tpu_torch.train.trainer import restore_checkpoint
from tests.torch_deep_weights import flowformer_params, raft_params
from tests.torch_dist import run_ranks
from tests.torch_train_common import (GRAD_ATOL, GRAD_L2, GRAD_RTOL, LOSS_RTOL, make_batch,
                                      record_grads)
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

ITERS = 2
LR, NUM_STEPS = 4e-4, 100
FLIP_FRACTION = 5e-3
B = 4
FF_CFG = dict(cost_latent_token_num=4, cost_latent_dim=32, cnet="basic", fnet="basic",
              encoder_depth=1, decoder_depth=2)
FF_OPT = dict(lr=2.5e-4, num_steps=100, wdecay=1e-4, twins_lr_factor=0.05)


def _batch():
    """make_batch at B = 4; the second 'data' shard has half its pixels
    invalid, the first a tenth."""
    batch = make_batch(b=B, seed=3)
    rng = np.random.default_rng(11)
    batch["valid"][B // 2:] = (rng.random(batch["valid"][B // 2:].shape) > 0.5)
    return batch


def _jax_step(make_step, model, tx, params, batch, mesh):
    state = jtrain.TrainState(jax.tree.map(jnp.array, params), tx.init(params),
                              jnp.zeros((), jnp.int32))
    new, metrics = make_step(model, tx, mesh)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return ({k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, new.opt_state[0]), jax.tree.map(np.asarray, new.params))


@pytest.fixture(scope="module")
def raft_runs(tmp_path_factory):
    """(JAX: metrics, grads, new params; the port's ranks' outputs; cfg)."""
    tmp = tmp_path_factory.mktemp("dp_tp")
    kw = dict(small=False, iters=ITERS, corr_radius=4)
    jcfg, tcfg = jraft.RaftConfig(**kw), traft.RaftConfig(**kw)
    params = raft_params(jcfg, seed=0)
    batch = _batch()
    tx = optax.chain(record_grads(), jax_raft_optimizer(lr=LR, num_steps=NUM_STEPS))
    step = lambda m, t, mesh: jtrain.make_train_step(m, t, mesh, iters=ITERS)  # noqa: E731
    jax_out = _jax_step(step, jraft.RAFT(jcfg), tx, params, batch, make_mesh(1))
    torch.save(params_from_jax(params, tcfg), tmp / "weights.pt")
    np.savez(tmp / "batch.npz", **batch)
    port = run_ranks(4, "train_raft", weights=str(tmp / "weights.pt"),
                     batch=str(tmp / "batch.npz"), cfg=kw, dp=2, tp=2, lr=LR,
                     num_steps=NUM_STEPS, iters=ITERS, ckpt=str(tmp / "ckpt"))
    port["ckpt"] = tmp / "ckpt"
    return jax_out, port, tcfg


def test_batch_shards_differ_in_valid_counts():
    valid = _batch()["valid"]
    first, second = valid[:B // 2].mean(), valid[B // 2:].mean()
    assert first > 0.85 and second < 0.55


def test_dp_tp_loss_and_metrics_match_jax(raft_runs):
    (metrics, _, _), port, _ = raft_runs
    got = json.loads(str(port["metrics"]))
    assert sorted(got) == sorted(metrics) == ["1px", "3px", "5px", "epe", "loss"]
    for k, v in metrics.items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)
    # the tp layout took effect: every marked convolution and norm is sharded
    assert int(port["n_sharded"]) > 30


def test_dp_tp_gradients_match_jax(raft_runs):
    (_, grads, _), port, tcfg = raft_runs
    want = {k: v.numpy() for k, v in params_from_jax(grads, tcfg).items()}
    got = {k[len("grad/"):]: v for k, v in port.items() if k.startswith("grad/")}
    # the port names a shared parameter once (norm3 is downsample.1 too)
    assert set(got) <= set(want) and len(got) > 50
    top = max(np.abs(w).max() for w in want.values())
    sq_err = sq_ref = 0.0
    for name, ref in ((n, want[n]) for n in got):
        err = np.abs(got[name] - ref).max()
        assert err <= GRAD_RTOL * np.abs(ref).max() + GRAD_ATOL * top, (name, err, top)
        sq_err += float(((got[name] - ref) ** 2).sum())
        sq_ref += float((ref ** 2).sum())
    assert np.sqrt(sq_err / sq_ref) <= GRAD_L2


def test_dp_tp_clip_norm_counts_each_shard_once(raft_runs):
    (_, grads, _), port, _ = raft_runs
    want = float(optax.global_norm(grads))
    assert want > 1.0  # the clip scales this step
    np.testing.assert_allclose(float(port["norm"]), want, rtol=1e-5)


def test_dp_tp_updated_parameters_match_jax(raft_runs):
    (_, _, new_params), port, tcfg = raft_runs
    want = {k: v.numpy() for k, v in params_from_jax(new_params, tcfg).items()}
    lr0 = LR / 25
    flipped = total = 0
    names = [k[len("param/"):] for k in port if k.startswith("param/")]
    assert set(names) <= set(want) and len(names) > 50
    for name, ref in ((n, want[n]) for n in names):
        got = port[f"param/{name}"]
        scale = np.abs(ref).max()
        err = np.abs(got - ref)
        assert err.max() <= 2 * lr0 + 1e-6 * scale, (name, err.max())
        flipped += int((err > 1e-6 * scale).sum())
        total += err.size
    assert flipped <= FLIP_FRACTION * total, (flipped, total)


def test_dp_tp_checkpoint_restores_on_mesh_and_one_device(raft_runs):
    """The dp×tp state saved after the step: restored on the mesh, every
    rank's shards equal the saved ones bit for bit; restored on one device,
    the parameters equal the gathered ones and the moments have the full
    shapes."""
    _, port, tcfg = raft_runs
    assert port["restored_equal"].tolist() == [True] * 4
    _, tx, state = ttrain.create_train_state(2, "cpu", cfg=tcfg, lr=LR, num_steps=NUM_STEPS)
    state, step = restore_checkpoint(port["ckpt"], state)
    assert step == 1
    for name, p in state.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), port[f"param/{name}"], name)
        moments = tx.optimizer.state[p]
        assert moments["exp_avg"].shape == moments["exp_avg_sq"].shape == p.shape, name


@pytest.fixture(scope="module")
def flowformer_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_ff")
    jcfg = jconfig.FlowFormerConfig(**FF_CFG)
    params = flowformer_params(jcfg, seed=0)
    batch = _batch()
    tx = optax.chain(record_grads(), jax_ff_optimizer(**FF_OPT))
    jax_out = _jax_step(jtrain.make_flowformer_step, jmodel.FlowFormer(jcfg), tx, params,
                        batch, make_mesh(1))
    tcfg = tconfig.FlowFormerConfig(**FF_CFG)
    torch.save(ff_params_from_jax(params, tcfg), tmp / "weights.pt")
    np.savez(tmp / "batch.npz", **batch)
    port = run_ranks(2, "train_flowformer", weights=str(tmp / "weights.pt"),
                     batch=str(tmp / "batch.npz"), cfg=FF_CFG, opt=FF_OPT)
    return jax_out, port, tcfg


def test_dp_flowformer_metrics_match_jax(flowformer_runs):
    (metrics, _, _), port, _ = flowformer_runs
    got = json.loads(str(port["metrics"]))
    assert sorted(got) == sorted(metrics)
    assert {"5-th-5px", "10-th-5px", "20-th-5px", "loss", "epe"} <= set(got)
    for k, v in metrics.items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)


def test_dp_flowformer_updated_parameters_match_jax(flowformer_runs):
    (_, _, new_params), port, tcfg = flowformer_runs
    want = {k: v.numpy() for k, v in ff_params_from_jax(new_params, tcfg).items()}
    lr0 = max(FF_OPT["lr"], FF_OPT["lr"] * FF_OPT["twins_lr_factor"]) / 25
    for name, ref in want.items():
        if f"param/{name}" not in port:
            continue
        err = np.abs(port[f"param/{name}"] - ref).max()
        assert err <= 2 * lr0 + 1e-6 * np.abs(ref).max(), (name, err)
    assert sum(k.startswith("param/") for k in port) > 50


def _chairs(root, n=3):
    from nsof_tpu_torch.data import flow_datasets as tfd
    from nsof_tpu_torch.utils.ppm import encode_ppm

    data = root / "FlyingChairs_release" / "data"
    data.mkdir(parents=True)
    pairs = tfd.synthetic_affine_dataset(np.random.default_rng(0), n=n, size=(96, 128))
    for i, (a, b, flow) in enumerate(pairs):
        (data / f"{i:05d}_img1.ppm").write_bytes(encode_ppm(a))
        (data / f"{i:05d}_img2.ppm").write_bytes(encode_ppm(b))
        tfd.write_flo(data / f"{i:05d}_flow.flo", flow)


def test_cli_train_mesh_restores_on_one_device(tmp_path):
    _chairs(tmp_path)
    crop, batch_size = (64, 96), 2
    out = run_ranks(2, "cli_train", data_root=str(tmp_path), ckpt_root=str(tmp_path / "mesh"),
                    mesh="2x1", crop=list(crop), batch_size=batch_size)
    assert int(out["rc"]) == 0
    assert sorted(p.name for p in (tmp_path / "mesh" / "chairs").iterdir()) == ["1",
                                                                                "metrics.jsonl"]
    cut = tuple(dataclasses.replace(s, image_size=crop, batch_size=batch_size)
                for s in curriculum.RAFT_STANDARD_STAGES)
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(printed):
        mp.setattr(curriculum, "RAFT_STANDARD_STAGES", cut)
        assert tcli.main(["train", "--data-root", str(tmp_path), "--ckpt-root",
                          str(tmp_path / "one"), "--stage", "chairs", "--small", "--steps", "1",
                          "--device", "cpu"]) == 0
    cfg = traft.RaftConfig(small=True)
    states = []
    for run in ("mesh", "one"):
        _, _, state = ttrain.create_train_state(1, "cpu", cfg=cfg, lr=4e-4, num_steps=1)
        state, step = restore_checkpoint(tmp_path / run / "chairs", state)
        assert step == 1 and state.mesh is None
        states.append(state)
    lr0 = 4e-4 / 25
    one = dict(states[1].model.named_parameters())
    for name, p in states[0].model.named_parameters():
        err = (p - one[name]).abs().max().item()
        assert err <= 2 * lr0 + 1e-6 * one[name].abs().max().item(), (name, err)
    # the optimizer's moments came back in the one-device layout too
    moments = states[0].tx.optimizer.state
    assert all(s["exp_avg"].shape == p.shape for p, s in moments.items())


def test_cli_mesh_must_match_world_size(tmp_path):
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        tcli.main(["train", "--data-root", str(tmp_path), "--mesh", "2x2", "--device", "cpu"])
    assert not torch.distributed.is_initialized()
