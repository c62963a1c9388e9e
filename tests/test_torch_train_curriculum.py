"""The port's trainer and curriculum (``nsof_tpu_torch/train/trainer.py``,
``nsof_tpu_torch/train/curriculum.py``) on the CPU, at RAFT-small with 2
iterations on 64×64 crops of synthetic pairs, and FlowFormer with RAFT-encoder
backbones at depth 1 + 1.

- ``run_curriculum`` over three stages: the second trains from the first's
  weights, a zero-step third restores the first's weights exactly, every
  stage writes its checkpoints; a FlowFormer stage chain hands off as well.
- ``save_checkpoint`` / ``restore_checkpoint``: the newest step restored
  into a fresh state (parameters, Adam moments, schedule position) bit for
  bit; an empty directory gives ``(state, 0)``.
- Resume: a run checkpointed at step 2 and resumed from it has the
  uninterrupted run's learning rate at every later step and, over the same
  batches, its parameters bit for bit.
- ``train_loop`` reads a step's metrics in one transfer and logs them;
  ``MetricLogger`` writes the JSONL lines the JAX package's writes;
  ``validate_epe`` runs a model without autograd and leaves it trainable.
"""

import json

import numpy as np
import pytest
import torch

from nsof_tpu.train.trainer import MetricLogger as JMetricLogger
from nsof_tpu_torch.data import flow_datasets as fd
from nsof_tpu_torch.models.flowformer import FlowFormerConfig
from nsof_tpu_torch.models.raft import RaftConfig
from nsof_tpu_torch.parallel import train as ptrain
from nsof_tpu_torch.train import trainer
from nsof_tpu_torch.train.curriculum import (SourceSpec, StageSpec, mixed_batch_iterator,
                                             build_stage_items, run_curriculum)
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)

CFG = RaftConfig(small=True, iters=2)


@pytest.fixture(scope="module")
def data():
    return fd.synthetic_affine_dataset(np.random.default_rng(0), n=8, size=(96, 96),
                                       max_shift=3)


def _stage(name, steps, lr=1e-4, restore_from=None, sources=("synthA",), model="raft"):
    return StageSpec(name, tuple(SourceSpec(s, 1, -0.1, 0.1, True) for s in sources),
                     num_steps=steps, batch_size=2, lr=lr, image_size=(64, 64), wdecay=1e-4,
                     restore_from=restore_from, model=model,
                     twins_lr_factor=0.05 if model == "flowformer" else None)


def _equal(a: dict, b: dict) -> bool:
    return all(torch.equal(a[k], b[k]) for k in a) and a.keys() == b.keys()


def test_curriculum_hands_weights_stage_to_stage(data, tmp_path):
    scanners = {"synthA": lambda: data, "synthB": lambda: data[:4]}
    stages = (_stage("s1", 2),
              _stage("s2", 2, lr=5e-5, restore_from="s1", sources=("synthA", "synthB")),
              _stage("s3", 0, restore_from="s1", sources=("synthB",)))
    results = run_curriculum("cpu", None, tmp_path, stages=stages, scanners=scanners,
                             raft_cfg=CFG, val_freq=100)
    assert set(results) == {"s1", "s2", "s3"}
    assert results["s1"].step == results["s2"].step == 2 and results["s3"].step == 0
    assert _equal(results["s3"].params, results["s1"].params)
    assert not _equal(results["s2"].params, results["s1"].params)
    for name, steps in (("s1", [2]), ("s2", [2]), ("s3", [0])):
        assert sorted(int(p.name) for p in (tmp_path / name).iterdir()
                      if p.name.isdigit()) == steps
    # each checkpoint restores the stage's final weights
    _, _, fresh = ptrain.create_train_state(1, "cpu", cfg=CFG)
    state, step = trainer.restore_checkpoint(tmp_path / "s2", fresh)
    assert step == 2 and _equal(state.params, results["s2"].params)
    with pytest.raises(ValueError, match="has not run"):
        run_curriculum("cpu", None, tmp_path, stages=stages[1:], scanners=scanners,
                       raft_cfg=CFG)


def test_flowformer_curriculum_hands_off(data, tmp_path):
    tiny = FlowFormerConfig(decoder_depth=1, encoder_depth=1, cnet="basic", fnet="basic",
                            cost_latent_token_num=4, cost_latent_dim=32)
    stages = (_stage("f1", 1, model="flowformer"),
              _stage("f2", 0, restore_from="f1", model="flowformer"))
    results = run_curriculum("cpu", None, tmp_path, stages=stages,
                             scanners={"synthA": lambda: data}, raft_cfg=tiny, val_freq=100)
    assert results["f1"].step == 1
    assert _equal(results["f2"].params, results["f1"].params)
    lrs = results["f2"].tx.lrs()
    assert lrs[1] == pytest.approx(0.05 * lrs[0], rel=1e-6)


def _batches(data, n):
    items = build_stage_items(_stage("x", n), {"synthA": lambda: data})
    it = mixed_batch_iterator(items, 2, np.random.default_rng(7))
    return [next(it) for _ in range(n)]


def test_checkpoint_round_trip_and_resume(data, tmp_path):
    batches = _batches(data, 4)
    # uninterrupted: 4 steps, the lr before each
    model, tx, state = ptrain.create_train_state(0, "cpu", cfg=CFG, lr=1e-4, num_steps=4)
    step = ptrain.make_train_step(model, tx, "cpu", iters=2)
    lrs = []
    for b in batches:
        lrs.append(tx.lrs()[0])
        state, _ = step(state, b)
    # interrupted after 2 (checkpointed), resumed into a fresh state
    model, tx, half = ptrain.create_train_state(0, "cpu", cfg=CFG, lr=1e-4, num_steps=4)
    half, _ = trainer.train_loop(ptrain.make_train_step(model, tx, "cpu", iters=2), half,
                                 iter(batches[:2]), 2, ckpt_dir=str(tmp_path), val_freq=2)
    model, tx, resumed = ptrain.create_train_state(5, "cpu", cfg=CFG, lr=1e-4, num_steps=4)
    assert not _equal(resumed.params, half.params)
    resumed, at = trainer.restore_checkpoint(tmp_path, resumed)
    assert at == resumed.step == 2 and _equal(resumed.params, half.params)
    assert _equal(tx.optimizer.state_dict()["state"][0], half.tx.optimizer.state_dict()["state"][0])
    step = ptrain.make_train_step(model, tx, "cpu", iters=2)
    for k, b in enumerate(batches[2:], start=2):
        assert tx.lrs()[0] == lrs[k]
        resumed, _ = step(resumed, b)
    assert _equal(resumed.params, state.params)
    assert trainer.restore_checkpoint(tmp_path / "empty", resumed) == (resumed, 0)


def test_train_loop_logs_what_jax_logs(data, tmp_path, capsys):
    model, tx, state = ptrain.create_train_state(0, "cpu", cfg=CFG)
    logger = trainer.MetricLogger(str(tmp_path / "port.jsonl"), sum_freq=2)
    state, info = trainer.train_loop(ptrain.make_train_step(model, tx, "cpu", iters=2), state,
                                     iter(_batches(data, 4)), 4, logger=logger)
    assert state.step == 4 and info["wall_s"] > 0
    lines = [json.loads(x) for x in (tmp_path / "port.jsonl").read_text().splitlines()]
    assert [x["step"] for x in lines] == [2, 4]
    assert sorted(lines[0]) == ["1px", "3px", "5px", "epe", "loss", "step"]
    # the same metrics through both loggers give the same file
    jlog = JMetricLogger(str(tmp_path / "jax.jsonl"), sum_freq=2)
    tlog = trainer.MetricLogger(str(tmp_path / "torch.jsonl"), sum_freq=2)
    for k in range(4):
        m = {"loss": 1.0 / (k + 3), "epe": 0.123456789 * k}
        jlog.push(m)
        tlog.push(m)
    assert (tmp_path / "jax.jsonl").read_text() == (tmp_path / "torch.jsonl").read_text()
    capsys.readouterr()


def test_validate_epe_leaves_the_model_trainable(data):
    model, _, _ = ptrain.create_train_state(0, "cpu", cfg=CFG)
    pairs = [(a[None, :64, :64], b[None, :64, :64], f[None, :64, :64]) for a, b, f in data[:2]]

    def apply(m, a, b):
        return m(torch.from_numpy(a), torch.from_numpy(b), iters=2, test_mode=True)[1]

    out = trainer.validate_epe(apply, model, pairs)
    assert out["n"] == 2 and np.isfinite(out["epe"])
    assert all(p.requires_grad for p in model.parameters())
