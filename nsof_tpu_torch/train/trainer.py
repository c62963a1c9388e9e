"""The training loop of the deep flow backends: the port of
:mod:`nsof_tpu.train.trainer`.

A step loop (codebase/RAFT/train.py:136-214) over :mod:`nsof_tpu_torch.
parallel.train`'s steps, metric logging, and checkpoints every
``val_freq`` steps with resume (the reference torch.saves every
VAL_FREQ=5000, :185-198; resume via --restore_ckpt, :141-142).

A checkpoint is one ``torch.save`` file, ``<ckpt_dir>/<step>/state.pt``,
holding the model's ``state_dict``, the optimizer's moments and the
schedule's position; :func:`restore_checkpoint` loads the newest step in
place.  A state on a mesh is saved in the one-device layout: its
tensor-parallel shards are gathered and the mesh's first rank alone writes
the file, so a checkpoint trained on any mesh restores on one device (and
on a mesh its shards are cut out again).  The JAX package writes orbax directories, which the port does not
read (orbax is JAX's).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

CKPT_FILE = "state.pt"


@dataclasses.dataclass
class StageConfig:
    """One curriculum stage (mirrors the reference's shell schedule)."""

    name: str = "chairs"
    num_steps: int = 100_000
    batch_size: int = 8
    lr: float = 4e-4
    image_size: tuple[int, int] = (368, 496)
    wdecay: float = 1e-4
    gamma: float = 0.8


class MetricLogger:
    """Running-mean metric printer (the reference's Logger,
    train.py:89-133, without the TensorBoard dependency; writes JSONL)."""

    def __init__(self, log_path: Optional[str] = None, sum_freq: int = 100):
        self.sum_freq = sum_freq
        self.running: dict[str, float] = {}
        self.count = 0
        self.step = 0
        self.log_path = pathlib.Path(log_path) if log_path else None
        if self.log_path:
            self.log_path.parent.mkdir(parents=True, exist_ok=True)
            self.log_path.write_text("")

    def push(self, metrics: dict):
        self.step += 1
        self.count += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.step % self.sum_freq == 0:
            means = {k: v / self.count for k, v in self.running.items()}
            line = {"step": self.step, **{k: round(v, 5) for k, v in means.items()}}
            print(line)
            if self.log_path:
                with open(self.log_path, "a") as f:
                    f.write(json.dumps(line) + "\n")
            self.running = {}
            self.count = 0


def save_checkpoint(ckpt_dir: str | pathlib.Path, step: int, state) -> None:
    """Write ``state`` (a :class:`~nsof_tpu_torch.parallel.train.TrainState`)
    as step ``step`` of ``ckpt_dir`` (replaces torch.save, train.py:185-187).
    On a mesh every rank calls it, and it returns once the file is
    written."""
    from nsof_tpu_torch.parallel.mesh import is_first_rank, mesh_barrier
    from nsof_tpu_torch.parallel.train import full_state_dict

    if state.mesh is None:
        full = {"model": state.model.state_dict(), "tx": state.tx.state_dict()}
    else:
        full = full_state_dict(state)
    if is_first_rank(state.mesh):
        path = pathlib.Path(ckpt_dir) / str(step)
        path.mkdir(parents=True, exist_ok=True)
        torch.save(dict(full, step=step), path / CKPT_FILE)
    if state.mesh is not None:
        mesh_barrier(state.mesh)


def restore_checkpoint(ckpt_dir: str | pathlib.Path, state):
    """Load the newest checkpoint of ``ckpt_dir`` into ``state``'s model and
    optimizer, in place (replaces --restore_ckpt, train.py:141-142).
    Returns ``(state, step)``; ``(state, 0)`` when there is none."""
    root = pathlib.Path(ckpt_dir)
    steps = sorted(int(p.name) for p in root.iterdir()
                   if p.name.isdigit() and (p / CKPT_FILE).is_file()) if root.is_dir() else []
    if not steps:
        return state, 0
    device = next(state.model.parameters()).device
    saved = torch.load(root / str(steps[-1]) / CKPT_FILE, map_location=device,
                       weights_only=True)
    if state.mesh is None:
        state.model.load_state_dict(saved["model"])
        state.tx.load_state_dict(saved["tx"])
    else:
        from nsof_tpu_torch.parallel.train import load_full_state_dict

        load_full_state_dict(state, saved)
    state.step = saved["step"]
    return state, saved["step"]


def train_loop(
    train_step: Callable,
    state,
    batches: Iterable[dict],
    num_steps: int,
    logger: Optional[MetricLogger] = None,
    ckpt_dir: Optional[str] = None,
    val_freq: int = 5000,
    validate_fn: Optional[Callable] = None,
):
    """Generic step loop: batch in → step on the device → metrics out, read
    to the host in one transfer a step.

    ``batches`` yields dicts with image1/image2/flow/valid (see
    nsof_tpu_torch.parallel.train.make_train_step).
    """
    logger = logger or MetricLogger()
    t0 = time.perf_counter()
    for step, batch in enumerate(batches):
        if step >= num_steps:
            break
        state, metrics = train_step(state, batch)
        keys = list(metrics)
        values = torch.stack([metrics[k].float() for k in keys]).tolist()
        logger.push(dict(zip(keys, values)))
        if ckpt_dir and (step + 1) % val_freq == 0:
            save_checkpoint(ckpt_dir, step + 1, state)
            if validate_fn is not None:
                val = validate_fn(state)
                print({"step": step + 1, **val})
    wall = time.perf_counter() - t0
    if ckpt_dir:
        save_checkpoint(ckpt_dir, num_steps, state)
    return state, {"wall_s": wall}


def validate_epe(apply_fn, params, pairs: Iterable[tuple]) -> dict:
    """EPE validation over (img1, img2, flow_gt) triples (the reference's
    validate_chairs/sintel EPE, codebase/RAFT/evaluate.py:21-60);
    ``apply_fn(params, img1, img2)`` runs without autograd, so a model in
    training can be validated as it is."""
    epes = []
    for img1, img2, gt in pairs:
        with torch.no_grad():
            pred = apply_fn(params, img1, img2)
        pred = pred.cpu().numpy() if isinstance(pred, torch.Tensor) else np.asarray(pred)
        epes.append(float(np.sqrt(((pred - np.asarray(gt)) ** 2).sum(-1)).mean()))
    return {"epe": float(np.mean(epes)), "n": len(epes)}
