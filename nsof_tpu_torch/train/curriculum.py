"""Staged training curriculum for the deep flow backends: the port of
:mod:`nsof_tpu.train.curriculum`.

The reference trains RAFT through a fixed schedule of dataset stages —
chairs → things → sintel-mix → kitti — where each stage has its own
dataset mix with *per-source* augmentation parameters and replication
weights (``fetch_dataloader``, codebase/RAFT/core/datasets.py:201-231:
e.g. the 'sintel' stage trains on ``100*sintel_clean + 100*sintel_final +
200*kitti + 5*hd1k + things``) and its own optimizer schedule
(train_standard.sh:3-6), restoring the previous stage's weights.

This module expresses that as data: :class:`SourceSpec` / :class:`StageSpec`
tables, a mixed-sampling batch iterator, and :func:`run_curriculum`, which
drives the train step (:mod:`nsof_tpu_torch.parallel.train`) through the
stages, handing each stage's weights to the next and writing each stage's
checkpoints.  Dataset scanners are a registry so tests (and users with
nonstandard layouts) can substitute synthetic stand-ins for the
multi-hundred-GB public benchmarks.

CLI: ``python -m nsof_tpu_torch train --stage chairs --data-root datasets/``
(see nsof_tpu_torch.cli).
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from nsof_tpu_torch.data.flow_datasets import (
    AugmentorConfig,
    augment_pair,
    load_item,
    scan_flying_chairs,
    scan_flying_things,
    scan_hd1k,
    scan_kitti,
    scan_sintel,
    stack_batch,
)
from nsof_tpu_torch.models.flowformer.config import get_experiment

__all__ = [
    "SourceSpec",
    "StageSpec",
    "RAFT_STANDARD_STAGES",
    "FLOWFORMER_STAGES",
    "default_scanners",
    "build_stage_items",
    "mixed_batch_iterator",
    "run_stage",
    "run_curriculum",
]


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """One dataset source inside a stage's mix.

    ``weight`` is the reference's list-replication factor (``200*kitti``
    means every kitti pair appears 200× in the shuffled epoch); ``aug``
    overrides select AugmentorConfig fields for this source only
    (fetch_dataloader gives kitti/hd1k their own scale ranges + sparse
    handling inside the 'sintel' stage mix).
    """

    name: str
    weight: int = 1
    min_scale: float = -0.2
    max_scale: float = 0.5
    do_flip: bool = True
    sparse: bool = False

    def augmentor(self, crop_size: tuple[int, int]) -> AugmentorConfig:
        return AugmentorConfig(
            crop_size=crop_size,
            min_scale=self.min_scale,
            max_scale=self.max_scale,
            do_flip=self.do_flip,
            sparse=self.sparse,
        )


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One curriculum stage: dataset mix + optimizer schedule.

    Mirrors one ``train.py`` invocation of train_standard.sh — the
    schedule fields are that script's CLI flags verbatim.
    """

    name: str
    sources: tuple[SourceSpec, ...]
    num_steps: int
    batch_size: int
    lr: float
    image_size: tuple[int, int]
    wdecay: float
    gamma: float = 0.8
    restore_from: Optional[str] = None  # previous stage name
    model: str = "raft"  # model family: 'raft' | 'flowformer'
    # FlowFormer-only knobs (configs/<stage>.py trainer + optimizer
    # blocks; ignored for RAFT stages)
    twins_lr_factor: Optional[float] = None
    ff_experiment: Optional[str] = None  # key into FF_EXPERIMENTS


# The standard RAFT schedule (train_standard.sh:3-6 + fetch_dataloader's
# per-stage aug params, core/datasets.py:201-231).
RAFT_STANDARD_STAGES: tuple[StageSpec, ...] = (
    StageSpec(
        name="chairs",
        sources=(SourceSpec("chairs", 1, -0.1, 1.0, True),),
        num_steps=100_000, batch_size=10, lr=4e-4,
        image_size=(368, 496), wdecay=1e-4, gamma=0.8,
    ),
    StageSpec(
        name="things",
        sources=(
            SourceSpec("things_clean", 1, -0.4, 0.8, True),
            SourceSpec("things_final", 1, -0.4, 0.8, True),
        ),
        num_steps=100_000, batch_size=6, lr=1.25e-4,
        image_size=(400, 720), wdecay=1e-4, gamma=0.8,
        restore_from="chairs",
    ),
    StageSpec(
        name="sintel",
        sources=(
            SourceSpec("sintel_clean", 100, -0.2, 0.6, True),
            SourceSpec("sintel_final", 100, -0.2, 0.6, True),
            SourceSpec("kitti", 200, -0.3, 0.5, True, sparse=True),
            SourceSpec("hd1k", 5, -0.5, 0.2, True, sparse=True),
            SourceSpec("things_clean", 1, -0.2, 0.6, True),
        ),
        num_steps=100_000, batch_size=6, lr=1.25e-4,
        image_size=(368, 768), wdecay=1e-5, gamma=0.85,
        restore_from="things",
    ),
    StageSpec(
        name="kitti",
        sources=(SourceSpec("kitti", 1, -0.2, 0.4, False, sparse=True),),
        num_steps=50_000, batch_size=6, lr=1e-4,
        image_size=(288, 960), wdecay=1e-5, gamma=0.85,
        restore_from="sintel",
    ),
)


def _ff_stage(key: str, stage_name: str, sources, restore_from=None):
    """Build a FlowFormer StageSpec from its experiment tree
    (models/flowformer/config.py::FF_EXPERIMENTS — the typed replicas of
    configs/{default,things,sintel,kitti}.py) + fetch_dataloader's
    per-stage dataset mix (core/datasets.py:200-229, shared with RAFT)."""
    exp = get_experiment(key)
    return StageSpec(
        name=stage_name,
        sources=sources,
        restore_from=restore_from,
        model="flowformer",
        ff_experiment=key,
        # optimizer/__init__.py:22-33 trains the twins backbones at
        # 0.05× the canonical lr when pretrained weights are loaded
        twins_lr_factor=0.05,
        **exp.train_stage_kwargs(),
    )


# The FlowFormer staged schedule (train_FlowFormer.py:139-154 maps
# --stage {chairs,things,sintel,kitti} onto configs/{default,things,
# sintel,kitti}.py; dataset mixes from the shared fetch_dataloader).
FLOWFORMER_STAGES: tuple[StageSpec, ...] = (
    _ff_stage(
        "chairs", "ff_chairs",
        (SourceSpec("chairs", 1, -0.1, 1.0, True),),
    ),
    _ff_stage(
        "things", "ff_things",
        (
            SourceSpec("things_clean", 1, -0.4, 0.8, True),
            SourceSpec("things_final", 1, -0.4, 0.8, True),
        ),
        restore_from="ff_chairs",
    ),
    _ff_stage(
        "sintel", "ff_sintel",
        (
            SourceSpec("sintel_clean", 100, -0.2, 0.6, True),
            SourceSpec("sintel_final", 100, -0.2, 0.6, True),
            SourceSpec("kitti", 200, -0.3, 0.5, True, sparse=True),
            SourceSpec("hd1k", 5, -0.5, 0.2, True, sparse=True),
            SourceSpec("things_clean", 1, -0.2, 0.6, True),
        ),
        restore_from="ff_things",
    ),
    _ff_stage(
        "kitti", "ff_kitti",
        (SourceSpec("kitti", 1, -0.2, 0.4, False, sparse=True),),
        restore_from="ff_sintel",
    ),
)


def default_scanners(data_root) -> dict[str, Callable[[], list]]:
    """Source name → pair-list scanner over the standard dataset layouts
    (dataset roots as in core/datasets.py's defaults, relative to
    ``data_root``)."""
    root = pathlib.Path(data_root)
    return {
        "chairs": lambda: scan_flying_chairs(root / "FlyingChairs_release"),
        "things_clean": lambda: scan_flying_things(
            root / "FlyingThings3D", "frames_cleanpass"),
        "things_final": lambda: scan_flying_things(
            root / "FlyingThings3D", "frames_finalpass"),
        "sintel_clean": lambda: scan_sintel(root / "Sintel", dstype="clean"),
        "sintel_final": lambda: scan_sintel(root / "Sintel", dstype="final"),
        "kitti": lambda: scan_kitti(root / "KITTI"),
        "hd1k": lambda: scan_hd1k(root / "HD1k"),
    }


def build_stage_items(
    stage: StageSpec, scanners: dict[str, Callable[[], list]]
) -> list[tuple[object, AugmentorConfig]]:
    """Materialise a stage's weighted mix: each source's pair list is
    replicated ``weight``× (the reference's ``100*dataset`` list
    concatenation) and tagged with its per-source augmentor."""
    items: list[tuple[object, AugmentorConfig]] = []
    for src in stage.sources:
        if src.name not in scanners:
            raise KeyError(
                f"stage {stage.name!r} needs unknown source {src.name!r}; "
                f"have {sorted(scanners)}"
            )
        pairs = scanners[src.name]()
        aug = src.augmentor(stage.image_size)
        items.extend((p, aug) for p in pairs for _ in range(src.weight))
    if not items:
        raise ValueError(f"stage {stage.name!r} produced no training pairs")
    return items


def mixed_batch_iterator(
    items: Sequence[tuple[object, AugmentorConfig]],
    batch_size: int,
    rng: np.random.Generator,
    epochs: Optional[int] = None,
) -> Iterator[dict]:
    """Shuffled epochs over a mixed item list with per-item augmentation
    (the DataLoader(shuffle=True, drop_last=True) over the concatenated
    replicated datasets, core/datasets.py:229-233)."""
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(items))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            samples = []
            for idx in order[s : s + batch_size]:
                pair, aug = items[idx]
                i1, i2, fl, valid = load_item(pair)
                samples.append(augment_pair(rng, i1, i2, fl, aug, valid))
            yield stack_batch(samples)
        epoch += 1


def run_stage(
    stage: StageSpec,
    device,
    scanners: dict[str, Callable[[], list]],
    ckpt_root,
    rng: np.random.Generator,
    init_params=None,
    raft_cfg=None,
    iters: Optional[int] = None,
    num_steps: Optional[int] = None,
    val_freq: int = 5000,
):
    """Train one stage on ``device``, or on a ('data', 'model') mesh from
    :func:`~nsof_tpu_torch.parallel.mesh.make_mesh` (every rank calls it with
    the same ``rng`` seed, so all draw the same global batches; the mesh's
    first rank writes the metrics log); returns ``(state, info)``.

    ``init_params`` (the previous stage's ``state_dict``) replaces the fresh
    initialisation — the optimizer restarts with this stage's schedule,
    exactly like ``--restore_ckpt`` + a new OneCycle (train.py:141-142,
    79-86).  ``num_steps`` overrides the spec for smoke runs.

    Dispatches on ``stage.model``: RAFT stages drive the RAFT step;
    FlowFormer stages (FLOWFORMER_STAGES) drive the FlowFormer step with
    this stage's experiment-tree model config, trainer block and twins lr
    groups (train_FlowFormer.py:56-66 + core/optimizer/__init__.py:22-33).
    ``raft_cfg`` overrides the model config for either family (smoke
    tests pass reduced-size configs through it).  Each model starts from
    torch's generator seeded with 0.
    """
    from nsof_tpu_torch.parallel import train as ptrain
    from nsof_tpu_torch.parallel.mesh import is_first_rank
    from nsof_tpu_torch.train.trainer import MetricLogger, train_loop

    steps = num_steps if num_steps is not None else stage.num_steps
    if stage.model == "flowformer":
        cfg, trainer = raft_cfg, {}
        if stage.ff_experiment is not None:
            exp = get_experiment(stage.ff_experiment)
            cfg = cfg or exp.model
            trainer = dict(wdecay=exp.adamw_decay, eps=exp.epsilon, clip=exp.clip)
        model, tx, state = ptrain.create_flowformer_state(
            0, device, cfg=cfg, lr=stage.lr, num_steps=steps,
            twins_lr_factor=stage.twins_lr_factor, **trainer,
        )
        step_fn = ptrain.make_flowformer_step(model, tx, device, gamma=stage.gamma)
    else:
        from nsof_tpu_torch.models.raft import RaftConfig

        cfg = raft_cfg or RaftConfig()
        model, tx, state = ptrain.create_train_state(
            0, device, cfg=cfg, lr=stage.lr, num_steps=steps,
        )
        step_fn = ptrain.make_train_step(model, tx, device,
                                         iters=cfg.iters if iters is None else iters,
                                         gamma=stage.gamma)
    if init_params is not None:
        model.load_state_dict(init_params)

    items = build_stage_items(stage, scanners)
    batches = mixed_batch_iterator(items, stage.batch_size, rng)
    ckpt_dir = pathlib.Path(ckpt_root) / stage.name
    logger = MetricLogger(str(ckpt_dir / "metrics.jsonl") if is_first_rank(state.mesh) else None)
    return train_loop(
        step_fn, state, batches, steps, logger=logger,
        ckpt_dir=str(ckpt_dir), val_freq=val_freq,
    )


def run_curriculum(
    device,
    data_root,
    ckpt_root,
    stages: Sequence[StageSpec] = RAFT_STANDARD_STAGES,
    scanners: Optional[dict[str, Callable[[], list]]] = None,
    raft_cfg=None,
    seed: int = 1234,
    steps_per_stage: Optional[int] = None,
    val_freq: int = 5000,
):
    """Run the full staged schedule on ``device`` or a mesh (see
    :func:`run_stage`), handing weights stage→stage (train_standard.sh's
    chained --restore_ckpt invocations).

    Returns {stage name: final TrainState}."""
    scanners = scanners or default_scanners(data_root)
    rng = np.random.default_rng(seed)
    results: dict[str, object] = {}
    for stage in stages:
        init_params = None
        if stage.restore_from is not None:
            if stage.restore_from not in results:
                raise ValueError(
                    f"stage {stage.name!r} restores from "
                    f"{stage.restore_from!r}, which has not run"
                )
            init_params = {k: v.detach().clone()
                           for k, v in results[stage.restore_from].params.items()}
        state, _ = run_stage(
            stage, device, scanners, ckpt_root, rng,
            init_params=init_params, raft_cfg=raft_cfg,
            num_steps=steps_per_stage, val_freq=val_freq,
        )
        results[stage.name] = state
    return results
