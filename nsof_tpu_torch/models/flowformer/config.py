"""FlowFormer configuration: the port's copy of
:mod:`nsof_tpu.models.flowformer.config`.

Typed-dataclass replacement for the reference's yacs CfgNode trees
(codebase/FlowFormer-Official/configs/*.py).  :class:`FlowFormerConfig`
defaults mirror ``configs/things_eval.py:18-53`` — the checkpoint
configuration the neuromorphic FF pipelines load (ff_seg.py:648-653).
One field is the port's own: ``gsa_pad``, how the Twins backbones' global
sub-sampled attention (GSA) cuts its key grid (see below).
:data:`FF_EXPERIMENTS` replicates every per-stage experiment tree the
reference ships (configs/{default,things,sintel,kitti,things_eval,
small_things_eval,submission,things_flowformer_sharp}.py) as typed
presets — stage-specific training params (gamma/batch/crop/lr/decay/
steps) plus the model-architecture deltas (e.g. small_things_eval's
4-token, 32-dim latent with basicencoder backbones).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch


@dataclasses.dataclass(frozen=True)
class FlowFormerConfig:
    # latent cost tokens
    encoder_latent_dim: int = 256  # twins stage-2 output dim
    query_latent_dim: int = 64
    cost_latent_input_dim: int = 64
    cost_latent_token_num: int = 8
    cost_latent_dim: int = 128
    cost_heads_num: int = 1
    # encoder
    encoder_depth: int = 3
    patch_size: int = 8
    vert_c_dim: int = 64
    cost_encoder_res: bool = True
    # decoder
    decoder_depth: int = 32
    add_flow_token: bool = True
    use_gma: bool = True
    only_global: bool = False
    # backbone: 'twins' (SVT-large first two stages) or 'basic' (RAFT CNN)
    cnet: str = "twins"
    fnet: str = "twins"
    # the Twins GSA's sub-sampling convolution (kernel = stride = sr): 'same'
    # pads as Flax's 'SAME' and keeps ceil(side / sr) keys a side, the JAX
    # package's behaviour; 'valid' is the published one, timm's unpadded
    # Conv2d, floor(side / sr) keys, the trailing rows and columns unused.
    # They agree where every stage's grid is a multiple of its sr (8, then 4).
    gsa_pad: str = "same"
    compute_dtype: Any = torch.float32
    # recompute each decoder step in the backward pass (as RaftConfig.remat:
    # at depth 32 the stored per-step activations dominate training memory)
    remat: bool = False


# Tiled-inference constants (visualize_flow.py:27-100)
TRAIN_SIZE = (432, 960)
TILE_MIN_OVERLAP = 20


@dataclasses.dataclass(frozen=True)
class FlowFormerExperiment:
    """One reference config tree (configs/<name>.py): the top-level
    training/eval fields plus this experiment's model configuration.

    ``restore_ckpt`` names the previous stage whose weights initialise
    training (``_CN.restore_ckpt``, e.g. configs/sintel.py:16 restores
    ``checkpoints/things.pth``); ``eval_ckpt`` names the checkpoint an
    eval-only tree loads (``_CN.model``, e.g. things_eval.py:16).
    """

    name: str
    suffix: str
    gamma: float
    max_flow: float
    batch_size: int
    sum_freq: int
    val_freq: int
    image_size: tuple[int, int]
    add_noise: bool
    restore_ckpt: Optional[str]
    eval_ckpt: Optional[str]
    model: FlowFormerConfig
    # trainer block (_CN.trainer.*)
    canonical_lr: float
    adamw_decay: float
    clip: float
    num_steps: int
    epsilon: float

    def train_stage_kwargs(self) -> dict:
        """The fields run_stage/StageSpec consume, in its vocabulary."""
        return dict(
            num_steps=self.num_steps,
            batch_size=self.batch_size,
            lr=self.canonical_lr,
            image_size=self.image_size,
            wdecay=self.adamw_decay,
            gamma=self.gamma,
        )


def _exp(
    name: str,
    suffix: str,
    *,
    gamma: float = 0.8,
    max_flow: float = 400.0,
    batch_size: int = 6,
    sum_freq: int = 100,
    val_freq: int = 5_000_000,
    image_size: tuple[int, int] = (432, 960),
    add_noise: bool = True,
    restore_ckpt: Optional[str] = None,
    eval_ckpt: Optional[str] = None,
    canonical_lr: float = 12.5e-5,
    adamw_decay: float = 1e-4,
    clip: float = 1.0,
    num_steps: int = 120_000,
    epsilon: float = 1e-8,
    **model_overrides,
) -> FlowFormerExperiment:
    model = FlowFormerConfig(**model_overrides)
    return FlowFormerExperiment(
        name=name, suffix=suffix, gamma=gamma, max_flow=max_flow,
        batch_size=batch_size, sum_freq=sum_freq, val_freq=val_freq,
        image_size=image_size, add_noise=add_noise,
        restore_ckpt=restore_ckpt, eval_ckpt=eval_ckpt, model=model,
        canonical_lr=canonical_lr, adamw_decay=adamw_decay, clip=clip,
        num_steps=num_steps, epsilon=epsilon,
    )


# The reference's experiment trees, value-for-value.  Training stages use
# decoder_depth 12 (configs/things.py:50); eval/submission trees use 32
# (things_eval.py:51) — the depth the released checkpoints run at.
FF_EXPERIMENTS: dict[str, FlowFormerExperiment] = {
    # configs/default.py — the chairs stage (train_FlowFormer.py:146-147)
    "chairs": _exp(
        "default", "arxiv2",
        batch_size=8, val_freq=5_000, image_size=(368, 496),
        restore_ckpt=None, canonical_lr=25e-5,
        decoder_depth=12,
    ),
    # configs/things.py
    "things": _exp(
        "", "",
        restore_ckpt="chairs",
        decoder_depth=12,
    ),
    # configs/sintel.py
    "sintel": _exp(
        "default", "sintel",
        gamma=0.85, restore_ckpt="things", adamw_decay=1e-5,
        decoder_depth=12,
    ),
    # configs/kitti.py
    "kitti": _exp(
        "kitti", "kitti",
        gamma=0.85, val_freq=499_999_999, restore_ckpt="sintel",
        adamw_decay=1e-5, num_steps=50_000,
        decoder_depth=12,
    ),
    # configs/things_eval.py — the neuromorphic pipelines' tree
    "things_eval": _exp(
        "", "",
        batch_size=1, add_noise=False, eval_ckpt="things",
        decoder_depth=32,
    ),
    # configs/small_things_eval.py — FlowFormer-small: 1-layer encoder,
    # 4×32 latent, no vertical context, RAFT CNN backbones (:25-44)
    "small_things_eval": _exp(
        "", "",
        add_noise=False, eval_ckpt="flowformer-small/things",
        cost_latent_token_num=4, cost_latent_dim=32, encoder_depth=1,
        vert_c_dim=0, cnet="basic", fnet="basic", decoder_depth=32,
    ),
    # configs/submission.py — Sintel/KITTI test-server submission runs
    "submission": _exp(
        "", "",
        add_noise=False, eval_ckpt="sintel",
        decoder_depth=32,
    ),
    # configs/things_flowformer_sharp.py — things at the 400×720 crop
    "things_sharp": _exp(
        "", "",
        image_size=(400, 720), restore_ckpt="chairs",
        decoder_depth=12,
    ),
}


def get_experiment(name: str) -> FlowFormerExperiment:
    """configs/<name>.py equivalent lookup (process_cfg's role)."""
    try:
        return FF_EXPERIMENTS[name]
    except KeyError:
        raise KeyError(
            f"unknown FlowFormer experiment {name!r}; "
            f"have {sorted(FF_EXPERIMENTS)}"
        ) from None
