"""FlowFormer weights for the port: reference checkpoints and Flax
parameters.  The port of :mod:`nsof_tpu.models.flowformer.convert`.

The port's modules carry the reference's torch names
(FlowFormer-Official core/FlowFormer/LatentCostFormer/): the context
backbone at top level (``context_encoder.svt.*``), the feature backbone
inside the memory encoder (``memory_encoder.feat_encoder.svt.*``), GSA's
fused ``kv`` Linear.  A reference checkpoint (``checkpoints/things.pth``,
ff_seg.py:640-658) therefore loads directly, strictly, apart from the
tensors the model has no use for and which are dropped: the GMA's
``att.pos_emb`` (registered, never used in its forward, gma.py:52,64-73),
the Twins wrapper's leftover final norm ``svt.norm.*`` (encoders.py:9-17)
and ``num_batches_tracked``.

:func:`params_from_jax` carries a Flax parameter tree of the JAX model (as
numpy) into a ``state_dict`` of the port: :func:`flowformer_torch_sources`
maps each Flax path to its torch tensor (the JAX converter's mapping), and
the k and v halves of a GSA's fused ``kv`` are stacked.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from nsof_tpu_torch.models.convert import _check, load_torch_state_dict, raft_torch_key
from nsof_tpu_torch.models.flowformer.config import FlowFormerConfig
from nsof_tpu_torch.models.flowformer.model import FlowFormer

__all__ = ["flowformer_torch_sources", "params_from_jax", "load_flowformer_state",
           "pretrained_flowformer"]

_STAGE_RE = re.compile(r"^stage(\d)$")
_BLOCK_RE = re.compile(r"^block(\d+)$")
_SELF_RE = re.compile(r"^self(\d+)$")
_VERT_RE = re.compile(r"^vert(\d+)$")
_TWINS_ATTN = {"qkv": "qkv", "q": "q", "proj": "proj", "sr": "sr", "sr_norm": "norm"}
_VERT_LEAF = {
    "ctx": "attn.context_proj", "q": "attn.q", "k": "attn.k", "v": "attn.v",
    "proj": "attn.proj", "srk": "attn.sr_key", "srv": "attn.sr_value", "srnorm": "attn.norm",
    "norm1": "norm1", "norm2": "norm2",
}
# reference tensors the model does not hold
_DROPPED = (
    re.compile(r"memory_decoder\.att\.pos_emb\."),
    re.compile(r"(memory_encoder\.feat_encoder|context_encoder)\.svt\.norm\."),
    re.compile(r"\.num_batches_tracked$"),
)


def _twins_key(parts: list[str]) -> tuple[str, str | None]:
    """A path inside the JAX TwinsSVTLarge2Stage → (``svt.`` suffix, the
    half 'k' or 'v' of a fused ``kv`` tensor, or None)."""
    stage = int(_STAGE_RE.match(parts[0]).group(1)) - 1
    rest = parts[1:]
    if rest[0] == "patch_embed":
        return f"patch_embeds.{stage}.proj", None
    if rest[0] == "patch_norm":
        return f"patch_embeds.{stage}.norm", None
    if rest[0] == "peg":
        return f"pos_block.{stage}.proj.0", None
    m = _BLOCK_RE.match(rest[0])
    if not m:
        raise KeyError(f"unmapped twins path {parts}")
    base = f"blocks.{stage}.{int(m.group(1))}"
    inner = rest[1:]
    if inner[0] == "attn":
        if inner[1] in ("k", "v"):
            return f"{base}.attn.kv", inner[1]
        return f"{base}.attn.{_TWINS_ATTN[inner[1]]}", None
    if inner[0] == "mlp":
        return f"{base}.mlp.{'fc1' if inner[1] == 'Dense_0' else 'fc2'}", None
    return f"{base}.{inner[0]}", None


def _attention_layer_key(base: str, parts: list[str]) -> str:
    """Self and cross attention layers: norm1/norm2/q/k/v/proj and the ffn
    Sequential's Linears at indices 0 and 3."""
    if parts[0] == "ffn":
        return f"{base}.ffn.{'0' if parts[1] == 'Dense_0' else '3'}"
    return f"{base}.{parts[0]}"


def _vert_key(idx: int, parts: list[str]) -> str:
    blk, leaf = parts[0].split("_", 1)
    base = f"vertical_encoder_layers.{idx}.{'local_block' if blk == 'local' else 'global_block'}"
    if leaf == "mlp":
        return f"{base}.mlp.{'fc1' if parts[1] == 'Dense_0' else 'fc2'}"
    return f"{base}.{_VERT_LEAF[leaf]}"


def _backbone_key(parts: list[str], kind: str):
    """The Twins trunk's ``svt.`` names, or a RAFT BasicEncoder's."""
    if kind == "twins":
        key, half = _twins_key(parts)
        return f"svt.{key}", half
    return raft_torch_key(tuple(parts)), None


def flowformer_torch_sources(flax_path: tuple[str, ...],
                             cfg: FlowFormerConfig = FlowFormerConfig()
                             ) -> tuple[str, str | None]:
    """The torch module (or parameter) name feeding a Flax module path of
    the JAX model (the path without its leaf kind), and the kv half ('k',
    'v' or None)."""
    parts = list(flax_path)
    head, rest = parts[0], parts[1:]
    if head == "context_encoder":
        key, half = _backbone_key(rest, cfg.cnet)
        return f"context_encoder.{key}", half
    if head == "feat_encoder":
        key, half = _backbone_key(rest, cfg.fnet)
        return f"memory_encoder.feat_encoder.{key}", half
    if head == "memory_encoder":
        if rest[0] == "channel_convertor":
            return "memory_encoder.channel_convertor", None
        cp = "memory_encoder.cost_perceiver_encoder"
        rest = rest[1:]
        if rest[0] == "patch_embed":
            conv_idx = {"proj0": "proj.0", "proj1": "proj.2", "proj2": "proj.4",
                        "ffn0": "ffn_with_coord.0", "ffn1": "ffn_with_coord.2", "norm": "norm"}
            return f"{cp}.patch_embed.{conv_idx[rest[1]]}", None
        if rest[0] == "latent_tokens":
            return f"{cp}.latent_tokens", None
        if rest[0] == "input_layer":
            return _attention_layer_key(f"{cp}.input_layer", rest[1:]), None
        m = _SELF_RE.match(rest[0])
        if m:
            return _attention_layer_key(f"{cp}.encoder_layers.{int(m.group(1))}", rest[1:]), None
        m = _VERT_RE.match(rest[0])
        if m:
            return f"{cp}.{_vert_key(int(m.group(1)), rest[1:])}", None
        raise KeyError(f"unmapped encoder path {parts}")
    if head == "memory_decoder":
        md = "memory_decoder"
        if rest[0] in ("Conv_0", "Conv_1"):
            return f"{md}.flow_token_encoder.{'0' if rest[0] == 'Conv_0' else '2'}", None
        if rest[0] == "proj":
            return f"{md}.proj", None
        if rest[0] == "att":
            return f"{md}.att.to_qk", None
        if rest[0] in ("mem_k", "mem_v"):
            return f"{md}.decoder_layer.cross_attend.{rest[0][-1]}", None
        if rest[0] == "decoder_layer":
            return _attention_layer_key(f"{md}.decoder_layer.cross_attend", rest[1:]), None
        if rest[0] == "update_block":
            ub = f"{md}.update_block"
            inner = rest[1:]
            if inner[0] in ("Conv_0", "Conv_1"):
                return f"{ub}.mask.{'0' if inner[0] == 'Conv_0' else '2'}", None
            if inner[0] in ("aggregator", "encoder"):
                return f"{ub}.{inner[0]}.{inner[1]}", None
            if inner[0] == "flow_head":
                return f"{ub}.flow_head.{'conv1' if inner[1] == 'Conv_0' else 'conv2'}", None
            if inner[0] == "gru":
                m = re.fullmatch(r"conv([zrq])_([hv])", inner[1])
                return f"{ub}.gru.conv{m.group(1)}{'1' if m.group(2) == 'h' else '2'}", None
        raise KeyError(f"unmapped decoder path {parts}")
    raise KeyError(f"unmapped path {parts}")


def params_from_jax(params: Mapping[str, Any],
                    cfg: FlowFormerConfig = FlowFormerConfig()) -> dict[str, torch.Tensor]:
    """A Flax parameter tree of ``nsof_tpu.models.flowformer.FlowFormer(cfg)``
    (nested dicts of arrays) → a ``state_dict`` of the port's
    ``FlowFormer(cfg)``: conv kernels HWIO → OIHW, dense kernels [in, out]
    → [out, in], LayerNorm scales → weights, the k and v halves of each
    fused ``kv`` stacked k first.  Raises ``ValueError`` if a port tensor is
    left without a source, a source is left unused, or a shape differs."""
    flat: dict[str, np.ndarray] = {}
    halves: dict[str, dict[str, np.ndarray]] = {}

    def put(key, half, val):
        if half is None:
            flat[key] = val
        else:
            halves.setdefault(key, {})[half] = val

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
                continue
            val = np.asarray(v, dtype=np.float32)
            if k in ("latent_tokens", "gamma"):
                base, _ = flowformer_torch_sources(path + (k,), cfg)
                put(base, None, val)
                continue
            base, half = flowformer_torch_sources(path, cfg)
            if k == "kernel":
                val = np.transpose(val, (3, 2, 0, 1)) if val.ndim == 4 else val.T
                put(f"{base}.weight", half, val)
            elif k == "scale":
                put(f"{base}.weight", half, val)
            else:
                put(f"{base}.{k}", half, val)

    walk(params, ())
    for key, kv in halves.items():
        flat[key] = np.concatenate([kv["k"], kv["v"]], axis=0)
    target = FlowFormer(cfg).state_dict()
    out, errors = {}, []
    for key, ref in target.items():
        if key not in flat:
            errors.append(f"{key}: no Flax source")
        elif tuple(flat[key].shape) != tuple(ref.shape):
            errors.append(f"{key}: shape {tuple(flat[key].shape)} != {tuple(ref.shape)}")
        else:
            out[key] = torch.from_numpy(np.ascontiguousarray(flat[key]))
    errors += [f"{k}: unused Flax parameter" for k in sorted(set(flat) - set(target))]
    _check(errors, "FlowFormer parameter conversion")
    return out


def load_flowformer_state(model: FlowFormer, state: Mapping[str, Any]) -> FlowFormer:
    """Load a reference-format ``state`` into ``model`` strictly: the keys
    must be the model's, shapes equal, apart from the dropped tensors
    (``att.pos_emb``, ``svt.norm``, ``num_batches_tracked``).  Raises
    ``ValueError`` naming each mismatch."""
    state = {k: torch.as_tensor(v) for k, v in state.items()
             if not any(p.search(k) for p in _DROPPED)}
    target = model.state_dict()
    errors = [f"{k}: missing from the checkpoint" for k in target if k not in state]
    errors += [f"{k}: unused checkpoint tensor" for k in state if k not in target]
    errors += [f"{k}: shape {tuple(state[k].shape)} != {tuple(target[k].shape)}"
               for k in target if k in state and tuple(state[k].shape) != tuple(target[k].shape)]
    _check(errors, "FlowFormer checkpoint loading")
    model.load_state_dict({k: state[k].to(target[k].dtype) for k in target}, strict=True)
    return model


def pretrained_flowformer(path: str, cfg: FlowFormerConfig | None = None) -> FlowFormer:
    """The port's FlowFormer with a reference checkpoint's weights
    (things.pth, sintel.pth, ...), in eval mode on the CPU: the torch side
    of ff_seg.py:640-658.  The default ``cfg`` keeps the JAX package's
    ``gsa_pad='same'``; the published GSA is ``'valid'``, and the two differ
    where a Twins grid is not a multiple of its sr (side / 4 at sr 8, side
    / 8 at sr 4: a frame side that is not a multiple of 32), so a published
    checkpoint run at such frames needs
    ``FlowFormerConfig(gsa_pad='valid')``."""
    return load_flowformer_state(FlowFormer(cfg or FlowFormerConfig()),
                                 load_torch_state_dict(path)).eval()
