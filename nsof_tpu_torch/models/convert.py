"""RAFT weights for the port: reference checkpoints and Flax parameters.

The port of :mod:`nsof_tpu.models.convert`.  The port's RAFT modules carry
the reference's torch names, so a reference checkpoint (``raft-things.pth``,
``raft-small.pth``, the reference's ``download_models.sh``) loads into them
directly:

- ``module.`` prefixes (``nn.DataParallel``) are stripped;
- BatchNorm2d (the basic model's cnet, core/extractor.py:131) is folded into
  the ``'frozenbatch'`` per-channel affine: ``scale = weight /
  sqrt(running_var + eps)``, ``bias = bias - running_mean · scale``, which
  is BatchNorm in eval mode, as the reference runs inference;
- the downsampling norms are registered twice (``normN`` and
  ``downsample.1``), in the reference and in the port alike;
- every tensor of the port is taken from the checkpoint with its shape
  checked, and every checkpoint tensor but ``num_batches_tracked`` is used,
  or loading fails naming each mismatch.

:func:`params_from_jax` carries a Flax parameter tree of the JAX model (as
numpy) into a ``state_dict`` of the port, through :func:`raft_torch_key`,
the JAX converter's path mapping.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from nsof_tpu_torch.models.raft import NORM_EPS, RAFT, AffineNorm, RaftConfig

__all__ = [
    "load_torch_state_dict",
    "raft_torch_key",
    "params_from_jax",
    "infer_raft_config",
    "load_raft_state",
    "pretrained_raft",
]

_LAYER_RE = re.compile(r"^layer(\d+)_(\d+)$")


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Read a torch checkpoint on the CPU (``weights_only``), stripping
    ``module.`` prefixes; a ``{'state_dict': ...}`` wrapper is opened."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in raw.items()}


def raft_torch_key(flax_path: tuple[str, ...]) -> str:
    """The torch module name of a Flax module path of the JAX model, e.g.
    ``('fnet', 'layer1_0', 'downsample')`` → ``fnet.layer2.0.downsample.0``."""
    parts = list(flax_path)
    out: list[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        m = _LAYER_RE.match(p)
        if m:
            out.append(f"layer{int(m.group(1)) + 1}.{m.group(2)}")
        elif p == "update_block" and i + 1 < len(parts) and parts[i + 1] in ("Conv_0", "Conv_1"):
            out += ["update_block", "mask.0" if parts[i + 1] == "Conv_0" else "mask.2"]
            i += 2
            continue
        elif p in ("Conv_0", "Conv_1") and out and out[-1] == "flow_head":
            out.append("conv1" if p == "Conv_0" else "conv2")
        elif re.fullmatch(r"conv[zrq]_[hv]", p):
            out.append(p[:5] + ("1" if p.endswith("h") else "2"))
        elif p == "downsample":
            out.append("downsample.0")
        else:
            out.append(p)
        i += 1
    return ".".join(out)


def _fold_batchnorm(state: Mapping[str, Any], key: str) -> tuple[np.ndarray, np.ndarray]:
    """BatchNorm ``key``'s eval-mode affine (scale, bias), computed in
    float64 and rounded to float32 once."""
    def get(name):
        return np.asarray(state[f"{key}.{name}"], dtype=np.float64)

    scale = get("weight") / np.sqrt(get("running_var") + NORM_EPS)
    bias = get("bias") - get("running_mean") * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def _check(errors: list[str], what: str) -> None:
    if errors:
        raise ValueError(f"{what} failed:\n  " + "\n  ".join(errors))


def params_from_jax(params: Mapping[str, Any], cfg: RaftConfig) -> dict[str, torch.Tensor]:
    """A Flax parameter tree of ``nsof_tpu.models.raft.RAFT(cfg)`` (nested
    dicts of arrays) → a ``state_dict`` of the port's ``RAFT(cfg)``.
    Conv kernels go from HWIO to OIHW; norm scales become weights.  Raises
    ``ValueError`` if a port tensor is left without a source, a source is
    left unused, or a shape differs."""
    flat: dict[str, np.ndarray] = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                base = raft_torch_key(path)
                val = np.asarray(v, dtype=np.float32)
                if k == "kernel":
                    flat[f"{base}.weight"] = np.transpose(val, (3, 2, 0, 1))
                elif k == "scale":
                    flat[f"{base}.weight"] = val
                else:
                    flat[f"{base}.{k}"] = val

    walk(params, ())
    target = RAFT(cfg).state_dict()
    out, errors, used = {}, [], set()
    for key, ref in target.items():
        src = key
        if src not in flat:
            m = re.fullmatch(r"(.*)\.downsample\.1\.(\w+)", key)
            alias = [n for n in (f"{m.group(1)}.norm4.{m.group(2)}",
                                 f"{m.group(1)}.norm3.{m.group(2)}") if n in target] if m else []
            src = alias[0] if alias else key
        if src not in flat:
            errors.append(f"{key}: no Flax source")
            continue
        if tuple(flat[src].shape) != tuple(ref.shape):
            errors.append(f"{key}: shape {tuple(flat[src].shape)} != {tuple(ref.shape)}")
            continue
        used.add(src)
        out[key] = torch.from_numpy(np.ascontiguousarray(flat[src]))
    errors += [f"{k}: unused Flax parameter" for k in sorted(set(flat) - used)]
    _check(errors, "RAFT parameter conversion")
    return out


def infer_raft_config(state: Mapping[str, Any]) -> RaftConfig:
    """Small or basic from a reference state_dict's structure (a bottleneck
    ``conv3`` means small; core/raft.py:29-39's hyperparameters)."""
    if any(k.startswith("fnet.layer1.0.conv3") for k in state):
        return RaftConfig(small=True, corr_levels=4, corr_radius=3)
    return RaftConfig(small=False, corr_levels=4, corr_radius=4, cnet_norm="frozenbatch")


def load_raft_state(model: RAFT, state: Mapping[str, Any]) -> RAFT:
    """Load a reference-format ``state`` into ``model``, strictly: every
    tensor of the model from the checkpoint with its shape checked (the
    ``'frozenbatch'`` affines folded from BatchNorm statistics), and every
    checkpoint tensor but ``num_batches_tracked`` used.  Raises
    ``ValueError`` naming each mismatch."""
    affine = {name for name, mod in model.named_modules(remove_duplicate=False)
              if isinstance(mod, AffineNorm)}
    target = model.state_dict()
    out, errors, used = {}, [], set()
    for key, ref in target.items():
        mod, leaf = key.rsplit(".", 1)
        try:
            if mod in affine and f"{mod}.running_mean" in state:
                scale, bias = _fold_batchnorm(state, mod)
                val = torch.from_numpy(scale if leaf == "weight" else bias)
                used |= {f"{mod}.{n}" for n in ("weight", "bias", "running_mean", "running_var")}
            else:
                val = torch.as_tensor(state[key])
                used.add(key)
        except KeyError as exc:
            errors.append(f"{key}: missing from the checkpoint ({exc})")
            continue
        if tuple(val.shape) != tuple(ref.shape):
            errors.append(f"{key}: shape {tuple(val.shape)} != {tuple(ref.shape)}")
            continue
        out[key] = val.to(ref.dtype)
    errors += [f"{k}: unused checkpoint tensor" for k in state
               if k not in used and not k.endswith("num_batches_tracked")]
    _check(errors, "RAFT checkpoint loading")
    model.load_state_dict(out, strict=True)
    return model


def pretrained_raft(path: str, iters: int | None = None) -> RAFT:
    """The port's RAFT with a reference checkpoint's weights
    (raft-things.pth, raft-small.pth, raft-sintel.pth, ...), in eval mode on
    the CPU: the torch side of raft_seg.py:595-607.

    The model keeps the JAX package's ``corr_pool='ceil'``, which this
    loader's JAX-parity test pins.  A published checkpoint runs as published
    only with ``corr_pool='floor'`` wherever a 1/8 side is odd at some
    pyramid level (a 640×360 frame: 45 columns); build that model with
    ``RAFT(dataclasses.replace(infer_raft_config(state), corr_pool='floor'))``
    and :func:`load_raft_state`."""
    import dataclasses

    state = load_torch_state_dict(path)
    cfg = infer_raft_config(state)
    if iters is not None:
        cfg = dataclasses.replace(cfg, iters=iters)
    return load_raft_state(RAFT(cfg), state).eval()
