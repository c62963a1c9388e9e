"""YOLOv8 detection in PyTorch: the port of :mod:`nsof_tpu.models.yolov8`.

The detector behind the YOLO-on-ROI pipeline (the reference runs
ultralytics YOLOv8n on each ROI crop and on the full frame,
optical_flow_yolo.py:442-682): the CSP backbone with C2f blocks, SPPF, the
PAN neck and the decoupled anchor-free DFL head, at every scale of
ultralytics' ``yolov8.yaml`` (n, s, m, l, x).

Inference only, as in the JAX package: BatchNorm (eval mode, eps 1e-3) is
folded into the preceding convolution when an ultralytics ``state_dict`` is
converted, so the graph is convolution + SiLU.  NCHW inside; the modules
carry the JAX model's Flax names (``l2.m0.cv1.conv``, ``l22.cv2_0_2``), so
:func:`params_from_jax` maps a converted Flax tree one to one.

:func:`decode_predictions` (DFL softmax expectation → boxes) and
:func:`postprocess` (top ``max_det`` candidates, class-aware greedy NMS)
run on the tensors' device with fixed shapes and no host synchronisation.
The NMS of :func:`postprocess` is
:func:`nsof_tpu_torch.ops.components.nms_batch`: kernel K9 on the card, the
plain loop on the CPU.

No checkpoint ships with the reference (``yolov8n.pt`` is a missing large
blob); :func:`synthetic_state_dict` gives random weights of the exact
ultralytics key and shape schema, drawn as the JAX fixture draws them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nsof_tpu_torch.ops.components import nms_batch

BN_EPS = 1e-3  # ultralytics Conv: BatchNorm2d(eps=0.001, momentum=0.03)
REG_MAX = 16
STRIDES = (8, 16, 32)
# the per-class box offset of the class-aware NMS, in px
CLASS_OFFSET = 7680.0

# depth, width, max_channels per scale (ultralytics yolov8.yaml `scales`)
SCALES: dict[str, tuple[float, float, int]] = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}


def _make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(x + divisor / 2) // divisor * divisor)


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    scale: str = "n"
    num_classes: int = 80
    compute_dtype: Any = torch.float32

    @property
    def depth(self) -> float:
        return SCALES[self.scale][0]

    @property
    def width(self) -> float:
        return SCALES[self.scale][1]

    @property
    def max_channels(self) -> int:
        return SCALES[self.scale][2]

    def ch(self, c: int) -> int:
        return _make_divisible(min(c, self.max_channels) * self.width)

    def n_rep(self, n: int) -> int:
        return max(round(n * self.depth), 1)

    @property
    def backbone_channels(self) -> tuple[int, ...]:
        """(stem, p2, p3, p4, p5) conv widths."""
        return tuple(self.ch(c) for c in (64, 128, 256, 512, 1024))


def _conv(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv`` computed in ``x``'s dtype (the Flax ``dtype``: parameters
    stay float32, the product runs in the compute dtype)."""
    return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), conv.stride,
                    conv.padding)


class ConvBlock(nn.Module):
    """Conv + (folded BN) + SiLU — ultralytics ``Conv`` in eval mode."""

    def __init__(self, c_in: int, feats: int, k: int = 1, s: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(c_in, feats, k, s, k // 2, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(_conv(self.conv, x))


class Bottleneck(nn.Module):
    def __init__(self, feats: int, shortcut: bool = True):
        super().__init__()
        self.cv1 = ConvBlock(feats, feats, 3)
        self.cv2 = ConvBlock(feats, feats, 3)
        self.shortcut = shortcut

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.shortcut else y


class C2f(nn.Module):
    """Cross-stage partial block: split, chain n bottlenecks, concat."""

    def __init__(self, c_in: int, feats: int, n: int = 1, shortcut: bool = False):
        super().__init__()
        self.c = feats // 2
        self.cv1 = ConvBlock(c_in, 2 * self.c, 1)
        self.n = n
        for i in range(n):
            setattr(self, f"m{i}", Bottleneck(self.c, shortcut))
        self.cv2 = ConvBlock((2 + n) * self.c, feats, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        parts = [y[:, : self.c], y[:, self.c :]]
        for i in range(self.n):
            parts.append(getattr(self, f"m{i}")(parts[-1]))
        return self.cv2(torch.cat(parts, dim=1))


class SPPF(nn.Module):
    """Spatial pyramid pooling (fast): 3 chained 5×5 max-pools."""

    def __init__(self, c_in: int, feats: int):
        super().__init__()
        c = c_in // 2
        self.cv1 = ConvBlock(c_in, c, 1)
        self.cv2 = ConvBlock(4 * c, feats, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pools = [self.cv1(x)]
        for _ in range(3):
            pools.append(F.max_pool2d(pools[-1], 5, 1, 2))
        return self.cv2(torch.cat(pools, dim=1))


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2× (torch nn.Upsample(scale_factor=2))."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class DetectHead(nn.Module):
    """Decoupled anchor-free head: per-scale box (4·reg_max DFL logits)
    and class branches (ultralytics ``Detect``)."""

    def __init__(self, num_classes: int, in_channels: Sequence[int]):
        super().__init__()
        c2 = max(16, in_channels[0] // 4, REG_MAX * 4)
        c3 = max(in_channels[0], min(num_classes, 100))
        for i, cin in enumerate(in_channels):
            setattr(self, f"cv2_{i}_0", ConvBlock(cin, c2, 3))
            setattr(self, f"cv2_{i}_1", ConvBlock(c2, c2, 3))
            setattr(self, f"cv2_{i}_2", nn.Conv2d(c2, 4 * REG_MAX, 1, bias=True))
            setattr(self, f"cv3_{i}_0", ConvBlock(cin, c3, 3))
            setattr(self, f"cv3_{i}_1", ConvBlock(c3, c3, 3))
            setattr(self, f"cv3_{i}_2", nn.Conv2d(c3, num_classes, 1, bias=True))

    def forward(self, feats: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        outs = []
        for i, x in enumerate(feats):
            box = getattr(self, f"cv2_{i}_1")(getattr(self, f"cv2_{i}_0")(x))
            box = _conv(getattr(self, f"cv2_{i}_2"), box)
            cls = getattr(self, f"cv3_{i}_1")(getattr(self, f"cv3_{i}_0")(x))
            cls = _conv(getattr(self, f"cv3_{i}_2"), cls)
            outs.append(torch.cat([box, cls], dim=1))
        return outs


class YOLOv8(nn.Module):
    """Full detector; ``forward`` takes ``[B, 3, H, W]`` RGB in [0, 1] and
    returns the per-scale raw head outputs ``[B, 4·reg_max + nc, H/s, W/s]``
    for s in (8, 16, 32).  Use :func:`decode_predictions` to get
    boxes/scores."""

    def __init__(self, config: YoloConfig = YoloConfig()):
        super().__init__()
        self.config = cfg = config
        c1, c2, c3, c4, c5 = cfg.backbone_channels
        n3, n6 = cfg.n_rep(3), cfg.n_rep(6)
        # backbone (layers 0-9)
        self.l0 = ConvBlock(3, c1, 3, 2)
        self.l1 = ConvBlock(c1, c2, 3, 2)
        self.l2 = C2f(c2, c2, n3, True)
        self.l3 = ConvBlock(c2, c3, 3, 2)
        self.l4 = C2f(c3, c3, n6, True)
        self.l5 = ConvBlock(c3, c4, 3, 2)
        self.l6 = C2f(c4, c4, n6, True)
        self.l7 = ConvBlock(c4, c5, 3, 2)
        self.l8 = C2f(c5, c5, n3, True)
        self.l9 = SPPF(c5, c5)
        # PAN neck (layers 10-21)
        self.l12 = C2f(c5 + c4, c4, n3, False)
        self.l15 = C2f(c4 + c3, c3, n3, False)
        self.l16 = ConvBlock(c3, c3, 3, 2)
        self.l18 = C2f(c3 + c4, c4, n3, False)
        self.l19 = ConvBlock(c4, c4, 3, 2)
        self.l21 = C2f(c4 + c5, c5, n3, False)
        self.l22 = DetectHead(cfg.num_classes, (c3, c4, c5))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = x.to(self.config.compute_dtype)
        x = self.l2(self.l1(self.l0(x)))
        p3 = self.l4(self.l3(x))
        p4 = self.l6(self.l5(p3))
        p5 = self.l9(self.l8(self.l7(p4)))
        h4 = self.l12(torch.cat([_upsample2(p5), p4], dim=1))
        h3 = self.l15(torch.cat([_upsample2(h4), p3], dim=1))  # P3/8
        n4 = self.l18(torch.cat([self.l16(h3), h4], dim=1))  # P4/16
        n5 = self.l21(torch.cat([self.l19(n4), p5], dim=1))  # P5/32
        return self.l22([h3, n4, n5])


def decode_predictions(outs: Sequence[torch.Tensor], num_classes: int,
                       strides: Sequence[int] = STRIDES) -> tuple[torch.Tensor, torch.Tensor]:
    """Raw head outputs ``[B, 4·reg_max + nc, H, W]`` → (boxes ``[B, N, 4]``
    xyxy px, scores ``[B, N, nc]``), N over the scales' cells in row-major
    order.

    DFL: softmax over the reg_max bins of each side's distribution (the 64
    box channels are side-major, ``side·16 + bin``), then the expectation
    gives the l/t/r/b distances in stride units from the anchor centre
    (cell centre + 0.5)."""
    boxes, scores = [], []
    for x, s in zip(outs, strides):
        b, _, h, w = x.shape
        x = x.float().permute(0, 2, 3, 1)  # [B, H, W, C]
        bins = torch.arange(REG_MAX, dtype=torch.float32, device=x.device)
        box = x[..., : 4 * REG_MAX].reshape(b, h, w, 4, REG_MAX)
        dist = torch.softmax(box, dim=-1) @ bins  # [B, H, W, 4] l, t, r, b
        cy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None] + 0.5
        cx = torch.arange(w, dtype=torch.float32, device=x.device)[None, :] + 0.5
        x1 = (cx - dist[..., 0]) * s
        y1 = (cy - dist[..., 1]) * s
        x2 = (cx + dist[..., 2]) * s
        y2 = (cy + dist[..., 3]) * s
        boxes.append(torch.stack([x1, y1, x2, y2], dim=-1).reshape(b, h * w, 4))
        scores.append(torch.sigmoid(x[..., 4 * REG_MAX :]).reshape(b, h * w, num_classes))
    return torch.cat(boxes, dim=1), torch.cat(scores, dim=1)


def _descending(v: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort(v)[::-1]`` along the last axis: a stable ascending
    sort reversed, so of equal values the higher index comes first."""
    return torch.sort(v, dim=-1, stable=True).indices.flip(-1)


def postprocess(boxes: torch.Tensor, scores: torch.Tensor, conf: float = 0.25,
                iou: float = 0.45, max_det: int = 300) -> dict[str, torch.Tensor]:
    """Batched class-aware NMS on the device (the ultralytics post step).

    Returns fixed-shape {boxes [B, K, 4], scores [B, K], classes [B, K]
    int32, valid [B, K] bool}, K = min(max_det, N), in descending score
    order; invalid slots are zero.  Class-aware via the per-class box
    offset (``CLASS_OFFSET`` px a class id)."""
    boxes = boxes.float()
    best, cls = scores.float().max(dim=-1)
    cls = cls.to(torch.int32)
    neg = torch.full((), -1.0, device=best.device)
    # keep only the top max_det candidates (static shape for NMS)
    order = _descending(torch.where(best >= conf, best, neg))[:, :max_det]
    bx = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    sc = torch.gather(best, 1, order)
    cl = torch.gather(cls, 1, order)
    off = cl.to(torch.float32)[..., None] * CLASS_OFFSET
    keep = nms_batch(bx + off, sc, sc >= conf, iou, plus_one=False)
    keep_order = _descending(torch.where(keep, sc, neg))
    bx = torch.gather(bx, 1, keep_order[..., None].expand(-1, -1, 4))
    sc, cl, keep = (torch.gather(v, 1, keep_order) for v in (sc, cl, keep))
    return {
        "boxes": torch.where(keep[..., None], bx, torch.zeros_like(bx)),
        "scores": torch.where(keep, sc, torch.zeros_like(sc)),
        "classes": torch.where(keep, cl, torch.zeros_like(cl)),
        "valid": keep,
    }


# ---------------------------------------------------------------------------
# ultralytics checkpoint conversion
# ---------------------------------------------------------------------------

#: (layer index, module kind) for the v8 detection graph; parameterless
#: Upsample/Concat layers (10, 11, 13, 14, 17, 20) carry no state.
_LAYOUT: tuple[tuple[int, str], ...] = (
    (0, "conv"), (1, "conv"), (2, "c2f"), (3, "conv"), (4, "c2f"),
    (5, "conv"), (6, "c2f"), (7, "conv"), (8, "c2f"), (9, "sppf"),
    (12, "c2f"), (15, "c2f"), (16, "conv"), (18, "c2f"), (19, "conv"),
    (21, "c2f"), (22, "detect"),
)


def _fold_conv_bn(state: Mapping[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    """torch Conv+BN(eval) → conv {weight, bias} with BN folded, in the
    JAX converter's float32 numpy arithmetic (so the weights are its bits)."""
    w = np.asarray(state[f"{prefix}.conv.weight"], np.float32)
    gamma = np.asarray(state[f"{prefix}.bn.weight"], np.float32)
    beta = np.asarray(state[f"{prefix}.bn.bias"], np.float32)
    mean = np.asarray(state[f"{prefix}.bn.running_mean"], np.float32)
    var = np.asarray(state[f"{prefix}.bn.running_var"], np.float32)
    scale = gamma / np.sqrt(var + BN_EPS)
    return {"weight": w * scale[:, None, None, None], "bias": beta - mean * scale}


def _plain_conv(state: Mapping[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    return {"weight": np.asarray(state[f"{prefix}.weight"], np.float32),
            "bias": np.asarray(state[f"{prefix}.bias"], np.float32)}


def _as_state(tree: Mapping[str, Any], prefix: str = "") -> dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_as_state(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.ascontiguousarray(v))
    return out


def convert_yolov8(state: Mapping[str, Any],
                   config: YoloConfig = YoloConfig()) -> dict[str, torch.Tensor]:
    """ultralytics DetectionModel state_dict (numpy arrays or tensors) → a
    ``state_dict`` of :class:`YOLOv8` ``(config)``.  Accepts keys with or
    without the ``model.`` prefix; a missing tensor raises ``KeyError`` so
    partial loads are never silent.  The fixed-arange ``dfl.conv.weight``
    is validated (``ValueError`` otherwise) and dropped (the decode
    computes the expectation directly)."""
    state = {(k[len("model."):] if k.startswith("model.") else k): v
             for k, v in state.items()}
    n3, n6 = config.n_rep(3), config.n_rep(6)
    tree: dict[str, Any] = {}
    for i, kind in _LAYOUT:
        if kind == "conv":
            tree[f"l{i}"] = {"conv": _fold_conv_bn(state, str(i))}
        elif kind in ("c2f", "sppf"):
            layer = {"cv1": {"conv": _fold_conv_bn(state, f"{i}.cv1")},
                     "cv2": {"conv": _fold_conv_bn(state, f"{i}.cv2")}}
            n = n3 if i in (2, 8, 12, 15, 18, 21) else n6
            for j in range(n if kind == "c2f" else 0):
                layer[f"m{j}"] = {
                    "cv1": {"conv": _fold_conv_bn(state, f"{i}.m.{j}.cv1")},
                    "cv2": {"conv": _fold_conv_bn(state, f"{i}.m.{j}.cv2")},
                }
            tree[f"l{i}"] = layer
        else:  # detect
            head: dict[str, Any] = {}
            for br in ("cv2", "cv3"):
                for s in range(3):
                    head[f"{br}_{s}_0"] = {"conv": _fold_conv_bn(state, f"{i}.{br}.{s}.0")}
                    head[f"{br}_{s}_1"] = {"conv": _fold_conv_bn(state, f"{i}.{br}.{s}.1")}
                    head[f"{br}_{s}_2"] = _plain_conv(state, f"{i}.{br}.{s}.2")
            dfl = np.asarray(state[f"{i}.dfl.conv.weight"], np.float32)
            if not np.allclose(dfl.reshape(-1), np.arange(REG_MAX, dtype=np.float32)):
                raise ValueError("unexpected DFL projection weights (not arange)")
            tree[f"l{i}"] = head
    return _as_state(tree)


def params_from_jax(params: Mapping[str, Any],
                    config: YoloConfig = YoloConfig()) -> dict[str, torch.Tensor]:
    """The JAX package's converted Flax parameters of ``YOLOv8(config)``
    (``{'params': tree}`` or the tree, as numpy arrays) → a ``state_dict``
    of the port's :class:`YOLOv8` ``(config)``: the same names, conv kernels
    from HWIO to OIHW.  Raises ``ValueError`` on a missing or unused tensor
    or a shape that differs."""
    tree = params.get("params", params)
    flat = {}
    for key, val in _as_state(tree).items():
        base, leaf = key.rsplit(".", 1)
        if leaf == "kernel":
            flat[f"{base}.weight"] = val.permute(3, 2, 0, 1).contiguous()
        else:
            flat[key] = val
    target = YOLOv8(config).state_dict()
    errors = [f"{k}: no Flax source" for k in target if k not in flat]
    errors += [f"{k}: unused Flax parameter" for k in flat if k not in target]
    errors += [f"{k}: shape {tuple(flat[k].shape)} != {tuple(v.shape)}"
               for k, v in target.items() if k in flat and flat[k].shape != v.shape]
    if errors:
        raise ValueError("YOLOv8 parameter conversion:\n" + "\n".join(errors))
    return flat


def _synth_conv_bn(rng, c_in, c_out, k) -> dict[str, np.ndarray]:
    return {
        "conv.weight": rng.normal(0, 0.05, (c_out, c_in, k, k)).astype(np.float32),
        "bn.weight": rng.uniform(0.5, 1.5, c_out).astype(np.float32),
        "bn.bias": rng.normal(0, 0.1, c_out).astype(np.float32),
        "bn.running_mean": rng.normal(0, 0.1, c_out).astype(np.float32),
        "bn.running_var": rng.uniform(0.5, 1.5, c_out).astype(np.float32),
        "bn.num_batches_tracked": np.asarray(0, np.int64),
    }


def synthetic_state_dict(config: YoloConfig = YoloConfig(),
                         seed: int = 0) -> dict[str, np.ndarray]:
    """Random state_dict (numpy) with the exact ultralytics key/shape
    schema — the weightless structural fixture.  The draws are the JAX
    fixture's, in its order, so one seed gives the same arrays."""
    rng = np.random.default_rng(seed)
    c1, c2, c3, c4, c5 = config.backbone_channels
    n3, n6 = config.n_rep(3), config.n_rep(6)
    nc = config.num_classes
    out: dict[str, np.ndarray] = {}

    def add(prefix: str, d: Mapping[str, np.ndarray]):
        for k, v in d.items():
            out[f"model.{prefix}.{k}"] = v

    def add_c2f(i: int, cin: int, cout: int, n: int):
        c = cout // 2
        add(f"{i}.cv1", _synth_conv_bn(rng, cin, 2 * c, 1))
        add(f"{i}.cv2", _synth_conv_bn(rng, (2 + n) * c, cout, 1))
        for j in range(n):
            add(f"{i}.m.{j}.cv1", _synth_conv_bn(rng, c, c, 3))
            add(f"{i}.m.{j}.cv2", _synth_conv_bn(rng, c, c, 3))

    add("0", _synth_conv_bn(rng, 3, c1, 3))
    add("1", _synth_conv_bn(rng, c1, c2, 3))
    add_c2f(2, c2, c2, n3)
    add("3", _synth_conv_bn(rng, c2, c3, 3))
    add_c2f(4, c3, c3, n6)
    add("5", _synth_conv_bn(rng, c3, c4, 3))
    add_c2f(6, c4, c4, n6)
    add("7", _synth_conv_bn(rng, c4, c5, 3))
    add_c2f(8, c5, c5, n3)
    add("9.cv1", _synth_conv_bn(rng, c5, c5 // 2, 1))
    add("9.cv2", _synth_conv_bn(rng, c5 * 2, c5, 1))
    add_c2f(12, c5 + c4, c4, n3)
    add_c2f(15, c4 + c3, c3, n3)
    add("16", _synth_conv_bn(rng, c3, c3, 3))
    add_c2f(18, c3 + c4, c4, n3)
    add("19", _synth_conv_bn(rng, c4, c4, 3))
    add_c2f(21, c4 + c5, c5, n3)
    cb = max(16, c3 // 4, REG_MAX * 4)
    cc = max(c3, min(nc, 100))
    for s, cin in enumerate((c3, c4, c5)):
        add(f"22.cv2.{s}.0", _synth_conv_bn(rng, cin, cb, 3))
        add(f"22.cv2.{s}.1", _synth_conv_bn(rng, cb, cb, 3))
        out[f"model.22.cv2.{s}.2.weight"] = rng.normal(
            0, 0.05, (4 * REG_MAX, cb, 1, 1)).astype(np.float32)
        out[f"model.22.cv2.{s}.2.bias"] = rng.normal(0, 0.1, 4 * REG_MAX).astype(np.float32)
        add(f"22.cv3.{s}.0", _synth_conv_bn(rng, cin, cc, 3))
        add(f"22.cv3.{s}.1", _synth_conv_bn(rng, cc, cc, 3))
        out[f"model.22.cv3.{s}.2.weight"] = rng.normal(
            0, 0.05, (nc, cc, 1, 1)).astype(np.float32)
        out[f"model.22.cv3.{s}.2.bias"] = rng.normal(0, 0.1, nc).astype(np.float32)
    out["model.22.dfl.conv.weight"] = np.arange(
        REG_MAX, dtype=np.float32).reshape(1, REG_MAX, 1, 1)
    return out


def pretrained_yolov8(path: str, config: YoloConfig = YoloConfig()
                      ) -> tuple[YOLOv8, dict[str, torch.Tensor]]:
    """(model with the weights loaded, its converted ``state_dict``) from an
    ultralytics ``.pt`` checkpoint's state dict, read on the CPU by
    :func:`nsof_tpu_torch.models.convert.load_torch_state_dict`."""
    from nsof_tpu_torch.models.convert import load_torch_state_dict

    state = convert_yolov8(load_torch_state_dict(path), config)
    model = YOLOv8(config)
    model.load_state_dict(state)
    return model, state
