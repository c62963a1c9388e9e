"""``jax.image.resize`` as matrix products: JAX's resize weights, shared by
the port.

JAX resizes by contracting each resized axis with a weight matrix built by
``compute_weight_mat`` (jax/_src/image/scale.py:54-84): half-pixel sample
positions, the kernel widened by the scale when shrinking (antialiasing,
``jax.image.resize``'s default), each output's weights normalised to sum to
one, and outputs whose sample lies outside the input zeroed.
``F.interpolate`` differs from it: without antialiasing a shrink skips
input pixels, and its bicubic kernel has a = −0.75 where JAX's Keys cubic
has a = −0.5.  So the port builds JAX's matrices and applies them as
float32 matrix products in full float32 (no TF32):

- ``'lanczos3'``: the device simulation's downsampling
  (:func:`nsof_tpu_torch.device.frame_sim.compress_frames`);
- ``'linear'`` (the triangle): SAM's ``postprocess`` and its resized
  relative-position tables;
- ``'cubic'`` (Keys, a = −0.5): SAM's position embedding at another input
  size.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch

__all__ = ["KERNELS", "weight_mat", "full_f32_matmul", "resize_axis", "resize"]


def _lanczos3(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``_fill_lanczos_kernel(3., x)``."""
    radius = 3.0
    y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
    den = torch.where(x != 0, math.pi**2 * (x * x), 1.0)
    out = torch.where(x > 1e-3, y / den, 1.0)
    return torch.where(x > radius, 0.0, out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``_fill_triangle_kernel``."""
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """JAX's ``_fill_keys_cubic_kernel``: Keys' cubic with a = −0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


KERNELS = {"lanczos3": _lanczos3, "linear": _triangle, "cubic": _keys_cubic}


@functools.lru_cache(maxsize=64)
def weight_mat(in_size: int, out_size: int, kernel: str, device: str,
               fused: bool = True) -> torch.Tensor:
    """``[in_size, out_size]`` float32 weights of an antialiased resize
    with ``kernel`` (a key of :data:`KERNELS`): JAX's
    ``compute_weight_mat`` with scale out/in and no translation.  With
    ``fused`` each sample position ``(i + 0.5) · inv_scale − 0.5`` is
    rounded once, as XLA fuses the product and the difference under
    ``jax.image.resize``'s jit (the weights then equal JAX's; rounded twice
    they were up to 3.8e-6 apart at 96 → 200); without it, twice, the form
    :func:`~nsof_tpu_torch.device.frame_sim.compress_frames` keeps.  Built
    once per size, kernel and device (the upload is the only host
    synchronisation)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = torch.float32
    pos = torch.arange(out_size, dtype=f32) + 0.5
    if fused:  # the float64 product of two float32 values is exact
        sample_f = (pos.double() * float(torch.tensor(inv_scale, dtype=f32)) - 0.5).to(f32)
    else:
        sample_f = pos * inv_scale - 0.0 - 0.5
    x = torch.abs(sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None])
    weights = KERNELS[kernel](x / torch.tensor(kernel_scale, dtype=f32))
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(
        torch.abs(total) > 1000.0 * float(torch.finfo(f32).eps),
        weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0).to(device)


@contextlib.contextmanager
def full_f32_matmul():
    """Float32 matrix products in full float32 (no TF32) inside."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def resize_axis(x: torch.Tensor, dim: int, size: int, kernel: str) -> torch.Tensor:
    """``x`` float32 resized along ``dim`` to ``size`` with ``kernel``, as
    ``jax.image.resize`` resizes one axis; an axis whose size does not
    change is returned as it is."""
    n = x.shape[dim]
    if n == size:
        return x
    w = weight_mat(n, size, kernel, str(x.device))
    with full_f32_matmul():
        return torch.movedim(torch.matmul(torch.movedim(x, dim, -1), w), -1, dim)


def resize(x: torch.Tensor, hw: tuple[int, int], kernel: str) -> torch.Tensor:
    """``[..., H, W]`` float32 resized to ``[..., h, w]`` with ``kernel``:
    ``jax.image.resize`` of the last two axes, rows first."""
    h, w = hw
    if x.shape[-2] != h:
        with full_f32_matmul():
            x = torch.matmul(weight_mat(x.shape[-2], h, kernel, str(x.device)).T, x)
    return resize_axis(x, -1, w, kernel)
