"""3D convolution primitives on torch tensors, JAX package layouts.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/ops/conv3d.py``.  Activations
keep the JAX package's channels-last ``(B, D, H, W, C)`` layout (or NCDHW at
the few-channel boundaries) and kernels its ``(K, K, K, Cin, Cout)`` (DHWIO)
layout, so the tests compare like with like.  ``torch.nn.functional.conv3d``
wants NCDHW activations and OIDHW kernels: a channels-last tensor permuted to
NCDHW is torch's ``channels_last_3d`` memory format, so the permutes below are
views, not copies.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def to_ncdhw(x, fmt: str):
    """View a 5-D activation in ``fmt`` as NCDHW."""
    return x if fmt == "NCDHW" else x.permute(0, 4, 1, 2, 3)


def from_ncdhw(y, fmt: str):
    """View an NCDHW result in ``fmt``."""
    return y if fmt == "NCDHW" else y.permute(0, 2, 3, 4, 1)


def dhwio_to_oidhw(w):
    """(K, K, K, Ci, Co) -> (Co, Ci, K, K, K), contiguous."""
    return w.permute(4, 3, 0, 1, 2).contiguous()


def conv3d(x, w, *, in_fmt: str = "NDHWC", out_fmt: str = "NDHWC"):
    """VALID 3D convolution.  ``w`` is a DHWIO kernel, cast to ``x.dtype``."""
    y = F.conv3d(to_ncdhw(x, in_fmt), dhwio_to_oidhw(w.to(x.dtype)))
    return from_ncdhw(y, out_fmt)


def conv1x1(x, w, *, in_fmt: str = "NDHWC", out_fmt: str = "NDHWC"):
    """1x1x1 convolution as a channel matmul; ``w`` is (1,1,1,Ci,Co) or (Ci,Co)."""
    w2 = w.reshape(w.shape[-2], w.shape[-1]).to(x.dtype)
    if in_fmt == "NCDHW":
        x = from_ncdhw(x, "NDHWC")
    y = torch.matmul(x, w2)
    return to_ncdhw(y, "NDHWC") if out_fmt == "NCDHW" else y


def conv_down2(x, w):
    """Stride-2 kernel-2 conv as space-to-depth + matmul (channels-last).

    y[d,h,w] = sum_{r,s,t} W[r,s,t] . x[2d+r, 2h+s, 2w+t].
    """
    b, d, h, wd, c = x.shape
    xr = x.reshape(b, d // 2, 2, h // 2, 2, wd // 2, 2, c)
    xr = xr.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, d // 2, h // 2, wd // 2, 8 * c)
    return torch.matmul(xr, w.reshape(8 * c, w.shape[-1]).to(x.dtype))


def conv_up2(x, w):
    """2x upsampling (lhs-dilated kernel-2, padding 1) conv as matmul + depth-to-space.

    Every output voxel y[2i+r, 2j+s, 2k+t] sees one input voxel:
    y = W[1-r, 1-s, 1-t] . x[i, j, k].  torch has no negative strides, so the
    kernel flip is a ``torch.flip``.
    """
    b, d, h, wd, c = x.shape
    co = w.shape[-1]
    w2 = torch.flip(w, (0, 1, 2)).permute(3, 0, 1, 2, 4).reshape(c, 8 * co).to(x.dtype)
    y = torch.matmul(x, w2).reshape(b, d, h, wd, 2, 2, 2, co)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7)  # (B, D,2, H,2, W,2, Co)
    return y.reshape(b, 2 * d, 2 * h, 2 * wd, co)


def leaky_relu(x, negative_slope: float = 0.01):
    """LeakyReLU with the reference's 0.01 slope."""
    return F.leaky_relu(x, negative_slope)


def leaky_relu_with_tangent(x, dx, negative_slope: float = 0.01):
    """LeakyReLU on a (primal, tangent) pair: dy = dx where x > 0, else
    slope * dx, with the slope rounded to x's dtype (as the JAX package
    rounds it, which matters in bf16)."""
    slope = torch.tensor(negative_slope, dtype=x.dtype)
    pos = x > 0
    return (torch.where(pos, x, x * slope.item()),
            torch.where(pos, dx, dx * slope.to(dx.dtype).item()))
