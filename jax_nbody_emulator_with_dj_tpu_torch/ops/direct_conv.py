"""The direct packed 3x3x2 conv as shifted-slice matrix products: the plain
PyTorch version of the hand-written CUDA kernels B4 and B5.

Counterpart of the arithmetic inside ``jax_nbody_emulator_with_dj_tpu/ops/
pallas_conv.py`` (a resident window, all 18 packed taps) and ``ops/
stripe_conv.py`` (the same taps over an implicit channel concat of N parts):
a VALID 3x3x3 conv in the W-parity packed layout is 18 tap products
``x[kd:, kh:, ka:] @ wp[kd, kh, ka]`` per part, summed in float32, then the
bias, LeakyReLU(0.01) and one cast.  ``conv3_packed_taps`` repeats exactly
that and calls no convolution: the library's conv (``s2d.conv3_packed``) is
the yardstick the kernels are timed beside, not their reference.  The CUDA
kernels are ``csrc/direct_conv.cu`` (B4) and ``csrc/stripe_conv.cu`` (B5),
their wrappers in ``ops/direct_conv_cuda.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def as_parts(xps) -> tuple:
    """One packed tensor or a sequence of them -> a tuple of parts that share
    (B, D, H, WP), dtype and device."""
    xps = tuple(xps) if isinstance(xps, (tuple, list)) else (xps,)
    if not xps:
        raise ValueError("the conv needs at least one input part")
    first = xps[0]
    for x in xps:
        if x.dim() != 5 or x.shape[:4] != first.shape[:4]:
            raise ValueError(
                f"parts must be 5-D and share (B, D, H, WP): {[tuple(t.shape) for t in xps]}")
        if x.dtype != first.dtype or x.device != first.device:
            raise ValueError("parts must share one dtype and one device")
    return xps


def conv3_packed_taps(xps, wp, bias=None, *, leaky: bool = False, out_dtype=None):
    """VALID packed conv over the implicit channel concat of ``xps``.

    Args:
        xps: one packed tensor (B, D, H, WP, Ci) or a sequence of them.
        wp: (3, 3, 2, sum(Ci), Co) packed kernel (``s2d.pack_w3`` with the
            matching ``groups``): the parts' rows in order.
        bias: (Co,) packed float32 bias (``s2d.pack_bias``), or None.
        leaky: apply LeakyReLU(0.01) after the bias.
        out_dtype: output dtype (default: the parts' dtype).
    Returns (B, D-2, H-2, WP-1, Co).  The operands are rounded to the parts'
    dtype (as the kernels take them); products and sums run in float32.
    """
    xps = as_parts(xps)
    b, d, h, wpd, _ = xps[0].shape
    cins = [x.shape[-1] for x in xps]
    if tuple(wp.shape[:3]) != (3, 3, 2) or wp.shape[3] != sum(cins):
        raise ValueError(f"wp {tuple(wp.shape)} does not match parts with {cins} channels")
    if d < 3 or h < 3 or wpd < 2:
        raise ValueError(f"input {tuple(xps[0].shape)} is smaller than the 3x3x2 window")
    od, oh, ow = d - 2, h - 2, wpd - 1
    w32 = wp.to(xps[0].dtype).float()
    y = None
    row = 0
    for x, ci in zip(xps, cins):
        x32 = x.float()
        for kd in range(3):
            for kh in range(3):
                for ka in range(2):
                    lhs = x32[:, kd:kd + od, kh:kh + oh, ka:ka + ow]
                    z = torch.matmul(lhs, w32[kd, kh, ka, row:row + ci])
                    y = z if y is None else y.add_(z)
        row += ci
    if bias is not None:
        if bias.shape != (wp.shape[-1],):
            raise ValueError(f"bias {tuple(bias.shape)} is not the packed ({wp.shape[-1]},) vector")
        y = y + bias.float()
    if leaky:
        y = F.leaky_relu(y, 0.01)
    return y.to(out_dtype or xps[0].dtype)
