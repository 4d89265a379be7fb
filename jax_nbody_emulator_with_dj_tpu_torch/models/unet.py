"""Valid-conv 3D U-Net: block plan, seeded init and the primal forward.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/models/unet.py``.  Topology
(levels=3 is the reference architecture):

    conv_l00 (CACA, in->mid) -> conv_l01 (CACA) -> down_l0 (DA)
    [conv_l{i} (CACA) -> down_l{i} (DA)]  for i in 1..levels-1
    conv_c (CACA)
    [up_r{i} (UA) -> concat(skip_i) -> conv_r{i} (CACA, 2mid->mid)]  i=levels-1..1
    up_r0 (UA) -> concat(skip_0) -> conv_r00 (CACA, 2mid->mid) -> conv_r01 (CAC, mid->out)

Parameters are ``{'params': {block_name: {layer_name: {...}}}}`` with the
JAX package's names and DHWIO kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .blocks import (
    _center_crop,
    apply_resample_block,
    apply_resample_block_vel,
    apply_resnet_block,
    apply_resnet_block_vel,
    init_resample_block,
    init_resnet_block,
)


def input_margin(levels: int = 3) -> int:
    """Receptive-field margin per side: output = input - 2*margin."""
    return 12 * 2 ** (levels - 1)


def _encoder_sizes(n: int, levels: int):
    """Spatial sizes along the encoder; raises on invalid sizes."""
    sizes = []
    h = n - 8  # conv_l00 + conv_l01 (CACA each: -4)
    if h <= 0:
        raise ValueError(f"input size {n} too small")
    sizes.append(h)  # skip 0
    for i in range(levels):
        if h % 2:
            raise ValueError(f"input size {n}: size {h} not divisible by 2 at down_l{i}")
        h //= 2
        if i < levels - 1:
            h -= 4  # conv_l{i+1}
            if h <= 0:
                raise ValueError(f"input size {n} too small at level {i + 1}")
            sizes.append(h)
    return sizes, h


def output_size(n: int, levels: int = 3) -> int:
    """Output spatial size for input size ``n`` (raises if ``n`` is invalid)."""
    skips, h = _encoder_sizes(n, levels)
    h -= 4  # bottleneck
    if h <= 0:
        raise ValueError(f"input size {n} too small at bottleneck")
    for i in range(levels - 1, 0, -1):
        h = 2 * h  # up
        if h > skips[i]:
            raise ValueError(f"input size {n}: skip {i} smaller than upsampled path")
        h -= 4  # conv_r{i}
    h = 2 * h
    if h > skips[0]:
        raise ValueError(f"input size {n}: skip 0 smaller than upsampled path")
    h -= 8  # conv_r00 + conv_r01
    if h <= 0:
        raise ValueError(f"input size {n} too small at head")
    return h


def valid_input_size(n: int, levels: int = 3) -> bool:
    try:
        return output_size(n, levels) > 0
    except ValueError:
        return False


def unet_block_plan(levels: int = 3, in_chan: int = 3, out_chan: int = 3, mid_chan: int = 64):
    """Ordered (name, block_type, seq, cin, cout) plan."""
    mid2 = 2 * mid_chan
    plan = [
        ("conv_l00", "resnet", "CACA", in_chan, mid_chan),
        ("conv_l01", "resnet", "CACA", mid_chan, mid_chan),
        ("down_l0", "resample", "DA", mid_chan, mid_chan),
    ]
    for i in range(1, levels):
        plan.append((f"conv_l{i}", "resnet", "CACA", mid_chan, mid_chan))
        plan.append((f"down_l{i}", "resample", "DA", mid_chan, mid_chan))
    plan.append(("conv_c", "resnet", "CACA", mid_chan, mid_chan))
    for i in range(levels - 1, 0, -1):
        plan.append((f"up_r{i}", "resample", "UA", mid_chan, mid_chan))
        plan.append((f"conv_r{i}", "resnet", "CACA", mid2, mid_chan))
    plan.append(("up_r0", "resample", "UA", mid_chan, mid_chan))
    plan.append(("conv_r00", "resnet", "CACA", mid2, mid_chan))
    plan.append(("conv_r01", "resnet", "CAC", mid_chan, out_chan))
    return plan


def init_unet(seed: int, *, levels=3, in_chan=3, out_chan=3, mid_chan=64,
              style: bool, vel: bool = False, style_size: int = 2):
    """Seeded random float32 parameter tree (lecun-normal kernels, zero biases;
    ``style`` adds the style weights, ``vel`` without ``style`` a learned
    tangent kernel ``dweight`` per layer)."""
    rng = np.random.default_rng(seed)
    params = {}
    for name, btype, seq, cin, cout in unet_block_plan(levels, in_chan, out_chan, mid_chan):
        init = init_resnet_block if btype == "resnet" else init_resample_block
        params[name] = init(rng, seq, cin, cout, style=style, vel=vel, style_size=style_size)
    return {"params": params}


def unet_forward(params, x, *, s=None, levels: int = 3, eps: float = 1e-8, io_fmt: str = "NCDHW"):
    """U-Net forward on an input-scaled 5-D tensor in ``io_fmt``: premodulated,
    or styled by the batch's style vectors ``s`` (B, S) when given."""
    p = params["params"]
    kw = dict(s=s, eps=eps)
    h = apply_resnet_block(p["conv_l00"], x, "CACA", in_fmt=io_fmt, **kw)
    h = apply_resnet_block(p["conv_l01"], h, "CACA", **kw)
    skips = [h]
    h = apply_resample_block(p["down_l0"], h, "DA", **kw)
    for i in range(1, levels):
        y = apply_resnet_block(p[f"conv_l{i}"], h, "CACA", **kw)
        skips.append(y)
        h = apply_resample_block(p[f"down_l{i}"], y, "DA", **kw)
    h = apply_resnet_block(p["conv_c"], h, "CACA", **kw)
    for i in range(levels - 1, 0, -1):
        h = apply_resample_block(p[f"up_r{i}"], h, "UA", **kw)
        h = torch.cat([_center_crop(skips[i], h.shape[1:4]), h], dim=-1)
        h = apply_resnet_block(p[f"conv_r{i}"], h, "CACA", **kw)
    h = apply_resample_block(p["up_r0"], h, "UA", **kw)
    h = torch.cat([_center_crop(skips[0], h.shape[1:4]), h], dim=-1)
    h = apply_resnet_block(p["conv_r00"], h, "CACA", **kw)
    return apply_resnet_block(p["conv_r01"], h, "CAC", out_fmt=io_fmt, **kw)


def unet_forward_vel(params, x, *, levels: int = 3, io_fmt: str = "NCDHW"):
    """Premodulated-vel U-Net forward: threads (x, dx) through the baked dweights.

    The tangent enters as ``dx=None`` at conv_l00, whose folded dweight
    carries the first-layer w/Dz rule.  Returns ``(h, dh)`` in ``io_fmt``.
    """
    p = params["params"]

    def cat(skip, h):
        y, dy = (_center_crop(t, h[0].shape[1:4]) for t in skip)
        return torch.cat([y, h[0]], dim=-1), torch.cat([dy, h[1]], dim=-1)

    h = apply_resnet_block_vel(p["conv_l00"], x, None, "CACA", in_fmt=io_fmt)
    h = apply_resnet_block_vel(p["conv_l01"], *h, "CACA")
    skips = [h]
    h = apply_resample_block_vel(p["down_l0"], *h, "DA")
    for i in range(1, levels):
        y = apply_resnet_block_vel(p[f"conv_l{i}"], *h, "CACA")
        skips.append(y)
        h = apply_resample_block_vel(p[f"down_l{i}"], *y, "DA")
    h = apply_resnet_block_vel(p["conv_c"], *h, "CACA")
    for i in range(levels - 1, 0, -1):
        h = apply_resample_block_vel(p[f"up_r{i}"], *h, "UA")
        h = apply_resnet_block_vel(p[f"conv_r{i}"], *cat(skips[i], h), "CACA")
    h = apply_resample_block_vel(p["up_r0"], *h, "UA")
    h = apply_resnet_block_vel(p["conv_r00"], *cat(skips[0], h), "CACA")
    return apply_resnet_block_vel(p["conv_r01"], *h, "CAC", out_fmt=io_fmt)
