"""ResNet / Resample blocks over plain dicts of torch tensors.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/models/blocks.py``.  A ResNet
block ``'CACA'`` runs a 1x1 skip conv cropped by ``num_conv`` voxels per side
to match the VALID-conv shrinkage of the main path (conv3 -> act -> conv3 ->
[residual add] -> act); a Resample block is ``'DA'`` (stride-2 down conv) or
``'UA'`` (2x up conv).  Parameters are nested dicts with the JAX package's
keys and DHWIO kernels: ``{'skip': {...}, 'conv_0': {...}, 'conv_1': {...}}``.

Styled layers (``style_weight``, ``style_bias``) take the batch's style
vectors ``s`` (B, S) and run ``conv(x * m, W) / n + b``: one batch-shared
conv between the per-channel scales of ``ops/style.py::style_modulation``.
Velocity ("premod-vel") layers carry a baked tangent kernel ``dweight`` and
thread a (primal, tangent) pair: ``y = conv(x, W) + b``, ``dy = conv(x, dW) +
conv(dx, W)``.

The second half holds the packed (space-to-depth) forms the hierarchical
runtime runs, with premodulated weights packed once per processor build (per
box for a style model, whose style is folded at the box's cosmology first).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import s2d
from ..ops.conv3d import (
    conv1x1,
    conv3d,
    conv3d_up,
    conv_down2,
    conv_up2,
    leaky_relu,
    leaky_relu_with_tangent,
)
from ..ops.style import recover_dweight_factors, style_modulation
from ..ops.winograd import transform_packed_w3
from ..ops.winograd_cuda import conv3d_wino_packed, conv3d_wino_pair_packed, tile_wh

_KSIZE = {"conv": 3, "skip": 1, "down": 2, "up": 2}  # 'C', skip, 'D', 'U'


def _run_conv(x, w, kind, in_fmt="NDHWC", out_fmt="NDHWC"):
    """One conv of ``kind``.  The resample convs take their matmul forms
    (``conv_up2``, ``conv_down2``) when both formats are channels-last, and
    the conv forms (``conv3d_up``, a stride-2 ``conv3d``) otherwise."""
    channels_last = in_fmt == out_fmt == "NDHWC"
    if kind == "skip":
        return conv1x1(x, w, in_fmt=in_fmt, out_fmt=out_fmt)
    if kind == "up":
        return conv_up2(x, w) if channels_last else conv3d_up(x, w, in_fmt=in_fmt, out_fmt=out_fmt)
    if kind == "down":
        if channels_last:
            return conv_down2(x, w)
        return conv3d(x, w, stride=2, in_fmt=in_fmt, out_fmt=out_fmt)
    return conv3d(x, w, in_fmt=in_fmt, out_fmt=out_fmt)


# ---------------------------------------------------------------------------
# Init (seeded numpy; lecun-normal weights, as the JAX package)
# ---------------------------------------------------------------------------


def init_conv_layer(rng, cin, cout, kind, *, style: bool, vel: bool = False,
                    style_size: int = 2):
    """Random init of one conv layer's float32 params from a numpy Generator;
    ``vel`` without ``style`` adds a learned tangent kernel ``dweight``."""
    ksz = _KSIZE[kind]
    std = math.sqrt(1.0 / (cin * ksz**3))
    shape = (ksz, ksz, ksz, cin, cout)
    p = {
        "weight": torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32)),
        "bias": torch.zeros(cout),
    }
    if style:
        p["style_weight"] = torch.from_numpy(
            (rng.standard_normal((cin, style_size)) * math.sqrt(1.0 / style_size)).astype(np.float32)
        )
        p["style_bias"] = torch.ones(cin)
    elif vel:
        p["dweight"] = torch.from_numpy((rng.standard_normal(shape) * std).astype(np.float32))
    return p


def _resnet_channel_plan(seq, cin, cout):
    """Per-conv (cin, cout) plan for a ResNet main path."""
    main_seq = seq[:-1] if seq.endswith("A") else seq
    num_conv = main_seq.count("C")
    mid = max(cin, cout)
    plan = []
    for i in range(num_conv):
        ci = cin if i == 0 else mid
        co = cout if i == num_conv - 1 else mid
        plan.append((ci, co))
    return main_seq, num_conv, plan


def init_resnet_block(rng, seq, cin, cout, *, style: bool, vel: bool = False,
                      style_size: int = 2):
    _, _, plan = _resnet_channel_plan(seq, cin, cout)
    kw = dict(style=style, vel=vel, style_size=style_size)
    params = {"skip": init_conv_layer(rng, cin, cout, "skip", **kw)}
    for i, (ci, co) in enumerate(plan):
        params[f"conv_{i}"] = init_conv_layer(rng, ci, co, "conv", **kw)
    return params


def init_resample_block(rng, seq, cin, cout, *, style: bool, vel: bool = False,
                        style_size: int = 2):
    kind = "down" if "D" in seq else "up"
    return {"conv_0": init_conv_layer(rng, cin, cout, kind, style=style, vel=vel,
                                      style_size=style_size)}


# ---------------------------------------------------------------------------
# Unpacked apply
# ---------------------------------------------------------------------------


def _bcast_channels(v, fmt: str):
    """(C,) or (B, C) -> broadcastable against a 5-D tensor in ``fmt``."""
    if fmt == "NCDHW":
        return v[..., None, None, None]
    return v if v.dim() == 1 else v[:, None, None, None, :]


def apply_conv_layer(p, x, kind, *, s=None, eps: float = 1e-8, in_fmt="NDHWC", out_fmt="NDHWC"):
    """One conv layer (+ float32 bias), in ``x``'s dtype; styled iff ``s``
    (B, S) is given: ``conv(x * m, W) / n + b``, with one batch-shared conv."""
    bias = _bcast_channels(p["bias"].float(), out_fmt)
    if s is None:
        return (_run_conv(x, p["weight"], kind, in_fmt, out_fmt) + bias).to(x.dtype)
    m, norm = style_modulation(p, s, eps)  # (B, Ci), (B, Co) float32
    z = _run_conv(x * _bcast_channels(m, in_fmt).to(x.dtype), p["weight"], kind, in_fmt, out_fmt)
    return (z / _bcast_channels(norm, out_fmt) + bias).to(x.dtype)


def apply_conv_layer_vel(p, x, dx, kind, *, in_fmt="NDHWC", out_fmt="NDHWC"):
    """Premod-vel conv layer: ``(y, dy)`` from the baked ``weight``/``dweight``.

    dy = conv(x, dW) + conv(dx, W), as one conv over the channel concat of
    (x, dx).  ``dx=None`` marks the model's first layers, whose folded dW
    carries the w/Dz rule: then dy = conv(x, dW).
    """
    bias = p["bias"].float()
    bias = bias[:, None, None, None] if out_fmt == "NCDHW" else bias
    w, dw = p["weight"], p["dweight"]
    y = _run_conv(x, w, kind, in_fmt, out_fmt) + bias
    if dx is None:
        dy = _run_conv(x, dw, kind, in_fmt, out_fmt)
    else:
        xx = torch.cat([x, dx], dim=1 if in_fmt == "NCDHW" else 4)
        dy = _run_conv(xx, torch.cat([dw, w], dim=3), kind, in_fmt, out_fmt)
    return y.to(x.dtype), dy.to(x.dtype)


def _spatial_axes(fmt: str):
    return (2, 3, 4) if fmt == "NCDHW" else (1, 2, 3)


def _center_crop(t, spatial, fmt: str = "NDHWC"):
    """Symmetric center crop of the spatial dims to the given size."""
    slices = [slice(None)] * 5
    for ax, target in zip(_spatial_axes(fmt), spatial):
        dim = t.shape[ax]
        c = dim - target
        if c < 0 or c % 2:
            raise ValueError(f"cannot center-crop {tuple(t.shape)} to {tuple(spatial)}")
        if c:
            slices[ax] = slice(c // 2, dim - c // 2)
    return t[tuple(slices)]


def apply_resnet_block(p, x, seq, *, s=None, eps: float = 1e-8, in_fmt="NDHWC",
                       out_fmt="NDHWC"):
    """Primal ResNet block (styled iff ``s`` is given); the first conv (and
    skip) read ``in_fmt``, the last conv (and skip) write ``out_fmt``,
    interior activations are channels-last."""
    main_seq, num_conv, _ = _resnet_channel_plan(seq, 0, 0)
    last_act = seq.endswith("A") and main_seq != seq
    y = apply_conv_layer(p["skip"], x, "skip", s=s, eps=eps, in_fmt=in_fmt, out_fmt=out_fmt)
    if num_conv > 0:
        target = tuple(y.shape[ax] - 2 * num_conv for ax in _spatial_axes(out_fmt))
        y = _center_crop(y, target, out_fmt)
    conv_idx = 0
    for op in main_seq:
        if op == "C":
            fi = in_fmt if conv_idx == 0 else "NDHWC"
            fo = out_fmt if conv_idx == num_conv - 1 else "NDHWC"
            x = apply_conv_layer(p[f"conv_{conv_idx}"], x, "conv", s=s, eps=eps, in_fmt=fi,
                                 out_fmt=fo)
            conv_idx += 1
        elif op == "A":
            x = leaky_relu(x)
        else:
            raise ValueError(f"layer type {op!r} not supported (use C or A)")
    x = x + y
    if last_act:
        x = leaky_relu(x)
    return x


def apply_resnet_block_vel(p, x, dx, seq, *, in_fmt="NDHWC", out_fmt="NDHWC"):
    """Premod-vel ResNet block threading (x, dx); ``dx=None`` marks the
    model's first block."""
    main_seq, num_conv, _ = _resnet_channel_plan(seq, 0, 0)
    last_act = seq.endswith("A") and main_seq != seq
    y, dy = apply_conv_layer_vel(p["skip"], x, dx, "skip", in_fmt=in_fmt, out_fmt=out_fmt)
    if num_conv > 0:
        target = tuple(y.shape[ax] - 2 * num_conv for ax in _spatial_axes(out_fmt))
        y, dy = _center_crop(y, target, out_fmt), _center_crop(dy, target, out_fmt)
    conv_idx = 0
    for op in main_seq:
        if op == "C":
            fi = in_fmt if conv_idx == 0 else "NDHWC"
            fo = out_fmt if conv_idx == num_conv - 1 else "NDHWC"
            x, dx = apply_conv_layer_vel(p[f"conv_{conv_idx}"], x, dx, "conv", in_fmt=fi, out_fmt=fo)
            conv_idx += 1
        elif op == "A":
            x, dx = leaky_relu_with_tangent(x, dx)
        else:
            raise ValueError(f"layer type {op!r} not supported (use C or A)")
    x, dx = x + y, dx + dy
    if last_act:
        x, dx = leaky_relu_with_tangent(x, dx)
    return x, dx


def apply_resample_block(p, x, seq, *, s=None, eps: float = 1e-8):
    """Primal resample block: 'DA' (down) or 'UA' (up); channels-last."""
    conv_idx = 0
    for op in seq:
        if op in ("D", "U"):
            kind = "down" if op == "D" else "up"
            x = apply_conv_layer(p[f"conv_{conv_idx}"], x, kind, s=s, eps=eps)
            conv_idx += 1
        elif op == "A":
            x = leaky_relu(x)
        else:
            raise ValueError(f"layer type {op!r} not supported")
    return x


def apply_resample_block_vel(p, x, dx, seq):
    """Premod-vel resample block: 'DA' or 'UA'; channels-last."""
    conv_idx = 0
    for op in seq:
        if op in ("D", "U"):
            kind = "down" if op == "D" else "up"
            x, dx = apply_conv_layer_vel(p[f"conv_{conv_idx}"], x, dx, kind)
            conv_idx += 1
        elif op == "A":
            x, dx = leaky_relu_with_tangent(x, dx)
        else:
            raise ValueError(f"layer type {op!r} not supported")
    return x, dx


# ---------------------------------------------------------------------------
# Space-to-depth packed execution (premodulated 64-channel interior)
#
# Activations stay W-packed ((B, D, H, W/2, 2C), ops/s2d.py) across whole
# phases.  Weights are packed ONCE per processor build, already in the
# compute dtype and on the device: 3x3x3 kernels in torch's OIDHW layout,
# Winograd kernels ("wh") in bf16, re-tiled into the pieces kernels B1 and B2
# read (ops/winograd_cuda.py::tile_wh), and the per-part weights of the
# decoder's concat inputs split into contiguous tensors.  Velocity layers run
# the FACTORED tangent where the dweight has the rank structure of a style
# fold, dW = W (.) g_in - W (.) c_out: dy = op(x (.) g + dx, W) - c (.) op(x, W),
# one conv sharing the primal kernel (kernel B2 at the Winograd sites).  A
# learned dweight (no such structure) runs the MATERIALIZED tangent,
# dy = op(x, dW) + op(dx, W), as a sum over the parts of the concat (x, dx)
# (kernel B1 for each part at the Winograd sites).
# ---------------------------------------------------------------------------

_PACKERS = {
    "conv": s2d.pack_w3,
    "skip": s2d.pack_w1,
    "down": s2d.pack_w_down,
    "up": s2d.pack_w_up,
}

_PACKED_OPS = {
    "conv": s2d.conv3_packed,
    "skip": s2d.conv1_packed,
    "down": s2d.down_packed,
    "up": s2d.up_packed,
}


def _wino_eligible(kind: str, wp) -> bool:
    """3x3x3 conv sites whose packed operands are >= 128 channels wide on
    both sides; narrow outputs (the model's 64->3 tail) keep the direct conv."""
    return kind == "conv" and wp.shape[-1] >= 128 and wp.shape[-2] >= 128


def _cat_weight_parts(w, kind, n):
    """Split a groups=n packed weight (JAX layout) into per-part operands.

    'down' weights fold the 8 spatial taps outside the channel rows, so the
    split goes through a (8, channels, Co) view.
    """
    if kind == "down":
        co = w.shape[-1]
        w3 = w.reshape(8, -1, co)
        rows = w3.shape[1] // n
        return [w3[:, i * rows:(i + 1) * rows].reshape(-1, co) for i in range(n)]
    rows = w.shape[-2] // n
    return [w[..., i * rows:(i + 1) * rows, :] for i in range(n)]


def pack_conv_layer_params(p, kind, *, groups: int = 1, vel: bool = False,
                           wino: bool = False, dtype=torch.float32, device=None):
    """Pre-pack one premodulated conv layer for packed execution.

    Returns ``{"w", "b"}`` (plus ``"wh"`` for Winograd-eligible convs when
    ``wino``: the transformed weights re-tiled into the kernels' pieces,
    ``ops/winograd_cuda.py::TiledWh``); with ``groups > 1`` the weights are
    the list of per-part operands of the implicit concat input instead.
    With ``vel``, the tangent: where ``dweight`` has the style fold's rank
    structure, its factors ``"g"`` unpacked (Ci,) and ``"c"`` packed (2Co,),
    float32, from the fold's ``dfac_in``/``dfac_out`` or recovered from
    ``dweight``; else (a learned ``dweight``) ``"wcat"``, the per-part
    operands of concat(dW, W) packed with twice the groups (``"whcat"`` their
    Winograd pieces where ``"wh"`` exists), and for a narrow output (packed
    Cols < 128, not 'up', groups 1) ``"wst"``, the primal and x-tangent
    kernels stacked along Cols so that one conv yields y and op(x, dW).
    """
    packer = _PACKERS[kind]
    wp = packer(p["weight"].float(), groups)
    parts = _cat_weight_parts(wp, kind, groups)

    def dev(t, dt):
        return t.to(device=device, dtype=dt).contiguous()

    def conv_layout(t):
        return s2d.oidhw_w3(t) if kind == "conv" else t

    w = [dev(conv_layout(t), dtype) for t in parts]
    out = {
        "w": w[0] if groups == 1 else w,
        "b": dev(s2d.pack_bias(p["bias"].float()), torch.float32),
    }
    if wino and _wino_eligible(kind, wp):
        wh = [tile_wh(dev(t, torch.bfloat16))
              for t in _cat_weight_parts(transform_packed_w3(wp), kind, groups)]
        out["wh"] = wh[0] if groups == 1 else wh
    if not vel:
        return out
    fac = _tangent_factors(p)
    if fac is not None:
        out["g"] = dev(fac[0], torch.float32)
        out["c"] = dev(s2d.pack_bias(fac[1]), torch.float32)
        return out
    # dy = op(cat(x, dx), cat(dW, W)): the packed input is the channel concat of
    # two packed tensors per part, so the concat weight packs with twice the groups.
    wcat = packer(torch.cat([p["dweight"].float(), p["weight"].float()], dim=-2), 2 * groups)
    out["wcat"] = [dev(conv_layout(t), dtype) for t in _cat_weight_parts(wcat, kind, 2 * groups)]
    if "wh" in out:
        # the tap transform commutes with the row split: split its result the same way
        out["whcat"] = [tile_wh(dev(t, torch.bfloat16))
                        for t in _cat_weight_parts(transform_packed_w3(wcat), kind, 2 * groups)]
    if kind != "up" and groups == 1 and wp.shape[-1] < 128:
        # narrow outputs (the model's 64->3 tail): one conv for y and op(x, dW)
        # ('up' Cols encode the (r, s, a, p) reshuffle and cannot be stacked)
        wst = torch.cat([wp, packer(p["dweight"].float(), groups)], -1)
        out["wst"] = dev(conv_layout(wst), dtype)
    return out


def _tangent_factors(p):
    """float32 (g (Ci,), c (Co,)) with dweight = weight (.) g - weight (.) c, or
    None where dweight has no such structure (a learned tangent kernel)."""
    if "dfac_in" in p:
        return p["dfac_in"].float(), p["dfac_out"].float()
    g, c, ok = recover_dweight_factors(p["weight"], p["dweight"])
    if not ok:
        return None
    return torch.from_numpy(g).float(), torch.from_numpy(c).float()


def pack_resnet_params(p, seq, *, groups: int = 1, vel: bool = False, wino: bool = False,
                       dtype=torch.float32, device=None):
    _, num_conv, _ = _resnet_channel_plan(seq, 0, 0)
    kw = dict(vel=vel, dtype=dtype, device=device)
    out = {"skip": pack_conv_layer_params(p["skip"], "skip", groups=groups, **kw)}
    for i in range(num_conv):
        out[f"conv_{i}"] = pack_conv_layer_params(
            p[f"conv_{i}"], "conv", groups=groups if i == 0 else 1, wino=wino, **kw
        )
    return out


def pack_resample_params(p, seq, *, vel: bool = False, dtype=torch.float32, device=None):
    kind = "down" if "D" in seq else "up"
    return {"conv_0": pack_conv_layer_params(p["conv_0"], kind, vel=vel, dtype=dtype,
                                             device=device)}


def _wino_dtypes(dtype):
    """The JAX package's dtype contract for the Winograd kernels, as
    ``(out_dtype, cast_back)``: float32 input runs on bf16 operands with
    float32 output; any other non-bf16 input goes through bf16 and its bf16
    output is cast back."""
    if dtype == torch.float32:
        return torch.float32, None
    return None, (None if dtype == torch.bfloat16 else dtype)


def _wino_conv(xp, wh, bias=None, leaky=False):
    """Kernel B1 under the dtype contract of ``_wino_dtypes``."""
    out_dtype, cast_back = _wino_dtypes(xp.dtype)
    y = conv3d_wino_packed(xp.to(torch.bfloat16), wh, bias, leaky=leaky, out_dtype=out_dtype)
    return y.to(cast_back) if cast_back is not None else y


def _wino_conv_pair(xp, sp, wh, bias, cvec, act):
    """Factored-tangent pair: y = conv(xp, W) + b, dy = conv(sp, W) - c (.)
    conv(xp, W), the LeakyReLU pair when ``act``: kernel B2 at every packed-W
    width (the JAX package runs two single kernels above a width of 96; here
    the pair's cost does not depend on the width, and the c-fold always sees
    the float32 accumulators)."""
    out_dtype, cast_back = _wino_dtypes(xp.dtype)
    y, dy = conv3d_wino_pair_packed(xp.to(torch.bfloat16), sp.to(torch.bfloat16), wh, bias,
                                    cvec, leaky=act, out_dtype=out_dtype)
    if cast_back is not None:
        y, dy = y.to(cast_back), dy.to(cast_back)
    return y, dy


def _apply_packed(pp, xp, kind, act: bool = False):
    """One packed conv layer (+bias); ``act`` fuses the following LeakyReLU."""
    if "wh" in pp:
        return _wino_conv(xp, pp["wh"], pp["b"], leaky=act)
    out_dtype = xp.dtype
    z = _PACKED_OPS[kind](xp, pp["w"]) + pp["b"].to(xp.dtype)
    if act:
        z = leaky_relu(z)
    return z.to(out_dtype)


def _apply_packed_cat(pp, xs, kind, act: bool = False):
    """Packed conv layer on an implicit channel concat of packed parts: one
    conv per part (weights split at pack time), summed."""
    out_dtype = xs[0].dtype
    if "wh" in pp:
        z = _wino_conv(xs[0], pp["wh"][0], pp["b"])  # bias rides part 0
        for x, wi in zip(xs[1:], pp["wh"][1:]):
            z = z + _wino_conv(x, wi)
    else:
        op = _PACKED_OPS[kind]
        z = op(xs[0], pp["w"][0])
        for x, wi in zip(xs[1:], pp["w"][1:]):
            z = z + op(x, wi)
        z = z + pp["b"].to(z.dtype)
    if act:
        z = leaky_relu(z)
    return z.to(out_dtype)


def _crop_packed(t, dhw_crop: int):
    """Center crop by ``dhw_crop`` voxels/side in D, H and W (W in cells)."""
    if dhw_crop == 0:
        return t
    c = dhw_crop
    if c % 2:
        raise ValueError("packed crops must be even in W")
    return t[:, c:-c, c:-c, c // 2:-(c // 2), :]


def _fin_vel(y, dy, act, out_dtype):
    if act:
        y, dy = leaky_relu_with_tangent(y, dy)
    return y.to(out_dtype), dy.to(out_dtype)


def _apply_packed_vel(pp, xp, dxp, kind, act: bool = False):
    """One packed vel conv layer, factored tangent: y = op(x, W) + b and
    dy = op(x (.) g + dx, W) - c (.) op(x, W); ``act`` fuses the LeakyReLU
    pair (in-kernel at the Winograd sites).  A layer packed without factors
    runs the materialized tangent (``_apply_packed_vel_learned``)."""
    if "g" not in pp:
        return _apply_packed_vel_learned(pp, xp, dxp, kind, act)
    out_dtype = xp.dtype
    sp = xp * pp["g"].repeat(2).to(xp.dtype) + dxp  # g tiled over the packed rows [q0|q1]
    if "wh" in pp:
        y, dy = _wino_conv_pair(xp, sp, pp["wh"], pp["b"], pp["c"], act)
        return y.to(out_dtype), dy.to(out_dtype)
    op = _PACKED_OPS[kind]
    z = op(xp, pp["w"])
    y = z + pp["b"].to(xp.dtype)
    dy = op(sp, pp["w"]) - pp["c"].to(z.dtype) * z
    return _fin_vel(y, dy, act, out_dtype)


def _apply_packed_vel_learned(pp, xp, dxp, kind, act):
    """Materialized tangent (a learned dweight): y = op(x, W) + b and
    dy = op(x, dW) + op(dx, W), the tangent as a sum over the parts of the
    concat (x, dx) -- three B1 launches at a Winograd site; a narrow output
    runs y and op(x, dW) as one Cols-stacked conv (``"wst"``)."""
    op = _PACKED_OPS[kind]
    out_dtype = xp.dtype
    wdw, ww = pp["wcat"]
    if "wst" in pp:
        c = pp["b"].shape[0]
        z = op(xp, pp["wst"])
        y = z[..., :c] + pp["b"].to(xp.dtype)
        dy = z[..., c:] + op(dxp, ww)
    elif "whcat" in pp:
        y = _wino_conv(xp, pp["wh"], pp["b"])
        dy = _wino_conv(xp, pp["whcat"][0]) + _wino_conv(dxp, pp["whcat"][1])
    else:
        y = op(xp, pp["w"]) + pp["b"].to(xp.dtype)
        dy = op(xp, wdw) + op(dxp, ww)
    return _fin_vel(y, dy, act, out_dtype)


def _apply_packed_vel_cat(pp, xs, dxs, kind, act: bool = False):
    """Vel form of ``_apply_packed_cat``: per part one raw factored pair
    (no bias, c-fold or act); the bias, the c-fold and the LeakyReLU pair
    run once on the sum of the parts.  Without factors (a learned dweight)
    the primal is ``_apply_packed_cat`` and the tangent the sum of one conv
    per part of (xs..., dxs...) against the twice-grouped concat weight."""
    out_dtype = xs[0].dtype
    wino = "wh" in pp
    op = _PACKED_OPS[kind]
    if "g" not in pp:
        y = _apply_packed_cat(pp, xs, kind)
        conv = _wino_conv if wino else op
        dy = None
        for x, wi in zip(list(xs) + list(dxs), pp["whcat"] if wino else pp["wcat"]):
            dy = conv(x, wi) if dy is None else dy + conv(x, wi)
        return _fin_vel(y, dy.to(out_dtype), act, out_dtype)
    cg = pp["g"].shape[0] // len(xs)
    z = zt = None
    for i, (x, dx, wi) in enumerate(zip(xs, dxs, pp["wh"] if wino else pp["w"])):
        sp = x * pp["g"][i * cg:(i + 1) * cg].repeat(2).to(x.dtype) + dx
        zi, zti = _wino_conv_pair(x, sp, wi, None, None, False) if wino else (op(x, wi), op(sp, wi))
        z = zi if z is None else z + zi
        zt = zti if zt is None else zt + zti
    y = z + pp["b"].to(z.dtype)
    dy = zt - pp["c"].to(z.dtype) * z
    return _fin_vel(y, dy, act, out_dtype)


def _apply_packed_main(pp, seq, first, layer, act):
    """The conv/act main path of a packed ResNet block.  ``first(fuse)`` runs
    conv_0 (plain or on a concat), ``layer(pp_conv, h, fuse)`` the other
    convs, ``act(h)`` a LeakyReLU no conv could fuse; ``h`` is a tensor, or
    a (primal, tangent) pair."""
    main_seq, _, _ = _resnet_channel_plan(seq, 0, 0)
    h = None
    conv_idx = 0
    i = 0
    while i < len(main_seq):
        if main_seq[i] == "C":
            fuse = i + 1 < len(main_seq) and main_seq[i + 1] == "A"
            h = first(fuse) if conv_idx == 0 else layer(pp[f"conv_{conv_idx}"], h, fuse)
            conv_idx += 1
            i += 2 if fuse else 1
        else:  # 'A'
            h = act(h)
            i += 1
    return h


def _disp_layer(pp, h, fuse):
    return _apply_packed(pp, h, "conv", act=fuse)


def _vel_layer(pp, h, fuse):
    return _apply_packed_vel(pp, *h, "conv", act=fuse)


def _vel_act(h):
    return leaky_relu_with_tangent(*h)


def apply_resnet_block_packed(pp, xp, seq):
    """Packed premodulated ResNet block ('CACA'/'CAC')."""
    main_seq, num_conv, _ = _resnet_channel_plan(seq, 0, 0)
    y = _crop_packed(_apply_packed(pp["skip"], xp, "skip"), num_conv)
    x_in = xp
    xp = _apply_packed_main(
        pp, seq, lambda fuse: _apply_packed(pp["conv_0"], x_in, "conv", act=fuse),
        _disp_layer, leaky_relu,
    )
    xp = xp + y
    return leaky_relu(xp) if seq.endswith("A") and main_seq != seq else xp


def apply_resnet_block_packed_cat(pp, xs, seq):
    """``apply_resnet_block_packed`` on an implicit concat of packed parts
    (the decoder's cat(skip, upsampled)); pp packed with groups=len(xs)."""
    main_seq, num_conv, _ = _resnet_channel_plan(seq, 0, 0)
    y = _crop_packed(_apply_packed_cat(pp["skip"], xs, "skip"), num_conv)
    xp = _apply_packed_main(
        pp, seq, lambda fuse: _apply_packed_cat(pp["conv_0"], xs, "conv", act=fuse),
        _disp_layer, leaky_relu,
    )
    xp = xp + y
    return leaky_relu(xp) if seq.endswith("A") and main_seq != seq else xp


def _vel_block_tail(h, skip, num_conv, last_act):
    """Residual add of the cropped skip pair, then the block's last LeakyReLU pair."""
    h = tuple(a + _crop_packed(b, num_conv) for a, b in zip(h, skip))
    return leaky_relu_with_tangent(*h) if last_act else h


def apply_resnet_block_vel_packed(pp, xp, dxp, seq):
    """Packed premodulated-vel ResNet block: (x, dx) -> (y, dy)."""
    main_seq, num_conv, _ = _resnet_channel_plan(seq, 0, 0)
    skip = _apply_packed_vel(pp["skip"], xp, dxp, "skip")
    h = _apply_packed_main(
        pp, seq, lambda fuse: _apply_packed_vel(pp["conv_0"], xp, dxp, "conv", act=fuse),
        _vel_layer, _vel_act,
    )
    return _vel_block_tail(h, skip, num_conv, seq.endswith("A") and main_seq != seq)


def apply_resnet_block_vel_packed_cat(pp, xs, dxs, seq):
    """``apply_resnet_block_vel_packed`` on implicit concats of packed parts
    (primal parts ``xs``, tangent parts ``dxs``); pp packed with groups=len(xs)."""
    main_seq, num_conv, _ = _resnet_channel_plan(seq, 0, 0)
    skip = _apply_packed_vel_cat(pp["skip"], xs, dxs, "skip")
    h = _apply_packed_main(
        pp, seq, lambda fuse: _apply_packed_vel_cat(pp["conv_0"], xs, dxs, "conv", act=fuse),
        _vel_layer, _vel_act,
    )
    return _vel_block_tail(h, skip, num_conv, seq.endswith("A") and main_seq != seq)


def apply_resample_block_packed(pp, xp, seq):
    xp = _apply_packed(pp["conv_0"], xp, "down" if "D" in seq else "up")
    return leaky_relu(xp) if seq.endswith("A") else xp


def apply_resample_block_vel_packed(pp, xp, dxp, seq):
    h = _apply_packed_vel(pp["conv_0"], xp, dxp, "down" if "D" in seq else "up")
    return leaky_relu_with_tangent(*h) if seq.endswith("A") else h


# ---------------------------------------------------------------------------
# Entry block: the model's first 'CACA' block consumes the NCDHW C=3 input;
# its first conv and skip are matmuls over stacked taps that emit the packed
# channels-last layout directly.
# ---------------------------------------------------------------------------


def pack_resnet_entry_params(p, seq, *, vel: bool = False, wino: bool = False,
                             dtype=torch.float32, device=None):
    """Fold a 'CACA' entry block's params for packed NCDHW-input execution.

    With ``vel`` the first conv's and the skip's tangent kernels (first-layer
    rule: dy = conv(x, dW)) stack beside the primal ones along Cols, so one
    im2col operand and one skip operand serve both.
    """
    _, num_conv, _ = _resnet_channel_plan(seq, 0, 0)
    if num_conv != 2:
        raise ValueError("entry block is the model's first 'CACA' block")

    def dev(t, dt):
        return t.to(device=device, dtype=dt).contiguous()

    keys = ("weight", "dweight") if vel else ("weight",)
    w0 = torch.cat([s2d.pack_w3_entry(p["conv_0"][k].float()) for k in keys], -1)
    wsk = torch.cat([s2d.pack_w1_entry(p["skip"][k].float()) for k in keys], -1)
    return {
        "conv_0": {
            "w9": dev(s2d.entry_cols(w0), dtype),
            "b": dev(s2d.pack_bias(p["conv_0"]["bias"].float()), torch.float32),
        },
        "conv_1": pack_conv_layer_params(p["conv_1"], "conv", vel=vel, wino=wino, dtype=dtype,
                                         device=device),
        "skip": {
            "w": dev(wsk, dtype),
            "b": dev(s2d.pack_bias(p["skip"]["bias"].float()), torch.float32),
        },
    }


def apply_resnet_entry_packed(pp, x, seq="CACA"):
    """Entry 'CACA' block: (B, C, D, H, W) NCDHW -> (B, D-4, H-4, (W-4)/2, 2*mid)."""
    h = s2d.conv3_entry_im2col(x, pp["conv_0"]["w9"]) + pp["conv_0"]["b"].to(x.dtype)
    h = leaky_relu(h)
    h = _apply_packed(pp["conv_1"], h, "conv")
    xs = x[:, :, 2:-2, 2:-2, 2:-2]
    h = h + s2d.conv1_entry_packed(xs, pp["skip"]["w"]) + pp["skip"]["b"].to(x.dtype)
    return leaky_relu(h)


def apply_resnet_entry_vel_packed(pp, x, seq="CACA"):
    """Entry vel 'CACA' block (first-layer rule: the tangent starts from dW):
    (B, C, D, H, W) NCDHW -> packed (h, dh)."""
    b0 = pp["conv_0"]["b"].to(x.dtype)
    c2 = b0.shape[0]
    z = s2d.conv3_entry_im2col(x, pp["conv_0"]["w9"])
    h, dh = leaky_relu_with_tangent(z[..., :c2] + b0, z[..., c2:])
    h, dh = _apply_packed_vel(pp["conv_1"], h, dh, "conv")
    zs = s2d.conv1_entry_packed(x[:, :, 2:-2, 2:-2, 2:-2], pp["skip"]["w"])
    h = h + zs[..., :c2] + pp["skip"]["b"].to(x.dtype)
    return leaky_relu_with_tangent(h, dh + zs[..., c2:])
