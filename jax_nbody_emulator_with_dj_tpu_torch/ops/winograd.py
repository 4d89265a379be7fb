"""Winograd transforms over (D, H) for the packed 3x3x2 interior conv:
F(2,3)^2, and the mixed F(2,3) in D x F(4,3) in H.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/ops/winograd.py``.  A 2x2
(D, H) output tile costs 16 point products instead of 36 tap-MACs (a 2x4 tile
of the mixed form 24 instead of 72); the packed W axis keeps its exact 2-tap
accumulation:

    y[., a] = sum_a  AT (G wp[., a] G^T) (.) (BT x[., u+a] B) A

``conv3_packed_wino`` and ``conv3_packed_wino_pair`` are the plain PyTorch
versions of the hand-written CUDA kernels B1 and B2 (``ops/winograd_cuda.py``,
``csrc/wino_f23.cu``): same inputs, same epilogue, and the same roundings as
the kernels (and as the Pallas kernels they replace) — the BT transform
rounds to the operand dtype after each axis, the point products accumulate
in float32, and the AT fold and the epilogue run in float32 before one cast
to the output dtype.  ``conv3_packed_wino43`` is the plain version of kernel
B3 (``ops/winograd43_cuda.py``, ``csrc/wino_f43.cu``), which follows the
roundings of ``ops/winograd43_pallas.py`` the same way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_BT = ((1, 0, -1, 0), (0, 1, 1, 0), (0, -1, 1, 0), (0, 1, 0, -1))
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))
_AT = ((1, 1, 1, 0), (0, 1, -1, -1))
# F(4,3): 6 points per 4 outputs.  BT4 is applied in ``_bt4`` in the CSE'd
# order of the TPU kernel (the order decides the bf16 roundings).
_G4 = ((1 / 4, 0, 0), (-1 / 6, -1 / 6, -1 / 6), (-1 / 6, 1 / 6, -1 / 6),
       (1 / 24, 1 / 12, 1 / 6), (1 / 24, -1 / 12, 1 / 6), (0, 0, 1))
_AT4 = ((1, 1, 1, 1, 1, 0), (0, 1, -1, 2, -2, 0), (0, 1, 1, 4, 4, 0), (0, 1, -1, 8, -8, 1))


def transform_packed_w3(wp):
    """Packed (3, 3, 2, 2Ci, 2Co) kernel -> Winograd (4, 4, 2, 2Ci, 2Co).

    What[a, b, t] = sum_{kd, kh} G[a, kd] G[b, kh] wp[kd, kh, t], in float32
    (G has exact halves), cast back to ``wp``'s dtype.
    """
    g = torch.tensor(_G, dtype=torch.float32, device=wp.device)
    out = torch.einsum("ak,bl,kltcf->abtcf", g, g, wp.float())
    return out.to(wp.dtype)


def transform_packed_w3_mixed(wp):
    """Packed (3, 3, 2, 2Ci, 2Co) kernel -> mixed Winograd (4, 6, 2, 2Ci, 2Co):
    G of F(2,3) along D, G of F(4,3) along H, in float32 (G4 has sixths),
    cast back to ``wp``'s dtype."""
    g2 = torch.tensor(_G, dtype=torch.float32, device=wp.device)
    g4 = torch.tensor(_G4, dtype=torch.float32, device=wp.device)
    out = torch.einsum("ak,bl,kltcf->abtcf", g2, g4, wp.float())
    return out.to(wp.dtype)


def _bt(x, axis: int, n: int):
    """BT of F(2,3) along ``axis`` -> new leading axis of 4 points.

    Tile i reads rows 2i..2i+3; each BT row is a +-1 pair of them.
    """
    r = [x.narrow(axis, k, 2 * n - 1)[(slice(None),) * axis + (slice(None, None, 2),)]
         for k in range(4)]
    return torch.stack([r[0] - r[2], r[1] + r[2], r[2] - r[1], r[1] - r[3]])


def _bt4(x, axis: int, n: int):
    """BT of F(4,3) along ``axis`` -> new leading axis of 6 points.

    Tile i reads rows 4i..4i+5.  Every operation rounds to ``x``'s dtype, in
    the order of the TPU kernel (``winograd43_pallas.py:129-141``): the
    shared sums first, the x2, x4, x5 products as written.
    """
    g0, g1, g2, g3, g0n, g1n = [
        x.narrow(axis, k, 4 * n - 3)[(slice(None),) * axis + (slice(None, None, 4),)]
        for k in range(6)]
    s12p = g1 + g2
    s12m = g1 - g2
    s13m2 = 2 * (g1 - g3)
    t02 = g0n - g2
    return torch.stack([
        4 * g0 - 5 * g2 + g0n,
        (g0n + g3) - 4 * s12p,
        (g0n - g3) + 4 * s12m,
        t02 - s13m2,
        t02 + s13m2,
        4 * g1 - 5 * g3 + g1n,
    ])


def conv3_packed_wino43(xp, what, bias=None, *, leaky: bool = False, out_dtype=None):
    """VALID (3,3,2)-tap packed conv via F(2,3) in D x F(4,3) in H, + bias +
    LeakyReLU: the plain version of kernel B3.

    Args:
        xp: (B, D, H, WP, C2) packed input.
        what: (4, 6, 2, C2, F2) from ``transform_packed_w3_mixed``.
        bias: (F2/2,) or (F2,) float32 bias, or None.
        leaky: apply LeakyReLU(0.01) after the bias.
        out_dtype: output dtype (default ``xp.dtype``).
    Returns (B, D-2, H-2, WP-1, F2).  Both input transforms run in ``xp``'s
    dtype, the 24 point products (two packed-W taps each) and AT4, AT2, the
    bias and the LeakyReLU in float32, then one cast.  Output extents that are
    not multiples of (2, 4) are zero-padded on the input side and cropped.
    """
    if what.dim() != 5 or tuple(what.shape[:3]) != (4, 6, 2) or what.shape[3] != xp.shape[-1]:
        raise ValueError(f"what {tuple(what.shape)} does not match xp {tuple(xp.shape)}")
    b, d, h, wpd, c2 = xp.shape
    od, oh, ow = d - 2, h - 2, wpd - 1
    nd, nh = (od + 1) // 2, (oh + 3) // 4
    xp = F.pad(xp, (0, 0, 0, 0, 0, 4 * nh + 2 - h, 0, 2 * nd + 2 - d))
    f2 = what.shape[-1]
    xd = _bt(xp, 1, nd)  # (4u, B, nd, Hp, WP, C2)
    z = _bt4(xd, 3, nh)  # (6v, 4u, B, nd, nh, WP, C2)
    z = z.transpose(0, 1).float()
    zz = torch.cat([z[..., :ow, :], z[..., 1:, :]], dim=-1).reshape(4, 6, -1, 2 * c2)
    wk = what.to(xp.dtype).float().reshape(4, 6, 2 * c2, f2)
    s = torch.matmul(zz, wk)  # (u, v, M, F2), float32 accumulation
    at4 = torch.tensor(_AT4, dtype=torch.float32, device=xp.device)
    at2 = torch.tensor(_AT, dtype=torch.float32, device=xp.device)
    y = torch.einsum("pu,uqmf->pqmf", at2, torch.einsum("qv,uvmf->uqmf", at4, s))
    y = y.reshape(2, 4, b, nd, nh, ow, f2).permute(2, 3, 0, 4, 1, 5, 6)
    y = y.reshape(b, 2 * nd, 4 * nh, ow, f2)[:, :od, :oh]
    if bias is not None:
        y = y + _vec(bias, f2)
    if leaky:
        y = F.leaky_relu(y, 0.01)
    return y.to(out_dtype or xp.dtype)


def _wino_acc(xp, wh):
    """float32 (B, D-2, H-2, WP-1, F2) result of the VALID packed conv.

    Odd output extents are handled by zero-padding the input to even ones
    and cropping.
    """
    b, d, h, wpd, c2 = xp.shape
    od, oh, ow = d - 2, h - 2, wpd - 1
    nd, nh = (od + 1) // 2, (oh + 1) // 2
    xp = F.pad(xp, (0, 0, 0, 0, 0, 2 * nh + 2 - h, 0, 2 * nd + 2 - d))
    wh = wh.to(xp.dtype)
    f2 = wh.shape[-1]
    # Input transform, rounded to the operand dtype after each axis.
    xd = _bt(xp, 1, nd)  # (4u, B, nd, Hp, WP, C2)
    z = _bt(xd, 3, nh)  # (4v, 4u, B, nd, nh, WP, C2)
    z = z.transpose(0, 1).float()  # (u, v, B, nd, nh, WP, C2)
    zz = torch.cat([z[..., :ow, :], z[..., 1:, :]], dim=-1)  # taps a=0|a=1
    zz = zz.reshape(4, 4, -1, 2 * c2)
    wk = wh.float().reshape(4, 4, 2 * c2, f2)
    s = torch.matmul(zz, wk)  # (u, v, M, F2), float32 accumulation
    at = torch.tensor(_AT, dtype=torch.float32, device=xp.device)
    y = torch.einsum("pu,qv,uvmf->pqmf", at, at, s)
    y = y.reshape(2, 2, b, nd, nh, ow, f2).permute(2, 3, 0, 4, 1, 5, 6)
    return y.reshape(b, 2 * nd, 2 * nh, ow, f2)[:, :od, :oh]


def _vec(v, f2: int):
    """A (F2/2,) unpacked or (F2,) packed float32 per-channel vector, as (F2,)."""
    v = v.float().reshape(-1)
    return v if v.shape[0] == f2 else v.repeat(2)


def conv3_packed_wino(xp, wh, bias=None, *, leaky: bool = False, out_dtype=None):
    """VALID (3,3,2)-tap packed conv via F(2,3)^2 Winograd, + bias + LeakyReLU.

    Args:
        xp: (B, D, H, WP, C2) packed input.
        wh: (4, 4, 2, C2, F2) from ``transform_packed_w3``.
        bias: (F2/2,) or (F2,) float32 bias, or None.
        leaky: apply LeakyReLU(0.01) after the bias.
        out_dtype: output dtype (default ``xp.dtype``).
    Returns (B, D-2, H-2, WP-1, F2).
    """
    y = _wino_acc(xp, wh)
    if bias is not None:
        y = y + _vec(bias, y.shape[-1])
    if leaky:
        y = F.leaky_relu(y, 0.01)
    return y.to(out_dtype or xp.dtype)


def conv3_packed_wino_pair(xp, sp, wh, bias=None, c=None, *, leaky: bool = False,
                           out_dtype=None):
    """The factored-tangent pair over one Winograd kernel ``wh``:

        y  = conv(xp, W) + bias
        dy = conv(sp, W) - c (.) conv(xp, W)

    on the float32 results; with ``leaky``, dy takes slope 0.01 wherever the
    float32 y <= 0, and then y does too.  ``bias``/``c`` are (F2/2,) or
    (F2,) float32, or None for zeros (the raw per-part form).  Returns
    ``(y, dy)``, each (B, D-2, H-2, WP-1, F2) in ``out_dtype`` (default
    ``xp.dtype``).
    """
    if sp.shape != xp.shape or sp.dtype != xp.dtype:
        raise ValueError(f"sp {tuple(sp.shape)} {sp.dtype} != xp {tuple(xp.shape)} {xp.dtype}")
    ax = _wino_acc(xp, wh)
    f2 = ax.shape[-1]
    y = ax if bias is None else ax + _vec(bias, f2)
    dy = _wino_acc(sp, wh)
    if c is not None:
        dy = dy - _vec(c, f2) * ax
    if leaky:
        neg = y <= 0
        dy = torch.where(neg, 0.01 * dy, dy)
        y = torch.where(neg, 0.01 * y, y)
    out_dtype = out_dtype or xp.dtype
    return y.to(out_dtype), dy.to(out_dtype)
