"""Space-to-depth (W-parity) packed execution for the 64-channel interior.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/ops/s2d.py``.  Packing the
minor spatial axis W pairwise into channels,

    x(B, D, H, W, C)  ->  x'(B, D, H, W/2, 2C)        [pure reshape]

turns a 3x3x3 conv into an exact 3x3x2 conv on packed tensors, a 1x1 conv
into a parity-block-diagonal matmul, and the k2s2 down / lhs-dilated up convs
into one matmul each.  The packed weights are the JAX package's, element for
element; the packed conv converts its kernel to torch's OIDHW once at pack
time (``oidhw_w3``) and runs ``F.conv3d`` on the channels-last tensor.

All packed weights support ``groups``: when the packed input is a channel
concatenation of g packed tensors, the input-channel rows are laid out as
``[t0q0, t0q1, t1q0, t1q1, ...]``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pack(x):
    """(B, D, H, W, C) -> (B, D, H, W/2, 2C); W must be even."""
    b, d, h, w, c = x.shape
    return x.reshape(b, d, h, w // 2, 2 * c)


def unpack(xp):
    """(B, D, H, WP, 2C) -> (B, D, H, 2*WP, C)."""
    b, d, h, wp, c2 = xp.shape
    return xp.reshape(b, d, h, 2 * wp, c2 // 2)


def _group_rows(ci: int, groups: int):
    """Packed input-channel row index for [parity, unpacked ci]."""
    g = ci // groups
    rows = np.zeros((2, ci), np.int64)
    for grp in range(groups):
        for q in range(2):
            rows[q, grp * g:(grp + 1) * g] = np.arange(g) + grp * 2 * g + q * g
    return torch.from_numpy(rows)


def pack_w3(w, groups: int = 1):
    """(3,3,3,Ci,Co) -> (3,3,2,2Ci,2Co): W'[a, qCi+ci, pCo+co] = W[2a+q-p]."""
    k1, k2, k3, ci, co = w.shape
    if (k1, k2, k3) != (3, 3, 3):
        raise ValueError(f"pack_w3 needs a 3x3x3 kernel, got {tuple(w.shape)}")
    rows = _group_rows(ci, groups)
    wp = w.new_zeros((3, 3, 2, 2 * ci, 2 * co))
    for a in range(2):
        for q in range(2):
            for p in range(2):
                kw = 2 * a + q - p
                if 0 <= kw <= 2:
                    wp[:, :, a, rows[q], p * co:(p + 1) * co] = w[:, :, kw]
    return wp


def oidhw_w3(wp):
    """Packed (3,3,2,2Ci,2Co) kernel -> torch's OIDHW (2Co, 2Ci, 3, 3, 2)."""
    return wp.permute(4, 3, 0, 1, 2).contiguous()


def pack_w1(w, groups: int = 1):
    """(1,1,1,Ci,Co) (or (Ci,Co)) -> (2Ci, 2Co) parity-block-diagonal matmul."""
    w = w.reshape(w.shape[-2], w.shape[-1])
    ci, co = w.shape
    rows = _group_rows(ci, groups)
    wp = w.new_zeros((2 * ci, 2 * co))
    for p in range(2):
        wp[rows[p], p * co:(p + 1) * co] = w
    return wp


def pack_w_down(w, groups: int = 1):
    """(2,2,2,Ci,Co) k2s2 kernel -> (8*2Ci, 2Co); rows are (r, s, a, packed channel)."""
    ci, co = w.shape[-2], w.shape[-1]
    rows = _group_rows(ci, groups)
    wp = w.new_zeros((2, 2, 2, 2 * ci, 2 * co))
    for p in range(2):  # output parity == which input cell (a) it consumes
        for q in range(2):  # input parity == kernel W tap
            wp[:, :, p, rows[q], p * co:(p + 1) * co] = w[:, :, q]
    return wp.reshape(8 * 2 * ci, 2 * co)


def pack_w_up(w, groups: int = 1):
    """(2,2,2,Ci,Co) upsample kernel -> (2Ci, 16*Co); cols are (r, s, a, p, Co).

    The value at (a*Ci+ci, (r,s,a,p,co)) is w[1-r, 1-s, 1-p, ci, co].
    """
    ci, co = w.shape[-2], w.shape[-1]
    rows = _group_rows(ci, groups)
    wp = w.new_zeros((2 * ci, 2, 2, 2, 2, co))
    for r in range(2):
        for s in range(2):
            for a in range(2):
                for p in range(2):
                    wp[rows[a], r, s, a, p] = w[1 - r, 1 - s, 1 - p]
    return wp.reshape(2 * ci, 16 * co)


def pack_bias(b):
    """(Co,) -> (2Co,) parity-duplicated bias."""
    return b.repeat(2)


# ---------------------------------------------------------------------------
# Entry convs: NCDHW small-C input -> packed channels-last output.
# Output position w = 2u+p reads input 2u+p+kw; in cell pairs (cell u, cell
# u+1, 2 parities each) the source index is t = p+kw in 0..3.
# ---------------------------------------------------------------------------


def pack_w3_entry(w):
    """(3,3,3,Ci,Co) -> (3,3,Ci,4,2Co) fold for the entry conv."""
    k1, k2, k3, ci, co = w.shape
    if (k1, k2, k3) != (3, 3, 3):
        raise ValueError(f"pack_w3_entry needs a 3x3x3 kernel, got {tuple(w.shape)}")
    wf = w.new_zeros((3, 3, ci, 4, 2 * co))
    for kw in range(3):
        for p in range(2):
            wf[:, :, :, p + kw, p * co:(p + 1) * co] = w[:, :, kw]
    return wf


def entry_cols(wf):
    """(3, 3, Ci, 4, Cols) entry fold -> (4*Ci*9, Cols) im2col rhs.

    Row order k = ((a*2 + q)*Ci + c)*9 + (kd*3 + kh), matching
    ``conv3_entry_im2col``'s operand.
    """
    k1, k2, ci, four, cols = wf.shape
    w6 = wf.reshape(k1, k2, ci, 2, 2, cols)  # [kd, kh, c, a, q, cols]
    return w6.permute(3, 4, 2, 0, 1, 5).reshape(four * ci * k1 * k2, cols).contiguous()


def conv3_entry_im2col(x, wf9):
    """VALID 3x3x3 entry conv as one K=4*Ci*9 matmul over cell pairs.

    (B, C, D, H, W) NCDHW -> (B, D-2, H-2, (W-2)/2, Cols).
    """
    b, c, d, h, w_ = x.shape
    xc = x.permute(0, 2, 3, 4, 1).reshape(b, d, h, w_ // 2, 2 * c)  # (q, c) minor
    xp = torch.cat([xc[..., :-1, :], xc[..., 1:, :]], -1)  # (.., U, 4C)
    dd, hh = d - 2, h - 2
    lhs = torch.stack(
        [xp[:, kd:kd + dd, kh:kh + hh] for kd in range(3) for kh in range(3)],
        dim=-1,
    )  # (B, D', H', U, 4C, 9)
    lhs = lhs.reshape(b, dd, hh, lhs.shape[3], 4 * c * 9)
    return torch.matmul(lhs, wf9.to(x.dtype))


def unpack_to_ncdhw(yp):
    """(B, D, H, U, 2C) packed -> (B, C, D, H, 2U) NCDHW."""
    b, d, h, u, c2 = yp.shape
    c = c2 // 2
    y = yp.reshape(b, d, h, u, 2, c)
    return y.permute(0, 5, 1, 2, 3, 4).reshape(b, c, d, h, 2 * u)


def pack_w1_entry(w):
    """(1,1,1,Ci,Co) (or (Ci,Co)) -> (Ci, 2, 2Co) fold for ``conv1_entry_packed``."""
    w = w.reshape(w.shape[-2], w.shape[-1])
    ci, co = w.shape
    wf = w.new_zeros((ci, 2, 2 * co))
    for p in range(2):
        wf[:, p, p * co:(p + 1) * co] = w
    return wf


def conv1_entry_packed(x, wf):
    """1x1x1 conv: (B, C, D, H, W) NCDHW -> (B, D, H, W/2, 2Co) packed."""
    b, c, d, h, w_ = x.shape
    xc = x.reshape(b, c, d, h, w_ // 2, 2).permute(0, 2, 3, 4, 1, 5)
    xc = xc.reshape(b, d, h, w_ // 2, 2 * c)  # K order (c, q)
    return torch.matmul(xc, wf.reshape(2 * c, -1).to(x.dtype))


def conv3_packed(xp, wp):
    """VALID 3x3x3 conv on packed tensors; ``wp`` is ``oidhw_w3(pack_w3(w))``,
    the OIDHW form the packed runtime keeps (converted once, at pack time)."""
    y = F.conv3d(xp.permute(0, 4, 1, 2, 3), wp.to(xp.dtype))
    return y.permute(0, 2, 3, 4, 1)


def conv1_packed(xp, w1p):
    """1x1x1 conv on packed tensors (w1p from ``pack_w1``)."""
    return torch.matmul(xp, w1p.to(xp.dtype))


def down_packed(xp, wdp):
    """Stride-2 kernel-2 conv on packed tensors (wdp from ``pack_w_down``)."""
    b, d, h, wp_, c2 = xp.shape
    xr = xp.reshape(b, d // 2, 2, h // 2, 2, wp_ // 2, 2, c2)
    xr = xr.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(b, d // 2, h // 2, wp_ // 2, 8 * c2)
    return torch.matmul(xr, wdp.to(xp.dtype))


def up_packed(xp, wup):
    """2x lhs-dilated kernel-2 upsample on packed tensors (``pack_w_up``)."""
    b, d, h, wp_, c2 = xp.shape
    co = wup.shape[1] // 16
    y = torch.matmul(xp, wup.to(xp.dtype))  # (B,D,H,WP, r,s,a,p,Co)
    y = y.reshape(b, d, h, wp_, 2, 2, 2, 2 * co)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7)  # (B, D,r, H,s, WP,a, 2Co)
    return y.reshape(b, 2 * d, 2 * h, 2 * wp_, 2 * co)
