"""Style modulation and the premodulation fold, on torch tensors.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/ops/style.py``: a styled conv
is ``conv(x * m, W) / n`` with input-channel scales ``m`` and demodulation
norms ``n`` (the same as a conv with the per-sample weight ``W * m / n``,
which the style models never build); the premodulation fold bakes
``W * m / n`` into a fixed-cosmology weight, and for velocity models its
d/dDz tangent ``dweight``.  The modulation and the fold run in float32 on
whatever device the weights lie on; the factor recovery
(``recover_dweight_factors``) in float64 numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def style_vector(Om, Dz):
    """Style vector s = [(Om - 0.3) * 5, Dz - 1], float32, shape (B, 2)."""
    Om = torch.atleast_1d(torch.as_tensor(Om, dtype=torch.float32))
    Dz = torch.atleast_1d(torch.as_tensor(Dz, dtype=torch.float32))
    Om, Dz = torch.broadcast_tensors(Om, Dz)
    return torch.stack([(Om - 0.3) * 5.0, Dz - 1.0], dim=-1)


def _m_r(layer_params, s):
    sw = layer_params["style_weight"].float()  # (Cin, S)
    sb = layer_params["style_bias"].float()  # (Cin,)
    w = layer_params["weight"].float()  # (K, K, K, Cin, Cout)
    m = s.float() @ sw.T + sb  # (B, Cin)
    r = (w * w).sum(dim=(0, 1, 2))  # (Cin, Cout)
    return m, r, w


def style_modulation(layer_params, s, eps: float = 1e-8):
    """Per-channel scales of a styled conv layer for a batch of style vectors.

    ``s`` is (B, S); returns the input-channel scales ``m`` (B, Cin) and the
    demodulation norms ``norm`` (B, Cout), float32.
    """
    m, r, _ = _m_r(layer_params, s)
    return m, torch.sqrt((m * m) @ r + eps)


def modulated_style_weight(layer_params, s, eps: float = 1e-8):
    """The demodulated per-sample weight ``W * m / n``, (B, K, K, K, Cin, Cout)
    float32.  For the fold's tests only: the styled forward never builds it."""
    m, norm = style_modulation(layer_params, s, eps)
    w = layer_params["weight"].float()
    return w[None] * m[:, None, None, None, :, None] / norm[:, None, None, None, None, :]


def premodulate_layer(layer_params, s, *, vel: bool = False, first_layer: bool = False,
                      eps: float = 1e-8, factors: bool = False):
    """Fold style ``s`` ((2,) or (1, 2)) into one layer's fixed-cosmology weight.

    Returns ``{"weight": W * m / n, "bias": bias}`` in float32.  With
    ``vel``, also ``dweight``, the analytic d/dDz of the demodulated weight,
    ``dW = W * dm / n + (W * m) * dn`` with ``dm = style_weight[:, 1]`` and
    ``dn = -sum_i m_i dm_i R[i, o] / n^3``; a ``first_layer`` (one that sees
    the raw, Dz/6-scaled input) adds ``weight / Dz``.  With ``factors``, also
    the tangent's rank factors ``dfac_in`` (Ci,) and ``dfac_out`` (Co,),
    ``dW = W_norm * dfac_in - W_norm * dfac_out``, gauge-centred so that
    ``dfac_out`` has mean 0.
    """
    s = torch.as_tensor(s, dtype=torch.float32).reshape(1, -1)
    m, r, w = _m_r(layer_params, s)
    m = m[0]
    norm = torch.sqrt(m * m @ r + eps)  # (Cout,)
    w_mod = w * m[:, None]
    w_norm = w_mod / norm
    out = {"weight": w_norm, "bias": layer_params["bias"]}
    if not vel:
        return out
    dm = layer_params["style_weight"].float()[:, 1]  # d(m)/dDz: style slot 1 is Dz - 1
    dnorm = -((m * dm) @ r) / norm**3  # (Cout,)
    dw = (w * dm[:, None]) / norm + w_mod * dnorm
    if first_layer:
        dw = dw + w_norm / (s[0, 1] + 1.0)
    out["dweight"] = dw
    if factors:
        # g = dm/m (+ 1/Dz), kept finite as m -> 0; c = -norm * dnorm; then
        # the gauge shift (g, c) -> (g - t, c - t), t = mean(c), which leaves dW
        # unchanged and keeps the c-fold's cancellation small.
        g = dm * m / (m * m + 1e-16)
        if first_layer:
            g = g + 1.0 / (s[0, 1] + 1.0)
        c = norm * (-dnorm)
        t = c.mean()
        out["dfac_in"] = g - t
        out["dfac_out"] = c - t
    return out


def recover_dweight_factors(weight, dweight, *, rel_tol: float = 1e-4):
    """Recover the rank structure ``dW = W * g_in - W * c_out`` of a tangent kernel.

    Least squares in float64 numpy over the (Ci + Co) gauge-degenerate normal
    equations (least-norm solution), gauge-centred so that ``c`` has mean 0.
    ``ok`` is whether the residual is at rounding level (max |residual| <=
    ``rel_tol`` * max |dW|): true for a ``dweight`` folded from a style tree,
    false for a learned one.  Returns ``(g (Ci,), c (Co,), ok)``, float64 numpy.
    """
    w = np.asarray(_np(weight), np.float64)
    dw = np.asarray(_np(dweight), np.float64)
    ci, co = w.shape[-2], w.shape[-1]
    wk = w.reshape(-1, ci, co)
    dwk = dw.reshape(-1, ci, co)
    p = (wk * wk).sum(0)  # (Ci, Co)
    q = (wk * dwk).sum(0)  # (Ci, Co)
    mat = np.zeros((ci + co, ci + co))
    mat[:ci, :ci] = np.diag(p.sum(1))
    mat[:ci, ci:] = -p
    mat[ci:, :ci] = p.T
    mat[ci:, ci:] = -np.diag(p.sum(0))
    rhs = np.concatenate([q.sum(1), q.sum(0)])
    sol, *_ = np.linalg.lstsq(mat, rhs, rcond=None)
    g, c = sol[:ci], sol[ci:]
    t = c.mean()
    g, c = g - t, c - t
    resid = wk * (g[None, :, None] - c[None, None, :]) - dwk
    ok = bool(np.abs(resid).max() <= rel_tol * (np.abs(dwk).max() + 1e-300))
    return g, c, ok


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else t
