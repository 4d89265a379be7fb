"""Style modulation and the premodulation fold, on torch tensors.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/ops/style.py``: a styled conv
is ``conv(x * m, W) / n`` with input-channel scales ``m`` and demodulation
norms ``n``; the premodulation fold bakes ``W * m / n`` into a fixed-cosmology
weight.  The fold math runs in float32 on whatever device the weights lie on.
"""

from __future__ import annotations

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
    """(m (B, Cin), norm (B, Cout)) float32 scales for a styled conv layer."""
    m, r, _ = _m_r(layer_params, s)
    return m, torch.sqrt((m * m) @ r + eps)


def premodulate_layer(layer_params, s, *, eps: float = 1e-8):
    """Fold style ``s`` ((2,) or (1, 2)) into one layer's fixed-cosmology weight.

    Returns ``{"weight": W * m / n, "bias": bias}`` in float32.  The velocity
    fold (``dweight`` and its factors) is ROADMAP item A2.
    """
    s = torch.as_tensor(s, dtype=torch.float32).reshape(1, -1)
    m, r, w = _m_r(layer_params, s)
    m = m[0]
    norm = torch.sqrt(m * m @ r + eps)  # (Cout,)
    return {"weight": w * m[:, None] / norm, "bias": layer_params["bias"]}
