"""Reduced bispectrum Q(theta) via the FFT-binned estimator.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/bispectrum.py``: for
each k bin build the band-filtered fields I_i(x) = IFFT[delta_k * mask_i] and
the mode fields N_i(x) = IFFT[mask_i]; then

    B(k1, k2, k3) = sum_x I1 I2 I3 / sum_x N1 N2 N3 * V^2 / N^3
    Q = B / (P1 P2 + P2 P3 + P3 P1)

The masks are real and even in k, so every inverse transform's input is
Hermitian.
"""

from __future__ import annotations

import numpy as np
import torch

from .powerspec import _k_grid


def _band_fields(dk, kmag, k_lo, k_hi, n):
    mask = ((kmag >= k_lo) & (kmag < k_hi)).to(torch.complex64)
    return (torch.fft.irfftn(dk * mask, s=(n, n, n)), torch.fft.irfftn(mask, s=(n, n, n)))


def reduced_bispectrum(delta, boxsize: float, k1: float, k2: float, thetas,
                       dk_width: float | None = None):
    """Q(theta) for triangle configurations (k1, k2, theta).

    Args:
        delta: (N, N, N) density contrast.
        boxsize: box side [Mpc/h].
        k1, k2: triangle side magnitudes [h/Mpc].
        thetas: (T,) opening angles [rad].
        dk_width: k-bin half-width (default: one fundamental mode).

    Returns:
        dict with 'theta', 'k3', 'B', 'Q', 'P3' (numpy) and 'P1', 'P2' (floats).
    """
    delta = torch.as_tensor(delta).float()
    n = delta.shape[0]
    kf = 2 * np.pi / boxsize
    half = dk_width if dk_width is not None else kf
    dk = torch.fft.rfftn(delta)
    kmag, _ = _k_grid(n, boxsize, delta.device)
    v = boxsize**3
    n3 = float(n) ** 3

    thetas = np.asarray(thetas, np.float64)
    k3s = np.sqrt(k1**2 + k2**2 + 2 * k1 * k2 * np.cos(thetas))

    def band(kc):
        return _band_fields(dk, kmag, kc - half, kc + half, n)

    def pk_of_band(i_field, n_field):
        # P = V/N^3 * sum I^2 / sum N^2  (per-bin shell average)
        return v / n3 * torch.sum(i_field**2) / torch.clamp(torch.sum(n_field**2), min=1e-30)

    i1, n1 = band(k1)
    i2, n2 = band(k2)
    p1 = pk_of_band(i1, n1)
    p2 = pk_of_band(i2, n2)

    Bs, Qs, P3s = [], [], []
    for k3 in k3s:
        i3, nn3 = band(float(k3))
        denom = torch.clamp(torch.sum(n1 * n2 * nn3), min=1e-30)
        b = (v**2 / n3) * torch.sum(i1 * i2 * i3) / denom
        p3 = pk_of_band(i3, nn3)
        Bs.append(b)
        Qs.append(b / torch.clamp(p1 * p2 + p2 * p3 + p3 * p1, min=1e-30))
        P3s.append(p3)

    return {
        "theta": thetas,
        "k3": k3s,
        "B": torch.stack(Bs).cpu().numpy(),
        "Q": torch.stack(Qs).cpu().numpy(),
        "P1": float(p1),
        "P2": float(p2),
        "P3": torch.stack(P3s).cpu().numpy(),
    }
