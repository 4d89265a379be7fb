"""FFT power spectra and field-comparison summary statistics.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/powerspec.py``:
auto/cross P(k) by spherical shell binning of the 3D rFFT, transfer function
T(k)=sqrt(P_a/P_b), correlation C(k)=P_x/sqrt(P_a P_b), and the scalar metric
dict of a target-vs-model comparison.  The shell sums are ``index_add_``
accumulated in float64 and rounded to float32 (the JAX package's float32
``bincount``, without its dependence on the order of the sum).

Conventions: box side ``boxsize`` in Mpc/h, density contrast delta(x) on an
(N, N, N) grid; P(k) in (Mpc/h)^3 with delta_k = (V/N^3) FFT(delta) and
P = <|delta_k|^2> / V.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import k_axes, to_numpy


def _k_grid(n: int, boxsize: float, device):
    """|k| on the rfftn grid, plus Hermitian mode weights (broadcastable)."""
    kx, ky, kz = k_axes(n, boxsize, device)
    kmag = torch.sqrt(kx**2 + ky**2 + kz**2)
    # Hermitian double-count weight: rfft stores half the modes; planes
    # kz=0 and kz=Nyquist are self-conjugate (weight 1), the rest weight 2.
    wz = torch.full((n // 2 + 1,), 2.0, device=device)
    wz[0] = 1.0
    if n % 2 == 0:
        wz[-1] = 1.0
    return kmag, wz[None, None, :]


def _bin_edges(n: int, boxsize: float, nbins: int | None, device):
    kf = 2.0 * np.pi / boxsize
    knyq = kf * (n // 2)
    if nbins is None:
        nbins = n // 2
    return torch.tensor(np.linspace(kf / 2, knyq + kf / 2, nbins + 1), dtype=torch.float32,
                        device=device)


def _shell_average(kmag, weights, quantity, edges, nbins: int):
    kflat = kmag.reshape(-1)
    idx = (torch.searchsorted(edges, kflat) - 1).clamp_(0, nbins - 1)
    in_range = (kflat >= edges[0]) & (kflat < edges[-1])
    w = (weights.expand(kmag.shape).reshape(-1) * in_range)

    def shell_sum(v):
        # float64 sums, rounded once to float32: a shell holds up to ~10^5 modes at
        # 128^3, whose float32 sums (sequential on the CPU, atomics in any order on
        # the card) differ in the 5th digit; the JAX package sums in float32
        return torch.zeros(nbins, dtype=torch.float64, device=kmag.device).index_add_(
            0, idx, v.double()).float()

    counts = shell_sum(w)
    ksum = shell_sum(w * kflat)
    qsum = shell_sum(w * quantity.reshape(-1))
    counts = torch.clamp(counts, min=1e-30)
    return ksum / counts, qsum / counts, counts


def _binned(field3d, n: int, boxsize: float, nbins: int):
    kmag, weights = _k_grid(n, boxsize, field3d.device)
    return _shell_average(kmag, weights, field3d, _bin_edges(n, boxsize, nbins, field3d.device),
                          nbins)


def power_spectrum(delta, boxsize: float, nbins: int | None = None):
    """Auto power spectrum of a periodic density field.

    Args:
        delta: (N, N, N) real field (any float dtype; promoted to f32).
        boxsize: box side length [Mpc/h].
        nbins: number of k shells (default N/2, fundamental-mode spaced).

    Returns:
        (k, Pk, Nmodes) float32 tensors on delta's device: shell-mean |k|
        [h/Mpc], P(k) [(Mpc/h)^3], mode counts.
    """
    delta = torch.as_tensor(delta).float()
    n = delta.shape[0]
    nbins = nbins or n // 2
    dk = torch.fft.rfftn(delta)
    # P = |delta_k|^2 * V / N^6
    pk3d = (dk.real**2 + dk.imag**2) * (boxsize**3 / float(n) ** 6)
    del dk
    return _binned(pk3d, n, boxsize, nbins)


def cross_power(delta_a, delta_b, boxsize: float, nbins: int | None = None):
    """Cross power spectrum Re<delta_a delta_b*> of two fields."""
    delta_a = torch.as_tensor(delta_a).float()
    n = delta_a.shape[0]
    nbins = nbins or n // 2
    da = torch.fft.rfftn(delta_a)
    db = torch.fft.rfftn(torch.as_tensor(delta_b, device=delta_a.device).float())
    px3d = (da.real * db.real + da.imag * db.imag) * (boxsize**3 / float(n) ** 6)
    del da, db
    return _binned(px3d, n, boxsize, nbins)


def transfer_and_correlation(delta_model, delta_target, boxsize: float, nbins=None):
    """T(k) = sqrt(P_model/P_target), C(k) = P_x / sqrt(P_model P_target)."""
    k, p_m, _ = power_spectrum(delta_model, boxsize, nbins)
    _, p_t, _ = power_spectrum(delta_target, boxsize, nbins)
    _, p_x, _ = cross_power(delta_model, delta_target, boxsize, nbins)
    t = torch.sqrt(torch.clamp(p_m, min=1e-30) / torch.clamp(p_t, min=1e-30))
    c = p_x / torch.sqrt(torch.clamp(p_m * p_t, min=1e-60))
    return k, t, c


def summary_metrics(delta_model, delta_target, boxsize: float, kmax: float | None = None):
    """Scalar regression metrics comparing two density fields (host float64).

    RMSE, Pearson r, field moments, median and max |T-1|, and mean (1-C) up
    to ``kmax``.
    """
    a = to_numpy(delta_model, np.float64).ravel()
    b = to_numpy(delta_target, np.float64).ravel()
    k, t, c = (to_numpy(v) for v in transfer_and_correlation(delta_model, delta_target, boxsize))
    sel = np.ones_like(k, bool) if kmax is None else (k <= kmax)
    return {
        "rmse": float(np.sqrt(np.mean((a - b) ** 2))),
        "pearson_r": float(np.corrcoef(a, b)[0, 1]),
        "mean_model": float(a.mean()),
        "mean_target": float(b.mean()),
        "std_model": float(a.std()),
        "std_target": float(b.std()),
        "skew_model": float(((a - a.mean()) ** 3).mean() / a.std() ** 3),
        "skew_target": float(((b - b.mean()) ** 3).mean() / b.std() ** 3),
        "median_abs_T_minus_1": float(np.median(np.abs(t[sel] - 1.0))),
        "max_abs_T_minus_1": float(np.max(np.abs(t[sel] - 1.0))),
        "mean_1_minus_C": float(np.mean(1.0 - c[sel])),
    }
