"""Gaussian random field generation from a target P(k).

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/grf.py``: real white
noise is drawn in configuration space and coloured in Fourier space by
sqrt(P(k)), so Hermitian symmetry is automatic.  Random numbers come from an
explicit ``torch.Generator`` (JAX's PRNG key); the colouring is a
deterministic function of the noise field (``_colour_noise``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..hierarchical import resolve_device
from ._common import k_axes


def white_noise_field(generator: torch.Generator, n: int, device=None, dtype=torch.float32):
    """Unit-variance real white noise on an (n, n, n) grid.

    ``device`` defaults to the CUDA card (see ``hierarchical.resolve_device``);
    the generator must live on the same device.
    """
    return torch.randn((n, n, n), generator=generator, device=resolve_device(device), dtype=dtype)


_DX0 = float(np.spacing(np.finfo(np.float32).eps))  # jnp.interp's guard against dx == 0


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)``: linear, constant beyond the table's ends."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp_(1, len(xp) - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    small = dx.abs() <= _DX0
    f = torch.where(small, f0, f0 + ((x - x0) / torch.where(small, torch.ones_like(dx), dx))
                    * (f1 - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def _interp_pk(kmag, k_table, p_table):
    """Log-log interpolation of P onto |k| (0 at k=0), float32 on kmag's device."""
    logk = torch.log(torch.clamp(kmag, min=1e-30))
    xp = torch.log(torch.as_tensor(k_table, dtype=torch.float32, device=kmag.device))
    fp = torch.log(torch.clamp(torch.as_tensor(p_table, dtype=torch.float32, device=kmag.device),
                               min=1e-30))
    return torch.where(kmag > 0, torch.exp(_interp(logk, xp, fp)), 0.0)


def _colour_noise(noise, boxsize: float, k_table, p_table, fixed_amplitude: bool = False):
    """delta(x) with power spectrum P(k) from an (n, n, n) white-noise field."""
    n = noise.shape[0]
    kx, ky, kz = k_axes(n, boxsize, noise.device)
    pk = _interp_pk(torch.sqrt(kx**2 + ky**2 + kz**2), k_table, p_table)

    w = torch.fft.rfftn(noise.float())
    if fixed_amplitude:
        mag = w.abs()
        w = torch.where(mag > 0, w / torch.clamp(mag, min=1e-30), 0.0) \
            * (float(n) ** 3 / 2.0) ** 0.5 * 2.0**0.5
    # <|W|^2> = N^3 for rfft of unit white noise; want |delta_k|^2 = P N^6/V.
    dk = w * torch.sqrt(pk * (float(n) ** 3 / boxsize**3))
    del w, pk
    dk[0, 0, 0] = 0.0
    return torch.fft.irfftn(dk, s=(n, n, n)).float()


def gaussian_random_field(generator: torch.Generator, n: int, boxsize: float, k_table, p_table,
                          *, fixed_amplitude: bool = False, device=None):
    """Draw delta(x) with power spectrum P(k).

    Args:
        generator: ``torch.Generator`` on ``device`` (the JAX package's PRNG key).
        n: grid size per axis.
        boxsize: box side [Mpc/h].
        k_table, p_table: tabulated spectrum (e.g. from
            :func:`.linear_pk.eisenstein_hu_pk`).
        fixed_amplitude: "fixed-field" ICs: unit-modulus modes (the variance
            suppressed ensemble trick); phases remain random.
        device: where the field is made (default: the CUDA card).

    Returns:
        (n, n, n) float32 density contrast on ``device``.
    """
    noise = white_noise_field(generator, n, device)
    return _colour_noise(noise, boxsize, k_table, p_table, fixed_amplitude)
