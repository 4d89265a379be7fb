"""First-order Lagrangian perturbation theory (Zel'dovich).

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/lpt.py``:

    psi_k = i k / k^2  delta_k          (Zel'dovich displacement)
    delta_NL(x) = deposit(q + psi) - 1  (PM/MAS density of displaced grid)

The emulator consumes psi normalized at z=0 (growth applied in-model via Dz).
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import k_axes
from .mas import deconvolve_mas, deposit_displacement


def zeldovich_displacement(delta, boxsize: float):
    """1LPT displacement field from a linear density contrast.

    Args:
        delta: (N, N, N) linear density contrast (z=0 normalization).
        boxsize: box side [Mpc/h].

    Returns:
        psi: (3, N, N, N) displacement [Mpc/h], float32, on delta's device.
    """
    delta = torch.as_tensor(delta).float()
    n = delta.shape[0]
    kvec = k_axes(n, boxsize, delta.device)
    k2 = kvec[0] ** 2 + kvec[1] ** 2 + kvec[2] ** 2
    # Odd spectral derivatives at the Nyquist plane are sign-ambiguous (which
    # mirror stores the mode is a convention of the half grid), and the
    # canonical choice is to zero the ik numerator there: the result is then
    # Hermitian in the self-conjugate planes, which cuFFT's complex-to-real
    # transform assumes (it answers otherwise than pocketfft for a
    # non-Hermitian input).  k^2 keeps the Nyquist magnitude.
    nyq = n // 2 * (2 * np.pi / boxsize)
    kd = tuple(torch.where(k.abs() == nyq, 0.0, k) for k in kvec)
    inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    dk = torch.fft.rfftn(delta)
    psi = torch.empty((3, n, n, n), dtype=torch.float32, device=delta.device)
    for d in range(3):
        psi[d] = torch.fft.irfftn(dk * (1j * (kd[d] * inv_k2)), s=(n, n, n))
    return psi


def displacement_to_density(psi, boxsize: float, nmesh: int | None = None, worder: int = 2,
                            deconvolve: bool = True):
    """Density contrast of grid particles displaced by psi.

    Args:
        psi: (3, N, N, N) displacement [Mpc/h].
        boxsize: box side [Mpc/h].
        nmesh: output mesh size (default: particle grid size N).
        worder: MAS order (1=NGP, 2=CIC, 3=TSC, 4=PCS).
        deconvolve: divide out the MAS window in Fourier space.
    """
    delta = deposit_displacement(psi, boxsize, nmesh=nmesh, worder=worder)
    delta -= 1.0
    if deconvolve:
        delta = deconvolve_mas(delta, worder)
    return delta
