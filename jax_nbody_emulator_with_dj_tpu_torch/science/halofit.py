"""Halofit nonlinear matter power spectrum (Takahashi et al. 2012).

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/halofit.py`` (host
numpy, float64): the revised halofit fitting formulas (arXiv:1208.2701) on
top of any linear spectrum table; flat-LCDM (w = -1).
"""

from __future__ import annotations

import numpy as np

from ..cosmology import growth_factor
from .linear_pk import trapezoid


def _halofit_quantities(k, pk_lin):
    """Solve for k_sigma (sigma_G(1/k_sigma)=1), n_eff, curvature C."""
    lnk = np.log(k)

    def sigma2(lnr):
        r = np.exp(lnr)
        y = k * r
        return trapezoid(pk_lin * k**3 / (2 * np.pi**2) * np.exp(-(y**2)), lnk)

    # bisection for sigma^2(R) = 1
    lo, hi = np.log(1e-4), np.log(1e2)
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if sigma2(mid) > 1.0:
            lo = mid
        else:
            hi = mid
    lnr = 0.5 * (lo + hi)
    r = np.exp(lnr)

    # log-derivatives by finite differences in ln R (robust and simple)
    eps = 0.01
    s0 = np.log(sigma2(lnr))
    sp = np.log(sigma2(lnr + eps))
    sm = np.log(sigma2(lnr - eps))
    d1 = (sp - sm) / (2 * eps)
    d2 = (sp - 2 * s0 + sm) / eps**2
    n_eff = -3.0 - d1
    curv = -d2
    return 1.0 / r, n_eff, curv


def halofit_pk(k, pk_lin_z0, Om: float, z: float = 0.0):
    """Nonlinear P(k) at redshift z from a z=0 linear spectrum.

    Args:
        k: wavenumbers [h/Mpc] (monotone).
        pk_lin_z0: linear z=0 P(k) [(Mpc/h)^3] at those k.
        Om: matter density.
        z: output redshift.

    Returns:
        nonlinear P(k) [(Mpc/h)^3] at z.
    """
    k = np.asarray(k, np.float64)
    d = float(growth_factor(z, Om))
    pk_lin = np.asarray(pk_lin_z0, np.float64) * d**2

    ksig, n, c = _halofit_quantities(k, pk_lin)

    # Omega_m(z), Omega_L(z) for flat LCDM
    ez2 = Om * (1 + z) ** 3 + (1 - Om)
    omz = Om * (1 + z) ** 3 / ez2
    olz = (1 - Om) / ez2

    # Takahashi et al. 2012 parameters (w = -1)
    an = 10 ** (
        1.5222 + 2.8553 * n + 2.3706 * n**2 + 0.9903 * n**3 + 0.2250 * n**4
        - 0.6038 * c
    )
    bn = 10 ** (-0.5642 + 0.5864 * n + 0.5716 * n**2 - 1.5474 * c)
    cn = 10 ** (0.3698 + 2.0404 * n + 0.8161 * n**2 + 0.5869 * c)
    gamma = 0.1971 - 0.0843 * n + 0.8460 * c
    alpha = abs(6.0835 + 1.3373 * n - 0.1959 * n**2 - 5.5274 * c)
    beta = (
        2.0379 - 0.7354 * n + 0.3157 * n**2 + 1.2490 * n**3 + 0.3980 * n**4
        - 0.1682 * c
    )
    mu = 0.0
    nu = 10 ** (5.2105 + 3.6902 * n)

    f1 = omz ** -0.0307
    f2 = omz ** -0.0585
    f3 = omz ** 0.0743

    y = k / ksig
    d2lin = pk_lin * k**3 / (2 * np.pi**2)

    # two-halo (quasi-linear)
    fy = y / 4.0 + y**2 / 8.0
    d2q = d2lin * ((1 + d2lin) ** beta / (1 + alpha * d2lin)) * np.exp(-fy)

    # one-halo
    d2h_prime = an * y ** (3 * f1) / (1 + bn * y**f2 + (cn * f3 * y) ** (3 - gamma))
    d2h = d2h_prime / (1 + mu / y + nu / y**2)

    d2nl = d2q + d2h
    return d2nl * (2 * np.pi**2) / k**3
