"""Flat-LambdaCDM background cosmology, evaluated on the host in float64.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/cosmology.py``.  Every value
here is a per-box scalar (the growth factor that scales the input, the
velocity normalization of the head), so it is computed with numpy and
``scipy.special.hyp2f1`` rather than on the device: torch has no ``hyp2f1``.

The Gauss hypergeometric function keeps the JAX package's branch split: for
the physical ``x < 0`` domain it is evaluated through the Pfaff transform
(the series only converges for ``|x| < 1``).  Derivatives that JAX takes with
a forward-mode JVP are written out analytically.

All functions are elementwise over broadcastable ``z`` and ``Om`` and return
float64 numpy arrays (0-d for scalar inputs).
"""

from __future__ import annotations

import numpy as np
from scipy.special import hyp2f1

__all__ = [
    "growth_factor",
    "growth_d_approx",
    "hubble_rate",
    "growth_rate",
    "dlogD_dz",
    "dlogH_dz",
    "dlogH_dloga",
    "vel_norm",
    "acc_norm",
]

# D(a) \propto a * 2F1(1, 1/3; 11/6; -OL a^3 / Om)
_A, _B, _C = 1.0, 1.0 / 3.0, 11.0 / 6.0


def _growth_hyp(x):
    """(2F1(1, 1/3; 11/6; x), d/dx of it) for x in (-inf, 1).

    For x < 0, Pfaff: 2F1(a, b; c; x) = (1-x)^-a 2F1(a, c-b; c; x/(x-1)),
    which maps the argument into (0, 1).
    """
    x = np.asarray(x, np.float64)
    neg = x < 0
    xn = np.where(neg, x, -0.5)
    xp = np.where(neg, 0.0, x)
    # Pfaff branch and its derivative (chain rule through zz = x/(x-1)).
    zz = xn / (xn - 1.0)
    g = hyp2f1(_A, _C - _B, _C, zz)
    dg = _A * (_C - _B) / _C * hyp2f1(_A + 1.0, _C - _B + 1.0, _C + 1.0, zz)
    f_neg = (1.0 - xn) ** (-_A) * g
    df_neg = _A * (1.0 - xn) ** (-_A - 1.0) * g + (1.0 - xn) ** (-_A) * dg * (
        -1.0 / (xn - 1.0) ** 2
    )
    f_pos = hyp2f1(_A, _B, _C, xp)
    df_pos = _A * _B / _C * hyp2f1(_A + 1.0, _B + 1.0, _C + 1.0, xp)
    return np.where(neg, f_neg, f_pos), np.where(neg, df_neg, df_pos)


def _za(z, Om):
    z = np.asarray(z, np.float64)
    Om = np.asarray(Om, np.float64)
    return z, Om, 1.0 / (1.0 + z), -(1.0 - Om) / Om


def growth_factor(z, Om):
    """Linear growth factor D(z), normalized so D(0) = 1."""
    z, Om, a, ratio = _za(z, Om)
    return a * _growth_hyp(ratio * a**3)[0] / _growth_hyp(ratio)[0]


def hubble_rate(z, Om):
    """Hubble rate H(z) in h km/s/Mpc for flat LCDM."""
    z = np.asarray(z, np.float64)
    Om = np.asarray(Om, np.float64)
    return 100.0 * np.sqrt(Om * (1.0 + z) ** 3 + (1.0 - Om))


def growth_rate(z, Om):
    """Linear growth rate f = d log D / d log a.

    With D = a F(x) / F(ratio), x = ratio a^3:  f = 1 + 3 x F'(x) / F(x).
    """
    z, Om, a, ratio = _za(z, Om)
    x = ratio * a**3
    f, df = _growth_hyp(x)
    return 1.0 + 3.0 * x * df / f


def dlogH_dloga(z, Om):
    """d log H / d log a = -(1+z) d log H / dz."""
    z = np.asarray(z, np.float64)
    Om = np.asarray(Om, np.float64)
    e2 = Om * (1.0 + z) ** 3 + (1.0 - Om)
    return -(1.0 + z) * 1.5 * Om * (1.0 + z) ** 2 / e2


def dlogD_dz(z, Om):
    """d log D / dz = -f / (1+z)."""
    z = np.asarray(z, np.float64)
    return -growth_rate(z, Om) / (1.0 + z)


def dlogH_dz(z, Om):
    """d log H / dz = -(d log H / d log a) / (1+z)."""
    z = np.asarray(z, np.float64)
    return -dlogH_dloga(z, Om) / (1.0 + z)


def vel_norm(z, Om):
    """Velocity normalization D(z) f(z) H(z) / (1+z)  [km/s]."""
    z = np.asarray(z, np.float64)
    return growth_factor(z, Om) * growth_rate(z, Om) * hubble_rate(z, Om) / (1.0 + z)


def acc_norm(z, Om):
    """Acceleration normalization D f H^2 dlogH/dloga / (1+z)  [km/s^2]."""
    z = np.asarray(z, np.float64)
    return (growth_factor(z, Om) * growth_rate(z, Om) * hubble_rate(z, Om) ** 2
            * dlogH_dloga(z, Om) / (1.0 + z))


def growth_d_approx(Om, z):
    """Carroll-Press-Turner (1992) closed-form growth-factor fit.

    Returns the *unnormalized* growth (a * g(a) with the CPT fitting function):
    only ratios ``growth_d_approx(Om, z1) / growth_d_approx(Om, z2)`` are
    meaningful.  Workflows that compare with Quijote use it to rescale z=127
    initial conditions to z=0; the package's own pipelines rescale with the
    exact ``growth_factor`` ratio (the fit is good to ~1e-3).  Note the
    argument order: ``(Om, z)``.
    """
    Om = np.asarray(Om, np.float64)
    zp1 = 1.0 + np.asarray(z, np.float64)
    ol0 = 1.0 - Om
    e2 = ol0 + Om * zp1**3  # H^2/H0^2 (flat LCDM, matter + Lambda)
    om_z = Om * zp1**3 / e2
    ol_z = ol0 / e2
    g = 2.5 * om_z / (om_z ** (4.0 / 7.0) - ol_z + (1.0 + 0.5 * om_z) * (1.0 + ol_z / 70.0))
    return g / zp1
