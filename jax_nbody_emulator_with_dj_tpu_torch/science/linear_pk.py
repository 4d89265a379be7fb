"""Linear matter power spectrum: Eisenstein & Hu (1998) transfer function.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/linear_pk.py``.  The
tables are small (hundreds of k), so they are computed on the host with numpy
in float64 and handed to the device functions, which cast them to float32.
The JAX package computes them in float32 (x64 off); the two agree to ~1e-6
relative.  External (e.g. CLASS) tables can be supplied anywhere a ``(k, P)``
table is accepted.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ._common import to_numpy

T_CMB = 2.7255  # K


def trapezoid(y, x) -> float:
    """Trapezoidal integral of ``y`` over the samples ``x`` (numpy's ``trapezoid``,
    which older numpy names ``trapz``)."""
    return float(np.add.reduce(np.diff(x) * (y[1:] + y[:-1]) / 2.0))


def eh98_transfer(k_hmpc, Om: float, Ob: float, h: float):
    """EH98 (with BAO) transfer function T(k); k in h/Mpc (float64 numpy)."""
    k = to_numpy(k_hmpc, np.float64) * h  # 1/Mpc
    theta = T_CMB / 2.7
    om = Om * h * h
    ob = Ob * h * h
    oc = om - ob
    fb, fc = ob / om, oc / om

    z_eq = 2.50e4 * om / theta**4
    k_eq = 7.46e-2 * om / theta**2  # 1/Mpc
    b1 = 0.313 * om**-0.419 * (1 + 0.607 * om**0.674)
    b2 = 0.238 * om**0.223
    z_d = 1291.0 * om**0.251 / (1 + 0.659 * om**0.828) * (1 + b1 * ob**b2)

    def R_of(z):
        return 31.5 * ob / theta**4 * (1e3 / z)

    R_d = R_of(z_d)
    R_eq = R_of(z_eq)
    s = (
        2.0
        / (3.0 * k_eq)
        * np.sqrt(6.0 / R_eq)
        * np.log((np.sqrt(1 + R_d) + np.sqrt(R_d + R_eq)) / (1 + np.sqrt(R_eq)))
    )
    k_silk = 1.6 * ob**0.52 * om**0.73 * (1 + (10.4 * om) ** -0.95)

    q = k / (13.41 * k_eq)

    # CDM piece
    a1 = (46.9 * om) ** 0.670 * (1 + (32.1 * om) ** -0.532)
    a2 = (12.0 * om) ** 0.424 * (1 + (45.0 * om) ** -0.582)
    alpha_c = a1 ** (-fb) * a2 ** (-(fb**3))
    b1c = 0.944 / (1 + (458.0 * om) ** -0.708)
    b2c = (0.395 * om) ** -0.0266
    beta_c = 1.0 / (1 + b1c * (fc**b2c - 1))

    def T0(q, alpha, beta):
        C = 14.2 / alpha + 386.0 / (1 + 69.9 * q**1.08)
        L = np.log(np.e + 1.8 * beta * q)
        return L / (L + C * q * q)

    ks = k * s
    f = 1.0 / (1 + (ks / 5.4) ** 4)
    Tc = f * T0(q, 1.0, beta_c) + (1 - f) * T0(q, alpha_c, beta_c)

    # Baryon piece
    y = (1 + z_eq) / (1 + z_d)
    Gy = y * (-6 * np.sqrt(1 + y) + (2 + 3 * y) * np.log((np.sqrt(1 + y) + 1) / (np.sqrt(1 + y) - 1)))
    alpha_b = 2.07 * k_eq * s * (1 + R_d) ** -0.75 * Gy
    beta_b = 0.5 + fb + (3 - 2 * fb) * np.sqrt((17.2 * om) ** 2 + 1)
    beta_node = 8.41 * om**0.435
    s_tilde = s / (1 + (beta_node / np.maximum(ks, 1e-12)) ** 3) ** (1.0 / 3.0)
    x = k * s_tilde
    sinc = np.where(x > 1e-8, np.sin(x) / np.maximum(x, 1e-12), 1.0)
    Tb = (
        T0(q, 1.0, 1.0) / (1 + (ks / 5.2) ** 2)
        + alpha_b / (1 + (beta_b / np.maximum(ks, 1e-12)) ** 3) * np.exp(-((k / k_silk) ** 1.4))
    ) * sinc
    return fb * Tb + fc * Tc


def _sigma_integrand_weights(k, pk, r):
    x = k * r
    w = 3.0 * (np.sin(x) - x * np.cos(x)) / np.maximum(x, 1e-12) ** 3
    w = np.where(x < 1e-4, 1.0 - x**2 / 10.0, w)
    return k**2 * pk * w**2 / (2 * np.pi**2)


def sigma_r(k, pk, r: float = 8.0) -> float:
    """RMS density fluctuation in a top-hat of radius r [Mpc/h]."""
    k = to_numpy(k, np.float64)
    return float(np.sqrt(trapezoid(_sigma_integrand_weights(k, to_numpy(pk, np.float64), r), k)))


def normalize_sigma8(k, pk_shape, sigma8: float) -> np.ndarray:
    """Rescale a P(k) shape so sigma(R=8 Mpc/h) == sigma8."""
    return to_numpy(pk_shape, np.float64) * (sigma8 / sigma_r(k, pk_shape, 8.0)) ** 2


def eisenstein_hu_pk(
    k_hmpc,
    Om: float = 0.3175,
    Ob: float = 0.049,
    h: float = 0.6711,
    ns: float = 0.9624,
    sigma8: float = 0.834,
) -> np.ndarray:
    """Linear z=0 matter P(k) [(Mpc/h)^3] at wavenumbers k [h/Mpc], float64 numpy.

    Defaults are the Quijote fiducial cosmology, sigma8-normalized.
    """
    k_hmpc = to_numpy(k_hmpc, np.float64)
    # Normalize on a fixed wide grid, then evaluate at requested k.
    kn = np.logspace(-4, 2.5, 1024)
    shape_n = kn**ns * eh98_transfer(kn, Om, Ob, h) ** 2
    amp = (sigma8 / sigma_r(kn, shape_n, 8.0)) ** 2
    return amp * k_hmpc**ns * eh98_transfer(k_hmpc, Om, Ob, h) ** 2


def pk_table(boxsize: float, n: int, **cosmo):
    """(k, P) table covering a box's k range (fundamental..sqrt(3)*Nyquist)."""
    kf = 2 * np.pi / boxsize
    kny = kf * (n // 2)
    k = np.logspace(np.log10(kf * 0.5), np.log10(kny * 2.0), 512)
    return k, eisenstein_hu_pk(k, **cosmo)


def load_pk_table(path):
    """Load an external linear P(k) table (k [h/Mpc], P [(Mpc/h)^3]).

    Accepts the two-column text format of CLASS ``.dat`` tables (comment
    lines ignored, first two numeric columns = k, P; ``.csv`` comma
    separated) and ``.npy`` / ``.npz`` arrays of shape (2, N) or (N, 2)
    (an ``.npz`` with ``k`` and ``P`` or ``pk`` keys, or its first array).

    Returns:
        (k, P) as float64 numpy arrays, ascending in k.
    """
    path = Path(path)
    if path.suffix == ".npz":
        with np.load(path) as f:
            if "k" in f and ("P" in f or "pk" in f):
                arr = np.stack([f["k"], f["P" if "P" in f else "pk"]])
            else:
                arr = f[f.files[0]]
    elif path.suffix == ".npy":
        arr = np.load(path)
    else:  # text (CLASS .dat, .txt, .csv)
        delim = "," if path.suffix == ".csv" else None
        arr = np.loadtxt(path, comments=["#", "%"], delimiter=delim)
    arr = np.asarray(arr, np.float64)
    if arr.ndim != 2:
        raise ValueError(f"P(k) table {path} must be 2-D, got shape {arr.shape}")
    if arr.shape[0] != 2 and arr.shape[1] >= 2:
        arr = arr.T  # (N, cols) -> (cols, N)
    k, p = arr[0], arr[1]
    if k.size < 2 or np.any(k <= 0) or np.any(p < 0):
        raise ValueError(f"invalid P(k) table in {path}")
    order = np.argsort(k)
    return k[order], p[order]
