"""Field resizing: mode-injection upsampling and block downsampling.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/resize.py``:
conditional GRF refinement embeds the coarse grid's Fourier modes (rescaled
by (Nout/Nin)^3) inside the coarse Nyquist sphere and draws the missing
high-k modes as a Gaussian realization of a target P(k) (from a
``torch.Generator``; ``_upsample_modes_from_noise`` is the deterministic
core); downsampling is block averaging (optionally after Gaussian smoothing).
The full-cube transforms stay complex ``fftn``/``ifftn`` + real part, as in
the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import k_squared
from .grf import _interp_pk, white_noise_field


def _axis_map(n_in: int, n_out: int):
    """Frequency index map (src, dst, weight) for one full FFT axis.

    Even n_in: frequencies |f| < n_in/2 map directly; the coarse Nyquist
    f = n_in/2 (self-conjugate in the coarse grid) splits half-half onto
    +-n_in/2 in the fine grid, preserving Hermitian symmetry and total
    power.  Odd n_in has no self-conjugate Nyquist: every mode maps
    directly with weight 1.
    """
    h = n_in // 2
    if n_in % 2:
        src = np.arange(n_in)
        dst = np.concatenate([np.arange(h + 1), np.arange(n_out - h, n_out)])
        return src, dst, np.ones(n_in)
    src = list(range(0, h)) + [h, h] + list(range(h + 1, n_in))
    dst = (
        list(range(0, h))
        + [h, n_out - h]
        + [n_out - (n_in - f) for f in range(h + 1, n_in)]
    )
    wgt = [1.0] * h + [0.5, 0.5] + [1.0] * (n_in - h - 1)
    return np.asarray(src), np.asarray(dst), np.asarray(wgt)


def _embed_coarse_modes(delta_coarse, n_out: int, scale: float):
    """Full-FFT embedding of a coarse field's modes into an n_out grid.

    Returns the fine fftn spectrum (complex, full cube) containing exactly
    the coarse field's information (band-limited interpolation), with proper
    Nyquist-plane splitting on all three axes.
    """
    delta_coarse = torch.as_tensor(delta_coarse).float()
    dev = delta_coarse.device
    dk_c = torch.fft.fftn(delta_coarse) * scale
    sx, dx_, wx = (torch.as_tensor(a, device=dev) for a in _axis_map(delta_coarse.shape[0], n_out))
    wx = wx.float()
    dk_out = torch.zeros((n_out,) * 3, dtype=dk_c.dtype, device=dev)
    w = wx[:, None, None] * wx[None, :, None] * wx[None, None, :]
    dk_out[dx_[:, None, None], dx_[None, :, None], dx_[None, None, :]] = \
        dk_c[sx[:, None, None], sx[None, :, None], sx[None, None, :]] * w
    return dk_out


def _upsample_modes_from_noise(delta, noise, n_out: int, boxsize: float, k_table, p_table):
    """``upsample_modes`` given the (n_out,)^3 white-noise field of the new modes."""
    n_in = delta.shape[0]
    dk_low = _embed_coarse_modes(delta, n_out, (n_out / n_in) ** 3)  # full fftn cube
    kmag = torch.sqrt(k_squared(n_out, boxsize, noise.device, full=True))
    low_mask = kmag <= 2 * np.pi / boxsize * (n_in // 2)
    pk = _interp_pk(kmag, k_table, p_table)
    # fftn of real white noise is Hermitian with <|W|^2> = N^3; the target is
    # |delta_k|^2 = P N^6 / V.
    dk_high = torch.fft.fftn(noise.float()) * torch.sqrt(pk * (float(n_out) ** 3 / boxsize**3))
    dk = torch.where(low_mask, dk_low, dk_high)
    del dk_low, dk_high
    dk[0, 0, 0] = 0.0
    return torch.fft.ifftn(dk).real.float()


def upsample_modes(delta, n_out: int, boxsize: float, k_table, p_table,
                   generator: torch.Generator | None = None):
    """Conditional-GRF upsampling: keep coarse modes, inject new high-k power.

    Args:
        delta: (N_in,)^3 field (tensor; the result is made on its device).
        n_out: output grid size (multiple of N_in).
        boxsize: box side [Mpc/h].
        k_table, p_table: target spectrum for the injected modes.
        generator: ``torch.Generator`` on delta's device for the new
            small-scale modes (None: one seeded with 0).

    Returns:
        (N_out,)^3 float32 field whose low-k modes equal the input's exactly
        and whose k > k_nyq(coarse) modes are a fresh Gaussian realization of
        the target spectrum.
    """
    delta = torch.as_tensor(delta)
    n_in = delta.shape[0]
    if n_out % n_in:
        raise ValueError(f"n_out {n_out} must be a multiple of n_in {n_in}")
    if generator is None:
        generator = torch.Generator(device=delta.device).manual_seed(0)
    noise = white_noise_field(generator, n_out, delta.device)
    return _upsample_modes_from_noise(delta, noise, n_out, boxsize, k_table, p_table)


def upsample_fourier(delta, n_out: int):
    """Band-limited (Fourier zero-padding) upsampling: no new power.

    Exact sinc interpolation of the existing modes; k > k_nyq(coarse) stays
    empty.
    """
    delta = torch.as_tensor(delta)
    n_in = delta.shape[0]
    if n_out % n_in:
        raise ValueError(f"n_out {n_out} must be a multiple of n_in {n_in}")
    if n_out == n_in:
        return delta
    dk = _embed_coarse_modes(delta, n_out, (n_out / n_in) ** 3)
    return torch.fft.ifftn(dk).real.float()


def upsample_linear(delta, n_out: int):
    """Periodic trilinear interpolation upsampling.

    Output grid point ``j * L/n_out`` interpolates the input at
    ``j * n_in/n_out`` input cells with periodic wrap.  Cheaper than
    :func:`upsample_fourier` (no FFT) but damps high-k power.
    """
    delta = torch.as_tensor(delta)
    n_in = delta.shape[0]
    if n_out % n_in:
        raise ValueError(f"n_out {n_out} must be a multiple of n_in {n_in}")
    if n_out == n_in:
        return delta
    d = delta.float()
    x = torch.arange(n_out, dtype=torch.float32, device=d.device) * (n_in / n_out)
    i0 = torch.floor(x).long()
    frac = x - torch.floor(x)
    i1 = torch.remainder(i0 + 1, n_in)
    out = torch.zeros((n_out,) * 3, dtype=torch.float32, device=d.device)
    for cx, wx in ((i0, 1.0 - frac), (i1, frac)):
        for cy, wy in ((i0, 1.0 - frac), (i1, frac)):
            for cz, wz in ((i0, 1.0 - frac), (i1, frac)):
                out += (d[cx][:, cy][:, :, cz] * wx[:, None, None] * wy[None, :, None]
                        * wz[None, None, :])
    return out


def downsample_average(delta, n_out: int):
    """Block-average downsampling."""
    delta = torch.as_tensor(delta)
    n_in = delta.shape[0]
    if n_in % n_out:
        raise ValueError(f"n_in {n_in} must be a multiple of n_out {n_out}")
    f = n_in // n_out
    return delta.reshape(n_out, f, n_out, f, n_out, f).mean(dim=(1, 3, 5))


def gaussian_smooth(delta, boxsize: float, r_smooth: float):
    """Isotropic Gaussian smoothing in Fourier space."""
    delta = torch.as_tensor(delta).float()
    k2 = k_squared(delta.shape[0], boxsize, delta.device)
    dk = torch.fft.rfftn(delta) * torch.exp(-0.5 * k2 * r_smooth**2)
    return torch.fft.irfftn(dk, s=tuple(delta.shape)).float()


def resize_density_grid(delta, n_out: int, boxsize: float, k_table=None, p_table=None,
                        generator: torch.Generator | None = None, r_smooth: float | None = None):
    """Unified resize: up via mode injection, down via (optionally smoothed)
    block averaging, identity when equal."""
    delta = torch.as_tensor(delta)
    n_in = delta.shape[0]
    if n_out == n_in:
        return delta
    if n_out > n_in:
        if k_table is None or p_table is None:
            raise ValueError("upsampling requires a target (k_table, p_table)")
        return upsample_modes(delta, n_out, boxsize, k_table, p_table, generator)
    if r_smooth:
        delta = gaussian_smooth(delta, boxsize, r_smooth)
    return downsample_average(delta, n_out)
