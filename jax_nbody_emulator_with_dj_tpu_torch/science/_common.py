"""Fourier grids and host conversion shared by the science modules."""

from __future__ import annotations

import numpy as np
import torch


def to_numpy(x, dtype=None) -> np.ndarray:
    """A tensor on any device (bfloat16 widened to float32), or anything numpy
    takes, as a numpy array of ``dtype`` (no copy where none is needed)."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        x = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x, dtype)


def fftfreq_int(n: int, device) -> torch.Tensor:
    """numpy's ``fftfreq(n, d=1/n)`` (integer frequencies) as float32 on ``device``."""
    return torch.fft.ifftshift(torch.arange(-(n // 2), (n + 1) // 2, device=device)).float()


def rfftfreq_int(n: int, device) -> torch.Tensor:
    """numpy's ``rfftfreq(n, d=1/n)`` as float32 on ``device``."""
    return torch.arange(n // 2 + 1, device=device).float()


def k_axes(n: int, boxsize: float, device, full: bool = False):
    """(kx, ky, kz) in h/Mpc, broadcastable over the rfftn grid (the full fftn
    grid with ``full``): kx (n,1,1), ky (1,n,1), kz (1,1,n//2+1 or n)."""
    kf = 2 * np.pi / boxsize
    kx = fftfreq_int(n, device) * kf
    kz = kx if full else rfftfreq_int(n, device) * kf
    return kx[:, None, None], kx[None, :, None], kz[None, None, :]


def k_squared(n: int, boxsize: float, device, full: bool = False) -> torch.Tensor:
    kx, ky, kz = k_axes(n, boxsize, device, full)
    return kx**2 + ky**2 + kz**2
