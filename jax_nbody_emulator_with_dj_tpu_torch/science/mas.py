"""Mass-assignment (particle-mesh deposition) schemes.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/mas.py``: NGP, CIC,
TSC and PCS (worder 1..4) with periodic wrapping, as one ``index_add_`` per
stencil corner on a flat float32 mesh (float32 atomics on the card, so the
mesh varies from run to run in its last bits).  The corners are built and
freed one at a time: at 512^3 particles each int64 index array is 1.07 GB.

Divisions by a constant are written as products with its reciprocal, the
arithmetic XLA compiles for the JAX package.

Conventions: particles start on the grid points of an N^3 Lagrangian grid
and are displaced by psi [Mpc/h]; output is rho/rho_bar on an nmesh^3 grid.
"""

from __future__ import annotations

import numpy as np
import torch

from ._common import fftfreq_int, rfftfreq_int


def _recip(c: float) -> float:
    """1/c as XLA folds it: the float32 reciprocal of the float32 constant."""
    return float(np.float32(1.0) / np.float32(c))


def _kernel_weights(frac, worder: int):
    """1D MAS weights at integer offsets for one fractional coordinate.

    Args:
        frac: (Np,) distance from the particle to the *base* grid point, in
            cell units, in [0, 1).
        worder: 1=NGP (1 pt), 2=CIC (2 pts), 3=TSC (3 pts), 4=PCS (4 pts).

    Returns:
        list of (offset, weight) pairs; weights shape (Np,).
    """
    if worder == 1:
        return [(0, torch.ones_like(frac))]
    d = frac
    if worder == 2:
        return [(0, 1.0 - d), (1, d)]
    if worder == 3:
        return [(0, 0.5 * (1.0 - d) ** 2), (1, 0.75 - (d - 0.5) ** 2), (2, 0.5 * d**2)]
    sixth = _recip(6.0)
    return [
        (0, (1.0 - d) ** 3 * sixth),
        (1, (4.0 - 6.0 * d**2 + 3.0 * d**3) * sixth),
        (2, (4.0 - 6.0 * (1 - d) ** 2 + 3.0 * (1 - d) ** 3) * sixth),
        (3, d**3 * sixth),
    ]


def _base_and_frac(x, worder: int):
    """Base grid index (int64) and fractional distance for each MAS order."""
    if worder == 1:
        return torch.floor(x + 0.5).long(), torch.zeros_like(x)
    if worder in (2, 4):
        fl = torch.floor(x)
        return (fl if worder == 2 else fl - 1).long(), x - fl
    # TSC: centered on nearest grid point
    base = torch.floor(x + 0.5) - 1
    return base.long(), x - base - 0.5  # in [0,1)


def _deposit_axes(coords, nmesh: int, worder: int):
    """rho/rho_bar from three (Np,) float32 coordinate arrays in output-mesh units."""
    if worder not in (1, 2, 3, 4):
        raise ValueError(f"worder {worder} not supported (1..4)")
    n_p = coords[0].numel()
    axes = []
    for x in coords:
        base, frac = _base_and_frac(x, worder)
        axes.append((base, _kernel_weights(frac, worder)))
    (bx, wxs), (by, wys), (bz, wzs) = axes

    mesh = torch.zeros(nmesh**3, dtype=torch.float32, device=coords[0].device)
    for ox, wx in wxs:
        ix = torch.remainder(bx + ox, nmesh)
        for oy, wy in wys:
            ixy = (ix * nmesh + torch.remainder(by + oy, nmesh)) * nmesh
            wxy = wx * wy
            for oz, wz in wzs:
                flat = ixy + torch.remainder(bz + oz, nmesh)
                mesh.index_add_(0, flat, wxy * wz)
                del flat
            del ixy, wxy
        del ix
    return mesh.view(nmesh, nmesh, nmesh) * _recip(n_p / float(nmesh**3))


def deposit(positions, nmesh: int, worder: int = 2):
    """Deposit unit-mass particles onto a periodic mesh.

    Args:
        positions: (Np, 3) tensor in grid units of the *output* mesh
            ([0, nmesh)); the mesh is made on its device.
        nmesh: output mesh size.
        worder: MAS order (1..4).

    Returns:
        rho/rho_bar: (nmesh, nmesh, nmesh) float32.
    """
    pos = torch.as_tensor(positions).float()
    return _deposit_axes(tuple(pos[:, d].contiguous() for d in range(3)), nmesh, worder)


def deposit_displacement(psi, boxsize: float, nmesh: int | None = None, worder: int = 2):
    """rho/rho_bar of an N^3 Lagrangian grid displaced by psi (3, N, N, N)."""
    psi = torch.as_tensor(psi).float()
    n = psi.shape[1]
    nmesh = nmesh or n
    # Lagrangian positions on the FFT grid (x_i = i * L/N), matching where
    # delta/psi are sampled: MAS weights are defined about grid points.
    q = torch.arange(n, dtype=torch.float32, device=psi.device) * (boxsize / n)
    qs = (q[:, None, None], q[None, :, None], q[None, None, :])
    coords = tuple(torch.remainder((qs[d] + psi[d]).reshape(-1) * _recip(boxsize / nmesh), nmesh)
                   for d in range(3))
    return _deposit_axes(coords, nmesh, worder)


def mas_window(n: int, worder: int, device=None):
    """Fourier-space MAS window W(k) on the rfftn grid (product of sincs),
    float32 on ``device`` (default: the CPU; callers pass their field's)."""
    def sinc(v):
        x = np.pi * v / n
        big = x.abs() > 1e-12
        return torch.where(big, torch.sin(x) / torch.where(big, x, 1.0), 1.0)

    wx = sinc(fftfreq_int(n, device)) ** worder
    wz = sinc(rfftfreq_int(n, device)) ** worder
    return wx[:, None, None] * wx[None, :, None] * wz[None, None, :]


def deconvolve_mas(delta, worder: int):
    """Divide out the MAS window in Fourier space."""
    delta = torch.as_tensor(delta).float()
    dk = torch.fft.rfftn(delta)
    dk /= torch.clamp(mas_window(delta.shape[0], worder, delta.device), min=1e-8)
    return torch.fft.irfftn(dk, s=tuple(delta.shape)).float()
