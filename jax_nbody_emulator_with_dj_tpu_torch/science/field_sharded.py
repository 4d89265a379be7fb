"""Field generation on the mesh: GRF initial conditions, Zel'dovich 1LPT and
mass deposition for spatially sharded volumes.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/field_sharded.py``.
With ``powerspec_sharded`` this completes the sharded pipeline with no gather
anywhere: IC generation -> 1LPT displacement -> emulation
(``parallel.ShardedHierarchicalProcessor``) -> density deposition ->
P(k)/T(k)/C(k), every stage leaving the volume sharded over the 3D mesh.  The
single-device counterparts (``grf.py``, ``lpt.py``, ``mas.py``) define the
semantics.

Spectral pieces use the pencil FFT of ``powerspec_sharded``.  Deposition is
the classic distributed particle-mesh scatter: each shard deposits its own
Lagrangian block's particles onto a ``margin``-padded local grid (one
``index_add_`` per stencil corner, int64 indices, positions and weights as
``mas.py`` computes them, so the density equals the single-device one up to
the order of the float32 additions), then a
**halo reduce**, the reverse of the runtime's halo exchange, ships each pad
slab to the neighbour that owns those cells and adds it into that
neighbour's interior (one shift pair per sharded axis; taking the axes in
turn over the still-padded remaining axes routes corner mass through two
hops).
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import ShardedField, as_sharded, ppermute_shift
from ..parallel.mesh import shard_coords
from .grf import _interp_pk
from .mas import _base_and_frac, _kernel_weights, _recip
from .powerspec_sharded import _check_geometry, _fft3_local, _ifft3_local, _local_kmag, _local_kvec


def shard_generators(generator: torch.Generator, mesh) -> list:
    """One ``torch.Generator`` per shard, on the shard's device, seeded from
    ``generator.initial_seed()`` and the shard's row-major linear index
    (``parallel.mesh.shard_linear_index``) through ``numpy.random.SeedSequence``:
    the port's counterpart of ``fold_in(key, shard_linear_index)``.  The
    streams differ from shard to shard and from the single-device draw."""
    seed = generator.initial_seed()
    out = []
    for i, dev in enumerate(mesh.devices.flat):
        state = np.random.SeedSequence([seed, i]).generate_state(2, np.uint32)
        out.append(torch.Generator(device=dev).manual_seed(
            (int(state[0]) << 32 | int(state[1])) >> 1))
    return out


def _white_blocks(generator, mesh, local) -> list:
    """Per-shard unit white noise of shape ``local`` from :func:`shard_generators`."""
    return [torch.randn(local, generator=g, device=dev, dtype=torch.float32)
            for g, dev in zip(shard_generators(generator, mesh), mesh.devices.flat)]


def gaussian_random_field_sharded(generator, n: int, mesh, boxsize: float, k_table, p_table, *,
                                  white=None, fixed_amplitude: bool = False) -> ShardedField:
    """Mesh-sharded delta(x) with power spectrum P(k).

    On-mesh counterpart of ``grf.gaussian_random_field``: real white noise is
    coloured in Fourier space by sqrt(P N^3 / V).  By default each shard draws
    its own block from its own generator (:func:`shard_generators`, derived
    from ``generator.initial_seed()`` and the shard's linear index): another
    (equally white) realization than the single-device draw.  ``white`` (an
    (n, n, n) field, sharded or not) colours given noise instead; the output
    then equals the single-device function on that noise up to float
    reordering.

    Returns an (n, n, n) float32 ``ShardedField``.
    """
    mesh_shape = mesh.spatial_shape()
    _check_geometry(n, mesh_shape)
    if white is None:
        w = _white_blocks(generator, mesh, tuple(n // m for m in mesh_shape))
    else:
        w = [p.float() for p in as_sharded(white, mesh, (0, 1, 2)).parts]
    wk = _fft3_local(w, mesh_shape)
    del w
    out = []
    for i, c in enumerate(shard_coords(mesh_shape)):
        if fixed_amplitude:
            # unit-modulus modes (the variance-suppressed "fixed" ICs): |W| -> sqrt(N^3)
            mag = wk[i].abs()
            wk[i] = torch.where(mag > 0, wk[i] / torch.clamp(mag, min=1e-30), 0.0) \
                * float(n) ** 1.5
        kmag = _local_kmag(n, boxsize, mesh_shape, c, wk[i].device)
        # amp is 0 at k=0 (_interp_pk zeroes kmag == 0), so no DC to clear
        wk[i] = wk[i] * torch.sqrt(_interp_pk(kmag, k_table, p_table) * (float(n) ** 3 / boxsize**3))
    out = [x.real.float() for x in _ifft3_local(wk, mesh_shape)]
    return ShardedField(mesh, (n, n, n), (0, 1, 2), out)


def zeldovich_displacement_sharded(delta, mesh, boxsize: float) -> ShardedField:
    """1LPT displacement of a mesh-sharded linear density contrast.

    On-mesh counterpart of ``lpt.zeldovich_displacement`` (psi_k = i k / k^2
    delta_k, the ik numerator zeroed on the Nyquist planes): one forward and
    three inverse pencil FFTs.  Returns a (3, n, n, n) float32 ``ShardedField``.
    """
    delta = as_sharded(delta, mesh, (0, 1, 2))
    n = delta.shape[0]
    mesh_shape = mesh.spatial_shape()
    _check_geometry(n, mesh_shape)
    dk = _fft3_local([p.float() for p in delta.parts], mesh_shape)
    nyq = n // 2 * (2.0 * np.pi / boxsize)
    coefs = []
    for c, d in zip(shard_coords(mesh_shape), dk):
        kx, ky, kz = _local_kvec(n, boxsize, mesh_shape, c, d.device)
        k2 = kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2
        inv_k2 = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
        kd = [torch.where(k.abs() == nyq, 0.0, k) for k in (kx, ky, kz)]
        coefs.append((kd[0][:, None, None], kd[1][None, :, None], kd[2][None, None, :], inv_k2))
    psi = [torch.empty((3,) + tuple(d.shape), dtype=torch.float32, device=d.device) for d in dk]
    for axis in range(3):
        comp = _ifft3_local([d * (1j * (cf[axis] * cf[3])) for d, cf in zip(dk, coefs)],
                            mesh_shape)
        for p, x in zip(psi, comp):
            p[axis] = x.real
    return ShardedField(mesh, (3, n, n, n), (1, 2, 3), psi)


def _deposit_local(axes, shape):
    """Scatter-add unit particles onto a local (padded) grid.

    Args:
        axes: per axis, ``(index, taps)``: ``index(offset)`` gives the (Np,)
            int64 local grid index of each particle's tap at ``offset``, and
            ``taps`` the MAS ``(offset, weight)`` pairs.
        shape: local grid shape.
    """
    (ix_of, wxs), (iy_of, wys), (iz_of, wzs) = axes
    grid = torch.zeros(int(np.prod(shape)), dtype=torch.float32, device=wxs[0][1].device)
    for ox, wx in wxs:
        ix = ix_of(ox)
        for oy, wy in wys:
            ixy = (ix * shape[1] + iy_of(oy)) * shape[2]
            wxy = wx * wy
            for oz, wz in wzs:
                flat = ixy + iz_of(oz)
                grid.index_add_(0, flat, wxy * wz)
                del flat
            del ixy, wxy
        del ix
    return grid.view(shape)


def _tap_index(base, q, n: int, start: int, size: int, sharded: bool):
    """``index(offset)``: the local grid index of each particle's tap at
    ``offset`` from its global base cell.  A whole axis wraps periodically; on
    a sharded axis the tap is taken relative to the particle's own Lagrangian
    cell (integer arithmetic, wrapped to the nearer image) and clamped into
    the padded block (the pad must cover every reachable cell; clamping only
    keeps an out-of-margin outlier's mass at the pad edge instead of
    dropping it)."""
    if not sharded:
        return lambda o: torch.remainder(base + o, n)
    rel = base - q  # the tap's offset from the particle's Lagrangian cell, less o
    return lambda o: (q - start + torch.remainder(rel + o + n // 2, n) - n // 2).clamp_(0, size - 1)


def _halo_reduce(grids, mesh_shape, axis: int, margin: int):
    """Add every shard's pad slabs along ``axis`` into the neighbours that own
    those cells (in place)."""
    if mesh_shape[axis] == 1 or margin == 0:
        return
    size = grids[0].shape[axis]
    # my low pad covers my lower neighbour's top interior cells (and vice versa)
    from_upper = ppermute_shift([g.narrow(axis, 0, margin) for g in grids], mesh_shape, axis, -1)
    from_lower = ppermute_shift([g.narrow(axis, size - margin, margin) for g in grids],
                                mesh_shape, axis, 1)
    for g, up, lo in zip(grids, from_upper, from_lower):
        g.narrow(axis, size - 2 * margin, margin).add_(up)
        g.narrow(axis, margin, margin).add_(lo)


def deposit_displacement_sharded(psi, mesh, boxsize: float, worder: int = 2, margin: int = 32,
                                 check_margin: bool = True) -> ShardedField:
    """rho/rho_bar of the displaced Lagrangian grid, on the mesh.

    On-mesh counterpart of ``mas.deposit_displacement`` (output mesh ==
    particle grid).  Each shard deposits its own block's particles onto a
    ``margin``-padded local grid; the pad slabs are then halo-reduced into
    the neighbours that own them.

    Args:
        psi: (3, n, n, n) displacement [Mpc/h], sharded or shardable.
        margin: pad depth in cells per sharded-axis side.  Must cover the
            largest displacement: ``margin >= max|psi| / (boxsize/n) +
            worder``.
        check_margin: check that bound on the host (one small copy per shard).

    Returns an (n, n, n) float32 ``ShardedField`` (mean 1).
    """
    if worder not in (1, 2, 3, 4):
        raise ValueError(f"worder {worder} not supported (1..4)")
    n = psi.shape[1]
    mesh_shape = mesh.spatial_shape()
    for m in mesh_shape:
        if n % m:
            raise ValueError(f"grid {n} not divisible by mesh {mesh_shape}")
    cell = boxsize / n
    psi = as_sharded(psi, mesh, (1, 2, 3))
    if check_margin:
        # Only sharded axes need margin: whole axes wrap periodically (margin
        # 0), so their displacement components are unconstrained.
        comp_max = torch.stack([p.abs().amax(dim=(1, 2, 3)).float().cpu()
                                for p in psi.parts]).amax(0)
        for d in range(3):
            if mesh_shape[d] == 1:
                continue
            need = float(comp_max[d]) / cell + worder
            if need > margin:
                raise ValueError(f"margin {margin} cells < axis-{d} max displacement "
                                 f"{need:.1f} cells; raise margin= (mass would clamp to the pad "
                                 f"edge)")
    local = tuple(n // m for m in mesh_shape)
    margins = tuple(margin if m > 1 else 0 for m in mesh_shape)
    for ln, mg, m in zip(local, margins, mesh_shape):
        if m > 1 and ln < mg:
            raise ValueError(f"local extent {ln} < margin {mg}: single-hop halo reduce needs "
                             f"n/mesh >= margin")
    padded = tuple(ln + 2 * mg for ln, mg in zip(local, margins))
    inv_cell = _recip(cell)
    grids = []
    for c, p in zip(shard_coords(mesh_shape), psi.parts):
        axes = []
        for d in range(3):
            # the particles' global Lagrangian indices and, as ``mas.deposit_displacement``
            # computes it, their wrapped global coordinate in cells: the same base and
            # weights as the single device's deposit
            q = c[d] * local[d] + torch.arange(local[d], device=p.device)
            shape = [1, 1, 1]
            shape[d] = local[d]
            q = q.view(shape).expand(local).reshape(-1)
            x = torch.remainder((q.float().view(-1) * cell + p[d].float().reshape(-1))
                                * inv_cell, n)
            base, frac = _base_and_frac(x, worder)
            del x
            axes.append((_tap_index(base, q, n, c[d] * local[d] - margins[d], padded[d],
                                    margins[d] > 0), _kernel_weights(frac, worder)))
        grids.append(_deposit_local(axes, padded))
        del axes
    for d in range(3):
        _halo_reduce(grids, mesh_shape, d, margins[d])
    out = [g[margins[0]:margins[0] + local[0], margins[1]:margins[1] + local[1],
             margins[2]:margins[2] + local[2]].contiguous() for g in grids]
    return ShardedField(mesh, (n, n, n), (0, 1, 2), out)


def deconvolve_mas_sharded(delta, mesh, worder: int) -> ShardedField:
    """Divide out the MAS window in Fourier space, on the mesh (counterpart
    of ``mas.deconvolve_mas``)."""
    delta = as_sharded(delta, mesh, (0, 1, 2))
    n = delta.shape[0]
    mesh_shape = mesh.spatial_shape()
    _check_geometry(n, mesh_shape)
    dk = _fft3_local([p.float() for p in delta.parts], mesh_shape)

    def sinc_pw(f):
        x = np.pi * f
        big = x.abs() > 1e-12
        return torch.where(big, torch.sin(x) / torch.where(big, x, 1.0), 1.0) ** worder

    for i, c in enumerate(shard_coords(mesh_shape)):
        # the mode number / n: wavenumbers of a box of side 2 pi n
        kx, ky, kz = _local_kvec(n, 2.0 * np.pi * n, mesh_shape, c, dk[i].device)
        w = sinc_pw(kx)[:, None, None] * sinc_pw(ky)[None, :, None] * sinc_pw(kz)[None, None, :]
        dk[i] = dk[i] / torch.clamp(w, min=1e-8)
    return delta.like([x.real.float() for x in _ifft3_local(dk, mesh_shape)])


def displacement_to_density_sharded(psi, mesh, boxsize: float, worder: int = 2,
                                    deconvolve: bool = True, margin: int = 32,
                                    check_margin: bool = True) -> ShardedField:
    """On-mesh counterpart of ``lpt.displacement_to_density`` (nmesh == n):
    deposit the displaced grid, subtract the mean, optionally deconvolve the
    MAS window."""
    rho = deposit_displacement_sharded(psi, mesh, boxsize, worder=worder, margin=margin,
                                       check_margin=check_margin)
    for p in rho.parts:
        p.sub_(1.0)
    return deconvolve_mas_sharded(rho, mesh, worder) if deconvolve else rho
