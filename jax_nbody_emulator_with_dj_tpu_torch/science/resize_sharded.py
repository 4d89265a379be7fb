"""Field resizing on the mesh: mode-injection and Fourier upsampling,
Gaussian smoothing, block downsampling.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/resize_sharded.py``
(of ``resize.py`` for volumes sharded over the 3D mesh): refine a coarse IC
to the production grid without ever gathering the fine volume.

The *coarse* field is replicated, one copy of its spectrum per distinct
device (it is coarse by definition); only the fine volume is sharded.  Each
shard builds its block of the fine spectrum by gathering from the coarse
spectrum through the inverse of the single-device ``_axis_map`` (the coarse
Nyquist's half-half split included), and the injected high-k modes come from
per-shard white noise pushed through the pencil FFT, globally Hermitian
because the noise is real in configuration space.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import ShardedField, as_sharded
from ..parallel.mesh import shard_coords
from .field_sharded import _white_blocks
from .grf import _interp_pk
from .powerspec_sharded import _check_geometry, _fft3_local, _ifft3_local, _local_kmag, _local_kvec


def _axis_src_w(dglob, n_in: int, n_out: int):
    """Inverse of ``resize._axis_map``: coarse source index and weight for
    each fine (full-FFT) frequency index; weight 0 marks injected modes."""
    h = n_in // 2
    if n_in % 2:
        # odd n_in: no self-conjugate Nyquist, every mode maps directly
        lo = dglob <= h
        hi = dglob >= n_out - h
        src = torch.where(lo, dglob, torch.where(hi, dglob - (n_out - n_in), 0))
        return src, (lo | hi).float()
    src = torch.zeros_like(dglob)
    w = torch.zeros(dglob.shape, dtype=torch.float32, device=dglob.device)
    lo = dglob < h
    src = torch.where(lo, dglob, src)
    w = torch.where(lo, 1.0, w)
    for d_nyq in (h, n_out - h):
        ny = dglob == d_nyq
        src = torch.where(ny, h, src)
        w = torch.where(ny, 0.5, w)
    hi = dglob >= n_out - h + 1
    src = torch.where(hi, dglob - (n_out - n_in), src)
    w = torch.where(hi, 1.0, w)
    return src, w


def upsample_modes_sharded(delta_coarse, n_out: int, mesh, boxsize: float, k_table=None,
                           p_table=None, generator: torch.Generator | None = None,
                           white=None) -> ShardedField:
    """Conditional-GRF upsampling with the fine volume sharded.

    On-mesh counterpart of ``resize.upsample_modes``: the output's modes
    inside the coarse Nyquist sphere equal the (replicated) input's exactly;
    modes outside are a fresh Gaussian realization of the target spectrum.
    With ``k_table is None`` this is pure band-limited Fourier upsampling
    (``resize.upsample_fourier``).

    Args:
        delta_coarse: (n_in,)^3 field (numpy or a tensor; must fit a device).
        n_out: fine grid size (a strict multiple of n_in), sharded over ``mesh``.
        generator: for the injected modes; each shard draws from its own
            generator derived from it (``field_sharded.shard_generators``;
            None: a generator seeded with 0).
        white: optional (n_out,)^3 white noise to colour instead of drawing
            (equality tests).

    Returns an (n_out,)^3 float32 ``ShardedField``.
    """
    n_in = delta_coarse.shape[0]
    if n_out % n_in or n_out <= n_in:
        raise ValueError(f"n_out {n_out} must be a strict multiple of n_in {n_in}")
    mesh_shape = mesh.spatial_shape()
    _check_geometry(n_out, mesh_shape)
    local = tuple(n_out // m for m in mesh_shape)
    inject = k_table is not None
    if inject and p_table is None:
        raise ValueError("k_table given without p_table")

    coarse = torch.as_tensor(np.asarray(delta_coarse) if not torch.is_tensor(delta_coarse)
                             else delta_coarse).float()
    scale = (n_out / n_in) ** 3
    dk_c = {d: torch.fft.fftn(coarse.to(d)) * scale for d in mesh.distinct_devices()}
    k_nyq_coarse = 2 * np.pi / boxsize * (n_in // 2)
    if inject:
        if white is not None:
            noise = [p.float() for p in as_sharded(white, mesh, (0, 1, 2)).parts]
        else:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            noise = _white_blocks(generator, mesh, local)
        wk = _fft3_local(noise, mesh_shape)
        del noise
    dk = []
    for i, (c, dev) in enumerate(zip(shard_coords(mesh_shape), mesh.devices.flat)):
        idx = [c[d] * local[d] + torch.arange(local[d], device=dev) for d in range(3)]
        sw = [_axis_src_w(v, n_in, n_out) for v in idx]
        low = dk_c[dev][sw[0][0]][:, sw[1][0]][:, :, sw[2][0]]
        blk = low * (sw[0][1][:, None, None] * sw[1][1][None, :, None] * sw[2][1][None, None, :])
        if inject:
            kmag = _local_kmag(n_out, boxsize, mesh_shape, c, dev)
            amp = torch.sqrt(_interp_pk(kmag, k_table, p_table) * (float(n_out) ** 3 / boxsize**3))
            blk = torch.where(kmag <= k_nyq_coarse, blk, wk[i] * amp)
            wk[i] = None
            if all(v == 0 for v in c):  # single-device upsample_modes zeroes the DC (mean) mode
                blk[0, 0, 0] = 0.0
        dk.append(blk)
    del dk_c
    return ShardedField(mesh, (n_out,) * 3, (0, 1, 2),
                        [x.real.float() for x in _ifft3_local(dk, mesh_shape)])


def upsample_fourier_sharded(delta_coarse, n_out: int, mesh) -> ShardedField:
    """Band-limited (sinc) upsampling on the mesh: no new power (counterpart
    of ``resize.upsample_fourier``)."""
    if n_out == delta_coarse.shape[0]:
        return as_sharded(delta_coarse, mesh, (0, 1, 2))
    return upsample_modes_sharded(delta_coarse, n_out, mesh, boxsize=1.0)


def downsample_average_sharded(delta, n_out: int, mesh) -> ShardedField:
    """Block-average downsampling of a sharded field (stays sharded)."""
    n_in = delta.shape[0]
    if n_in % n_out:
        raise ValueError(f"n_in {n_in} must be a multiple of n_out {n_out}")
    f = n_in // n_out
    mesh_shape = mesh.spatial_shape()
    for m in mesh_shape:
        if n_in % m or (n_in // m) % f or n_out % m:
            raise ValueError(f"block factor {f} must divide the local extent "
                             f"{n_in}/{tuple(mesh_shape)}")
    delta = as_sharded(delta, mesh, (0, 1, 2))
    parts = []
    for p in delta.parts:
        l0, l1, l2 = p.shape
        parts.append(p.reshape(l0 // f, f, l1 // f, f, l2 // f, f).mean(dim=(1, 3, 5)))
    return ShardedField(mesh, (n_out,) * 3, (0, 1, 2), parts)


def gaussian_smooth_sharded(delta, mesh, boxsize: float, r_smooth: float) -> ShardedField:
    """Isotropic Gaussian smoothing in Fourier space, on the mesh
    (counterpart of ``resize.gaussian_smooth``)."""
    delta = as_sharded(delta, mesh, (0, 1, 2))
    n = delta.shape[0]
    mesh_shape = mesh.spatial_shape()
    _check_geometry(n, mesh_shape)
    dk = _fft3_local([p.float() for p in delta.parts], mesh_shape)
    for i, c in enumerate(shard_coords(mesh_shape)):
        kx, ky, kz = _local_kvec(n, boxsize, mesh_shape, c, dk[i].device)
        k2 = kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2
        dk[i] = dk[i] * torch.exp(-0.5 * k2 * r_smooth**2)
    return delta.like([x.real.float() for x in _ifft3_local(dk, mesh_shape)])
