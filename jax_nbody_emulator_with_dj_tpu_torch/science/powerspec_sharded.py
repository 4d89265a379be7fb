"""Power spectra of spatially sharded fields, with no gather.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/powerspec_sharded.py``:
the single-device estimators (``powerspec.py``) need the whole field on one
device; here the field stays block-sharded over the 3D mesh
(``parallel.mesh.SPATIAL_AXES``).

  * **Pencil-decomposed 3D FFT**: for each axis in turn, a tiled all-to-all
    over that mesh axis makes the axis whole on every shard (splitting
    another axis deeper), a local ``torch.fft.fft`` transforms it, and the
    inverse all-to-all restores the block sharding; after the three cycles
    each shard holds its block ``[ix*N/mx :, iy*N/my :, iz*N/mz :]`` of the
    full complex spectrum (6 all-to-alls per transform).
  * **Shard-local shell sums, summed over the shards**: each shard bins
    |delta_k|^2 over its own global k indices (every mode counted once: the
    full complex transform needs no Hermitian weights) with ``index_add_`` in
    float64, as ``powerspec._shell_average`` does; the shards' partial sums
    are added (``collectives.psum``) and rounded once to float32.

The binned results are float32 tensors on the first device of this
process's shards.  In a multi-process run (``parallel.distributed.
initialize``) each process transforms and bins its own shards, the
all-to-alls and sums cross processes (``parallel.collectives``), and every
process gets the same spectrum, equal to the one-process mesh's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import all_to_all_tiled, as_sharded, each, psum
from ..parallel.mesh import shard_coords
from .powerspec import _bin_edges


def _check_geometry(n: int, mesh_shape):
    mx, my, mz = mesh_shape
    for name, num, den in (
        ("N/mx % mz", n // mx, mz),
        ("N/mx % my", n // mx, my),
        ("N/my % mx", n // my, mx),
        ("N % mx", n, mx),
        ("N % my", n, my),
        ("N % mz", n, mz),
    ):
        if num % den:
            raise ValueError(f"sharded FFT needs {name} == 0 (N={n}, mesh={tuple(mesh_shape)})")


def _pencil(parts, mesh_shape, transform):
    """``transform`` (``torch.fft.fft`` or ``ifft``) along each axis of the
    block-sharded complex blocks ``parts``: z (splitting axis 0 deeper), y
    (axis 0), x (axis 1), each between a tiled all-to-all and its inverse."""
    for axis, dim, other in ((2, 2, 0), (1, 1, 0), (0, 0, 1)):
        if mesh_shape[axis] > 1:
            parts = all_to_all_tiled(parts, mesh_shape, axis, split_axis=other, concat_axis=dim)
        parts = each(lambda p: transform(p, dim=dim), parts)
        if mesh_shape[axis] > 1:
            parts = all_to_all_tiled(parts, mesh_shape, axis, split_axis=dim, concat_axis=other)
    return parts


def _fft3_local(parts, mesh_shape):
    """Full 3D complex FFT of a block-sharded field (complex64 blocks out)."""
    return _pencil(each(lambda p: p.to(torch.complex64), parts), mesh_shape, torch.fft.fft)


def _ifft3_local(parts, mesh_shape):
    """Inverse of :func:`_fft3_local` (same pencil cycles)."""
    return _pencil(parts, mesh_shape, torch.fft.ifft)


def _local_kvec(n: int, boxsize: float, mesh_shape, coords, device):
    """Per-axis physical wavenumbers (1D, float32) of the shard at ``coords``:
    its global block of the full (non-rfft) k grid (fftfreq semantics)."""
    kf = 2.0 * np.pi / boxsize
    out = []
    for c, m in zip(coords, mesh_shape):
        i = c * (n // m) + torch.arange(n // m, device=device)
        out.append(torch.where(i < (n + 1) // 2, i, i - n).float() * kf)
    return tuple(out)


def _local_kmag(n: int, boxsize: float, mesh_shape, coords, device):
    """|k| of the shard at ``coords``'s block of the full k grid."""
    kx, ky, kz = _local_kvec(n, boxsize, mesh_shape, coords, device)
    return torch.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2 + kz[None, None, :] ** 2)


def _bin_local(kmags, quantities, edges, nbins: int):
    """Per-shard float64 shell sums, added over the shards, rounded once to
    float32: (shell-mean |k|, shell-mean quantity, counts) on this process's
    first device."""

    def sums_of(kmag, q):
        e = edges.to(kmag.device)
        kflat = kmag.reshape(-1)
        idx = (torch.searchsorted(e, kflat) - 1).clamp_(0, nbins - 1)
        w = ((kflat >= e[0]) & (kflat < e[-1])).double()
        sums = torch.zeros((3, nbins), dtype=torch.float64, device=kmag.device)
        for row, v in enumerate((w, w * kflat.double(), w * q.reshape(-1).double())):
            sums[row].index_add_(0, idx, v)
        return sums

    counts, ksum, qsum = psum(each(sums_of, kmags, quantities)).float()
    counts = torch.clamp(counts, min=1e-30)
    return ksum / counts, qsum / counts, counts


def _binned_spectrum(fields, mesh, boxsize: float, nbins, cross: bool):
    n = fields[0].shape[0]
    mesh_shape = mesh.spatial_shape()
    _check_geometry(n, mesh_shape)
    fields = [as_sharded(f, mesh, (0, 1, 2)) for f in fields]
    nbins = nbins or n // 2
    edges = _bin_edges(n, boxsize, nbins, fields[0].local_parts[0].device)
    specs = [_fft3_local(each(lambda p: p.float(), f.parts), mesh_shape) for f in fields]
    norm = boxsize**3 / float(n) ** 6
    if cross:
        q = each(lambda a, b: (a.real * b.real + a.imag * b.imag) * norm, *specs)
    else:
        q = each(lambda a: (a.real**2 + a.imag**2) * norm, specs[0])
    del specs
    kmags = each(lambda p, c: _local_kmag(n, boxsize, mesh_shape, c, p.device), q,
                 shard_coords(mesh_shape))
    return _bin_local(kmags, q, edges, nbins)


def power_spectrum_sharded(delta, mesh, boxsize: float, nbins=None):
    """Auto P(k) of a mesh-sharded periodic density field.

    Args:
        delta: (N, N, N) field: a ``ShardedField`` on ``mesh`` (stays
            sharded) or any array (sharded over ``mesh``).
        mesh: 3D spatial mesh.
        boxsize: box side [Mpc/h].
        nbins: number of k shells (default N/2).

    Returns:
        (k, Pk, Nmodes), float32 tensors on this process's first device,
        matching ``science.powerspec.power_spectrum`` up to float reordering
        (the same on every process of a multi-process run).
    """
    return _binned_spectrum((delta,), mesh, boxsize, nbins, cross=False)


def cross_power_sharded(delta_a, delta_b, mesh, boxsize: float, nbins=None):
    """Cross power Re<delta_a delta_b*> of two mesh-sharded fields."""
    return _binned_spectrum((delta_a, delta_b), mesh, boxsize, nbins, cross=True)


def transfer_and_correlation_sharded(delta_model, delta_target, mesh, boxsize: float,
                                     nbins=None):
    """Sharded T(k) = sqrt(P_m/P_t) and C(k) = P_x/sqrt(P_m P_t)."""
    k, p_m, _ = power_spectrum_sharded(delta_model, mesh, boxsize, nbins)
    _, p_t, _ = power_spectrum_sharded(delta_target, mesh, boxsize, nbins)
    _, p_x, _ = cross_power_sharded(delta_model, delta_target, mesh, boxsize, nbins)
    t = torch.sqrt(torch.clamp(p_m, min=1e-30) / torch.clamp(p_t, min=1e-30))
    c = p_x / torch.sqrt(torch.clamp(p_m * p_t, min=1e-60))
    return k, t, c


def _moments(a, b) -> dict:
    """Field moments of two sharded fields from per-shard float64 sums (two
    passes: the means, then the central moments); nothing is gathered."""
    count = float(np.prod(a.shape))
    pa, pb = each(lambda p: p.double(), a.parts), each(lambda p: p.double(), b.parts)
    ma = float(psum(each(lambda p: p.sum(), pa))) / count
    mb = float(psum(each(lambda p: p.sum(), pb))) / count

    def mean_of(fn):
        return float(psum(each(lambda x, y: fn(x, y).sum(), pa, pb))) / count

    sa = mean_of(lambda x, y: (x - ma) ** 2) ** 0.5
    sb = mean_of(lambda x, y: (y - mb) ** 2) ** 0.5
    cov = mean_of(lambda x, y: (x - ma) * (y - mb))
    return {
        "rmse": mean_of(lambda x, y: (x - y) ** 2) ** 0.5,
        "pearson_r": cov / max(sa * sb, 1e-30),
        "mean_model": ma,
        "mean_target": mb,
        "std_model": sa,
        "std_target": sb,
        "skew_model": mean_of(lambda x, y: (x - ma) ** 3) / max(sa**3, 1e-30),
        "skew_target": mean_of(lambda x, y: (y - mb) ** 3) / max(sb**3, 1e-30),
    }


def summary_metrics_sharded(delta_model, delta_target, mesh, boxsize: float,
                            kmax: float | None = None) -> dict:
    """On-mesh counterpart of ``powerspec.summary_metrics``: the same scalar
    dict with the fields left sharded (moments from per-shard float64 sums,
    spectra from the pencil FFT estimators)."""
    a, b = (as_sharded(f, mesh, (0, 1, 2)) for f in (delta_model, delta_target))
    mom = _moments(a, b)
    k, t, c = (v.cpu().numpy() for v in transfer_and_correlation_sharded(a, b, mesh, boxsize))
    sel = np.ones_like(k, bool) if kmax is None else (k <= kmax)
    mom.update({
        "median_abs_T_minus_1": float(np.median(np.abs(t[sel] - 1.0))),
        "max_abs_T_minus_1": float(np.max(np.abs(t[sel] - 1.0))),
        "mean_1_minus_C": float(np.mean(1.0 - c[sel])),
    })
    return mom
