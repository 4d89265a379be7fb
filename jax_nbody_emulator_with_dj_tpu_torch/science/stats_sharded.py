"""Minkowski functionals and the reduced bispectrum of sharded fields.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/stats_sharded.py``;
with ``powerspec_sharded`` and ``field_sharded`` it completes the sharded
validation suite: every diagnostic runs with the field left block-sharded.

* **Minkowski V0..V3**: the cubical-complex counts need each cell's
  neighbours on the index-1 side only, so one 1-voxel low-side plane per axis
  (shifted from the previous shard, axis after axis so corner slivers route
  themselves) makes every count shard-local.  The counts are int64 on every
  shard and summed exactly over the shards; V0..V3 then come from the global
  counts by the same float32 relations as ``minkowski.py``, so the result
  equals the single-device one.
* **Reduced bispectrum Q(theta)**: the FFT-binned estimator is a handful of
  band-filtered inverse FFTs and global sums: pencil transforms
  (``powerspec_sharded``) and per-shard sums (float64) added over the shards.

In a multi-process run (``parallel.distributed.initialize``) each process
counts and sums its own shards; the planes, the transforms and the sums cross
processes through ``parallel.collectives``, and every process gets the same
result, the one-process mesh's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.collectives import as_sharded, each, ppermute_shift, psum
from ..parallel.mesh import shard_coords
from .minkowski import _functionals
from .powerspec_sharded import _check_geometry, _fft3_local, _ifft3_local, _local_kmag


def _extend_low(parts, mesh_shape):
    """Prepend each axis's global index-1 neighbour plane (periodic) to every block."""
    ext = list(parts)
    for ax, m in enumerate(mesh_shape):
        last = each(lambda e: e.narrow(ax, e.shape[ax] - 1, 1), ext)
        if m > 1:
            last = ppermute_shift(last, mesh_shape, ax, 1)  # my last plane fronts the next shard
        ext = each(lambda lo, e: torch.cat([lo, e], ax), last, ext)
    return ext


def _local_counts(ext, local):
    """Cell counts (n0, n1, n2, n3), int64, of the excursion set ``ext`` (a
    boolean block extended by one low plane per axis) over its interior."""
    def block(o):
        return ext[1 - o[0]:1 - o[0] + local[0], 1 - o[1]:1 - o[1] + local[1],
                   1 - o[2]:1 - o[2] + local[2]]

    b0 = block((0, 0, 0))
    n3 = b0.sum()
    n2 = sum((b0 | block(tuple(int(a == ax) for a in range(3)))).sum() for ax in range(3))
    n1 = 0
    for ax in range(3):
        o1, o2 = [d for d in range(3) if d != ax]
        acc = b0
        for c1, c2 in ((0, 1), (1, 0), (1, 1)):
            o = [0, 0, 0]
            o[o1], o[o2] = c1, c2
            acc = acc | block(tuple(o))
        n1 = n1 + acc.sum()
    acc = b0
    for o in np.ndindex(2, 2, 2):
        if any(o):
            acc = acc | block(o)
    return torch.stack([acc.sum(), n1, n2, n3])


def minkowski_functionals_sharded(delta, thresholds, mesh):
    """V0..V3 of the excursion sets of a mesh-sharded field.

    Returns a (T, 4) float32 tensor on this process's first device, equal to
    ``minkowski.minkowski_functionals`` on the whole field (the global counts
    are exact int64 sums).
    """
    mesh_shape = mesh.spatial_shape()
    for s, m in zip(delta.shape, mesh_shape):
        if s % m:
            raise ValueError(f"grid {tuple(delta.shape)} not divisible by {tuple(mesh_shape)}")
    delta = as_sharded(delta, mesh, (0, 1, 2))
    local = delta.local_shape
    ext = _extend_low(each(lambda p: p.float(), delta.parts), mesh_shape)
    thresholds = torch.as_tensor(thresholds, dtype=torch.float32).reshape(-1)
    rows = []
    for t in thresholds.tolist():
        counts = psum(each(lambda e: _local_counts(e > t, local), ext))
        rows.append(_functionals(*counts.float(), float(np.prod(delta.shape))))
    return torch.stack(rows)


def reduced_bispectrum_sharded(delta, mesh, boxsize: float, k1: float, k2: float, thetas,
                               dk_width: float | None = None) -> dict:
    """Q(theta) for (k1, k2, theta) triangles, on the mesh.

    Same estimator and return dict as ``bispectrum.reduced_bispectrum``
    (full complex transforms; every global sum is per-shard float64 sums
    added over the shards and rounded once to float32).
    """
    delta = as_sharded(delta, mesh, (0, 1, 2))
    n = delta.shape[0]
    mesh_shape = mesh.spatial_shape()
    _check_geometry(n, mesh_shape)
    kf = 2 * np.pi / boxsize
    half = dk_width if dk_width is not None else kf
    v = boxsize**3
    n3_f = float(n) ** 3
    thetas = np.asarray(thetas, np.float64)
    k3s = np.sqrt(k1**2 + k2**2 + 2 * k1 * k2 * np.cos(thetas))
    dk = _fft3_local(each(lambda p: p.float(), delta.parts), mesh_shape)
    kmag = each(lambda d, c: _local_kmag(n, boxsize, mesh_shape, c, d.device), dk,
                shard_coords(mesh_shape))

    def band(kc):
        mask = each(lambda k: ((k >= kc - half) & (k < kc + half)).to(torch.complex64), kmag)
        return (each(lambda x: x.real, _ifft3_local(each(lambda d, m: d * m, dk, mask),
                                                     mesh_shape)),
                each(lambda x: x.real, _ifft3_local(mask, mesh_shape)))

    def gsum(fn, *fields):
        return psum(each(lambda *f: fn(*f).sum(dtype=torch.float64), *fields)).float()

    def pk_of_band(i_f, n_f):
        return v / n3_f * gsum(lambda x: x**2, i_f) / torch.clamp(gsum(lambda x: x**2, n_f),
                                                                  min=1e-30)

    i1, nf1 = band(k1)
    i2, nf2 = band(k2)
    p1, p2 = pk_of_band(i1, nf1), pk_of_band(i2, nf2)
    bs, qs, p3s = [], [], []
    for k3 in k3s:
        i3, nf3 = band(float(k3))
        denom = torch.clamp(gsum(lambda a, b, c: a * b * c, nf1, nf2, nf3), min=1e-30)
        b = (v**2 / n3_f) * gsum(lambda a, b, c: a * b * c, i1, i2, i3) / denom
        p3 = pk_of_band(i3, nf3)
        bs.append(b)
        qs.append(b / torch.clamp(p1 * p2 + p2 * p3 + p3 * p1, min=1e-30))
        p3s.append(p3)
    return {
        "theta": thetas,
        "k3": k3s,
        "B": torch.stack(bs).cpu().numpy(),
        "Q": torch.stack(qs).cpu().numpy(),
        "P1": float(p1),
        "P2": float(p2),
        "P3": torch.stack(p3s).cpu().numpy(),
    }
