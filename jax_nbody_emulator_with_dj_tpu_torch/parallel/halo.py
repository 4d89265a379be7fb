"""Periodic halo exchange for spatially sharded volumes.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/parallel/halo.py``: every
shard receives the ``halo``-deep face slabs of its mesh neighbours
(periodically), after which every conv is VALID and the output lands exactly
on the shard's interior.  The port works on the list of every shard's local
tensor (row-major shard order) instead of one shard inside ``shard_map``; the
neighbour shifts are ``collectives.ppermute_shift``, which also carries the
faces between processes.  Only this process's shards are padded (the entries
of the others' are ``None``).  A mesh axis of size 1 degenerates to the
periodic self-wrap, so one code path covers any mesh shape.
"""

from __future__ import annotations

import torch

from .collectives import each, ppermute_shift


def halo_exchange_axis(parts, mesh_shape, halo: int, *, dim: int, axis: int) -> list:
    """Pad one spatial dim of every shard with its periodic neighbours' faces.

    When the shard extent is smaller than the halo the halo spans several
    neighbours: one shift per neighbour distance k, taking the last / first
    ``min(size, halo - (k-1)*size)`` voxels from the neighbour at distance k;
    farther neighbours sit farther out.
    """
    n = mesh_shape[axis]
    size = next(p for p in parts if p is not None).shape[dim]
    if halo > n * size:
        raise ValueError(f"halo {halo} exceeds the global extent {n * size} along dim {dim}")
    hops = -(-halo // size)  # ceil: number of neighbour distances the halo spans
    lo_parts, hi_parts = [], []
    for k in range(1, hops + 1):
        take = min(size, halo - (k - 1) * size)
        lo_face = each(lambda p: p.narrow(dim, size - take, take), parts)
        hi_face = each(lambda p: p.narrow(dim, 0, take), parts)
        if n > 1:  # single shard along this axis: periodic wrap onto itself
            lo_face = ppermute_shift(lo_face, mesh_shape, axis, k)  # from k left
            hi_face = ppermute_shift(hi_face, mesh_shape, axis, -k)  # from k right
        lo_parts.insert(0, lo_face)
        hi_parts.append(hi_face)
    return [None if p is None else
            torch.cat([lo[i] for lo in lo_parts] + [p] + [hi[i] for hi in hi_parts], dim)
            for i, p in enumerate(parts)]


def halo_exchange(parts, mesh_shape, halo: int, *, spatial_dims=(1, 2, 3)) -> list:
    """Periodic halo exchange on all three spatial dims of every shard's block
    (a (C, X, Y, Z) block by default); returns the padded blocks."""
    for axis, dim in enumerate(spatial_dims):
        parts = halo_exchange_axis(parts, mesh_shape, halo, dim=dim, axis=axis)
    return parts
