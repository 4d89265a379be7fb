"""Sharded tensors and the three collectives the multi-device layer uses.

The port's counterpart of a sharded JAX array (``ShardedField``) and of
``lax.ppermute``, tiled ``lax.all_to_all`` and ``lax.psum`` inside
``shard_map``.  One process holds every shard, so each collective is a copy
between per-shard tensors: a peer copy (``.to(device)``) where the two shards'
devices differ, and no copy at all where they repeat (the receiver's own
write, a ``copy_`` or a ``cat``, is then the plain copy).  Copies stay on
each device's current stream, which orders them; ``non_blocking`` is used
only between two CUDA devices (PyTorch synchronises both devices' current
streams around a peer copy).

Every list of per-shard tensors is in row-major shard order
(``mesh.shard_linear_index``); a collective along mesh axis ``axis`` acts
on each ring of shards that differ only in that coordinate.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, shard_coords, shard_linear_index


def send(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: itself where it already lies there, else a copy."""
    device = torch.device(device)
    if t.device == device:
        return t
    return t.to(device, non_blocking=t.is_cuda and device.type == "cuda")


def rings(mesh_shape, axis: int) -> list:
    """The linear indices of each ring of shards along mesh axis ``axis``
    (coordinate 0 .. mesh_shape[axis]-1 in order)."""
    out = []
    others = [range(s) if a != axis else range(1) for a, s in enumerate(mesh_shape)]
    for base in np.ndindex(*[len(r) for r in others]):
        ring = []
        for c in range(mesh_shape[axis]):
            coords = list(base)
            coords[axis] = c
            ring.append(shard_linear_index(mesh_shape, coords))
        out.append(ring)
    return out


def ppermute_shift(parts, mesh_shape, axis: int, shift: int, devices=None) -> list:
    """Each shard receives the tensor of its neighbour ``shift`` places to its
    left along ``axis`` (periodically): ``lax.ppermute`` with the pairs
    ``(i, (i + shift) % n)``.  ``devices`` are the receivers' devices
    (default: each receiver's own entry of ``parts``)."""
    devices = devices or [p.device for p in parts]
    out = [None] * len(parts)
    for ring in rings(mesh_shape, axis):
        n = len(ring)
        for i, src in enumerate(ring):
            dst = ring[(i + shift) % n]
            out[dst] = send(parts[src], devices[dst])
    return out


def all_to_all_tiled(parts, mesh_shape, axis: int, split_axis: int, concat_axis: int) -> list:
    """``lax.all_to_all(..., tiled=True)`` along mesh axis ``axis``: shard i
    splits its tensor along ``split_axis`` into n equal chunks and sends chunk
    j to shard j of its ring; each receiver concatenates the chunks along
    ``concat_axis`` in source order."""
    out = [None] * len(parts)
    for ring in rings(mesh_shape, axis):
        n = len(ring)
        size = parts[ring[0]].shape[split_axis]
        if size % n:
            raise ValueError(f"all_to_all: extent {size} along dim {split_axis} does not split "
                             f"into {n}")
        chunks = [parts[src].split(size // n, split_axis) for src in ring]
        for j, dst in enumerate(ring):
            dev = parts[dst].device
            out[dst] = torch.cat([send(chunks[i][j], dev) for i in range(n)], concat_axis)
    return out


def psum(values) -> torch.Tensor:
    """The sum of the shards' partial values, on the first shard's device."""
    total = values[0]
    for v in values[1:]:
        total = total + send(v, total.device)
    return total


def as_tensor(x) -> torch.Tensor:
    """A tensor as it is, or a numpy array (or anything numpy takes) as a CPU
    tensor sharing its memory."""
    return x if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))


def place(block: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """``block`` uploaded to ``device``, then cast to ``dtype`` if given (one
    rounding, on the device); never a view of the caller's memory."""
    out = block.to(device)
    if dtype is not None and out.dtype != dtype:
        return out.to(dtype)
    if out.untyped_storage().data_ptr() == block.untyped_storage().data_ptr():
        return out.clone(memory_format=torch.contiguous_format)
    return out


def local_shape(shape, dims, mesh_shape) -> tuple:
    """The block shape of a global ``shape`` split along ``dims`` over ``mesh_shape``."""
    local = list(shape)
    for d, m in zip(dims, mesh_shape):
        if local[d] % m:
            raise ValueError(f"shape {tuple(shape)} not divisible by mesh {tuple(mesh_shape)}")
        local[d] //= m
    return tuple(local)


def block_index(shape, dims, mesh_shape, i: int) -> tuple:
    """The global index (a tuple of slices) of shard ``i``'s block."""
    local = local_shape(shape, dims, mesh_shape)
    sl = [slice(None)] * len(shape)
    for d, c in zip(dims, shard_coords(mesh_shape)[i]):
        sl[d] = slice(c * local[d], (c + 1) * local[d])
    return tuple(sl)


class ShardedField:
    """A global tensor of ``shape`` held as per-shard blocks on ``mesh``.

    ``dims`` are the three tensor dims split over the mesh's spatial axes
    (``(0, 1, 2)`` for an (N, N, N) field, ``(1, 2, 3)`` for a (C, X, Y, Z)
    box); every other dim is whole on each shard.  ``parts`` are the blocks in
    row-major shard order, each on its shard's device.
    """

    def __init__(self, mesh: Mesh, shape, dims, parts):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.dims = tuple(dims)
        self.parts = list(parts)
        if len(self.parts) != mesh.size:
            raise ValueError(f"{len(self.parts)} parts for a mesh of {mesh.size} shards")
        local = self.local_shape
        for p in self.parts:
            if tuple(p.shape) != local:
                raise ValueError(f"part of shape {tuple(p.shape)}, expected {local}")

    @property
    def mesh_shape(self):
        return self.mesh.spatial_shape()

    @property
    def local_shape(self):
        return local_shape(self.shape, self.dims, self.mesh_shape)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def devices(self):
        return [p.device for p in self.parts]

    def index(self, i: int) -> tuple:
        """The global index (a tuple of slices) of shard ``i``'s block."""
        return block_index(self.shape, self.dims, self.mesh_shape, i)

    def origin(self, i: int) -> tuple:
        """The global start of shard ``i``'s block along ``dims``."""
        return tuple(self.index(i)[d].start for d in self.dims)

    def pieces(self):
        """``(part, origin)`` for every shard, the form ``science.halos.
        friends_of_friends_sharded`` reads."""
        return [(p, self.origin(i)) for i, p in enumerate(self.parts)]

    def like(self, parts, shape=None, dims=None) -> ShardedField:
        """A field with this one's mesh (and shape and dims unless given)."""
        return ShardedField(self.mesh, self.shape if shape is None else shape,
                            self.dims if dims is None else dims, parts)

    @classmethod
    def shard(cls, x, mesh: Mesh, dims, dtype=None) -> ShardedField:
        """Split a global array (numpy, or a tensor on any device) into the
        mesh's blocks, each uploaded to its shard's device and then cast to
        ``dtype`` (a torch dtype) if given."""
        x = as_tensor(x)
        shape, dims = tuple(x.shape), tuple(dims)
        parts = [place(x[block_index(shape, dims, mesh.spatial_shape(), i)], dev, dtype)
                 for i, dev in enumerate(mesh.devices.flat)]
        return cls(mesh, shape, dims, parts)

    def gather(self) -> torch.Tensor:
        """The global tensor on the host (for tests and ``as_numpy`` only)."""
        out = torch.empty(self.shape, dtype=self.dtype)
        for i, p in enumerate(self.parts):
            out[self.index(i)] = p.cpu()
        return out

    def numpy(self) -> np.ndarray:
        t = self.gather()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def __repr__(self):
        return (f"ShardedField(shape={self.shape}, dims={self.dims}, mesh={self.mesh_shape}, "
                f"dtype={self.dtype})")


def as_sharded(x, mesh: Mesh, dims, dtype=None) -> ShardedField:
    """``x`` as a field on ``mesh`` split along ``dims``: a ``ShardedField``
    already laid out so is returned as it is (cast to ``dtype`` if given);
    any other array is sharded.  A field on another mesh raises."""
    if isinstance(x, ShardedField):
        same = (x.mesh is mesh or (x.mesh.devices.shape == mesh.devices.shape
                                   and list(x.mesh.devices.flat) == list(mesh.devices.flat)))
        if not same or x.dims != tuple(dims):
            raise ValueError(f"{x} is not laid out on this mesh along dims {tuple(dims)}")
        if dtype is not None and x.dtype != dtype:
            return x.like([p.to(dtype) for p in x.parts])
        return x
    return ShardedField.shard(x, mesh, dims, dtype)
