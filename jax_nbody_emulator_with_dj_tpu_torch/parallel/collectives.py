"""Sharded tensors and the three collectives the multi-device layer uses.

The port's counterpart of a sharded JAX array (``ShardedField``) and of
``lax.ppermute``, tiled ``lax.all_to_all`` and ``lax.psum`` inside
``shard_map``.  Every list of per-shard tensors is in row-major shard order
(``mesh.shard_linear_index``); a collective along mesh axis ``axis`` acts
on each ring of shards that differ only in that coordinate.  The entry of a
shard another process owns (``mesh.shard_owner``) is ``None``.

Between two shards of one process a collective is a copy: a peer copy
(``.to(device)``) where the two shards' devices differ, and no copy at all
where they repeat (the receiver's own write, a ``copy_`` or a ``cat``, is
then the plain copy).  Copies stay on each device's current stream, which
orders them; ``non_blocking`` is used only between two CUDA devices
(PyTorch synchronises both devices' current streams around a peer copy).

Between two processes (``distributed.initialize``) a collective call posts
all its messages as one ``torch.distributed.batch_isend_irecv`` on the gloo
group, in one global order that every process walks alike (rings in
:func:`rings` order, then source, then destination), so the messages between
two processes pair up in the order they were posted.  Every message crosses
as the raw bytes of a contiguous host tensor, so bfloat16, float16,
complex64 and int64 cross unchanged: a card's tensor is copied into pinned
host memory and its stream synchronised before the send, and the receiver
uploads what it got to its shard's device.  Gloo's point-to-point ops take
CPU tensors only, so this staging is the transport, not a fallback.  The
receiver knows every message's shape and dtype, because the parts a
collective exchanges along a ring share them.  ``psum`` and ``pmax``
all-gather the shards' partial values and reduce them in shard order, so the
result equals the one-process mesh's bit for bit and is replicated on every
process.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .mesh import REMOTE, Mesh, process_count, process_index, shard_coords, shard_linear_index
from .mesh import shard_owner


def send(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device``: itself where it already lies there, else a copy."""
    device = torch.device(device)
    if t.device == device:
        return t
    return t.to(device, non_blocking=t.is_cuda and device.type == "cuda")


def each(fn, *lists) -> list:
    """``fn`` over the entries of this process's shards; ``None`` for the others'."""
    return [None if xs[0] is None else fn(*xs) for xs in zip(*lists)]


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


@dataclass
class Traffic:
    """What the cross-process collectives of this process moved: bytes it
    sent to and received from other processes, messages, and the wall
    seconds of the collective calls that crossed processes (staging
    included).  Read the difference around a region."""

    bytes_sent: int = 0
    bytes_received: int = 0
    messages: int = 0
    seconds: float = 0.0


traffic = Traffic()


def _owners(parts) -> list:
    """Each shard's owning process; checks that ``parts`` holds exactly this
    process's shards."""
    n, world, rank = len(parts), process_count(), process_index()
    owners = [shard_owner(n, i, world) for i in range(n)]
    for i, (p, o) in enumerate(zip(parts, owners)):
        if (p is None) != (o != rank):
            raise ValueError(f"shard {i} of {n} (process {o}): entry "
                             f"{'None' if p is None else 'set'} in process {rank}")
    return owners


def _host_bytes(t: torch.Tensor) -> torch.Tensor:
    """The raw bytes of ``t`` in host memory: pinned and copied on ``t``'s
    stream when ``t`` is on a card (the caller synchronises before sending)."""
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    if not flat.is_cuda:
        return flat
    host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
    return host.copy_(flat, non_blocking=True)


def _sync_staging(devices):
    """Wait for the copies into pinned host memory on every card in ``devices``."""
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _from_host(host: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    """A tensor of ``dtype`` and ``shape`` from the raw bytes ``host``, on ``device``."""
    t = host.view(dtype).view(shape)
    return t.to(device, non_blocking=host.is_pinned())


class _Exchange:
    """The messages of one collective call that cross processes, posted
    together by :meth:`run`.  Every process walks the call's pairs in the
    same order; the message of the pair (``src``, ``dst``) carries the tag
    ``src * n + dst``, unique within the call."""

    def __init__(self, owners):
        self.owners, self.rank, self.n = owners, process_index(), len(owners)
        self.sends, self.recvs = [], []

    def crosses(self, src: int, dst: int) -> bool:
        return self.owners[src] != self.owners[dst]

    def post(self, src: int, dst: int, t, like, finish):
        """The message of a crossing pair: this process sends ``t`` if it owns
        shard ``src``; if it owns ``dst``, it receives a tensor of ``like``'s
        shape and dtype and hands it, on ``like``'s device, to ``finish``."""
        tag = src * self.n + dst
        if self.owners[src] == self.rank:
            self.sends.append((self.owners[dst], tag, _host_bytes(t), t.device))
        elif self.owners[dst] == self.rank:
            host = torch.empty(like.nbytes, dtype=torch.uint8, pin_memory=like.is_cuda)
            self.recvs.append((self.owners[src], tag, host, like, finish))

    def run(self):
        if not (self.sends or self.recvs):
            return
        t0 = time.perf_counter()
        _sync_staging([d for *_, d in self.sends])
        ops = [dist.P2POp(dist.isend, host, peer, tag=tag) for peer, tag, host, _ in self.sends]
        ops += [dist.P2POp(dist.irecv, host, peer, tag=tag)
                for peer, tag, host, *_ in self.recvs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for _, _, host, like, finish in self.recvs:
            finish(_from_host(host, like.dtype, like.shape, like.device))
        traffic.bytes_sent += sum(h.numel() for _, _, h, _ in self.sends)
        traffic.bytes_received += sum(h.numel() for _, _, h, *_ in self.recvs)
        traffic.messages += len(ops)
        traffic.seconds += time.perf_counter() - t0


def ppermute_shift(parts, mesh_shape, axis: int, shift: int, devices=None) -> list:
    """Each shard receives the tensor of its neighbour ``shift`` places to its
    left along ``axis`` (periodically): ``lax.ppermute`` with the pairs
    ``(i, (i + shift) % n)``.  ``devices`` are the receivers' devices
    (default: each receiver's own entry of ``parts``).  A shard another
    process owns has ``None`` in and out."""
    devices = devices or [None if p is None else p.device for p in parts]
    out = [None] * len(parts)
    ex = _Exchange(_owners(parts))
    for ring in rings(mesh_shape, axis):
        n = len(ring)
        for i, src in enumerate(ring):
            dst = ring[(i + shift) % n]
            if not ex.crosses(src, dst):
                if parts[src] is not None:
                    out[dst] = send(parts[src], devices[dst])
                continue

            def finish(t, dst=dst):
                out[dst] = send(t, devices[dst])

            ex.post(src, dst, parts[src], parts[dst], finish)
    ex.run()
    return out


def all_to_all_tiled(parts, mesh_shape, axis: int, split_axis: int, concat_axis: int) -> list:
    """``lax.all_to_all(..., tiled=True)`` along mesh axis ``axis``: shard i
    splits its tensor along ``split_axis`` into n equal chunks and sends chunk
    j to shard j of its ring; each receiver concatenates the chunks along
    ``concat_axis`` in source order.  A shard another process owns has
    ``None`` in and out."""
    out = [None] * len(parts)
    ex = _Exchange(_owners(parts))
    got = {}  # (dst, source position) -> chunk on dst's device
    for ring in rings(mesh_shape, axis):
        n = len(ring)
        local = [p for p in (parts[s] for s in ring) if p is not None]
        if not local:
            continue  # no message of this ring involves this process
        size = local[0].shape[split_axis]
        if size % n:
            raise ValueError(f"all_to_all: extent {size} along dim {split_axis} does not split "
                             f"into {n}")
        chunks = {src: parts[src].split(size // n, split_axis) for src in ring
                  if parts[src] is not None}
        for i, src in enumerate(ring):
            for j, dst in enumerate(ring):
                if not ex.crosses(src, dst):
                    if parts[src] is not None:
                        got[dst, i] = send(chunks[src][j], parts[dst].device)
                    continue

                def finish(t, key=(dst, i)):
                    got[key] = t

                ex.post(src, dst, chunks[src][j] if src in chunks else None,
                        chunks[dst][i] if dst in chunks else None, finish)
    ex.run()
    for ring in rings(mesh_shape, axis):
        for dst in ring:
            if parts[dst] is not None:
                out[dst] = torch.cat([got[dst, i] for i in range(len(ring))], concat_axis)
    return out


def _all_values(values) -> list:
    """Every shard's partial value, in shard order, on this process's first
    shard's device (an all-gather of the shards' raw bytes across processes)."""
    owners = _owners(values)
    mine = [v for v in values if v is not None]
    dev = mine[0].device
    if process_count() == 1:
        return [send(v, dev) for v in values]
    t0 = time.perf_counter()
    stacked = torch.stack([send(v, dev) for v in mine])
    host = _host_bytes(stacked)
    _sync_staging([dev])
    gathered = [torch.empty_like(host) for _ in range(process_count())]
    dist.all_gather(gathered, host)
    traffic.bytes_sent += host.numel() * (process_count() - 1)
    traffic.bytes_received += host.numel() * (process_count() - 1)
    traffic.messages += 2 * (process_count() - 1)
    traffic.seconds += time.perf_counter() - t0
    blocks = [_from_host(g, stacked.dtype, stacked.shape, dev) for g in gathered]
    per = len(mine)
    return [blocks[o][i - o * per] for i, o in enumerate(owners)]


def psum(values) -> torch.Tensor:
    """The sum of the shards' partial values, added in shard order on this
    process's first shard's device; the same on every process."""
    return functools.reduce(torch.add, _all_values(values))


def pmax(values) -> torch.Tensor:
    """The elementwise max of the shards' partial values (as :func:`psum`):
    the value a check that may raise reads, so every process raises alike."""
    return functools.reduce(torch.maximum, _all_values(values))


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
    row-major shard order, each on its shard's device; the entry of a shard
    another process owns is ``None`` (:meth:`local_indices` lists the others).
    """

    def __init__(self, mesh: Mesh, shape, dims, parts):
        self.mesh = mesh
        self.shape = tuple(int(s) for s in shape)
        self.dims = tuple(dims)
        self.parts = list(parts)
        if len(self.parts) != mesh.size:
            raise ValueError(f"{len(self.parts)} parts for a mesh of {mesh.size} shards")
        local = self.local_shape
        for i, (p, d) in enumerate(zip(self.parts, mesh.devices.flat)):
            if (p is None) != (d == REMOTE):
                raise ValueError(f"part {i}: {'None' if p is None else 'a tensor'} for a shard "
                                 f"on {d}")
            if p is not None and tuple(p.shape) != local:
                raise ValueError(f"part of shape {tuple(p.shape)}, expected {local}")

    @property
    def mesh_shape(self):
        return self.mesh.spatial_shape()

    @property
    def local_shape(self):
        return local_shape(self.shape, self.dims, self.mesh_shape)

    def local_indices(self) -> list:
        """The shards whose parts this process holds."""
        return [i for i, p in enumerate(self.parts) if p is not None]

    @property
    def local_parts(self) -> list:
        return [p for p in self.parts if p is not None]

    @property
    def dtype(self):
        return self.local_parts[0].dtype

    @property
    def devices(self):
        return [None if p is None else p.device for p in self.parts]

    def index(self, i: int) -> tuple:
        """The global index (a tuple of slices) of shard ``i``'s block."""
        return block_index(self.shape, self.dims, self.mesh_shape, i)

    def origin(self, i: int) -> tuple:
        """The global start of shard ``i``'s block along ``dims``."""
        return tuple(self.index(i)[d].start for d in self.dims)

    def pieces(self):
        """``(part, origin)`` for every shard this process holds, the form
        ``science.halos.friends_of_friends_sharded`` reads."""
        return [(self.parts[i], self.origin(i)) for i in self.local_indices()]

    def like(self, parts, shape=None, dims=None) -> ShardedField:
        """A field with this one's mesh (and shape and dims unless given)."""
        return ShardedField(self.mesh, self.shape if shape is None else shape,
                            self.dims if dims is None else dims, parts)

    @classmethod
    def shard(cls, x, mesh: Mesh, dims, dtype=None) -> ShardedField:
        """Split a global array (numpy, or a tensor on any device) into the
        mesh's blocks, each of this process's uploaded to its shard's device
        and then cast to ``dtype`` (a torch dtype) if given."""
        x = as_tensor(x)
        shape, dims = tuple(x.shape), tuple(dims)
        parts = [None if dev == REMOTE else
                 place(x[block_index(shape, dims, mesh.spatial_shape(), i)], dev, dtype)
                 for i, dev in enumerate(mesh.devices.flat)]
        return cls(mesh, shape, dims, parts)

    def gather(self) -> torch.Tensor:
        """The global tensor on the host (for tests and ``as_numpy`` only).
        Raises ``ValueError`` where other processes hold shards, as JAX's
        ``np.asarray`` refuses an array that is not fully addressable."""
        if len(self.local_indices()) != len(self.parts):
            raise ValueError(f"{self} has shards in other processes: write each process's "
                             f"parts (local_indices(), origin(i)) instead of gathering")
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
            return x.like(each(lambda p: p.to(dtype), x.parts))
        return x
    return ShardedField.shard(x, mesh, dims, dtype)
