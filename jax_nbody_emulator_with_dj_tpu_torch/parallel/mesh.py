"""Device meshes for spatial (domain) decomposition.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/parallel/mesh.py``.  The
emulation domain is a 3D periodic volume whose three spatial axes are sharded
over a 3D logical mesh ('x', 'y', 'z').  The port's mesh is a numpy object
array of ``torch.device`` in the mesh's shape.

A device may repeat in the array: eight shards on ``[torch.device("cuda")] * 8``
are the port's counterpart of XLA's virtual devices, so a (2, 2, 2)
decomposition (its exchanges included) runs on one card, and the CPU tests run
the same code on ``[torch.device("cpu")] * 8``.  A node with several cards runs
it unchanged on ``cuda:0 .. cuda:n-1``.

In a multi-process run (``distributed.initialize``: a ``torch.distributed``
group of ``process_count()`` processes) each process owns a contiguous
row-major block of ``n / process_count()`` shards (:func:`shard_owner`), the
counterpart of a JAX device's ``process_index``.  The device array holds this
process's devices for its own shards and ``torch.device("meta")`` for every
shard another process owns, so a loop that forgets to skip a remote shard
fails at once instead of computing on the wrong device.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

SPATIAL_AXES = ("x", "y", "z")
REMOTE = torch.device("meta")  # the device entry of a shard another process owns


def process_index() -> int:
    """This process's rank in the run (0 without a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes in the run (1 without a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def shard_owner(n_shards: int, i: int, world: int | None = None) -> int:
    """The process that owns shard ``i`` of ``n_shards``: contiguous row-major
    blocks of ``n_shards / world`` shards (``world`` defaults to
    :func:`process_count`)."""
    world = process_count() if world is None else world
    return i // (n_shards // world)


class Mesh:
    """A grid of devices with named axes.

    ``devices`` is the object array of ``torch.device`` (``mesh.devices.flat``
    enumerates the shards in row-major order, the order of every list of
    per-shard tensors in this package); ``shape`` maps each axis name to its
    size, as a JAX mesh's does.  ``process_ids`` (same shape) is each
    shard's owning process (:func:`shard_owner`); a shard another process
    owns has ``REMOTE`` as its device.
    """

    def __init__(self, devices, axis_names=SPATIAL_AXES):
        devices = np.asarray(devices, dtype=object)
        for idx in np.ndindex(*devices.shape):
            devices[idx] = canonical_device(devices[idx])
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D device array needs {devices.ndim} axis names, "
                             f"got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        world = process_count()
        if devices.size % world:
            raise ValueError(f"{devices.size} shards do not split over {world} processes")
        self.process_ids = np.array([shard_owner(devices.size, i, world)
                                     for i in range(devices.size)]).reshape(devices.shape)
        rank = process_index()
        for i, (d, p) in enumerate(zip(devices.flat, self.process_ids.flat)):
            if (d == REMOTE) != (p != rank):
                raise ValueError(f"shard {i} (process {p}) on {d} in process {rank}: a "
                                 f"process's own shards need devices, the others' {REMOTE}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def spatial_shape(self) -> tuple[int, int, int]:
        """Sizes of the spatial axes ``SPATIAL_AXES``, in that order."""
        return tuple(self.shape[a] for a in SPATIAL_AXES)

    def local_indices(self) -> list:
        """The linear indices of the shards this process owns (every shard in
        one process)."""
        return [i for i, d in enumerate(self.devices.flat) if d != REMOTE]

    def distinct_devices(self) -> list:
        """Each device of this process's shards once, in order of first appearance."""
        out = []
        for d in self.devices.flat:
            if d != REMOTE and d not in out:
                out.append(d)
        return out


def canonical_device(device) -> torch.device:
    """``device`` as its tensors report it: ``cuda`` becomes ``cuda:<current>``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def shard_linear_index(mesh_shape, coords) -> int:
    """Row-major linear index of the shard at ``coords`` of the spatial mesh.

    The canonical shard enumeration for per-shard random streams (the GRF,
    the resize noise): one definition so those paths can never desynchronize,
    and the position of the shard in every per-shard list.
    """
    _, my, mz = mesh_shape
    cx, cy, cz = coords
    return (int(cx) * my + int(cy)) * mz + int(cz)


def shard_coords(mesh_shape):
    """Every shard's (cx, cy, cz), in row-major (linear index) order."""
    return list(np.ndindex(*mesh_shape))


def visible_devices() -> list:
    """The CUDA devices this process sees, ``cuda:0 .. cuda:k-1``; raises without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no devices were given and CUDA is not available: the port's meshes default to "
            "the CUDA cards; pass devices=[torch.device('cpu')] * n for virtual CPU shards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(shape=(1, 1, 1), axis_names=SPATIAL_AXES, devices=None) -> Mesh:
    """A 3D spatial mesh over ``devices``, this process's devices (default:
    its visible CUDA cards).

    The process owns ``n / process_count()`` of the mesh's ``n`` shards
    (:func:`shard_owner`) and places them on the first as many ``devices``;
    the other shards get ``REMOTE``.  Raises ``ValueError`` when the shards do
    not split evenly over the processes or the process needs more devices
    than given.  A list that repeats a device places several shards on it
    (virtual shards)."""
    if devices is None:
        devices = visible_devices()
    n = int(np.prod(shape))
    world, rank = process_count(), process_index()
    per = n // world  # Mesh raises where n does not split over the processes
    if per > len(devices):
        need = f"{per} devices a process" if world > 1 else f"{n} devices"
        raise ValueError(f"mesh shape {tuple(shape)} needs {need}, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [REMOTE] * n
    arr[rank * per:(rank + 1) * per] = list(devices[:per])
    return Mesh(arr.reshape(tuple(shape)), axis_names)


def mesh_for_devices(n_devices: int, axis_names=SPATIAL_AXES, devices=None) -> Mesh:
    """A reasonable 3D factorization of ``n_devices`` (largest axis first)."""
    return make_mesh(_factor3(n_devices), axis_names, devices)


def _factor3(n: int) -> tuple[int, int, int]:
    """Factor n into 3 roughly equal factors, descending."""
    best = (n, 1, 1)
    for a in range(1, int(round(n ** (1 / 3))) + 1):
        if n % a:
            continue
        m = n // a
        for b in range(a, int(m**0.5) + 1):
            if m % b:
                continue
            c = m // b
            cand = tuple(sorted((a, b, c), reverse=True))
            if cand < best:  # lexicographically smaller == more balanced
                best = cand
    return best
