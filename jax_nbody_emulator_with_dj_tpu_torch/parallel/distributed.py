"""Process bootstrap and per-shard input assembly.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/parallel/distributed.py``.
A multi-process (multi-host) run starts the same script in every process;
:func:`initialize` joins them into one ``torch.distributed`` gloo group,
after which each process owns a contiguous block of every mesh's shards
(``mesh.shard_owner``), :func:`make_sharded_box` builds only those, and the
collectives carry what crosses processes over the group
(``collectives``).  Without a coordinator everything runs in one process.

    from jax_nbody_emulator_with_dj_tpu_torch.parallel import (
        initialize, make_mesh, make_sharded_box,
        ShardedHierarchicalProcessor,
    )

    initialize("host0:29500", num_processes=2, process_id=rank)  # no-op without
    mesh = make_mesh((2, 2, 2), devices=[torch.device("cuda")] * 4)  # 4 shards here
    proc = ShardedHierarchicalProcessor(model, params, mesh, cfg)
    box = make_sharded_box(mesh, cfg.size, load_block)  # this process's reads only
    dis, vel = proc.process_box(box, z=0.0, Om=0.3175)
    for i in dis.local_indices(): ...  # write this process's blocks

Gloo's point-to-point ops take CPU tensors, so what crosses processes is
staged through host memory; ranks that share one card (NCCL refuses two
ranks on one GPU) run unchanged.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from .collectives import ShardedField, as_tensor, block_index, place
from .mesh import REMOTE, SPATIAL_AXES, Mesh
from .mesh import process_count, process_index  # noqa: F401  (this module's API, as JAX's)

COORDINATOR_ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
NUM_PROCESSES_ENV = "JAX_NUM_PROCESSES"
PROCESS_ID_ENV = "JAX_PROCESS_ID"
DEFAULT_TIMEOUT_S = 300.0  # bounds the join and every collective


def _env_int(name):
    value = os.environ.get(name)
    return int(value) if value else None


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join a multi-process run: a ``torch.distributed`` gloo group at
    ``tcp://<coordinator_address>`` (``host:port``; process 0 serves it) of
    ``num_processes`` processes, this one ``process_id``.

    Each argument not given is read from the names the JAX package reads
    (``JAX_COORDINATOR_ADDRESS`` or ``COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``).  Where none of the three is
    set this is a no-op (one process), as is a second call.  A coordinator
    without the process count and id, or either of those without a
    coordinator, raises ``ValueError``: there is no metadata server to
    discover them.  ``timeout`` (seconds) bounds the join and every
    collective: a process whose peer failed raises after it.
    """
    address = coordinator_address or next(
        (os.environ[k] for k in COORDINATOR_ENV if os.environ.get(k)), None)
    count = num_processes if num_processes is not None else _env_int(NUM_PROCESSES_ENV)
    rank = process_id if process_id is not None else _env_int(PROCESS_ID_ENV)
    if address is None and count is None and rank is None:
        return  # single-process run
    if dist.is_initialized():
        return  # already joined
    if address is None or count is None or rank is None:
        raise ValueError(
            f"a multi-process run needs a coordinator address, the number of processes and "
            f"this process's id (got {address!r}, {count!r}, {rank!r}; arguments or "
            f"{COORDINATOR_ENV[0]}, {NUM_PROCESSES_ENV}, {PROCESS_ID_ENV})")
    if not 0 <= rank < count:
        raise ValueError(f"process id {rank} is not in 0 .. {count - 1}")
    dist.init_process_group("gloo", init_method=f"tcp://{address}", world_size=int(count),
                            rank=int(rank), timeout=datetime.timedelta(seconds=timeout))


def shutdown() -> None:
    """Leave the multi-process run (the counterpart of JAX's
    ``distributed.shutdown``); a no-op without one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def box_spec() -> tuple:
    """The partition of a (C, X, Y, Z) box over the spatial mesh axes."""
    return (None,) + SPATIAL_AXES


def make_sharded_box(mesh: Mesh, size, make_block, in_chan: int = 3, dtype=None) -> ShardedField:
    """Assemble a (C, X, Y, Z) box sharded over ``mesh`` from per-shard callbacks.

    ``make_block(index)`` is called once per shard of this process with its
    global index (a tuple of slices into the (C,) + size array) and returns
    the local block, numpy or torch (typically a slice read from a
    memory-mapped ``.npy``); it is placed on the shard's device and cast to
    ``dtype`` (numpy or torch) if given.  The global box never exists in one
    place, and no process reads another's blocks.
    """
    shape = (in_chan,) + tuple(int(s) for s in size)
    dims = (1, 2, 3)
    if dtype is not None and not isinstance(dtype, torch.dtype):  # a numpy dtype
        dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    parts = [None if dev == REMOTE else
             place(as_tensor(make_block(block_index(shape, dims, mesh.spatial_shape(), i))),
                   dev, dtype)
             for i, dev in enumerate(mesh.devices.flat)]
    return ShardedField(mesh, shape, dims, parts)


def process_local_devices(mesh: Mesh) -> list:
    """The devices of this process's shards, in shard order (a device repeats
    once per shard it holds)."""
    return [mesh.devices.flat[i] for i in mesh.local_indices()]
