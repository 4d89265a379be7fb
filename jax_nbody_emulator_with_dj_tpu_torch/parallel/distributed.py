"""Process bootstrap and per-shard input assembly.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/parallel/distributed.py``.
The port's mesh is driven by one process (``parallel/mesh.py``), so a run on
one host needs no bootstrap; multi-process (multi-host) runs, which would
need ``torch.distributed`` process groups, are not ported (ROADMAP A10b).

    from jax_nbody_emulator_with_dj_tpu_torch.parallel import (
        initialize, mesh_for_devices, make_sharded_box,
        ShardedBoxConfig, ShardedBoxProcessor,
    )

    initialize()                       # no-op in one process
    mesh = mesh_for_devices(8, devices=[torch.device("cuda")] * 8)
    cfg = ShardedBoxConfig(size=(512,) * 3)
    proc = ShardedBoxProcessor(model, params, mesh, cfg)
    box = make_sharded_box(mesh, cfg.size, load_block)  # one read per shard
    dis, vel = proc.process_box(box, z=0.0, Om=0.3175)
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .collectives import ShardedField, as_tensor, block_index, place
from .mesh import SPATIAL_AXES, Mesh

COORDINATOR_ENV = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join a multi-process run: a no-op where no coordinator is named, by
    argument or by environment (``JAX_COORDINATOR_ADDRESS`` or
    ``COORDINATOR_ADDRESS``, the names the JAX package reads).  Where one is
    named it raises ``NotImplementedError``: the port's multi-process runtime
    is ROADMAP item A10b."""
    explicit = coordinator_address or num_processes or process_id is not None
    env = next((os.environ[k] for k in COORDINATOR_ENV if os.environ.get(k)), None)
    if not (explicit or env):
        return  # single-process run
    raise NotImplementedError(
        "multi-process runs (a coordinator was named: "
        f"{coordinator_address or env or (num_processes, process_id)}) are not ported: the "
        "port drives every shard of a mesh from one process (ROADMAP A10b)")


def box_spec() -> tuple:
    """The partition of a (C, X, Y, Z) box over the spatial mesh axes."""
    return (None,) + SPATIAL_AXES


def make_sharded_box(mesh: Mesh, size, make_block, in_chan: int = 3, dtype=None) -> ShardedField:
    """Assemble a (C, X, Y, Z) box sharded over ``mesh`` from per-shard callbacks.

    ``make_block(index)`` is called once per shard with its global index (a
    tuple of slices into the (C,) + size array) and returns the local block,
    numpy or torch (typically a slice read from a memory-mapped ``.npy``);
    it is placed on the shard's device and cast to ``dtype`` (numpy or torch)
    if given.  The global box never exists in one place.
    """
    shape = (in_chan,) + tuple(int(s) for s in size)
    dims = (1, 2, 3)
    if dtype is not None and not isinstance(dtype, torch.dtype):  # a numpy dtype
        dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    parts = [place(as_tensor(make_block(block_index(shape, dims, mesh.spatial_shape(), i))),
                   dev, dtype)
             for i, dev in enumerate(mesh.devices.flat)]
    return ShardedField(mesh, shape, dims, parts)


def process_local_devices(mesh: Mesh) -> list:
    """The mesh devices this process drives: all of them (one process)."""
    return list(mesh.devices.flat)
