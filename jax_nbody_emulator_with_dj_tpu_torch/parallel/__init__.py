"""Multi-device layer of the PyTorch port: a mesh of torch devices, sharded
fields and their collectives, halo exchange, and the sharded runtimes.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/parallel``.  One process
drives every shard of a mesh (``mesh.make_mesh``) unless ``initialize`` joined
several into a run, in which each drives its own block of the shards; a
device may repeat, so ``[torch.device("cuda")] * 8`` runs a (2, 2, 2)
decomposition on one card and ``[torch.device("cpu")] * 8`` on the CPU.
Meshes default to the visible CUDA cards.  ``ShardedHierarchicalProcessor``
is the production path (kernels B1 and B2 on every shard);
``dryrun.dryrun_multichip`` drives the whole layer.
"""

from .collectives import ShardedField
from .distributed import (
    box_spec,
    initialize,
    make_sharded_box,
    process_count,
    process_index,
    process_local_devices,
    shutdown,
)
from .halo import halo_exchange
from .mesh import make_mesh, mesh_for_devices
from .sharded_box import ShardedBoxConfig, ShardedBoxProcessor
from .sharded_hierarchical import ShardedHierarchicalProcessor

__all__ = [
    "make_mesh",
    "mesh_for_devices",
    "halo_exchange",
    "ShardedBoxConfig",
    "ShardedBoxProcessor",
    "ShardedHierarchicalProcessor",
    "initialize",
    "shutdown",
    "process_index",
    "process_count",
    "process_local_devices",
    "make_sharded_box",
    "box_spec",
    "ShardedField",
]
