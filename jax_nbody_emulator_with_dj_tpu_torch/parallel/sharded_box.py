"""Multi-device big-box runtime: spatial decomposition with halo exchange.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/parallel/sharded_box.py``:
the periodic volume lives sharded over a 3D mesh of devices, and one call

    1. exchanges the model's receptive margin (48 voxels for the canonical
       net) between mesh neighbours, periodic by construction;
    2. per shard, runs the local tiles through the model's own (unpacked)
       forward, as ``SubboxProcessor`` does, bounding activation memory;
    3. writes each tile's output into the shard's block of the result.

The shards of the calling process run one after another; nothing is
gathered.  In a multi-process run (``distributed.initialize``) each process
runs its own shards, and the halo exchange carries the faces between
processes (``collectives``).
No kernel of the port runs here (the unpacked forward is ``F.conv3d``), as
in ``SubboxProcessor``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..cosmology import growth_factor, vel_norm
from ..models.cores import NBodyEmulatorCore, NBodyEmulatorVelCore, StyleNBodyEmulatorVelCore
from ..models.unet import valid_input_size
from ..utils.params import tree_to
from .collectives import ShardedField, as_sharded, each
from .halo import halo_exchange
from .mesh import Mesh


@dataclass
class ShardedBoxConfig:
    """Geometry of the sharded decomposition.

    Attributes:
        size: global box spatial size (D, H, W).
        tiles_per_shard: local subbox subdivision inside each shard (bounds
            the activation memory; (1, 1, 1) = one model call per shard).
        dtype: compute dtype (a torch dtype).
        output_dtype: dtype of the (still sharded) output.
        in_chan: input channels.
        halo: receptive margin exchanged between shards (``model.margin``).
    """

    size: tuple[int, int, int]
    tiles_per_shard: tuple[int, int, int] = (1, 1, 1)
    dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float32
    in_chan: int = 3
    halo: int = 48


class ShardedBoxProcessor:
    """Runs a model over a periodic volume sharded across a device mesh."""

    def __init__(self, model, params, mesh: Mesh, config: ShardedBoxConfig):
        self.model = model
        self.mesh = mesh
        self.config = config
        self.premodulate = isinstance(model, (NBodyEmulatorCore, NBodyEmulatorVelCore))
        self.compute_vel = isinstance(model, (NBodyEmulatorVelCore, StyleNBodyEmulatorVelCore))

        margin = getattr(model, "margin", None)
        if margin is not None and margin != config.halo:
            raise ValueError(f"config.halo {config.halo} != model margin {margin}")

        mesh_shape = mesh.spatial_shape()
        for s, m in zip(config.size, mesh_shape):
            if s % m:
                raise ValueError(f"size {config.size} not divisible by mesh {mesh_shape}")
            # shard extent < halo is fine (multi-hop exchange); the halo can
            # never exceed the global periodic extent, though.
            if config.halo > s:
                raise ValueError(f"halo {config.halo} > global extent {s}")
        self.shard_size = tuple(s // m for s, m in zip(config.size, mesh_shape))
        for s, t in zip(self.shard_size, config.tiles_per_shard):
            if s % t:
                raise ValueError(f"shard size {self.shard_size} not divisible by tiles "
                                 f"{config.tiles_per_shard}")
            if not valid_input_size(s // t + 2 * config.halo, getattr(model, "levels", 3)):
                raise ValueError(f"tile input size {s // t + 2 * config.halo} invalid for the "
                                 f"model; adjust tiles_per_shard")
        self.tile_size = tuple(s // t for s, t in zip(self.shard_size, config.tiles_per_shard))
        # one copy of the weights per distinct device of this process, shared by its shards
        self.params = {d: tree_to(params, d) for d in mesh.distinct_devices()}

    def _apply(self, x, Om, Dz, vel_fac):
        """The model on one batched crop: a tuple of one or two outputs."""
        if self.premodulate:
            args = (Dz, vel_fac) if self.compute_vel else (Dz,)
        else:
            args = (Om, Dz, vel_fac) if self.compute_vel else (Om, Dz)
        out = self.model.apply(self.params[x.device], x, *args)
        return out if self.compute_vel else (out,)

    def shard_input(self, box) -> ShardedField:
        """Place a (C, D, H, W) array onto the mesh, split along D, H, W, in the
        compute dtype (a field already laid out so is kept)."""
        return as_sharded(box, self.mesh, (1, 2, 3), self.config.dtype)

    def process_box(self, box, z: float, Om: float, as_numpy: bool = False):
        """Emulate a full periodic box sharded over the mesh.

        Args:
            box: (C, D, H, W) global input: numpy, a torch tensor (sharded
                here) or a ``ShardedField`` on this mesh.
            z, Om: output redshift and matter density.
            as_numpy: gather the result to host numpy (validation only; by
                default the outputs stay sharded, as ``ShardedField``).
        """
        cfg = self.config
        if tuple(box.shape) != (cfg.in_chan,) + tuple(cfg.size):
            raise ValueError(f"box shape {tuple(box.shape)} != {(cfg.in_chan,) + tuple(cfg.size)}")
        dz, vf = float(growth_factor(z, Om)), float(vel_norm(z, Om)) if self.compute_vel else 0.0
        field = self.shard_input(box)
        outs = []
        with torch.no_grad():
            padded = halo_exchange(field.parts, self.mesh.spatial_shape(), cfg.halo)
            del field
            tiles = cfg.tiles_per_shard
            anchors = np.stack(np.meshgrid(*[np.arange(t) for t in tiles], indexing="ij"),
                               axis=-1).reshape(-1, 3) * np.array(self.tile_size)
            extent = tuple(t + 2 * cfg.halo for t in self.tile_size)
            for local in padded:
                if local is None:  # another process's shard
                    outs.append(None)
                    continue
                dev = local.device
                scal = [torch.tensor([v], dtype=torch.float32, device=dev) for v in (Om, dz, vf)]
                res = tuple(torch.zeros((cfg.in_chan,) + self.shard_size, dtype=cfg.output_dtype,
                                        device=dev) for _ in range(2 if self.compute_vel else 1))
                for a in anchors.tolist():
                    crop = local[:, a[0]:a[0] + extent[0], a[1]:a[1] + extent[1],
                                 a[2]:a[2] + extent[2]]
                    for out, r in zip(res, self._apply(crop[None], *scal)):
                        out[:, a[0]:a[0] + self.tile_size[0], a[1]:a[1] + self.tile_size[1],
                            a[2]:a[2] + self.tile_size[2]].copy_(r[0])
                outs.append(res)
            del padded
        shape = (cfg.in_chan,) + tuple(cfg.size)
        nout = 2 if self.compute_vel else 1
        result = tuple(ShardedField(self.mesh, shape, (1, 2, 3), each(lambda o: o[b], outs))
                       for b in range(nout))
        if as_numpy:
            result = tuple(r.numpy() for r in result)
        return result if self.compute_vel else result[0]
