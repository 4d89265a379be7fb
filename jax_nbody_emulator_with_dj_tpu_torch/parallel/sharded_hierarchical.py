"""Sharded hierarchical runtime: the overlap-minimal phases over a device mesh.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/parallel/sharded_hierarchical.py``.
``ShardedBoxProcessor`` scales the *subbox* scheme across a mesh (one 48-voxel
halo exchange, then full-network recompute tiles, ~5.4x the FLOPs).  This
module shards the *hierarchical* runtime (``hierarchical.py``) instead: each
phase runs on every shard's local block, and the margins of the padded level
buffers are filled from mesh neighbours between phases (8 input voxels up
front, then 2 level-1 voxels after phase 1, 4 after phase 2a, 8 level-2
voxels after phase 2b, 4 level-1 after phase 2c), in place of the periodic
self-wrap; the overlap overhead stays ~1.3x.  On every shard the phases run
the port's packed blocks, so the interior convs are kernels B1 (disp) and B2
(vel) as on one device.

Order matters: a phase runs for *every* shard before any margin is exchanged,
and the exchange finishes axis D for every shard before axis H of any shard
(corners compose from the margins the earlier axis filled).  A mesh axis of
size 1 degenerates every exchange to the single-device ghost fill, and the
phases are shared code, so the result equals the single-device runtime up to
float reordering (``tests/test_torch_port_parallel.py``).

A style model is folded once per call at (z, Om), on the first device, and
copied once to each other distinct device; the shards of one device share
its weights.
"""

from __future__ import annotations

import copy
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..cosmology import growth_factor, vel_norm
from ..hierarchical import HierarchicalConfig, HierarchicalProcessor
from .collectives import ShardedField, as_sharded, ppermute_shift
from .halo import halo_exchange
from .mesh import Mesh


def fill_margins_exchange(mesh: Mesh, shard_bufs, margins) -> int:
    """Fill the margins of every shard's padded buffer from its mesh neighbours.

    ``shard_bufs`` are (1, D, H, W, C) buffers in row-major shard order with
    ``margins`` (in the buffer's own units: W in packed cells when packed)
    baked into dims 1..3; their interiors are written, their margins are
    filled in place.  Axis by axis, like the single-device ghost fill, so the
    strips sent along an axis span the margins of the axes before it.  When a
    margin exceeds the interior the exchange takes one shift per neighbour
    distance k; the shift is ``k % mesh size`` (a margin wider than the global
    extent wraps the torus more than once; shift 0 is the shard's own
    interior).  Every face of an axis is taken before any margin of that axis
    is written (faces lie in the interiors, which no write touches).
    Returns the bytes written into the margins.
    """
    mesh_shape = mesh.spatial_shape()
    moved = 0
    for axis, (dim, m) in enumerate(zip((1, 2, 3), margins)):
        if m == 0:
            continue
        n = shard_bufs[0].shape[dim] - 2 * m
        nm = mesh_shape[axis]
        writes = []
        for k in range(1, -(-m // n) + 1):
            take = min(n, m - (k - 1) * n)
            lo = [b.narrow(dim, m + n - take, take) for b in shard_bufs]
            hi = [b.narrow(dim, m, take) for b in shard_bufs]
            shift = k % nm
            if shift:
                lo = ppermute_shift(lo, mesh_shape, axis, shift)  # from the k-left neighbour
                hi = ppermute_shift(hi, mesh_shape, axis, -shift)  # from the k-right neighbour
            writes.append((m - (k - 1) * n - take, lo, m + n + (k - 1) * n, hi))
        for lo_at, lo, hi_at, hi in writes:
            for buf, a, b in zip(shard_bufs, lo, hi):
                buf.narrow(dim, lo_at, a.shape[dim]).copy_(a)
                buf.narrow(dim, hi_at, b.shape[dim]).copy_(b)
                moved += a.nbytes + b.nbytes
    return moved


class _LocalHierarchical(HierarchicalProcessor):
    """The phases of one device's shards; their margins come from the mesh
    exchange, so a phase leaves its output buffers unfilled."""

    def _ghost_fill_all(self, bufs, margins):
        return bufs


def _exec_to(tree, device):
    """A packed exec tree (tensors, ``TiledWh``, lists, dicts) copied to ``device``."""
    if isinstance(tree, dict):
        return {k: _exec_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_exec_to(v, device) for v in tree)
    if torch.is_tensor(tree):
        return tree.to(device)
    if torch.is_tensor(getattr(tree, "tiles", None)):  # ops/winograd_cuda.py::TiledWh
        out = copy.copy(tree)
        out.tiles = tree.tiles.to(device)
        return out
    return tree


@dataclass(frozen=True)
class ShapeDtype:
    """The shape and dtype of a (global) tensor at a phase boundary."""

    shape: tuple
    dtype: torch.dtype


class ShardedHierarchicalProcessor:
    """Overlap-minimal big-box runtime sharded over a device mesh.

    Args:
        model: any of the four emulator cores.
        params: its parameters.
        mesh: 3D spatial mesh (``parallel.mesh``); a device may repeat.
        config: hierarchical geometry with the **global** ``size``; ``slab``,
            ``slab_h``, ``tile`` and ``tile1`` apply to the local shard
            (clipped to it; ``tile1`` falls back to the local auto pick).
    """

    def __init__(self, model, params, mesh: Mesh, config: HierarchicalConfig):
        self.mesh = mesh
        self.global_size = tuple(config.size)
        mesh_shape = mesh.spatial_shape()
        local_size = []
        for s, m in zip(self.global_size, mesh_shape):
            if s % m:
                raise ValueError(f"size {config.size} not divisible by mesh {mesh_shape}")
            local_size.append(s // m)
        kw = dict(
            size=tuple(local_size),
            slab=min(config.slab, local_size[0]),
            slab_h=(config.slab_h if config.slab_h and local_size[1] % config.slab_h == 0
                    else None),
            tile=tuple(min(t, s) for t, s in zip(config.tile, local_size)),
            dtype=config.dtype,
            output_dtype=config.output_dtype,
            in_chan=config.in_chan,
            packed=config.packed,
            buf_dtype=config.buf_dtype,
            wino=config.wino,
            y0_cache=config.y0_cache,
        )
        try:
            local_cfg = HierarchicalConfig(tile1=min(config.tile1, min(local_size) // 2), **kw)
        except ValueError:
            local_cfg = HierarchicalConfig(**kw)  # auto-pick a local tile1
        self.config = local_cfg
        # one processor (and one copy of the weights) per distinct device
        self.locals = {d: _LocalHierarchical(model, params, local_cfg, device=d)
                       for d in mesh.distinct_devices()}
        self.local = next(iter(self.locals.values()))
        self.shard_local = [self.locals[d] for d in mesh.devices.flat]
        self.compute_vel = self.local.compute_vel
        self.styled = self.local.styled
        self.last_timings = {}
        self.last_halo_bytes = {}

    # ---- per-shard work ---------------------------------------------------

    def _sync(self):
        for d in self.locals:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _fold(self, z, Om):
        """Fold a style model once, on the first device; copy it to the others."""
        exec0 = self.local._fold_exec(z, Om)
        for loc in self.locals.values():
            loc._exec = exec0 if loc is self.local else _exec_to(exec0, loc.device)

    def _exchange(self, bufs, margins) -> int:
        """Fill the margins of every shard's level buffers (each of the one or
        two buffers of a level in turn)."""
        return sum(fill_margins_exchange(self.mesh, [b[j] for b in bufs], margins)
                   for j in range(len(bufs[0])))

    # ---- ahead-of-time inspection -----------------------------------------

    def abstract_inputs(self) -> dict:
        """Global shapes and dtypes at every phase boundary (the local blocks,
        padded as each phase holds them, side by side over the mesh)."""
        cfg, loc = self.config, self.local
        mesh_shape = self.mesh.spatial_shape()
        nbuf = 2 if self.compute_vel else 1

        def g(shape, spatial_at, dtype=cfg.dtype):
            s = list(shape)
            for i, m in zip(spatial_at, mesh_shape):
                s[i] *= m
            return ShapeDtype(tuple(s), dtype)

        def bufs(margin, level=1):
            return (g(loc._buf_shape(margin, level), (1, 2, 3), cfg.buf_dtype),) * nbuf

        ld, lh, lw = cfg.size
        return {
            "box": g((1, cfg.in_chan, ld, lh, lw), (2, 3, 4)),
            "boxp": g((1, cfg.in_chan, ld + 16, lh + 16, lw + 16), (2, 3, 4)),
            "h1": bufs(loc._h1_margin()),
            "y1": bufs(loc._y1_margin()),
            "y2": bufs(loc._y2_margin(), level=2),
            "r1": bufs(loc._r1_margin()),
            "scalar": ShapeDtype((1,), torch.float32),
        }

    def memory_audit(self, z: float = 0.0, Om: float = 0.3175) -> dict:
        """The calibrated device-memory estimate of one ``process_box`` call,
        per device, in bytes (the port's counterpart of the JAX package's
        ``lower_phases``, which is XLA's).

        Each phase's row of the local config's ``memory_audit`` (``geometry.
        phase_bytes``: ``args``, ``out``, ``temps``, ``extra_live``) is taken
        for the ``k`` shards the device holds: their buffers are all resident
        (``k`` x args and out, less the weights, which the device's shards
        share; ``k`` x extra_live), the tile transient once (shards run one
        after another).  Returns ``{"devices": {device: {"shards", "phases",
        "max_total", "max_phase"}}, "max_total", "max_device"}``.  Nothing is
        allocated and a style model is not folded.
        """
        local = self.local.memory_audit(z, Om)["phases"]
        w = self.local.exec_weight_bytes()
        counts = {}
        for d in self.mesh.devices.flat:
            counts[d] = counts.get(d, 0) + 1
        devices = {}
        for d, k in counts.items():
            phases = {}
            for name, r in local.items():
                args, out = w + k * (r["args"] - w), k * r["out"]
                peak = args + out + r["temps"]
                extra = k * r["extra_live"]
                phases[name] = dict(peak=peak, args=args, out=out, temps=r["temps"],
                                    extra_live=extra, total=peak + extra)
            worst = max(phases, key=lambda p: phases[p]["total"])
            devices[str(d)] = dict(shards=k, phases=phases, max_total=phases[worst]["total"],
                                   max_phase=worst)
        top = max(devices, key=lambda d: devices[d]["max_total"])
        return {"devices": devices, "max_total": devices[top]["max_total"], "max_device": top}

    def lower_phases(self):
        raise NotImplementedError(
            "lower_phases lowers XLA programs, which the port does not have; "
            "memory_audit() gives the per-device estimate of every phase")

    # ---- public API -------------------------------------------------------

    def shard_input(self, box) -> ShardedField:
        """Place a (C, D, H, W) array onto the mesh, split along D, H, W, in the
        compute dtype (a field already laid out so is kept)."""
        return as_sharded(box, self.mesh, (1, 2, 3), self.config.dtype)

    def process_box(self, box, z: float, Om: float, as_numpy: bool = False,
                    profile: bool = False):
        """Emulate a full periodic box sharded over the mesh.

        Args:
            box: (C, D, H, W) global input: numpy, a torch tensor (sharded
                here: each block uploaded, then cast) or a ``ShardedField``.
            z, Om: output redshift and matter density.
            as_numpy: gather the result to host numpy (validation only; by
                default each output is a ``ShardedField`` on the mesh).
            profile: synchronise the mesh's devices after each step and keep
                the wall times in ``last_timings`` (seconds: ``fold``,
                ``scale``, each phase and, apart, each ``exchange_*``) and
                the bytes written into the margins at each phase boundary,
                over all shards, in ``last_halo_bytes``.

        Returns the displacement, or ``(disp, vel)`` for a velocity model.
        """
        cfg = self.config
        expect = (cfg.in_chan,) + self.global_size
        if tuple(box.shape) != expect:
            raise ValueError(f"box shape {tuple(box.shape)} != {expect}")
        mesh_shape = self.mesh.spatial_shape()
        timings, moved = {}, {}
        t0 = time.perf_counter()

        def stamp(name):
            nonlocal t0
            if profile:
                self._sync()
                timings[name] = time.perf_counter() - t0
                t0 = time.perf_counter()

        locs = self.shard_local
        shards = range(len(locs))
        with torch.no_grad():
            if self.styled:
                self._fold(z, Om)  # this call's weights, released below
                stamp("fold")
            field = self.shard_input(box)
            del box
            dz32 = torch.tensor(float(growth_factor(z, Om)), dtype=torch.float32)
            vf = torch.tensor(float(vel_norm(z, Om)) if self.compute_vel else 0.0,
                              dtype=torch.float32)
            head = (vf * 6.0, vf * 6.0 / dz32)
            scale = dz32.to(cfg.dtype) / torch.tensor(6.0, dtype=cfg.dtype)
            scaled = [(p * scale)[None] for p in field.parts]
            del field
            stamp("scale")
            # the 8-voxel input halo (phase 1 needs 4, phase 3 needs 8), in place of _wrap_pad
            boxp = halo_exchange(scaled, mesh_shape, 8, spatial_dims=(2, 3, 4))
            moved["input"] = sum(b.nbytes - s.nbytes for b, s in zip(boxp, scaled))
            del scaled
            stamp("exchange_input")

            h1 = [locs[i]._new_bufs(locs[i]._h1_margin()) for i in shards]
            for i in shards:
                locs[i]._phase1_all(boxp[i], h1[i])
            stamp("phase1")
            moved["h1"] = self._exchange(h1, self.local._h1_margin())
            stamp("exchange_h1")

            y1 = [locs[i]._new_bufs(locs[i]._y1_margin()) for i in shards]
            for i in shards:
                locs[i]._phase2a_all(h1[i], y1[i])
                h1[i] = None  # its margins were filled: no other shard reads it
            stamp("phase2a")
            moved["y1"] = self._exchange(y1, self.local._y1_margin())
            stamp("exchange_y1")

            y2 = [locs[i]._new_bufs(locs[i]._y2_margin(), level=2) for i in shards]
            for i in shards:
                locs[i]._phase2b_all(y1[i], y2[i])
            stamp("phase2b")
            moved["y2"] = self._exchange(y2, self.local._y2_margin())
            stamp("exchange_y2")

            r1 = [locs[i]._new_bufs(locs[i]._r1_margin()) for i in shards]
            for i in shards:
                locs[i]._phase2c_all(y1[i], y2[i], r1[i])
                y1[i] = y2[i] = None
            stamp("phase2c")
            moved["r1"] = self._exchange(r1, self.local._r1_margin())
            stamp("exchange_r1")

            outs = []
            for i in shards:
                o = tuple(torch.zeros((1, cfg.in_chan) + cfg.size, dtype=cfg.output_dtype,
                                      device=locs[i].device) for _ in r1[i])
                outs.append(locs[i]._phase3_all(boxp[i], r1[i], o, head))
                boxp[i] = r1[i] = None
            stamp("phase3")
            if self.styled:
                for loc in self.locals.values():
                    loc._exec = None
        result = tuple(ShardedField(self.mesh, expect, (1, 2, 3), [o[b][0] for o in outs])
                       for b in range(len(outs[0])))
        if as_numpy:
            result = tuple(r.numpy() for r in result)
            stamp("to_host")
        if profile:
            self.last_timings = timings
            self.last_halo_bytes = moved
        return result if self.compute_vel else result[0]
