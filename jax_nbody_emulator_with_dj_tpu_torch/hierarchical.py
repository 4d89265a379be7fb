"""Hierarchical big-box runtime: overlap-minimal periodic U-Net evaluation.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/hierarchical.py``, for the
four model cores.  A style (flexible-cosmology) model evaluates one style
vector per box, so each ``process_box`` call folds the style at its (z, Om)
into premodulated weights (with the tangent's rank factors for velocity) and
packs them, on the device; the phases then run as for a premodulated model.
The phases, tile anchors and margins are the JAX package's, which is what
makes the result equal (up to float reordering) to the subbox decomposition:

  Phase 1  (level-0 encoder on D[/H] slabs): conv_l00/conv_l01/down_l0 on
           slabs of the wrap-padded box, written into the level-1 buffer h1.
  Phase 2a (conv_l1, level-1 tiles, halo 2): h1 -> y1.
  Phase 2b (down_l1 + conv_l2, halo 4): y1 -> level-2 buffer y2.
  Phase 2c (down_l2 .. conv_r1, level-2 halo 8, y1 skip halo 4): -> r1.
  Phase 3  (final decode per output tile): the level-0 encoder is recomputed
           from the box (halo 8) and joined with up_r0 of r1 (halo 4 packed,
           3 unpacked).  With ``y0_cache`` the level-0 encoder runs once per
           (D, H) strip of tiles instead, and every W tile of the strip
           decodes from that strip.

Packed execution (``packed=True``, the default): activations are W-packed,
(1, D, H, W/2, 2C) channels-last (``ops/s2d.py``); every interior 3x3x3 conv
whose packed operands are >= 128 channels wide runs the F(2,3)^2 Winograd
kernels (``ops/winograd_cuda.py``: B1, and for the velocity model's
factored-tangent pairs B2) when ``HierarchicalConfig.wino`` is on, which it
is by default on a CUDA device.  ``packed=False`` runs the unpacked blocks
(``F.conv3d`` on channels-last tensors of ``mid_chan`` channels, the
decoder's concats materialised), as the JAX package runs XLA's convs there;
its level buffers are (1, D/2+2m, H/2+2m, W/2+2m, C).

A velocity model threads a (primal, tangent) pair through every phase, so
each level has two buffers, and phase 3 writes the displacement and the
velocity.  The runtime carries activations as tuples of one tensor (disp)
or two (disp+vel) throughout.

Where the port updates in place: the level buffers are allocated once per
``process_box`` call (``torch.zeros``); each tile's result is copied into
its slice of the destination buffer (one cast to ``buf_dtype`` where that
differs from ``dtype``; a consumer casts the tile it reads back), and the
periodic ghost margins are filled by in-place strip copies inside the same
buffer.  Tile reads are views (slices) of the padded buffers, never gathers.
The phases are plain Python loops; nothing is traced or compiled.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass

import numpy as np
import torch

from .cosmology import growth_factor, vel_norm
from .models.blocks import (
    _center_crop,
    apply_resample_block,
    apply_resample_block_packed,
    apply_resample_block_vel,
    apply_resample_block_vel_packed,
    apply_resnet_block,
    apply_resnet_block_packed,
    apply_resnet_block_packed_cat,
    apply_resnet_block_vel,
    apply_resnet_block_vel_packed,
    apply_resnet_block_vel_packed_cat,
    apply_resnet_entry_packed,
    apply_resnet_entry_vel_packed,
    pack_resample_params,
    pack_resnet_entry_params,
    pack_resnet_params,
)
from .models.cores import (
    NBodyEmulatorCore,
    NBodyEmulatorVelCore,
    StyleNBodyEmulatorCore,
    StyleNBodyEmulatorVelCore,
)
from .ops import s2d
from .ops.style import style_vector
from .utils.params import tree_to


def _wrap_pad(x, pad: int, axes=(2, 3, 4)):
    """Periodic pad of the given axes by ``pad`` on each side (any ``pad``)."""
    for ax in axes:
        n = x.shape[ax]
        idx = torch.arange(-pad, n + pad, device=x.device) % n
        x = x.index_select(ax, idx)
    return x


@dataclass
class HierarchicalConfig:
    size: tuple[int, int, int]
    slab: int = 32  # phase-1 D-slab thickness (even, divides size[0])
    slab_h: int | None = None  # optional phase-1 H split (even, divides size[1])
    tile: tuple[int, int, int] = (128, 128, 128)  # phase-3 output tiles
    tile1: int | None = None  # phase-2 level-1 tile (default min(64, N/2))
    dtype: torch.dtype = torch.bfloat16
    output_dtype: torch.dtype = torch.float16
    in_chan: int = 3
    packed: bool = True  # W-packed interior (module doc); False: the unpacked blocks
    wino: bool | None = None  # Winograd kernel for eligible convs; None = on for CUDA
    y0_cache: bool = False  # phase 3 runs the level-0 encoder (conv_l00 + conv_l01) once
    # per (D, H) strip of tiles and decodes every W tile of the strip from it, instead of
    # once per tile: the re-encode overhead drops from (tile+16)^3/tile^3 to about
    # (W+8)/W * (tile+16)^2/tile^2, for one strip buffer of (tile D+8, tile H+8, W+8) voxels
    y0_slab_h: int | None = None  # H rows per segment of the strip fill (bounds the entry
    # conv's transient); default min(68, tile H + 8); segments partition the strip
    buf_dtype: torch.dtype | None = None  # storage of the level buffers between the phases
    # (default: ``dtype``).  With float32 compute, bfloat16 halves the buffers: a phase's
    # result is rounded once where it is written, a consumer casts the tile it reads back to
    # ``dtype``, and the math inside a tile stays float32.

    def __post_init__(self):
        self.size = tuple(int(s) for s in self.size)
        self.tile = tuple(int(t) for t in self.tile)
        if self.size[0] % self.slab or self.slab % 2:
            raise ValueError(f"slab {self.slab} must be even and divide D={self.size[0]}")
        if self.slab_h is not None and (self.size[1] % self.slab_h or self.slab_h % 2):
            raise ValueError(f"slab_h {self.slab_h} must be even and divide H={self.size[1]}")
        for s, t in zip(self.size, self.tile):
            if s % t or t % 2:
                raise ValueError(f"tile {self.tile} must be even and divide size {self.size}")
        for s in self.size:
            if s % 8:
                raise ValueError(f"size {self.size} must be divisible by 8 (3 levels)")
        if self.tile1 is None:
            cap = min(64, min(self.size) // 2)
            step = 8 if self.packed else 4
            self.tile1 = next(
                (m for m in range(cap - cap % step, 0, -step)
                 if all((s // 2) % m == 0 for s in self.size)),
                cap,
            )
        if self.tile1 % 4 or any((s // 2) % self.tile1 for s in self.size):
            raise ValueError(f"tile1 {self.tile1} must be a multiple of 4 dividing size/2")
        if self.packed:
            if self.tile1 % 8:
                raise ValueError(f"packed mode needs tile1 % 8 == 0, got {self.tile1}")
            if self.tile[2] % 4:
                raise ValueError(f"packed mode needs tile W % 4 == 0, got {self.tile}")
        if self.y0_slab_h is None:
            self.y0_slab_h = min(68, self.tile[1] + 8)
        if self.y0_slab_h < 2:
            raise ValueError(f"y0_slab_h {self.y0_slab_h} must be >= 2")
        if self.buf_dtype is None:
            self.buf_dtype = self.dtype


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another one.  Raises where none was named and there is no card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no device was given and CUDA is not available: the port runs on the "
            'CUDA card by default; pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda")


# Level-buffer margins, in the buffer's own voxels (W in cells when packed): each
# buffer carries its consumer's halo, so tile reads are plain slices.
PHASE2A_MARGIN = 2
PHASE2B_MARGIN = 4
PHASE2C_MARGIN = 8  # level-2 voxels
PHASE3_R1_MARGIN = 3  # unpacked: up_r0 + two convs need 3
PHASE3_R1_MARGIN_PACKED = 4  # packed: 4, so the slice starts on a W cell


def level_margins(cfg: HierarchicalConfig) -> dict:
    """(D, H, W) margins of the four level buffers h1, y1, y2, r1."""
    wu = 2 if cfg.packed else 1
    r1 = PHASE3_R1_MARGIN_PACKED if cfg.packed else PHASE3_R1_MARGIN
    return {name: (m, m, m // wu) for name, m in (
        ("h1", PHASE2A_MARGIN), ("y1", PHASE2B_MARGIN), ("y2", PHASE2C_MARGIN), ("r1", r1))}


def buf_shape(cfg: HierarchicalConfig, mid_chan: int, margin, level: int = 1):
    """Padded level-``level`` buffer shape (channels-last; 2C packed)."""
    nd, nh, nw = cfg.size
    f = 2**level
    wu = 2 if cfg.packed else 1
    return (1, nd // f + 2 * margin[0], nh // f + 2 * margin[1], nw // (f * wu) + 2 * margin[2],
            wu * mid_chan)


def pack_exec_params(p, *, vel: bool, wino: bool, dtype, device):
    """Pack the interior layers' weights once, in the compute dtype, on ``device``."""
    kw = dict(vel=vel, dtype=dtype, device=device)
    pp = {
        "conv_l00": pack_resnet_entry_params(p["conv_l00"], "CACA", wino=wino, **kw),
        "conv_r01": pack_resnet_params(p["conv_r01"], "CAC", wino=wino, **kw),
    }
    for name in ("conv_l01", "conv_l1", "conv_l2", "conv_c"):
        pp[name] = pack_resnet_params(p[name], "CACA", wino=wino, **kw)
    for name in ("conv_r2", "conv_r1", "conv_r00"):
        pp[name] = pack_resnet_params(p[name], "CACA", groups=2, wino=wino, **kw)
    for name in ("down_l0", "down_l1", "down_l2"):
        pp[name] = pack_resample_params(p[name], "DA", **kw)
    for name in ("up_r2", "up_r1", "up_r0"):
        pp[name] = pack_resample_params(p[name], "UA", **kw)
    return pp


class HierarchicalProcessor:
    """Overlap-minimal runtime for the 3-level models (premodulated or style;
    disp or disp+vel)."""

    def __init__(self, model, params, config: HierarchicalConfig, device=None):
        if not isinstance(model, (NBodyEmulatorCore, NBodyEmulatorVelCore,
                                  StyleNBodyEmulatorCore, StyleNBodyEmulatorVelCore)):
            raise TypeError("HierarchicalProcessor supports the premodulated and style "
                            "emulator cores.")
        if model.levels != 3:
            raise ValueError("hierarchical runtime implements the 3-level topology")
        self.model = model
        self.styled = isinstance(model, (StyleNBodyEmulatorCore, StyleNBodyEmulatorVelCore))
        self.compute_vel = isinstance(model, (NBodyEmulatorVelCore, StyleNBodyEmulatorVelCore))
        self.config = config
        self.device = resolve_device(device)
        self.wu = 2 if config.packed else 1  # W voxels per buffer column
        self.wino = config.packed and (
            config.wino if config.wino is not None else self.device.type == "cuda")
        if self.styled:
            # the float32 style tree, on the device once; folded (and packed) per box
            self.params = tree_to(params, self.device, torch.float32)
            self._exec = None
        elif config.packed:
            self._exec = self._pack_params(params["params"])
        else:  # the unpacked blocks cast the float32 kernels to the compute dtype per call
            self._exec = tree_to(params, self.device, torch.float32)["params"]
        # a velocity tree with a learned dweight runs the materialized tangent (a style
        # fold always has the factored one)
        self.learned_tangent = (self.compute_vel and config.packed and not self.styled
                                and "wcat" in self._exec["conv_l1"]["conv_0"])
        self.last_timings = {}
        self.last_peaks = {}

    def _fold_exec(self, z, Om):
        """The style tree folded at (z, Om) (and packed): the exec weights of one
        box.  ``factors=True`` gives the tangent's rank factors, so packing
        never falls back to the host's factor recovery."""
        from .emulator import _modulate_tree  # emulator.py imports this module

        s = style_vector(float(Om), float(growth_factor(z, Om)))[0].to(self.device)
        folded = _modulate_tree(self.params, s, vel=self.compute_vel, eps=self.model.eps,
                                factors=True)
        return self._pack_params(folded["params"]) if self.config.packed else folded["params"]

    def _pack_params(self, p):
        return pack_exec_params(p, vel=self.compute_vel, wino=self.wino, dtype=self.config.dtype,
                                device=self.device)

    # ------------------------------------------------------------------
    # Blocks on activation tuples: (h,) for disp, (h, dh) for disp+vel
    # ------------------------------------------------------------------

    def _resnet(self, name, x, seq="CACA", out_fmt="NDHWC"):
        p = self._exec[name]
        if self.config.packed:
            if self.compute_vel:
                return apply_resnet_block_vel_packed(p, *x, seq)
            return (apply_resnet_block_packed(p, x[0], seq),)
        if self.compute_vel:
            return apply_resnet_block_vel(p, *x, seq, out_fmt=out_fmt)
        return (apply_resnet_block(p, x[0], seq, out_fmt=out_fmt),)

    def _resnet_cat(self, name, a, b):
        """Decoder block on the concat (a, b): implicit when packed (one conv per
        part), materialised on the unpacked path."""
        if not self.config.packed:
            return self._resnet(name, tuple(torch.cat(t, -1) for t in zip(a, b)))
        p = self._exec[name]
        if self.compute_vel:
            return apply_resnet_block_vel_packed_cat(p, (a[0], b[0]), (a[1], b[1]), "CACA")
        return (apply_resnet_block_packed_cat(p, (a[0], b[0]), "CACA"),)

    def _resample(self, name, x, seq):
        p = self._exec[name]
        if self.config.packed:
            if self.compute_vel:
                return apply_resample_block_vel_packed(p, *x, seq)
            return (apply_resample_block_packed(p, x[0], seq),)
        if self.compute_vel:
            return apply_resample_block_vel(p, *x, seq)
        return (apply_resample_block(p, x[0], seq),)

    def _entry(self, x):
        """The model's first block on the NCDHW input (the tangent starts here)."""
        p = self._exec["conv_l00"]
        if self.config.packed:
            if self.compute_vel:
                return apply_resnet_entry_vel_packed(p, x)
            return (apply_resnet_entry_packed(p, x),)
        if self.compute_vel:
            return apply_resnet_block_vel(p, x, None, "CACA", in_fmt="NCDHW")
        return (apply_resnet_block(p, x, "CACA", in_fmt="NCDHW"),)

    def _exit(self, h):
        """The 'CAC' tail (mid -> out channels), as NCDHW tensors."""
        if self.config.packed:
            return tuple(s2d.unpack_to_ncdhw(b) for b in self._resnet("conv_r01", h, "CAC"))
        return self._resnet("conv_r01", h, "CAC", out_fmt="NCDHW")

    # ------------------------------------------------------------------
    # Buffers
    # ------------------------------------------------------------------

    def _h1_margin(self):
        return level_margins(self.config)["h1"]

    def _y1_margin(self):
        return level_margins(self.config)["y1"]

    def _y2_margin(self):
        return level_margins(self.config)["y2"]

    def _r1_margin(self):
        return level_margins(self.config)["r1"]

    def _buf_shape(self, margin, level: int = 1):
        """Padded level-``level`` buffer shape (channels-last; 2C packed)."""
        return buf_shape(self.config, self.model.mid_chan, margin, level)

    def _new_bufs(self, margin, level: int = 1):
        """The level buffers: one for disp, two (primal, tangent) for disp+vel."""
        return tuple(
            torch.zeros(self._buf_shape(margin, level), dtype=self.config.buf_dtype,
                        device=self.device)
            for _ in range(2 if self.compute_vel else 1)
        )

    @classmethod
    def _ghost_fill_all(cls, bufs, margins):
        for buf in bufs:
            cls._ghost_fill(buf, margins)
        return bufs

    @staticmethod
    def _ghost_fill(buf, margins):
        """Fill the periodic ghost strips of a (1, D, H, W, C) padded buffer in place.

        Axis by axis, so once D's ghosts are filled the H strips span the
        full ghosted D extent (edges and corners compose).  Each side grows
        in period-sized chunks, so margins wider than the interior wrap too.
        """
        for ax, m in zip((1, 2, 3), margins):
            if m == 0:
                continue
            n = buf.shape[ax] - 2 * m
            lo = m  # lowest filled index
            while lo > 0:
                w = min(n, lo)
                buf.narrow(ax, lo - w, w).copy_(buf.narrow(ax, lo + n - w, w))
                lo -= w
            hi = m + n  # first unfilled index on the high side
            while hi < n + 2 * m:
                w = min(n, n + 2 * m - hi)
                buf.narrow(ax, hi, w).copy_(buf.narrow(ax, hi - n, w))
                hi += w
        return buf

    @staticmethod
    def _tile_anchors(steps3):
        return list(itertools.product(*[range(0, n, s) for n, s in steps3]))

    @staticmethod
    def _slice(buf, starts, sizes):
        """View of ``buf[:, s0:s0+n0, s1:s1+n1, s2:s2+n2, :]``."""
        return buf[:, starts[0]:starts[0] + sizes[0], starts[1]:starts[1] + sizes[1],
                   starts[2]:starts[2] + sizes[2]]

    def _read_tiles(self, bufs, starts, sizes):
        """One window (a view) of each level buffer, cast to the compute dtype
        where the buffers are stored in another one (``buf_dtype``)."""
        return tuple(self._slice(b, starts, sizes).to(self.config.dtype) for b in bufs)

    def _tile_window(self, bufs, start, halo, out_margin):
        """The (tile1 + 2*halo) windows of buffers padded by ``halo``, and the
        write offset of their tile in buffers padded by ``out_margin``."""
        e = self.config.tile1 + 2 * halo
        wu = self.wu
        win = self._read_tiles(bufs, (start[0], start[1], start[2] // wu), (e, e, e // wu))
        s5 = (
            out_margin[0] + start[0],
            out_margin[1] + start[1],
            out_margin[2] + start[2] // wu,
        )
        return win, s5

    def _write(self, bufs, starts, outs):
        for buf, out in zip(bufs, outs):
            self._slice(buf, starts, out.shape[1:4]).copy_(out)

    # ------------------------------------------------------------------
    # Phases
    # ------------------------------------------------------------------

    # Each phase: ``_phase*_all`` loops over the slabs or tiles and then fills
    # the ghosts of its output buffers; ``_phase*_step`` reads one window (a
    # view of each buffer), runs ``_phase*_slab``/``_phase*_tile`` and copies
    # the results into their slices of the output buffers.

    def _phase1_all(self, boxp, h1):
        cfg = self.config
        sh = cfg.slab_h or cfg.size[1]
        for d0 in range(0, cfg.size[0], cfg.slab):
            for h0 in range(0, cfg.size[1], sh):
                self._phase1_step(boxp, d0, h0, h1)
        return self._ghost_fill_all(h1, self._h1_margin())

    def _phase1_step(self, boxp, d0, h0, h1):
        cfg = self.config
        sh = cfg.slab_h or cfg.size[1]
        slab = boxp[:, :, d0 + 4:d0 + cfg.slab + 12, h0 + 4:h0 + sh + 12, 4:cfg.size[2] + 12]
        m = self._h1_margin()
        self._write(h1, (m[0] + d0 // 2, m[1] + h0 // 2, m[2]), self._phase1_slab(slab))

    def _y0_slab(self, slab):
        """conv_l00 + conv_l01 on an NCDHW slab (1, C, SD+2k, SH+2k, W+2k) ->
        level-0 features of extent (SD+2k-8, SH+2k-8, W+2k-8) (W in cells packed)."""
        return self._resnet("conv_l01", self._entry(slab))

    def _phase1_slab(self, slab):
        """(1, C, S+8, H+8, W+8) scaled input -> down_l0 rows (1, S/2, H/2, W/2[/2], C[*2])."""
        return self._resample("down_l0", self._y0_slab(slab), "DA")

    def _level1_anchors(self):
        return self._tile_anchors([(s // 2, self.config.tile1) for s in self.config.size])

    def _phase2a_all(self, h1, y1):
        for start in self._level1_anchors():
            self._phase2a_step(h1, start, y1)
        return self._ghost_fill_all(y1, self._y1_margin())

    def _phase2a_step(self, h1, start, y1):
        t, s5 = self._tile_window(h1, start, PHASE2A_MARGIN, self._y1_margin())
        self._write(y1, s5, self._phase2a_tile(t))

    def _phase2a_tile(self, t):
        """conv_l1 on a (1, M+4, M+4, (M+4)[/2], C[*2]) window -> the exact M tile."""
        return self._resnet("conv_l1", t)

    def _phase2b_all(self, y1, y2):
        for start in self._level1_anchors():
            self._phase2b_step(y1, start, y2)
        return self._ghost_fill_all(y2, self._y2_margin())

    def _phase2b_step(self, y1, start, y2):
        t, _ = self._tile_window(y1, start, PHASE2B_MARGIN, (0, 0, 0))
        m = self._y2_margin()
        wdiv = 2 * self.wu
        s5 = (m[0] + start[0] // 2, m[1] + start[1] // 2, m[2] + start[2] // wdiv)
        self._write(y2, s5, self._phase2b_tile(t))

    def _phase2b_tile(self, t):
        """down_l1 + conv_l2 on a (1, M+8, M+8, (M+8)[/2], C[*2]) y1 window -> the
        exact level-2 tile (1, M/2, M/2, M/2[/2], C[*2])."""
        return self._resnet("conv_l2", self._resample("down_l1", t, "DA"))

    def _phase2c_all(self, y1, y2, r1):
        for start in self._level1_anchors():
            self._phase2c_step(y1, y2, start, r1)
        return self._ghost_fill_all(r1, self._r1_margin())

    def _phase2c_step(self, y1, y2, start, r1):
        # y2 window: level-2 extent M/2 + 2*PHASE2C_MARGIN at the plain
        # level-2 anchor (the buffer carries exactly that margin).
        wu = self.wu
        e2 = self.config.tile1 // 2 + 2 * PHASE2C_MARGIN
        t2 = self._read_tiles(y2, (start[0] // 2, start[1] // 2, start[2] // (2 * wu)),
                              (e2, e2, e2 // wu))
        # conv_r1's skip: the 4-halo y1 window phase 2b reads too.
        t1, s5 = self._tile_window(y1, start, PHASE2B_MARGIN, self._r1_margin())
        self._write(r1, s5, self._phase2c_tile(t2, t1))

    def _phase2c_tile(self, t2, t1):
        """down_l2 .. conv_r1 on a level-2 window t2 (M/2+16) and y1 skip t1 (M+8).

        Extents: t2 M/2+16 (L2) -> down M/4+8 (L3) -> conv_c M/4+4 -> up
        M/2+8 -> conv_r2[cat crop(t2)] M/2+4 -> up M+8 (L1) -> conv_r1[cat t1]
        M+4 -> slack crop 2/side (1 cell packed) -> M.
        """
        def crop_like(t, h):
            return tuple(_center_crop(b, h[0].shape[1:4]) for b in t)

        h = self._resample("down_l2", t2, "DA")
        h = self._resnet("conv_c", h)
        h = self._resample("up_r2", h, "UA")
        h = self._resnet_cat("conv_r2", crop_like(t2, h), h)
        h = self._resample("up_r1", h, "UA")
        h = self._resnet_cat("conv_r1", crop_like(t1, h), h)
        ws = 2 // self.wu
        return tuple(b[:, 2:-2, 2:-2, ws:-ws] for b in h)

    def _phase3_all(self, boxp, r1, outs, head):
        cfg = self.config
        if not cfg.y0_cache:
            for a in self._tile_anchors(list(zip(cfg.size, cfg.tile))):
                self._phase3_step(boxp, r1, a, outs, head)
            return outs
        # One level-0 re-encode per (D, H) strip, shared by the strip's W tiles.
        td, th, tw = cfg.tile
        for d0, h0 in self._tile_anchors([(cfg.size[0], td), (cfg.size[1], th)]):
            y0 = self._y0_strip(boxp, d0, h0)
            for aw in range(0, cfg.size[2], tw):
                self._phase3_step_cached(boxp, r1, y0, (d0, h0, aw), outs, head)
            del y0  # freed before the next strip is built
        return outs

    def _r1_window(self, r1, a):
        """The level-1 r1 slices of output tile ``a`` (halo 4 packed, 3 unpacked):
        r1 carries that margin, so they start at the plain level-1 anchor."""
        td, th, tw = self.config.tile
        hm, wu = self._r1_margin()[0], self.wu
        return self._read_tiles(r1, (a[0] // 2, a[1] // 2, a[2] // (2 * wu)),
                                (td // 2 + 2 * hm, th // 2 + 2 * hm, (tw // 2 + 2 * hm) // wu))

    def _write_tile(self, outs, a, tiles):
        td, th, tw = self.config.tile
        for out, y in zip(outs, tiles):
            out[:, :, a[0]:a[0] + td, a[1]:a[1] + th, a[2]:a[2] + tw].copy_(y)

    def _phase3_step(self, boxp, r1, a, outs, head):
        td, th, tw = self.config.tile
        box_tile = boxp[:, :, a[0]:a[0] + td + 16, a[1]:a[1] + th + 16, a[2]:a[2] + tw + 16]
        self._write_tile(outs, a, self._phase3_tile(box_tile, self._r1_window(r1, a), head))

    def _phase3_tile(self, box_tile, r1_tile, head):
        """(1, C, T+16, ., .) box window + level-1 r1 slices -> NCDHW
        displacement tile (and velocity tile)."""
        x0 = box_tile[:, :, 8:-8, 8:-8, 8:-8]
        return self._decode(self._y0_slab(box_tile), r1_tile, x0, head)

    def _y0_strip(self, boxp, d0, h0):
        """Level-0 features (conv_l00 + conv_l01) of one (D, H) strip of tiles:
        (1, td+8, th+8, (W+8)[/2], C[*2]) per buffer, in ``buf_dtype``, covering
        the halo-4 windows of every W tile of the strip.  Strip index i is global
        coordinate d0+i-4 (h0+i-4; packed W cell u holds globals 2u-4, 2u-3).
        Filled in H segments of ``y0_slab_h`` rows, each written into the strip
        and released before the next, which bounds the entry conv's transient."""
        cfg = self.config
        td, th = cfg.tile[:2]
        rows = th + 8
        strip = None
        o = 0
        while o < rows:
            n = min(cfg.y0_slab_h, rows - o)
            seg = self._y0_slab(boxp[:, :, d0:d0 + td + 16, h0 + o:h0 + o + n + 8])
            if strip is None:
                strip = tuple(torch.empty((1, td + 8, rows) + tuple(s.shape[3:]),
                                          dtype=cfg.buf_dtype, device=s.device) for s in seg)
            for t, s in zip(strip, seg):
                t[:, :, o:o + n].copy_(s)
            del seg
            o += n
        return strip

    def _phase3_step_cached(self, boxp, r1, y0, a, outs, head):
        """Decode the W tile at ``a`` of the current (D, H) strip ``y0``: its
        halo-4 window spans the strip in D and H and starts at W cell a[2][/2]."""
        td, th, tw = self.config.tile
        wu = self.wu
        y0_t = self._read_tiles(y0, (0, 0, a[2] // wu), (td + 8, th + 8, (tw + 8) // wu))
        # the residual needs no halo (the (T+16)^3 window exists only for the re-encode)
        x0 = boxp[:, :, a[0] + 8:a[0] + 8 + td, a[1] + 8:a[1] + 8 + th, a[2] + 8:a[2] + 8 + tw]
        self._write_tile(outs, a, self._decode(y0_t, self._r1_window(r1, a), x0, head))

    def _decode(self, y0, r1_tile, x0, head):
        """up_r0 of the r1 slices, joined with the level-0 features y0 through
        conv_r00 and conv_r01, then the head.  ``head`` holds the velocity
        head's (vel_fac * 6, vel_fac * 6 / Dz), float32."""
        u = self._resample("up_r0", r1_tile, "UA")
        # up_r0 slack per side: margin 4 -> 4 voxels (2 cells) packed, margin 3 -> 2 voxels
        c, cw = (4, 2) if self.config.packed else (2, 2)
        u = tuple(b[:, c:-c, c:-c, cw:-cw] for b in u)
        h = self._exit(self._resnet_cat("conv_r00", y0, u))
        disp = (h[0] + x0) * torch.tensor(6.0, dtype=h[0].dtype)
        if not self.compute_vel:
            return (disp,)
        dx_norm, x0_norm = (f.to(h[0].dtype) for f in head)
        return disp, h[1] * dx_norm + x0 * x0_norm

    # ------------------------------------------------------------------
    # Memory audit
    # ------------------------------------------------------------------

    def exec_weight_bytes(self) -> int:
        """Bytes of one box's exec weights, from their shapes.  A style model's
        are counted from the style tree's shapes (the folded tree has the same
        layers), without folding and without allocating anything."""
        from .geometry import meta_exec_bytes, tree_nbytes

        if self._exec is not None:
            return tree_nbytes(self._exec)
        return meta_exec_bytes(self.params["params"], vel=self.compute_vel,
                               packed=self.config.packed, wino=self.wino,
                               dtype=self.config.dtype, folded=True)

    def memory_audit(self, z: float = 0.0, Om: float = 0.3175):
        """The calibrated device-memory estimate of every phase of one
        ``process_box(donate_input=True)`` call, in bytes.

        Returns ``{"phases": {name: {"peak", "args", "out", "temps",
        "extra_live", "total"}}, "max_total": int, "max_phase": str}`` over
        the phases ``scale``, ``phase1``, ``phase2a``, ``phase2b``,
        ``phase2c``, ``phase3``.  ``args`` and ``out`` are the phase's input
        and output buffers (from this processor's ``_buf_shape``) and, in
        ``args``, the exec weights' bytes (from their shapes); ``temps`` is
        the transient fitted on the card (``geometry.py``);
        ``extra_live`` the padded input box, alive through phases 2a-2c
        without being their argument; ``total = peak + extra_live``.  A
        learned-``dweight`` velocity tree takes its own phase-3 transient
        (``learned_tangent``).
        PyTorch has no ahead-of-time memory analysis, so this is the
        calibrated estimate ``geometry.estimate_peak_bytes`` reads too
        (``max_total`` equals it for the same config and weights), not a
        compiled plan.  Nothing is allocated on the device and a style model
        is not folded; ``z`` and ``Om`` change no shape.
        """
        from .geometry import phase_bytes

        report = phase_bytes(self.config, self.compute_vel, self.model.mid_chan,
                             weight_bytes=self.exec_weight_bytes(),
                             learned_tangent=self.learned_tangent)
        max_phase = max(report, key=lambda k: report[k]["total"])
        return {"phases": report, "max_total": report[max_phase]["total"],
                "max_phase": max_phase}

    # ------------------------------------------------------------------
    # process_box
    # ------------------------------------------------------------------

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def process_box(self, input_box, z: float, Om: float, as_numpy: bool = True,
                    profile: bool = False, donate_input: bool = False):
        """Emulate a full periodic (C, N, N, N) box at redshift z and matter density Om.

        Returns the displacement, or ``(disp, vel)`` for a velocity model.
        A style model's weights are folded at (z, Om) (and packed) first, for
        this call only.  With ``profile=True`` the device is synchronised
        after each phase and the per-phase wall times land in
        ``self.last_timings`` (seconds; ``fold`` is the style fold + pack)
        and, on a CUDA device, each phase's peak of
        ``torch.cuda.max_memory_allocated`` in ``self.last_peaks`` (bytes; the
        peak statistics are reset at each phase's start).  With
        ``as_numpy=False`` the results stay on the device and nothing waits
        for the device before the call returns (unless ``profile``).
        ``donate_input=True`` lets a torch tensor that already lies on the
        device in the compute dtype be scaled in place (do not reuse it),
        which saves one box-sized allocation; for any other input it changes
        nothing.  Either way the call drops its own reference to the input
        once the scaled padded copy exists.
        """
        cfg = self.config
        if tuple(input_box.shape) != (cfg.in_chan,) + cfg.size:
            raise ValueError(f"box shape {tuple(input_box.shape)} != {(cfg.in_chan,) + cfg.size}")
        timings, peaks = {}, {}
        track = profile and self.device.type == "cuda"
        if track:
            torch.cuda.reset_peak_memory_stats(self.device)
        t0 = time.perf_counter()

        def stamp(name):
            nonlocal t0
            if profile:
                self._sync()
                timings[name] = time.perf_counter() - t0
                if track:
                    peaks[name] = torch.cuda.max_memory_allocated(self.device)
                    torch.cuda.reset_peak_memory_stats(self.device)
                t0 = time.perf_counter()

        with torch.no_grad():
            if self.styled:
                self._exec = self._fold_exec(z, Om)  # this call's weights, released below
                stamp("fold")
            box = torch.as_tensor(np.asarray(input_box) if not torch.is_tensor(input_box)
                                  else input_box)
            # upload, then cast on the device: measured faster from 256^3 up than casting on
            # the host, which one .to(device=, dtype=) call does (experiments/upload_cast.py);
            # one rounding either way
            box = box.to(self.device).to(cfg.dtype)
            donated = donate_input and box is input_box
            del input_box
            dz32 = torch.tensor(float(growth_factor(z, Om)), dtype=torch.float32)
            vf = torch.tensor(float(vel_norm(z, Om)) if self.compute_vel else 0.0,
                              dtype=torch.float32)
            head = (vf * 6.0, vf * 6.0 / dz32)
            # a 0-dim host tensor: multiplies as a scalar, with no copy that would wait
            # for the device
            scale = dz32.to(cfg.dtype) / torch.tensor(6.0, dtype=cfg.dtype)
            # NCDHW scaled input, wrap-padded by 8 (phase-1 halo 4, phase-3 halo 8).
            boxp = _wrap_pad((box.mul_(scale) if donated else box * scale)[None], 8)
            del box
            stamp("scale")
            h1 = self._phase1_all(boxp, self._new_bufs(self._h1_margin()))
            stamp("phase1")
            y1 = self._phase2a_all(h1, self._new_bufs(self._y1_margin()))
            del h1
            stamp("phase2a")
            y2 = self._phase2b_all(y1, self._new_bufs(self._y2_margin(), level=2))
            stamp("phase2b")
            r1 = self._phase2c_all(y1, y2, self._new_bufs(self._r1_margin()))
            del y1, y2
            stamp("phase2c")
            outs = tuple(
                torch.zeros((1, cfg.in_chan) + cfg.size, dtype=cfg.output_dtype,
                            device=self.device)
                for _ in r1
            )
            outs = self._phase3_all(boxp, r1, outs, head)
            del r1, boxp
            stamp("phase3")
            if self.styled:
                self._exec = None
        outs = tuple(o[0].cpu().numpy() if as_numpy else o[0] for o in outs)
        if profile:
            timings["to_host"] = time.perf_counter() - t0  # the results' copy (as_numpy)
            self.last_timings = timings
            self.last_peaks = peaks
        return outs if self.compute_vel else outs[0]
