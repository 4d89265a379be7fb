"""Execution-geometry planning for the hierarchical runtime on one CUDA card.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/geometry.py``.  The
hierarchical runtime's speed and fit depend on five knobs (phase-1 slab and
H split, phase-2 level-1 tile, phase-3 output tile, buffer dtype).
:func:`auto_hierarchical_config` applies the geometry rules, estimates the
resulting peak device memory and, when the monolithic phase buffers cannot
fit the card, falls back to a :class:`ChunkedHierarchicalConfig`, growing
the chunk grid until the inner run fits.

The geometry rules (``_tile1_for``, ``_monolithic_config``) are the JAX
package's, found by its sweeps on a 16 GB TPU v5e; no sweep on the H100 has
retuned them yet.  The peak estimate keeps the JAX package's buffer algebra:
per phase, the live level buffers, the padded input and the outputs (from
``hierarchical.buf_shape``, the shapes the runtime allocates) plus a
per-voxel transient for the slab or tile in flight.  Its coefficients
(``_LIVE_*``) are fitted to per-phase peaks of ``torch.cuda.max_memory_allocated``
measured on an H100 (``experiments/memory_points.py``; the points are in
``PERF.md`` §5): the port's eager phases keep more tensors alive than XLA's
fused programs, so the JAX package's coefficients under-estimate every
measured box here.
:func:`phase_bytes` holds the per-phase algebra once; ``estimate_peak_bytes``
is its maximum and ``HierarchicalProcessor.memory_audit`` reports it.
"""

from __future__ import annotations

import numpy as np
import torch

from .chunked import ChunkedHierarchicalConfig, _largest_divisor
from .hierarchical import (
    HierarchicalConfig,
    buf_shape,
    level_margins,
    pack_exec_params,
    resolve_device,
)

# Per-voxel transients, in live mid-channel tensors of the compute dtype per
# voxel of the slab or tile in flight, keyed by compute_vel.  Fitted to the
# per-phase peaks measured on an H100 (experiments/memory_points.py, PERF.md
# §5), packed path: phase 3 took 7.7 (disp) and 21.5-22.1 (vel) live tensors
# a voxel of its (tile+16)^3 window at 128^3-512^3, bf16 and float32 alike;
# phase 1 3.4-4.1 (disp) and 9.2-10.0 (vel) a voxel of its slab.  The JAX
# package's XLA programs kept 3 / 6 and 6 / 12.  The planner plans packed
# runs, so these are its coefficients.
_LIVE_P1 = {False: 4, True: 10.5}  # phase 1 over (slab+8)(slab_h+8)(W+8); the y0 strip fill
_LIVE_P3 = {False: 8.5, True: 23}  # phases 2 ((tile1+16)^3) and 3 ((tile+16)^3)
# Where the card's peaks differ: the unpacked path (phase 1 5.2 disp; phase 3
# 9.3 disp, 18.6 vel) and a learned dweight's materialized tangent (phase 3
# 14.5-14.7 vel: no x (.) g + dx operand, no pair outputs).
_LIVE_P1_UNPACKED = {False: 5.5, True: 10.5}
_LIVE_P3_UNPACKED = {False: 10, True: 20}
_LIVE_P3_LEARNED = 16
_HEADROOM = 0.88  # use at most this fraction of the stated device memory (allocator slack)

MID_CHAN = 64  # the shipped models' interior width (mid_chan)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _tile1_for(size, cap: int) -> int:
    half = [s // 2 for s in size]
    for m in range(cap - cap % 8, 7, -8):
        if all(h % m == 0 for h in half):
            return m
    return 8


def phase_bytes(cfg: HierarchicalConfig, compute_vel: bool, mid_chan: int = MID_CHAN,
                weight_bytes: int = 0, learned_tangent: bool = False) -> dict:
    """The estimated device bytes of each phase of one monolithic
    ``process_box(donate_input=True)`` call:
    ``{phase: {"args", "out", "temps", "extra_live", "peak", "total"}}``.

    ``args``: the phase's input buffers plus ``weight_bytes`` (the exec
    weights; 0 leaves them to the fitted transients, as the planner does);
    ``out``: its output buffers; ``temps``: the fitted transient;
    ``extra_live``: the padded input through phases 2a-2c.  ``scale`` uploads
    a float32 host box (the planner cannot see the host dtype) and pads it.
    ``learned_tangent``: a velocity tree with a learned ``dweight`` (the
    planner cannot see the tree and assumes the factored one, which keeps
    more alive).
    """
    nbuf = 2 if compute_vel else 1
    bufb = _itemsize(cfg.buf_dtype)
    dtb = _itemsize(cfg.dtype)
    outb = _itemsize(cfg.output_dtype)
    nd, nh, nw = cfg.size
    margins = level_margins(cfg)

    def buf_bytes(name, level=1):
        return int(np.prod(buf_shape(cfg, mid_chan, margins[name], level))) * bufb * nbuf

    h1, y1, y2, r1 = buf_bytes("h1"), buf_bytes("y1"), buf_bytes("y2", 2), buf_bytes("r1")
    voxels = cfg.in_chan * nd * nh * nw
    boxp = cfg.in_chan * (nd + 16) * (nh + 16) * (nw + 16) * dtb
    outs = nbuf * voxels * outb

    live1, live3 = (_LIVE_P1, _LIVE_P3) if cfg.packed else (_LIVE_P1_UNPACKED, _LIVE_P3_UNPACKED)
    live3 = live3[compute_vel]
    if compute_vel and learned_tangent and cfg.packed:
        live3 = _LIVE_P3_LEARNED
    c1 = live1[compute_vel] * mid_chan * dtb  # bytes / in-flight voxel
    c3 = live3 * mid_chan * dtb

    sh = cfg.slab_h or nh
    p1_tmp = int((cfg.slab + 8) * (sh + 8) * (nw + 8) * c1)
    td, th, tw = cfg.tile
    p3_tmp = int((td + 16) * (th + 16) * (tw + 16) * c3)
    # phase-2 tiles live at level 1 (mid channels over (tile1 + halo)^3
    # windows); +16 over-covers the 2c y2 window's level-2 margin
    p2_tmp = int((cfg.tile1 + 16) ** 3 * c3)
    if cfg.y0_cache:
        # the strip (td+8, th+8, W+8) per buffer stays through its W tiles; its
        # fill streams H segments of y0_slab_h rows through the entry stack
        strip = nbuf * (td + 8) * (th + 8) * (nw + 8) * mid_chan * bufb
        fill = int((td + 16) * (cfg.y0_slab_h + 8) * (nw + 16) * c1)
        p3_tmp = strip + max(fill, p3_tmp)

    w = int(weight_bytes)
    rows = {
        "scale": (w + voxels * 4, boxp, boxp, 0),
        "phase1": (w + boxp, h1, p1_tmp, 0),
        "phase2a": (w + h1, y1, p2_tmp, boxp),
        "phase2b": (w + y1, y2, p2_tmp, boxp),
        "phase2c": (w + y1 + y2, r1, p2_tmp, boxp),
        "phase3": (w + boxp + r1, outs, p3_tmp, 0),
    }
    report = {}
    for name, (args, out, temps, extra) in rows.items():
        peak = args + out + temps
        report[name] = dict(peak=int(peak), args=int(args), out=int(out), temps=int(temps),
                            extra_live=int(extra), total=int(peak + extra))
    return report


def estimate_peak_bytes(cfg: HierarchicalConfig, compute_vel: bool, mid_chan: int = MID_CHAN,
                        weight_bytes: int = 0, learned_tangent: bool = False) -> int:
    """Estimated peak device memory of a monolithic hierarchical run: the
    largest phase of :func:`phase_bytes`."""
    report = phase_bytes(cfg, compute_vel, mid_chan, weight_bytes, learned_tangent)
    return max(v["total"] for v in report.values())


def tree_nbytes(tree) -> int:
    """Bytes of every tensor in a (packed) parameter tree."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    t = getattr(tree, "tiles", tree)  # ops/winograd_cuda.py::TiledWh
    return t.numel() * t.element_size() if torch.is_tensor(t) else 0


def meta_exec_bytes(params, *, vel: bool, packed: bool, wino: bool, dtype,
                    folded: bool = False) -> int:
    """Bytes of the exec weights of an unpacked tree ``params`` (block ->
    layer -> leaves), counted on the ``meta`` device: nothing is allocated
    and nothing is computed.  ``folded``: count a style tree as its style
    fold with the tangent's factors (``HierarchicalProcessor._fold_exec``)."""

    def meta(t):
        return torch.empty(tuple(t.shape), dtype=torch.float32, device="meta")

    def layer(p):
        if not (folded and "style_weight" in p):
            return {k: meta(v) for k, v in p.items()}
        out = {"weight": meta(p["weight"]), "bias": meta(p["bias"])}
        if vel:
            ci, co = p["weight"].shape[-2:]
            out.update(dweight=meta(p["weight"]), dfac_in=torch.empty(ci, device="meta"),
                       dfac_out=torch.empty(co, device="meta"))
        return out

    tree = {b: {n: layer(p) for n, p in block.items()} for b, block in params.items()}
    if not packed:
        return tree_nbytes(tree)
    return tree_nbytes(pack_exec_params(tree, vel=vel, wino=wino, dtype=dtype, device="meta"))


def _monolithic_config(size, dtype, compute_vel, output_dtype, in_chan,
                       hbm_bytes, mid_chan=MID_CHAN) -> HierarchicalConfig:
    """The JAX package's geometry rules (its v5e sweep), generalized to
    divisible extents, then the phase-3 tile shrunk until the estimate fits."""
    f32 = dtype == torch.float32
    n = min(size)
    t = _largest_divisor(n, 128, 2)

    def ax(i, cap, mult=2):
        return _largest_divisor(size[i], cap, mult)

    if compute_vel:
        wcap = max(t // 2, 4) if f32 else t
        tile = (ax(0, t), ax(1, t), ax(2, wcap, mult=4))
    else:
        tile = (ax(0, t), ax(1, t if f32 else 2 * t), ax(2, 2 * t, mult=4))
    cfg = HierarchicalConfig(
        size=size,
        slab=_largest_divisor(
            size[0], 32 if (compute_vel and f32) else (64 if compute_vel else 32), 2
        ),
        slab_h=(
            _largest_divisor(size[1], max(size[1] // 4, 8), 2) if f32
            else (size[1] // 2 if compute_vel and size[1] >= 256 else None)
        ),
        tile=tile,
        tile1=_tile1_for(size, 64 if compute_vel else 128),
        dtype=dtype,
        output_dtype=output_dtype,
        in_chan=in_chan,
        buf_dtype=torch.bfloat16 if f32 else None,
    )
    # Shrink the phase-3 tile (largest axis first) while over budget:
    # transients scale with tile volume, buffers do not move.
    budget = hbm_bytes * _HEADROOM
    while estimate_peak_bytes(cfg, compute_vel, mid_chan) > budget:
        order = sorted(range(3), key=lambda i: -cfg.tile[i])
        for a in order:
            cur = cfg.tile[a]
            mult = 4 if a == 2 else 2
            nxt = _largest_divisor(size[a], cur // 2, mult)
            if nxt < cur:
                tile = list(cfg.tile)
                tile[a] = nxt
                cfg = HierarchicalConfig(
                    size=size, slab=cfg.slab, slab_h=cfg.slab_h,
                    tile=tuple(tile), tile1=cfg.tile1, dtype=cfg.dtype,
                    output_dtype=cfg.output_dtype, in_chan=cfg.in_chan,
                    buf_dtype=cfg.buf_dtype,
                )
                break
        else:
            break  # tile floor reached; the buffers themselves are the problem
    return cfg


def fallback_ladder(cfg: HierarchicalConfig, compute_vel: bool = True, mid_chan: int = MID_CHAN):
    """Yield progressively slimmer geometries to retry after an out-of-memory error.

    Rungs: ``"slim"`` and ``"slim2"`` halve the phase-1 slab and H split,
    the phase-2 level-1 tile and cap the phase-3 tile (every transient drops,
    the level buffers, fixed by ``size``, stay); then
    ``"chunked(cx,cy,cz)"`` for (2,1,1), (2,2,1), (2,2,2) where the size
    allows.  A slim rung is yielded only if its estimate is strictly below
    the last yielded config's (at small sizes the halving reaches its floors
    and a rung would repeat its predecessor), a chunked rung only if its
    inner volume is strictly below the last chunked rung's (an anisotropic
    box can pad its third split axis past the saving).
    """
    size = cfg.size
    cur = cfg
    last = estimate_peak_bytes(cfg, compute_vel, mid_chan)

    def down(v, floor):  # halve toward a floor, never grow
        return max(v // 2, min(floor, v))

    for rung in ("slim", "slim2"):
        tile = (
            _largest_divisor(size[0], down(cur.tile[0], 32), 2),
            _largest_divisor(size[1], down(cur.tile[1], 32), 2),
            _largest_divisor(size[2], down(cur.tile[2], 32), 4),
        )
        sh0 = cur.slab_h or size[1]
        cur = HierarchicalConfig(
            size=size,
            slab=_largest_divisor(size[0], down(cur.slab, 16), 2),
            slab_h=_largest_divisor(size[1], down(sh0, 16), 2),
            tile=tile,
            tile1=_tile1_for(size, down(cur.tile1, 8)),
            dtype=cfg.dtype,
            output_dtype=cfg.output_dtype,
            in_chan=cfg.in_chan,
            packed=cfg.packed,
            wino=cfg.wino,
            buf_dtype=cfg.buf_dtype,
        )
        est = estimate_peak_bytes(cur, compute_vel, mid_chan)
        if est < last:
            last = est
            yield rung, cur
    last_volume = None
    for chunks in ((2, 1, 1), (2, 2, 1), (2, 2, 2)):
        align = 16 if cfg.packed else 8
        if not all(
            s % c == 0 and (s // c) % align == 0 and s // c >= 64
            for s, c in zip(size, chunks)
        ):
            continue
        rung = ChunkedHierarchicalConfig(
            size=size,
            chunks=chunks,
            pad=48,
            dtype=cfg.dtype,
            output_dtype=cfg.output_dtype,
            in_chan=cfg.in_chan,
            packed=cfg.packed,
            buf_dtype=cfg.buf_dtype,
        )
        volume = int(np.prod(rung.inner_size))
        if last_volume is None or volume < last_volume:
            last_volume = volume
            yield f"chunked{chunks}", rung


def is_oom_error(e: BaseException) -> bool:
    """True for device out-of-memory failures: ``torch.OutOfMemoryError`` (which
    ``torch.cuda.OutOfMemoryError`` aliases) by type, and by text the
    messages other layers use (``RESOURCE_EXHAUSTED``, ``out of memory``,
    ``OOM when allocating``), so a wrapped error still matches."""
    if isinstance(e, torch.OutOfMemoryError):
        return True
    s = f"{type(e).__name__}: {e}"
    return any(m in s for m in ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory",
                                "OOM when allocating"))


def auto_hierarchical_config(
    size,
    dtype=torch.bfloat16,
    compute_vel: bool = True,
    output_dtype=torch.float16,
    in_chan: int = 3,
    hbm_bytes: int | None = None,
    mid_chan: int = MID_CHAN,
    device=None,
):
    """Plan a geometry that fits one card.

    Returns a :class:`HierarchicalConfig` when the monolithic phase buffers
    fit the budget, else a :class:`ChunkedHierarchicalConfig` whose inner run
    fits (growing the chunk grid axis by axis).  Either is accepted by
    ``create_emulator(processor_config=...)``.

    Args:
        size: box extent, int or (D, H, W); each must be divisible by 16
            (packed-execution alignment).
        dtype: compute dtype (bfloat16 or float32; float32 runs get
            bfloat16 level buffers, see ``HierarchicalConfig.buf_dtype``).
        compute_vel: plan for the displacement+velocity models.
        hbm_bytes: the device-memory budget in bytes; None: the total memory
            of ``resolve_device(device)`` (``torch.cuda.mem_get_info``), which
            needs a CUDA card.
        mid_chan: the model's interior channel width (the per-voxel
            transient scales with it; default: the shipped 64).
        device: the card whose memory ``hbm_bytes=None`` reads (default: the
            current CUDA device).
    """
    if hbm_bytes is None:
        dev = resolve_device(device)
        if dev.type != "cuda":
            raise ValueError(f"hbm_bytes=None reads a CUDA card's memory; {dev} has none: "
                             "pass hbm_bytes")
        hbm_bytes = torch.cuda.mem_get_info(dev)[1]
    if isinstance(size, (int, np.integer)):
        size = (int(size),) * 3
    size = tuple(int(s) for s in size)
    if any(s % 16 for s in size):
        raise ValueError(
            f"auto geometry plans packed execution, which needs every box "
            f"extent divisible by 16; got {size}.  Build a "
            f"HierarchicalConfig(packed=False, ...) manually for other "
            f"extents."
        )
    cfg = _monolithic_config(size, dtype, compute_vel, output_dtype, in_chan, hbm_bytes,
                             mid_chan)
    if estimate_peak_bytes(cfg, compute_vel, mid_chan) <= hbm_bytes * _HEADROOM:
        return cfg

    chunks = [1, 1, 1]
    while True:
        # split the axis with the largest chunk extent that can still split
        order = sorted(range(3), key=lambda i: -(size[i] // chunks[i]))
        for a in order:
            c = chunks[a] * 2
            if size[a] % c == 0 and (size[a] // c) % 16 == 0 and size[a] // c >= 64:
                chunks[a] = c
                break
        else:
            raise ValueError(f"no chunk decomposition of {size} fits {hbm_bytes} bytes")
        ccfg = ChunkedHierarchicalConfig(
            size=size,
            chunks=tuple(chunks),
            pad=64,  # keeps 2^k chunk extents on 2^k-friendly inner grids
            dtype=dtype,
            output_dtype=output_dtype,
            in_chan=in_chan,
            buf_dtype=torch.bfloat16 if dtype == torch.float32 else None,
        )
        inner = _monolithic_config(ccfg.inner_size, dtype, compute_vel, output_dtype, in_chan,
                                   hbm_bytes, mid_chan)
        # The chunked runtime stages the NEXT padded input chunk while the
        # current one computes: one extra inner-size input, budgeted in
        # float32 (the planner cannot see the host dtype).
        prefetch = in_chan * int(np.prod(ccfg.inner_size)) * 4
        fit = estimate_peak_bytes(inner, compute_vel, mid_chan) + prefetch
        if fit <= hbm_bytes * _HEADROOM:
            return ChunkedHierarchicalConfig(
                size=size,
                chunks=tuple(chunks),
                pad=64,
                slab=inner.slab,
                slab_h=inner.slab_h,
                tile=inner.tile,
                tile1=inner.tile1,
                dtype=dtype,
                output_dtype=output_dtype,
                in_chan=in_chan,
                buf_dtype=inner.buf_dtype,
            )
