"""Where one ``process_box`` call's time and memory go: device time by op from
``torch.profiler``, and wall time and peak memory by phase.

    python3 -m jax_nbody_emulator_with_dj_tpu_torch.experiments.profile_box \\
        [--size 128] [--no-vel] [--no-wino] [--style | --learned-vel] [--f32]
        [--unpacked] [--y0-cache] [--tile D H W] [--chunks CX CY CZ | --auto]
        [--top 25] [--warmups 2] [--no-trace]

Builds the seeded premodulated model at full width (``mid_chan=64``, 3
levels, bf16; displacement+velocity unless ``--no-vel``; with ``--style`` the
style model of the same tree, whose per-box fold + pack then lands in the
trace and in ``phase_ms["fold"]``; with ``--learned-vel`` a premodulated
velocity tree with learned tangent kernels, ``NBodyEmulatorVelCore.init``,
whose layers run the materialized tangent) on the runtime's default geometry
(slab 32, tiles of 128^3, float32 outputs), or: ``--tile`` other phase-3
tiles; ``--unpacked`` the unpacked path; ``--y0-cache`` the y0 strip cache;
``--f32`` float32 compute with bfloat16 level buffers; ``--chunks`` the
chunked runtime over that grid (pad 48, inner geometry derived); ``--auto``
the planner's config for this card (``auto_hierarchical_config``, float16
outputs, the box in float32 on the host).  It warms up with ``--warmups``
calls and prints one JSON line.  From one call under ``torch.profiler``
(CPU and CUDA activities; left out with ``--no-trace``, as a 512^3 box's
trace is long): the call's wall time, the summed device time, the device
time and call count of each aten op (``by_op``: the kernels it launched) and
of each device kernel or copy by name (``by_kernel``: the port's own
kernels, which no aten op wraps, and the copies by direction show there),
the largest first.  From one more call with ``profile=True`` (a device sync
after every phase): its wall time, ``phase_ms`` (``to_host`` is the results'
copy to numpy; a chunked run sums its inner phases over the chunks and adds
``stage`` and ``crop_to_host``), ``phase_peak`` (each phase's peak of
``torch.cuda.max_memory_allocated``, its statistics reset at the phase's
start), the kernels' launches, the call's peak (the largest phase's) and
the allocator's reserved pool after it, and the planner's estimate of the
same geometry (``geometry.estimate_peak_bytes``; for a chunked run its inner
config's plus the staged next chunk) beside ``memory_audit()["max_total"]``.  With the kernels on (default) the
interior convs run B1 or B2; ``--no-wino`` sends them to cuDNN.  Needs one
CUDA card and ``nvcc``; the line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from .. import HierarchicalConfig, create_emulator
from ..models.unet import init_unet
from ..ops import winograd_cuda


def _self_device_us(entry) -> float:
    """An averaged profiler entry's own device time (the attribute's name
    differs between PyTorch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(entry, name):
            return float(getattr(entry, name))
    return 0.0


def _short(name: str) -> str:
    """A kernel's name without its template arguments' tail; an elementwise
    kernel by the functor it applies."""
    if "elementwise_kernel" in name and name.count("at::native::") > 1:
        return "elementwise " + name.split("at::native::")[2][:48]
    return name[:80]


def _trace(emu, box, top):
    """One call under ``torch.profiler``: (wall s, device ms, by_op, by_kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        emu.process_box(box, 0.5, 0.3)  # returns numpy: ends in a sync
        wall = time.perf_counter() - t0
    # Device rows are the kernels and copies themselves: the port's own kernels, which no
    # aten op wraps, and the copies by direction show here.  Host rows carry, as their own
    # device time, the kernels each aten op launched.
    by_kernel, by_op = {}, {}
    for e in prof.key_averages():
        us = _self_device_us(e)
        if us <= 0:
            continue
        on_device = e.device_type != torch.autograd.DeviceType.CPU
        into = (by_kernel if on_device else by_op).setdefault(_short(e.key), dict(ms=0.0, calls=0))
        into["ms"] += us / 1e3
        into["calls"] += e.count
    total = sum(v["ms"] for v in by_kernel.values())
    if total <= 0:
        raise RuntimeError("the profiler recorded no device time")

    def ranked(d):
        return dict(sorted(d.items(), key=lambda kv: -kv[1]["ms"])[:top])

    return wall, total, ranked(by_op), ranked(by_kernel)


def _processor_config(size, vel, wino, f32, unpacked, y0_cache, tile, chunks, auto):
    from .. import ChunkedHierarchicalConfig, auto_hierarchical_config

    dtype = torch.float32 if f32 else torch.bfloat16
    buf = torch.bfloat16 if f32 else None
    if auto:
        return auto_hierarchical_config(size, dtype=dtype, compute_vel=vel)
    if chunks:
        return ChunkedHierarchicalConfig(size=(size,) * 3, chunks=tuple(chunks), dtype=dtype,
                                         output_dtype=torch.float32, packed=not unpacked,
                                         buf_dtype=buf)
    return HierarchicalConfig(size=(size,) * 3, output_dtype=torch.float32, dtype=dtype,
                              wino=wino, slab=32, tile=tuple(tile or (min(size, 128),) * 3),
                              packed=not unpacked, y0_cache=y0_cache, buf_dtype=buf)


def estimate(cfg, vel, mid_chan=64, learned_tangent=False):
    """The planner's estimate of ``cfg``: a chunked config's inner run plus the
    staged next chunk (float32), as ``auto_hierarchical_config`` budgets it."""
    from .. import ChunkedHierarchicalConfig
    from ..geometry import estimate_peak_bytes

    if isinstance(cfg, ChunkedHierarchicalConfig):
        return (estimate_peak_bytes(cfg.inner_config(), vel, mid_chan,
                                    learned_tangent=learned_tangent)
                + cfg.in_chan * int(np.prod(cfg.inner_size)) * 4)
    return estimate_peak_bytes(cfg, vel, mid_chan, learned_tangent=learned_tangent)


def run(size=128, vel=True, wino=None, top=25, warmups=2, trace=True, style=False, emit=print,
        learned_vel=False, f32=False, unpacked=False, y0_cache=False, tile=None, chunks=None,
        auto=False):
    from .. import ChunkedHierarchicalConfig

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the profile needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = _processor_config(size, vel, wino, f32, unpacked, y0_cache, tile, chunks, auto)
    if learned_vel:
        params = init_unet(0, style=False, vel=True)
    else:
        params = init_unet(0, style=True)
    emu = create_emulator(premodulate=not style, compute_vel=vel, params=params,
                          premodulate_z=0.5, premodulate_Om=0.3, device="cuda",
                          processor_config=cfg)
    chunked = isinstance(cfg, ChunkedHierarchicalConfig)
    proc = emu.processor.inner if chunked else emu.processor
    box = np.random.default_rng(0).standard_normal((3, size, size, size), dtype=np.float32)
    for _ in range(warmups):
        emu.process_box(box, 0.5, 0.3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    geom = cfg.inner_config() if chunked else cfg
    row = dict(size=size, vel=vel, style=style, learned_vel=learned_vel, wino=proc.wino,
               dtype=str(geom.dtype).replace("torch.", ""), packed=geom.packed,
               y0_cache=geom.y0_cache, slab=geom.slab, slab_h=geom.slab_h, tile=list(geom.tile),
               tile1=geom.tile1, warmups=warmups)
    if chunked:
        row.update(chunks=list(cfg.chunks), pad=cfg.pad, inner_size=list(cfg.inner_size))
    if trace:
        row["wall_s"], row["device_ms"], row["by_op"], row["by_kernel"] = _trace(emu, box, top)
    b1, b2 = winograd_cuda.conv3d_wino_packed, winograd_cuda.conv3d_wino_pair_packed
    b1.launches = b2.launches = 0
    t0 = time.perf_counter()
    out = emu.process_box(box, 0.5, 0.3, profile=True)
    row["wall_profiled_s"] = time.perf_counter() - t0
    row["launches"] = dict(B1=b1.launches, B2=b2.launches)
    row["phase_ms"] = {k: round(v * 1e3, 3) for k, v in emu.processor.last_timings.items()}
    row["phase_peak"] = dict(emu.processor.last_peaks)
    # the profiled call resets the peak statistics at each phase: its peak is theirs
    row["max_memory_allocated"] = max(row["phase_peak"].values())
    row["memory_reserved"] = torch.cuda.memory_reserved()  # the allocator's pool after the call
    row["estimate"] = estimate(cfg, vel, learned_tangent=proc.learned_tangent)
    row["audit_max_total"] = proc.memory_audit()["max_total"]
    outs = out if vel else (out,)
    row["finite"] = bool(all(o.shape == (3, size, size, size) and np.isfinite(o).all()
                             for o in outs))
    row.update(card=card, device=torch.cuda.get_device_name(0))
    emit(json.dumps(row))
    if not row["finite"]:
        raise RuntimeError(f"the {size}^3 box came out with a wrong shape or not finite")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--no-vel", action="store_true", help="the displacement model alone")
    ap.add_argument("--no-wino", action="store_true", help="interior convs through cuDNN")
    ap.add_argument("--style", action="store_true",
                    help="the style model: its style folded and packed per box")
    ap.add_argument("--learned-vel", action="store_true",
                    help="a premodulated velocity tree with learned tangent kernels")
    ap.add_argument("--f32", action="store_true",
                    help="float32 compute with bfloat16 level buffers")
    ap.add_argument("--unpacked", action="store_true", help="the unpacked runtime path")
    ap.add_argument("--y0-cache", action="store_true", help="phase 3 with the y0 strip cache")
    ap.add_argument("--tile", type=int, nargs=3, metavar=("D", "H", "W"),
                    help="phase-3 output tile (default: 128^3, or the box)")
    ap.add_argument("--chunks", type=int, nargs=3, metavar=("CX", "CY", "CZ"),
                    help="the chunked runtime over this chunk grid")
    ap.add_argument("--auto", action="store_true",
                    help="the planner's config for this card (auto_hierarchical_config)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--warmups", type=int, default=2, help="calls before the measured ones")
    ap.add_argument("--no-trace", action="store_true",
                    help="leave out the torch.profiler call (phases, launches and memory only)")
    args = ap.parse_args(argv)
    run(args.size, not args.no_vel, False if args.no_wino else None, args.top, args.warmups,
        not args.no_trace, args.style, learned_vel=args.learned_vel, f32=args.f32,
        unpacked=args.unpacked, y0_cache=args.y0_cache, tile=args.tile, chunks=args.chunks,
        auto=args.auto)


if __name__ == "__main__":
    main()
