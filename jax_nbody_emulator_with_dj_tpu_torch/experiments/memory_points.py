"""The planner's estimate against the measured peak device memory, geometry by geometry.

    python3 -m jax_nbody_emulator_with_dj_tpu_torch.experiments.memory_points \\
        [--points NAME ...] [--out chiprun_out/memory_points.jsonl]

Runs each named geometry once through ``experiments/profile_box.py`` (one
warm-up call, then one ``profile=True`` call; no trace) and prints one JSON
line per point: the whole call's peak of ``torch.cuda.max_memory_allocated``
and each phase's (``phase_peak``), the planner's estimate of the same
geometry (``geometry.estimate_peak_bytes``, for a chunked run its inner
config's plus the staged next chunk) and its per-phase algebra
(``geometry.phase_bytes``), their ratio, ``memory_audit()["max_total"]``,
phase times and kernel launches.  These are the points the planner's
coefficients are fitted to (``geometry.py``).  The last line gathers the
ratios.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import torch

from . import profile_box

# name -> profile_box.run keywords; all at mid_chan=64, bf16 unless f32
POINTS = {
    "disp128": dict(size=128, vel=False),
    "vel128": dict(size=128),
    "vel256": dict(size=256),
    "vel512": dict(size=512),
    "disp512": dict(size=512, vel=False),
    "vel512_f32": dict(size=512, f32=True),
    "vel256_chunked211": dict(size=256, chunks=(2, 1, 1)),
    "disp128_y0": dict(size=128, vel=False, y0_cache=True, tile=(128, 128, 64)),
    "vel128_y0": dict(size=128, y0_cache=True, tile=(128, 128, 64)),
    "disp128_unpacked": dict(size=128, vel=False, unpacked=True),
    "vel128_unpacked": dict(size=128, unpacked=True),
    "vel512_y0": dict(size=512, y0_cache=True, tile=(128, 128, 128)),
    "vel128_learned": dict(size=128, learned_vel=True),
    "vel128_learned_nowino": dict(size=128, learned_vel=True, wino=False),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", nargs="*", default=list(POINTS), choices=list(POINTS))
    ap.add_argument("--warmups", type=int, default=1)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    from ..geometry import phase_bytes

    sink = open(Path(args.out), "a") if args.out else None
    ratios = {}
    for name in args.points:
        kw = POINTS[name]
        rows = []
        profile_box.run(warmups=args.warmups, trace=False, emit=lambda line: rows.append(line),
                        **kw)
        row = json.loads(rows[0])
        from .. import ChunkedHierarchicalConfig

        cfg = profile_box._processor_config(
            kw["size"], kw.get("vel", True), kw.get("wino"), kw.get("f32", False),
            kw.get("unpacked", False), kw.get("y0_cache", False), kw.get("tile"),
            kw.get("chunks"), False)
        geom = cfg.inner_config() if isinstance(cfg, ChunkedHierarchicalConfig) else cfg
        row["estimate_phases"] = {k: v["total"] for k, v in phase_bytes(
            geom, kw.get("vel", True), learned_tangent=kw.get("learned_vel", False)).items()}
        row["point"] = name
        row["estimate_over_peak"] = row["estimate"] / row["max_memory_allocated"]
        ratios[name] = row["estimate_over_peak"]
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        torch.cuda.empty_cache()
    print(json.dumps({"estimate_over_peak": ratios}), flush=True)


if __name__ == "__main__":
    main()
