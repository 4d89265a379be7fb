"""FoF at scale: timings, peak RSS and catalogue summaries, as a JSON record.

Counterpart of the JAX package's ``scripts/fof_scale_demo.py``: makes an
N^3 clumped displacement field (20 % of the particles fall into ~N^3/5e4
Gaussian clumps, the rest stay near the grid; the same numpy draw as the JAX
script, so both find the same groups), runs the friends-of-friends finder
with each ``--engines`` entry (``native``: ``native/fof.cpp``; ``numpy``),
and writes one record with the JAX script's keys.

Differences from the JAX script: the default output is
``runs/fof_scale_<N>.json`` (the JAX script writes under ``docs/``, whose
records this driver must not overwrite); ``--device`` (default the CUDA
card; raises without one; ``--device cpu`` runs on the CPU) is recorded with
the card's name and power limit (FoF is host code); each run's record keeps
its unrounded seconds in ``seconds_exact``, and ``main`` also returns every
engine's catalogue.

    python -m jax_nbody_emulator_with_dj_tpu_torch.cli.fof_scale_demo --n 256 \\
        --engines native numpy --out runs/fof_scale_256.json
"""

from __future__ import annotations

import argparse
import json
import resource
import time
from pathlib import Path

import numpy as np

from ._common import add_device_args, device_of, device_record, write_json


def peak_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--boxsize", type=float, default=1000.0)
    p.add_argument("--engines", nargs="+", default=["native", "numpy"])
    p.add_argument("--n-slabs", type=int, default=1,
                   help=">1 records the slab-streamed finder instead")
    p.add_argument("--nmin", type=int, default=20)
    p.add_argument("--clump-sigma", type=float, default=1.0,
                   help="clump radius in grid cells; 0.3 is the extreme delta-core regime "
                        "(native engine only at 512^3)")
    p.add_argument("--out", type=str, default=None,
                   help="output JSON (default runs/fof_scale_<N>.json)")
    add_device_args(p)
    return p.parse_args(argv)


def clumped_displacement(n: int, boxsize: float, clump_sigma: float) -> np.ndarray:
    """(3, n, n, n) float32 displacements: each infalling particle's points at
    its clump's centre (smooth Zel'dovich fields never reach FoF
    overdensities, so the clustering is drawn directly)."""
    cell = boxsize / n
    rng = np.random.RandomState(0)
    n_clumps = max(8, n**3 // 50_000)
    centers = rng.uniform(0, boxsize, size=(n_clumps, 3)).astype(np.float32)
    psi = rng.normal(0.0, 0.05 * cell, size=(3, n, n, n)).astype(np.float32)
    infall = rng.random(n**3) < 0.2
    which = rng.randint(0, n_clumps, size=int(infall.sum()))
    q1 = np.arange(n, dtype=np.float32) * cell
    for d in range(3):
        comp = psi[d].reshape(-1)
        shape = [1, 1, 1]
        shape[d] = n
        q = np.broadcast_to(q1.reshape(shape), (n, n, n)).reshape(-1)  # Lagrangian coordinate d
        comp[infall] = (centers[which, d] - q[infall]
                        + rng.normal(0.0, clump_sigma * cell, size=len(which)).astype(np.float32))
        psi[d] = comp.reshape(n, n, n)
    return psi


def main(argv: list[str] | None = None) -> dict:
    """Run each engine; returns the record, its path and each engine's catalogue."""
    args = parse_args(argv)
    device = device_of(args)

    from ..science.halos import (
        friends_of_friends,
        friends_of_friends_slabbed,
        positions_from_displacement,
    )

    n, L = args.n, args.boxsize
    rec = {
        "n_part": n, "boxsize": L, "nmin": args.nmin,
        "linking_length_rel": 0.2, "host": "single host, no MPI",
        "clump_sigma_cells": args.clump_sigma,
        "ic": "synthetic clumped displacement: 20% of particles fall into ~N^3/5e4 Gaussian "
              "clumps, rest stay on the grid; dense 10^4-particle clumps exercise the "
              "cell-hash dense-pair streaming",
        "runs": [],
        **device_record(device),
    }
    t0 = time.perf_counter()
    psi = clumped_displacement(n, L, args.clump_sigma)
    rec["ic_seconds"] = round(time.perf_counter() - t0, 1)
    print(f"IC ({n}^3) in {rec['ic_seconds']} s", flush=True)

    b = 0.2 * L / n
    catalogues = {}
    for engine in args.engines:
        t0 = time.perf_counter()
        if args.n_slabs > 1:
            fof = friends_of_friends_slabbed(psi, L, b, nmin=args.nmin, n_slabs=args.n_slabs,
                                             engine=engine)
        else:
            pos = positions_from_displacement(psi, L)
            fof = friends_of_friends(pos, L, b, nmin=args.nmin, engine=engine)
            del pos
        dt = time.perf_counter() - t0
        run = {
            "engine": engine,
            "n_slabs": args.n_slabs,
            "seconds": round(dt, 1),
            "seconds_exact": dt,
            "peak_rss_gib_so_far": round(peak_rss_gib(), 2),
            "n_halos": int(fof["n_groups"]),
            "largest_halo_particles": int(fof["lengths"].max()) if fof["n_groups"] else 0,
            "particles_in_halos": int(fof["lengths"].sum()),
        }
        rec["runs"].append(run)
        catalogues[engine] = {"lengths": fof["lengths"], "centers": fof["centers"]}
        print(json.dumps(run), flush=True)
        del fof

    out = Path(args.out or f"runs/fof_scale_{n}.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    write_json(out, rec)
    print(f"wrote {out}")
    return {"out": str(out), "record": rec, "catalogues": catalogues}


if __name__ == "__main__":
    main()
