"""FoF halo pipeline: displacement field -> halo catalogue -> mass function.

Counterpart of the JAX package's ``scripts/halos.py``: builds Eulerian
positions x = (q + psi) mod L from a saved displacement field, runs the
periodic friends-of-friends finder (``science/halos.py``: the native C++
linking loop ``native/fof.cpp`` or numpy, ``--engine``; ``--n-slabs`` > 1
streams Eulerian x-slabs of a memory-mapped file), and writes the catalogue
``halo_catalog.npz`` and ``fof_summary.json`` with the JAX script's keys.  A
glob of per-shard pieces named ``*_<i0>_<j0>_<k0>.npy`` (what ``run_pod
--out-dir`` writes) runs the sharded finder without assembling the box.

The mass function (the measured dn/dlog10 M with the Warren 2006 FoF
correction, and the Tinker et al. 2008 overlay at the same masses) is written
to ``hmf.json`` whether or not ``--plots`` is given.

Differences from the JAX script: ``--device`` (default the CUDA card; raises
without one; ``--device cpu`` runs on the CPU), recorded with the card's
name and power limit in ``fof_summary.json`` (FoF and the mass function are
host code); ``--plots`` is off by default and needs matplotlib.

    python -m jax_nbody_emulator_with_dj_tpu_torch.cli.halos \\
        --displacement runs/emulator/psi_emu.npy --boxsize 500 --engine native
"""

from __future__ import annotations

import argparse
import glob
import json
import re
from pathlib import Path

import numpy as np

from ._common import add_device_args, device_of, device_record, pyplot, write_json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--displacement", required=True,
                   help="psi .npy (3, N, N, N) [Mpc/h], or a glob of per-shard pieces named "
                        "*_<i0>_<j0>_<k0>.npy (voxel origins, as run_pod --out-dir writes "
                        "them); pieces are memory-mapped and streamed, never assembled")
    p.add_argument("--boxsize", type=float, required=True)
    p.add_argument("--Om", type=float, default=0.3175)
    p.add_argument("--z", type=float, default=0.0)
    p.add_argument("--linking-length", type=float, default=0.2,
                   help="in mean interparticle spacings")
    p.add_argument("--nmin", type=int, default=20)
    p.add_argument("--engine", choices=("auto", "numpy", "native"), default="auto",
                   help="FoF linking engine: auto prefers the native C++ loop, built on "
                        "demand, and falls back to numpy")
    p.add_argument("--n-slabs", type=int, default=1,
                   help=">1 streams Eulerian x-slabs through the FoF (one slab and its "
                        "ghosts resident; the displacement file is memory-mapped)")
    p.add_argument("--out-dir", type=str, default="runs/halos")
    p.add_argument("--plot-only", action="store_true",
                   help="recompute the mass function (and figures) from the saved catalogue")
    p.add_argument("--plots", action=argparse.BooleanOptionalAction, default=False,
                   help="also draw the figures (needs matplotlib)")
    add_device_args(p)
    return p.parse_args(argv)


def _shard_pieces(pattern: str):
    """``[(memory-mapped piece, origin)]`` and N from per-shard files; raises
    unless the pieces tile the N^3 grid exactly."""
    files = sorted(glob.glob(pattern))
    if not files:
        raise SystemExit(f"no files match {pattern!r}")
    shards, n_part = [], 0
    for f in files:
        m = re.search(r"_(\d+)_(\d+)_(\d+)\.npy$", f)
        if not m:
            raise SystemExit(f"{f}: shard files must be named *_<i0>_<j0>_<k0>.npy")
        origin = tuple(int(g) for g in m.groups())
        piece = np.load(f, mmap_mode="r")
        n_part = max(n_part, *(o + s for o, s in zip(origin, piece.shape[1:])))
        shards.append((piece, origin))
    # a missing shard file would drop its particles from the catalogue
    total = sum(int(np.prod(p.shape[1:])) for p, _ in shards)
    if total != n_part**3:
        raise SystemExit(f"shard pieces cover {total:,} particles but the inferred grid is "
                         f"{n_part}^3 = {n_part**3:,}: missing or overlapping shard files in "
                         f"{pattern!r}")
    origins = [o for _, o in shards]
    if len(set(origins)) != len(origins):
        raise SystemExit(f"duplicate shard origins in {pattern!r}")
    return shards, n_part


def mass_function(lengths, n_part: int, boxsize: float, Om: float, z: float) -> dict:
    """The FoF mass function and the Tinker 2008 overlay at its bin centres."""
    from ..science import eisenstein_hu_pk
    from ..science.halos import empirical_hmf, particle_mass_msun_h, tinker08_hmf

    m_p = particle_mass_msun_h(boxsize, n_part, Om)
    m_centers, dn, err = empirical_hmf(lengths, m_p, boxsize)
    k = np.logspace(-4, 2, 256)
    dn_theory = tinker08_hmf(m_centers, k, eisenstein_hu_pk(k, Om=Om), Om=Om, z=z)
    return {"particle_mass": m_p, "mass": m_centers, "dn_dlog10m": dn, "err": err,
            "tinker08": dn_theory}


def make_plots(out_dir: Path, hmf: dict, lengths, centers, boxsize: float) -> None:
    plt = pyplot()
    fig, ax = plt.subplots(figsize=(6.5, 5))
    ax.errorbar(hmf["mass"], hmf["dn_dlog10m"], yerr=hmf["err"], fmt="o", ms=4,
                label="FoF (corrected)")
    ax.loglog(hmf["mass"], hmf["tinker08"], "k--", label="Tinker et al. 2008")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel(r"$M\ [M_\odot/h]$")
    ax.set_ylabel(r"$dn/d\log_{10}M\ [h^3\,{\rm Mpc}^{-3}]$")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_dir / "hmf.png", dpi=130)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(6, 6))
    sel = centers[:, 0] < boxsize / 8
    ax.scatter(centers[sel, 1], centers[sel, 2], s=np.sqrt(lengths[sel]).clip(1, 30), lw=0,
               alpha=0.6)
    ax.set_xlabel("y [Mpc/h]")
    ax.set_ylabel("z [Mpc/h]")
    ax.set_title(f"halos in x < L/8 slab (N={sel.sum()})")
    fig.tight_layout()
    fig.savefig(out_dir / "halo_slice.png", dpi=130)
    plt.close(fig)


def main(argv: list[str] | None = None) -> dict:
    """Run the finder; returns the summary, the mass function and the files."""
    args = parse_args(argv)
    device = device_of(args)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    from ..science.halos import (
        friends_of_friends,
        friends_of_friends_sharded,
        friends_of_friends_slabbed,
        positions_from_displacement,
    )

    cat_path = out_dir / "halo_catalog.npz"
    if args.plot_only:
        with np.load(cat_path) as cat:
            lengths, centers = cat["lengths"], cat["centers"]
        meta = json.loads((out_dir / "fof_summary.json").read_text())
        n_part = meta["n_part"]
    else:
        extra = {}
        if any(c in args.displacement for c in "*?["):
            shards, n_part = _shard_pieces(args.displacement)
            b_abs = args.linking_length * args.boxsize / n_part
            n_slabs = max(args.n_slabs, 1)
            print(f"sharded FoF over {len(shards)} pieces (N={n_part}), b = {b_abs:.4f} Mpc/h, "
                  f"{n_slabs} Eulerian slab(s) ...", flush=True)
            fof = friends_of_friends_sharded(shards, n_part, args.boxsize, b_abs, nmin=args.nmin,
                                             n_slabs=n_slabs, engine=args.engine)
            extra = {"n_shards": len(shards)}
        else:
            psi = np.load(args.displacement, mmap_mode="r" if args.n_slabs > 1 else None)
            n_part = psi.shape[1]
            b_abs = args.linking_length * args.boxsize / n_part
            print(f"FoF over {n_part**3:,} particles, b = {b_abs:.4f} Mpc/h ({args.n_slabs} "
                  f"slab{'s' if args.n_slabs > 1 else ''}) ...", flush=True)
            if args.n_slabs > 1:
                fof = friends_of_friends_slabbed(psi, args.boxsize, b_abs, nmin=args.nmin,
                                                 n_slabs=args.n_slabs, engine=args.engine)
            else:
                pos = positions_from_displacement(psi, args.boxsize)
                fof = friends_of_friends(pos, args.boxsize, b_abs, nmin=args.nmin,
                                         engine=args.engine)
        lengths, centers = fof["lengths"], fof["centers"]
        np.savez(cat_path, lengths=lengths, centers=centers)
        meta = {
            "n_part": int(n_part),
            "boxsize": args.boxsize,
            "Om": args.Om,
            "z": args.z,
            "linking_length": args.linking_length,
            "nmin": args.nmin,
            "n_halos": int(fof["n_groups"]),
            "largest_halo_particles": int(lengths.max()) if len(lengths) else 0,
            **extra,
            "engine": args.engine,
            "n_slabs": args.n_slabs,
            **device_record(device),
        }
        write_json(out_dir / "fof_summary.json", meta)
        print(json.dumps(meta, indent=2))

    hmf = None
    if len(lengths):
        hmf = mass_function(lengths, n_part, args.boxsize, args.Om, args.z)
        write_json(out_dir / "hmf.json", hmf)
        if args.plots:
            make_plots(out_dir, hmf, lengths, centers, args.boxsize)
            print(f"plots written to {out_dir}")
    return {"out_dir": str(out_dir), "summary": meta, "hmf": hmf, "lengths": lengths,
            "centers": centers, "files": sorted(p.name for p in out_dir.iterdir())}


if __name__ == "__main__":
    main()
