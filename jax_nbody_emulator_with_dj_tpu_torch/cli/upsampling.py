"""Upsampling-fidelity diagnostic.

Counterpart of the JAX package's ``scripts/test_upsampling.py`` (renamed so
that pytest never collects it as a test module): draws a Gaussian random
field from EH98, upsamples it by mode injection (the coarse modes kept, new
high-k modes drawn), compares the fine field's P(k) with EH98, block-averages
it back down, and reports C(k) of the round trip against the original, with
the stages' seconds, in ``metadata.json`` (the JAX script's keys).

Differences from the JAX script: the fields come from ``torch.Generator``s
on the device seeded with ``--seed`` and ``--seed + 1`` (JAX keys cannot be
matched); ``--device`` (default the CUDA card; raises without one;
``--device cpu`` runs on the CPU); ``metadata.json`` also carries ``card``;
``--plots`` is off by default and needs matplotlib, while the figure's data
is always written (``upsampling.json``).

    python -m jax_nbody_emulator_with_dj_tpu_torch.cli.upsampling --n-in 128 --factor 2
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from ._common import add_device_args, device_of, device_record, pyplot, write_json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--n-in", type=int, default=128)
    p.add_argument("--factor", type=int, default=2)
    p.add_argument("--boxsize", type=float, default=1000.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out-dir", type=str, default="runs/upsampling")
    p.add_argument("--plots", action=argparse.BooleanOptionalAction, default=False,
                   help="also draw the figure (needs matplotlib)")
    add_device_args(p)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Run the diagnostic; returns the metadata and the figure's data."""
    args = parse_args(argv)
    device = device_of(args)

    from ..science import (
        cross_power,
        downsample_average,
        eisenstein_hu_pk,
        gaussian_random_field,
        power_spectrum,
        upsample_modes,
    )
    from ..science._common import to_numpy
    from ..utils.timing import force_sync

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n_out = args.n_in * args.factor
    timings = {}

    k_tab = np.logspace(-4, 2, 512)
    p_tab = eisenstein_hu_pk(k_tab)

    def generator(seed):
        return torch.Generator(device=device).manual_seed(seed)

    t0 = time.perf_counter()
    coarse = gaussian_random_field(generator(args.seed), args.n_in, args.boxsize, k_tab, p_tab,
                                   device=device)
    force_sync(coarse)
    timings["grf_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    fine = upsample_modes(coarse, n_out, args.boxsize, k_tab, p_tab,
                          generator=generator(args.seed + 1))
    force_sync(fine)
    timings["upsample_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    back = downsample_average(fine, args.n_in)
    force_sync(back)
    timings["downsample_seconds"] = time.perf_counter() - t0

    k_c, p_c, _ = (to_numpy(t) for t in power_spectrum(coarse, args.boxsize))
    k_f, p_f, _ = (to_numpy(t) for t in power_spectrum(fine, args.boxsize))
    _, p_x, _ = (to_numpy(t) for t in cross_power(back, coarse, args.boxsize))
    _, p_b, _ = (to_numpy(t) for t in power_spectrum(back, args.boxsize))
    c_k = p_x / np.sqrt(np.maximum(p_b * p_c, 1e-30))

    p_target_f = np.interp(k_f, k_tab, p_tab)
    ratio = p_f / p_target_f
    meta = {
        "n_in": args.n_in,
        "n_out": n_out,
        "boxsize": args.boxsize,
        "timings": timings,
        "fine_pk_over_target_median": float(np.median(ratio)),
        "low_k_c_of_downsampled": float(np.mean(c_k[: len(c_k) // 4])),
        "seed": args.seed,
        **device_record(device),
    }
    write_json(out_dir / "metadata.json", meta)
    print(json.dumps(meta, indent=2))
    data = {"k_coarse": k_c, "pk_coarse": p_c, "k_fine": k_f, "pk_fine": p_f,
            "pk_target_fine": p_target_f, "c_of_downsampled": c_k}
    write_json(out_dir / "upsampling.json", data)

    if args.plots:
        plt = pyplot()
        fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
        axes[0].loglog(k_c, p_c, label=f"coarse {args.n_in}")
        axes[0].loglog(k_f, p_f, label=f"upsampled {n_out}")
        axes[0].loglog(k_f, p_target_f, "k--", label="target EH98")
        axes[0].set_xlabel("k [h/Mpc]"); axes[0].set_ylabel("P(k)"); axes[0].legend()
        axes[1].semilogx(k_c, c_k)
        axes[1].axhline(1, color="k", lw=0.5)
        axes[1].set_xlabel("k [h/Mpc]"); axes[1].set_ylabel("C(k) down(up(x)) vs x")
        fig.tight_layout()
        fig.savefig(out_dir / "upsampling.png", dpi=130)
        plt.close(fig)
        print(f"plots written to {out_dir}")
    return {"out_dir": str(out_dir), "metadata": meta, "data": data,
            "files": sorted(p.name for p in out_dir.iterdir())}


if __name__ == "__main__":
    main()
