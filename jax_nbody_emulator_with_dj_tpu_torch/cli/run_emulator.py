"""End-to-end emulation driver: IC -> 1LPT -> emulator -> density -> figures.

Counterpart of the JAX package's ``scripts/run_emulator.py``, with its
arguments and defaults, its output files (``delta_lin.npy``,
``delta_lpt.npy``, ``delta_emu.npy``, ``psi_emu.npy``, ``vel_emu.npy``,
``metadata.json``) and metadata keys, so that the same downstream code reads
a run of either.  It runs ``run_lpt_emulator_pipeline`` in mode A
(``--seed``: a Gaussian random field from a ``torch.Generator``) or mode B
(``--input-delta``).  ``--runtime auto`` takes the planned hierarchical
runtime, whose packed convs run kernel B2 for a velocity model and B1 for a
displacement one on the card; ``--runtime subbox`` the model's unpacked
forward.

Differences from the JAX script: ``--device`` (default the CUDA card; raises
without one; ``--device cpu`` runs on the CPU); ``metadata.json`` also
carries ``card``, the card's name and power limit; ``--plots`` is off by
default and needs matplotlib, while each figure's data is always written
(``density_slices.npy``, ``power_spectrum.json``, ``minkowski.json``);
``--plot-only`` recomputes that data from the saved fields.

    python -m jax_nbody_emulator_with_dj_tpu_torch.cli.run_emulator --seed 42 \\
        --n-part 256 --boxsize 500 --runtime auto --random-params --out-dir runs/demo
    python -m jax_nbody_emulator_with_dj_tpu_torch.cli.run_emulator \\
        --input-delta delta.npy --n-part 16 --boxsize 250 --ndiv 1 1 1 \\
        --precision f32 --random-params --mid-chan 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ._common import (
    add_device_args,
    add_params_args,
    device_of,
    device_record,
    pyplot,
    resolve_params,
    write_json,
)

SLICE_TITLES = ("linear (z=0 norm)", "1LPT", "emulator")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    ic = p.add_mutually_exclusive_group()
    ic.add_argument("--seed", type=int, default=None, help="GRF seed (IC mode A)")
    ic.add_argument("--input-delta", type=str, default=None, help=".npy linear field (IC mode B)")
    p.add_argument("--n-part", type=int, default=256)
    p.add_argument("--boxsize", type=float, default=1000.0)
    p.add_argument("--z", type=float, default=0.0)
    p.add_argument("--Om", type=float, default=0.3175)
    p.add_argument("--Ob", type=float, default=0.049)
    p.add_argument("--h", dest="h_param", type=float, default=0.6711)
    p.add_argument("--ns", type=float, default=0.9624)
    p.add_argument("--sigma8", type=float, default=0.834)
    p.add_argument("--ndiv", type=int, nargs=3, default=(2, 2, 2))
    p.add_argument("--runtime", choices=("subbox", "auto"), default="subbox",
                   help="auto = the hierarchical runtime with planner-chosen geometry "
                        "(ndiv ignored; kernels B1/B2 on the card)")
    p.add_argument("--precision", choices=("bf16", "f16", "f32"), default="bf16")
    p.add_argument("--no-style", dest="premodulate", action="store_true",
                   help="premodulate (fixed cosmology) instead of runtime style")
    p.add_argument("--compute-vel", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--pk-table", type=str, default=None,
                   help="external linear z=0 P(k) table (CLASS .dat / .npy / .npz) "
                        "replacing the in-package EH98")
    p.add_argument("--mas-worder", type=int, default=2, choices=(1, 2, 3, 4))
    p.add_argument("--deconvolve", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--num-sims", type=int, default=1)
    add_params_args(p)
    p.add_argument("--mid-chan", type=int, default=64)
    p.add_argument("--out-dir", type=str, default="runs/emulator")
    p.add_argument("--save-fields", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--plots", action=argparse.BooleanOptionalAction, default=False,
                   help="also draw the figures (needs matplotlib)")
    p.add_argument("--plot-only", action="store_true",
                   help="recompute the figures' data (and figures) from saved fields")
    add_device_args(p)
    return p.parse_args(argv)


def figure_data(out_dir: Path, delta_lin, delta_lpt, delta_emu, boxsize, cosmo, z,
                device, pk_table=None) -> dict:
    """The data of the three figures, written to ``out_dir`` and returned:
    projected density slices, P(k) of 1LPT and the emulator beside linear
    theory, and the emulated field's Minkowski functionals."""
    from ..cosmology import growth_factor
    from ..science import eisenstein_hu_pk, minkowski_functionals, power_spectrum
    from ..science._common import to_numpy
    from ..science.linear_pk import load_pk_table

    fields = [np.asarray(f, np.float32) for f in (delta_lin, delta_lpt, delta_emu)]
    with np.errstate(invalid="ignore"):  # a contrast below -2 has no log (NaN, as plotted)
        slices = np.stack([np.log10(2.0 + f[: f.shape[0] // 8].mean(axis=0)) for f in fields])
    np.save(out_dir / "density_slices.npy", slices)

    dz = float(growth_factor(z, cosmo["Om"]))
    spectra = {}
    for f, label in ((fields[1], "1LPT"), (fields[2], "emulator")):
        k, pk, _ = (to_numpy(t) for t in power_spectrum(torch.from_numpy(f).to(device), boxsize))
        spectra[label] = pk
    if pk_table is not None:
        kt, pt = load_pk_table(pk_table)
        p_lin = np.exp(np.interp(np.log(k), np.log(kt), np.log(pt))) * dz**2
        lin_label = f"linear table (z={z})"
    else:
        p_lin = eisenstein_hu_pk(k, Om=cosmo["Om"], Ob=cosmo["Ob"], h=cosmo["h"],
                                 ns=cosmo["ns"], sigma8=cosmo["sigma8"]) * dz**2
        lin_label = f"linear EH98 (z={z})"
    pk_data = {"k": k, "pk": spectra, "p_lin": p_lin, "lin_label": lin_label}
    write_json(out_dir / "power_spectrum.json", pk_data)

    sigma = float(np.std(fields[2]))
    ts = np.linspace(-2, 4, 25) * sigma
    mf = to_numpy(minkowski_functionals(torch.from_numpy(fields[2]).to(device), ts))
    mink = {"nu": ts / sigma, "thresholds": ts, "V": mf}
    write_json(out_dir / "minkowski.json", mink)
    return {"slices": slices, "power_spectrum": pk_data, "minkowski": mink}


def make_plots(out_dir: Path, data: dict) -> None:
    plt = pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    for ax, sl, title in zip(axes, data["slices"], SLICE_TITLES):
        im = ax.imshow(sl, origin="lower", cmap="inferno")
        ax.set_title(title)
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(out_dir / "density_slices.png", dpi=130)
    plt.close(fig)

    pk = data["power_spectrum"]
    fig, ax = plt.subplots(figsize=(7, 5))
    for label, p in pk["pk"].items():
        ax.loglog(pk["k"], p, label=label)
    ax.loglog(pk["k"], pk["p_lin"], "k--", label=pk["lin_label"])
    ax.set_xlabel("k [h/Mpc]")
    ax.set_ylabel("P(k) [(Mpc/h)^3]")
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_dir / "power_spectrum.png", dpi=130)
    plt.close(fig)

    mk = data["minkowski"]
    fig, axes = plt.subplots(1, 4, figsize=(16, 4))
    for i, (ax, name) in enumerate(zip(axes, ["V0", "V1", "V2", "V3"])):
        ax.plot(mk["nu"], mk["V"][:, i])
        ax.set_xlabel(r"$\nu = \delta/\sigma$")
        ax.set_title(name)
    fig.tight_layout()
    fig.savefig(out_dir / "minkowski.png", dpi=130)
    plt.close(fig)


def _written(out_dir: Path, meta: dict) -> dict:
    return {"out_dir": str(out_dir), "metadata": meta,
            "files": sorted(p.name for p in out_dir.iterdir())}


def main(argv: list[str] | None = None) -> dict:
    """Run the driver; returns the metadata and the files of ``--out-dir``."""
    args = parse_args(argv)
    device = device_of(args)
    out_dir = Path(args.out_dir)
    cosmo = {"Om": args.Om, "Ob": args.Ob, "h": args.h_param, "ns": args.ns,
             "sigma8": args.sigma8}

    if args.plot_only:
        fields = [np.load(out_dir / f"{name}.npy") for name in ("delta_lin", "delta_lpt",
                                                                "delta_emu")]
        meta = json.loads((out_dir / "metadata.json").read_text())
        saved_pk = meta.get("pk_table")
        data = figure_data(out_dir, *fields, meta["boxsize"], meta["cosmology"], meta["z"],
                           device, pk_table=None if saved_pk in (None, "eh98", "external-array")
                           else saved_pk)
        if args.plots:
            make_plots(out_dir, data)
        print(f"figure data written to {out_dir}")
        return _written(out_dir, meta)

    from ..pipeline import run_lpt_emulator_pipeline

    params, load_params = resolve_params(args)
    seed = args.seed if (args.seed is not None or args.input_delta) else 42
    input_delta = np.load(args.input_delta) if args.input_delta else None

    result = run_lpt_emulator_pipeline(
        seed=seed,
        input_delta=input_delta,
        n_part=args.n_part,
        boxsize=args.boxsize,
        z=args.z,
        cosmo=cosmo,
        pk_table=args.pk_table,
        params=params,
        load_params=load_params,
        premodulate=args.premodulate,
        compute_vel=args.compute_vel,
        ndiv=tuple(args.ndiv),
        runtime=args.runtime,
        precision=args.precision,
        mas_worder=args.mas_worder,
        deconvolve=args.deconvolve,
        num_sims=args.num_sims,
        out_dir=out_dir,
        save_fields=args.save_fields,
        mid_chan=args.mid_chan,
        device=device,
    )
    meta = {**result.metadata, **device_record(device)}
    write_json(out_dir / "metadata.json", meta)
    print(json.dumps({k: v for k, v in meta.items() if k != "timings"}, default=str))
    print("timings:", json.dumps(result.timings, default=str))

    data = figure_data(out_dir, result.delta_lin, result.delta_lpt, result.delta_emu,
                       args.boxsize, cosmo, args.z, device, pk_table=args.pk_table)
    if args.plots:
        make_plots(out_dir, data)
        print(f"plots written to {out_dir}")
    return _written(out_dir, meta)


if __name__ == "__main__":
    main()
