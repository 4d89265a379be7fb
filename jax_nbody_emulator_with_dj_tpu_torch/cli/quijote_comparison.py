"""Validate the emulator against a target N-body (e.g. Quijote) realization.

Counterpart of the JAX package's ``scripts/quijote_comparison.py``: loads a
target linear IC and nonlinear density pair, runs the pipeline in mode B on
the same IC (the premodulated displacement model), and writes the scalar
metric dict of the emulator and of 1LPT against the target into
``metadata.json`` under ``metrics`` (``science.summary_metrics``: RMSE,
Pearson r, moments, |T-1| and mean 1-C up to ``--kmax``).

Target files: ``--target-delta`` (nonlinear density, ``.npy`` or torch
``.pt``) and ``--ic-delta`` (linear IC density).  ``--ic-z`` rescales the IC
to z=0 by the exact growth ratio D(0)/D(ic_z).  ``--mesh`` computes every
statistic with the ``*_sharded`` estimators on a mesh over ``--devices``
(``--mesh 2 2 2 --devices cuda``: eight virtual shards of one card).

Differences from the JAX script: ``--device`` (default the CUDA card; raises
without one; ``--device cpu`` runs on the CPU) and ``--devices``;
``metadata.json`` also carries ``card``; ``--plots`` is off by default and
needs matplotlib, while the data of its five figures is always written:
``slices.npy``, ``spectra.json`` (P, T and C of k), ``pdf.json``,
``bispectrum.json`` and ``minkowski.json``.

    python -m jax_nbody_emulator_with_dj_tpu_torch.cli.quijote_comparison \\
        --ic-delta ic.npy --target-delta target.npy --n-part 256 --boxsize 500 \\
        --random-params --out-dir runs/quijote
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
    cli_mesh,
    device_of,
    device_record,
    pyplot,
    resolve_params,
    write_json,
)

BISPECTRUM_CONFIGS = ((0.1, 0.1), (0.05, 0.1))  # (k1, k2) [h/Mpc], the reference's two


def load_field(path: str) -> np.ndarray:
    """A field from ``.npy`` or a torch ``.pt`` file, as float32 numpy."""
    p = Path(path)
    if p.suffix == ".pt":
        t = torch.load(p, map_location="cpu", weights_only=False)
        return np.asarray(t.numpy() if hasattr(t, "numpy") else t, np.float32)
    return np.asarray(np.load(p), np.float32)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--ic-delta", required=True, help="linear IC density (.npy/.pt)")
    p.add_argument("--target-delta", required=True, help="target nonlinear density (.npy/.pt)")
    p.add_argument("--ic-z", type=float, default=0.0, help="redshift of the IC normalization")
    p.add_argument("--z", type=float, default=0.0, help="output redshift")
    p.add_argument("--boxsize", type=float, default=1000.0)
    p.add_argument("--n-part", type=int, default=512)
    p.add_argument("--Om", type=float, default=0.3175)
    p.add_argument("--Ob", type=float, default=0.049)
    p.add_argument("--h", dest="h_param", type=float, default=0.6711)
    p.add_argument("--ns", type=float, default=0.9624)
    p.add_argument("--sigma8", type=float, default=0.834)
    p.add_argument("--pk-table", type=str, default=None,
                   help="external linear z=0 P(k) table (CLASS .dat / .npy / .npz) "
                        "replacing the in-package EH98")
    p.add_argument("--ndiv", type=int, nargs=3, default=(4, 4, 8))
    p.add_argument("--precision", choices=("bf16", "f16", "f32"), default="bf16")
    p.add_argument("--mas-worder", type=int, default=2)
    add_params_args(p)
    p.add_argument("--mid-chan", type=int, default=64)
    p.add_argument("--kmax", type=float, default=0.5, help="metric cut [h/Mpc]")
    p.add_argument("--mesh", type=int, nargs=3, default=None,
                   help="compute the statistics on a mesh with the sharded estimators")
    p.add_argument("--out-dir", type=str, default="runs/quijote")
    p.add_argument("--plots", action=argparse.BooleanOptionalAction, default=False,
                   help="also draw the figures (needs matplotlib)")
    add_device_args(p, devices=True)
    return p.parse_args(argv)


def _estimators(args, device):
    """(metrics, transfer, bispectrum, Minkowski) functions, single-device or sharded."""
    from .. import science as sci

    if args.mesh and int(np.prod(args.mesh)) > 1:
        mesh = cli_mesh(args.mesh, args.devices, device)
        return (
            lambda a, b: sci.summary_metrics_sharded(a, b, mesh, args.boxsize, kmax=args.kmax),
            lambda a, b: sci.transfer_and_correlation_sharded(a, b, mesh, args.boxsize),
            lambda f, k1, k2, th: sci.reduced_bispectrum_sharded(f, mesh, args.boxsize, k1, k2,
                                                                 th),
            lambda f, ts: sci.minkowski_functionals_sharded(f, ts, mesh),
        )
    return (
        lambda a, b: sci.summary_metrics(a, b, args.boxsize, kmax=args.kmax),
        lambda a, b: sci.transfer_and_correlation(a, b, args.boxsize),
        lambda f, k1, k2, th: sci.reduced_bispectrum(f, args.boxsize, k1, k2, th),
        lambda f, ts: sci.minkowski_functionals(f, ts),
    )


def figure_data(out_dir: Path, fields: dict, args, transfer_fn, bispec_fn, mink_fn) -> dict:
    """The data of the five figures, written to ``out_dir`` and returned."""
    from ..science import power_spectrum
    from ..science._common import to_numpy

    target = fields["target"]
    with np.errstate(invalid="ignore"):  # a contrast below -2 has no log (NaN, as plotted)
        slices = np.stack([np.log10(2.0 + to_numpy(f[0])) for f in fields.values()])
    np.save(out_dir / "slices.npy", slices)

    spectra = {"pk": {}, "transfer": {}, "correlation": {}}
    for label, f in fields.items():
        k, pk, _ = (to_numpy(t) for t in power_spectrum(f, args.boxsize))
        spectra["pk"][label] = {"k": k, "pk": pk}
    for label in ("emulator", "1LPT"):
        k, t, c = (to_numpy(v) for v in transfer_fn(fields[label], target))
        spectra["transfer"][label] = {"k": k, "T": t}
        spectra["correlation"][label] = {"k": k, "C": c}
    write_json(out_dir / "spectra.json", spectra)

    bins = np.linspace(-1, 6, 100)
    pdf = {"bins": bins}
    for label, f in fields.items():
        pdf[label], _ = np.histogram(to_numpy(f).ravel(), bins=bins, density=True)
    write_json(out_dir / "pdf.json", pdf)

    thetas = np.linspace(0.1, np.pi - 0.1, 15)
    bispec = {"theta": thetas, "configs": []}
    for k1, k2 in BISPECTRUM_CONFIGS:
        q = {label: bispec_fn(fields[label], k1, k2, thetas)["Q"]
             for label in ("target", "emulator")}
        bispec["configs"].append({"k1": k1, "k2": k2, "Q": q})
    write_json(out_dir / "bispectrum.json", bispec)

    sigma = float(to_numpy(target).std())
    ts = np.linspace(-2, 4, 25) * sigma
    mink = {"nu": ts / sigma, "thresholds": ts,
            "V": {label: to_numpy(mink_fn(fields[label], ts))
                  for label in ("target", "emulator")}}
    write_json(out_dir / "minkowski.json", mink)
    return {"spectra": spectra, "pdf": pdf, "bispectrum": bispec, "minkowski": mink}


def make_plots(out_dir: Path, slices, data: dict) -> None:
    plt = pyplot()
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    for ax, sl, title in zip(axes, slices, ("target", "emulator", "1LPT")):
        im = ax.imshow(sl, origin="lower", cmap="inferno")
        ax.set_title(title)
        fig.colorbar(im, ax=ax, fraction=0.046)
    fig.tight_layout()
    fig.savefig(out_dir / "slices.png", dpi=130)
    plt.close(fig)

    sp = data["spectra"]
    fig, axes = plt.subplots(1, 3, figsize=(16, 4.5))
    for label, v in sp["pk"].items():
        axes[0].loglog(v["k"], v["pk"], label=label)
    axes[0].set_xlabel("k"); axes[0].set_ylabel("P(k)"); axes[0].legend()
    for ax, key, q in ((axes[1], "transfer", "T"), (axes[2], "correlation", "C")):
        for label, v in sp[key].items():
            ax.semilogx(v["k"], v[q], label=label)
        ax.axhline(1, color="k", lw=0.5); ax.set_ylabel(f"{q}(k)"); ax.legend()
    fig.tight_layout()
    fig.savefig(out_dir / "spectra.png", dpi=130)
    plt.close(fig)

    pdf = data["pdf"]
    fig, ax = plt.subplots(figsize=(6, 4.5))
    for label in ("target", "emulator", "1LPT"):
        ax.stairs(pdf[label], pdf["bins"], label=label)
    ax.set_yscale("log"); ax.set_xlabel(r"$\delta$"); ax.legend()
    fig.tight_layout()
    fig.savefig(out_dir / "pdf.png", dpi=130)
    plt.close(fig)

    bs = data["bispectrum"]
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    for ax, cfg in zip(axes, bs["configs"]):
        for label, q in cfg["Q"].items():
            ax.plot(bs["theta"], q, label=label)
        ax.set_title(f"k1={cfg['k1']}, k2={cfg['k2']}"); ax.set_xlabel(r"$\theta$")
        ax.set_ylabel("Q"); ax.legend()
    fig.tight_layout()
    fig.savefig(out_dir / "bispectrum.png", dpi=130)
    plt.close(fig)

    mk = data["minkowski"]
    fig, axes = plt.subplots(1, 4, figsize=(16, 4))
    for label, mf in mk["V"].items():
        for i, ax in enumerate(axes):
            ax.plot(mk["nu"], mf[:, i], label=label)
    for ax, name in zip(axes, ["V0", "V1", "V2", "V3"]):
        ax.set_title(name); ax.set_xlabel(r"$\nu$")
    axes[0].legend()
    fig.tight_layout()
    fig.savefig(out_dir / "minkowski.png", dpi=130)
    plt.close(fig)


def main(argv: list[str] | None = None) -> dict:
    """Run the comparison; returns the metadata (with ``metrics``) and the files."""
    args = parse_args(argv)
    device = device_of(args)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cosmo = {"Om": args.Om, "Ob": args.Ob, "h": args.h_param, "ns": args.ns,
             "sigma8": args.sigma8}

    from ..cosmology import growth_factor
    from ..pipeline import run_lpt_emulator_pipeline

    ic = load_field(args.ic_delta)
    target = load_field(args.target_delta)
    if args.ic_z != 0.0:  # rescale the IC to z=0 with the exact growth ratio
        ic = ic * (float(growth_factor(0.0, args.Om)) / float(growth_factor(args.ic_z, args.Om)))

    params, load_params = resolve_params(args)
    result = run_lpt_emulator_pipeline(
        input_delta=ic,
        seed=0,
        n_part=args.n_part,
        boxsize=args.boxsize,
        z=args.z,
        cosmo=cosmo,
        pk_table=args.pk_table,
        params=params,
        load_params=load_params,
        premodulate=True,
        compute_vel=False,
        ndiv=tuple(args.ndiv),
        precision=args.precision,
        mas_worder=args.mas_worder,
        out_dir=out_dir,
        save_fields=True,
        mid_chan=args.mid_chan,
        device=device,
    )
    if target.shape != result.delta_emu.shape:
        raise ValueError(f"target shape {target.shape} != emulated {result.delta_emu.shape}")

    metric_fn, transfer_fn, bispec_fn, mink_fn = _estimators(args, device)
    fields = {name: torch.from_numpy(np.ascontiguousarray(f)).to(device)
              for name, f in (("target", target), ("emulator", result.delta_emu),
                              ("1LPT", result.delta_lpt))}
    metrics = {
        "emulator_vs_target": metric_fn(fields["emulator"], fields["target"]),
        "lpt_vs_target": metric_fn(fields["1LPT"], fields["target"]),
    }
    meta = {**result.metadata, **device_record(device), "metrics": metrics}
    write_json(out_dir / "metadata.json", meta)
    print(json.dumps(metrics, indent=2))

    data = figure_data(out_dir, fields, args, transfer_fn, bispec_fn, mink_fn)
    if args.plots:
        make_plots(out_dir, np.load(out_dir / "slices.npy"), data)
        print(f"plots written to {out_dir}")
    return {"out_dir": str(out_dir), "metadata": meta,
            "files": sorted(p.name for p in out_dir.iterdir())}


if __name__ == "__main__":
    main()
