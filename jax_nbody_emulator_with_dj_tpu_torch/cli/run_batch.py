"""Production batch driver: many displacement boxes through one emulator.

Counterpart of the JAX package's ``scripts/run_jax_emulator.py``: takes a
glob of input displacement ``.npy`` files of shape (3, N, N, N) plus per-file
(z, Om) cosmologies (``--cosmo-json`` maps a file's basename to ``{z, Om}``),
validates their ranges, and runs them through one style emulator shared by
every cosmology (``--style``: each box's fold, then kernels B1/B2 with
``--runtime auto`` on the card) or through a premodulated emulator per
(z, Om), of which only the latest is kept.  Writes ``<name>_disp.npy``,
``<name>_vel.npy`` and ``batch_summary.json`` (one record per file), as the
JAX script does.

Differences from the JAX script: ``--device`` (default the CUDA card; raises
without one; ``--device cpu`` runs on the CPU); each record also carries
``device`` and ``card``; ``--matmul-precision`` sets
``torch.set_float32_matmul_precision`` (``default`` is torch's ``medium``);
there is no ``--compilation-cache``, since the kernels are built once into
the package's ``_build/`` and nothing else is compiled.

    python -m jax_nbody_emulator_with_dj_tpu_torch.cli.run_batch \\
        --inputs 'boxes/*.npy' --out-dir runs/batch --style --runtime auto --random-params
"""

from __future__ import annotations

import argparse
import glob
import json
import time
from pathlib import Path

import numpy as np
import torch

from ._common import (
    OUTPUT_DTYPE,
    PRECISION,
    add_device_args,
    add_params_args,
    device_of,
    device_record,
    plan_config,
    resolve_params,
    write_json,
)

MATMUL_PRECISION = {"default": "medium", "high": "high", "highest": "highest"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--inputs", required=True,
                   help="glob of input displacement .npy files (3,N,N,N)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--z", type=float, default=0.0, help="output redshift (all files)")
    p.add_argument("--Om", type=float, default=0.3175)
    p.add_argument("--cosmo-json", type=str, default=None,
                   help="JSON file mapping input basename -> {z, Om} (overrides --z/--Om)")
    p.add_argument("--ndiv", type=int, nargs=3, default=(4, 4, 8))
    p.add_argument("--runtime", choices=("subbox", "auto"), default="subbox",
                   help="auto = the hierarchical runtime with planner-chosen geometry "
                        "(ndiv ignored; kernels B1/B2 on the card)")
    p.add_argument("--precision", choices=("bf16", "f16", "f32"), default="bf16")
    p.add_argument("--output-dtype", choices=("f16", "f32"), default="f32")
    p.add_argument("--compute-vel", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--style", action="store_true",
                   help="one style emulator reused across cosmologies "
                        "(default: per-cosmology premodulated)")
    add_params_args(p)
    p.add_argument("--mid-chan", type=int, default=64)
    p.add_argument("--matmul-precision", default=None, choices=(None, "default", "high", "highest"))
    add_device_args(p)
    return p.parse_args(argv)


def validate(z: float, om: float, path: str):
    if not (0.0 <= z <= 3.0):
        raise ValueError(f"{path}: z={z} outside [0, 3]")
    if not (0.1 <= om <= 0.5):
        raise ValueError(f"{path}: Om={om} outside [0.1, 0.5]")


def main(argv: list[str] | None = None) -> dict:
    """Run the batch; returns the records and the output files."""
    args = parse_args(argv)
    device = device_of(args)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if args.matmul_precision:
        torch.set_float32_matmul_precision(MATMUL_PRECISION[args.matmul_precision])

    from ..emulator import create_emulator
    from ..subbox import SubboxConfig

    files = sorted(glob.glob(args.inputs))
    if not files:
        raise SystemExit(f"no inputs match {args.inputs}")
    cosmo_map = json.loads(Path(args.cosmo_json).read_text()) if args.cosmo_json else {}
    params, load_params = resolve_params(args)
    dtype = PRECISION[args.precision]
    out_dtype = OUTPUT_DTYPE[args.output_dtype]
    record_device = device_record(device)

    emulators: dict = {}
    records, written = [], []
    for path in files:
        name = Path(path).stem
        cz = cosmo_map.get(Path(path).name, {})
        z = float(cz.get("z", args.z))
        om = float(cz.get("Om", args.Om))
        validate(z, om, path)

        box = np.load(path)
        if box.ndim != 4 or box.shape[0] != 3 or len(set(box.shape[1:])) != 1:
            raise ValueError(f"{path}: expected (3, N, N, N), got {box.shape}")
        n = box.shape[1]

        emu_key = ("style", n) if args.style else (z, om, n)
        if emu_key not in emulators:
            # Premodulated emulators are one per (z, Om): keep only the most
            # recent, so a long batch of distinct cosmologies does not hold a
            # weight tree per file (--style shares one emulator).
            if not args.style:
                emulators.clear()
            if args.runtime == "auto":
                cfg = plan_config(n, device, dtype=dtype, compute_vel=args.compute_vel,
                                  output_dtype=out_dtype, mid_chan=args.mid_chan)
            else:
                cfg = SubboxConfig(size=(n,) * 3, ndiv=tuple(args.ndiv), dtype=dtype,
                                   output_dtype=out_dtype)
            emulators[emu_key] = create_emulator(
                premodulate=not args.style,
                compute_vel=args.compute_vel,
                load_params=load_params,
                params=params,
                processor_config=cfg,
                premodulate_z=None if args.style else z,
                premodulate_Om=None if args.style else om,
                mid_chan=args.mid_chan,
                device=device,
            )
        emulator = emulators[emu_key]

        t0 = time.perf_counter()
        out = emulator.process_box(box, z=z, Om=om)  # host numpy: ends in a device sync
        elapsed = time.perf_counter() - t0
        if args.compute_vel:
            disp, vel = out
            np.save(out_dir / f"{name}_vel.npy", vel)
            written.append(f"{name}_vel.npy")
        else:
            disp = out
        np.save(out_dir / f"{name}_disp.npy", disp)
        written.append(f"{name}_disp.npy")
        rec = {"input": path, "z": z, "Om": om, "n": n, "seconds": round(elapsed, 3),
               "voxels_per_sec": round(n**3 / elapsed, 1), **record_device}
        records.append(rec)
        print(json.dumps(rec), flush=True)

    write_json(out_dir / "batch_summary.json", records)
    return {"out_dir": str(out_dir), "records": records,
            "files": sorted(written + ["batch_summary.json"])}


if __name__ == "__main__":
    main()
