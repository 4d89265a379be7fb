"""Sharded emulation driver: one box decomposed over a mesh of devices.

Counterpart of the JAX package's ``examples/run_pod.py``: ``--mesh`` over
``--devices`` (default: the visible CUDA cards), where one device name
repeated is a mesh of virtual shards (``--mesh 2 2 2 --devices cuda`` runs
eight shards on one card).  A multi-process run starts the same command in
every process with ``--coordinator host:port --num-processes P --process-id
r`` (``parallel.initialize``: a gloo group); each process then drives its own
``1/P`` of the shards on its ``--devices``, and process 0 prints.  A mesh
with more shards than a process has devices for raises.  The input is
made on the mesh (``--ic-seed``: EH98 P(k) -> sharded Gaussian random field
-> sharded Zel'dovich displacement, never gathered), read shard by shard
from a memory-mapped ``--input``, or drawn per shard (the benchmark mode).
``ShardedBoxProcessor`` runs the box twice (a warm-up, then a timed call);
``--validate`` deposits the emulated displacement to a density on the mesh
and prints its P(k) (pencil FFT; every process gets the same spectrum);
``--out-dir`` writes one file per shard and output, ``dis_<i0>_<j0>_<k0>.npy``
/ ``vel_...`` (what ``halos`` reads), each process its own shards.

Differences from the JAX example: ``--device`` (default the CUDA card;
raises without one; ``--device cpu`` runs on the CPU, the mesh then on the
CPU repeated) and ``--devices`` (this process's); the GRF comes from a
``torch.Generator`` seeded with ``--ic-seed``.

    python -m jax_nbody_emulator_with_dj_tpu_torch.cli.run_pod --size 128 \\
        --mesh 2 2 2 --devices cuda --ic-seed 5 --validate
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ._common import add_device_args, device_of, mesh_devices


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", type=int, default=2048)
    p.add_argument("--z", type=float, default=0.0)
    p.add_argument("--Om", type=float, default=0.3175)
    p.add_argument("--vel", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--input", type=str, default=None,
                   help=".npy 1LPT displacement (3, N, N, N), memory-mapped; each shard "
                        "reads its own block. Default: a per-shard Gaussian field "
                        "(benchmark mode)")
    p.add_argument("--ic-seed", type=int, default=None,
                   help="make physical ICs on the mesh instead of reading --input: EH98 "
                        "linear P(k) -> sharded GRF -> Zel'dovich 1LPT")
    p.add_argument("--boxsize", type=float, default=1000.0,
                   help="box side [Mpc/h] for --ic-seed / --validate")
    p.add_argument("--validate", action="store_true",
                   help="deposit the emulated displacement to a density on the mesh and "
                        "print its P(k) (pencil-FFT estimator)")
    p.add_argument("--margin", type=int, default=32,
                   help="--validate deposit's halo-reduce margin [cells]")
    p.add_argument("--params", type=str, default=None)
    p.add_argument("--mesh", type=int, nargs=3, default=None,
                   help="3D mesh shape (default: all devices, factored)")
    p.add_argument("--tiles", type=int, nargs=3, default=None,
                   help="tiles per shard (default: tile extents near 128)")
    p.add_argument("--halo", type=int, default=48)
    p.add_argument("--coordinator", type=str, default=None,
                   help="host:port of a multi-process run (process 0 serves it)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--out-dir", type=str, default=None,
                   help="write the per-shard outputs here (one file per shard)")
    p.add_argument("--mid-chan", type=int, default=64)
    add_device_args(p, devices=True)
    return p.parse_args(argv)


def _params(args):
    """The premodulated tree at (z, Om): ``--params`` (a style tree is folded,
    a reference-layout one converted first), else a seeded style tree folded."""
    from ..emulator import (
        ensure_native_layout,
        modulate_emulator_parameters,
        modulate_emulator_parameters_vel,
    )
    from ..models.unet import init_unet
    from ..utils.params import load_params_npz

    fold = modulate_emulator_parameters_vel if args.vel else modulate_emulator_parameters
    if args.params:
        params = ensure_native_layout(load_params_npz(args.params))
        has_style = any("style_weight" in layer for block in params["params"].values()
                        for layer in block.values())
        return fold(params, z=args.z, Om=args.Om) if has_style else params
    return fold(init_unet(0, style=True, mid_chan=args.mid_chan), z=args.z, Om=args.Om)


def _sync(fields):
    for f in fields:
        for p in f.local_parts:
            if p.device.type == "cuda":
                torch.cuda.synchronize(p.device)


def main(argv: list[str] | None = None) -> dict:
    """Run the sharded box; returns its seconds, the validation P(k) and the files."""
    args = parse_args(argv)
    device = device_of(args)

    from ..models.cores import NBodyEmulatorCore, NBodyEmulatorVelCore
    from ..parallel import (
        ShardedBoxConfig,
        ShardedBoxProcessor,
        initialize,
        make_mesh,
        make_sharded_box,
        process_count,
        process_index,
    )
    from ..parallel.collectives import each
    from ..parallel.mesh import _factor3

    initialize(args.coordinator, args.num_processes, args.process_id)
    world, rank = process_count(), process_index()
    if args.mesh:
        mesh_shape = tuple(args.mesh)
        devices = mesh_devices(args.devices, device, int(np.prod(mesh_shape)) // world)
    else:
        devices = mesh_devices(args.devices, device, 1)
        if devices is None:  # the visible cards
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        mesh_shape = _factor3(len(devices) * world)
    mesh = make_mesh(mesh_shape, devices=devices)
    n_dev = len(mesh.distinct_devices())
    if rank == 0:
        print(f"pod: {world} process{'es' if world > 1 else ''}, {mesh.size} shards on "
              f"{n_dev} device(s){' a process' if world > 1 else ''}, mesh {mesh_shape}",
              flush=True)

    size = (args.size,) * 3
    shard = tuple(s // m for s, m in zip(size, mesh_shape))
    tiles = tuple(args.tiles) if args.tiles else tuple(max(1, s // 128) for s in shard)
    model = (NBodyEmulatorVelCore if args.vel else NBodyEmulatorCore)(mid_chan=args.mid_chan)
    cfg = ShardedBoxConfig(size=size, tiles_per_shard=tiles, halo=args.halo,
                           dtype=torch.bfloat16, output_dtype=torch.float16)
    proc = ShardedBoxProcessor(model, _params(args), mesh, cfg)

    if args.ic_seed is not None:
        from ..science import (
            eisenstein_hu_pk,
            gaussian_random_field_sharded,
            zeldovich_displacement_sharded,
        )

        k_t = np.logspace(-4, 2, 512)
        p_t = eisenstein_hu_pk(k_t, Om=args.Om, Ob=0.049, h=0.6711, ns=0.9624, sigma8=0.834)
        gen = torch.Generator(device=mesh.distinct_devices()[0]).manual_seed(args.ic_seed)
        delta = gaussian_random_field_sharded(gen, args.size, mesh, args.boxsize, k_t, p_t)
        psi = zeldovich_displacement_sharded(delta, mesh, args.boxsize)
        box = psi.like(each(lambda p: p.to(cfg.dtype), psi.parts))
        del delta, psi
    elif args.input:
        psi = np.lib.format.open_memmap(args.input, mode="r")
        box = make_sharded_box(mesh, size, lambda idx: np.ascontiguousarray(psi[idx]),
                               dtype=np.float16)
    else:
        def synth(idx):  # a deterministic Gaussian block per shard
            key = tuple((s.start or 0) for s in idx)
            rng = np.random.default_rng(hash(key) % 2**32)
            shape = tuple(len(range(*s.indices(dim))) for s, dim in zip(idx, (3,) + size))
            return rng.normal(size=shape).astype(np.float16)

        box = make_sharded_box(mesh, size, synth, dtype=np.float16)

    out = proc.process_box(box, z=args.z, Om=args.Om)  # warm-up
    outs = out if args.vel else (out,)
    _sync(outs)
    t0 = time.perf_counter()
    out = proc.process_box(box, z=args.z, Om=args.Om)
    outs = out if args.vel else (out,)
    _sync(outs)
    dt = time.perf_counter() - t0
    vps = float(np.prod(size)) / dt
    if rank == 0:
        print(f"{args.size}^3 {'disp+vel' if args.vel else 'disp'}: {dt:.2f} s  "
              f"({vps / 1e6:.1f} M voxel/s, {vps / 1e6 / n_dev / world:.1f} M voxel/s/device)",
              flush=True)
    result = {"seconds": dt, "mesh": mesh_shape, "shards": mesh.size, "devices": n_dev,
              "process_index": rank, "process_count": world, "outputs": outs}

    if args.validate:
        from ..science import displacement_to_density_sharded, power_spectrum_sharded
        from ..science._common import to_numpy

        delta_emu = displacement_to_density_sharded(outs[0], mesh, args.boxsize,
                                                    margin=args.margin)
        k, pk, nm = (to_numpy(t) for t in power_spectrum_sharded(delta_emu, mesh, args.boxsize))
        sel = nm > 0
        rows = np.linspace(0, sel.sum() - 1, 8).astype(int)
        if rank == 0:
            print("emulated-density P(k):", flush=True)
            for i in np.flatnonzero(sel)[rows]:
                print(f"  k={k[i]:.4f} h/Mpc  P={pk[i]:.4e}  ({int(nm[i])} modes)", flush=True)
        result["pk"] = {"k": k, "pk": pk, "modes": nm}

    if args.out_dir:
        outdir = Path(args.out_dir)
        outdir.mkdir(parents=True, exist_ok=True)
        files = []
        for name, field in zip(("dis", "vel"), outs):
            for i in field.local_indices():
                tag = "_".join(str(o) for o in field.origin(i))
                np.save(outdir / f"{name}_{tag}.npy", field.parts[i].cpu().numpy())
                files.append(f"{name}_{tag}.npy")
        if rank == 0:
            print(f"per-shard outputs in {outdir}", flush=True)
        result["files"] = files
    return result


if __name__ == "__main__":
    main()
