"""Worked examples of the port's API, with seeded random weights.

Counterpart of the JAX package's ``examples/basic_usage.py``: (1) the style
emulator's ``process_box`` (the cosmology per call), (2) a premodulated
(fixed-cosmology) emulator reused over boxes, (3) the model applied directly,
with the padding arithmetic (input = output + 2 x margin), (4) the cosmology
utilities, (5) the sharded runtime on a one-shard mesh, and (6) the
planner's geometry for a 512^3 velocity box.

Differences from the JAX example: the box side is ``--size`` (default 128,
as there; a multiple of 8), the width ``--mid-chan`` (default 8, as there:
a demo; the full-width runs are ``run_emulator`` and ``run_batch``), the
U-Net's depth ``--levels`` (default 3, the published model; fewer levels
shrink the margin, 48 voxels a side at 3, so a small box runs quickly), and
``--device`` (default the CUDA card; raises without one; ``--device cpu``
runs on the CPU).  Random inputs come from numpy and torch generators.

    python -m jax_nbody_emulator_with_dj_tpu_torch.cli.basic_usage
    python -m jax_nbody_emulator_with_dj_tpu_torch.cli.basic_usage --size 16 --levels 1 \\
        --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ._common import add_device_args, device_of, plan_config

MID = 8  # small width keeps the demo fast; production uses 64


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--size", type=int, default=128, help="box side of the examples")
    p.add_argument("--mid-chan", type=int, default=MID)
    p.add_argument("--levels", type=int, default=3, help="U-Net levels (3: the published model)")
    add_device_args(p)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    """Run the six examples; returns what each printed."""
    args = parse_args(argv)
    device = device_of(args)

    from .. import (
        ChunkedHierarchicalConfig,
        StyleNBodyEmulatorVelCore,
        SubboxConfig,
        create_emulator,
        growth_factor,
        vel_norm,
    )
    from ..models import min_input_size, output_size, valid_input_size
    from ..parallel import ShardedBoxConfig, ShardedBoxProcessor, make_mesh
    from ..utils.params import tree_to

    n, mid, levels = args.size, args.mid_chan, args.levels
    model = StyleNBodyEmulatorVelCore(mid_chan=mid, levels=levels)
    pad = ((model.margin,) * 2,) * 3
    out = {}
    params = model.init(0)
    box = np.random.default_rng(0).standard_normal((3, n, n, n)).astype(np.float32)

    # 1. style emulator (runtime cosmology) on a full box
    config = SubboxConfig(size=(n,) * 3, ndiv=(1, 1, 1), padding=pad)
    emulator = create_emulator(premodulate=False, compute_vel=True, params=params,
                               processor_config=config, mid_chan=mid, levels=levels,
                               device=device)
    disp, vel = emulator.process_box(box, z=0.5, Om=0.3)
    print(f"[1] style process_box: in {box.shape} -> disp {disp.shape}, vel {vel.shape}")
    out["style"] = {"disp": disp, "vel": vel}

    # 2. premodulated (fixed cosmology): the fold once, then any number of boxes
    emulator_premod = create_emulator(premodulate=True, compute_vel=True, params=params,
                                      processor_config=config, premodulate_z=0.5,
                                      premodulate_Om=0.3, mid_chan=mid, levels=levels,
                                      device=device)
    out["premodulated_range"] = []
    for i in range(2):
        d, _ = emulator_premod.process_box(box, z=0.5, Om=0.3)
        print(f"[2] box {i + 1}: displacement range [{d.min():.3f}, {d.max():.3f}]")
        out["premodulated_range"].append((float(d.min()), float(d.max())))

    # 3. direct model access: the input carries the margin on every side
    n_in = n + 2 * model.margin
    if not valid_input_size(n_in, levels) or output_size(n_in, levels) != n:
        raise ValueError(f"--size {n}: a {n_in}^3 input is not valid for the model")
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((1, 3, n_in, n_in, n_in), generator=gen, device=device)
    z, om = 0.5, 0.3
    dz, vn = growth_factor(np.array([z]), np.array([om])), vel_norm(np.array([z]), np.array([om]))
    with torch.no_grad():
        d, v = model.apply(tree_to(params, device), x, [om], dz, vn)
    print(f"[3] direct apply: {tuple(x.shape)} -> {tuple(d.shape)} (margin {model.margin}/side, "
          f"smallest valid input {min_input_size(levels)})")
    out["direct"] = {"in": tuple(x.shape), "out": tuple(d.shape), "margin": model.margin}

    # 4. cosmology utilities (vectorised over z)
    zs = np.linspace(0, 2, 5)
    out["growth"] = np.asarray(growth_factor(zs, 0.3175))
    print("[4] D(z) =", np.round(out["growth"], 4))

    # 5. sharded runtime (a (1, 1, 1) mesh here; e.g. (2, 2, 2) over eight shards)
    mesh = make_mesh((1, 1, 1), devices=[device])
    cfg = ShardedBoxConfig(size=(n,) * 3, dtype=torch.float32, halo=model.margin)
    proc = ShardedBoxProcessor(model, params, mesh, cfg)
    d, _ = proc.process_box(box, z=0.5, Om=0.3, as_numpy=True)
    print(f"[5] sharded process_box on mesh {mesh.shape}: disp {d.shape}")
    out["sharded"] = {"mesh": mesh.shape, "disp": d}

    # 6. planner-chosen geometry: the production single-card path
    acfg = plan_config(512, device, compute_vel=True)
    geom = acfg.inner_config() if isinstance(acfg, ChunkedHierarchicalConfig) else acfg
    print(f"[6] auto geometry for 512^3 vel: {type(acfg).__name__}, slab {geom.slab}, tile "
          f"{geom.tile}, tile1 {geom.tile1} (pass as processor_config= to create_emulator)")
    out["plan"] = {"type": type(acfg).__name__, "slab": geom.slab, "tile": tuple(geom.tile),
                   "tile1": geom.tile1}
    return out


if __name__ == "__main__":
    main()
