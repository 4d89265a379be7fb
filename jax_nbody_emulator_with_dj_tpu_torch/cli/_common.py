"""What the port's command-line drivers share.

The argument surface they have in common (``--device``, ``--devices``,
``--params`` / ``--random-params``), the precision names, the card line each
record carries, the meshes of the sharded paths, JSON output and the lazy
matplotlib import.
"""

from __future__ import annotations

import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..hierarchical import resolve_device
from ..parallel.mesh import make_mesh, process_count

PRECISION = {"bf16": torch.bfloat16, "f16": torch.float16, "f32": torch.float32}
OUTPUT_DTYPE = {"f16": torch.float16, "f32": torch.float32}
# The JAX planner's default budget: what a CPU run plans for (a run on the
# card reads the card's own memory).
CPU_PLAN_BYTES = 16 << 30


def add_device_args(p, devices: bool = False) -> None:
    """``--device`` (and, for the sharded paths, ``--devices``)."""
    p.add_argument("--device", type=str, default=None,
                   help="torch device the run uses (default: the CUDA card; raises without "
                        "one; 'cpu' runs on the CPU)")
    if devices:
        p.add_argument("--devices", type=str, nargs="+", default=None,
                       help="this process's devices for its shards of the mesh: one name is "
                            "repeated over every shard (virtual shards, e.g. 'cuda'), several "
                            "fill the shards in order and must be at least as many (default: "
                            "the visible CUDA cards; with --device cpu, the CPU)")


def add_params_args(p) -> None:
    p.add_argument("--params", type=str, default=None,
                   help="weights .npz (this package's or the JAX package's "
                        "save_params_npz format; else the packaged default)")
    p.add_argument("--random-params", action="store_true",
                   help="seeded random weights (models/unet.py::init_unet(0)): a pipeline "
                        "smoke test, no physics fidelity")


def device_of(args) -> torch.device:
    """The run's device: ``--device``, else the CUDA card (raises without one)."""
    return resolve_device(args.device)


def resolve_params(args):
    """``(params, load_params)`` for ``create_emulator`` / the pipeline.

    ``--random-params`` draws a seeded style tree at ``--mid-chan``: the
    JAX scripts draw theirs from a JAX key, which a torch run cannot
    reproduce, so the two agree only through a shared ``--params`` file.
    """
    from ..models.unet import init_unet
    from ..utils.params import load_params_npz

    if args.params:
        return load_params_npz(args.params), False
    if args.random_params:
        return init_unet(0, style=True, vel=True, mid_chan=args.mid_chan), False
    return None, True


def card_line(device: torch.device) -> str | None:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (None off the card or without nvidia-smi)."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    index = device.index if device.index is not None else torch.cuda.current_device()
    return lines[index] if index < len(lines) else None


def device_record(device: torch.device) -> dict:
    """``device`` and ``card`` keys for a run's metadata."""
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    return {"device": name, "card": card_line(device)}


def plan_config(n: int, device: torch.device, **kw):
    """``auto_hierarchical_config`` for an n^3 box on ``device`` (a CPU run plans
    for the JAX planner's 16 GB)."""
    from ..geometry import auto_hierarchical_config

    hbm = CPU_PLAN_BYTES if device.type == "cpu" else None
    return auto_hierarchical_config((n,) * 3, hbm_bytes=hbm, device=device, **kw)


def mesh_devices(names, device: torch.device, n_shards: int):
    """The device list of this process's ``n_shards`` shards of a mesh:
    ``names`` (one name repeated over every shard), else the visible CUDA
    cards (None), or on the CPU the CPU repeated."""
    if names is None:
        return None if device.type == "cuda" else [device] * n_shards
    devs = [torch.device(d) for d in names]
    return devs * n_shards if len(devs) == 1 else devs


def cli_mesh(shape, names, device: torch.device):
    """A spatial mesh of ``shape`` over ``mesh_devices`` for this process's
    shards; raises when it has more shards than devices were given."""
    shape = tuple(int(s) for s in shape)
    per = int(np.prod(shape)) // process_count()
    return make_mesh(shape, devices=mesh_devices(names, device, per))


def to_jsonable(x):
    """Numbers, arrays and tensors as JSON values (lists for arrays)."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [to_jsonable(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def write_json(path: Path, obj) -> Path:
    with open(path, "w") as f:
        json.dump(to_jsonable(obj), f, indent=2, default=str)
    return path


def pyplot():
    """matplotlib's pyplot on the Agg backend, imported on demand (``--plots``)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("--plots needs matplotlib, which is not installed; every figure's "
                          "data is written without it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt
