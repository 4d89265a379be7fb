"""One process of a multi-process sharded box: ``ShardedHierarchicalProcessor.process_box``
on this process's shards, the margins that cross processes over the gloo group.

    python3 -m jax_nbody_emulator_with_dj_tpu_torch.experiments.mp_box \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0 \\
        [--size 512 | --size D H W] [--mesh 2 2 2] [--kind vel] [--mid-chan 64]
        [--dtype bf16] [--warmups 1] [--out-dir DIR] [--device cpu]

Start it once per process (``launch`` does so on one host).  Each process
joins the group (``parallel.initialize``, its default timeout), builds the
seeded model as ``chip_smoke.py`` does (``init_unet(SEED, style=True)`` at
``--mid-chan``, premodulated at (z, Om) = (0.5, 0.3) unless ``--kind`` names a
style model), makes its shards of the input box with numpy (:func:`box_block`:
each block from ``SEED`` and its origin, so the box does not depend on how
many processes share the mesh) and runs the box ``--warmups`` times, then once
more with the kernels' launch counts set to 0 and ``profile=True``.  Its
shards lie on ``--device`` (default the CUDA card; raises without one), as
virtual shards of that one device.  On the card the interior convs run
kernels B1 (disp) and B2 (vel); on the CPU their plain versions run.

With ``--out-dir`` it writes this process's shards of each output as
``dis_<x0>_<y0>_<z0>.npy`` / ``vel_...`` (float32, the files ``run_pod`` and
``science.halos.friends_of_friends_sharded`` use) and ``mp_box_<rank>.json``:
the timed call's wall seconds, this process's peak device memory, the B1/B2
launches, the bytes written into this process's margins at each phase
boundary (``halo_bytes``), the bytes it sent to and received from other
processes, the exchanges' ms (``phase_ms``; ``exchange_cross`` is the
cross-process messages', staging included), and the card.  The record is
also printed as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

KINDS = ("disp", "vel", "style_disp", "style_vel")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
Z, OM = 0.5, 0.3
SEED = 0  # the weights and the input box


def box_block(seed: int, size, index) -> np.ndarray:
    """The block ``index`` (slices of the (3,) + size box) of the seeded input
    box: float32 standard normals from ``SeedSequence([seed, *origin])``."""
    shape = tuple(len(range(*s.indices(n))) for s, n in zip(index, (3,) + tuple(size)))
    origin = [s.indices(n)[0] for s, n in zip(index, (3,) + tuple(size))]
    rng = np.random.default_rng(np.random.SeedSequence([seed, *origin]))
    return rng.standard_normal(shape, dtype=np.float32)


def build_model(kind: str, seed: int, mid_chan: int, device):
    """The seeded model of ``kind`` and its parameters, as ``chip_smoke.py``'s
    ``_emulator`` builds them."""
    from .. import create_emulator
    from ..models.unet import init_unet

    style = kind.startswith("style")
    emu = create_emulator(premodulate=not style, compute_vel=kind.endswith("vel"),
                          params=init_unet(seed, style=True, mid_chan=mid_chan),
                          premodulate_z=Z, premodulate_Om=OM, device=device, mid_chan=mid_chan)
    return emu.model, emu.params


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--coordinator", type=str, default=None, help="host:port of process 0")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--size", type=int, nargs="+", default=[512],
                   help="the box's extent, one for a cube or three (D H W)")
    p.add_argument("--mesh", type=int, nargs=3, default=(2, 2, 2))
    p.add_argument("--device", type=str, default=None,
                   help="this process's shards' device (default: the CUDA card, raises "
                        "without one; 'cpu' on the CPU)")
    p.add_argument("--kind", choices=KINDS, default="vel")
    p.add_argument("--mid-chan", type=int, default=64)
    p.add_argument("--dtype", choices=tuple(DTYPES), default="bf16")
    p.add_argument("--slab", type=int, default=32)
    p.add_argument("--tile", type=int, nargs=3, default=(128, 128, 128))
    p.add_argument("--warmups", type=int, default=1)
    p.add_argument("--out-dir", type=str, default=None)
    return p.parse_args(argv)


def run(args) -> dict:
    """This process's part of the box (the group joined already or here)."""
    from .. import HierarchicalConfig
    from ..cli._common import card_line, device_of
    from ..ops import winograd_cuda as wc
    from ..parallel import (
        ShardedHierarchicalProcessor,
        collectives,
        initialize,
        make_mesh,
        make_sharded_box,
        process_count,
        process_index,
    )

    initialize(args.coordinator, args.num_processes, args.process_id)
    device = device_of(args)
    if device.type == "cuda":  # as chip_smoke.py measures: no TF32 in float32 convs, matmuls
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    rank, world = process_index(), process_count()
    mesh_shape = tuple(args.mesh)
    per = int(np.prod(mesh_shape)) // world
    mesh = make_mesh(mesh_shape, devices=[device] * per)
    size = tuple(args.size) * 3 if len(args.size) == 1 else tuple(args.size)
    model, params = build_model(args.kind, SEED, args.mid_chan, device)
    cfg = HierarchicalConfig(size=size, slab=args.slab, tile=tuple(args.tile),
                             dtype=DTYPES[args.dtype], output_dtype=torch.float32)
    proc = ShardedHierarchicalProcessor(model, params, mesh, cfg)
    box = make_sharded_box(mesh, size, lambda idx: box_block(SEED, size, idx),
                           dtype=cfg.dtype)
    cuda = [d for d in mesh.distinct_devices() if d.type == "cuda"]

    def sync():
        for d in cuda:
            torch.cuda.synchronize(d)

    for _ in range(args.warmups):
        proc.process_box(box, Z, OM)
    sync()
    for d in cuda:
        torch.cuda.reset_peak_memory_stats(d)
    wc.conv3d_wino_packed.launches = wc.conv3d_wino_pair_packed.launches = 0
    t = collectives.traffic
    sent, received = t.bytes_sent, t.bytes_received
    t0 = time.perf_counter()
    out = proc.process_box(box, Z, OM, profile=True)
    sync()
    seconds = time.perf_counter() - t0
    outs = out if isinstance(out, tuple) else (out,)
    halo = dict(proc.last_halo_bytes)
    margins = sum(v for k, v in halo.items() if not k.startswith("sent_"))
    record = {
        "process_index": rank, "process_count": world, "mesh": list(mesh_shape),
        "shards": mesh.local_indices(), "devices": [str(d) for d in mesh.distinct_devices()],
        "kind": args.kind, "size": list(size), "mid_chan": args.mid_chan, "dtype": args.dtype,
        "wino": proc.local.wino, "seconds": seconds,
        "peak_bytes": max((torch.cuda.max_memory_allocated(d) for d in cuda), default=None),
        "launches": {"B1": wc.conv3d_wino_packed.launches,
                     "B2": wc.conv3d_wino_pair_packed.launches},
        "halo_bytes": halo, "margin_bytes": margins,
        "cross_bytes_sent": t.bytes_sent - sent,
        "cross_bytes_received": t.bytes_received - received,
        "inside_bytes": margins - (t.bytes_received - received),
        "phase_ms": {k: v * 1e3 for k, v in proc.last_timings.items()},
        "device": torch.cuda.get_device_name(cuda[0]) if cuda else str(device),
        "card": card_line(cuda[0]) if cuda else None,
    }
    if args.out_dir:
        outdir = Path(args.out_dir)
        outdir.mkdir(parents=True, exist_ok=True)
        for name, field in zip(("dis", "vel"), outs):
            for i in field.local_indices():
                tag = "_".join(str(o) for o in field.origin(i))
                np.save(outdir / f"{name}_{tag}.npy", field.parts[i].float().cpu().numpy())
        (outdir / f"mp_box_{rank}.json").write_text(json.dumps(record, indent=1))
    return record


def free_port() -> int:
    """A TCP port on 127.0.0.1 that no socket holds now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(command, world: int, timeout: float, cwd=None, env=None) -> list:
    """Start ``world`` processes of one run on this host and wait for them.

    ``command(rank, coordinator)`` gives each process's argv (``coordinator``
    is ``127.0.0.1:<free port>``); ``env`` (default: this process's) gets
    ``GLOO_SOCKET_IFNAME=lo`` unless it names an interface, as the processes
    meet on the loopback.  Returns each process's ``(stdout, stderr)``.  When
    a process exits non-zero or ``timeout`` seconds pass, every process still
    running is killed and ``RuntimeError`` carries every process's exit code
    and the end of its stderr.  The port is free when it is chosen, but
    another program may bind it before process 0 does: a run whose
    coordinator found its port taken is started once more on a new port.
    """
    env = dict(os.environ if env is None else env)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    for attempt in range(2):
        codes, texts, timed_out = _run(command, world, f"127.0.0.1:{free_port()}", timeout,
                                       cwd, env)
        if not any(codes):
            return texts
        taken = any("EADDRINUSE" in err or "address already in use" in err.lower()
                    for _, err in texts)
        if attempt or not taken:
            break
    why = f"timed out after {timeout:.0f} s" if timed_out else "a process failed"
    detail = "\n".join(f"--- process {r}: exit {c}\n{e[-4000:]}"
                       for r, (c, (_, e)) in enumerate(zip(codes, texts)))
    raise RuntimeError(f"multi-process run: {why}; exit codes {codes}\n{detail}")


def _run(command, world, coordinator, timeout, cwd, env):
    """One start of ``launch``'s processes: their exit codes, their ``(stdout,
    stderr)`` and whether the time ran out."""
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")) for _ in range(world)]
    procs = [subprocess.Popen(command(r, coordinator), stdout=out, stderr=err, cwd=cwd, env=env)
             for r, (out, err) in enumerate(logs)]
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                timed_out = True
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = []
    for out, err in logs:
        out.seek(0), err.seek(0)
        texts.append((out.read(), err.read()))
        out.close(), err.close()
    return [p.returncode for p in procs], texts, timed_out


def main(argv=None) -> dict:
    from ..parallel import shutdown

    args = parse_args(argv)
    try:
        record = run(args)
    except Exception:  # the process must exit non-zero whatever the group's state
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
    shutdown()
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
