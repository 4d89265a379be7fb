"""Multi-process runs of the port: gloo groups of CPU processes on one host,
held bit for bit against the one-process mesh, and against JAX.

Two runs start from a module fixture, side by side: 4 processes on a
(2, 2, 2) mesh of ``[cpu] * 2`` each (the z rings stay inside a process, the
x and y rings cross processes) and 2 processes on (4, 1, 1), each at
``tcp://127.0.0.1:<free port>``, one torch thread, a 60 s group timeout and a
180 s limit on the run (``experiments/mp_box.py::launch``: a process that
fails kills the others).  Every process runs this file as a script
(:func:`_worker`), which imports no JAX, and saves what its shards produced:
the collectives (bfloat16, complex64 and int64 included), the halo exchange
and the margin fill with multi-hop widths, ``experiments/mp_box.py`` (the
sharded hierarchical runtime) for all four cores, ``ShardedBoxProcessor`` for
all four cores, the sharded science (GRF -> 1LPT -> deposit -> P(k), the
spectra and moments, Minkowski, the bispectrum, resizing, a Zel'dovich field
for FoF) and, on two processes, ``cli/run_pod``.  Meanwhile the test process
runs the same cases on the one-process mesh.  Each value must equal the
one-process value bit for bit, and every shard must be covered by exactly
one process; a psum-like value must be the same in every process.  The
multi-process premodulated box is held against JAX's
``ShardedHierarchicalProcessor`` at ``test_sharded_hierarchical_matches_jax``'s
gates (rtol 2e-4 / atol 2e-5).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":  # a process of a run: the port from this checkout
    sys.path.insert(0, str(ROOT))

from jax_nbody_emulator_with_dj_tpu_torch import science as sci  # noqa: E402
from jax_nbody_emulator_with_dj_tpu_torch.cli import run_pod  # noqa: E402
from jax_nbody_emulator_with_dj_tpu_torch.emulator import create_emulator  # noqa: E402
from jax_nbody_emulator_with_dj_tpu_torch.experiments import mp_box  # noqa: E402
from jax_nbody_emulator_with_dj_tpu_torch.models.unet import init_unet  # noqa: E402
from jax_nbody_emulator_with_dj_tpu_torch.parallel import (  # noqa: E402
    ShardedBoxConfig,
    ShardedBoxProcessor,
    ShardedField,
    halo_exchange,
    initialize,
    make_mesh,
    make_sharded_box,
    process_count,
    process_index,
    shutdown,
)
from jax_nbody_emulator_with_dj_tpu_torch.parallel import collectives  # noqa: E402
from jax_nbody_emulator_with_dj_tpu_torch.science.halos import (  # noqa: E402
    friends_of_friends_sharded,
)
from jax_nbody_emulator_with_dj_tpu_torch.parallel import sharded_hierarchical as tsh  # noqa: E402
from jax_nbody_emulator_with_dj_tpu_torch.parallel.collectives import (  # noqa: E402
    block_index,
    each,
)
from jax_nbody_emulator_with_dj_tpu_torch.parallel.mesh import REMOTE  # noqa: E402

CPU = torch.device("cpu")
RUNS = {"4x222": (4, (2, 2, 2)), "2x411": (2, (4, 1, 1))}
GROUP_TIMEOUT = 60.0  # seconds a process waits in a join or a collective
RUN_TIMEOUT = 180.0  # seconds a run may take before its processes are killed
KINDS = mp_box.KINDS
Z, OM = mp_box.Z, mp_box.OM
BOX_N, BOX_L = 32, 1000.0  # the science chain (P(k), deposit, Minkowski, ...)
FOF_N, FOF_L = 24, 60.0  # a clumpy Zel'dovich field for FoF
POD = ["--size", "64", "--mesh", "2", "2", "2", "--devices", "cpu", "--device", "cpu",
       "--ic-seed", "5", "--validate", "--mid-chan", "4", "--no-vel", "--boxsize", "200"]


# ---------------------------------------------------------------------------
# the cases: run by every process of a run, and by the test on one process
# ---------------------------------------------------------------------------


class Results(dict):
    """``case|name|shard`` -> this process's value of that shard (``case|name``
    for a value every process holds)."""

    def shards(self, case, name, field_or_parts):
        parts = getattr(field_or_parts, "parts", field_or_parts)
        for i, p in enumerate(parts):
            if p is not None:
                self[f"{case}|{name}|{i}"] = _host(p)

    def value(self, case, name, v):
        self[f"{case}|{name}"] = _host(v)


def _host(x):
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def _pk_table():
    k = np.logspace(-3, 1.5, 64)
    return k, sci.eisenstein_hu_pk(k, Om=0.3175, Ob=0.049, h=0.6711, ns=0.9624, sigma8=0.834)


def case_collectives(mesh, res):
    ms = mesh.spatial_shape()
    vol = np.random.default_rng(3).normal(size=(16, 16, 16)).astype(np.float32)
    parts = ShardedField.shard(vol, mesh, (0, 1, 2)).parts
    for axis in range(3):
        for shift in (1, -1, 2, 3):
            res.shards("collectives", f"ppermute_{axis}_{shift}",
                       collectives.ppermute_shift(parts, ms, axis, shift))
    for axis, split, concat in ((0, 1, 0), (1, 0, 1), (2, 0, 2), (2, 2, 0)):
        res.shards("collectives", f"all_to_all_{axis}_{split}_{concat}",
                   collectives.all_to_all_tiled(parts, ms, axis, split, concat))
    for dtype in (torch.bfloat16, torch.float16, torch.complex64, torch.int64):
        typed = each(lambda p: (p * 100).to(dtype), parts)
        res.shards("collectives", f"ppermute_{dtype}", collectives.ppermute_shift(typed, ms, 0, 1))
    res.value("collectives", "psum_f64", collectives.psum(each(lambda p: p.double().sum(), parts)))
    res.value("collectives", "psum_vec", collectives.psum(each(lambda p: p.sum(0), parts)))
    res.value("collectives", "psum_i64", collectives.psum(each(lambda p: (p > 0).sum(), parts)))
    res.value("collectives", "pmax", collectives.pmax(each(lambda p: p.abs().amax(1), parts)))


def case_halo(mesh, res):
    ms = mesh.spatial_shape()
    vol = np.random.default_rng(9).normal(size=(3, 16, 16, 16)).astype(np.float32)
    parts = ShardedField.shard(vol, mesh, (1, 2, 3)).parts
    for halo in (4, 11):  # 11 spans two neighbours on a local extent of 8 (three of 4)
        res.shards("halo", f"halo_{halo}", halo_exchange(parts, ms, halo))


def case_fill_margins(mesh, res):
    ms = mesh.spatial_shape()
    for local, margins in (((8, 8, 4), (2, 2, 1)), ((4, 4, 2), (10, 9, 5))):  # wider than the box
        shape = (1,) + tuple(n + 2 * m for n, m in zip(local, margins)) + (3,)
        rng = np.random.default_rng(11)
        blocks = [rng.normal(size=shape).astype(np.float32) for _ in range(mesh.size)]
        bufs = [None if d == REMOTE else torch.from_numpy(b)
                for b, d in zip(blocks, mesh.devices.flat)]
        moved = tsh.fill_margins_exchange(mesh, bufs, margins)
        res.shards("fill_margins", f"{local}_{margins}", bufs)
        # every shard's margins are as large: this process's bytes per shard
        res.value("fill_margins", f"moved_{margins}", moved // len(mesh.local_indices()))


def case_hierarchical(mesh, res, out: Path, kind: str):
    """``experiments/mp_box.py``, float32, ``mid_chan=4`` (its files): 32^3 on
    (2, 2, 2), (64, 32, 32) on (4, 1, 1) (a local extent of 16: packed)."""
    ms = mesh.spatial_shape()
    kdir = out / f"hier_{kind}"
    size = [str(16 * m) if m > 2 else "32" for m in ms]
    mp_box.run(mp_box.parse_args([
        "--size", *size, "--mesh", *map(str, ms), "--device", "cpu", "--kind", kind,
        "--mid-chan", "4", "--dtype", "f32", "--slab", "8", "--tile", "16", "16", "16",
        "--warmups", "0", "--out-dir", str(kdir)]))
    _files(res, f"hier_{kind}", kdir)


def _files(res, case, directory: Path):
    """The per-shard ``<name>_<x0>_<y0>_<z0>.npy`` files a process wrote."""
    for f in sorted(directory.glob("*.npy")):
        name, origin = f.stem.split("_", 1)
        res[f"{case}|{name}|{origin}"] = np.load(f)


def case_sharded_box(mesh, res, kind: str):
    """The subbox scheme over the mesh, ``levels=1``, ``mid_chan=4``, float32."""
    style = kind.startswith("style")
    emu = create_emulator(premodulate=not style, compute_vel=kind.endswith("vel"),
                          params=init_unet(2, levels=1, style=True, mid_chan=4),
                          premodulate_z=Z, premodulate_Om=OM, device="cpu", levels=1,
                          mid_chan=4)
    size = (64, 32, 32)
    box = np.random.default_rng(7).normal(size=(3,) + size).astype(np.float32)
    proc = ShardedBoxProcessor(emu.model, emu.params, mesh, ShardedBoxConfig(
        size=size, dtype=torch.float32, halo=emu.model.margin))
    out = proc.process_box(box, Z, OM)
    for name, field in zip(("dis", "vel"), out if isinstance(out, tuple) else (out,)):
        res.shards(f"box_{kind}", name, field)


def case_science(mesh, res, out: Path):
    k_t, p_t = _pk_table()
    n, box = BOX_N, BOX_L
    delta = sci.gaussian_random_field_sharded(torch.Generator().manual_seed(3), n, mesh, box,
                                              k_t, p_t)
    psi = sci.zeldovich_displacement_sharded(delta, mesh, box)
    rho = sci.deposit_displacement_sharded(psi, mesh, box, worder=2, margin=4)
    dens = sci.displacement_to_density_sharded(psi, mesh, box, margin=4)
    for name, f in (("delta", delta), ("psi", psi), ("rho", rho), ("density", dens)):
        res.shards("science", name, f)
    for name, v in zip(("k", "pk", "modes"), sci.power_spectrum_sharded(dens, mesh, box)):
        res.value("science", name, v)
    for name, v in zip(("t", "c"), sci.transfer_and_correlation_sharded(dens, delta, mesh,
                                                                         box)[1:]):
        res.value("science", name, v)
    summary = sci.summary_metrics_sharded(dens, delta, mesh, box)
    res.value("science", "summary", [summary[k] for k in sorted(summary)])

    res.value("minkowski", "v", sci.minkowski_functionals_sharded(delta, [-0.3, 0.0, 0.3], mesh))
    bis = sci.reduced_bispectrum_sharded(delta, mesh, box, 0.03, 0.05, [0.5, 1.5, 2.5])
    for name in ("B", "Q", "P1", "P2", "P3"):
        res.value("bispectrum", name, bis[name])

    coarse = np.random.default_rng(5).normal(size=(16,) * 3).astype(np.float32)
    res.shards("resize", "modes", sci.upsample_modes_sharded(
        coarse, n, mesh, box, k_t, p_t, generator=torch.Generator().manual_seed(4)))
    res.shards("resize", "fourier", sci.upsample_fourier_sharded(coarse, n, mesh))
    res.shards("resize", "down", sci.downsample_average_sharded(delta, 16, mesh))
    res.shards("resize", "smooth", sci.gaussian_smooth_sharded(delta, mesh, box, 40.0))

    fof = sci.zeldovich_displacement_sharded(sci.gaussian_random_field_sharded(
        torch.Generator().manual_seed(11), FOF_N, mesh, FOF_L, k_t, p_t), mesh, FOF_L)
    res.shards("science", "fof_psi", fof)
    (out / "fof").mkdir(parents=True, exist_ok=True)
    for i in fof.local_indices():
        np.save(out / "fof" / ("psi_" + "_".join(map(str, fof.origin(i))) + ".npy"),
                fof.parts[i].numpy())
    return psi


def case_behaviour(mesh, psi) -> dict:
    """What a process observes of the run's rules (a JSON record)."""
    size = (8, 8, 8)
    calls = []
    box = make_sharded_box(mesh, size, lambda idx: calls.append(idx) or np.zeros(
        [len(range(*s.indices(d))) for s, d in zip(idx, (1,) + size)], np.float32), in_chan=1)
    local = mesh.local_indices()
    origins = [tuple(s.start for s in idx[1:]) for idx in calls]
    field = ShardedField.shard(np.zeros((4, 4, 4), np.float32), mesh, (0, 1, 2))
    try:
        field.gather()
        gather_error = None
    except ValueError as e:
        gather_error = str(e)
    # one displacement far beyond the margin, in shard 0 only
    cell = BOX_L / BOX_N
    bad = psi.like(each(lambda p: p.clone(), psi.parts))
    if bad.parts[0] is not None:
        bad.parts[0][0, 0, 0, 0] += 10 * cell
    t0 = time.perf_counter()
    try:
        sci.deposit_displacement_sharded(bad, mesh, BOX_L, margin=4)
        deposit_error = None
    except ValueError as e:
        deposit_error = str(e)
    return {"local": local, "block_origins": origins,
            "local_origins": [box.origin(i) for i in local],
            "gather_error": gather_error, "deposit_error": deposit_error,
            "deposit_s": time.perf_counter() - t0,
            "traffic": vars(collectives.traffic).copy()}


def run_cases(mesh, out: Path, pod_argv=None):
    """Every case on ``mesh``: the saved values, and the behaviour record."""
    res = Results()
    case_collectives(mesh, res)
    case_halo(mesh, res)
    case_fill_margins(mesh, res)
    for kind in KINDS:
        case_hierarchical(mesh, res, out, kind)
        case_sharded_box(mesh, res, kind)
    psi = case_science(mesh, res, out)
    record = case_behaviour(mesh, psi)
    if pod_argv is not None:
        pod = run_pod.main([*pod_argv, "--out-dir", str(out / "pod")])
        for name in ("k", "pk", "modes"):
            res.value("pod", name, pod["pk"][name])
        _files(res, "pod", out / "pod")
    return res, record


# ---------------------------------------------------------------------------
# one process of a run
# ---------------------------------------------------------------------------


def _worker(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator")
    p.add_argument("--num-processes", type=int)
    p.add_argument("--process-id", type=int)
    p.add_argument("--mesh", type=int, nargs=3)
    p.add_argument("--out")
    p.add_argument("--fail-rank", type=int, default=None)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    initialize(args.coordinator, args.num_processes, args.process_id, timeout=GROUP_TIMEOUT)
    rank, world = process_index(), process_count()
    if args.fail_rank == rank:
        raise RuntimeError(f"process {rank} fails on purpose")
    if args.fail_rank is not None:
        n = int(np.prod(args.mesh))  # a sum that waits for the failed process
        collectives.psum([torch.ones(1) if i // (n // world) == rank else None for i in range(n)])
    mesh = make_mesh(tuple(args.mesh), devices=[CPU] * (int(np.prod(args.mesh)) // world))
    out = Path(args.out) / f"rank{rank}"
    pod = [*POD, "--coordinator", args.coordinator, "--num-processes", str(world),
           "--process-id", str(rank)] if world == 2 else None
    res, record = run_cases(mesh, out, pod)
    record.update(rank=rank, world=world, jax_modules=sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jax_nbody_emulator_with_dj_tpu")))
    np.savez(out / "results.npz", **res)
    (out / "record.json").write_text(json.dumps(record))
    shutdown()


def _launch(out: Path, world: int, mesh_shape, fail_rank=None, timeout=RUN_TIMEOUT):
    def command(rank, coordinator):
        argv = [sys.executable, str(Path(__file__).resolve()), "--coordinator", coordinator,
                "--num-processes", str(world), "--process-id", str(rank),
                "--mesh", *map(str, mesh_shape), "--out", str(out)]
        return argv + (["--fail-rank", str(fail_rank)] if fail_rank is not None else [])

    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return mp_box.launch(command, world, timeout, cwd=ROOT, env=env)


# ---------------------------------------------------------------------------
# the runs and the one-process references
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runs, started together; the one-process references computed here
    meanwhile.  ``{run: {"ref": Results, "ref_record", "ranks": [(Results,
    record)], "dir", "ref_dir"}}``."""
    base = tmp_path_factory.mktemp("mp")
    out = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as in the processes: a threaded 3D FFT sums in another order
    with ThreadPoolExecutor(len(RUNS)) as pool:
        started = {name: pool.submit(_launch, base / name, world, shape)
                   for name, (world, shape) in RUNS.items()}
        for name, (world, shape) in RUNS.items():
            ref_dir = base / f"ref_{name}"
            pod = POD if world == 2 else None
            ref, record = run_cases(make_mesh(shape, devices=[CPU] * int(np.prod(shape))),
                                    ref_dir, pod)
            out[name] = {"ref": ref, "ref_record": record, "dir": base / name,
                         "ref_dir": ref_dir}
        torch.set_num_threads(threads)
        for name, fut in started.items():
            fut.result()
    for name, (world, _) in RUNS.items():
        ranks = []
        for r in range(world):
            rdir = base / name / f"rank{r}"
            with np.load(rdir / "results.npz") as z:
                ranks.append(({k: z[k] for k in z.files},
                              json.loads((rdir / "record.json").read_text())))
        out[name]["ranks"] = ranks
    return out


def _bit_equal(got, want, key):
    assert got.dtype == want.dtype and got.shape == want.shape, (key, got.dtype, want.dtype)
    if got.tobytes() != want.tobytes():
        np.testing.assert_array_equal(got, want, err_msg=key)
        pytest.fail(f"{key}: equal values, different bits (signed zeros)")


CASES = ["collectives", "halo", "fill_margins", *[f"hier_{k}" for k in KINDS],
         *[f"box_{k}" for k in KINDS], "science", "minkowski", "bispectrum", "resize"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("run", list(RUNS))
def test_bit_identical_to_one_process(runs, run, case):
    r = runs[run]
    want = {k: v for k, v in r["ref"].items() if k.split("|")[0] == case}
    assert want
    seen = {}
    for rank, (got, _) in enumerate(r["ranks"]):
        for key, value in got.items():
            if key.split("|")[0] != case:
                continue
            assert key in want, key
            _bit_equal(value, want[key], f"{run} process {rank}: {key}")
            seen.setdefault(key, []).append(rank)
    assert set(seen) == set(want)
    world = RUNS[run][0]
    for key, ranks in seen.items():  # a shard in one process, a reduced value in all
        assert ranks == (list(range(world)) if key.count("|") == 1 else ranks[:1]), key


def test_every_process_drives_its_own_shards(runs):
    for run, (world, shape) in RUNS.items():
        n = int(np.prod(shape))
        owned = []
        for rank, (_, rec) in enumerate(runs[run]["ranks"]):
            assert rec["rank"] == rank and rec["world"] == world
            assert rec["local"] == list(range(rank * n // world, (rank + 1) * n // world))
            # make_sharded_box asked for this process's blocks only, once each
            assert sorted(map(tuple, rec["block_origins"])) == sorted(
                map(tuple, rec["local_origins"]))
            owned += rec["local"]
            assert rec["traffic"]["bytes_sent"] > 0 and rec["traffic"]["messages"] > 0
        assert sorted(owned) == list(range(n))
        assert runs[run]["ref_record"]["local"] == list(range(n))


def test_processes_import_no_jax(runs):
    for run in RUNS:
        for _, rec in runs[run]["ranks"]:
            assert rec["jax_modules"] == []


def test_gather_of_a_multi_process_field_raises(runs):
    for run in RUNS:
        for _, rec in runs[run]["ranks"]:
            assert "other processes" in rec["gather_error"]
        assert runs[run]["ref_record"]["gather_error"] is None


def test_a_check_raises_in_every_process(runs):
    """The deposit's margin check sees a displacement that only shard 0 holds,
    and every process raises, none waits for the others (each went on to its
    next case and finished)."""
    for run in RUNS:
        recs = [rec for _, rec in runs[run]["ranks"]] + [runs[run]["ref_record"]]
        for rec in recs:
            assert rec["deposit_error"] and "margin 4 cells" in rec["deposit_error"]
            assert rec["deposit_s"] < GROUP_TIMEOUT / 2
        assert len({rec["deposit_error"] for rec in recs}) == 1


def test_mp_box_records(runs):
    """``mp_box``'s record: bytes inside and across processes, and the
    per-boundary bytes each process sent."""
    for run, (world, _) in RUNS.items():
        for rank in range(world):
            rec = json.loads((runs[run]["dir"] / f"rank{rank}" / "hier_vel" /
                              f"mp_box_{rank}.json").read_text())
            assert rec["process_count"] == world and rec["launches"] == {"B1": 0, "B2": 0}
            assert rec["cross_bytes_sent"] > 0 and rec["cross_bytes_received"] > 0
            assert rec["margin_bytes"] == rec["inside_bytes"] + rec["cross_bytes_received"]
            assert rec["cross_bytes_sent"] == sum(v for k, v in rec["halo_bytes"].items()
                                                  if k.startswith("sent_"))
            assert "exchange_cross" in rec["phase_ms"]


def test_run_pod_on_two_processes(runs):
    r = runs["2x411"]
    want = {k: v for k, v in r["ref"].items() if k.startswith("pod|")}
    files = [k for k in want if k.count("|") == 2]
    assert len(files) == 8 and {"pod|k", "pod|pk", "pod|modes"} <= set(want)
    written = sorted(p.name for rank in range(2) for p in (r["dir"] / f"rank{rank}" /
                                                           "pod").glob("*.npy"))
    assert written == sorted(p.name for p in (r["ref_dir"] / "pod").glob("*.npy"))
    seen = []
    for rank, (got, _) in enumerate(r["ranks"]):
        for name in ("k", "pk", "modes"):  # the same P(k) in every process
            _bit_equal(got[f"pod|{name}"], want[f"pod|{name}"], f"process {rank}: pod {name}")
        for key in (k for k in got if k.startswith("pod|") and k.count("|") == 2):
            _bit_equal(got[key], want[key], f"process {rank}: {key}")
            seen.append(key)
    assert sorted(seen) == sorted(files)


def test_fof_over_every_process_files(runs):
    for run, (world, _) in RUNS.items():
        files = [f for rank in range(world)
                 for f in sorted((runs[run]["dir"] / f"rank{rank}" / "fof").glob("*.npy"))]
        ref_files = sorted((runs[run]["ref_dir"] / "fof").glob("*.npy"))
        assert sorted(f.name for f in files) == sorted(f.name for f in ref_files)

        def pieces(fs):
            return [(str(f), tuple(int(v) for v in f.stem.split("_")[1:])) for f in fs]

        b = 0.2 * FOF_L / FOF_N
        got = friends_of_friends_sharded(pieces(files), FOF_N, FOF_L, b, nmin=5, n_slabs=3,
                                             return_labels=True)
        want = friends_of_friends_sharded(pieces(ref_files), FOF_N, FOF_L, b, nmin=5,
                                              n_slabs=3, return_labels=True)
        assert got["n_groups"] == want["n_groups"] > 0
        np.testing.assert_array_equal(got["labels"], want["labels"])
        np.testing.assert_array_equal(got["lengths"], want["lengths"])


def test_multi_process_box_matches_jax(runs):
    """The 4-process premodulated box against JAX's sharded runtime on the
    8 virtual CPU devices, the same seeded box and style tree (each package
    folds it at (z, Om))."""
    import jax

    from jax_nbody_emulator_with_dj_tpu.emulator import modulate_emulator_parameters as jmod
    from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalConfig as JConfig
    from jax_nbody_emulator_with_dj_tpu.models import NBodyEmulatorCore as JCore
    from jax_nbody_emulator_with_dj_tpu.parallel import ShardedHierarchicalProcessor as JProc
    from jax_nbody_emulator_with_dj_tpu.parallel import mesh as jmesh

    if len(jax.devices()) < 8:
        pytest.fail("tests/conftest.py gives JAX 8 virtual CPU devices")
    n, shape = 32, RUNS["4x222"][1]
    box = np.empty((3, n, n, n), np.float32)
    for i in range(8):
        idx = block_index(box.shape, (1, 2, 3), shape, i)
        box[idx] = mp_box.box_block(0, (n,) * 3, idx)

    def numpy_tree(t):
        return {k: numpy_tree(v) for k, v in t.items()} if isinstance(t, dict) else t.numpy()

    jparams = jmod(numpy_tree(init_unet(0, style=True, mid_chan=4)), Z, OM)
    jcfg = JConfig(size=(n,) * 3, slab=8, tile=(16, 16, 16), dtype=np.float32,
                   output_dtype=np.float32)
    want = JProc(JCore(mid_chan=4), jparams, jmesh.make_mesh(shape), jcfg).process_box(
        box, Z, OM, as_numpy=True)
    got = np.empty_like(want)
    files = [f for r in range(4)
             for f in (runs["4x222"]["dir"] / f"rank{r}" / "hier_disp").glob("dis_*.npy")]
    assert len(files) == 8
    for f in files:
        x0, y0, z0 = (int(v) for v in f.stem.split("_")[1:])
        got[:, x0:x0 + 16, y0:y0 + 16, z0:z0 + 16] = np.load(f)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_a_failed_process_stops_the_run(tmp_path):
    """Process 1 raises right after the join while process 0 waits in a
    collective: the run fails at once, with process 1's error, long before
    the group's timeout."""
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        _launch(tmp_path, 2, (2, 1, 1), fail_rank=1)
    assert time.perf_counter() - t0 < GROUP_TIMEOUT


def test_launch_moves_off_a_taken_port(monkeypatch):
    """Another program binds the chosen port before process 0 does: ``launch``
    starts the run once more on a new port, and it succeeds there."""
    held = []
    chosen = []
    free_port = mp_box.free_port

    def port_then_free():
        port = free_port()
        if not held:  # the first port: taken by the time process 0 binds it
            sock = socket.socket()
            sock.bind(("127.0.0.1", port))
            sock.listen()
            held.append(sock)
        chosen.append(port)
        return port

    def command(rank, coordinator):
        return [sys.executable, "-c",
                "import sys\n"
                "from jax_nbody_emulator_with_dj_tpu_torch.parallel import (\n"
                "    initialize, process_count, shutdown)\n"
                f"initialize({coordinator!r}, 2, {rank}, timeout={GROUP_TIMEOUT})\n"
                "print(process_count(), sys.argv[-1])\n"
                "shutdown()\n", coordinator]

    monkeypatch.setattr(mp_box, "free_port", port_then_free)
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    try:
        texts = mp_box.launch(command, 2, RUN_TIMEOUT, cwd=ROOT, env=env)
    finally:
        held[0].close()
    assert len(chosen) == 2 and chosen[0] != chosen[1]
    assert [out.split() for out, _ in texts] == [["2", f"127.0.0.1:{chosen[1]}"]] * 2


# ---------------------------------------------------------------------------
# initialize
# ---------------------------------------------------------------------------


def test_a_one_process_group_equals_no_group(tmp_path):
    mesh_shape = (2, 2, 2)
    ref = Results()
    case_collectives(make_mesh(mesh_shape, devices=[CPU] * 8), ref)
    case_hierarchical(make_mesh(mesh_shape, devices=[CPU] * 8), ref, tmp_path / "none", "vel")
    initialize(f"127.0.0.1:{mp_box.free_port()}", 1, 0, timeout=GROUP_TIMEOUT)
    try:
        assert torch.distributed.is_initialized() and process_count() == 1
        got = Results()
        case_collectives(make_mesh(mesh_shape, devices=[CPU] * 8), got)
        case_hierarchical(make_mesh(mesh_shape, devices=[CPU] * 8), got, tmp_path / "one", "vel")
    finally:
        shutdown()
    assert not torch.distributed.is_initialized()
    assert set(got) == set(ref)
    for key in ref:
        _bit_equal(got[key], ref[key], key)


def test_initialize_from_the_jax_environment_names(monkeypatch):
    for name in ("COORDINATOR_ADDRESS",):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"127.0.0.1:{mp_box.free_port()}")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    initialize(timeout=GROUP_TIMEOUT)
    try:
        assert torch.distributed.is_initialized()
        assert (process_index(), process_count()) == (0, 1)
        initialize(timeout=GROUP_TIMEOUT)  # a second call is a no-op
        assert torch.distributed.get_backend() == "gloo"
    finally:
        shutdown()
    assert not torch.distributed.is_initialized()
    shutdown()  # a no-op without a group


def test_meshes_split_over_processes(monkeypatch):
    """Ownership without a group: contiguous row-major blocks, remote shards
    on ``meta``; an uneven split or too few devices raise."""
    from jax_nbody_emulator_with_dj_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(tmesh, "process_count", lambda: 4)
    monkeypatch.setattr(tmesh, "process_index", lambda: 1)
    mesh = make_mesh((2, 2, 2), devices=[CPU] * 2)
    assert mesh.local_indices() == [2, 3]
    assert [d.type for d in mesh.devices.flat] == ["meta"] * 2 + ["cpu"] * 2 + ["meta"] * 4
    assert mesh.process_ids.ravel().tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert mesh.distinct_devices() == [CPU]
    with pytest.raises(ValueError, match="do not split over 4 processes"):
        make_mesh((3, 1, 1), devices=[CPU] * 3)
    with pytest.raises(ValueError, match="needs 2 devices a process, have 1"):
        make_mesh((2, 2, 2), devices=[CPU])


if __name__ == "__main__":
    try:
        _worker(sys.argv[1:])
    except Exception:  # exit non-zero whatever state the group is in
        import traceback

        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)
