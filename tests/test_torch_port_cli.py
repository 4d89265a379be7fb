"""The port's command-line drivers (``cli/``) and the exports and resample
convs they rest on, against the JAX package, on the CPU.

- ``models`` / ``ops`` exports and ``min_input_size``; ``conv3d_up`` and the
  strided ``conv3d`` against JAX's in both activation formats, and
  ``models/blocks.py::_run_conv`` "up" / "down" under every format pair
  (a channel count equal to the last spatial extent included): float32,
  rtol 1e-5 / atol 1e-6.
- The JAX scripts run in-process (``runpy`` with a patched ``argv``) beside
  the port's ``main(argv)`` at ``n_part`` 16, ``mid_chan`` 4, float32, both
  on one ``--params`` file written by JAX's ``save_params_npz``:
  ``run_emulator`` (mode B, both runtimes: the fields at
  ``test_torch_port_pipeline.py``'s gates), ``quijote_comparison`` (metric
  keys identical, values rtol 1e-4 with atol 1e-6 for the field means, which
  are zero up to float32 rounding), ``run_batch`` (premodulated and
  ``--style``: disp rel max 2e-4, vel rms 1e-3) and ``halos`` with
  ``--engine numpy`` (catalogue lengths exactly equal).
- Port-only smoke runs of ``upsampling``, ``fof_scale_demo``,
  ``basic_usage`` and ``run_pod``, two ``python -m`` runs, and the package
  data of the port's native sources.
"""

import contextlib
import fnmatch
import json
import os
import runpy
import subprocess
import sys
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorVelCore as JStyleVelCore
from jax_nbody_emulator_with_dj_tpu import models as jmodels
from jax_nbody_emulator_with_dj_tpu import ops as jops
from jax_nbody_emulator_with_dj_tpu.models import blocks as jblocks
from jax_nbody_emulator_with_dj_tpu.utils.params import save_params_npz as jax_save_params
from jax_nbody_emulator_with_dj_tpu_torch import models as tmodels
from jax_nbody_emulator_with_dj_tpu_torch import ops as tops
from jax_nbody_emulator_with_dj_tpu_torch.cli import (
    _common,
    basic_usage,
    fof_scale_demo,
    halos,
    quijote_comparison,
    run_batch,
    run_emulator,
    run_pod,
    upsampling,
)
from jax_nbody_emulator_with_dj_tpu_torch.models import blocks as tblocks

torch.set_num_threads(2)  # tier-1 runs several xdist workers

ROOT = Path(__file__).resolve().parent.parent
SCRIPTS = ROOT / "scripts"
N, MID, BOX = 16, 4, 250.0
FMTS = ("NDHWC", "NCDHW")
FMT_PAIRS = [(a, b) for a in FMTS for b in FMTS]


def rel_max(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((a - b).std() / b.std())


# ---------------------------------------------------------------------------
# C8: exports, min_input_size, conv3d_up, strided conv3d
# ---------------------------------------------------------------------------


def test_subpackage_imports():
    from jax_nbody_emulator_with_dj_tpu_torch.models import NBodyEmulatorCore, min_input_size
    from jax_nbody_emulator_with_dj_tpu_torch.ops import conv3d_up, premodulate_layer

    assert callable(NBodyEmulatorCore) and callable(conv3d_up) and callable(premodulate_layer)
    assert min_input_size(1) == 32 and min_input_size(3) == 104


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_min_input_size_matches_jax(levels):
    assert tmodels.min_input_size(levels) == jmodels.min_input_size(levels)
    n = tmodels.min_input_size(levels)
    assert tmodels.valid_input_size(n, levels) and not tmodels.valid_input_size(n - 8, levels)


def _act(shape, fmt, seed):
    """A seeded float32 activation of spatial ``shape`` with C channels, in ``fmt``."""
    c, *sp = shape
    x = np.random.default_rng(seed).standard_normal((1, *sp, c)).astype(np.float32)
    return x if fmt == "NDHWC" else np.ascontiguousarray(np.moveaxis(x, -1, 1))


def _kernel(k, ci, co, seed):
    return (np.random.default_rng(seed).standard_normal((k, k, k, ci, co)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("in_fmt,out_fmt", FMT_PAIRS)
def test_conv3d_up_matches_jax(in_fmt, out_fmt):
    x, w = _act((4, 5, 6, 7), in_fmt, 0), _kernel(2, 4, 3, 1)
    ref = jops.conv3d_up(jnp.asarray(x), jnp.asarray(w), in_fmt=in_fmt, out_fmt=out_fmt)
    got = tops.conv3d_up(torch.from_numpy(x), torch.from_numpy(w), in_fmt=in_fmt,
                         out_fmt=out_fmt)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("in_fmt,out_fmt", FMT_PAIRS)
@pytest.mark.parametrize("k", [2, 3])
def test_conv3d_stride2_matches_jax(in_fmt, out_fmt, k):
    x, w = _act((4, 8, 9, 10), in_fmt, 2), _kernel(k, 4, 5, 3)
    ref = jops.conv3d(jnp.asarray(x), jnp.asarray(w), stride=2, in_fmt=in_fmt, out_fmt=out_fmt)
    got = tops.conv3d(torch.from_numpy(x), torch.from_numpy(w), stride=2, in_fmt=in_fmt,
                      out_fmt=out_fmt)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# C9: the resample convs honour the activation formats
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_fmt,out_fmt", FMT_PAIRS)
@pytest.mark.parametrize("kind", ["up", "down"])
@pytest.mark.parametrize("shape", [(4, 8, 8, 8), (8, 6, 4, 8)],
                         ids=["c4", "c_equals_last_extent"])
def test_run_conv_resample_matches_jax(kind, in_fmt, out_fmt, shape):
    x, w = _act(shape, in_fmt, 4), _kernel(2, shape[0], 5, 5)
    ref = jblocks._run_conv(jnp.asarray(x), jnp.asarray(w), kind, in_fmt=in_fmt,
                            out_fmt=out_fmt)
    got = tblocks._run_conv(torch.from_numpy(x), torch.from_numpy(w), kind, in_fmt=in_fmt,
                            out_fmt=out_fmt)
    assert tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_package_data_covers_native_sources():
    from setuptools import find_packages

    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"]["setuptools"]
    packages = find_packages(str(ROOT), include=cfg["packages"]["find"]["include"])
    native = "jax_nbody_emulator_with_dj_tpu_torch.native"
    assert native in packages and "jax_nbody_emulator_with_dj_tpu_torch.cli" in packages
    patterns = cfg["package-data"][native]
    for name in ("fof.cpp", "staging.cpp"):
        assert (ROOT / native.replace(".", "/") / name).exists()
        assert any(fnmatch.fnmatch(name, p) for p in patterns), name


# ---------------------------------------------------------------------------
# The drivers against the JAX scripts
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _argv(argv):
    saved = sys.argv[:], sys.path[:]
    sys.argv = argv
    try:
        yield
    finally:
        sys.argv, sys.path[:] = saved


def run_jax_script(script: Path, args):
    """A JAX script run in this process as ``python script args``."""
    with _argv([str(script), *map(str, args)]):
        runpy.run_path(str(script), run_name="__main__")


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return tmp_path_factory.mktemp("cli")


@pytest.fixture(scope="module")
def params_npz(work):
    """One style tree at mid 4, written by JAX's ``save_params_npz``."""
    path = work / "params.npz"
    jax_save_params(path, JStyleVelCore(mid_chan=MID).init(jax.random.key(0)))
    return path


@pytest.fixture(scope="module")
def delta_npy(work):
    path = work / "delta.npy"
    np.save(path, (np.random.default_rng(0).normal(size=(N, N, N)) * 0.1).astype(np.float32))
    return path


EMU_ARGS = ["--n-part", N, "--boxsize", BOX, "--z", 0.5, "--ndiv", 1, 1, 1, "--precision", "f32",
            "--mid-chan", MID, "--no-plots"]
EMU_GATES = {"delta_lin": 1e-5, "delta_lpt": 1e-5, "psi_emu": 2e-4, "vel_emu": 1e-3,
             "delta_emu": 1e-5}


@pytest.fixture(scope="module")
def emulator_runs(work, params_npz, delta_npy):
    """runtime -> (JAX out dir, port out dir), each run once."""
    cache = {}

    def get(runtime):
        if runtime not in cache:
            args = ["--input-delta", delta_npy, "--params", params_npz, "--runtime", runtime,
                    *EMU_ARGS]
            jdir, tdir = work / f"jax_emu_{runtime}", work / f"port_emu_{runtime}"
            run_jax_script(SCRIPTS / "run_emulator.py", [*args, "--out-dir", jdir])
            run_emulator.main([*map(str, args), "--out-dir", str(tdir), "--device", "cpu"])
            cache[runtime] = jdir, tdir
        return cache[runtime]

    return get


@pytest.mark.parametrize("field", sorted(EMU_GATES))
@pytest.mark.parametrize("runtime", ["subbox", "auto"])
def test_run_emulator_matches_jax(emulator_runs, runtime, field):
    jdir, tdir = emulator_runs(runtime)
    ref, got = np.load(jdir / f"{field}.npy"), np.load(tdir / f"{field}.npy")
    assert got.shape == ref.shape and np.isfinite(got).all()
    if field == "vel_emu":
        assert rms(got, ref) < EMU_GATES[field]
    elif field == "delta_emu":  # the deposit's gate, in units of the mean density
        assert np.abs(got - ref).max() < EMU_GATES[field]
    else:
        assert rel_max(got, ref) < EMU_GATES[field]


@pytest.mark.parametrize("runtime", ["subbox", "auto"])
def test_run_emulator_metadata_matches_jax(emulator_runs, runtime):
    jdir, tdir = emulator_runs(runtime)
    ref = json.loads((jdir / "metadata.json").read_text())
    got = json.loads((tdir / "metadata.json").read_text())
    assert set(ref) <= set(got) and got["card"] is None and got["device"] == "cpu"
    for key in ("n_part", "boxsize", "z", "cosmology", "runtime", "precision", "ndiv"):
        assert got[key] == ref[key], key
    assert set(ref["timings"]) <= set(got["timings"])
    # the figures' data without matplotlib, and --plot-only recomputes it
    for name in ("density_slices.npy", "power_spectrum.json", "minkowski.json"):
        assert (tdir / name).exists(), name
    before = json.loads((tdir / "power_spectrum.json").read_text())
    run_emulator.main(["--out-dir", str(tdir), "--plot-only", "--device", "cpu"])
    assert json.loads((tdir / "power_spectrum.json").read_text()) == before


QUIJOTE_ARGS = ["--ic-z", 127.0, "--n-part", N, "--boxsize", BOX, "--ndiv", 1, 1, 1,
                "--precision", "f32", "--mid-chan", MID]


@pytest.fixture(scope="module")
def quijote_fields(work):
    rng = np.random.default_rng(0)
    ic, target = work / "q_ic.npy", work / "q_target.npy"
    np.save(ic, rng.normal(0, 1.0, size=(N, N, N)).astype(np.float32))
    np.save(target, rng.normal(0, 1.2, size=(N, N, N)).astype(np.float32))
    return ic, target


def test_quijote_comparison_matches_jax(work, params_npz, quijote_fields):
    ic, target = quijote_fields
    args = ["--ic-delta", ic, "--target-delta", target, "--params", params_npz, *QUIJOTE_ARGS]
    run_jax_script(SCRIPTS / "quijote_comparison.py",
                   [*args, "--out-dir", work / "jax_q", "--no-plots"])
    out = quijote_comparison.main([*map(str, args), "--out-dir", str(work / "port_q"),
                                   "--device", "cpu"])
    ref = json.loads((work / "jax_q" / "metadata.json").read_text())["metrics"]
    got = out["metadata"]["metrics"]
    assert json.loads((work / "port_q" / "metadata.json").read_text())["metrics"] == got
    assert set(got) == set(ref)
    for which in ref:
        assert set(got[which]) == set(ref[which])
        for key, value in ref[which].items():
            np.testing.assert_allclose(got[which][key], value, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{which}.{key}")
    for name in ("slices.npy", "spectra.json", "pdf.json", "bispectrum.json", "minkowski.json"):
        assert (work / "port_q" / name).exists(), name


def test_quijote_comparison_mesh_matches_single_device(work, params_npz, quijote_fields):
    """``--mesh 2 2 2`` over the CPU repeated: the sharded estimators' metrics
    equal the single-device ones (PERF.md's sharded-science gates)."""
    ic, target = quijote_fields
    args = ["--ic-delta", ic, "--target-delta", target, "--params", params_npz, *QUIJOTE_ARGS,
            "--device", "cpu"]
    single = quijote_comparison.main([*map(str, args), "--out-dir", str(work / "q_single")])
    mesh = quijote_comparison.main([*map(str, args), "--out-dir", str(work / "q_mesh"),
                                    "--mesh", "2", "2", "2", "--devices", "cpu"])
    for which, ref in single["metadata"]["metrics"].items():
        for key, value in ref.items():
            np.testing.assert_allclose(mesh["metadata"]["metrics"][which][key], value,
                                       rtol=1e-5, atol=1e-6, err_msg=f"{which}.{key}")
    with pytest.raises(ValueError, match="needs 8 devices"):
        quijote_comparison.main([*map(str, args), "--out-dir", str(work / "q_bad"),
                                 "--mesh", "2", "2", "2", "--devices", "cpu", "cpu"])


@pytest.fixture(scope="module")
def batch_inputs(work):
    d = work / "batch_in"
    d.mkdir()
    for i, name in enumerate(("box_a", "box_b")):
        box = np.random.default_rng(10 + i).standard_normal((3, N, N, N)).astype(np.float32)
        np.save(d / f"{name}.npy", box)
    cosmo = work / "cosmo.json"
    cosmo.write_text(json.dumps({"box_a.npy": {"z": 0.0, "Om": 0.3175},
                                 "box_b.npy": {"z": 0.5, "Om": 0.28}}))
    return d, cosmo


@pytest.mark.parametrize("style", [False, True], ids=["premodulated", "style"])
def test_run_batch_matches_jax(work, params_npz, batch_inputs, style):
    d, cosmo = batch_inputs
    tag = "style" if style else "premod"
    args = ["--inputs", d / "*.npy", "--cosmo-json", cosmo, "--params", params_npz,
            "--ndiv", 1, 1, 1, "--precision", "f32", "--mid-chan", MID,
            "--runtime", "auto" if style else "subbox"] + (["--style"] if style else [])
    run_jax_script(SCRIPTS / "run_jax_emulator.py",
                   [*args, "--out-dir", work / f"jax_b_{tag}", "--compilation-cache", ""])
    out = run_batch.main([*map(str, args), "--out-dir", str(work / f"port_b_{tag}"),
                          "--device", "cpu"])
    ref = json.loads((work / f"jax_b_{tag}" / "batch_summary.json").read_text())
    assert [r["input"] for r in out["records"]] == [r["input"] for r in ref]
    for r, g in zip(ref, out["records"]):
        assert set(r) <= set(g) and (g["z"], g["Om"], g["n"]) == (r["z"], r["Om"], r["n"])
    for name in ("box_a", "box_b"):
        jd, td = work / f"jax_b_{tag}", work / f"port_b_{tag}"
        assert rel_max(np.load(td / f"{name}_disp.npy"), np.load(jd / f"{name}_disp.npy")) < 2e-4
        assert rms(np.load(td / f"{name}_vel.npy"), np.load(jd / f"{name}_vel.npy")) < 1e-3
    with pytest.raises(ValueError, match="outside"):
        run_batch.validate(3.5, 0.3, "x.npy")


@pytest.fixture(scope="module")
def clumped_psi(work):
    path = work / "clumped.npy"
    np.save(path, fof_scale_demo.clumped_displacement(32, 500.0, 1.0))
    return path


def test_halos_matches_jax(work, clumped_psi):
    args = ["--displacement", clumped_psi, "--boxsize", 500.0, "--engine", "numpy"]
    run_jax_script(SCRIPTS / "halos.py", [*args, "--out-dir", work / "jax_h", "--no-plots"])
    out = halos.main([*map(str, args), "--out-dir", str(work / "port_h"), "--device", "cpu"])
    with np.load(work / "jax_h" / "halo_catalog.npz") as ref:
        assert out["summary"]["n_halos"] > 0
        np.testing.assert_array_equal(np.sort(out["lengths"]), np.sort(ref["lengths"]))
    ref_meta = json.loads((work / "jax_h" / "fof_summary.json").read_text())
    assert set(ref_meta) <= set(out["summary"])
    assert {k: out["summary"][k] for k in ref_meta} == ref_meta
    hmf = json.loads((work / "port_h" / "hmf.json").read_text())
    assert len(hmf["mass"]) == len(hmf["tinker08"]) > 0 and np.all(np.isfinite(hmf["tinker08"]))


def test_halos_slabs_and_shards_agree(work, clumped_psi):
    base = ["--boxsize", "500", "--engine", "numpy", "--device", "cpu"]
    one = halos.main(["--displacement", str(clumped_psi), *base, "--out-dir", str(work / "h1")])
    two = halos.main(["--displacement", str(clumped_psi), *base, "--n-slabs", "2",
                      "--out-dir", str(work / "h2")])
    np.testing.assert_array_equal(np.sort(two["lengths"]), np.sort(one["lengths"]))
    pieces = work / "pieces"
    pieces.mkdir()
    psi = np.load(clumped_psi)
    for i0 in (0, 16):
        for j0 in (0, 16):
            np.save(pieces / f"dis_{i0}_{j0}_0.npy", psi[:, i0:i0 + 16, j0:j0 + 16, :])
    sh = halos.main(["--displacement", str(pieces / "dis_*.npy"), *base,
                     "--out-dir", str(work / "h3")])
    assert sh["summary"]["n_shards"] == 4
    np.testing.assert_array_equal(np.sort(sh["lengths"]), np.sort(one["lengths"]))


# ---------------------------------------------------------------------------
# Port-only smoke runs
# ---------------------------------------------------------------------------


def test_upsampling_smoke(tmp_path):
    out = upsampling.main(["--n-in", "16", "--factor", "2", "--device", "cpu",
                           "--out-dir", str(tmp_path)])
    meta = out["metadata"]
    assert meta["n_out"] == 32 and set(meta["timings"]) == {
        "grf_seconds", "upsample_seconds", "downsample_seconds"}
    # the JAX package's own gates for upsample_modes (tests/test_science.py::TestResize)
    assert abs(meta["fine_pk_over_target_median"] - 1) < 0.2
    assert meta["low_k_c_of_downsampled"] > 0.5
    assert (tmp_path / "upsampling.json").exists() and not list(tmp_path.glob("*.png"))


def test_fof_scale_demo_engines_agree(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = fof_scale_demo.main(["--n", "32", "--engines", "native", "numpy", "--device", "cpu"])
    # the default path is under runs/, never the committed docs/ records
    assert Path(out["out"]) == Path("runs/fof_scale_32.json") and Path(out["out"]).exists()
    assert not (tmp_path / "docs").exists()
    cats = out["catalogues"]
    assert len(cats["native"]["lengths"]) > 0
    np.testing.assert_array_equal(np.sort(cats["native"]["lengths"]),
                                  np.sort(cats["numpy"]["lengths"]))
    runs = json.loads(Path(out["out"]).read_text())["runs"]
    assert [r["engine"] for r in runs] == ["native", "numpy"]


def test_basic_usage_smoke():
    out = basic_usage.main(["--size", "16", "--levels", "1", "--mid-chan", "4", "--device", "cpu"])
    assert out["style"]["disp"].shape == out["style"]["vel"].shape == (3, 16, 16, 16)
    assert out["direct"] == {"in": (1, 3, 40, 40, 40), "out": (1, 3, 16, 16, 16), "margin": 12}
    assert out["premodulated_range"][0] == out["premodulated_range"][1]
    assert out["sharded"]["disp"].shape == (3, 16, 16, 16)
    assert np.isfinite(out["sharded"]["disp"]).all() and out["growth"][0] == pytest.approx(1.0)


def test_run_pod_on_cpu_mesh(tmp_path, capsys):
    out = run_pod.main(["--size", "64", "--mesh", "2", "2", "2", "--devices", "cpu",
                        "--device", "cpu", "--ic-seed", "5", "--validate", "--mid-chan", "4",
                        "--no-vel", "--boxsize", "200", "--out-dir", str(tmp_path)])
    assert "emulated-density P(k):" in capsys.readouterr().out
    assert out["shards"] == 8 and np.all(np.isfinite(out["pk"]["pk"]))
    dis = sorted(tmp_path.glob("dis_*.npy"))
    assert len(dis) == 8 and not list(tmp_path.glob("vel_*.npy"))
    assert all(np.isfinite(np.load(f)).all() for f in dis)


def test_run_pod_refuses_what_it_cannot_run():
    base = ["--size", "32", "--mid-chan", "4", "--device", "cpu", "--devices", "cpu"]
    with pytest.raises(ValueError, match="the number of processes"):  # --num-processes missing
        run_pod.main([*base, "--coordinator", "localhost:1234", "--process-id", "0"])
    with pytest.raises(ValueError, match="needs 8 devices"):
        run_pod.main(["--size", "32", "--mid-chan", "4", "--device", "cpu", "--mesh", "2", "2",
                      "2", "--devices", "cpu", "cpu"])


def test_entry_points_need_a_card_or_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        upsampling.main(["--n-in", "16", "--out-dir", str(tmp_path)])
    assert _common.card_line(torch.device("cpu")) is None


def test_plots_without_matplotlib_name_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        _common.pyplot()


@pytest.mark.parametrize("module,args", [
    ("upsampling", ["--n-in", "16", "--factor", "2"]),
    ("basic_usage", ["--size", "16", "--levels", "1", "--mid-chan", "2"]),
])
def test_python_m_runs(tmp_path, module, args):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA_")}
    extra = ["--out-dir", str(tmp_path)] if module == "upsampling" else []
    proc = subprocess.run(
        [sys.executable, "-m", f"jax_nbody_emulator_with_dj_tpu_torch.cli.{module}", *args,
         "--device", "cpu", *extra],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    if module == "upsampling":
        assert "fine_pk_over_target_median" in json.loads((tmp_path / "metadata.json").read_text())
    else:
        assert "[6] auto geometry" in proc.stdout
