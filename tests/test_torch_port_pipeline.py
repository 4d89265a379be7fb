"""The port's science pipeline against the JAX package's, on the CPU.

``run_lpt_emulator_pipeline`` in ``input_delta`` mode at n_part=16,
mid_chan=4, float32, with the JAX parameters carried across by
``utils.params.params_from_jax``, through the subbox runtime (``ndiv=(1,1,1)``)
and the planned hierarchical one (``runtime="auto"``), for the displacement
and the displacement+velocity models.  Every field of ``PipelineResult`` is
held against JAX's: ``delta_lin``, ``psi_lpt`` and ``delta_lpt`` at rel max
1e-5, ``psi_emu`` at rel max 2e-4 and ``vel_emu`` at rms 1e-3 (the gates of
the port's float32 slice tests), ``delta_emu`` at max abs 1e-5 in units of
the mean density (the deposit's gate).  Each JAX pipeline runs once per
module.  Then the JAX package's own pipeline checks, on the port.
"""

import json

import jax
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorCore, StyleNBodyEmulatorVelCore
from jax_nbody_emulator_with_dj_tpu.pipeline import run_lpt_emulator_pipeline as jax_pipeline
from jax_nbody_emulator_with_dj_tpu_torch import PipelineResult, run_lpt_emulator_pipeline
from jax_nbody_emulator_with_dj_tpu_torch import pipeline as tpipe
from jax_nbody_emulator_with_dj_tpu_torch.chunked import (
    ChunkedHierarchicalConfig,
    ChunkedHierarchicalProcessor,
)
from jax_nbody_emulator_with_dj_tpu_torch.pipeline import QUIJOTE_FIDUCIAL
from jax_nbody_emulator_with_dj_tpu_torch.science.linear_pk import eisenstein_hu_pk
from jax_nbody_emulator_with_dj_tpu_torch.utils.params import params_from_jax

N = 16
MID = 4
COMMON = dict(n_part=N, boxsize=250.0, z=0.5, load_params=False, premodulate=True,
              ndiv=(1, 1, 1), precision="f32", mid_chan=MID)
FIELDS = ("delta_lin", "psi_lpt", "delta_lpt", "psi_emu", "vel_emu", "delta_emu")
RUNS = [(rt, vel) for rt in ("subbox", "auto") for vel in (False, True)]


@pytest.fixture(scope="module")
def jax_params():
    return {vel: (StyleNBodyEmulatorVelCore if vel else StyleNBodyEmulatorCore)(
        mid_chan=MID).init(jax.random.key(0)) for vel in (False, True)}


@pytest.fixture(scope="module")
def input_delta():
    return (np.random.default_rng(0).normal(size=(N, N, N)) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def results(jax_params, input_delta):
    """(runtime, vel) -> (JAX result, port result), each computed once."""
    cache = {}

    def get(runtime, vel):
        if (runtime, vel) not in cache:
            kw = dict(COMMON, input_delta=input_delta, compute_vel=vel, runtime=runtime)
            ref = jax_pipeline(params=jax_params[vel], **kw)
            got = run_lpt_emulator_pipeline(params=params_from_jax(jax_params[vel]),
                                            device="cpu", **kw)
            cache[(runtime, vel)] = ref, got
        return cache[(runtime, vel)]

    return get


def _rel_max(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("runtime,vel", RUNS)
def test_pipeline_field_matches_jax(results, runtime, vel, field):
    ref, got = results(runtime, vel)
    r, g = getattr(ref, field), getattr(got, field)
    if r is None:
        assert field == "vel_emu" and not vel and g is None
        return
    assert isinstance(g, np.ndarray) and g.dtype == np.float32 and g.shape == r.shape
    if field == "psi_emu":
        assert _rel_max(g, r) < 2e-4
    elif field == "vel_emu":
        assert float((g.astype(np.float64) - r).std() / r.astype(np.float64).std()) < 1e-3
    elif field == "delta_emu":
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5)
    else:
        assert _rel_max(g, r) < 1e-5


@pytest.mark.parametrize("runtime,vel", RUNS)
def test_pipeline_metadata_matches_jax(results, runtime, vel):
    ref, got = results(runtime, vel)
    assert isinstance(got, PipelineResult)
    assert set(got.metadata) == set(ref.metadata)
    assert set(got.timings) == set(ref.timings)
    for key in set(ref.metadata) - {"timings", "voxels_per_second", "device", "growth_factor"}:
        assert got.metadata[key] == ref.metadata[key], key
    assert np.isclose(got.metadata["growth_factor"], ref.metadata["growth_factor"], rtol=1e-6)
    assert got.metadata["device"] == "cpu"
    assert got.timings["emulator_seconds_includes_compile"] is True
    assert len(got.timings["emulator_runs_seconds"]) == 1


def test_delta_mode_starts_from_the_given_field(results, input_delta):
    _, got = results("subbox", False)
    np.testing.assert_array_equal(got.delta_lin, input_delta)


def test_seed_mode_end_to_end(jax_params, tmp_path):
    res = run_lpt_emulator_pipeline(seed=1, params=params_from_jax(jax_params[True]),
                                    compute_vel=True, num_sims=2, out_dir=tmp_path,
                                    save_fields=True, device="cpu", **COMMON)
    for name in ("psi_emu", "vel_emu", "psi_lpt"):
        assert getattr(res, name).shape == (3, N, N, N)
    assert res.delta_emu.shape == (N, N, N) and np.all(np.isfinite(res.delta_emu))
    assert len(res.timings["emulator_runs_seconds"]) == 2
    assert res.timings["emulator_seconds_includes_compile"] is False
    meta = json.loads((tmp_path / "metadata.json").read_text())
    assert meta["n_part"] == N and meta["seed"] == 1
    for name in ("delta_lin", "delta_lpt", "delta_emu", "psi_emu", "vel_emu"):
        np.testing.assert_array_equal(np.load(tmp_path / f"{name}.npy"), getattr(res, name))
    again = run_lpt_emulator_pipeline(seed=1, params=params_from_jax(jax_params[True]),
                                      compute_vel=True, keep_fields=False, device="cpu", **COMMON)
    assert again.delta_lin is None and again.psi_emu is None
    other = run_lpt_emulator_pipeline(seed=1, params=params_from_jax(jax_params[False]),
                                      compute_vel=False, device="cpu", **COMMON)
    np.testing.assert_array_equal(other.delta_lin, res.delta_lin)  # deterministic in the seed


def test_delta_mode_resizes_to_n_part(jax_params):
    coarse = (np.random.default_rng(1).normal(size=(8, 8, 8)) * 0.1).astype(np.float32)
    res = run_lpt_emulator_pipeline(input_delta=coarse, seed=3,
                                    params=params_from_jax(jax_params[False]),
                                    compute_vel=False, device="cpu", **COMMON)
    assert res.delta_lin.shape == (N, N, N)
    lo = np.fft.fftn(coarse) * 8.0
    lo[0, 0, 0] = 0.0  # the mean mode is zeroed
    hi = np.fft.fftn(res.delta_lin)
    inner = np.s_[:3, :3, :3]  # modes well inside the coarse Nyquist sphere
    np.testing.assert_allclose(hi[inner], lo[inner], rtol=0, atol=1e-4 * np.abs(lo).max())


def test_chunked_plan_takes_the_host_io_branch(jax_params, monkeypatch):
    """A chunked plan stages its input from the host and returns host arrays;
    its fields equal the monolithic plan's (rtol 1e-3, atol 1e-3 std: the JAX
    package's gate for two runtimes of one box)."""
    n = 32
    delta = (np.random.default_rng(2).normal(size=(n, n, n)) * 0.1).astype(np.float32)
    kw = dict(COMMON, n_part=n, input_delta=delta, compute_vel=False, runtime="auto",
              params=params_from_jax(jax_params[False]), device="cpu")
    mono = run_lpt_emulator_pipeline(**kw)
    plan = tpipe.auto_hierarchical_config
    monkeypatch.setattr(tpipe, "auto_hierarchical_config", lambda size, **k: ChunkedHierarchicalConfig(
        size=size, chunks=(2, 1, 1), dtype=k["dtype"], output_dtype=k["output_dtype"],
        buf_dtype=plan(size, **k).buf_dtype))
    calls = []
    real = ChunkedHierarchicalProcessor.process_box

    def spy(self, input_box, *a, **k):
        calls.append((type(input_box), k.get("as_numpy")))
        return real(self, input_box, *a, **k)

    monkeypatch.setattr(ChunkedHierarchicalProcessor, "process_box", spy)
    chunked = run_lpt_emulator_pipeline(**kw)
    assert calls == [(np.ndarray, True)]
    ref = mono.psi_emu
    np.testing.assert_allclose(chunked.psi_emu, ref, rtol=1e-3, atol=1e-3 * float(ref.std()))
    np.testing.assert_array_equal(chunked.psi_lpt, mono.psi_lpt)


def test_lpt_density_tracks_linear_at_z(jax_params):
    """The LPT density's amplitude scales with D(z)."""
    kw = dict(COMMON, seed=2, boxsize=4000.0, compute_vel=False,
              params=params_from_jax(jax_params[False]), device="cpu")
    res0 = run_lpt_emulator_pipeline(**dict(kw, z=0.0))
    res1 = run_lpt_emulator_pipeline(**dict(kw, z=1.0))
    ratio = res1.delta_lpt.std() / res0.delta_lpt.std()
    d_ratio = res1.metadata["growth_factor"] / res0.metadata["growth_factor"]
    assert np.isclose(ratio, d_ratio, rtol=0.05)


def test_external_pk_table(jax_params, tmp_path):
    """A CLASS-style (k, P) file replaces EH98 end to end."""
    k = np.logspace(-4, 2, 256)
    tab = tmp_path / "pk.dat"
    np.savetxt(tab, np.c_[k, eisenstein_hu_pk(k) * 2.0], header="k [h/Mpc]  P [(Mpc/h)^3]")
    kw = dict(COMMON, seed=3, boxsize=1000.0, z=0.0, compute_vel=False,
              params=params_from_jax(jax_params[False]), device="cpu")
    res_tab = run_lpt_emulator_pipeline(pk_table=str(tab), **kw)
    res_arr = run_lpt_emulator_pipeline(pk_table=(k, eisenstein_hu_pk(k) * 2.0), **kw)
    res_eh = run_lpt_emulator_pipeline(**kw)
    assert res_tab.metadata["pk_table"] == str(tab)
    assert res_arr.metadata["pk_table"] == "external-array"
    assert res_eh.metadata["pk_table"] == "eh98"
    # 2x P(k) -> sqrt(2)x field amplitude for the same seed
    assert np.isclose(res_tab.delta_lin.std() / res_eh.delta_lin.std(), np.sqrt(2.0), rtol=0.05)
    np.testing.assert_allclose(res_arr.delta_lin, res_tab.delta_lin, rtol=1e-6, atol=1e-7)


def test_bad_runtime_rejected(jax_params):
    with pytest.raises(ValueError, match="runtime"):
        run_lpt_emulator_pipeline(seed=1, n_part=N, params=params_from_jax(jax_params[False]),
                                  load_params=False, runtime="warp", precision="f32",
                                  compute_vel=False, mid_chan=MID, device="cpu")
    with pytest.raises(ValueError, match="seed or input_delta"):
        run_lpt_emulator_pipeline(n_part=N, load_params=False, device="cpu")


def test_pipeline_defaults_to_the_card(monkeypatch):
    """Without a device and without a card it raises: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_lpt_emulator_pipeline(seed=1, n_part=N, load_params=False, mid_chan=MID)


def test_fiducial_constants():
    assert QUIJOTE_FIDUCIAL["Om"] == 0.3175 and QUIJOTE_FIDUCIAL["sigma8"] == 0.834


def test_output_dtype_maps_to_torch():
    assert tpipe._torch_dtype(np.float32) is torch.float32
    assert tpipe._torch_dtype(np.float16) is torch.float16
    assert tpipe._torch_dtype(torch.bfloat16) is torch.bfloat16


def test_force_sync_walks_trees():
    from jax_nbody_emulator_with_dj_tpu_torch.utils import force_sync

    tree = {"a": [torch.ones(2), (torch.zeros(1), None)], "b": PipelineResult(timings={"t": 1.0})}
    assert force_sync(tree) is tree


def test_stage_timer_and_trace(tmp_path):
    from jax_nbody_emulator_with_dj_tpu_torch.utils.profiling import stage_timer, trace

    timings = {}
    with trace(str(tmp_path / "prof")) as prof:
        with stage_timer(timings, "mm", sync_on=[torch.ones(1)]):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert timings["mm"] > 0
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
    with pytest.raises(KeyError):
        with stage_timer(timings, "failed"):
            raise KeyError("x")
    assert "failed" in timings
