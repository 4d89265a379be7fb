"""The port's chunked hierarchical runtime and its host staging vs the JAX package, on the CPU.

The same seeded style tree (made by the JAX package, converted with
``params_from_jax``) and the same numpy box (N = 32, ``mid_chan=4``, float32)
go through the JAX package's ``ChunkedHierarchicalProcessor`` and the port's,
and through the port's monolithic ``HierarchicalProcessor``.  Tolerance:
rtol 2e-4 / atol 2e-5, as JAX's ``tests/test_chunked.py`` holds its chunked
runtime against its monolithic one, velocities in displacement units
(divided by ``vel_norm(z, Om)``).  Resume, determinism, staging with and
without the native gather: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu import ChunkedHierarchicalConfig as JChunkedConfig
from jax_nbody_emulator_with_dj_tpu import ChunkedHierarchicalProcessor as JChunked
from jax_nbody_emulator_with_dj_tpu import NBodyEmulatorCore as JCore
from jax_nbody_emulator_with_dj_tpu import NBodyEmulatorVelCore as JVelCore
from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorVelCore as JStyleVelCore
from jax_nbody_emulator_with_dj_tpu import native as jnative
from jax_nbody_emulator_with_dj_tpu.emulator import modulate_emulator_parameters as jmod
from jax_nbody_emulator_with_dj_tpu.emulator import modulate_emulator_parameters_vel as jmod_vel
from jax_nbody_emulator_with_dj_tpu_torch import (
    ChunkedHierarchicalConfig,
    ChunkedHierarchicalProcessor,
    HierarchicalConfig,
    create_emulator,
    native,
)
from jax_nbody_emulator_with_dj_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(2)  # tier-1 runs several xdist workers

MID = 4
N = 32  # global box; chunks of 16 (packed alignment) padded to 112
Z, OM = 0.5, 0.3175
VF = 51.74779427502384  # vel_norm(Z, OM)


@pytest.fixture(scope="module")
def style4():
    return JStyleVelCore(mid_chan=MID).init(jax.random.key(23))


@pytest.fixture(scope="module")
def box():
    return np.random.default_rng(23).standard_normal((3, N, N, N)).astype(np.float32)


def _pair(out, vel):
    return tuple(out) if vel else (out,)


def _close_box(got, ref, vel):
    got, ref = _pair(got, vel), _pair(ref, vel)
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=2e-4, atol=2e-5)
    if vel:
        np.testing.assert_allclose(got[1] / VF, np.asarray(ref[1]) / VF, rtol=2e-4, atol=2e-5)


def _emulator(style4, cfg, vel, style=False):
    return create_emulator(premodulate=not style, compute_vel=vel, params=params_from_jax(style4),
                           premodulate_z=Z, premodulate_Om=OM, processor_config=cfg,
                           mid_chan=MID, device="cpu")


def _chunked_cfg(chunks, **kw):
    return ChunkedHierarchicalConfig(size=(N,) * 3, chunks=chunks, dtype=torch.float32,
                                     output_dtype=torch.float32, **kw)


def _jax_chunked(style4, box, chunks, vel, style=False):
    cfg = JChunkedConfig(size=(N,) * 3, chunks=chunks, dtype=jnp.float32,
                         output_dtype=np.float32)
    if style:
        model, params = JStyleVelCore(mid_chan=MID), style4
    else:
        model = (JVelCore if vel else JCore)(mid_chan=MID)
        params = (jmod_vel if vel else jmod)(style4, Z, OM)
    return JChunked(model, params, cfg).process_box(box, Z, OM)


@pytest.fixture(scope="module")
def mono(style4, box):
    """The port's monolithic runs: disp, vel, style vel."""
    cfg = HierarchicalConfig(size=(N,) * 3, slab=8, tile=(16, 16, 16), dtype=torch.float32,
                             output_dtype=torch.float32)
    return {key: _emulator(style4, cfg, vel, style).process_box(box, Z, OM)
            for key, vel, style in (("disp", False, False), ("vel", True, False),
                                    ("style_vel", True, True))}


# ---------------------------------------------------------------------------
# (a) The config against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(size=(32,) * 3, chunks=(2, 1, 1)),
    dict(size=(32,) * 3, chunks=(1, 2, 2), pad=56),
    dict(size=(64, 32, 96), chunks=(2, 1, 3), slab=16),
    dict(size=(48,) * 3, chunks=(1, 1, 3), packed=False, tile=(16, 48, 8)),
    dict(size=(128,) * 3, chunks=(2, 2, 1), tile1=16, slab_h=32),
])
def test_config_and_inner_config_match_jax(kw):
    port, ref = ChunkedHierarchicalConfig(**kw), JChunkedConfig(**kw)
    for name in ("chunks", "pad", "chunk_size", "pads", "inner_size", "packed"):
        assert getattr(port, name) == getattr(ref, name), name
    pi, ri = port.inner_config(), ref.inner_config()
    for f in dataclasses.fields(pi):
        if f.name not in ("dtype", "output_dtype", "buf_dtype"):
            assert getattr(pi, f.name) == getattr(ri, f.name), f.name


@pytest.mark.parametrize("kw", [
    dict(size=(64,) * 3, chunks=(2, 1, 1), pad=32),  # pad below the receptive margin
    dict(size=(64,) * 3, chunks=(2, 1, 1), pad=52),  # pad not a multiple of 8
    dict(size=(24,) * 3, chunks=(3, 1, 1)),  # chunk extent 8: not packed-aligned
    dict(size=(32,) * 3, chunks=(3, 1, 1)),  # chunks do not divide the size
    dict(size=(32,) * 3, chunks=(0, 1, 1)),
    dict(size=(40,) * 3, chunks=(1, 1, 5), packed=False),  # 8 ok unpacked, but not a divisor
])
def test_config_errors_match_jax(kw):
    def raises(cls):
        try:
            cls(**kw)
        except ValueError:
            return True
        return False

    assert raises(ChunkedHierarchicalConfig) == raises(JChunkedConfig)
    if kw.get("chunks") != (1, 1, 5):
        assert raises(ChunkedHierarchicalConfig)


def test_unsplit_axes_not_padded():
    cfg = ChunkedHierarchicalConfig(size=(32,) * 3, chunks=(2, 1, 1))
    assert cfg.pads == (48, 0, 0) and cfg.inner_size == (112, 32, 32)


# ---------------------------------------------------------------------------
# (b) Chunked against JAX's chunked runtime and the port's monolithic one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("key,chunks", [
    ("disp", (2, 1, 1)),
    ("disp", (2, 2, 1)),
    ("vel", (2, 1, 1)),
    ("style_vel", (1, 2, 1)),
])
def test_chunked_matches_jax_and_monolithic(style4, box, mono, key, chunks):
    vel, style = key != "disp", key == "style_vel"
    proc = _emulator(style4, _chunked_cfg(chunks), vel, style).processor
    assert isinstance(proc, ChunkedHierarchicalProcessor)
    out = proc.process_box(box, Z, OM)
    for o in _pair(out, vel):
        assert o.shape == (3, N, N, N) and o.dtype == np.float32
    _close_box(out, _jax_chunked(style4, box, chunks, vel, style), vel)
    _close_box(out, mono[key], vel)


@pytest.fixture(scope="module")
def proc_disp(style4):
    return _emulator(style4, _chunked_cfg((2, 1, 1)), False).processor


@pytest.fixture(scope="module")
def chunked_disp(proc_disp, box):
    return proc_disp.process_box(box, Z, OM)


@pytest.mark.parametrize("as_numpy", [True, False])
def test_device_input_on_the_cpu_device(proc_disp, box, chunked_disp, as_numpy):
    """A torch tensor on the processor's device is cut on the device, and
    with ``as_numpy=False`` the crops land in device tensors; the global
    input survives the donated chunk runs."""
    dev = torch.from_numpy(box.copy())
    out = proc_disp.process_box(dev, Z, OM, as_numpy=as_numpy)
    assert torch.is_tensor(out) != as_numpy
    got = out.numpy() if torch.is_tensor(out) else out
    np.testing.assert_array_equal(got, chunked_disp)
    np.testing.assert_array_equal(dev.numpy(), box)


def test_vel_device_output(style4, box, mono):
    proc = _emulator(style4, _chunked_cfg((2, 1, 1)), True).processor
    disp, vel = proc.process_box(torch.from_numpy(box), Z, OM, as_numpy=False)
    assert torch.is_tensor(disp) and torch.is_tensor(vel)
    _close_box((disp.numpy(), vel.numpy()), mono["vel"], True)


def test_deterministic_and_input_unchanged(proc_disp, box, chunked_disp):
    before = box.copy()
    np.testing.assert_array_equal(proc_disp.process_box(box, Z, OM), chunked_disp)
    np.testing.assert_array_equal(box, before)


@pytest.mark.parametrize("as_numpy", [True, False])
def test_no_inner_output_outlives_its_crop(style4, box, as_numpy):
    """When an inner run starts, no earlier inner run's output and no earlier
    chunk cut from a device box is referenced: only one chunk's tensors are
    ever alive.  (A host box's chunk is a staging buffer itself on the CPU
    device, reused by design; on a card it is uploaded into a new tensor.)"""
    import weakref

    proc = _emulator(style4, _chunked_cfg((2, 2, 1)), True).processor
    real, earlier = proc.inner.process_box, []

    def tracking(chunk, *a, **k):
        assert all(ref() is None for ref in earlier), "an earlier chunk's tensor is alive"
        if not as_numpy:
            earlier.append(weakref.ref(chunk))
        outs = real(chunk, *a, **k)
        earlier.extend(weakref.ref(t) for t in outs)
        return outs

    proc.inner.process_box = tracking
    proc.process_box(box if as_numpy else torch.from_numpy(box), Z, OM, as_numpy=as_numpy)
    assert len(earlier) == 4 * (2 if as_numpy else 3)


def test_profile_timings_cover_all_phases(proc_disp, box):
    proc_disp.process_box(box, Z, OM, profile=True)
    want = {"scale", "phase1", "phase2a", "phase2b", "phase2c", "phase3", "stage",
            "crop_to_host"}
    assert want <= set(proc_disp.last_timings)
    assert all(v >= 0 for v in proc_disp.last_timings.values())
    assert proc_disp.last_peaks == {}  # peaks are measured on a CUDA device only


def test_shape_validation(proc_disp):
    with pytest.raises(ValueError, match="box shape"):
        proc_disp.process_box(np.zeros((3, 16, 16, 16), np.float32), Z, OM)


# ---------------------------------------------------------------------------
# (c) Resume
# ---------------------------------------------------------------------------


def _counting(proc):
    calls = []
    inner_run = proc.inner.process_box
    proc.inner.process_box = lambda *a, **k: calls.append(1) or inner_run(*a, **k)
    return calls


def test_full_run_then_resume_skips_all(style4, box, chunked_disp, tmp_path):
    proc = _emulator(style4, _chunked_cfg((2, 1, 1)), False).processor
    first = proc.process_box(box, Z, OM, resume_dir=tmp_path)
    np.testing.assert_array_equal(first, chunked_disp)
    assert sorted(f.name for f in tmp_path.iterdir()) == [
        "chunk_0_0_0_0.npy", "chunk_16_0_0_0.npy", "manifest.json"]
    calls = _counting(proc)
    np.testing.assert_array_equal(proc.process_box(box, Z, OM, resume_dir=tmp_path), chunked_disp)
    assert calls == []  # every chunk loaded from disk


def test_partial_resume_computes_only_missing(style4, box, mono, tmp_path):
    proc = _emulator(style4, _chunked_cfg((2, 1, 1)), True).processor
    ref = proc.process_box(box, Z, OM, resume_dir=tmp_path)
    sorted(tmp_path.glob("chunk_*_1.npy"))[0].unlink()  # one chunk's velocity file
    calls = _counting(proc)
    resumed = proc.process_box(box, Z, OM, resume_dir=tmp_path)
    assert len(calls) == 1
    for a, b in zip(resumed, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("change", ["cosmology", "input"])
def test_resume_refuses_another_run(proc_disp, box, tmp_path, change):
    proc_disp.process_box(box, Z, OM, resume_dir=tmp_path)
    other = box.copy()
    other[0, 0, 0, 0] += 1.0
    args = (box, Z + 0.1, OM) if change == "cosmology" else (other, Z, OM)
    with pytest.raises(ValueError, match="different run"):
        proc_disp.process_box(*args, resume_dir=tmp_path)
    np.testing.assert_array_equal(proc_disp.process_box(box, Z, OM, resume_dir=tmp_path),
                                  proc_disp.process_box(box, Z, OM))


def test_resume_requires_host_assembly(proc_disp, box, tmp_path):
    with pytest.raises(ValueError, match="resume_dir"):
        proc_disp.process_box(torch.from_numpy(box), Z, OM, as_numpy=False, resume_dir=tmp_path)


# ---------------------------------------------------------------------------
# (d) Host staging: the port's native gather
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
@pytest.mark.parametrize("shape,start,out", [
    ((3, 16, 16, 16), (10, 15, 3), (12, 9, 20)),  # every axis wraps
    ((3, 16, 16, 16), (0, 0, 0), (16, 16, 16)),  # identity
    ((2, 8, 12, 10), (5, 11, 9), (40, 30, 35)),  # extents beyond the torus
    ((1, 32, 8, 24), (-3, 20, 47), (7, 9, 11)),  # negative and large starts
])
def test_periodic_gather_matches_numpy_and_jax(shape, start, out, dtype):
    assert native.native_staging_available()
    src = np.random.default_rng(7).standard_normal(shape).astype(dtype)
    idx = [(np.arange(s, s + m) % n) for s, m, n in zip(start, out, shape[1:])]
    ref = src[:, idx[0][:, None, None], idx[1][None, :, None], idx[2][None, None, :]]
    got = native.periodic_gather(src, start, out)
    assert got.dtype == src.dtype
    np.testing.assert_array_equal(got, ref)
    dst = np.empty(ref.shape, ref.dtype)
    assert native.periodic_gather(src, start, out, out=dst) is dst
    np.testing.assert_array_equal(dst, ref)
    if jnative.native_staging_available():
        np.testing.assert_array_equal(got, jnative.periodic_gather(src, start, out))


def test_periodic_gather_rejects_bad_arguments():
    src = np.zeros((3, 8, 8, 8), np.float32)
    with pytest.raises(ValueError):
        native.periodic_gather(src[:, ::2], (0, 0, 0), (4, 4, 4))
    with pytest.raises(ValueError):
        native.periodic_gather(src, (0, 0, 0), (4, 4, 4), out=np.empty((3, 4, 4, 4), np.float16))


def test_staging_builds_into_the_package(tmp_path):
    """The helper's library lands in the package's git-ignored ``_build/``."""
    from pathlib import Path

    build = Path(native.__file__).resolve().parent.parent / "_build"
    assert native.native_staging_available()
    assert list(build.glob("staging_*.so"))


def test_chunked_identical_without_native(style4, box, chunked_disp, monkeypatch):
    monkeypatch.setattr(native, "periodic_gather", lambda *a, **k: None)
    proc = _emulator(style4, _chunked_cfg((2, 1, 1)), False).processor
    np.testing.assert_array_equal(proc.process_box(box, Z, OM), chunked_disp)
    # a non-contiguous host box takes the numpy path as well
    np.testing.assert_array_equal(proc.process_box(np.asfortranarray(box), Z, OM), chunked_disp)
