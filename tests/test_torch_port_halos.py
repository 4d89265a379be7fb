"""The port's FoF halo finder, its native engine and the mass functions
against the JAX package's, on the CPU.

Both packages' finders are host numpy (and C++ for the native engine), so
labels, lengths and centers must be array-equal with each engine; the slab
finder and ``positions_from_displacement`` take the port's torch tensors.
Tinker's HMF reads ``sigma_r``, float32 in the JAX package and float64 in
the port: rtol 1e-5.  The cases are the JAX package's own halo tests, at
their sizes.
"""

import hashlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu import native as jnative
from jax_nbody_emulator_with_dj_tpu.science import halos as jhalos
from jax_nbody_emulator_with_dj_tpu.science.grf import gaussian_random_field as jgrf
from jax_nbody_emulator_with_dj_tpu.science.linear_pk import eisenstein_hu_pk as jeh
from jax_nbody_emulator_with_dj_tpu.science.lpt import zeldovich_displacement as jzel
from jax_nbody_emulator_with_dj_tpu_torch import native as tnative
from jax_nbody_emulator_with_dj_tpu_torch import science as tsci
from jax_nbody_emulator_with_dj_tpu_torch.science import halos as thalos
from jax_nbody_emulator_with_dj_tpu_torch.science.linear_pk import eisenstein_hu_pk


def _assert_same(got, ref):
    assert set(got) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]), err_msg=key)


# (name, positions, boxsize, linking length, nmin): the JAX package's FoF cases
def _two_clusters():
    rng = np.random.default_rng(0)
    c1 = rng.normal(scale=0.5, size=(50, 3)) + 20.0
    c2 = rng.normal(scale=0.5, size=(80, 3)) + 70.0
    field = rng.uniform(0, 100, size=(30, 3))
    return np.concatenate([c1, c2, field]) % 100.0, 100.0, 1.0, 20


def _across_boundary():
    offs = np.random.default_rng(1).normal(scale=0.4, size=(40, 3))
    return np.mod(offs + np.array([0.0, 50.0, 50.0]), 100.0), 100.0, 1.5, 10


def _nmin_filtering():
    rng = np.random.default_rng(2)
    small = rng.normal(scale=0.2, size=(5, 3)) + 10.0
    big = rng.normal(scale=0.2, size=(30, 3)) + 60.0
    return np.concatenate([small, big]) % 100.0, 100.0, 1.0, 20


def _random_points():
    return np.random.default_rng(0).uniform(0, 50.0, size=(4000, 3)), 50.0, 1.2, 2


def _clustered_points():
    rng = np.random.default_rng(1)
    centers = rng.uniform(0, 100.0, size=(40, 3))
    pts = (centers[:, None, :] + rng.normal(0, 0.8, size=(40, 60, 3))).reshape(-1, 3)
    return np.mod(pts, 100.0), 100.0, 0.9, 2


def _boundary_wrap_clusters():
    rng = np.random.default_rng(2)
    base = np.array([[0.0, 25.0, 25.0], [25.0, 0.0, 25.0], [25.0, 25.0, 0.0]])
    pts = (base[:, None, :] + rng.normal(0, 0.5, size=(3, 200, 3))).reshape(-1, 3)
    return np.mod(pts, 50.0), 50.0, 0.6, 2


def _grid_displaced_64():
    n = 64
    psi = np.asarray(2.0 * jax.random.normal(jax.random.key(5), (3, n, n, n), jnp.float32))
    return jhalos.positions_from_displacement(psi, 100.0), 100.0, 0.2 * 100.0 / n, 2


def _chain_across_cells():
    box = 100.0
    b = box / 256 * (1 + 1e-7)
    xs = np.arange(0, box - b, b * (1 - 1e-6), dtype=np.float64)
    pos = np.zeros((len(xs), 3))
    pos[:, 0] = xs
    pos[:, 1:] = 50.0
    return pos, box, b, 2


def _out_of_range():
    pos = np.random.default_rng(12).uniform(0, 30.0, size=(200, 3)).astype(np.float32)
    pos[0] = [-1e-6, 5.0, 5.0]
    pos[1] = [30.0, 5.0, 5.0]
    return pos, 30.0, 1.0, 1


CASES = {f.__name__[1:]: f for f in (
    _two_clusters, _across_boundary, _nmin_filtering, _random_points, _clustered_points,
    _boundary_wrap_clusters, _grid_displaced_64, _chain_across_cells, _out_of_range)}


@pytest.mark.parametrize("engine", ["numpy", "native"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_friends_of_friends_matches_jax(case, engine):
    pos, box, b, nmin = CASES[case]()
    pos = np.asarray(pos, np.float32)
    got = thalos.friends_of_friends(pos, box, b, nmin=nmin, engine=engine)
    ref = jhalos.friends_of_friends(pos, box, b, nmin=nmin, engine=engine)
    _assert_same(got, ref)
    assert got["labels"].dtype == np.int32 and got["n_groups"] >= 1


def test_two_clusters_found():
    pos, box, b, nmin = _two_clusters()
    out = tsci.friends_of_friends(pos, box, b, nmin=nmin)
    assert sorted(out["lengths"].tolist()) == [50, 80]
    centers = out["centers"][np.argsort(out["lengths"])]
    np.testing.assert_allclose(centers, [[20, 20, 20], [70, 70, 70]], atol=1.0)


def test_tiny_chunk_matches_default_and_jax():
    rng = np.random.default_rng(11)
    core = rng.normal(scale=0.3, size=(60, 3)) + 25.0
    pos = (np.concatenate([core, rng.uniform(0, 50.0, size=(300, 3))]) % 50.0).astype(np.float32)
    got = thalos.friends_of_friends(pos, 50.0, 1.0, nmin=2, engine="numpy", chunk=64)
    _assert_same(got, thalos.friends_of_friends(pos, 50.0, 1.0, nmin=2, engine="numpy"))
    _assert_same(got, jhalos.friends_of_friends(pos, 50.0, 1.0, nmin=2, engine="numpy",
                                                chunk=64))


def test_bad_engine_rejected():
    with pytest.raises(ValueError, match="engine"):
        thalos.friends_of_friends(np.zeros((4, 3), np.float32), 1.0, 0.1, engine="gpu")


# ---------------------------------------------------------------------------
# native engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_threads", [1, 2, 4, 7])
def test_native_fof_labels_match_jax_at_any_thread_count(n_threads):
    assert tnative.native_fof_available()
    rng = np.random.default_rng(11)
    box = 40.0
    pos = np.concatenate([
        rng.uniform(0, box, size=(5000, 3)),
        rng.normal(25.0, 0.3, size=(1500, 3)),
        rng.normal(0.0, 0.3, size=(800, 3)) % box,
    ]).astype(np.float32)
    np.clip(pos, 0, np.nextafter(box, 0, dtype=np.float32), out=pos)
    for b in (0.5, 1.2):
        got = tnative.fof_labels(pos, box, b, n_threads=n_threads)
        np.testing.assert_array_equal(got, jnative.fof_labels(pos, box, b, n_threads=1))


def test_native_threads_from_environment(monkeypatch):
    pos = np.random.default_rng(3).uniform(0, 20, (3000, 3)).astype(np.float32)
    ref = tnative.fof_labels(pos, 20.0, 0.7, n_threads=1)
    monkeypatch.setenv(tnative.FOF_THREADS_ENV, "3")
    np.testing.assert_array_equal(tnative.fof_labels(pos, 20.0, 0.7), ref)
    monkeypatch.setenv(tnative.FOF_THREADS_ENV, "three")
    with pytest.raises(ValueError):
        tnative.fof_labels(pos, 20.0, 0.7)


def test_native_rejects_bad_positions():
    with pytest.raises(ValueError, match="Np, 3"):
        tnative.fof_labels(np.zeros((4, 2), np.float32), 1.0, 0.1)


def test_native_damaged_library_is_rebuilt(tmp_path, monkeypatch):
    """A damaged cached .so (a torn concurrent write) is rebuilt at the next
    load, not left to disable the native engine."""
    monkeypatch.setattr(tnative, "_build_dir", lambda: tmp_path)
    monkeypatch.setattr(tnative, "_CACHE", {})
    tag = hashlib.sha256(Path(tnative.__file__).with_name("fof.cpp").read_bytes()).hexdigest()[:16]
    so = tmp_path / f"fof_{tag}.so"
    so.write_bytes(b"not an ELF file")
    assert tnative.native_fof_available()
    pos = np.random.default_rng(0).uniform(0, 10, (50, 3)).astype(np.float32)
    assert tnative.fof_labels(pos, 10.0, 0.5) is not None
    assert so.read_bytes()[:4] == b"\x7fELF"


def test_auto_engine_falls_back_to_numpy(monkeypatch):
    """Without the native library, 'auto' runs the numpy engine and 'native' raises."""
    monkeypatch.setattr(thalos, "native_fof", lambda *a, **k: None)
    pos, box, b, nmin = _clustered_points()
    pos = pos.astype(np.float32)
    _assert_same(thalos.friends_of_friends(pos, box, b, nmin=nmin),
                 jhalos.friends_of_friends(pos, box, b, nmin=nmin, engine="numpy"))
    with pytest.raises(RuntimeError, match="native"):
        thalos.friends_of_friends(pos, box, b, engine="native")


# ---------------------------------------------------------------------------
# positions and the slab finder
# ---------------------------------------------------------------------------


def _psi_grf(n, boxsize, seed=3):
    k = np.logspace(-3, 1.5, 128)
    p = jeh(k, Om=0.3175, Ob=0.049, h=0.6711, ns=0.9624, sigma8=0.834)
    return np.array(jzel(jgrf(jax.random.key(seed), n, boxsize, k, p), boxsize))


@pytest.mark.parametrize("as_tensor", [False, True])
def test_positions_from_displacement_matches_jax(as_tensor):
    psi = _psi_grf(16, 40.0)
    psi[:, 0, 0, 0] = -10.0  # wraps below 0
    got = thalos.positions_from_displacement(torch.from_numpy(psi) if as_tensor else psi, 40.0)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == (16**3, 3)
    np.testing.assert_array_equal(got, jhalos.positions_from_displacement(psi, 40.0))
    assert got.min() >= 0 and got.max() < 40.0


@pytest.mark.parametrize("engine", ["numpy", "native"])
@pytest.mark.parametrize("n_slabs", [1, 2, 3, 5])
def test_friends_of_friends_slabbed_matches_jax(n_slabs, engine):
    n, box = 24, 60.0
    psi = _psi_grf(n, box)
    b = 0.2 * box / n
    got = thalos.friends_of_friends_slabbed(torch.from_numpy(psi), box, b, nmin=5,
                                            n_slabs=n_slabs, return_labels=True, engine=engine)
    ref = jhalos.friends_of_friends_slabbed(psi, box, b, nmin=5, n_slabs=n_slabs,
                                            return_labels=True, engine=engine)
    _assert_same(got, ref)


def test_slabbed_matches_monolithic_and_small_chunks():
    n, box = 16, 40.0
    psi = _psi_grf(n, box, seed=7)
    b = 0.2 * box / n
    mono = thalos.friends_of_friends(thalos.positions_from_displacement(psi, box), box, b, nmin=3)
    slab = thalos.friends_of_friends_slabbed(psi, box, b, nmin=3, n_slabs=2, chunk=300,
                                             return_labels=True)
    assert slab["n_groups"] == mono["n_groups"]
    np.testing.assert_array_equal(np.sort(slab["lengths"]), np.sort(mono["lengths"]))
    no_labels = thalos.friends_of_friends_slabbed(psi, box, b, nmin=3, n_slabs=2)
    assert "labels" not in no_labels
    np.testing.assert_array_equal(no_labels["lengths"], slab["lengths"])


def test_group_spanning_every_boundary():
    n, box = 12, 36.0
    psi = torch.zeros((3, n, n, n))
    got = thalos.friends_of_friends_slabbed(psi, box, 1.2 * box / n, nmin=n**3, n_slabs=4)
    assert got["n_groups"] == 1 and got["lengths"][0] == n**3


def test_slabbed_rejects_too_many_slabs():
    psi = np.zeros((3, 8, 8, 8), np.float32)
    with pytest.raises(ValueError, match="slab width"):
        thalos.friends_of_friends_slabbed(psi, 8.0, 2.0, n_slabs=4)
    with pytest.raises(ValueError, match="n_slabs"):
        thalos.friends_of_friends_slabbed(psi, 8.0, 0.5, n_slabs=0)


# ---------------------------------------------------------------------------
# mass functions
# ---------------------------------------------------------------------------


def test_particle_mass_matches_jax():
    for args in ((1000.0, 512, 0.3175), (250.0, 64, 0.3)):
        assert thalos.particle_mass_msun_h(*args) == jhalos.particle_mass_msun_h(*args)


@pytest.mark.parametrize("fof_correction", [False, True])
def test_empirical_hmf_matches_jax(fof_correction):
    lengths = np.array([1, 1, 5, 20, 25, 40, 80, 160, 320, 2000])
    got = thalos.empirical_hmf(lengths, 1e12, 100.0, bins_per_dex=4,
                               fof_correction=fof_correction)
    ref = jhalos.empirical_hmf(lengths, 1e12, 100.0, bins_per_dex=4,
                               fof_correction=fof_correction)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(ValueError, match="corrected mass"):
        thalos.empirical_hmf(np.array([1, 1, 1]), 1e12, 100.0)


@pytest.mark.parametrize("z,growth", [(0.0, None), (1.0, None), (0.5, 0.8)])
def test_tinker08_hmf_matches_jax(z, growth):
    k = np.logspace(-4, 2, 256)
    p = eisenstein_hu_pk(k)
    m = np.logspace(12, 15, 16)
    got = thalos.tinker08_hmf(m, k, p, Om=0.3175, z=z, growth=growth)
    ref = jhalos.tinker08_hmf(m, jnp.asarray(k, jnp.float32), jnp.asarray(p, jnp.float32),
                              Om=0.3175, z=z, growth=growth)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert np.all(got > 0) and np.all(np.diff(np.log(got)) < 0)
