"""The port's sharded science toolkit against the JAX package's, on the CPU.

Each ``*_sharded`` function runs on ``[torch.device("cpu")] * 8`` meshes
((2, 2, 2) and (4, 2, 1)) and is held against the JAX package's sharded
function on the 8 virtual CPU devices of ``tests/conftest.py`` (same numpy
inputs; the random ones through JAX's own noise: ``white=``) at the JAX
tests' tolerances (``tests/test_field_sharded.py``,
``test_sharded_powerspec.py``, ``test_resize_sharded.py``,
``test_stats_sharded.py``), and against the port's single-device function,
which it matches much more closely: the port's shell sums are float64 on
both paths, its Minkowski counts int64 and exact.  Each tolerance is stated
where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu.parallel import make_mesh as jmake_mesh
from jax_nbody_emulator_with_dj_tpu.science import field_sharded as jfs
from jax_nbody_emulator_with_dj_tpu.science import powerspec_sharded as jps
from jax_nbody_emulator_with_dj_tpu.science import resize_sharded as jrs
from jax_nbody_emulator_with_dj_tpu.science import stats_sharded as jss
from jax_nbody_emulator_with_dj_tpu.science.halos import (
    friends_of_friends_sharded as jfof_sharded,
)
from jax_nbody_emulator_with_dj_tpu_torch import science as sci
from jax_nbody_emulator_with_dj_tpu_torch.parallel import ShardedField, make_mesh
from jax_nbody_emulator_with_dj_tpu_torch.science import field_sharded, grf, mas, resize
from jax_nbody_emulator_with_dj_tpu_torch.science.halos import friends_of_friends_sharded

torch.set_num_threads(2)  # tier-1 runs several xdist workers

CPU = torch.device("cpu")
BOX = 100.0
N = 32
MESHES = [(2, 2, 2), (4, 2, 1)]

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 (virtual) devices")


def cpu_mesh(shape):
    return make_mesh(shape, devices=[CPU] * int(np.prod(shape)))


def host(x):
    """numpy of a ShardedField, a tensor or a JAX array."""
    if isinstance(x, ShardedField):
        return x.numpy()
    if torch.is_tensor(x):
        return x.cpu().numpy()
    return np.asarray(x)


def assert_sharded(field, shape, mesh):
    assert isinstance(field, ShardedField) and field.shape == shape
    assert field.mesh is mesh and len(field.parts) == mesh.size


@pytest.fixture(scope="module")
def pk_table():
    k = np.logspace(-3, 1.5, 256)
    return k, sci.eisenstein_hu_pk(k, Om=0.3175, Ob=0.049, h=0.6711, ns=0.9624, sigma8=0.834)


@pytest.fixture(scope="module")
def white():
    return np.asarray(jax.random.normal(jax.random.key(7), (N, N, N), jnp.float32))


@pytest.fixture(scope="module")
def delta(white, pk_table):
    return grf._colour_noise(torch.from_numpy(white), BOX, *pk_table).numpy()


@pytest.fixture(scope="module")
def psi(delta):
    return sci.zeldovich_displacement(torch.from_numpy(delta), BOX).numpy()


@pytest.fixture(scope="module")
def fields():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(N, N, N)).astype(np.float32)
    b = (0.7 * a + 0.3 * rng.normal(size=a.shape)).astype(np.float32)
    return a, b


# ---------------------------------------------------------------------------
# power spectra
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_power_spectrum_sharded(fields, mesh_shape):
    a, _ = fields
    mesh = cpu_mesh(mesh_shape)
    k, p, n = (host(v) for v in sci.power_spectrum_sharded(a, mesh, BOX))
    jk, jp, jn = (host(v) for v in jps.power_spectrum_sharded(a, jmake_mesh(mesh_shape), BOX))
    # against JAX: its tests' gates (its shell sums are float32)
    np.testing.assert_array_equal(n, jn)
    np.testing.assert_allclose(k, jk, rtol=1e-4)
    np.testing.assert_allclose(p, jp, rtol=2e-4)
    # against the port on one device: float64 sums on both, rounded once
    rk, rp, rn = (host(v) for v in sci.power_spectrum(torch.from_numpy(a), BOX))
    np.testing.assert_array_equal(n, rn)
    np.testing.assert_allclose(k, rk, rtol=1e-6)
    np.testing.assert_allclose(p, rp, rtol=1e-6)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_cross_and_transfer_sharded(fields, mesh_shape):
    a, b = fields
    mesh, jmesh = cpu_mesh(mesh_shape), jmake_mesh(mesh_shape)
    px = host(sci.cross_power_sharded(a, b, mesh, BOX)[1])
    np.testing.assert_allclose(px, host(jps.cross_power_sharded(a, b, jmesh, BOX)[1]),
                               rtol=2e-4, atol=1e-8)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_allclose(px, host(sci.cross_power(ta, tb, BOX)[1]), rtol=1e-6, atol=1e-10)
    _, t, c = (host(v) for v in sci.transfer_and_correlation_sharded(a, b, mesh, BOX))
    _, jt, jc = (host(v) for v in jps.transfer_and_correlation_sharded(a, b, jmesh, BOX))
    np.testing.assert_allclose(t, jt, rtol=2e-4)
    np.testing.assert_allclose(c, jc, rtol=2e-4, atol=1e-6)
    _, rt, rc = (host(v) for v in sci.transfer_and_correlation(ta, tb, BOX))
    np.testing.assert_allclose(t, rt, rtol=1e-6)
    np.testing.assert_allclose(c, rc, rtol=1e-6, atol=1e-8)


def test_summary_metrics_sharded(fields):
    a, b = fields
    got = sci.summary_metrics_sharded(a, b, cpu_mesh((4, 2, 1)), BOX, kmax=0.5)
    want = jps.summary_metrics_sharded(a, b, jmake_mesh((4, 2, 1)), BOX, kmax=0.5)
    ref = sci.summary_metrics(torch.from_numpy(a), torch.from_numpy(b), BOX, kmax=0.5)
    assert set(got) == set(want) == set(ref)
    for key in ref:
        # JAX's moments are float32 reductions: rtol 1e-4; the port's are per-shard
        # float64 sums against the single-device host float64
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=1e-9, err_msg=key)


def test_spectrum_geometry_validation():
    with pytest.raises(ValueError, match="sharded FFT"):
        sci.power_spectrum_sharded(np.zeros((12, 12, 12), np.float32), cpu_mesh((8, 1, 1)), BOX)


# ---------------------------------------------------------------------------
# GRF, 1LPT, deposit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fixed", [False, True])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_grf_sharded_colours_given_noise(white, pk_table, mesh_shape, fixed):
    mesh = cpu_mesh(mesh_shape)
    got = sci.gaussian_random_field_sharded(None, N, mesh, BOX, *pk_table, white=white,
                                            fixed_amplitude=fixed)
    assert_sharded(got, (N, N, N), mesh)
    got = got.numpy()
    want = host(jfs.gaussian_random_field_sharded(None, N, jmake_mesh(mesh_shape), BOX,
                                                  *pk_table, white=white,
                                                  fixed_amplitude=fixed))
    scale = want.std()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4 * scale)  # the JAX test's gate
    ref = grf._colour_noise(torch.from_numpy(white), BOX, *pk_table, fixed_amplitude=fixed)
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=2e-6 * scale)


def test_grf_sharded_draw(pk_table):
    """Each shard draws its own stream (from the generator's seed and its
    linear index): deterministic, distinct between shards, and of the input
    spectrum (the JAX test's gate, single realization)."""
    mesh = cpu_mesh((2, 2, 2))
    gen = torch.Generator().manual_seed(3)
    d = sci.gaussian_random_field_sharded(gen, 64, mesh, BOX, *pk_table)
    again = sci.gaussian_random_field_sharded(torch.Generator().manual_seed(3), 64, mesh, BOX,
                                              *pk_table)
    np.testing.assert_array_equal(d.numpy(), again.numpy())
    other = sci.gaussian_random_field_sharded(torch.Generator().manual_seed(4), 64, mesh, BOX,
                                              *pk_table)
    assert not np.allclose(d.numpy(), other.numpy())
    kk, pk, nm = (host(v) for v in sci.power_spectrum_sharded(d, mesh, BOX))
    sel = (nm > 500) & (kk > 0)
    ratio = pk[sel] / np.interp(kk[sel], *pk_table)
    assert np.all(np.abs(ratio - 1) < 0.35), ratio
    halves = sci.gaussian_random_field_sharded(gen, N, cpu_mesh((2, 1, 1)), BOX, *pk_table)
    assert not np.allclose(halves.parts[0].numpy(), halves.parts[1].numpy())
    gens = field_sharded.shard_generators(gen, mesh)
    assert len({g.initial_seed() for g in gens}) == 8


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_zeldovich_sharded(delta, mesh_shape):
    mesh = cpu_mesh(mesh_shape)
    got = sci.zeldovich_displacement_sharded(delta, mesh, BOX)
    assert_sharded(got, (3, N, N, N), mesh)
    got = got.numpy()
    want = host(jfs.zeldovich_displacement_sharded(delta, jmake_mesh(mesh_shape), BOX))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=5e-4 * scale)
    ref = sci.zeldovich_displacement(torch.from_numpy(delta), BOX).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * scale)


@pytest.mark.parametrize("worder", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", MESHES)
def test_deposit_sharded(psi, mesh_shape, worder):
    psi = 0.5 * psi  # within the 8-cell margin on (4, 2, 1) for every order
    mesh = cpu_mesh(mesh_shape)
    got = sci.deposit_displacement_sharded(psi, mesh, BOX, worder=worder, margin=8)
    assert_sharded(got, (N, N, N), mesh)
    got = got.numpy()
    want = host(jfs.deposit_displacement_sharded(psi, jmake_mesh(mesh_shape), BOX,
                                                 worder=worder, margin=8))
    # JAX's sharded deposit forms positions as q + psi N/L, the port (on both paths)
    # as the single-device deposit does, (q L/N + psi) N/L: an ulp of a position apart
    # (the JAX test's gate, rtol 1e-4, atol 2e-4; measured ~2e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
    # the single-device deposit's positions and weights: only the order of the float32
    # additions differs (a few ulps of values up to ~20)
    ref = mas.deposit_displacement(torch.from_numpy(psi), BOX, worder=worder).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got.mean(dtype=np.float64), 1.0, rtol=1e-6)


@pytest.mark.parametrize("case", ["uniform_shift", "corner_blob"])
def test_deposit_mass_crossing_a_shard_corner(case):
    """Mass deposited across a shard's corner reaches the diagonal neighbour
    by two hops of the halo reduce."""
    psi = np.zeros((3, N, N, N), np.float32)
    cell = BOX / N
    h = N // 2
    if case == "uniform_shift":
        psi += 0.6 * cell  # every particle's CIC stencil straddles 8 cells
    else:  # particles just below the central corner of the (2, 2, 2) mesh jump across it
        psi[:, h - 3:h, h - 3:h, h - 3:h] = 2.7 * cell
    mesh = cpu_mesh((2, 2, 2))
    got = sci.deposit_displacement_sharded(psi, mesh, BOX, worder=2, margin=5).numpy()
    want = host(jfs.deposit_displacement_sharded(psi, jmake_mesh((2, 2, 2)), BOX, worder=2,
                                                 margin=5))
    ref = mas.deposit_displacement(torch.from_numpy(psi), BOX, worder=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got.sum(dtype=np.float64), N**3, rtol=1e-6)
    if case == "corner_blob":
        assert got[h:h + 2, h:h + 2, h:h + 2].sum() > 10.0  # mass in the (1, 1, 1) shard


def test_deposit_margin_errors(psi):
    mesh = cpu_mesh((2, 2, 2))
    with pytest.raises(ValueError, match="margin 1 cells < axis"):
        sci.deposit_displacement_sharded(psi, mesh, BOX, margin=1)
    with pytest.raises(ValueError, match="local extent 16 < margin 17"):
        sci.deposit_displacement_sharded(psi, mesh, BOX, margin=17)
    big_x = psi.copy()
    big_x[0] += 50.0  # x is sharded: rejected
    with pytest.raises(ValueError, match="axis-0"):
        sci.deposit_displacement_sharded(big_x, cpu_mesh((4, 2, 1)), BOX, margin=8)
    with pytest.raises(ValueError, match="worder"):
        sci.deposit_displacement_sharded(psi, mesh, BOX, worder=5)


def test_deposit_large_displacement_on_a_whole_axis(psi):
    big_z = psi.copy()
    big_z[2] += 30.0  # z is whole on every shard of (4, 2, 1): it wraps, no margin needed
    got = sci.deposit_displacement_sharded(big_z, cpu_mesh((4, 2, 1)), BOX, worder=2, margin=8)
    want = host(jfs.deposit_displacement_sharded(big_z, jmake_mesh((4, 2, 1)), BOX, worder=2,
                                                 margin=8))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-4)
    ref = mas.deposit_displacement(torch.from_numpy(big_z), BOX, worder=2).numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_density_and_deconvolution_sharded(psi, fields, mesh_shape):
    mesh, jmesh = cpu_mesh(mesh_shape), jmake_mesh(mesh_shape)
    got = sci.displacement_to_density_sharded(psi, mesh, BOX, margin=8)
    assert_sharded(got, (N, N, N), mesh)
    got = got.numpy()
    want = host(jfs.displacement_to_density_sharded(psi, jmesh, BOX, margin=8))
    scale = want.std()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=5e-4 * scale)
    ref = sci.displacement_to_density(torch.from_numpy(psi), BOX).numpy()
    # the same deposit up to summation order, then the same deconvolution (measured 7e-6 x std)
    np.testing.assert_allclose(got, ref, rtol=0, atol=5e-5 * scale)
    a, _ = fields
    dec = sci.deconvolve_mas_sharded(a, mesh, 2).numpy()
    np.testing.assert_allclose(dec, host(jfs.deconvolve_mas_sharded(a, jmesh, 2)), rtol=2e-3,
                               atol=5e-4 * a.std())
    np.testing.assert_allclose(dec, sci.deconvolve_mas(torch.from_numpy(a), 2).numpy(), rtol=0,
                               atol=2e-6 * np.abs(dec).max())


def test_sharded_chain_without_gather(white, pk_table):
    """GRF -> Zel'dovich -> density -> P(k), every stage a ShardedField on the
    mesh; equal to the single-device chain on the same noise (the JAX test's
    gate, rtol 5e-3; measured here much tighter)."""
    mesh = cpu_mesh((2, 2, 2))
    d = sci.gaussian_random_field_sharded(None, N, mesh, BOX, *pk_table, white=white)
    p = sci.zeldovich_displacement_sharded(d, mesh, BOX)
    rho = sci.displacement_to_density_sharded(p, mesh, BOX, margin=8)
    for f in (d, p, rho):
        assert isinstance(f, ShardedField) and f.mesh is mesh
    _, pk_s, _ = sci.power_spectrum_sharded(rho, mesh, BOX)
    d1 = grf._colour_noise(torch.from_numpy(white), BOX, *pk_table)
    rho1 = sci.displacement_to_density(sci.zeldovich_displacement(d1, BOX), BOX)
    _, pk_1, _ = sci.power_spectrum(rho1, BOX)
    np.testing.assert_allclose(host(pk_s), host(pk_1), rtol=5e-3)


# ---------------------------------------------------------------------------
# resizing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_in,n_out,mesh_shape", [(16, 32, (2, 2, 2)), (16, 32, (4, 2, 1)),
                                                   (9, 36, (2, 2, 2))])
def test_upsample_modes_sharded(pk_table, n_in, n_out, mesh_shape):
    coarse = np.asarray(jax.random.normal(jax.random.key(n_in), (n_in,) * 3, jnp.float32))
    noise = np.asarray(jax.random.normal(jax.random.key(0), (n_out,) * 3, jnp.float32))
    mesh = cpu_mesh(mesh_shape)
    got = sci.upsample_modes_sharded(coarse, n_out, mesh, 200.0, *pk_table, white=noise)
    assert_sharded(got, (n_out,) * 3, mesh)
    got = got.numpy()
    want = host(jrs.upsample_modes_sharded(coarse, n_out, jmake_mesh(mesh_shape), 200.0,
                                           *pk_table, white=noise))
    scale = want.std()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=5e-4 * scale)
    ref = resize._upsample_modes_from_noise(torch.from_numpy(coarse), torch.from_numpy(noise),
                                            n_out, 200.0, *pk_table).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * np.abs(ref).max())


def test_upsample_modes_sharded_draws_and_checks(pk_table):
    coarse = np.random.default_rng(1).normal(size=(16,) * 3).astype(np.float32)
    mesh = cpu_mesh((2, 2, 2))
    got = sci.upsample_modes_sharded(coarse, 32, mesh, 200.0, *pk_table,
                                     generator=torch.Generator().manual_seed(5))
    assert np.isfinite(got.numpy()).all()
    default = sci.upsample_modes_sharded(coarse, 32, mesh, 200.0, *pk_table)
    seeded0 = sci.upsample_modes_sharded(coarse, 32, mesh, 200.0, *pk_table,
                                         generator=torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(default.numpy(), seeded0.numpy())
    with pytest.raises(ValueError, match="strict multiple"):
        sci.upsample_modes_sharded(coarse, 16, mesh, 200.0, *pk_table)
    with pytest.raises(ValueError, match="p_table"):
        sci.upsample_modes_sharded(coarse, 32, mesh, 200.0, pk_table[0])


@pytest.mark.parametrize("n_in,n_out", [(16, 32), (9, 36), (32, 32)])
def test_upsample_fourier_sharded(n_in, n_out):
    coarse = np.asarray(jax.random.normal(jax.random.key(8), (n_in,) * 3, jnp.float32))
    mesh = cpu_mesh((2, 2, 2))
    got = sci.upsample_fourier_sharded(coarse, n_out, mesh).numpy()
    want = host(jrs.upsample_fourier_sharded(coarse, n_out, jmake_mesh((2, 2, 2))))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4 * scale)
    ref = sci.upsample_fourier(torch.from_numpy(coarse), n_out).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * scale)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_downsample_and_smooth_sharded(mesh_shape):
    f = np.asarray(jax.random.normal(jax.random.key(4), (32,) * 3, jnp.float32))
    mesh, jmesh = cpu_mesh(mesh_shape), jmake_mesh(mesh_shape)
    down = sci.downsample_average_sharded(f, 16, mesh)
    assert_sharded(down, (16,) * 3, mesh)
    np.testing.assert_allclose(down.numpy(), host(jrs.downsample_average_sharded(f, 16, jmesh)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(down.numpy(),
                                  sci.downsample_average(torch.from_numpy(f), 16).numpy())
    sm = sci.gaussian_smooth_sharded(f, mesh, 200.0, 5.0).numpy()
    np.testing.assert_allclose(sm, host(jrs.gaussian_smooth_sharded(f, jmesh, 200.0, 5.0)),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sm, sci.gaussian_smooth(torch.from_numpy(f), 200.0, 5.0).numpy(),
                               rtol=0, atol=2e-6 * np.abs(sm).max())
    with pytest.raises(ValueError, match="block factor"):
        sci.downsample_average_sharded(f, 4, cpu_mesh((8, 1, 1)))  # 4 rows a shard, factor 8


# ---------------------------------------------------------------------------
# Minkowski functionals and the bispectrum
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smooth_field():
    x = np.asarray(jax.random.normal(jax.random.key(11), (N, N, N), jnp.float32))
    return sci.gaussian_smooth(torch.from_numpy(x), N, 1.0).numpy()


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_minkowski_sharded(smooth_field, mesh_shape):
    thr = np.linspace(-2, 2, 9) * smooth_field.std()
    got = host(sci.minkowski_functionals_sharded(smooth_field, thr, cpu_mesh(mesh_shape)))
    want = host(jss.minkowski_functionals_sharded(smooth_field, thr, jmake_mesh(mesh_shape)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)  # the JAX test's gate
    # exact int64 counts, then the single-device float32 relations: equal
    ref = host(sci.minkowski_functionals(torch.from_numpy(smooth_field), thr))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("where", ["corner", "single"])
def test_minkowski_cube_across_a_shard_corner(where):
    f = np.zeros((N, N, N), np.float32)
    h = N // 2
    if where == "corner":  # a 2^3 cube straddling all 8 shards: one component
        f[h - 1:h + 1, h - 1:h + 1, h - 1:h + 1] = 1.0
    else:
        f[3, 5, 7] = 1.0
    got = host(sci.minkowski_functionals_sharded(f, [0.5], cpu_mesh((2, 2, 2))))
    np.testing.assert_array_equal(got, host(sci.minkowski_functionals(torch.from_numpy(f), [0.5])))
    assert got[0, 3] == pytest.approx(1.0 / N**3)


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_bispectrum_sharded(smooth_field, mesh_shape):
    thetas = np.linspace(0.2, np.pi - 0.2, 5)
    kf = 2 * np.pi / 250.0
    got = sci.reduced_bispectrum_sharded(smooth_field, cpu_mesh(mesh_shape), 250.0, 4 * kf,
                                         6 * kf, thetas)
    want = jss.reduced_bispectrum_sharded(smooth_field, jmake_mesh(mesh_shape), 250.0, 4 * kf,
                                          6 * kf, thetas)
    ref = sci.reduced_bispectrum(torch.from_numpy(smooth_field), 250.0, 4 * kf, 6 * kf, thetas)
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["B"], want["B"], rtol=2e-3, atol=1e-8)
    np.testing.assert_allclose(got["Q"], want["Q"], rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(got["P1"], want["P1"], rtol=2e-3)
    np.testing.assert_allclose(got["P3"], want["P3"], rtol=2e-3)
    for key in ("B", "Q", "P3"):  # float64 global sums against the single device's float32
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-5,
                                   atol=1e-5 * np.abs(ref[key]).max(), err_msg=key)
    np.testing.assert_allclose(got["P1"], ref["P1"], rtol=1e-5)
    np.testing.assert_allclose(got["P2"], ref["P2"], rtol=1e-5)


# ---------------------------------------------------------------------------
# FoF over shard pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_shape", [(2, 2, 2), (4, 2, 1)])
def test_fof_sharded_matches_jax(tmp_path, pk_table, mesh_shape):
    n, box = 24, 60.0
    noise = torch.from_numpy(np.random.default_rng(11).normal(size=(n,) * 3).astype(np.float32))
    psi = sci.zeldovich_displacement(grf._colour_noise(noise, box, *pk_table), box).numpy()
    b = 0.2 * box / n
    field = ShardedField.shard(psi, cpu_mesh(mesh_shape), (1, 2, 3))
    pieces = []
    for i, (piece, origin) in enumerate(field.pieces()):
        if i % 3 == 1:  # some pieces arrive as .npy files, some as numpy, the rest as tensors
            path = tmp_path / f"shard_{i}.npy"
            np.save(path, piece.numpy())
            piece = str(path)
        elif i % 3 == 2:
            piece = piece.numpy()
        pieces.append((piece, origin))
    got = friends_of_friends_sharded(pieces, n, box, b, nmin=5, n_slabs=3, return_labels=True)
    host_pieces = [(p.numpy() if torch.is_tensor(p) else p, o) for p, o in pieces]
    want = jfof_sharded(host_pieces, n, box, b, nmin=5, n_slabs=3, return_labels=True)
    assert got["n_groups"] == want["n_groups"] > 0
    np.testing.assert_array_equal(np.sort(got["lengths"]), np.sort(want["lengths"]))
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["lengths"], want["lengths"])
    ref = sci.friends_of_friends_slabbed(psi, box, b, nmin=5, n_slabs=3)
    np.testing.assert_array_equal(np.sort(got["lengths"]), np.sort(ref["lengths"]))


def test_science_exports_cover_the_jax_package():
    import jax_nbody_emulator_with_dj_tpu.science as jsci

    assert set(jsci.__all__) == set(sci.__all__)
    from jax_nbody_emulator_with_dj_tpu_torch.science import halos

    assert "friends_of_friends_sharded" not in sci.__all__
    assert callable(halos.friends_of_friends_sharded)
