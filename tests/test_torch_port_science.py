"""The port's science toolkit against the JAX package's, on the CPU.

Each test makes its inputs with numpy from a seed (or takes the JAX
package's own white noise, converted to numpy, where the JAX function draws
random numbers: JAX's PRNG cannot be matched bit for bit, so the port's
random functions are held through their deterministic noise cores) and runs
them through the JAX function and its port with ``device="cpu"``.

Tolerances: FFT fields (GRF core, LPT, deconvolution, smoothing, resize) rel
max 1e-5; the deposit max abs 1e-5 on rho/rho_bar for all four MAS orders;
P(k), cross P(k), T and C rtol 1e-5 where a shell has at least one mode;
Minkowski cell counts equal; bispectrum rtol 1e-4 (with an absolute floor of
1e-4 of the largest |B|: at an opening angle where the triangle sum cancels
to 1e-3 of the others, float32 sums of the JAX package already differ from
float64 by 6e-4, see ``test_bispectrum_matches_jax``); EH98, sigma8 and
Tinker rtol 1e-5 (the JAX package computes them in float32, the port in
float64); halofit rtol 1e-10 (host float64 on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu.science import bispectrum as jbis
from jax_nbody_emulator_with_dj_tpu.science import grf as jgrf
from jax_nbody_emulator_with_dj_tpu.science import halofit as jhalofit
from jax_nbody_emulator_with_dj_tpu.science import linear_pk as jlin
from jax_nbody_emulator_with_dj_tpu.science import lpt as jlpt
from jax_nbody_emulator_with_dj_tpu.science import mas as jmas
from jax_nbody_emulator_with_dj_tpu.science import minkowski as jmink
from jax_nbody_emulator_with_dj_tpu.science import powerspec as jps
from jax_nbody_emulator_with_dj_tpu.science import resize as jres
from jax_nbody_emulator_with_dj_tpu_torch import cosmology as tcosmo
from jax_nbody_emulator_with_dj_tpu_torch import science as tsci
from jax_nbody_emulator_with_dj_tpu_torch.science import bispectrum as tbis
from jax_nbody_emulator_with_dj_tpu_torch.science import grf as tgrf
from jax_nbody_emulator_with_dj_tpu_torch.science import halofit as thalofit
from jax_nbody_emulator_with_dj_tpu_torch.science import linear_pk as tlin
from jax_nbody_emulator_with_dj_tpu_torch.science import mas as tmas
from jax_nbody_emulator_with_dj_tpu_torch.science import minkowski as tmink
from jax_nbody_emulator_with_dj_tpu_torch.science import resize as tres

RTOL_TABLE = 1e-5
RTOL_FFT = 1e-5
ATOL_DEPOSIT = 1e-5
L = 250.0
K_TAB = np.logspace(-3, 1.5, 256)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.array(x)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rel_max(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def pk_tab():
    """(k, P) from the port's EH98 (float64), the table both sides read."""
    return K_TAB, tlin.eisenstein_hu_pk(K_TAB)


@pytest.fixture(scope="module")
def fields(pk_tab):
    """Seeded linear fields at N = 16, 24 (not a power of 2) and 32, made by
    the JAX package's GRF; the same numpy array goes to both sides."""
    k, p = pk_tab
    return {n: np.array(jgrf.gaussian_random_field(jax.random.key(n), n, L, k, p))
            for n in (16, 24, 32)}


@pytest.fixture(scope="module")
def psis(fields):
    """Zel'dovich displacements of ``fields`` from the JAX package (rms 0.6-0.8
    cells: particles cross cells and the box edge)."""
    return {n: np.array(jlpt.zeldovich_displacement(d, L)) for n, d in fields.items()}


# ---------------------------------------------------------------------------
# linear_pk
# ---------------------------------------------------------------------------


def test_eh98_transfer_matches_jax():
    k = np.logspace(-4, 2, 300).astype(np.float32)
    for cosmo in ((0.3175, 0.049, 0.6711), (0.25, 0.04, 0.7)):
        np.testing.assert_allclose(tlin.eh98_transfer(k, *cosmo),
                                   np.asarray(jlin.eh98_transfer(jnp.asarray(k), *cosmo)),
                                   rtol=RTOL_TABLE)


@pytest.mark.parametrize("cosmo", [{}, dict(Om=0.28, Ob=0.045, h=0.7, ns=0.95, sigma8=0.8)])
def test_eisenstein_hu_pk_matches_jax(cosmo):
    k = np.logspace(-4, 2, 512).astype(np.float32)
    got = tlin.eisenstein_hu_pk(k, **cosmo)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(jlin.eisenstein_hu_pk(jnp.asarray(k), **cosmo)),
                               rtol=RTOL_TABLE)


@pytest.mark.parametrize("r", [2.0, 8.0, 32.0])
def test_sigma_r_and_normalize_sigma8_match_jax(pk_tab, r):
    k, p = pk_tab
    kj, pj = jnp.asarray(k, jnp.float32), jnp.asarray(p, jnp.float32)
    assert np.isclose(tlin.sigma_r(k, p, r), jlin.sigma_r(kj, pj, r), rtol=RTOL_TABLE)
    np.testing.assert_allclose(tlin.normalize_sigma8(k, p, 1.1),
                               np.asarray(jlin.normalize_sigma8(kj, pj, 1.1)), rtol=RTOL_TABLE)
    assert np.isclose(tlin.sigma_r(k, tlin.normalize_sigma8(k, p, 1.1), 8.0), 1.1, rtol=1e-12)


def test_sigma_r_takes_tensors(pk_tab):
    k, p = pk_tab
    assert tlin.sigma_r(torch.from_numpy(k), torch.from_numpy(p)) == tlin.sigma_r(k, p)


def test_pk_table_matches_jax():
    k, p = tlin.pk_table(500.0, 64, sigma8=0.9)
    kj, pj = jlin.pk_table(500.0, 64, sigma8=0.9)
    np.testing.assert_allclose(k, np.asarray(kj), rtol=RTOL_TABLE)
    np.testing.assert_allclose(p, np.asarray(pj), rtol=RTOL_TABLE)


@pytest.mark.parametrize("fmt", ["dat", "csv", "npy_rows", "npy_cols", "npz_keys", "npz_first"])
def test_load_pk_table_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(0)
    k = np.sort(rng.uniform(1e-3, 10.0, 40))
    p = rng.uniform(0.0, 1e4, 40)
    shuffled = rng.permutation(40)
    path = tmp_path / {"dat": "pk.dat", "csv": "pk.csv"}.get(fmt, f"pk.{fmt[:3]}")
    if fmt == "dat":
        np.savetxt(path, np.c_[k, p][shuffled], header="k P")
    elif fmt == "csv":
        np.savetxt(path, np.c_[k, p, p][shuffled], delimiter=",")
    elif fmt == "npy_rows":
        np.save(path, np.stack([k, p]))
    elif fmt == "npy_cols":
        np.save(path, np.c_[k, p])
    elif fmt == "npz_keys":
        np.savez(path, k=k, pk=p)
    else:
        np.savez(path, np.stack([k, p]))
    got, ref = tlin.load_pk_table(path), jlin.load_pk_table(path)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_allclose(got[0], k)


def test_load_pk_table_rejects_bad_tables(tmp_path):
    np.save(tmp_path / "neg.npy", np.stack([[1.0, 2.0], [1.0, -1.0]]))
    np.save(tmp_path / "flat.npy", np.ones(5))
    for name in ("neg.npy", "flat.npy"):
        with pytest.raises(ValueError):
            tlin.load_pk_table(tmp_path / name)


# ---------------------------------------------------------------------------
# grf
# ---------------------------------------------------------------------------


def test_interp_is_jnp_interp():
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(-2, 3, 50)).astype(np.float32)
    fp = rng.normal(size=50).astype(np.float32)
    x = np.concatenate([rng.uniform(-4, 5, 500), xp, [xp[0], xp[-1], -10, 10]]).astype(np.float32)
    # float32 on both sides; XLA fuses the lerp, which moves the last bit
    np.testing.assert_allclose(tgrf._interp(_t(x), _t(xp), _t(fp)).numpy(),
                               np.asarray(jnp.interp(x, xp, fp)), rtol=1e-6, atol=1e-7)


def test_interp_pk_matches_jax(pk_tab):
    k, p = pk_tab
    kmag = np.concatenate([[0.0], np.logspace(-4, 2, 300)]).astype(np.float32)
    got = tgrf._interp_pk(_t(kmag), k, p).numpy()
    ref = np.asarray(jgrf._interp_pk(jnp.asarray(kmag), jnp.asarray(k, jnp.float32),
                                     jnp.asarray(p, jnp.float32)))
    assert got[0] == 0.0
    np.testing.assert_allclose(got, ref, rtol=RTOL_FFT)


@pytest.mark.parametrize("n", [16, 24, 33])
@pytest.mark.parametrize("fixed_amplitude", [False, True])
def test_grf_core_matches_jax(pk_tab, n, fixed_amplitude):
    """The port's colouring of JAX's own white noise equals JAX's GRF."""
    k, p = pk_tab
    key = jax.random.key(100 + n)
    noise = np.array(jgrf.white_noise_field(key, n))
    ref = jgrf.gaussian_random_field(key, n, L, k, p, fixed_amplitude=fixed_amplitude)
    got = tgrf._colour_noise(_t(noise), L, k, p, fixed_amplitude)
    assert got.dtype == torch.float32
    assert _rel_max(got, ref) < RTOL_FFT


@pytest.fixture(scope="module")
def port_grf(pk_tab):
    k, p = pk_tab
    return tsci.gaussian_random_field(torch.Generator().manual_seed(7), 64, 256.0, k, p,
                                      device="cpu")


def test_grf_recovers_input_pk(port_grf, pk_tab):
    k_t, p_t = pk_tab
    k, pk, counts = (x.numpy() for x in tsci.power_spectrum(port_grf, 256.0))
    sel = (counts > 200) & (k < 0.7 * np.pi * 64 / 256.0)
    ratio = pk[sel] / np.interp(k, k_t, p_t)[sel]
    assert np.abs(np.mean(ratio) - 1.0) < 0.1
    assert np.all(np.abs(ratio - 1.0) < 0.5)


def test_grf_zero_mean(port_grf):
    assert abs(float(port_grf.mean())) < 1e-4 * float(port_grf.std())


def test_grf_deterministic_in_seed(pk_tab):
    k, p = pk_tab

    def draw(seed):
        return tsci.gaussian_random_field(torch.Generator().manual_seed(seed), 32, L, k, p,
                                          device="cpu")

    np.testing.assert_array_equal(draw(3).numpy(), draw(3).numpy())
    assert not np.array_equal(draw(3).numpy(), draw(4).numpy())
    _, _, c = tsci.transfer_and_correlation(draw(1), draw(2), L)
    assert np.abs(c.numpy()).mean() < 0.2


def test_white_noise_field():
    w = tsci.white_noise_field(torch.Generator().manual_seed(0), 24, device="cpu")
    assert w.shape == (24, 24, 24) and w.dtype == torch.float32 and w.device.type == "cpu"
    assert abs(float(w.mean())) < 0.05 and abs(float(w.std()) - 1.0) < 0.05


def test_field_makers_default_to_the_card(monkeypatch, pk_tab):
    """Without a device and without a card they raise: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsci.white_noise_field(gen, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsci.gaussian_random_field(gen, 8, L, *pk_tab)


# ---------------------------------------------------------------------------
# mas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("worder", [1, 2, 3, 4])
def test_deposit_matches_jax(worder):
    rng = np.random.default_rng(worder)
    nmesh = 12
    pos = rng.uniform(0, nmesh, (5000, 3)).astype(np.float32)
    # points on grid lines and just below the periodic edge
    pos[:20] = np.floor(pos[:20])
    pos[20:40, 0] = np.nextafter(np.float32(nmesh), np.float32(0))
    got = tsci.deposit(_t(pos), nmesh, worder)
    ref = np.asarray(jmas.deposit(pos, nmesh, worder))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL_DEPOSIT)
    assert np.isclose(float(got.sum()), nmesh**3, rtol=1e-5)


@pytest.mark.parametrize("n,nmesh,worder", [(16, None, 1), (16, None, 2), (16, None, 3),
                                             (16, None, 4), (24, 20, 2), (24, 20, 4)])
def test_deposit_displacement_matches_jax(psis, n, nmesh, worder):
    got = tmas.deposit_displacement(_t(psis[n]), L, nmesh=nmesh, worder=worder)
    ref = np.asarray(jmas.deposit_displacement(jnp.asarray(psis[n]), L, nmesh=nmesh,
                                               worder=worder))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL_DEPOSIT)


def _cic_float64(psi, boxsize):
    """CIC rho/rho_bar of the port's float32 particle positions, summed in float64."""
    n = psi.shape[1]
    scale = np.float32(1.0) / np.float32(boxsize / n)
    q = np.arange(n, dtype=np.float32) * np.float32(boxsize / n)
    shapes = ((-1, 1, 1), (1, -1, 1), (1, 1, -1))
    pos = [np.mod((q.reshape(sh) + psi[d]).reshape(-1) * scale, np.float32(n))
           for d, sh in enumerate(shapes)]
    base = [np.floor(x).astype(np.int64) for x in pos]
    frac = [(x - np.floor(x)).astype(np.float64) for x in pos]
    mesh = np.zeros(n**3)
    for off in np.ndindex(2, 2, 2):
        w = np.prod([f if o else 1 - f for o, f in zip(off, frac)], axis=0)
        idx = ((base[0] + off[0]) % n * n + (base[1] + off[1]) % n) * n + (base[2] + off[2]) % n
        np.add.at(mesh, idx, w)
    return mesh.reshape(n, n, n)


def test_deposit_of_large_displacements_against_float64(psis):
    """Three times the displacements (cells of up to 12 particles): the port's
    float32 deposit stays within the deposit gate of a float64 sum.  (The JAX
    package's float32 scatter order is 1.8e-5 off it here.)"""
    psi = 3.0 * psis[32]
    got = tmas.deposit_displacement(_t(psi), L, worder=2).numpy()
    np.testing.assert_allclose(got, _cic_float64(psi, L), rtol=0, atol=ATOL_DEPOSIT)


def test_deposit_wraps_positions_that_round_to_the_edge():
    """A float32 position -1e-9 cells wraps to exactly nmesh under the float mod;
    the integer wrap of the base index must put it back in cell 0."""
    nmesh = 8
    psi = np.zeros((3, nmesh, nmesh, nmesh), np.float32)
    psi[0, 0, 0, 0] = -1e-9
    got = tmas.deposit_displacement(_t(psi), float(nmesh), worder=2)
    ref = np.asarray(jmas.deposit_displacement(jnp.asarray(psi), float(nmesh), worder=2))
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL_DEPOSIT)
    np.testing.assert_allclose(got.numpy(), 1.0, atol=1e-6)


def test_deposit_rejects_bad_order():
    with pytest.raises(ValueError, match="worder"):
        tsci.deposit(torch.zeros((4, 3)), 4, 5)


@pytest.mark.parametrize("worder", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [16, 24])
def test_mas_window_and_deconvolution_match_jax(fields, worder, n):
    np.testing.assert_allclose(tmas.mas_window(n, worder).numpy(),
                               np.asarray(jmas.mas_window(n, worder)), rtol=1e-6, atol=1e-7)
    d = fields[n]
    assert _rel_max(tsci.deconvolve_mas(_t(d), worder), jmas.deconvolve_mas(d, worder)) < RTOL_FFT


# ---------------------------------------------------------------------------
# lpt
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16, 24, 32])
def test_zeldovich_displacement_matches_jax(fields, n):
    got = tsci.zeldovich_displacement(_t(fields[n]), L)
    assert got.shape == (3, n, n, n) and got.dtype == torch.float32
    assert _rel_max(got, jlpt.zeldovich_displacement(fields[n], L)) < RTOL_FFT


def test_zeldovich_nyquist_numerator_is_zeroed():
    """A pure Nyquist-plane mode has no odd derivative: psi is zero."""
    n = 8
    x = np.arange(n)
    delta = np.broadcast_to(np.cos(np.pi * x)[:, None, None], (n, n, n)).astype(np.float32)
    psi = tsci.zeldovich_displacement(_t(delta), 100.0).numpy()
    np.testing.assert_allclose(psi, np.asarray(jlpt.zeldovich_displacement(delta, 100.0)),
                               atol=1e-6)
    assert np.abs(psi).max() < 1e-6


@pytest.mark.parametrize("worder,deconvolve", [(1, True), (2, True), (3, True), (4, True),
                                               (2, False)])
def test_displacement_to_density_matches_jax(psis, worder, deconvolve):
    got = tsci.displacement_to_density(_t(psis[32]), L, worder=worder, deconvolve=deconvolve)
    ref = np.asarray(jlpt.displacement_to_density(jnp.asarray(psis[32]), L, worder=worder,
                                                  deconvolve=deconvolve))
    if deconvolve:
        assert _rel_max(got, ref) < RTOL_FFT
    else:
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ATOL_DEPOSIT)


def test_displacement_to_density_other_mesh(psis):
    got = tsci.displacement_to_density(_t(psis[24]), L, nmesh=16, worder=3)
    ref = jlpt.displacement_to_density(jnp.asarray(psis[24]), L, nmesh=16, worder=3)
    assert got.shape == (16, 16, 16)
    assert _rel_max(got, ref) < RTOL_FFT


# ---------------------------------------------------------------------------
# powerspec
# ---------------------------------------------------------------------------


def _assert_binned(got, ref, counts, floor=0.0):
    """rtol 1e-5 over the shells with a mode; ``floor`` x max|ref| as an absolute
    term for signed quantities (a cross spectrum that crosses zero in a shell
    has no relative precision there)."""
    sel = np.asarray(counts) >= 1
    for g, r in zip(got, ref):
        r = np.asarray(r)[sel]
        np.testing.assert_allclose(_np(g)[sel], r, rtol=1e-5, atol=floor * np.abs(r).max())


@pytest.mark.parametrize("n", [16, 24, 32])
@pytest.mark.parametrize("nbins", [None, 7])
def test_power_spectrum_matches_jax(fields, n, nbins):
    ref = jps.power_spectrum(fields[n], L, nbins)
    got = tsci.power_spectrum(_t(fields[n]), L, nbins)
    assert all(g.dtype == torch.float32 for g in got)
    _assert_binned(got, ref, ref[2])


@pytest.mark.parametrize("n", [16, 32])
def test_cross_power_and_transfer_match_jax(fields, psis, n):
    a = fields[n]
    b = np.array(jlpt.displacement_to_density(jnp.asarray(psis[n]), L))
    ref = jps.cross_power(a, b, L)
    _assert_binned(tsci.cross_power(_t(a), _t(b), L), ref, ref[2], floor=1e-7)
    _assert_binned(tsci.transfer_and_correlation(_t(b), _t(a), L),
                   jps.transfer_and_correlation(b, a, L), ref[2], floor=1e-7)


@pytest.mark.parametrize("kmax", [None, 0.2])
def test_summary_metrics_matches_jax(fields, psis, kmax):
    a = fields[32]
    b = np.array(jlpt.displacement_to_density(jnp.asarray(psis[32]), L))
    got = tsci.summary_metrics(_t(b), _t(a), L, kmax=kmax)
    ref = jps.summary_metrics(b, a, L, kmax=kmax)
    assert set(got) == set(ref)
    for key in ref:
        assert np.isclose(got[key], ref[key], rtol=1e-5, atol=1e-7), key


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_in,n_out", [(8, 16), (9, 18), (16, 32)])
def test_upsample_modes_core_matches_jax(pk_tab, n_in, n_out):
    k, p = pk_tab
    d = np.array(jgrf.gaussian_random_field(jax.random.key(n_in), n_in, L, k, p))
    key = jax.random.key(500 + n_in)
    noise = np.array(jgrf.white_noise_field(key, n_out))
    ref = jres.upsample_modes(d, n_out, L, k, p, key=key)
    got = tres._upsample_modes_from_noise(_t(d), _t(noise), n_out, L, k, p)
    assert _rel_max(got, ref) < RTOL_FFT


def test_upsample_modes_keeps_low_modes(pk_tab):
    k, p = pk_tab
    d = tsci.gaussian_random_field(torch.Generator().manual_seed(1), 16, L, k, p, device="cpu")
    up = tsci.upsample_modes(d, 32, L, k, p)
    np.testing.assert_array_equal(up.numpy(), tsci.upsample_modes(d, 32, L, k, p).numpy())
    lo = np.fft.fftn(d.numpy()) * 8.0
    hi = np.fft.fftn(up.numpy())
    inner = np.s_[:5, :5, :5]  # |k| <= 4 sqrt(3) < the coarse Nyquist 8
    np.testing.assert_allclose(hi[inner], lo[inner], rtol=0, atol=1e-4 * np.abs(lo).max())
    with pytest.raises(ValueError, match="multiple"):
        tsci.upsample_modes(d, 24, L, k, p)


@pytest.mark.parametrize("n_in,n_out", [(8, 16), (9, 18), (8, 8)])
def test_upsample_fourier_and_linear_match_jax(fields, pk_tab, n_in, n_out):
    k, p = pk_tab
    d = np.array(jgrf.gaussian_random_field(jax.random.key(n_in), n_in, L, k, p))
    assert _rel_max(tsci.upsample_fourier(_t(d), n_out), jres.upsample_fourier(d, n_out)) < RTOL_FFT
    assert _rel_max(tsci.upsample_linear(_t(d), n_out), jres.upsample_linear(d, n_out)) < 1e-6


@pytest.mark.parametrize("r_smooth", [None, 4.0])
def test_downsample_and_smooth_match_jax(fields, r_smooth):
    d = fields[32]
    assert _rel_max(tsci.downsample_average(_t(d), 16), jres.downsample_average(d, 16)) < 1e-6
    assert _rel_max(tsci.gaussian_smooth(_t(d), L, 6.0), jres.gaussian_smooth(d, L, 6.0)) < RTOL_FFT
    assert _rel_max(tsci.resize_density_grid(_t(d), 8, L, r_smooth=r_smooth),
                    jres.resize_density_grid(d, 8, L, r_smooth=r_smooth)) < RTOL_FFT


def test_resize_density_grid_paths(fields, pk_tab):
    d = _t(fields[16])
    assert tsci.resize_density_grid(d, 16, L) is d
    with pytest.raises(ValueError, match="target"):
        tsci.resize_density_grid(d, 32, L)
    up = tsci.resize_density_grid(d, 32, L, *pk_tab, generator=torch.Generator().manual_seed(2))
    assert up.shape == (32, 32, 32) and torch.isfinite(up).all()


# ---------------------------------------------------------------------------
# minkowski
# ---------------------------------------------------------------------------


def test_minkowski_counts_equal_jax(fields):
    d = fields[32]
    for t in (-0.5, 0.0, 0.4, 10.0):
        got = [int(c) for c in tmink._complex_counts(_t(d) > t)]
        ref = [int(c) for c in jmink._complex_counts(jnp.asarray(d) > t)]
        assert got == ref, t
    th = np.array([-0.5, 0.0, 0.4, 10.0], np.float32)
    got = tsci.minkowski_functionals(_t(d), th)
    assert got.shape == (4, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jmink.minkowski_functionals(d, th)),
                               rtol=1e-6, atol=1e-7)


def test_minkowski_single_cube_euler():
    d = np.zeros((8, 8, 8), np.float32)
    d[3, 3, 3] = 1.0
    v = tsci.minkowski_functionals(_t(d), [0.5]).numpy()[0]
    assert np.isclose(v[3] * 8**3, 1.0)
    assert v.dtype == np.float32


# ---------------------------------------------------------------------------
# bispectrum
# ---------------------------------------------------------------------------


def _bispectrum_f64(delta, boxsize, k1, k2, thetas):
    """The same estimator in float64 numpy."""
    n = delta.shape[0]
    kf = 2 * np.pi / boxsize
    dk = np.fft.rfftn(delta.astype(np.float64))
    fx, fz = np.fft.fftfreq(n, 1 / n) * kf, np.fft.rfftfreq(n, 1 / n) * kf
    km = np.sqrt(fx[:, None, None] ** 2 + fx[None, :, None] ** 2 + fz[None, None, :] ** 2)

    def band(kc):
        m = ((km >= kc - kf) & (km < kc + kf)).astype(np.float64)
        return (np.fft.irfftn(dk * m, s=(n,) * 3, axes=(0, 1, 2)),
                np.fft.irfftn(m, s=(n,) * 3, axes=(0, 1, 2)))

    (i1, n1), (i2, n2) = band(k1), band(k2)
    out = []
    for k3 in np.sqrt(k1**2 + k2**2 + 2 * k1 * k2 * np.cos(thetas)):
        i3, n3 = band(k3)
        out.append(boxsize**6 / n**3 * np.sum(i1 * i2 * i3) / np.sum(n1 * n2 * n3))
    return np.array(out)


@pytest.mark.parametrize("k1,k2", [(0.1, 0.15), (0.08, 0.08)])
def test_bispectrum_matches_jax(fields, k1, k2):
    d = fields[32]
    th = np.linspace(0.2, 3.0, 4)
    got = tbis.reduced_bispectrum(_t(d), L, k1, k2, th)
    ref = jbis.reduced_bispectrum(d, L, k1, k2, th)
    assert set(got) == set(ref)
    for key in ("theta", "k3"):
        np.testing.assert_array_equal(got[key], ref[key])
    for key in ("B", "Q", "P1", "P2", "P3"):
        r = np.asarray(ref[key], np.float64)
        np.testing.assert_allclose(got[key], r, rtol=1e-4, atol=1e-4 * np.abs(r).max())
    np.testing.assert_allclose(got["B"], _bispectrum_f64(d, L, k1, k2, th), rtol=1e-4)


# ---------------------------------------------------------------------------
# halofit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("z", [0.0, 0.5, 1.0])
def test_halofit_matches_jax(monkeypatch, z):
    """Host float64 on both sides.  The JAX package evaluates its growth
    factor in float32 (x64 off); the reference module is given the port's
    float64 ``growth_factor`` (held against the JAX one by the cosmology
    tests), so that the halofit formulas themselves are compared."""
    monkeypatch.setattr(jhalofit, "growth_factor", tcosmo.growth_factor)
    k = np.logspace(-3, 1, 300)
    pl = tlin.eisenstein_hu_pk(k)
    for om in (0.3175, 0.25):
        np.testing.assert_allclose(thalofit.halofit_pk(k, pl, om, z),
                                   jhalofit.halofit_pk(k, pl, om, z), rtol=1e-10)


def test_halofit_at_z0_needs_no_growth_patch():
    k = np.logspace(-3, 1, 200)
    pl = tlin.eisenstein_hu_pk(k)
    np.testing.assert_allclose(tsci.halofit_pk(k, pl, 0.3175), jhalofit.halofit_pk(k, pl, 0.3175),
                               rtol=1e-10)
