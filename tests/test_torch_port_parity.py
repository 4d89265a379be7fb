"""The port's public surface against the JAX package's, on the CPU.

What ``create_emulator``, ``HierarchicalConfig``, ``process_box``, the
cosmology module and the parameter utilities accept and return, held against
the JAX package in the same process: the derivative and normalization
functions of the background cosmology (the JAX functions are float32, so rtol
2e-5), the OIDHW <-> DHWIO conversion of parameter trees (transpositions: bit
for bit), the factory's handling of missing and reference-layout parameters,
and the level buffers' storage dtype (``buf_dtype``).  Inputs come from
``numpy.random.default_rng(seed)`` and go to both sides.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_nbody_emulator_with_dj_tpu as jpkg
import jax_nbody_emulator_with_dj_tpu_torch as tpkg
from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorCore as JStyleCore
from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorVelCore as JStyleVelCore
from jax_nbody_emulator_with_dj_tpu import cosmology as jcosmo
from jax_nbody_emulator_with_dj_tpu.emulator import create_emulator as jcreate
from jax_nbody_emulator_with_dj_tpu.emulator import ensure_native_layout as jensure
from jax_nbody_emulator_with_dj_tpu.emulator import modulate_emulator_parameters as jmodulate
from jax_nbody_emulator_with_dj_tpu.emulator import (
    modulate_emulator_parameters_vel as jmodulate_vel,
)
from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalConfig as JConfig
from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalProcessor as JProcessor
from jax_nbody_emulator_with_dj_tpu.utils import params as jparams
from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalConfig, create_emulator
from jax_nbody_emulator_with_dj_tpu_torch import cosmology as tcosmo
from jax_nbody_emulator_with_dj_tpu_torch.emulator import NBodyEmulator, ensure_native_layout
from jax_nbody_emulator_with_dj_tpu_torch.hierarchical import HierarchicalProcessor
from jax_nbody_emulator_with_dj_tpu_torch.utils import params as tparams
from jax_nbody_emulator_with_dj_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(2)  # tier-1 runs several xdist workers

N = 16  # tiny box: slab 8, tiles 8^3, tile1 8
Z, OM = 0.5, 0.3175


def rel_max(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def box():
    return np.random.default_rng(1).standard_normal((3, N, N, N)).astype(np.float32)


@pytest.fixture(scope="module")
def style4():
    return JStyleCore(mid_chan=4).init(jax.random.key(17))


@pytest.fixture(scope="module")
def style4_vel():
    return JStyleVelCore(mid_chan=4).init(jax.random.key(18))


# ---------------------------------------------------------------------------
# Cosmology: the derivative and normalization functions
# ---------------------------------------------------------------------------

Z_GRID = np.array([0.0, 0.1, 0.5, 1.0, 2.0, 3.0, 10.0, 127.0])[:, None]
OM_GRID = np.array([0.05, 0.1, 0.25, 0.3175, 0.5, 0.8, 0.99])[None, :]


@pytest.mark.parametrize("name", ["acc_norm", "dlogD_dz", "dlogH_dz"])
def test_cosmology_derivatives_match_jax(name):
    """Closed forms in float64 against ``jax.jvp`` through the float32 functions."""
    got = getattr(tcosmo, name)(Z_GRID, OM_GRID)
    ref = np.asarray(getattr(jcosmo, name)(Z_GRID, OM_GRID))
    assert got.shape == ref.shape == (8, 7) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=2e-5)


def test_growth_d_approx_matches_jax():
    got = tcosmo.growth_d_approx(OM_GRID, Z_GRID)  # (Om, z), the reference's argument order
    np.testing.assert_allclose(got, np.asarray(jcosmo.growth_d_approx(OM_GRID, Z_GRID)), rtol=2e-5)
    # for Om >= 0.25 the fit follows the exact growth factor's ratios to a few 1e-3
    ratio = (got[2] / got[0])[2:]
    np.testing.assert_allclose(ratio, tcosmo.growth_factor(0.5, OM_GRID[0, 2:]), rtol=5e-3)


def test_cosmology_derivative_identities():
    z, om = 0.7, 0.3
    assert np.isclose(tcosmo.dlogD_dz(z, om), -tcosmo.growth_rate(z, om) / (1 + z))
    assert np.isclose(tcosmo.dlogH_dz(z, om), -tcosmo.dlogH_dloga(z, om) / (1 + z))
    h = 1e-5  # central differences of the port's own D and H
    log_d = [np.log(tcosmo.growth_factor(zz, om)) for zz in (z - h, z + h)]
    num = (log_d[1] - log_d[0]) / (2 * h)
    assert np.isclose(tcosmo.dlogD_dz(z, om), num, rtol=1e-7)
    num = (np.log(tcosmo.hubble_rate(z + h, om)) - np.log(tcosmo.hubble_rate(z - h, om))) / (2 * h)
    assert np.isclose(tcosmo.dlogH_dz(z, om), num, rtol=1e-7)
    assert np.isclose(tcosmo.acc_norm(z, om), tcosmo.vel_norm(z, om) * tcosmo.hubble_rate(z, om)
                      * tcosmo.dlogH_dloga(z, om))


def test_cosmology_exports_cover_the_jax_package():
    assert set(jcosmo.__all__) <= set(tcosmo.__all__)
    for name in jcosmo.__all__:
        assert callable(getattr(tpkg, name)), name  # ... and from the package's root
    cosmo_root = {"growth_factor", "hubble_rate", "growth_rate", "dlogH_dloga", "vel_norm",
                  "acc_norm", "load_default_parameters"}
    assert cosmo_root <= set(jpkg.__all__) and cosmo_root <= set(tpkg.__all__)


# ---------------------------------------------------------------------------
# Parameter trees: OIDHW <-> DHWIO
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tree", ["style4", "style4_vel", "modulated_vel"])
def test_layout_conversion_matches_jax_bit_for_bit(tree, request, style4_vel):
    """A transposition of the 5-D ``weight`` / ``dweight`` leaves and nothing else."""
    jtree = (jmodulate_vel(style4_vel, Z, OM) if tree == "modulated_vel"
             else request.getfixturevalue(tree))
    jref = jparams.convert_to_reference_params(jtree)
    ref = tparams.convert_to_reference_params(params_from_jax(jtree))
    want, got = dict(_leaves(jref)), dict(_leaves(ref))
    assert got.keys() == want.keys()
    for k, v in got.items():
        assert isinstance(v, torch.Tensor)
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]), err_msg=str(k))
    kernels = [k for k, v in got.items() if v.dim() == 5]
    assert kernels and all(k[-1] in ("weight", "dweight") for k in kernels)
    if tree == "modulated_vel":
        assert any(k[-1] == "dweight" for k in kernels)
    # ... and back: the round trip is the identity, and equals the JAX function on the JAX tree
    back = dict(_leaves(tparams.convert_reference_params(ref)))
    jback = dict(_leaves(jparams.convert_reference_params(jref)))
    for k, v in dict(_leaves(jtree)).items():
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(v), err_msg=str(k))
        np.testing.assert_array_equal(back[k].numpy(), np.asarray(jback[k]), err_msg=str(k))


def test_layout_conversion_takes_numpy_leaves(style4):
    host = jax.tree.map(np.asarray, jparams.convert_to_reference_params(style4))
    got = dict(_leaves(tparams.convert_reference_params(host)))
    for k, v in _leaves(style4):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


@pytest.mark.parametrize("layout", ["dhwio", "oidhw"])
def test_ensure_native_layout(style4, layout):
    native = params_from_jax(style4)
    tree = native if layout == "dhwio" else tparams.convert_to_reference_params(native)
    out = ensure_native_layout(tree)
    if layout == "dhwio":
        assert out is tree  # already native: untouched
    jout = jensure(jax.tree.map(np.asarray, tree))
    want, got = dict(_leaves(jout)), dict(_leaves(out))
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(v.numpy(), dict(_leaves(native))[k].numpy())
    assert ensure_native_layout({"params": {}}) == {"params": {}}  # no kernel: as it came


def test_tree_cast_matches_jax(style4):
    tree = {"params": {"a": {"weight": style4["params"]["conv_c"]["conv_0"]["weight"],
                             "n": np.arange(3)}}}
    got = tparams.tree_cast(params_from_jax(tree), torch.bfloat16)
    ref = jparams.tree_cast(tree, jnp.bfloat16)
    w, n = got["params"]["a"]["weight"], got["params"]["a"]["n"]
    assert w.dtype == torch.bfloat16 and n.dtype == torch.int64  # integer leaves are left
    np.testing.assert_array_equal(w.float().numpy(),
                                  np.asarray(ref["params"]["a"]["weight"].astype(jnp.float32)))


# ---------------------------------------------------------------------------
# create_emulator and the bundle
# ---------------------------------------------------------------------------


def test_create_emulator_accepts_the_reference_keywords():
    ref = inspect.signature(jcreate).parameters
    got = inspect.signature(create_emulator).parameters
    assert set(ref) <= set(got) and "device" in got
    for name, p in ref.items():
        if p.kind is not inspect.Parameter.VAR_KEYWORD:
            assert got[name].default == p.default, name
    jfields = {f.name for f in jpkg.NBodyEmulator.__dataclass_fields__.values()}
    assert jfields <= set(NBodyEmulator.__dataclass_fields__)


@pytest.mark.parametrize("vel", [False, True])
def test_bundle_without_parameters(vel):
    """``load_params=False`` and no tree: a bundle with ``params None`` whose
    ``apply`` raises the JAX bundle's error."""
    emu = create_emulator(premodulate=True, compute_vel=vel, load_params=False, mid_chan=4,
                          device="cpu")
    jemu = jcreate(premodulate=True, compute_vel=vel, load_params=False, mid_chan=4)
    assert emu.params is None and jemu.params is None and emu.processor is None
    assert (emu.premodulate, emu.compute_vel) == (jemu.premodulate, jemu.compute_vel) == (True, vel)
    with pytest.raises(ValueError) as jerr:
        jemu.apply(jnp.zeros((3, 8, 8, 8)), Z, OM)
    with pytest.raises(ValueError) as err:
        emu.apply(torch.zeros((3, 8, 8, 8)), Z, OM)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(ValueError, match="No processor"):
        emu.process_box(np.zeros((3, N, N, N), np.float32), Z, OM)


def test_bundle_built_by_hand_applies_where_the_input_lies(style4):
    """The bundle's fields in the reference's order; without ``device`` it means the
    card (and raises where there is none), so the CPU is asked for by name."""
    made = create_emulator(premodulate=True, compute_vel=False, params=params_from_jax(style4),
                           premodulate_z=Z, premodulate_Om=OM, mid_chan=4, levels=1, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cpu"):
            NBodyEmulator(made.model, made.params, None, True, False)
    byhand = NBodyEmulator(made.model, made.params, None, True, False, device="cpu")
    assert byhand.device == torch.device("cpu") and byhand.dtype == torch.float32
    x = np.random.default_rng(4).standard_normal((1, 3, 40, 40, 40)).astype(np.float32)
    x = torch.from_numpy(x)
    assert torch.equal(byhand(x, Z, OM), made.apply(x, Z, OM))


def test_default_parameters_are_not_shipped(tmp_path, monkeypatch):
    """Like the JAX package, the port names the path and the variable."""
    missing = tmp_path / "nowhere.npz"
    monkeypatch.setenv("JAX_NBODY_EMULATOR_PARAMS", str(missing))
    assert tpkg.default_parameters_path() == missing == jpkg.emulator.default_parameters_path()
    for create, kw in ((create_emulator, dict(device="cpu")), (jcreate, {})):
        with pytest.raises(FileNotFoundError, match="JAX_NBODY_EMULATOR_PARAMS") as err:
            create(premodulate=True, mid_chan=4, **kw)  # load_params defaults to True
        assert str(missing) in str(err.value)
    with pytest.raises(FileNotFoundError):
        tpkg.load_default_parameters()
    monkeypatch.delenv("JAX_NBODY_EMULATOR_PARAMS")
    path = tpkg.default_parameters_path()
    assert path.name == "nbody_emulator_params.npz" and path.parent.name == "model_parameters"
    assert "jax_nbody_emulator_with_dj_tpu_torch" in str(path) and not path.exists()


@pytest.mark.parametrize("layout", ["oidhw", "file"])
def test_reference_layout_tree_gives_the_native_output(style4, box, layout, tmp_path, monkeypatch):
    """An OIDHW tree, passed in or found as the default file, is converted:
    the same 16^3 box, bit for bit."""
    cfg = HierarchicalConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8), dtype=torch.float32,
                             output_dtype=torch.float32)
    kw = dict(premodulate=True, compute_vel=False, premodulate_z=Z, premodulate_Om=OM,
              processor_config=cfg, mid_chan=4, device="cpu")
    native = params_from_jax(style4)
    ref = create_emulator(params=native, **kw).process_box(box, Z, OM)
    oidhw = tparams.convert_to_reference_params(native)
    if layout == "oidhw":
        emu = create_emulator(params=oidhw, **kw)
    else:
        tparams.save_params_npz(tmp_path / "p.npz", oidhw)
        monkeypatch.setenv("JAX_NBODY_EMULATOR_PARAMS", str(tmp_path / "p.npz"))
        emu = create_emulator(**kw)
    assert emu.premodulate and not emu.compute_vel
    assert emu.params["params"]["conv_c"]["conv_0"]["weight"].shape[:3] == (3, 3, 3)
    np.testing.assert_array_equal(emu.process_box(box, Z, OM), ref)


def test_processor_needs_parameters():
    cfg = HierarchicalConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8))
    with pytest.raises(ValueError, match="params="):
        create_emulator(premodulate=True, compute_vel=False, load_params=False,
                        processor_config=cfg, mid_chan=4, device="cpu")
    # the reference's default model, the style disp+vel core, without parameters: as in JAX
    emu = create_emulator(premodulate=False, load_params=False, device="cpu")
    jemu = jcreate(premodulate=False, load_params=False)
    assert type(emu.model).__name__ == type(jemu.model).__name__ == "StyleNBodyEmulatorVelCore"
    assert emu.params is None and emu.processor is None
    assert (emu.premodulate, emu.compute_vel) == (jemu.premodulate, jemu.compute_vel)
    assert (emu.premodulate, emu.compute_vel) == (False, True)


# ---------------------------------------------------------------------------
# HierarchicalConfig / process_box: buf_dtype, y0_slab_h, donate_input
# ---------------------------------------------------------------------------


def test_config_accepts_every_reference_field():
    jfields = set(JConfig.__dataclass_fields__)
    assert jfields <= set(HierarchicalConfig.__dataclass_fields__)
    for kw in (dict(size=(N,) * 3, slab=8, tile=(8, 8, 8)),
               dict(size=(128,) * 3), dict(size=(512,) * 3, tile=(128, 64, 128))):
        cfg, jcfg = HierarchicalConfig(**kw), JConfig(**kw)
        # the y0 cache reads it: the JAX default, min(68, tile H + 8)
        assert cfg.y0_slab_h == jcfg.y0_slab_h == min(68, cfg.tile[1] + 8)
        assert cfg.buf_dtype == cfg.dtype == torch.bfloat16 and jcfg.buf_dtype == jcfg.dtype
    cfg = HierarchicalConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8), dtype=torch.float32,
                             buf_dtype=torch.bfloat16, y0_slab_h=6)
    assert (cfg.buf_dtype, cfg.y0_slab_h) == (torch.bfloat16, 6)


def _boxes(style, box, vel, **cfg_kw):
    """(port, JAX) outputs of the 16^3 box, float32 compute, as tuples."""
    geo = dict(size=(N,) * 3, slab=8, tile=(8, 8, 8))
    tkw = {k: getattr(torch, v) if k == "buf_dtype" else v for k, v in cfg_kw.items()}
    jkw = {k: getattr(jnp, v) if k == "buf_dtype" else v for k, v in cfg_kw.items()}
    emu = create_emulator(
        premodulate=True, compute_vel=vel, params=params_from_jax(style), premodulate_z=Z,
        premodulate_Om=OM, mid_chan=4, device="cpu",
        processor_config=HierarchicalConfig(**geo, dtype=torch.float32,
                                            output_dtype=torch.float32, **tkw))
    jemu = jcreate(
        premodulate=True, compute_vel=vel, params=style, premodulate_z=Z, premodulate_Om=OM,
        mid_chan=4,
        processor_config=JConfig(**geo, dtype=jnp.float32, output_dtype=np.float32, **jkw))
    out, ref = emu.process_box(box, Z, OM), jemu.process_box(box, Z, OM)
    return (out, ref) if vel else ((out,), (ref,))


@pytest.mark.parametrize("vel", [False, True])
def test_bf16_level_buffers_match_jax(style4, style4_vel, box, vel):
    """float32 tiles, bf16 level buffers, on both sides: each phase's result is
    rounded once where it is written, at the same places in both runtimes, so
    the two differ by float32 reordering (measured 3e-7 relative max, disp and
    vel) unless a reordering moves a value across a bf16 rounding boundary
    (2^-8 relative on one buffer element, carried on by the later phases).
    Gate: relative max 2e-3 for the displacement and velocity rms over rms
    2e-3, a tenth of the 0.02 that gates the bf16 kernel paths.  The buffers
    do cost accuracy: against float32 buffers the same box moves by 1e-4 to
    7e-3, far more than reordering does."""
    out, ref = _boxes(style4_vel if vel else style4, box, vel, buf_dtype="bfloat16")
    f32, _ = _boxes(style4_vel if vel else style4, box, vel)
    assert rel_max(out[0], ref[0]) < 2e-3
    assert 1e-5 < rel_max(out[0], f32[0]) < 0.02
    if vel:
        rms = float((out[1].astype(np.float64) - ref[1]).std() / ref[1].astype(np.float64).std())
        assert rms < 2e-3
        assert 1e-5 < rel_max(out[1], f32[1]) < 0.02


def test_buf_dtype_none_changes_nothing(style4, box):
    """``buf_dtype=None`` (the default) and ``buf_dtype=dtype`` give the same bits, and the
    level buffers take the dtype asked for."""
    a, _ = _boxes(style4, box, False)
    b, _ = _boxes(style4, box, False, buf_dtype="float32")
    np.testing.assert_array_equal(a[0], b[0])
    from jax_nbody_emulator_with_dj_tpu_torch.models.cores import NBodyEmulatorCore

    tree = tpkg.modulate_emulator_parameters(params_from_jax(style4), Z, OM)
    for buf in (None, torch.bfloat16):
        cfg = HierarchicalConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8), dtype=torch.float32,
                                 buf_dtype=buf)
        proc = HierarchicalProcessor(NBodyEmulatorCore(mid_chan=4), tree, cfg, device="cpu")
        bufs = proc._new_bufs(proc._h1_margin())
        assert [t.dtype for t in bufs] == [buf or torch.float32]
        tiles = proc._read_tiles(bufs, (0, 0, 0), (4, 4, 2))
        assert tiles[0].dtype == torch.float32 and tiles[0].shape == (1, 4, 4, 2, 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_donate_input_and_host_cast(style4, box, dtype):
    """``donate_input`` changes no value; only a tensor that already lies on the
    device in the compute dtype is scaled in place.  A numpy box, a CPU tensor
    and a tensor in the compute dtype are rounded once, to the same bits."""
    cfg = HierarchicalConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8), dtype=dtype,
                             output_dtype=torch.float32, y0_slab_h=4)
    emu = create_emulator(premodulate=True, compute_vel=False, params=params_from_jax(style4),
                          premodulate_z=Z, premodulate_Om=OM, processor_config=cfg, mid_chan=4,
                          device="cpu")
    assert "donate_input" in inspect.signature(JProcessor.process_box).parameters
    ref = emu.process_box(box, Z, OM)
    np.testing.assert_array_equal(emu.process_box(box, Z, OM, donate_input=True), ref)
    f32 = torch.from_numpy(box.copy())
    np.testing.assert_array_equal(emu.process_box(f32, Z, OM, donate_input=dtype != torch.float32),
                                  ref)
    if dtype != torch.float32:
        assert torch.equal(f32, torch.from_numpy(box))  # another dtype: not consumed
    own = torch.from_numpy(box.copy()).to(dtype)
    np.testing.assert_array_equal(emu.process_box(own.clone(), Z, OM), ref)
    kept = own.clone()
    np.testing.assert_array_equal(emu.process_box(own, Z, OM, donate_input=True), ref)
    assert not torch.equal(own, kept)  # consumed: scaled in place
