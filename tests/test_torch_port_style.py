"""The port's style (flexible-cosmology) models vs the JAX package, on the CPU.

The same seeded style trees (made by the JAX package, converted with
``params_from_jax``) and the same numpy inputs go through the JAX package and
the port.  Tolerances, each stated where it is used: rtol 1e-5 (atol 1e-6
for conv outputs near 0) for the style modulation and single styled layers,
where only the float32 summation order differs; the stored goldens at their
own rtol/atol 5e-5 (``tests/test_golden.py``), velocity divided by its max;
rtol 1e-4 for the batched style cores against per-sample premodulated
forwards; rtol 2e-4 / atol 2e-5 for whole boxes, as
``tests/test_hierarchical.py`` holds the JAX runtimes against each other,
with velocity in rms < 1e-3 and max < 0.005 of its max
(``test_torch_port_vel.py::test_vel_slice_matches_jax_mid64`` says why);
with the Winograd kernels' plain versions (bf16 operands by contract)
displacement rel max < 0.02 and velocity rms < 0.08, the JAX package's gates
for its kernel path.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax_nbody_emulator_with_dj_tpu as jpkg
from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorCore as JStyleCore
from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorVelCore as JStyleVelCore
from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalConfig as JConfig
from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalProcessor as JProcessor
from jax_nbody_emulator_with_dj_tpu.models import blocks as jblocks
from jax_nbody_emulator_with_dj_tpu.ops import style as jstyle
import jax_nbody_emulator_with_dj_tpu_torch as tpkg
from jax_nbody_emulator_with_dj_tpu_torch import (
    HierarchicalConfig,
    HierarchicalProcessor,
    NBodyEmulatorCore,
    NBodyEmulatorVelCore,
    StyleNBodyEmulatorCore,
    StyleNBodyEmulatorVelCore,
    create_emulator,
    growth_factor,
    modulate_emulator_parameters,
    modulate_emulator_parameters_vel,
    vel_norm,
)
from jax_nbody_emulator_with_dj_tpu_torch.models import blocks as tblocks
from jax_nbody_emulator_with_dj_tpu_torch.ops import style as tstyle
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd_cuda
from jax_nbody_emulator_with_dj_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(2)  # tier-1 runs several xdist workers

N = 16  # tiny box: slab 8, tiles 8^3, tile1 8
Z, OM = 0.5, 0.3175
VF = float(vel_norm(Z, OM))


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def rel_max(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def rms_ratio(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((a - b).std() / b.std())


@pytest.fixture(scope="module")
def box():
    return np.random.default_rng(1).standard_normal((3, N, N, N)).astype(np.float32)


@pytest.fixture(scope="module")
def style4():
    return JStyleCore(mid_chan=4).init(jax.random.key(17))


@pytest.fixture(scope="module")
def style64():
    return JStyleCore(mid_chan=64).init(jax.random.key(17))


# ---------------------------------------------------------------------------
# (a) Style modulation and the styled layer, batch of two cosmologies
# ---------------------------------------------------------------------------

# s = [(Om - 0.3) * 5, Dz - 1] for (Om, Dz) = (0.25, 0.7) and (0.35, 0.9)
S2 = np.array([[-0.25, -0.3], [0.25, -0.1]], np.float32)
KSIZE = {"conv": 3, "skip": 1, "down": 2, "up": 2}


def _style_layer(kind, cin=6, cout=5):
    k = KSIZE[kind]
    return {
        "weight": rnd(k, k, k, cin, cout, seed=3, scale=0.3),
        "bias": rnd(cout, seed=4, scale=0.1),
        "style_weight": rnd(cin, 2, seed=5),
        "style_bias": np.ones(cin, np.float32) + rnd(cin, seed=6, scale=0.1),
    }


def test_style_modulation_matches_jax():
    """rtol 1e-5: float32 products of (B, S) x (S, Ci) and (B, Ci) x (Ci, Co)."""
    layer = _style_layer("conv")
    m, norm = tstyle.style_modulation({k: T(v) for k, v in layer.items()}, T(S2))
    mj, normj = jstyle.style_modulation({k: jnp.asarray(v) for k, v in layer.items()},
                                        jnp.asarray(S2))
    assert tuple(m.shape) == (2, 6) and tuple(norm.shape) == (2, 5)
    assert m.dtype == norm.dtype == torch.float32
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=1e-5)
    np.testing.assert_allclose(norm.numpy(), np.asarray(normj), rtol=1e-5)


def test_modulated_style_weight_matches_jax():
    """rtol 1e-5; and each sample's weight is the premodulation fold at its style."""
    layer = _style_layer("conv")
    got = tstyle.modulated_style_weight({k: T(v) for k, v in layer.items()}, T(S2))
    ref = jstyle.modulated_style_weight({k: jnp.asarray(v) for k, v in layer.items()},
                                        jnp.asarray(S2))
    assert tuple(got.shape) == (2, 3, 3, 3, 6, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)
    for b in range(2):
        fold = tstyle.premodulate_layer({k: T(v) for k, v in layer.items()}, T(S2[b]))
        np.testing.assert_allclose(got[b].numpy(), fold["weight"].numpy(), rtol=1e-5)


@pytest.mark.parametrize("kind,in_fmt,out_fmt", [
    ("conv", "NCDHW", "NDHWC"), ("conv", "NDHWC", "NCDHW"), ("conv", "NDHWC", "NDHWC"),
    ("skip", "NCDHW", "NDHWC"), ("down", "NDHWC", "NDHWC"), ("up", "NDHWC", "NDHWC"),
])
def test_styled_conv_layer_matches_jax(kind, in_fmt, out_fmt):
    """B = 2, two cosmologies; rtol 1e-5, atol 1e-6 for outputs near 0.  The
    port's one shared conv between scales equals a conv per sample with that
    sample's demodulated weight (rtol 1e-5, atol 1e-6)."""
    layer = _style_layer(kind)
    shape = (2, 6, 8, 10, 12) if in_fmt == "NCDHW" else (2, 8, 10, 12, 6)
    x = rnd(*shape, seed=7)
    got = tblocks.apply_conv_layer({k: T(v) for k, v in layer.items()}, T(x), kind, s=T(S2),
                                   in_fmt=in_fmt, out_fmt=out_fmt)
    ref = jblocks.apply_conv_layer({k: jnp.asarray(v) for k, v in layer.items()},
                                   jnp.asarray(x), kind, s=jnp.asarray(S2), in_fmt=in_fmt,
                                   out_fmt=out_fmt)
    assert tuple(got.shape) == tuple(ref.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    w = tstyle.modulated_style_weight({k: T(v) for k, v in layer.items()}, T(S2))
    for b in range(2):
        per = tblocks.apply_conv_layer({"weight": w[b], "bias": T(layer["bias"])}, T(x[b:b + 1]),
                                       kind, in_fmt=in_fmt, out_fmt=out_fmt)
        np.testing.assert_allclose(got[b:b + 1].numpy(), per.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# (b) The cores: the stored goldens, and batched style vs per-sample premodulated
# ---------------------------------------------------------------------------

SEED = 20260816  # tests/test_golden.py's tree and input
GOLDEN_CFG = dict(levels=1, mid_chan=4)
GOLDEN = Path(__file__).resolve().parent / "golden" / "emulator_golden.npz"


@pytest.fixture(scope="module")
def golden_setup():
    tree = params_from_jax(JStyleVelCore(**GOLDEN_CFG).init(jax.random.key(SEED)))
    x = jax.random.normal(jax.random.key(SEED + 1), (1, 3, 32, 32, 32), jnp.float32)
    with np.load(GOLDEN) as f:
        golden = {k: f[k] for k in f.files}
    return tree, torch.from_numpy(np.array(x)), golden


@pytest.mark.parametrize("core", ["style_disp", "style_vel", "premod_disp", "premod_vel"])
def test_cores_match_goldens(golden_setup, core):
    """rtol/atol 5e-5 as ``tests/test_golden.py``; velocity divided by its max.
    The premodulated cores run the port's own fold of the same tree."""
    tree, x, golden = golden_setup
    dz, vf = float(growth_factor(Z, OM)), float(vel_norm(Z, OM))
    with torch.no_grad():
        if core == "style_disp":
            out = (StyleNBodyEmulatorCore(**GOLDEN_CFG).apply(tree, x, OM, dz),)
        elif core == "style_vel":
            out = StyleNBodyEmulatorVelCore(**GOLDEN_CFG).apply(tree, x, OM, dz, vf)
        elif core == "premod_disp":
            out = (NBodyEmulatorCore(**GOLDEN_CFG).apply(
                modulate_emulator_parameters(tree, Z, OM), x, dz),)
        else:
            out = NBodyEmulatorVelCore(**GOLDEN_CFG).apply(
                modulate_emulator_parameters_vel(tree, Z, OM), x, dz, vf)
    keys = [core] if core.endswith("disp") else [core + "_d", core + "_v"]
    for got, key in zip(out, keys):
        want = golden[key]
        scale = np.abs(want).max() if key.endswith("_v") else 1.0
        assert got.shape == want.shape and np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy() / scale, want / scale, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("vel", [False, True])
def test_batched_style_core_matches_per_sample_fold(vel):
    """B = 2 at two cosmologies, float32: the style core on the batch against
    the premodulated core on each sample with the style folded at its (z, Om)
    (``modulate_emulator_parameters[_vel]``); rtol 1e-4, atol 1e-5, velocity in
    displacement units (divided by vel_norm)."""
    cfg = dict(levels=1, mid_chan=4)
    tree = params_from_jax(JStyleVelCore(**cfg).init(jax.random.key(3)))
    x = torch.from_numpy(rnd(2, 3, 40, 40, 40, seed=2))
    zs, oms = np.array([0.5, 1.0]), np.array([0.3175, 0.25])
    dz, vf = growth_factor(zs, oms), vel_norm(zs, oms)
    with torch.no_grad():
        if vel:
            got = StyleNBodyEmulatorVelCore(**cfg).apply(tree, x, T(oms), T(dz), T(vf))
        else:
            got = (StyleNBodyEmulatorCore(**cfg).apply(tree, x, T(oms), T(dz)),)
        for b in range(2):
            if vel:
                ref = NBodyEmulatorVelCore(**cfg).apply(
                    modulate_emulator_parameters_vel(tree, zs[b], oms[b]), x[b], dz[b], vf[b])
            else:
                ref = (NBodyEmulatorCore(**cfg).apply(
                    modulate_emulator_parameters(tree, zs[b], oms[b]), x[b], dz[b]),)
            for i, (g, r) in enumerate(zip(got, ref)):
                unit = vf[b] if i else 1.0
                np.testing.assert_allclose(g[b].numpy() / unit, r.numpy() / unit, rtol=1e-4,
                                           atol=1e-5)


def test_style_vel_core_matches_jax_unbatched():
    """A (C, D, H, W) input comes back unbatched; against the JAX core with the
    same float32 Dz and vel_fac: rtol 1e-4, atol 1e-5, velocity over vel_norm."""
    cfg = dict(levels=1, mid_chan=4)
    jtree = JStyleVelCore(**cfg).init(jax.random.key(4))
    x = rnd(3, 32, 32, 32, seed=3)
    dz, vf = np.float32(growth_factor(Z, OM)), np.float32(VF)
    jd, jv = JStyleVelCore(**cfg).apply(jtree, jnp.asarray(x), OM, dz, vf)
    with torch.no_grad():
        d, v = StyleNBodyEmulatorVelCore(**cfg).apply(params_from_jax(jtree), T(x), OM,
                                                      float(dz), float(vf))
    assert tuple(d.shape) == tuple(v.shape) == (3, 8, 8, 8)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v.numpy() / VF, np.asarray(jv) / VF, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# (c) The four cores' surface (fault C6)
# ---------------------------------------------------------------------------

CORES = ["StyleNBodyEmulatorCore", "StyleNBodyEmulatorVelCore", "NBodyEmulatorCore",
         "NBodyEmulatorVelCore"]


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", CORES)
def test_core_fields_and_init_match_jax(name):
    """The same fields with the same defaults, and an ``init`` tree with the JAX
    core's paths and shapes (a learned ``dweight`` for the premodulated vel core)."""
    port, ref = getattr(tpkg, name), getattr(jpkg, name)
    got = [(f.name, f.default) for f in dataclasses.fields(port)]
    assert got == [(f.name, f.default) for f in dataclasses.fields(ref)]
    assert port().margin == ref().margin == 48
    tree = dict(_leaves(port(mid_chan=4).init(0)))
    want = dict(_leaves(ref(mid_chan=4).init(jax.random.key(0))))
    assert tree.keys() == want.keys()
    for k, v in tree.items():
        assert isinstance(v, torch.Tensor) and tuple(v.shape) == tuple(want[k].shape), k
    assert any(k[-1] == "dweight" for k in tree) == (name == "NBodyEmulatorVelCore")


def test_learned_vel_tree_from_init_still_raises_a11():
    """A learned-``dweight`` tree from ``init`` once made packing raise; it now
    packs the materialized tangent (``wcat``, no rank factors) and runs, equal
    to the model's own forward on the wrap-padded box (rtol 2e-4 / atol 2e-5,
    velocity in displacement units as in ``tests/test_torch_port_vel.py``)."""
    from jax_nbody_emulator_with_dj_tpu_torch.hierarchical import _wrap_pad

    tree = NBodyEmulatorVelCore(mid_chan=4).init(5)
    cfg = HierarchicalConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8), dtype=torch.float32,
                             output_dtype=torch.float32)
    emu = create_emulator(premodulate=True, compute_vel=True, params=tree, processor_config=cfg,
                          mid_chan=4, device="cpu")
    assert isinstance(emu.processor, HierarchicalProcessor)
    assert emu.processor.learned_tangent and "g" not in emu.processor._exec["conv_l1"]["conv_0"]
    box = np.random.default_rng(2).standard_normal((3, N, N, N)).astype(np.float32)
    disp, vel = emu.process_box(box, Z, OM)
    ref = emu.apply(_wrap_pad(torch.from_numpy(box)[None], 48), Z, OM)
    vf = float(vel_norm(Z, OM))
    np.testing.assert_allclose(disp, ref[0][0].numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(vel / vf, ref[1][0].numpy() / vf, rtol=2e-4, atol=2e-5)


def test_create_emulator_takes_style_size(style4):
    """``style_size`` reaches the model, for both kinds of model, as in the JAX factory."""
    for premodulate in (True, False):
        emu = create_emulator(premodulate=premodulate, compute_vel=False, style_size=2,
                              params=params_from_jax(style4), premodulate_z=Z,
                              premodulate_Om=OM, mid_chan=4, levels=3, device="cpu")
        assert emu.model.style_size == 2 and emu.premodulate == premodulate
        assert type(emu.model).__name__ == ("NBodyEmulatorCore" if premodulate
                                             else "StyleNBodyEmulatorCore")


# ---------------------------------------------------------------------------
# (d) The style models on the hierarchical runtime vs the JAX runtime
# ---------------------------------------------------------------------------


def _jax_style_box(style, mid, box, vel):
    cfg = JConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8), dtype=jnp.float32,
                  output_dtype=np.float32)
    model = (JStyleVelCore if vel else JStyleCore)(mid_chan=mid)
    out = JProcessor(model, style, cfg).process_box(box, Z, OM)
    return out if vel else (out,)


def _port_style_emulator(style, mid, vel, wino=None):
    cfg = HierarchicalConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8), dtype=torch.float32,
                             output_dtype=torch.float32, wino=wino)
    return create_emulator(compute_vel=vel, params=params_from_jax(style), processor_config=cfg,
                           mid_chan=mid, device="cpu")  # premodulate=False: the reference's default


def _port_style_box(style, mid, box, vel, wino=None):
    out = _port_style_emulator(style, mid, vel, wino).process_box(box, Z, OM,
                                                                  show_progress=False)
    return out if vel else (out,)


def _close_style_box(out, ref):
    """Disp at rtol 2e-4 / atol 2e-5; vel in rms < 1e-3 and max < 0.005."""
    assert out[0].shape == (3, N, N, N) and out[0].dtype == np.float32
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-4, atol=2e-5)
    if len(out) > 1:
        assert rms_ratio(out[1], ref[1]) < 1e-3
        assert rel_max(out[1], ref[1]) < 0.005


@pytest.mark.parametrize("vel", [False, True])
def test_style_hierarchical_matches_jax_mid4(style4, box, vel):
    _close_style_box(_port_style_box(style4, 4, box, vel), _jax_style_box(style4, 4, box, vel))


@pytest.fixture(scope="module")
def jax_style_boxes64(style64, box):
    return {vel: _jax_style_box(style64, 64, box, vel) for vel in (False, True)}


@pytest.mark.parametrize("vel", [False, True])
def test_style_hierarchical_matches_jax_mid64(style64, box, jax_style_boxes64, vel):
    _close_style_box(_port_style_box(style64, 64, box, vel, wino=False), jax_style_boxes64[vel])


@pytest.mark.parametrize("vel", [False, True])
def test_style_hierarchical_wino_matches_jax_mid64(style64, box, jax_style_boxes64, vel,
                                                   monkeypatch):
    """B1's (disp) or B2's (vel) plain version at every Winograd site, from the
    per-box fold's packed weights; the JAX package's gates for its kernel path."""
    calls = []
    name = "conv3_packed_wino_pair" if vel else "conv3_packed_wino"
    plain = getattr(winograd_cuda, name)
    monkeypatch.setattr(winograd_cuda, name, lambda *a, **k: calls.append(1) or plain(*a, **k))
    out = _port_style_box(style64, 64, box, vel, wino=True)
    ref = jax_style_boxes64[vel]
    assert len(calls) > 0 and all(np.isfinite(o).all() for o in out)
    assert rel_max(out[0], ref[0]) < 0.02
    if vel:
        assert rms_ratio(out[1], ref[1]) < 0.08


def test_style_fold_is_per_call_and_never_recovers_factors(style4, box, monkeypatch):
    """Each call folds at its own (z, Om) (timed as ``fold``), keeps no folded
    weights after it, and takes the tangent's factors from the fold, never from
    the host's least squares."""
    def refuse(*a, **k):
        raise AssertionError("the style fold reached recover_dweight_factors")

    monkeypatch.setattr(tblocks, "recover_dweight_factors", refuse)
    emu = _port_style_emulator(style4, 4, True)
    a = emu.process_box(box, Z, OM, profile=True)
    timings = emu.processor.last_timings
    assert list(timings)[:2] == ["fold", "scale"] and timings["fold"] > 0
    assert emu.processor._exec is None
    b = emu.process_box(box, 1.0, 0.25)
    assert not np.allclose(a[0], b[0]) and not np.allclose(a[1], b[1])


@pytest.mark.parametrize("vel", [False, True])
def test_style_hierarchical_equals_premodulated_fold(style4, box, vel):
    """The same fold, made per box on the device or once at creation: the
    displacement bit for bit; the velocity to rtol 1e-5, atol 1e-6 of
    vel_norm, since the premodulated tree's tangent factors are recovered by
    least squares where the per-box fold gives them exactly."""
    cfg = HierarchicalConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8), dtype=torch.float32,
                             output_dtype=torch.float32)
    premod = create_emulator(premodulate=True, compute_vel=vel, params=params_from_jax(style4),
                             premodulate_z=Z, premodulate_Om=OM, processor_config=cfg,
                             mid_chan=4, device="cpu").process_box(box, Z, OM)
    premod = premod if vel else (premod,)
    out = _port_style_box(style4, 4, box, vel)
    np.testing.assert_array_equal(out[0], premod[0])
    if vel:
        np.testing.assert_allclose(out[1] / VF, premod[1] / VF, rtol=1e-5, atol=1e-6)
