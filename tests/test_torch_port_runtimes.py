"""The port's unpacked and y0-cached hierarchical paths and its learned-tangent
velocity layers vs the JAX package, on the CPU.

The same seeded trees (made by the JAX package, converted with
``params_from_jax``) and the same numpy box go through the JAX package and
the port, at ``mid_chan=4`` (and 64 where noted), N = 16, float32.
Tolerances: whole boxes rtol 2e-4 / atol 2e-5 against the JAX runtime with
the same config, as ``tests/test_hierarchical.py`` holds the JAX runtimes
against each other, with velocities compared in displacement units (divided
by ``vel_norm(z, Om)``, ~52 here, as ``tests/test_torch_port_vel.py`` does);
at ``mid_chan=64`` velocity in rms < 1e-3 and max < 0.005 (ROADMAP.md's
standing record: one pre-activation of this box lies within float32
rounding of 0).  Against the port's own packed monolithic run rtol 2e-5 /
atol 2e-5 (JAX ``tests/test_hierarchical.py``); the y0 cache's variants
(W-splitting tiles, strip segment heights) rtol 1e-6 to each other.  Single
packed layers rtol 1e-4 / atol 1e-5.  Where the port runs the Winograd
kernel's plain version, its operands are bf16 by contract: displacement
relative max error < 0.02, velocity rms < 0.08 (the JAX package's gates
for its kernel path).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu import NBodyEmulatorCore as JCore
from jax_nbody_emulator_with_dj_tpu import NBodyEmulatorVelCore as JVelCore
from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorCore as JStyleCore
from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorVelCore as JStyleVelCore
from jax_nbody_emulator_with_dj_tpu.emulator import modulate_emulator_parameters as jmod
from jax_nbody_emulator_with_dj_tpu.emulator import modulate_emulator_parameters_vel as jmod_vel
from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalConfig as JConfig
from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalProcessor as JProcessor
from jax_nbody_emulator_with_dj_tpu.models import blocks as jblocks
from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalConfig, create_emulator
from jax_nbody_emulator_with_dj_tpu_torch.hierarchical import HierarchicalProcessor, _wrap_pad
from jax_nbody_emulator_with_dj_tpu_torch.models import blocks as tblocks
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd as twino
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd_cuda
from jax_nbody_emulator_with_dj_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(2)  # tier-1 runs several xdist workers

N = 16
Z, OM = 0.5, 0.3175
VF = 51.74779427502384  # vel_norm(Z, OM)
BASE = dict(size=(N,) * 3, slab=8, tile=(8, 8, 8))


def rel_max(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def rms_ratio(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((a - b).std() / b.std())


def _pair(out, vel):
    return tuple(out) if vel else (out,)


def _close_box(got, ref, vel, rtol=2e-4, atol=2e-5):
    """disp (and vel, in displacement units) at the given tolerance."""
    got, ref = _pair(got, vel), _pair(ref, vel)
    np.testing.assert_allclose(got[0], np.asarray(ref[0]), rtol=rtol, atol=atol)
    if vel:
        np.testing.assert_allclose(got[1] / VF, np.asarray(ref[1]) / VF, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def box():
    return np.random.default_rng(1).standard_normal((3, N, N, N)).astype(np.float32)


@pytest.fixture(scope="module")
def style4():
    return JStyleVelCore(mid_chan=4).init(jax.random.key(17))


@pytest.fixture(scope="module")
def style64():
    return JStyleVelCore(mid_chan=64).init(jax.random.key(17))


# (premodulated, vel) for the four cores; a style core takes the style tree itself
MODELS = {
    "disp": (True, False),
    "vel": (True, True),
    "style_disp": (False, False),
    "style_vel": (False, True),
}


def _jax_box(style, mid, box, model, **cfg_kw):
    premod, vel = MODELS[model]
    cfg = JConfig(**{**BASE, **cfg_kw}, dtype=jnp.float32, output_dtype=np.float32)
    if premod:
        core = (JVelCore if vel else JCore)(mid_chan=mid)
        params = (jmod_vel if vel else jmod)(style, Z, OM)
    else:
        core, params = (JStyleVelCore if vel else JStyleCore)(mid_chan=mid), style
    return JProcessor(core, params, cfg).process_box(box, Z, OM)


def _port_emulator(tree, mid, model, wino=False, **cfg_kw):
    premod, vel = MODELS[model]
    cfg = HierarchicalConfig(**{**BASE, **cfg_kw}, dtype=torch.float32,
                             output_dtype=torch.float32, wino=wino)
    return create_emulator(premodulate=premod, compute_vel=vel, params=tree,
                           premodulate_z=Z, premodulate_Om=OM, processor_config=cfg,
                           mid_chan=mid, device="cpu")


def _port_box(tree, mid, box, model, **kw):
    return _port_emulator(tree, mid, model, **kw).process_box(box, Z, OM)


# ---------------------------------------------------------------------------
# (a) HierarchicalConfig against JAX's, field by field
# ---------------------------------------------------------------------------


def test_config_fields_match_jax():
    port = [(f.name, f.default) for f in dataclasses.fields(HierarchicalConfig)]
    ref = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    assert [n for n, _ in port] == [n for n, _ in ref]
    for (name, got), (_, want) in zip(port, ref):
        if name not in ("dtype", "output_dtype"):  # torch dtypes against JAX / numpy ones
            assert got == want, name
    assert HierarchicalConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8)).output_dtype == torch.float16


@pytest.mark.parametrize("kw", [
    dict(size=(16,) * 3, slab=8, tile=(16, 16, 16)),
    dict(size=(16,) * 3, slab=8, tile=(16, 16, 16), packed=False),
    dict(size=(16,) * 3, slab=8, tile=(8, 8, 8), y0_cache=True),
    dict(size=(16,) * 3, slab=8, tile=(16, 4, 8), packed=False, y0_cache=True),
    dict(size=(32, 16, 48), slab=8, tile=(16, 8, 16), y0_slab_h=5),
    dict(size=(128,) * 3, slab=32, tile=(128, 64, 128)),
    dict(size=(256, 128, 128), slab=16, tile=(64, 128, 32), packed=False),
])
def test_config_defaults_match_jax(kw):
    port, ref = HierarchicalConfig(**kw), JConfig(**kw)
    for name in ("size", "slab", "slab_h", "tile", "tile1", "in_chan", "packed", "wino",
                 "y0_cache", "y0_slab_h"):
        assert getattr(port, name) == getattr(ref, name), name
    assert port.buf_dtype == port.dtype


@pytest.mark.parametrize("kw", [
    dict(size=(16,) * 3, slab=8, y0_slab_h=1),
    dict(size=(16,) * 3, slab=8, y0_slab_h=0),
    dict(size=(16,) * 3, slab=8, tile1=4),
    dict(size=(16,) * 3, slab=8, tile1=6, packed=False),
    dict(size=(16,) * 3, slab=8, tile=(8, 8, 2)),
    dict(size=(24,) * 3, slab=8, tile=(8, 8, 8), packed=False, tile1=8),
])
def test_config_errors_match_jax(kw):
    with pytest.raises(ValueError):
        JConfig(**kw)
    with pytest.raises(ValueError):
        HierarchicalConfig(**kw)


def test_unpacked_tile_w_needs_no_cells():
    """tile W = 2 and tile1 = 4 are valid unpacked, as in JAX."""
    kw = dict(size=(16,) * 3, slab=8, tile=(8, 8, 2), tile1=4, packed=False)
    assert HierarchicalConfig(**kw).tile1 == JConfig(**kw).tile1 == 4


# ---------------------------------------------------------------------------
# (b) The unpacked and y0-cached paths against the JAX runtime, mid_chan=4
# ---------------------------------------------------------------------------

VARIANTS = {
    "unpacked": dict(packed=False),
    "y0_cache": dict(y0_cache=True),
}


@pytest.fixture(scope="module")
def packed_runs(style4, box):
    """The port's packed monolithic runs of the four cores, the reference of (c)."""
    return {m: _port_box(params_from_jax(style4), 4, box, m) for m in MODELS}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("model", list(MODELS))
def test_runtime_variant_matches_jax(style4, box, packed_runs, model, variant):
    kw = VARIANTS[variant]
    vel = MODELS[model][1]
    out = _port_box(params_from_jax(style4), 4, box, model, **kw)
    for o in _pair(out, vel):
        assert o.shape == (3, N, N, N) and o.dtype == np.float32
    _close_box(out, _jax_box(style4, 4, box, model, **kw), vel)
    # (c) against the port's own packed monolithic run
    _close_box(out, packed_runs[model], vel, rtol=2e-5, atol=2e-5)


def test_unpacked_vel_matches_jax_mid64(style64, box):
    disp, vel = _port_box(params_from_jax(style64), 64, box, "vel", packed=False)
    ref = _jax_box(style64, 64, box, "vel", packed=False)
    np.testing.assert_allclose(disp, np.asarray(ref[0]), rtol=2e-4, atol=2e-5)
    assert rms_ratio(vel, ref[1]) < 1e-3
    assert rel_max(vel, ref[1]) < 0.005


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("model", ["disp", "style_vel"])
def test_y0_cache_strip_heights_and_w_split(style4, box, model, packed):
    """A tile that splits W (4 W tiles share each strip) and y0_slab_h of
    None (one segment), 8 and 4 (3 segments of 4 rows and 5 segments)."""
    vel = MODELS[model][1]
    tree = params_from_jax(style4)
    runs = [_port_box(tree, 4, box, model, packed=packed, y0_cache=True, tile=(8, 8, 4),
                      y0_slab_h=h) for h in (None, 8, 4)]
    for out in runs[1:]:
        for a, b in zip(_pair(out, vel), _pair(runs[0], vel)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())
    ref = _jax_box(style4, 4, box, model, packed=packed, y0_cache=True, tile=(8, 8, 4),
                   y0_slab_h=4)
    _close_box(runs[2], ref, vel)


def test_y0_strip_is_freed_before_the_next(style4, box, monkeypatch):
    """Each strip is built, decodes its W tiles, and is dropped: never two alive."""
    emu = _port_emulator(params_from_jax(style4), 4, "vel", y0_cache=True, tile=(8, 8, 4))
    proc = emu.processor
    built, alive = [], []
    real = HierarchicalProcessor._y0_strip

    def tracking(self, boxp, d0, h0):
        import weakref

        alive[:] = [r for r in alive if r() is not None]
        assert not alive, "a previous strip is still referenced"
        strip = real(self, boxp, d0, h0)
        built.append((d0, h0))
        alive.append(weakref.ref(strip[0]))
        assert all(s.dtype == proc.config.buf_dtype for s in strip)
        assert tuple(strip[0].shape) == (1, 16, 16, (N + 8) // 2, 8)
        return strip

    monkeypatch.setattr(HierarchicalProcessor, "_y0_strip", tracking)
    emu.process_box(box, Z, OM)
    assert built == [(0, 0), (0, 8), (8, 0), (8, 8)]


def test_bf16_level_buffers_with_y0_cache(style4, box):
    """buf_dtype=bfloat16 stores the strip in bf16 too: the JAX runtime with
    the same config, at the gate the bf16 level buffers were held to (2e-3)."""
    kw = dict(y0_cache=True, tile=(8, 8, 4), buf_dtype=torch.bfloat16)
    out = _port_box(params_from_jax(style4), 4, box, "disp", **kw)
    ref = _jax_box(style4, 4, box, "disp", **{**kw, "buf_dtype": jnp.bfloat16})
    assert rel_max(out, ref) < 2e-3


# ---------------------------------------------------------------------------
# (d) Learned-dweight velocity trees (materialized tangent)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def learned4():
    return JVelCore(mid_chan=4).init(jax.random.key(5))


@pytest.fixture(scope="module")
def learned64():
    # key 6: with key 5, one pre-activation of this box lies within float32 rounding of
    # 0 and the port's float32 forward flips its LeakyReLU-tangent mask against a
    # float64 forward (vel max 0.0057, rms < 1e-3; JAX's rounds the other way):
    # ROADMAP.md's standing records
    return JVelCore(mid_chan=64).init(jax.random.key(6))


def _learned_layer(learned, block, layer):
    return learned["params"][block][layer]


@pytest.mark.parametrize("block,layer,kind,groups,shape", [
    ("conv_l1", "conv_0", "conv", 1, (1, 8, 9, 6, 8)),
    ("conv_l1", "skip", "skip", 1, (1, 5, 6, 4, 8)),
    ("down_l1", "conv_0", "down", 1, (1, 6, 8, 4, 8)),
    ("up_r1", "conv_0", "up", 1, (1, 3, 4, 3, 8)),
    ("conv_r1", "conv_0", "conv", 2, (1, 8, 9, 6, 8)),
    ("conv_r1", "skip", "skip", 2, (1, 5, 6, 4, 8)),
    ("conv_r01", "conv_1", "conv", 1, (1, 8, 9, 6, 8)),
])
@pytest.mark.parametrize("act", [False, True])
def test_learned_layer_matches_jax(learned4, block, layer, kind, groups, shape, act):
    p = _learned_layer(learned4, block, layer)
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(2 * groups)]
    jpp = jblocks.pack_conv_layer_params(p, kind, groups=groups, vel=True)
    tpp = tblocks.pack_conv_layer_params(params_from_jax(p), kind, groups=groups, vel=True)
    assert "g" not in tpp and "wcat" in tpp and ("wst" in tpp) == ("wst" in jpp and groups == 1)
    if groups == 1:
        ref = jblocks._apply_packed_vel(jpp, jnp.asarray(xs[0]), jnp.asarray(xs[1]), kind, act)
        got = tblocks._apply_packed_vel(tpp, torch.from_numpy(xs[0]), torch.from_numpy(xs[1]),
                                        kind, act)
    else:
        ref = jblocks._apply_packed_vel_cat(jpp, tuple(map(jnp.asarray, xs[:2])),
                                            tuple(map(jnp.asarray, xs[2:])), kind, act)
        got = tblocks._apply_packed_vel_cat(tpp, tuple(map(torch.from_numpy, xs[:2])),
                                            tuple(map(torch.from_numpy, xs[2:])), kind, act)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def test_learned_narrow_tail_takes_the_stacked_branch_mid64(learned64):
    """The 64 -> 3 tail (packed Cols 6 < 128) runs y and op(x, dW) as one
    Cols-stacked conv, as JAX's ``wst`` branch; the 128-wide convs carry the
    Winograd pieces of the concat weight."""
    p = learned64["params"]["conv_r01"]
    rng = np.random.default_rng(4)
    x, dx = (rng.standard_normal((1, 6, 7, 5, 128)).astype(np.float32) for _ in range(2))
    jpp = jblocks.pack_resnet_params(p, "CAC", vel=True)
    tpp = tblocks.pack_resnet_params(params_from_jax(p), "CAC", vel=True, wino=True)
    assert "wst" in tpp["conv_1"] and "wst" in jpp["conv_1"]
    assert "whcat" in tpp["conv_0"] and len(tpp["conv_0"]["whcat"]) == 2
    ref = jblocks._apply_packed_vel(jpp["conv_1"], jnp.asarray(x), jnp.asarray(dx), "conv")
    got = tblocks._apply_packed_vel(tpp["conv_1"], torch.from_numpy(x), torch.from_numpy(dx),
                                    "conv")
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4, atol=1e-5)


def _jax_learned_box(learned, mid, box, **cfg_kw):
    cfg = JConfig(**{**BASE, **cfg_kw}, dtype=jnp.float32, output_dtype=np.float32)
    return JProcessor(JVelCore(mid_chan=mid), learned, cfg).process_box(box, Z, OM)


@pytest.mark.parametrize("cfg_kw", [dict(), dict(packed=False), dict(y0_cache=True)])
def test_learned_vel_box_matches_jax_mid4(learned4, box, cfg_kw):
    out = _port_box(params_from_jax(learned4), 4, box, "vel", **cfg_kw)
    _close_box(out, _jax_learned_box(learned4, 4, box, **cfg_kw), True)


def test_learned_vel_box_matches_apply_mid4(learned4, box):
    """The packed runtime against the port's own unpacked forward on the
    wrap-padded box (``emu.apply``)."""
    emu = _port_emulator(params_from_jax(learned4), 4, "vel")
    d, v = emu.apply(_wrap_pad(torch.from_numpy(box)[None], 48), Z, OM)
    _close_box(emu.process_box(box, Z, OM), (d[0].numpy(), v[0].numpy()), True)


@pytest.fixture(scope="module")
def jax_learned64(learned64, box):
    return _jax_learned_box(learned64, 64, box)


def test_learned_vel_box_matches_jax_mid64(learned64, box, jax_learned64):
    disp, vel = _port_box(params_from_jax(learned64), 64, box, "vel")
    np.testing.assert_allclose(disp, np.asarray(jax_learned64[0]), rtol=2e-4, atol=2e-5)
    assert rms_ratio(vel, jax_learned64[1]) < 1e-3
    assert rel_max(vel, jax_learned64[1]) < 0.005


def test_learned_vel_box_wino_mid64(learned64, box, jax_learned64, monkeypatch):
    """With the Winograd kernel's plain version on: B1 three times a site, never B2."""
    singles, pairs = [], []
    plain, plain_pair = twino.conv3_packed_wino, twino.conv3_packed_wino_pair
    monkeypatch.setattr(winograd_cuda, "conv3_packed_wino",
                        lambda *a, **k: singles.append(1) or plain(*a, **k))
    monkeypatch.setattr(winograd_cuda, "conv3_packed_wino_pair",
                        lambda *a, **k: pairs.append(1) or plain_pair(*a, **k))
    disp, vel = _port_box(params_from_jax(learned64), 64, box, "vel", wino=True)
    assert len(singles) > 0 and not pairs
    assert len(singles) % 3 == 0
    assert np.isfinite(disp).all() and np.isfinite(vel).all()
    assert rel_max(disp, jax_learned64[0]) < 0.02
    assert rms_ratio(vel, jax_learned64[1]) < 0.08
