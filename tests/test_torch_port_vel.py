"""The PyTorch port's displacement+velocity path vs the JAX package, on the CPU.

The same seeded style tree (made by the JAX package, converted with
``params_from_jax``) and the same numpy inputs go through the JAX package and
the port.  Tolerances: rtol 1e-5 for the float32 fold (only summation order
differs); rtol 1e-4 / atol 1e-5 for single layers, blocks and the pair conv,
as the JAX package's own kernel tests; rtol 2e-4 / atol 2e-5 for whole
boxes, as ``tests/test_hierarchical.py``.  Velocities are compared in
displacement units, divided by ``vel_norm(z, Om)`` (~52 here): they are
vel_fac * d(disp)/dDz, so the same float32 reordering moves them ~52x more
in absolute terms.  Where the port runs the Winograd kernels (plain
versions on the CPU) the operands are bf16 by contract, so those
comparisons use the JAX package's gates for its kernel path
(``tests/test_pallas_conv.py``): displacement relative max error < 0.02, and
velocity std(v1 - v0) / std(v0) < 0.08, because the LeakyReLU tangent's
mask flips near zero under any bf16 perturbation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu import NBodyEmulatorVelCore as JVelCore
from jax_nbody_emulator_with_dj_tpu import StyleNBodyEmulatorCore as JStyleCore
from jax_nbody_emulator_with_dj_tpu.emulator import modulate_emulator_parameters_vel as jmod_vel
from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalConfig as JConfig
from jax_nbody_emulator_with_dj_tpu.hierarchical import HierarchicalProcessor as JProcessor
from jax_nbody_emulator_with_dj_tpu.models import blocks as jblocks
from jax_nbody_emulator_with_dj_tpu.ops import s2d as js2d
from jax_nbody_emulator_with_dj_tpu.ops import style as jstyle
from jax_nbody_emulator_with_dj_tpu.ops import winograd as jwino
from jax_nbody_emulator_with_dj_tpu.ops.conv3d import leaky_relu_with_tangent as j_lrt
from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalConfig, create_emulator
from jax_nbody_emulator_with_dj_tpu_torch.emulator import modulate_emulator_parameters_vel
from jax_nbody_emulator_with_dj_tpu_torch.hierarchical import _wrap_pad
from jax_nbody_emulator_with_dj_tpu_torch.models import blocks as tblocks
from jax_nbody_emulator_with_dj_tpu_torch.models.cores import NBodyEmulatorVelCore
from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d as ts2d
from jax_nbody_emulator_with_dj_tpu_torch.ops import style as tstyle
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd as twino
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd_cuda
from jax_nbody_emulator_with_dj_tpu_torch.ops.conv3d import leaky_relu_with_tangent
from jax_nbody_emulator_with_dj_tpu_torch.utils.params import params_from_jax

torch.set_num_threads(2)  # tier-1 runs several xdist workers

N = 16  # tiny box: slab 8, tiles 8^3, tile1 8
Z, OM = 0.5, 0.3175
VF = 51.74779427502384  # vel_norm(Z, OM)


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def close(port, ref, rtol=1e-4, atol=1e-5):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


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
# (a) The velocity fold and the factor recovery
# ---------------------------------------------------------------------------


def _style_layer(cin=6, cout=5, k=3):
    return {
        "weight": rnd(k, k, k, cin, cout, seed=3, scale=0.3),
        "bias": rnd(cout, seed=4, scale=0.1),
        "style_weight": rnd(cin, 2, seed=5),
        "style_bias": np.ones(cin, np.float32) + rnd(cin, seed=6, scale=0.1),
    }


@pytest.mark.parametrize("k", [1, 2, 3])
@pytest.mark.parametrize("first_layer", [False, True])
def test_premodulate_layer_vel(k, first_layer):
    layer = _style_layer(k=k)
    s = np.array([0.2, -0.3], np.float32)
    kw = dict(vel=True, first_layer=first_layer, factors=True)
    port = tstyle.premodulate_layer({key: T(v) for key, v in layer.items()}, T(s), **kw)
    ref = jstyle.premodulate_layer({key: jnp.asarray(v) for key, v in layer.items()},
                                   jnp.asarray(s), **kw)
    assert port.keys() == ref.keys()
    for key in ("weight", "dweight", "dfac_in", "dfac_out"):
        close(port[key], ref[key], rtol=1e-5, atol=1e-6)


def test_recover_dweight_factors_matches_jax():
    layer = _style_layer()
    s = np.array([0.2, -0.3], np.float32)
    folded = tstyle.premodulate_layer({key: T(v) for key, v in layer.items()}, T(s),
                                      vel=True, factors=True)
    g, c, ok = tstyle.recover_dweight_factors(folded["weight"], folded["dweight"])
    gj, cj, okj = jstyle.recover_dweight_factors(folded["weight"].numpy(),
                                                 folded["dweight"].numpy())
    assert ok and okj and g.dtype == np.float64
    np.testing.assert_allclose(g, gj, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(c, cj, rtol=1e-5, atol=1e-9)
    # the recovered factors are the fold's own, in the same gauge
    close(g, folded["dfac_in"], rtol=1e-4, atol=1e-5)
    close(c, folded["dfac_out"], rtol=1e-4, atol=1e-5)
    learned = rnd(*folded["weight"].shape, seed=9)
    assert not tstyle.recover_dweight_factors(folded["weight"], T(learned))[2]
    assert not jstyle.recover_dweight_factors(folded["weight"].numpy(), learned)[2]


@pytest.mark.parametrize("fold_factors", [True, False])
def test_pack_vel_factors_from_fold_or_recovered(fold_factors):
    """Packing takes the fold's dfac_in/dfac_out when the layer carries them
    and recovers them from dweight otherwise: the same g and packed c."""
    layer = {key: T(v) for key, v in _style_layer(cin=4, cout=4).items()}
    folded = tstyle.premodulate_layer(layer, T(np.array([0.2, -0.3], np.float32)),
                                      vel=True, factors=True)
    tree = folded if fold_factors else {k: folded[k] for k in ("weight", "bias", "dweight")}
    pp = tblocks.pack_conv_layer_params(tree, "conv", vel=True)
    assert pp["g"].dtype == pp["c"].dtype == torch.float32
    close(pp["g"], folded["dfac_in"], rtol=1e-4, atol=1e-5)
    close(pp["c"], ts2d.pack_bias(folded["dfac_out"]), rtol=1e-4, atol=1e-5)


def test_modulated_vel_tree_matches_jax(style4):
    port = modulate_emulator_parameters_vel(params_from_jax(style4), Z, OM)
    ref = jmod_vel(style4, Z, OM)["params"]
    for bname, block in port["params"].items():
        for lname, layer in block.items():
            assert layer.keys() == ref[bname][lname].keys()
            for key, v in layer.items():
                close(v, ref[bname][lname][key], rtol=1e-5, atol=1e-7)


def test_leaky_relu_with_tangent():
    x, dx = rnd(3, 4, 5), rnd(3, 4, 5, seed=1)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        y, dy = leaky_relu_with_tangent(T(x).to(dt), T(dx).to(dt))
        yj, dyj = j_lrt(jnp.asarray(x, jdt), jnp.asarray(dx, jdt))
        close(y.float(), np.asarray(yj, np.float32), rtol=0, atol=0)
        close(dy.float(), np.asarray(dyj, np.float32), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# (b) B2's plain version vs the JAX Pallas pair kernel (interpret mode)
# ---------------------------------------------------------------------------

C = 8  # unpacked channels: packed 16


def _pair_inputs(shape, dtype=np.float32):
    x, s = rnd(*shape, seed=7), rnd(*shape, seed=8)
    w = rnd(3, 3, 3, C, C, seed=9, scale=0.1)
    return x, s, w, rnd(C, seed=10, scale=0.1), rnd(2 * C, seed=11, scale=0.3)


def _jax_pair(x, s, w, b, c, leaky, dtype=jnp.float32):
    from jax_nbody_emulator_with_dj_tpu.ops.winograd_pallas import conv3d_wino_pallas_pair_packed

    wh = jwino.transform_packed_w3(js2d.pack_w3(jnp.asarray(w, dtype)))
    return conv3d_wino_pallas_pair_packed(
        js2d.pack(jnp.asarray(x, dtype)), js2d.pack(jnp.asarray(s, dtype)), wh,
        None if b is None else jnp.asarray(b), None if c is None else jnp.asarray(c),
        leaky=leaky, interpret=True, block=(4, 4, 8),
    )


def _port_pair(x, s, w, b, c, leaky, dtype=torch.float32):
    wh = twino.transform_packed_w3(ts2d.pack_w3(T(w).to(dtype)))  # rounded as _jax_pair's
    return winograd_cuda.conv3d_wino_pair_packed(
        ts2d.pack(T(x).to(dtype)), ts2d.pack(T(s).to(dtype)), wh,
        None if b is None else T(b), None if c is None else T(c), leaky=leaky,
    )


@pytest.mark.parametrize("leaky", [False, True])
@pytest.mark.parametrize("fold", [True, False])
def test_pair_plain_matches_jax_kernel(leaky, fold):
    """float32; ``fold=False`` is the raw per-part form (bias=None, c=None)."""
    x, s, w, b, c = _pair_inputs((1, 12, 15, 22, C))
    if not fold:
        b = c = None
    ref = _jax_pair(x, s, w, b, c, leaky)
    port = _port_pair(x, s, w, b, c, leaky)
    for got, want in zip(port, ref):
        assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
        close(got, want, rtol=1e-4, atol=1e-5)


def test_pair_plain_bf16_matches_jax_kernel():
    """bf16 operands and outputs: y to the kernel gate, dy in rms (the
    LeakyReLU pair's mask may flip where y rounds near 0)."""
    x, s, w, b, c = _pair_inputs((1, 10, 11, 16, C))
    yj, dyj = (np.asarray(t, np.float32) for t in _jax_pair(x, s, w, b, c, True, jnp.bfloat16))
    y, dy = _port_pair(x, s, w, b, c, True, torch.bfloat16)
    assert y.dtype == dy.dtype == torch.bfloat16
    assert rel_max(y.float().numpy(), yj) < 0.02
    assert rms_ratio(dy.float().numpy(), dyj) < 0.02


def test_pair_cpu_call_never_builds_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(winograd_cuda, "build", refuse)
    before = winograd_cuda.conv3d_wino_pair_packed.launches
    x, s, w, b, c = _pair_inputs((1, 6, 6, 10, C))
    y, dy = _port_pair(x, s, w, b, c, True)
    assert tuple(y.shape) == tuple(dy.shape) == (1, 4, 4, 4, 2 * C)
    assert winograd_cuda.conv3d_wino_pair_packed.launches == before


def test_pair_wrapper_rejects_what_the_kernel_does_not_take():
    xp = torch.zeros((1, 6, 6, 5, 128), dtype=torch.bfloat16, device="meta")
    wh = torch.zeros((4, 4, 2, 128, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):  # no kernel for this device
        winograd_cuda.conv3d_wino_pair_packed(xp, xp, wh)
    with pytest.raises(ValueError):  # shapes differ
        twino.conv3_packed_wino_pair(torch.zeros((1, 6, 6, 5, 16)), torch.zeros((1, 6, 6, 4, 16)),
                                     torch.zeros((4, 4, 2, 16, 16)))


# ---------------------------------------------------------------------------
# (c) Packed vel blocks vs the JAX packed vel blocks
# ---------------------------------------------------------------------------


def _block(style, name):
    return jmod_vel(style, Z, OM)["params"][name]


def _xp(shape, seed=5):
    x = rnd(*shape, seed=seed)
    return T(x), jnp.asarray(x)


def _close_pair(port, ref, **kw):
    for got, want in zip(port, ref):
        close(got, want, **kw)


def test_resnet_entry_vel_packed(style4):
    p = _block(style4, "conv_l00")
    xt, xj = _xp((1, 3, 12, 10, 14))
    ref = jblocks.apply_resnet_entry_vel_packed(
        jblocks.pack_resnet_entry_params(p, "CACA", vel=True), xj)
    port = tblocks.apply_resnet_entry_vel_packed(
        tblocks.pack_resnet_entry_params(params_from_jax(p), "CACA", vel=True), xt)
    _close_pair(port, ref)


@pytest.mark.parametrize("name,seq", [("conv_l1", "CACA"), ("conv_r01", "CAC")])
def test_resnet_block_vel_packed(style4, name, seq):
    p = _block(style4, name)
    (xt, xj), (dt, dj) = _xp((1, 10, 12, 7, 8), 5), _xp((1, 10, 12, 7, 8), 6)
    ref = jblocks.apply_resnet_block_vel_packed(
        jblocks.pack_resnet_params(p, seq, vel=True), xj, dj, seq)
    pp = tblocks.pack_resnet_params(params_from_jax(p), seq, vel=True)
    assert tuple(pp["conv_0"]["g"].shape) == (4,) and tuple(pp["conv_0"]["c"].shape) == (8,)
    _close_pair(tblocks.apply_resnet_block_vel_packed(pp, xt, dt, seq), ref)


def test_resnet_block_vel_packed_cat(style4):
    p = _block(style4, "conv_r00")
    parts = [_xp((1, 10, 12, 7, 8), seed) for seed in (5, 6, 7, 8)]
    (at, aj), (bt, bj), (dat, daj), (dbt, dbj) = parts
    ref = jblocks.apply_resnet_block_vel_packed_cat(
        jblocks.pack_resnet_params(p, "CACA", groups=2, vel=True), (aj, bj), (daj, dbj), "CACA")
    port = tblocks.apply_resnet_block_vel_packed_cat(
        tblocks.pack_resnet_params(params_from_jax(p), "CACA", groups=2, vel=True),
        (at, bt), (dat, dbt), "CACA")
    _close_pair(port, ref)


@pytest.mark.parametrize("name,seq", [("down_l1", "DA"), ("up_r1", "UA")])
def test_resample_block_vel_packed(style4, name, seq):
    p = _block(style4, name)
    (xt, xj), (dt, dj) = _xp((1, 6, 8, 4, 8), 5), _xp((1, 6, 8, 4, 8), 6)
    ref = jblocks.apply_resample_block_vel_packed(
        jblocks.pack_resample_params(p, seq, vel=True), xj, dj, seq)
    port = tblocks.apply_resample_block_vel_packed(
        tblocks.pack_resample_params(params_from_jax(p), seq, vel=True), xt, dt, seq)
    _close_pair(port, ref)


@pytest.mark.parametrize("dx", [False, True])
def test_resnet_block_vel_unpacked(style4, dx):
    """The model's own block: the first block (dx=None, NCDHW input) and an
    interior one."""
    p = _block(style4, "conv_l00" if not dx else "conv_l1")
    if dx:
        (xt, xj), (dt, dj) = _xp((1, 9, 8, 10, 4), 5), _xp((1, 9, 8, 10, 4), 6)
        ref = jblocks.apply_resnet_block_vel(p, xj, dj, "CACA")
        port = tblocks.apply_resnet_block_vel(params_from_jax(p), xt, dt, "CACA")
    else:
        xt, xj = _xp((1, 3, 9, 8, 10))
        ref = jblocks.apply_resnet_block_vel(p, xj, None, "CACA", in_fmt="NCDHW")
        port = tblocks.apply_resnet_block_vel(params_from_jax(p), xt, None, "CACA",
                                              in_fmt="NCDHW")
    _close_pair(port, ref)


def test_wino_pair_block_vel_packed_mid64(style64, monkeypatch):
    """At mid_chan=64 the 3x3x3 sites run B2's plain version (bf16 operands
    by contract): the decoder's per-part raw pairs and conv_1's pair."""
    calls = _count_pair_calls(monkeypatch)
    p = _block(style64, "conv_r1")
    parts = [_xp((1, 10, 10, 6, 128), seed) for seed in (5, 6, 7, 8)]
    (at, aj), (bt, bj), (dat, daj), (dbt, dbj) = parts
    ref = jblocks.apply_resnet_block_vel_packed_cat(
        jblocks.pack_resnet_params(p, "CACA", groups=2, vel=True), (aj, bj), (daj, dbj), "CACA")
    pp = tblocks.pack_resnet_params(params_from_jax(p), "CACA", groups=2, vel=True, wino=True)
    y, dy = tblocks.apply_resnet_block_vel_packed_cat(pp, (at, bt), (dat, dbt), "CACA")
    assert len(calls) == 3  # two raw parts of conv_0, then conv_1
    assert rel_max(y.numpy(), ref[0]) < 0.02
    assert rms_ratio(dy.numpy(), ref[1]) < 0.08


def _count_pair_calls(monkeypatch):
    calls = []
    plain = twino.conv3_packed_wino_pair

    def counting(*a, **k):
        calls.append(tuple(a[0].shape))
        return plain(*a, **k)

    monkeypatch.setattr(winograd_cuda, "conv3_packed_wino_pair", counting)
    return calls


# ---------------------------------------------------------------------------
# (d) The vel core's forward vs JAX, and the runtime vs the core
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def padded_box(box):
    return _wrap_pad(torch.from_numpy(box)[None], 48)


@pytest.fixture(scope="module")
def core_vel4(style4, padded_box):
    """The port's own vel forward on the wrap-padded box (mid_chan=4)."""
    emu = create_emulator(premodulate=True, compute_vel=True, params=params_from_jax(style4),
                          premodulate_z=Z, premodulate_Om=OM, mid_chan=4, device="cpu")
    return emu.apply(padded_box, Z, OM)


def test_vel_core_apply_matches_jax(style4, padded_box, core_vel4):
    from jax_nbody_emulator_with_dj_tpu import cosmology as jcosmo

    jp = jmod_vel(style4, Z, OM)
    dz, vf = jcosmo.growth_factor(Z, OM), jcosmo.vel_norm(Z, OM)
    ref = JVelCore(mid_chan=4).apply(jp, jnp.asarray(padded_box.numpy()), dz, vf)
    port = NBodyEmulatorVelCore(mid_chan=4).apply(
        modulate_emulator_parameters_vel(params_from_jax(style4), Z, OM), padded_box,
        torch.tensor(float(dz)), torch.tensor(float(vf)))
    assert port[0].shape == (1, 3, N, N, N)
    for got in (port, core_vel4):
        _close_box(got, ref)


def _close_box(port, ref):
    """(disp, vel) at the whole-box tolerance; vel in displacement units."""
    close(port[0], ref[0], rtol=2e-4, atol=2e-5)
    close(port[1] / VF, np.asarray(ref[1]) / VF, rtol=2e-4, atol=2e-5)


def test_vel_hierarchical_matches_model_forward(style4, box, core_vel4):
    _close_box(_port_box(style4, 4, box), (core_vel4[0][0], core_vel4[1][0]))


# ---------------------------------------------------------------------------
# (e) The slice: create_emulator(compute_vel=True).process_box vs JAX
# ---------------------------------------------------------------------------


def _jax_box(style, mid, box):
    cfg = JConfig(size=(N,) * 3, slab=8, tile=(8, 8, 8), dtype=jnp.float32,
                  output_dtype=np.float32)
    return JProcessor(JVelCore(mid_chan=mid), jmod_vel(style, Z, OM), cfg).process_box(box, Z, OM)


def _port_box(style, mid, box, wino=None, **cfg_kw):
    cfg = HierarchicalConfig(**{**dict(size=(N,) * 3, slab=8, tile=(8, 8, 8)), **cfg_kw},
                             dtype=torch.float32, output_dtype=torch.float32, wino=wino)
    emu = create_emulator(premodulate=True, compute_vel=True, params=params_from_jax(style),
                          premodulate_z=Z, premodulate_Om=OM, processor_config=cfg,
                          mid_chan=mid, device="cpu")
    return emu.process_box(box, Z, OM)


def test_vel_slice_matches_jax_mid4(style4, box):
    ref = _jax_box(style4, 4, box)
    out = _port_box(style4, 4, box)
    for got in out:
        assert got.shape == (3, N, N, N) and got.dtype == np.float32
    _close_box(out, ref)


def test_vel_slice_invariant_to_slab_and_tiles(style4, box):
    a = _port_box(style4, 4, box)
    b = _port_box(style4, 4, box, slab=16, slab_h=8, tile=(16, 16, 8))
    np.testing.assert_allclose(a[0], b[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a[1] / VF, b[1] / VF, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_box_vel64(style64, box):
    return _jax_box(style64, 64, box)


def test_vel_slice_matches_jax_mid64(style64, box, jax_box_vel64):
    """Disp at the box tolerance.  Vel in rms and max: at mid_chan=64 one
    pre-activation of this box lies within float32 rounding of 0, and the
    JAX runtime's LeakyReLU tangent mask there differs from the JAX model's
    own forward (one voxel moves by 0.0019 of max |vel|, rms 1.2e-4), while
    the port's runtime agrees with the JAX model to 1e-6 at that voxel."""
    disp, vel = _port_box(style64, 64, box, wino=False)
    close(disp, jax_box_vel64[0], rtol=2e-4, atol=2e-5)
    assert rms_ratio(vel, jax_box_vel64[1]) < 1e-3
    assert rel_max(vel, jax_box_vel64[1]) < 0.005


def test_vel_slice_wino_matches_jax_mid64(style64, box, jax_box_vel64, monkeypatch):
    calls = _count_pair_calls(monkeypatch)
    disp, vel = _port_box(style64, 64, box, wino=True)
    assert len(calls) > 0  # the pair sites ran (B2's plain version on the CPU)
    assert np.isfinite(disp).all() and np.isfinite(vel).all()
    assert rel_max(disp, jax_box_vel64[0]) < 0.02
    assert rms_ratio(vel, jax_box_vel64[1]) < 0.08
