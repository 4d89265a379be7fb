"""The PyTorch port's ops held against the JAX package, on the CPU.

Each test feeds the same numpy inputs (seeded) to a JAX package function and
to its port counterpart in ``jax_nbody_emulator_with_dj_tpu_torch`` and
compares in float32.  Tolerances: exact equality for the weight packers
(pure index moves); rtol 1e-5 for float32 math that only reorders sums
(JAX runs at ``highest`` matmul precision, see conftest); rtol 1e-4 / atol
1e-5 for the Winograd conv, as the JAX package's own kernel tests.

The CUDA kernel itself is tested on a card by ``test_torch_port_cuda.py``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu import cosmology as jcosmo
from jax_nbody_emulator_with_dj_tpu.ops import s2d as js2d
from jax_nbody_emulator_with_dj_tpu.ops import style as jstyle
from jax_nbody_emulator_with_dj_tpu.ops import winograd as jwino
from jax_nbody_emulator_with_dj_tpu_torch import cosmology as tcosmo
from jax_nbody_emulator_with_dj_tpu_torch.ops import conv3d as tconv
from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d as ts2d
from jax_nbody_emulator_with_dj_tpu_torch.ops import style as tstyle
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd as twino
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd_cuda

# ``ops/__init__`` re-exports a function named conv3d over the module.
jconv = importlib.import_module("jax_nbody_emulator_with_dj_tpu.ops.conv3d")

torch.set_num_threads(2)  # tier-1 runs several xdist workers


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


def close(port, ref, rtol=1e-5, atol=1e-5):
    port = port.detach().numpy() if torch.is_tensor(port) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Cosmology
# ---------------------------------------------------------------------------

COSMO_POINTS = [(0.0, 0.3175), (0.5, 0.3), (1.0, 0.25), (2.0, 0.2), (3.0, 0.5), (127.0, 0.3175)]


@pytest.mark.parametrize("fn", ["growth_factor", "growth_rate", "hubble_rate", "dlogH_dloga", "vel_norm"])
@pytest.mark.parametrize("z,Om", COSMO_POINTS)
def test_cosmology_matches_jax(fn, z, Om):
    port = getattr(tcosmo, fn)(z, Om)
    ref = float(getattr(jcosmo, fn)(z, Om))
    np.testing.assert_allclose(port, ref, rtol=2e-6)


def test_cosmology_anchors():
    """D(0, Om) = 1; f(0, 0.3175) ~ 0.53; Om -> 1 gives D = 1/(1+z), f = 1."""
    assert tcosmo.growth_factor(0.0, 0.3) == pytest.approx(1.0, abs=1e-12)
    assert tcosmo.growth_rate(0.0, 0.3175) == pytest.approx(0.53, abs=5e-3)
    z = np.array([0.0, 0.5, 2.0, 10.0])
    np.testing.assert_allclose(tcosmo.growth_factor(z, 1.0 - 1e-9), 1.0 / (1.0 + z), rtol=1e-7)
    np.testing.assert_allclose(tcosmo.growth_rate(z, 1.0 - 1e-9), 1.0, rtol=1e-7)


def test_cosmology_broadcasts():
    z = np.array([0.0, 1.0, 2.0])
    om = np.array([0.2, 0.3, 0.4])
    np.testing.assert_allclose(tcosmo.vel_norm(z, om), np.asarray(jcosmo.vel_norm(J(z), J(om))), rtol=2e-6)


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("in_fmt,out_fmt", [("NDHWC", "NDHWC"), ("NCDHW", "NDHWC"), ("NDHWC", "NCDHW")])
def test_conv3d(in_fmt, out_fmt):
    x = rnd(2, 7, 6, 8, 5) if in_fmt == "NDHWC" else rnd(2, 5, 7, 6, 8)
    w = rnd(3, 3, 3, 5, 4, seed=1, scale=0.2)
    close(tconv.conv3d(T(x), T(w), in_fmt=in_fmt, out_fmt=out_fmt),
          jconv.conv3d(J(x), J(w), in_fmt=in_fmt, out_fmt=out_fmt))


@pytest.mark.parametrize("in_fmt,out_fmt", [("NDHWC", "NDHWC"), ("NCDHW", "NDHWC"), ("NDHWC", "NCDHW")])
def test_conv1x1(in_fmt, out_fmt):
    x = rnd(1, 4, 5, 6, 3) if in_fmt == "NDHWC" else rnd(1, 3, 4, 5, 6)
    w = rnd(1, 1, 1, 3, 7, seed=1)
    close(tconv.conv1x1(T(x), T(w), in_fmt=in_fmt, out_fmt=out_fmt),
          jconv.conv1x1(J(x), J(w), in_fmt=in_fmt, out_fmt=out_fmt))


def test_conv_down2():
    x, w = rnd(2, 6, 4, 8, 5), rnd(2, 2, 2, 5, 3, seed=1)
    close(tconv.conv_down2(T(x), T(w)), jconv.conv_down2(J(x), J(w)))


def test_conv_up2_matches_dilated_conv():
    x, w = rnd(1, 3, 4, 5, 6), rnd(2, 2, 2, 6, 4, seed=1)
    ref = jconv.conv3d_up(J(x), J(w))
    close(tconv.conv_up2(T(x), T(w)), ref)
    close(tconv.conv_up2(T(x), T(w)), jconv.conv_up2(J(x), J(w)))


def test_leaky_relu():
    x = rnd(3, 4, 5)
    close(tconv.leaky_relu(T(x)), jconv.leaky_relu(J(x)), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Style and the premodulation fold
# ---------------------------------------------------------------------------


def _style_layer(cin=6, cout=5, k=3):
    return {
        "weight": rnd(k, k, k, cin, cout, seed=3, scale=0.3),
        "bias": rnd(cout, seed=4, scale=0.1),
        "style_weight": rnd(cin, 2, seed=5),
        "style_bias": np.ones(cin, np.float32) + rnd(cin, seed=6, scale=0.1),
    }


def test_style_vector_and_modulation():
    s_t = tstyle.style_vector([0.3175, 0.25], [0.8, 0.6])
    s_j = jstyle.style_vector(J([0.3175, 0.25]), J([0.8, 0.6]))
    close(s_t, s_j, rtol=0, atol=1e-7)
    layer = _style_layer()
    m_t, n_t = tstyle.style_modulation({k: T(v) for k, v in layer.items()}, s_t)
    m_j, n_j = jstyle.style_modulation({k: J(v) for k, v in layer.items()}, s_j)
    close(m_t, m_j, rtol=1e-6)
    close(n_t, n_j, rtol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_premodulate_layer(k):
    layer = _style_layer(k=k)
    s = np.array([0.2, -0.3], np.float32)
    port = tstyle.premodulate_layer({key: T(v) for key, v in layer.items()}, T(s))
    ref = jstyle.premodulate_layer({key: J(v) for key, v in layer.items()}, J(s))
    close(port["weight"], ref["weight"], rtol=1e-6, atol=1e-7)
    close(port["bias"], ref["bias"], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Space-to-depth packers and packed ops
# ---------------------------------------------------------------------------


def test_pack_unpack_roundtrip():
    x = rnd(2, 3, 4, 6, 5)
    close(ts2d.pack(T(x)), js2d.pack(J(x)), rtol=0, atol=0)
    close(ts2d.unpack(ts2d.pack(T(x))), x, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["pack_w3", "pack_w1", "pack_w_down", "pack_w_up"])
@pytest.mark.parametrize("groups", [1, 2])
def test_weight_packers_exact(name, groups):
    k = {"pack_w3": 3, "pack_w1": 1, "pack_w_down": 2, "pack_w_up": 2}[name]
    w = rnd(k, k, k, 8, 6, seed=2)
    close(getattr(ts2d, name)(T(w), groups), getattr(js2d, name)(J(w), groups), rtol=0, atol=0)


def test_entry_packers_exact():
    w3, w1, b = rnd(3, 3, 3, 3, 4, seed=2), rnd(1, 1, 1, 3, 4, seed=3), rnd(4, seed=4)
    close(ts2d.pack_w3_entry(T(w3)), js2d.pack_w3_entry(J(w3)), rtol=0, atol=0)
    close(ts2d.entry_cols(ts2d.pack_w3_entry(T(w3))), js2d.entry_cols(js2d.pack_w3_entry(J(w3))),
          rtol=0, atol=0)
    close(ts2d.pack_w1_entry(T(w1)), js2d.pack_w1_entry(J(w1)), rtol=0, atol=0)
    close(ts2d.pack_bias(T(b)), js2d.pack_bias(J(b)), rtol=0, atol=0)


def test_conv3_packed():
    x, w = rnd(1, 7, 6, 10, 4), rnd(3, 3, 3, 4, 3, seed=1, scale=0.3)
    port = ts2d.conv3_packed(ts2d.pack(T(x)), ts2d.oidhw_w3(ts2d.pack_w3(T(w))))
    close(port, js2d.conv3_packed(js2d.pack(J(x)), js2d.pack_w3(J(w))))
    close(ts2d.unpack(port), jconv.conv3d(J(x), J(w)))


def test_conv1_down_up_packed():
    x = rnd(1, 4, 6, 8, 4)
    w1, wd, wu = rnd(1, 1, 1, 4, 3, seed=1), rnd(2, 2, 2, 4, 3, seed=2), rnd(2, 2, 2, 4, 3, seed=3)
    xp_t, xp_j = ts2d.pack(T(x)), js2d.pack(J(x))
    close(ts2d.conv1_packed(xp_t, ts2d.pack_w1(T(w1))), js2d.conv1_packed(xp_j, js2d.pack_w1(J(w1))))
    close(ts2d.down_packed(xp_t, ts2d.pack_w_down(T(wd))),
          js2d.down_packed(xp_j, js2d.pack_w_down(J(wd))))
    close(ts2d.up_packed(xp_t, ts2d.pack_w_up(T(wu))), js2d.up_packed(xp_j, js2d.pack_w_up(J(wu))))


def test_entry_convs_and_unpack_to_ncdhw():
    x = rnd(1, 3, 7, 6, 10)
    w3, w1 = rnd(3, 3, 3, 3, 4, seed=1, scale=0.3), rnd(1, 1, 1, 3, 4, seed=2)
    port = ts2d.conv3_entry_im2col(T(x), ts2d.entry_cols(ts2d.pack_w3_entry(T(w3))))
    ref = js2d.conv3_entry_im2col(J(x), js2d.entry_cols(js2d.pack_w3_entry(J(w3))))
    close(port, ref)
    close(ts2d.conv1_entry_packed(T(x), ts2d.pack_w1_entry(T(w1))),
          js2d.conv1_entry_packed(J(x), js2d.pack_w1_entry(J(w1))))
    close(ts2d.unpack_to_ncdhw(port), js2d.unpack_to_ncdhw(ref))


def test_transform_packed_w3():
    wp = js2d.pack_w3(J(rnd(3, 3, 3, 8, 8, seed=5)))
    close(twino.transform_packed_w3(T(wp)), jwino.transform_packed_w3(wp), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# B1: the Winograd conv's plain version vs the JAX Pallas kernel (interpret)
# ---------------------------------------------------------------------------

C = 64


@pytest.mark.parametrize("shape", [(1, 10, 10, 16, C), (1, 12, 15, 22, C)])
@pytest.mark.parametrize("bias_leaky", [True, False])
def test_wino_plain_matches_jax_kernel(shape, bias_leaky):
    from jax_nbody_emulator_with_dj_tpu.ops.winograd_pallas import conv3d_wino_pallas_packed

    x = rnd(*shape, seed=7)
    w = rnd(3, 3, 3, C, C, seed=8, scale=0.05)
    b = rnd(C, seed=9, scale=0.1) if bias_leaky else None
    wh_j = jwino.transform_packed_w3(js2d.pack_w3(J(w)))
    ref = conv3d_wino_pallas_packed(
        js2d.pack(J(x)), wh_j, None if b is None else J(b),
        leaky=bias_leaky, interpret=True, block=(4, 4, 8),
    )
    wh_t = twino.transform_packed_w3(ts2d.pack_w3(T(w)))
    port = winograd_cuda.conv3d_wino_packed(
        ts2d.pack(T(x)), wh_t, None if b is None else T(b), leaky=bias_leaky
    )
    assert tuple(port.shape) == tuple(ref.shape)
    close(port, ref, rtol=1e-4, atol=1e-5)


def test_wino_plain_bf16_rounds_like_kernel_contract():
    """bf16 operands: error vs the float32 direct conv stays bf16-sized."""
    x, w = rnd(1, 8, 9, 6, 16, seed=10), rnd(3, 3, 3, 16, 8, seed=11, scale=0.1)
    wh = twino.transform_packed_w3(ts2d.pack_w3(T(w))).to(torch.bfloat16)
    got = twino.conv3_packed_wino(ts2d.pack(T(x)).to(torch.bfloat16), wh, out_dtype=torch.float32)
    ref = np.asarray(js2d.conv3_packed(js2d.pack(J(x)), js2d.pack_w3(J(w))))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < 0.03


def test_cpu_call_never_builds_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA build")

    monkeypatch.setattr(winograd_cuda, "build", refuse)
    before = winograd_cuda.conv3d_wino_packed.launches
    xp = T(rnd(1, 6, 6, 5, 16))
    wh = twino.transform_packed_w3(ts2d.pack_w3(T(rnd(3, 3, 3, 8, 8, seed=1))))
    y = winograd_cuda.conv3d_wino_packed(xp, wh, leaky=True)
    assert tuple(y.shape) == (1, 4, 4, 4, 16)
    assert winograd_cuda._lib is None
    assert winograd_cuda.conv3d_wino_packed.launches == before


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    xp = torch.zeros((1, 6, 6, 5, 128), dtype=torch.bfloat16)
    wh = torch.zeros((4, 4, 2, 128, 128), dtype=torch.bfloat16)
    winograd_cuda._check(xp, wh, torch.bfloat16)  # accepted shape
    with pytest.raises(TypeError):
        winograd_cuda._check(xp.float(), wh, torch.bfloat16)
    with pytest.raises(TypeError):
        winograd_cuda._check(xp, wh, torch.float16)
    with pytest.raises(ValueError):
        winograd_cuda._check(xp[..., :64], wh, torch.bfloat16)
    with pytest.raises(ValueError):
        winograd_cuda._check(xp, wh[..., :76].contiguous(), torch.bfloat16)  # F2 % 8
    with pytest.raises(ValueError):
        winograd_cuda._check(xp[..., :48], wh[:, :, :, :48].contiguous(), torch.bfloat16)  # C2 % 32
    with pytest.raises(ValueError):
        winograd_cuda._check(xp, wh[..., :72], torch.bfloat16)  # not contiguous
    with pytest.raises(ValueError):
        winograd_cuda._check(torch.zeros((1, 6, 6, 5, 130), dtype=torch.bfloat16)[..., :128],
                             wh, torch.bfloat16)  # 16-byte rows broken
    with pytest.raises(ValueError):
        winograd_cuda.conv3d_wino_packed(xp.to("meta"), wh.to("meta"))
