"""The weight layout of the redesigned Winograd kernels B1/B2, on the CPU.

The CUDA kernel (``csrc/wino_f23.cu``) reads its transformed weights as 8 KB
pieces that ``ops/winograd_cuda.py::tile_wh`` cuts from
``transform_packed_w3``'s (4, 4, 2, C2, F2) output.  Here: the re-tile is a
permutation (plus zero columns up to a multiple of 128) that round-trips bit
for bit; weights packed by the model (``pack_conv_layer_params(wino=True)``)
drive the wrappers' CPU route to the JAX package's Pallas kernel in interpret
mode (rtol 1e-4 / atol 1e-5, the tolerance ``test_torch_port_ops.py`` states
for the same comparison); and a pair site wider than the JAX package's
``_PAIR_W_MAX`` (where the port has no threshold any more) agrees with the JAX
package's ``_wino_conv_pair`` in float32 at the same tolerance.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu.models import blocks as jblocks
from jax_nbody_emulator_with_dj_tpu.ops import s2d as js2d
from jax_nbody_emulator_with_dj_tpu.ops import winograd as jwino
from jax_nbody_emulator_with_dj_tpu.ops import winograd_pallas as jpallas
from jax_nbody_emulator_with_dj_tpu_torch.models import blocks as tblocks
from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d as ts2d
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd as twino
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd_cuda
from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd_cuda import TiledWh, tile_wh


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def J(a):
    return jnp.asarray(np.asarray(a))


@pytest.mark.parametrize("c2", [128, 192, 256])
@pytest.mark.parametrize("f2", [128, 192, 256, 136])
def test_tile_wh_round_trips_bit_for_bit(c2, f2):
    wh = twino.transform_packed_w3(T(rnd(3, 3, 2, c2, f2, seed=c2 + f2))).to(torch.bfloat16)
    tiled = tile_wh(wh)
    nb = -(-f2 // 128)
    assert tuple(tiled.tiles.shape) == (nb, c2 // 32, 16, 2, 4, 128, 8)
    assert tiled.tiles.is_contiguous() and tiled.tiles.dtype == torch.bfloat16
    assert tuple(tiled.shape) == (4, 4, 2, c2, f2) and tiled.f2 == f2
    assert torch.equal(tiled.untiled(), wh)
    # a permutation: every weight appears once, the rest is the zero padding
    assert tiled.tiles.numel() == wh.numel() // f2 * nb * 128
    srt = tiled.tiles.flatten().view(torch.int16).sort().values
    ref = torch.cat([wh.flatten().view(torch.int16),
                     torch.zeros(tiled.tiles.numel() - wh.numel(), dtype=torch.int16)])
    assert torch.equal(srt, ref.sort().values)


@pytest.mark.parametrize("c2,f2", [(128, 128), (256, 136), (64, 192)])
def test_tile_wh_element_map(c2, f2):
    """tiles[nb, g, p, t, q, f, e] = wh[p // 4, p % 4, t, 32 g + 8 q + e, 128 nb + f]."""
    wh = T(rnd(4, 4, 2, c2, f2, seed=5))
    tiles = tile_wh(wh).tiles
    rng = np.random.default_rng(6)
    for _ in range(200):
        nb, g, p, t, q, f, e = (int(rng.integers(n)) for n in tiles.shape)
        col = 128 * nb + f
        want = wh[p // 4, p % 4, t, 32 * g + 8 * q + e, col] if col < f2 else 0.0
        assert tiles[nb, g, p, t, q, f, e] == want


def test_tile_wh_is_idempotent_and_checks_its_input():
    wh = T(rnd(4, 4, 2, 64, 72, seed=7))
    tiled = tile_wh(wh)
    assert tile_wh(tiled) is tiled
    assert tiled.dim() == 5 and tiled.device == wh.device and tiled.dtype == wh.dtype
    with pytest.raises(ValueError):
        tile_wh(wh[:, :, :, :48])  # C2 % 32
    with pytest.raises(ValueError):
        tile_wh(wh[0])
    with pytest.raises(ValueError):
        TiledWh(tiled.tiles, 129)  # more columns than the tiles hold
    with pytest.raises(ValueError):
        TiledWh(tiled.tiles[..., :4], 72)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("pair", [False, True])
def test_wrappers_take_tiled_weights_on_the_cpu(tiled, pair):
    """The CPU route un-tiles: tiled and untiled weights give the same bits."""
    xp, sp = T(rnd(1, 7, 8, 6, 64, seed=8)), T(rnd(1, 7, 8, 6, 64, seed=9))
    wh = twino.transform_packed_w3(ts2d.pack_w3(T(rnd(3, 3, 3, 32, 20, seed=10, scale=0.1))))
    b, c = T(rnd(20, seed=11, scale=0.1)), T(rnd(40, seed=12, scale=0.3))
    w_arg = tile_wh(wh) if tiled else wh
    if pair:
        got = winograd_cuda.conv3d_wino_pair_packed(xp, sp, w_arg, b, c, leaky=True)
        ref = twino.conv3_packed_wino_pair(xp, sp, wh, b, c, leaky=True)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    else:
        got = winograd_cuda.conv3d_wino_packed(xp, w_arg, b, leaky=True)
        assert torch.equal(got, twino.conv3_packed_wino(xp, wh, b, leaky=True))


@pytest.mark.parametrize("shape", [(1, 10, 10, 8), (1, 12, 15, 11)])
@pytest.mark.parametrize("act", [False, True])
def test_packed_wino_weights_match_jax_kernel(shape, act):
    """``pack_conv_layer_params(wino=True)`` yields the tiled weights; the CPU
    route with them equals the Pallas kernel in interpret mode."""
    ci = co = 64  # packed 128 -> 128: the narrowest Winograd-eligible site
    w, b = rnd(3, 3, 3, ci, co, seed=13, scale=0.05), rnd(co, seed=14, scale=0.1)
    x = rnd(*shape[:3], 2 * shape[3], ci, seed=15)
    pp = tblocks.pack_conv_layer_params({"weight": T(w), "bias": T(b)}, "conv", wino=True)
    assert isinstance(pp["wh"], TiledWh) and tuple(pp["wh"].shape) == (4, 4, 2, 128, 128)
    assert pp["wh"].dtype == torch.bfloat16
    wh_j = jwino.transform_packed_w3(js2d.pack_w3(J(w))).astype(jnp.bfloat16)
    ref = jpallas.conv3d_wino_pallas_packed(
        js2d.pack(J(x)).astype(jnp.bfloat16), wh_j, J(b), leaky=act, interpret=True,
        block=(4, 4, 8), out_dtype=jnp.float32,
    )
    port = tblocks._apply_packed(pp, ts2d.pack(T(x)), "conv", act=act)  # float32 in and out
    assert port.dtype == torch.float32 and tuple(port.shape) == tuple(ref.shape)
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("act", [False, True])
@pytest.mark.parametrize("fold", [False, True])
def test_wide_pair_site_matches_jax(monkeypatch, act, fold):
    """A pair site of packed-W output width 100 > 96: the JAX package runs two
    single kernels and folds c outside, the port runs the pair form; float32,
    so both fold the same float32 values.  (The Pallas kernel runs in
    interpret mode here, as in the JAX package's own CPU tests.)"""
    monkeypatch.setattr(
        jpallas, "conv3d_wino_pallas_packed",
        functools.partial(jpallas.conv3d_wino_pallas_packed, interpret=True, block=(4, 4, 8)))
    ci = co = 64
    shape = (1, 6, 6, 101, 2 * ci)
    assert shape[3] - 1 > jblocks._PAIR_W_MAX
    w = rnd(3, 3, 3, ci, co, seed=16, scale=0.05)
    xp, sp = rnd(*shape, seed=17), rnd(*shape, seed=18)
    b = rnd(2 * co, seed=19, scale=0.1) if fold else None
    c = rnd(2 * co, seed=20, scale=0.3) if fold else None
    wh_j = jwino.transform_packed_w3(js2d.pack_w3(J(w))).astype(jnp.bfloat16)
    y_ref, dy_ref = jblocks._wino_conv_pair(
        J(xp), J(sp), wh_j, None if b is None else J(b), None if c is None else J(c), act)
    wh_t = tile_wh(twino.transform_packed_w3(ts2d.pack_w3(T(w))).to(torch.bfloat16))
    y, dy = tblocks._wino_conv_pair(
        T(xp), T(sp), wh_t, None if b is None else T(b), None if c is None else T(c), act)
    assert y.dtype == dy.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4, atol=1e-5)
    # dy's LeakyReLU slope follows the sign of y: compare where both agree on it
    agree = (y.numpy() > 0) == (np.asarray(y_ref) > 0)
    assert agree.mean() > 1 - 1e-4
    np.testing.assert_allclose(np.where(agree, dy.numpy(), 0.0),
                               np.where(agree, np.asarray(dy_ref), 0.0), rtol=1e-4, atol=1e-5)
