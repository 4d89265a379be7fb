"""The weight layouts of the redesigned conv kernels B4, B5 and B3, on the CPU.

The CUDA kernels read their weights as 8 KB pieces laid out as ``wgmma`` reads
them: B5 (``csrc/stripe_conv.cu``) and B4 (``csrc/direct_conv.cu``) the packed
direct-conv kernel cut by ``ops/direct_conv_cuda.py::tile_wp`` into (column
block, kd, channel group, tap) pieces (B5 runs them in that order, B4 with the
channel group outermost), B3 (``csrc/wino_f43.cu``) the mixed
Winograd weights cut by ``ops/winograd43_cuda.py::tile_what`` into (column
block of 64, channel group, point) pieces holding both packed-W taps.  Here:
each re-tile is a permutation (plus zero columns up to the column block) that
round-trips bit for bit and matches its element map written out by hand; it
is idempotent and rejects what it cannot cut; the wrappers take tiled weights
on the CPU and give the plain version's bits; and tiled mixed weights still
drive the CPU route to the JAX package's Pallas kernel in interpret mode
(rtol 2e-4 / atol 2e-5, the tolerance ``test_torch_port_convs.py`` states for
the same comparison).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu.ops.winograd43_pallas import conv3d_wino43_pallas
from jax_nbody_emulator_with_dj_tpu_torch.ops import direct_conv as tdirect
from jax_nbody_emulator_with_dj_tpu_torch.ops import direct_conv_cuda as tdc
from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d as ts2d
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd as twino
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd43_cuda as tw43
from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd_cuda import TiledWh, tile_wh

SHAPES = [(128, 128), (256, 128), (320, 72), (128, 136), (32, 8), (512, 256)]


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def _is_permutation_plus_zeros(tiles, w):
    """Every weight appears once in ``tiles``; the rest is the zero padding."""
    srt = tiles.flatten().view(torch.int16).sort().values
    ref = torch.cat([w.flatten().view(torch.int16),
                     torch.zeros(tiles.numel() - w.numel(), dtype=torch.int16)])
    return torch.equal(srt, ref.sort().values)


# ---------------------------------------------------------------------------
# B5: tile_wp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,co", SHAPES)
def test_tile_wp_round_trips_bit_for_bit(c, co):
    wp = T(rnd(3, 3, 2, c, co, seed=c + co)).to(torch.bfloat16)
    tiled = tdc.tile_wp(wp)
    nb = -(-co // 128)
    assert tuple(tiled.tiles.shape) == (nb, 3, c // 32, 6, 4, 128, 8)
    assert tiled.tiles.is_contiguous() and tiled.tiles.dtype == torch.bfloat16
    assert tuple(tiled.shape) == (3, 3, 2, c, co) and tiled.co == co and tiled.dim() == 5
    assert torch.equal(tiled.untiled(), wp)
    assert tiled.tiles.numel() == wp.numel() // co * nb * 128
    assert _is_permutation_plus_zeros(tiled.tiles, wp)


@pytest.mark.parametrize("c,co", SHAPES)
def test_tile_wp_element_map(c, co):
    """tiles[nb, kd, g, k, q, f, e] = wp[kd, k // 2, k % 2, 32 g + 8 q + e, 128 nb + f]: a
    piece is one (kd, group, kh, ka), in the order the kernel's taps run."""
    wp = T(rnd(3, 3, 2, c, co, seed=5))
    tiles = tdc.tile_wp(wp).tiles
    rng = np.random.default_rng(6)
    for _ in range(200):
        nb, kd, g, k, q, f, e = (int(rng.integers(n)) for n in tiles.shape)
        col = 128 * nb + f
        want = wp[kd, k // 2, k % 2, 32 * g + 8 * q + e, col] if col < co else 0.0
        assert tiles[nb, kd, g, k, q, f, e] == want


def test_tile_wp_is_idempotent_and_checks_its_input():
    wp = T(rnd(3, 3, 2, 64, 72, seed=7))
    tiled = tdc.tile_wp(wp)
    assert tdc.tile_wp(tiled) is tiled
    assert tiled.device == wp.device and tiled.dtype == wp.dtype and tiled.is_contiguous()
    assert tiled.data_ptr() == tiled.tiles.data_ptr()
    with pytest.raises(ValueError):
        tdc.tile_wp(wp[:, :, :, :48])  # C % 32
    with pytest.raises(ValueError):
        tdc.tile_wp(wp[0])
    with pytest.raises(ValueError):
        tdc.tile_wp(T(rnd(4, 4, 2, 64, 72)))  # Winograd weights are not a packed kernel
    with pytest.raises(ValueError):
        tdc.TiledWp(tiled.tiles, 129)  # more columns than the tiles hold
    with pytest.raises(ValueError):
        tdc.TiledWp(tiled.tiles[..., :4], 72)
    with pytest.raises(ValueError, match="square"):  # B4 takes the same pieces, of a square kernel
        tdc.conv3d_direct_packed(torch.zeros((1, 6, 6, 5, 64)), tiled)


@pytest.mark.parametrize("cins,co", [((64,), 64), ((32, 64), 72), ((32, 64, 128, 96), 8)])
@pytest.mark.parametrize("tiled", [False, True])
def test_stripe_wrapper_takes_tiled_weights_on_the_cpu(cins, co, tiled):
    """The CPU route un-tiles: tiled and plain weights give the plain version's bits."""
    xps = tuple(T(rnd(1, 6, 7, 5, ci, seed=8 + i)) for i, ci in enumerate(cins))
    wp = T(rnd(3, 3, 2, sum(cins), co, seed=12, scale=0.05))
    bp = T(rnd(co, seed=13, scale=0.1))
    got = tdc.conv3_packed_stripe(xps, tdc.tile_wp(wp) if tiled else wp, bp, leaky=True)
    assert torch.equal(got, tdirect.conv3_packed_taps(xps, wp, bp, leaky=True))
    assert tdc.conv3_packed_stripe.launches == 0


@pytest.mark.parametrize("shape,c2", [((1, 6, 7, 5), 64), ((2, 5, 9, 4), 128), ((1, 4, 4, 3), 320)])
@pytest.mark.parametrize("use_bias,leaky", [(True, True), (False, False)])
def test_direct_wrapper_takes_tiled_weights_on_the_cpu(shape, c2, use_bias, leaky):
    """B4 reads B5's pieces: on the CPU tiled and plain weights give the plain version's bits."""
    xp = T(rnd(*shape, c2, seed=14))
    wp = T(rnd(3, 3, 2, c2, c2, seed=15, scale=0.05))
    b = T(rnd(c2 // 2, seed=16, scale=0.1)) if use_bias else None
    got = tdc.conv3d_direct_packed(xp, tdc.tile_wp(wp), b, leaky=leaky)
    assert torch.equal(got, tdc.conv3d_direct_packed(xp, wp, b, leaky=leaky))
    bp = None if b is None else ts2d.pack_bias(b)
    assert torch.equal(got, tdirect.conv3_packed_taps(xp, wp, bp, leaky=leaky))
    assert tdc.conv3d_direct_packed.launches == 0


def test_direct_piece_order_is_group_outermost():
    """B4's producer walks (group, kd, kh * 2 + ka) over ``tile_wp``'s (column block, kd,
    group, tap) pieces: piece ((nb * 3 + kd) * G + g) * 6 + k of the flat tensor, the six
    taps of one (kd, group) contiguous."""
    c, co = 96, 136
    wp = T(rnd(3, 3, 2, c, co, seed=17))
    tiles = tdc.tile_wp(wp).tiles
    g_count = c // 32
    flat = tiles.reshape(-1, 4, 128, 8)
    for nb in range(2):
        for g in range(g_count):
            for kd in range(3):
                for k in range(6):
                    piece = flat[((nb * 3 + kd) * g_count + g) * 6 + k]
                    cols = min(128, co - 128 * nb)
                    want = wp[kd, k // 2, k % 2, 32 * g:32 * g + 32, 128 * nb:128 * nb + cols]
                    got = piece.permute(0, 2, 1).reshape(32, 128)  # (8 q + e, f)
                    assert torch.equal(got[:, :cols], want) and not got[:, cols:].any()


# ---------------------------------------------------------------------------
# B3: tile_what
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c2,f2", SHAPES)
def test_tile_what_round_trips_bit_for_bit(c2, f2):
    what = twino.transform_packed_w3_mixed(T(rnd(3, 3, 2, c2, f2, seed=c2 + f2))).to(torch.bfloat16)
    tiled = tw43.tile_what(what)
    nb = -(-f2 // 64)
    assert tuple(tiled.tiles.shape) == (nb, c2 // 32, 24, 2, 4, 64, 8)
    assert tiled.tiles.is_contiguous() and tiled.tiles.dtype == torch.bfloat16
    assert tuple(tiled.shape) == (4, 6, 2, c2, f2) and tiled.f2 == f2 and tiled.dim() == 5
    assert torch.equal(tiled.untiled(), what)
    assert tiled.tiles.numel() == what.numel() // f2 * nb * 64
    assert _is_permutation_plus_zeros(tiled.tiles, what)


@pytest.mark.parametrize("c2,f2", SHAPES)
def test_tile_what_element_map(c2, f2):
    """tiles[nb, g, p, t, q, f, e] = what[p // 6, (1, 2, 3, 4, 0, 5)[p % 6], t, 32 g + 8 q + e,
    64 nb + f]: a D-point's H-points in the pairs the kernel multiplies them in."""
    what = T(rnd(4, 6, 2, c2, f2, seed=5))
    tiles = tw43.tile_what(what).tiles
    rng = np.random.default_rng(6)
    for _ in range(200):
        nb, g, p, t, q, f, e = (int(rng.integers(n)) for n in tiles.shape)
        col = 64 * nb + f
        want = what[p // 6, (1, 2, 3, 4, 0, 5)[p % 6], t, 32 * g + 8 * q + e, col] \
            if col < f2 else 0.0
        assert tiles[nb, g, p, t, q, f, e] == want


def test_tile_what_is_idempotent_and_checks_its_input():
    what = T(rnd(4, 6, 2, 64, 72, seed=7))
    tiled = tw43.tile_what(what)
    assert tw43.tile_what(tiled) is tiled and isinstance(tiled, TiledWh)
    assert tiled.device == what.device and tiled.dtype == what.dtype
    with pytest.raises(ValueError):
        tw43.tile_what(what[:, :, :, :48])  # C2 % 32
    with pytest.raises(ValueError):
        tw43.tile_what(what[:, :4])  # F(2,3)^2 weights
    with pytest.raises(ValueError):
        tw43.tile_what(tile_wh(T(rnd(4, 4, 2, 64, 72))))  # the other kernel's pieces
    with pytest.raises(ValueError):
        tile_wh(tiled)
    with pytest.raises(ValueError):
        tw43.TiledWhat(tiled.tiles, 129)  # more columns than the tiles hold
    with pytest.raises(ValueError):
        tw43.TiledWhat(tile_wh(T(rnd(4, 4, 2, 64, 72))).tiles, 72)


@pytest.mark.parametrize("shape,use_bias,leaky", [((1, 10, 14, 16), True, True),
                                                  ((2, 7, 9, 8), False, False)])
@pytest.mark.parametrize("tiled", [False, True])
def test_wino43_wrapper_takes_tiled_weights_on_the_cpu(shape, use_bias, leaky, tiled):
    """The CPU route un-tiles: tiled and plain weights give the plain version's
    bits, and those agree with the Pallas kernel in interpret mode."""
    c = 64
    x, w, b = rnd(*shape, c, seed=41), rnd(3, 3, 3, c, c, seed=42, scale=0.05), rnd(c, seed=43,
                                                                                    scale=0.1)
    xp = ts2d.pack(T(x))
    what = twino.transform_packed_w3_mixed(ts2d.pack_w3(T(w)))
    bias = T(b) if use_bias else None
    got = tw43.conv3d_wino43_packed(xp, tw43.tile_what(what) if tiled else what, bias,
                                    leaky=leaky)
    assert torch.equal(got, twino.conv3_packed_wino43(xp, what, bias, leaky=leaky))
    assert tw43.conv3d_wino43_packed.launches == 0
    ref = conv3d_wino43_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b) if use_bias else None,
                               leaky=leaky, interpret=True, block=(4, 8, 8))
    np.testing.assert_allclose(ts2d.unpack(got).numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)
