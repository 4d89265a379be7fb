"""The port's three experimental conv routes against the JAX package, on the CPU.

B4 (direct, resident window), B5 (direct, plane-streamed N parts) and B3
(mixed F(2,3) x F(4,3) Winograd) are CUDA kernels on the card; on a CPU tensor
their wrappers run the plain PyTorch versions, which are what these tests
hold against the JAX package's Pallas kernels (run in interpret mode, as the
JAX package's own tests run them).  Inputs and weights come from
``numpy.random.default_rng(seed)`` and go to both sides.  Also here: the
conv-route bench on the CPU and the entry points' default device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu.ops import s2d as js2d
from jax_nbody_emulator_with_dj_tpu.ops import winograd as jwino
from jax_nbody_emulator_with_dj_tpu.ops.pallas_conv import conv3d_pallas
from jax_nbody_emulator_with_dj_tpu.ops.stripe_conv import conv3_packed_stripe as jstripe
from jax_nbody_emulator_with_dj_tpu.ops.winograd43_pallas import conv3d_wino43_pallas

from jax_nbody_emulator_with_dj_tpu_torch import ops as tops
from jax_nbody_emulator_with_dj_tpu_torch.experiments import conv_routes
from jax_nbody_emulator_with_dj_tpu_torch.ops import direct_conv as tdirect
from jax_nbody_emulator_with_dj_tpu_torch.ops import direct_conv_cuda as tdc
from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d as ts2d
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd as twino
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd43_cuda as tw43

C = 64


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def both(a):
    return torch.from_numpy(a), jnp.asarray(a)


def oracle(xp, wp, bias_packed=None, leaky=False):
    """The port's library conv on packed tensors: a second, independent oracle."""
    y = ts2d.conv3_packed(xp, ts2d.oidhw_w3(wp))
    if bias_packed is not None:
        y = y + bias_packed
    return torch.nn.functional.leaky_relu(y, 0.01) if leaky else y


# ---------------------------------------------------------------------------
# B4: direct conv, resident window (ops/pallas_conv.py)
# ---------------------------------------------------------------------------

B4_CASES = [  # tests/test_pallas_conv.py::TestPallasKernel
    pytest.param((1, 12, 12, 16), True, True, id="bias_leaky"),
    pytest.param((1, 12, 12, 16), False, False, id="no_bias_no_act"),
    pytest.param((2, 12, 12, 16), True, True, id="batched"),
    pytest.param((1, 13, 15, 20), True, False, id="non_aligned"),
]


@pytest.mark.parametrize("shape,use_bias,leaky", B4_CASES)
def test_direct_matches_pallas(shape, use_bias, leaky):
    """float32: both sides sum the same 18 x 2C products in float32, in another
    order (rtol 1e-4, atol 1e-5, the JAX test's own tolerance)."""
    x, jx = both(rnd(*shape, C, seed=1))
    w, jw = both(rnd(3, 3, 3, C, C, seed=2, scale=0.05))
    b, jb = both(rnd(C, seed=3, scale=0.1))
    ref = conv3d_pallas(jx, jw, jb if use_bias else None, leaky=leaky, interpret=True)
    before = tdc.conv3d_direct_packed.launches
    got = tdc.conv3d_direct(x, w, b if use_bias else None, leaky=leaky)
    assert tdc.conv3d_direct_packed.launches == before  # a CPU tensor launches nothing
    assert got.shape == ref.shape and got.dtype == x.dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape,use_bias,leaky", B4_CASES)
def test_direct_matches_library_conv(shape, use_bias, leaky):
    x = torch.from_numpy(rnd(*shape, C, seed=1))
    w = torch.from_numpy(rnd(3, 3, 3, C, C, seed=2, scale=0.05))
    b = torch.from_numpy(rnd(C, seed=3, scale=0.1))
    xp, wp = ts2d.pack(x), ts2d.pack_w3(w)
    got = tdc.conv3d_direct_packed(xp, wp, b if use_bias else None, leaky=leaky)
    ref = oracle(xp, wp, ts2d.pack_bias(b) if use_bias else None, leaky)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_direct_checks_its_arguments():
    xp = torch.zeros((1, 6, 6, 5, 128))
    with pytest.raises(ValueError, match="square"):
        tdc.conv3d_direct_packed(xp, torch.zeros((3, 3, 2, 128, 64)))
    with pytest.raises(ValueError, match="unpacked"):  # B4 takes the (C,) bias, not the packed one
        tdc.conv3d_direct_packed(xp, torch.zeros((3, 3, 2, 128, 128)), torch.zeros(128))
    with pytest.raises(ValueError, match="no kernel for device"):
        tdc.conv3d_direct_packed(xp.to("meta"), torch.zeros((3, 3, 2, 128, 128), device="meta"))


# ---------------------------------------------------------------------------
# B5: direct conv over N parts (ops/stripe_conv.py)
# ---------------------------------------------------------------------------

B5_CASES = [  # tests/test_stripe_conv.py's four, then three parts and a non-square kernel
    pytest.param((1, 10, 18, 16), (128,), 64, False, False, id="single_part"),
    pytest.param((1, 8, 12, 16), (128,), 64, True, True, id="bias_leaky"),
    pytest.param((1, 8, 12, 16), (128, 128), 64, False, False, id="two_parts"),
    pytest.param((1, 8, 11, 13), (128,), 64, False, False, id="wp13"),
    pytest.param((1, 7, 9, 10), (64, 64, 64), 32, True, True, id="three_parts"),
    pytest.param((2, 6, 9, 7), (64, 64), 80, True, False, id="non_square_batched"),
]


def _stripe_case(shape, cins, co, use_bias):
    parts = [rnd(*shape, c, seed=10 + i) for i, c in enumerate(cins)]
    w = rnd(3, 3, 3, sum(cins) // 2, co, seed=20, scale=0.05)
    bias = rnd(co, seed=21) if use_bias else None
    return parts, w, bias


@pytest.mark.parametrize("shape,cins,co,use_bias,leaky", B5_CASES)
def test_stripe_matches_pallas(shape, cins, co, use_bias, leaky):
    """float32, rtol 1e-5, atol 1e-5 (the JAX test's tolerance): the same tap
    products summed in float32 on both sides."""
    parts, w, bias = _stripe_case(shape, cins, co, use_bias)
    jwp = js2d.pack_w3(jnp.asarray(w), groups=len(cins))
    jbp = None if bias is None else js2d.pack_bias(jnp.asarray(bias))
    ref = jstripe(tuple(jnp.asarray(p) for p in parts), jwp, jbp, leaky=leaky, interpret=True)
    wp = ts2d.pack_w3(torch.from_numpy(w), groups=len(cins))
    np.testing.assert_array_equal(wp.numpy(), np.asarray(jwp))  # the group layout, row for row
    bp = None if bias is None else ts2d.pack_bias(torch.from_numpy(bias))
    xps = tuple(torch.from_numpy(p) for p in parts)
    got = tdc.conv3_packed_stripe(xps if len(xps) > 1 else xps[0], wp, bp, leaky=leaky)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert tdc.conv3_packed_stripe.launches == 0


@pytest.mark.parametrize("shape,cins,co,use_bias,leaky", B5_CASES)
def test_stripe_matches_library_conv_on_the_concat(shape, cins, co, use_bias, leaky):
    parts, w, bias = _stripe_case(shape, cins, co, use_bias)
    wp = ts2d.pack_w3(torch.from_numpy(w), groups=len(cins))
    bp = None if bias is None else ts2d.pack_bias(torch.from_numpy(bias))
    xps = [torch.from_numpy(p) for p in parts]
    got = tdirect.conv3_packed_taps(xps, wp, bp, leaky=leaky)
    ref = oracle(torch.cat(xps, dim=-1), wp, bp, leaky)
    # the library conv sums the up to 18 x 256 products in its own order: rtol 1e-4, atol 2e-5
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=2e-5)


def test_stripe_out_dtype_and_strided_parts():
    """A part that is a window of a larger buffer, bf16 operands, float32 out:
    equal to the same call on contiguous copies."""
    big = torch.from_numpy(rnd(1, 9, 10, 12, 64, seed=30)).to(torch.bfloat16)
    a = big[:, 1:8, 2:9, 3:10]
    b = torch.from_numpy(rnd(1, 7, 7, 7, 64, seed=31)).to(torch.bfloat16)
    wp = ts2d.pack_w3(torch.from_numpy(rnd(3, 3, 3, 64, 32, seed=32, scale=0.05)), groups=2)
    got = tdc.conv3_packed_stripe((a, b), wp.to(torch.bfloat16), out_dtype=torch.float32)
    ref = tdc.conv3_packed_stripe((a.contiguous(), b), wp.to(torch.bfloat16),
                                  out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (1, 5, 5, 6, 64)
    assert torch.equal(got, ref)


def test_stripe_checks_its_arguments():
    x = torch.zeros((1, 6, 6, 5, 64))
    wp = torch.zeros((3, 3, 2, 128, 64))
    with pytest.raises(ValueError, match="share"):
        tdc.conv3_packed_stripe((x, torch.zeros((1, 6, 7, 5, 64))), wp)
    with pytest.raises(ValueError, match="does not match"):
        tdc.conv3_packed_stripe(x, wp)
    with pytest.raises(ValueError, match="packed"):  # B5 takes the packed (Co,) bias
        tdc.conv3_packed_stripe((x, x), wp, torch.zeros(32))
    with pytest.raises(ValueError, match="no kernel for device"):
        tdc.conv3_packed_stripe(x.to("meta"), torch.zeros((3, 3, 2, 64, 64), device="meta"))


@pytest.mark.parametrize("ctot,bh,stages", [(32, 16, 8), (128, 16, 8), (160, 16, 8), (256, 16, 5),
                                            (288, 8, 8), (320, 8, 8), (512, 8, 4)])
def test_stripe_patch_fits_shared_memory(ctot, bh, stages):
    """One block per SM: the weight ring (8,192 bytes a stage), the two plane
    slots of (BH+2) x 9 cells x C bf16 (144 bytes per H row and 8 channels),
    the bf16 staging of each consumer warpgroup (one per 8 rows of the patch:
    64 rows x 144 bytes), 128 bias values and 20 mbarriers stay inside the
    232,448 bytes a block may use; the ring is as deep as that leaves, at most
    8 stages and never fewer than 3; and one more stage would not fit (or is
    the ninth)."""
    assert tdc.stripe_block_h(ctot) == bh and tdc.stripe_ring_stages(ctot) == stages
    cells = (bh + 2) * 9
    smem = stages * 8192 + 2 * cells * ctot * 2 + (bh // 8) * 64 * 144 + 128 * 4 + 20 * 8
    assert smem == tdc.stripe_smem_bytes(ctot, stages) <= tdc.SMEM_MAX == 232448
    assert 3 <= stages <= 8
    assert stages == 8 or tdc.stripe_smem_bytes(ctot, stages + 1) > tdc.SMEM_MAX


@pytest.mark.parametrize("od,patches,sms", [(140, 81, 132), (66, 25, 132), (34, 9, 132),
                                            (134, 561, 132), (5, 1, 132), (1, 3, 132),
                                            (140, 162, 132)])
def test_stripe_segments_cover_the_planes(od, patches, sms):
    nseg = tdc.stripe_segments(od, patches, sms)
    dseg = -(-od // nseg)
    assert 1 <= nseg <= od and dseg * -(-od // dseg) >= od
    if patches < sms and od >= 8:  # too few patches for the card: D is cut
        assert nseg > 1
    # no other cut keeps the SMs busier: waves that are full, segments that are long (a
    # segment's start and end cost what 2.5 of its planes cost)
    def busy(n):
        seg = -(-od // n)
        blocks = patches * -(-od // seg)
        return blocks / (-(-blocks // sms) * sms) * seg / (seg + 2.5)
    assert all(busy(nseg) >= busy(n) - 1e-9 for n in range(1, od + 1))


# ---------------------------------------------------------------------------
# B3: mixed F(2,3) x F(4,3) Winograd (ops/winograd43_pallas.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ci,co,groups", [(8, 8, 1), (64, 64, 1), (16, 24, 2)])
def test_mixed_weight_transform_matches_jax(ci, co, groups):
    """float32 on both sides (G4 has sixths): rtol 1e-6."""
    w, jw = both(rnd(3, 3, 3, ci, co, seed=40))
    got = twino.transform_packed_w3_mixed(ts2d.pack_w3(w, groups=groups))
    ref = jwino.transform_packed_w3_mixed(js2d.pack_w3(jw, groups=groups))
    assert got.shape == (4, 6, 2, 2 * ci, 2 * co)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


B3_CASES = [  # tests/test_pallas_conv.py::TestWino43Interpret, then ragged extents
    pytest.param((1, 10, 14, 16), True, True, id="bias_leaky"),
    pytest.param((1, 12, 15, 22), True, False, id="clipped"),
    pytest.param((2, 7, 9, 8), False, False, id="odd_d_ragged_h_batched"),
]


@pytest.mark.parametrize("shape,use_bias,leaky", B3_CASES)
def test_wino43_matches_pallas(shape, use_bias, leaky):
    """float32, rtol 2e-4, atol 2e-5 (the JAX test's tolerance: F(4,3)'s
    transforms lose about a digit more than F(2,3)'s)."""
    x, jx = both(rnd(*shape, C, seed=41))
    w, jw = both(rnd(3, 3, 3, C, C, seed=42, scale=0.05))
    b, jb = both(rnd(C, seed=43, scale=0.1))
    ref = conv3d_wino43_pallas(jx, jw, jb if use_bias else None, leaky=leaky, interpret=True,
                               block=(4, 8, 8))
    got = tw43.conv3d_wino43(x, w, b if use_bias else None, leaky=leaky)
    assert got.shape == ref.shape and tw43.conv3d_wino43_packed.launches == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("shape,use_bias,leaky", B3_CASES)
def test_wino43_matches_library_conv(shape, use_bias, leaky):
    x = torch.from_numpy(rnd(*shape, C, seed=41))
    w = torch.from_numpy(rnd(3, 3, 3, C, C, seed=42, scale=0.05))
    b = torch.from_numpy(rnd(C, seed=43, scale=0.1))
    xp, wp = ts2d.pack(x), ts2d.pack_w3(w)
    got = tw43.conv3d_wino43_packed(xp, twino.transform_packed_w3_mixed(wp),
                                    b if use_bias else None, leaky=leaky)
    ref = oracle(xp, wp, ts2d.pack_bias(b) if use_bias else None, leaky)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=2e-4, atol=2e-5)


def test_wino43_packed_bias_and_out_dtype():
    """The bias may come unpacked (Co,) or packed (2Co,); out_dtype is honoured."""
    xp = torch.from_numpy(rnd(1, 6, 8, 5, 32, seed=44)).to(torch.bfloat16)
    what = twino.transform_packed_w3_mixed(
        ts2d.pack_w3(torch.from_numpy(rnd(3, 3, 3, 16, 16, seed=45, scale=0.1)))).to(torch.bfloat16)
    b = torch.from_numpy(rnd(16, seed=46))
    y0 = tw43.conv3d_wino43_packed(xp, what, b, out_dtype=torch.float32)
    y1 = tw43.conv3d_wino43_packed(xp, what, ts2d.pack_bias(b), out_dtype=torch.float32)
    assert y0.dtype == torch.float32 and torch.equal(y0, y1)
    assert tw43.conv3d_wino43_packed(xp, what, b).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="does not match"):
        tw43.conv3d_wino43_packed(xp, what[:, :4], b)


def test_wino43_bf16_error_within_gate():
    """bf16 operands against the float32 direct conv: BT4's {4,5} and AT4's
    {4,8} entries amplify bf16 rounding about 2x over F(2,3); within 0.08 of
    the output scale, the JAX package's gate for its kernel.  The port's plain
    version also stays within the same distance of the Pallas kernel on bf16
    operands (both round the transforms to bf16, not always at the same places)."""
    x, jx = both(rnd(1, 10, 14, 16, C, seed=41))
    w, jw = both(rnd(3, 3, 3, C, C, seed=42, scale=0.05))
    b, jb = both(rnd(C, seed=43, scale=0.1))
    y32 = oracle(ts2d.pack(x), ts2d.pack_w3(w), ts2d.pack_bias(b)).numpy()
    got = tw43.conv3d_wino43(x.to(torch.bfloat16), w.to(torch.bfloat16), b).float()
    got = ts2d.pack(got).numpy()
    scale = np.abs(y32).max()
    assert np.abs(got - y32).max() / scale < 0.08
    ref = conv3d_wino43_pallas(jx.astype(jnp.bfloat16), jw.astype(jnp.bfloat16), jb,
                               interpret=True, block=(4, 8, 8))
    ref = np.asarray(js2d.pack(ref.astype(jnp.float32)))
    assert np.abs(got - ref).max() / scale < 0.08


# ---------------------------------------------------------------------------
# The entry point: the conv-route bench, on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parts", [1, 2])
def test_conv_routes_on_cpu(parts):
    lines = []
    rows = conv_routes.run(shape=(8, 10, 9), parts=parts, device="cpu", emit=lines.append)
    assert [r["route"] for r in rows] == ["cudnn", "B1", "B3", "B4", "B5"]
    assert len(lines) == 5 and all(r["ok"] for r in rows)
    for r in rows:
        assert r["rel_err"] < r["gate"] and r["parts"] == parts
        # a CPU run times nothing and launches no kernel
        assert r["ms"] is None and r["launches"] == 0 and r["device"] == "cpu"
        assert r["bound_ms"] > 0 and r["bound_by"] in ("bytes", "operations")


def test_conv_routes_bounds_at_the_phase3_shape():
    """The least times at xp (1,142,142,71,128) -> (1,140,140,70,128) bf16 on
    an H100: 0.21 ms of memory traffic; 0.82 ms for the direct conv's 809
    GFLOP, 0.36 ms for F(2,3)^2's 4/9 and 0.27 ms for the mixed form's 3/9."""
    shape = (142, 142, 71)
    by = {r: conv_routes.route_bound(r, shape, 1) for r in conv_routes.ROUTES}
    assert all(v[1] == "operations" for v in by.values())
    assert by["B4"][0] == by["B5"][0] == by["cudnn"][0] == pytest.approx(0.8185, abs=2e-3)
    assert by["B1"][0] == pytest.approx(0.8185 * 4 / 9, abs=2e-3)
    assert by["B3"][0] == pytest.approx(0.8185 * 3 / 9, abs=2e-3)
    assert 2 * by["B4"][2] == pytest.approx(809e9, rel=2e-3)


def test_conv_routes_default_device_is_the_card():
    if torch.cuda.is_available():
        assert conv_routes.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        conv_routes.run(shape=(8, 10, 9))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        conv_routes.main(["--shape", "8", "10", "9"])


def test_new_ops_are_exported():
    for name in ("conv3d_direct", "conv3d_direct_packed", "conv3_packed_stripe",
                 "conv3d_wino43", "conv3d_wino43_packed", "conv3_packed_taps",
                 "conv3_packed_wino43", "transform_packed_w3_mixed"):
        assert callable(getattr(tops, name)), name


# ---------------------------------------------------------------------------
# The entry points' default device
# ---------------------------------------------------------------------------


def _tiny_emulator(**kw):
    from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalConfig, create_emulator
    from jax_nbody_emulator_with_dj_tpu_torch.models.unet import init_unet

    cfg = HierarchicalConfig(size=(16,) * 3, slab=8, tile=(8, 8, 8), dtype=torch.float32,
                             output_dtype=torch.float32)
    return create_emulator(premodulate=True, compute_vel=False,
                           params=init_unet(0, mid_chan=4, style=True), premodulate_z=0.5,
                           premodulate_Om=0.3, processor_config=cfg, mid_chan=4, **kw)


def test_create_emulator_on_the_cpu_when_asked():
    emu = _tiny_emulator(device="cpu")
    assert emu.device.type == "cpu" and emu.processor.device.type == "cpu"
    box = rnd(3, 16, 16, 16, seed=50)
    out = emu.process_box(box, 0.5, 0.3)
    assert out.shape == (3, 16, 16, 16) and np.isfinite(out).all()


def test_create_emulator_defaults_to_the_card():
    if torch.cuda.is_available():
        assert _tiny_emulator().device.type == "cuda"
    else:  # no quiet step down to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _tiny_emulator()
