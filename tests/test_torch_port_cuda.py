"""The port's CUDA kernels (B1-B5) against their plain PyTorch versions, on the card.

Skips without a CUDA device.  Imports neither JAX nor the repo's
``conftest.py`` (which imports JAX), so it runs on a machine that has only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: float32 outputs must agree to 1e-5 relative (same roundings, only
the float32 summation order differs); bf16 outputs to 1e-2 (one bf16 rounding
of the output on either side).  B2's dy is compared where kernel and plain
version agree on the sign of y (the LeakyReLU pair's mask); the share where
they disagree must stay under 1e-4.  B3 (mixed Winograd) is held to 1e-4 in
float32 (the float32 sums pass through AT4's entries of up to 8 in another
order) and to 0.08 in bf16, the JAX package's gate for its kernel.
"""

import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu_torch.ops import direct_conv as tdirect
from jax_nbody_emulator_with_dj_tpu_torch.ops import direct_conv_cuda, winograd43_cuda
from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d as ts2d
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd as twino
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd_cuda


def rnd(*shape, seed=0, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    )


def _input(shape, c, seed, view):
    """bf16 input on the card; ``view``: a window of a larger buffer (its own strides)."""
    full = (shape[0], shape[1] + 3, shape[2] + 2, shape[3] + 5, c) if view else shape + (c,)
    xp = rnd(*full, seed=seed).to("cuda", torch.bfloat16)
    return xp[:, 2:2 + shape[1], 1:1 + shape[2], 3:3 + shape[3]] if view else xp


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.cuda
class TestCudaConvRoutes:
    """B4, B5 and B3 against their plain versions on the card (skip without one),
    over the case grid of ``chip_smoke.py``'s phases at small extents."""

    @pytest.fixture(autouse=True)
    def _need_cuda(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU and nvcc")

    # B4's block owns a patch of 2 D planes x 16 H rows x 8 cells and walks over patches:
    # an output of exactly one patch and of less than one, an odd count of output planes
    # (the second plane of the last patch masked), H not a multiple of 16 with an odd
    # count of patches, ragged W; C of 64 to 320 (one to three column blocks, a ragged
    # last one; two to ten channel groups through the three window slots); a strided
    # view; weights tiled beforehand or by the wrapper.
    @pytest.mark.parametrize("shape,view", [((1, 12, 20, 18), False), ((2, 13, 16, 21), True),
                                            ((1, 3, 3, 2), False), ((1, 4, 18, 9), True),
                                            ((1, 5, 37, 18), False), ((1, 9, 11, 7), True)])
    @pytest.mark.parametrize("c2", [64, 96, 128, 256, 320])
    @pytest.mark.parametrize("use_bias", [False, True])
    @pytest.mark.parametrize("leaky", [False, True])
    @pytest.mark.parametrize("tiled", [False, True])
    def test_direct_kernel_matches_plain(self, shape, view, c2, use_bias, leaky, tiled):
        xp = _input(shape, c2, 31, view)
        wp = ts2d.pack_w3(rnd(3, 3, 3, c2 // 2, c2 // 2, seed=32, scale=(13.5 * c2) ** -0.5))
        wp = wp.to("cuda", torch.bfloat16)
        b = rnd(c2 // 2, seed=33, scale=0.1).to("cuda") if use_bias else None
        before = direct_conv_cuda.conv3d_direct_packed.launches
        got = direct_conv_cuda.conv3d_direct_packed(
            xp, direct_conv_cuda.tile_wp(wp) if tiled else wp, b, leaky=leaky)
        ref = tdirect.conv3_packed_taps(xp, wp, None if b is None else ts2d.pack_bias(b),
                                        leaky=leaky)
        torch.cuda.synchronize()
        assert direct_conv_cuda.conv3d_direct_packed.launches == before + 1
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        assert _rel(got, ref) < 0.01

    @pytest.mark.parametrize("shape,c2", [((1, 5, 37, 18), 128), ((2, 13, 16, 21), 256)])
    def test_direct_kernel_float32_out(self, shape, c2):
        """The C entry point's ``out_f32`` form, which the wrapper (output in the
        input's dtype) never asks for: float32 from the fragments, 1e-5 of the
        plain version (only the summation order differs)."""
        xp = _input(shape, c2, 34, True)
        wp = ts2d.pack_w3(rnd(3, 3, 3, c2 // 2, c2 // 2, seed=35, scale=(13.5 * c2) ** -0.5))
        wp = wp.to("cuda", torch.bfloat16)
        bp = rnd(c2, seed=36, scale=0.1).to("cuda")
        b, d, h, w = shape
        y = torch.empty((b, d - 2, h - 2, w - 1, c2), dtype=torch.float32, device="cuda")
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rc = direct_conv_cuda.build().direct_conv_window(
            xp.data_ptr(), direct_conv_cuda.tile_wp(wp).data_ptr(), bp.data_ptr(), y.data_ptr(),
            *xp.stride()[:4], b, d, h, w, c2, c2, 1, 1, sms,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        ref = tdirect.conv3_packed_taps(xp, wp, bp, leaky=True, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert _rel(y, ref) < 1e-5

    def test_direct_kernel_refuses_what_it_cannot_take(self):
        x = torch.zeros((1, 6, 6, 5, 128), dtype=torch.bfloat16, device="cuda")
        wp = torch.zeros((3, 3, 2, 128, 128), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(TypeError, match="bf16"):
            direct_conv_cuda.conv3d_direct_packed(x.float(), wp.float())
        with pytest.raises(ValueError, match="square"):
            direct_conv_cuda.conv3d_direct_packed(x, direct_conv_cuda.tile_wp(wp[..., :64]))
        x48 = torch.zeros((1, 6, 6, 5, 48), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="multiples of 32"):
            direct_conv_cuda.conv3d_direct_packed(x48, wp[:, :, :, :48, :48].contiguous())
        with pytest.raises(ValueError, match="contiguous channels"):
            direct_conv_cuda.conv3d_direct_packed(x[..., ::2], wp[:, :, :, :64, :64].contiguous())

    @pytest.mark.parametrize("shape,view", [((1, 12, 20, 18), False), ((2, 13, 16, 21), True)])
    @pytest.mark.parametrize("cins,co", [((128,), 128), ((128, 128), 256), ((128, 128, 128), 128),
                                         ((32, 64, 128, 96), 72), ((64,), 8)])
    @pytest.mark.parametrize("fused", [False, True])
    @pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
    def test_stripe_kernel_matches_plain(self, shape, view, cins, co, fused, out_dtype):
        """``fused``: bias and LeakyReLU on; parts: one to four, equal and unequal."""
        xps = tuple(_input(shape, c, 41 + i, view and i == 0) for i, c in enumerate(cins))
        ctot = sum(cins)
        wp = rnd(3, 3, 2, ctot, co, seed=45, scale=(13.5 * ctot) ** -0.5).to("cuda", torch.bfloat16)
        bp = rnd(co, seed=46, scale=0.1).to("cuda") if fused else None
        before = direct_conv_cuda.conv3_packed_stripe.launches
        got = direct_conv_cuda.conv3_packed_stripe(xps, wp, bp, leaky=fused, out_dtype=out_dtype)
        ref = tdirect.conv3_packed_taps(xps, wp, bp, leaky=fused, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert direct_conv_cuda.conv3_packed_stripe.launches == before + 1
        assert got.dtype == out_dtype and got.shape == ref.shape
        assert _rel(got, ref) < (1e-5 if out_dtype == torch.float32 else 0.01)

    # The shapes that reach the redesigned kernel's other code paths: an output
    # of one patch, ragged D, H and W (WP - 1 not a multiple of 8) with an odd
    # count of patches, Co of 72, 136, 192 and 256 (a ragged last column tile, a
    # second column block), 256, 320 and 512 input channels (two consumer
    # warpgroups; one, with an accumulator set per kd), a strided view, float32
    # out, weights tiled beforehand or by the wrapper.
    STRIPE_NEW_SHAPES = [
        ((1, 3, 10, 9), (128,), 128, True),            # one patch
        ((1, 3, 10, 9), (256, 256), 136, False),       # ... of the one-consumer kernel
        ((1, 9, 11, 7), (256,), 136, True),
        ((2, 13, 16, 21), (32, 64, 128, 96), 72, False),
        ((1, 7, 19, 12), (256, 256), 136, True),
        ((2, 13, 16, 21), (128, 128, 128, 128), 256, False),
        ((1, 20, 22, 12), (128,), 192, True),
        ((1, 12, 37, 18), (64, 64), 256, False),       # three H patches: an odd count
    ]

    @pytest.mark.parametrize("shape,cins,co,view", STRIPE_NEW_SHAPES)
    @pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("tiled", [False, True])
    def test_stripe_kernel_new_shapes(self, shape, cins, co, view, out_dtype, tiled):
        xps = tuple(_input(shape, c, 61 + i, view and i == 0) for i, c in enumerate(cins))
        ctot = sum(cins)
        wp = rnd(3, 3, 2, ctot, co, seed=65, scale=(13.5 * ctot) ** -0.5).to("cuda", torch.bfloat16)
        bp = rnd(co, seed=66, scale=0.1).to("cuda")
        got = direct_conv_cuda.conv3_packed_stripe(
            xps, direct_conv_cuda.tile_wp(wp) if tiled else wp, bp, leaky=True,
            out_dtype=out_dtype)
        ref = tdirect.conv3_packed_taps(xps, wp, bp, leaky=True, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == ref.shape
        assert _rel(got, ref) < (1e-5 if out_dtype == torch.float32 else 0.01)

    def test_stripe_kernel_refuses_what_it_cannot_take(self):
        x = torch.zeros((1, 6, 6, 5, 128), dtype=torch.bfloat16, device="cuda")
        wp = torch.zeros((3, 3, 2, 640, 128), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="at most 4 parts"):
            direct_conv_cuda.conv3_packed_stripe((x,) * 5, wp)
        with pytest.raises(TypeError, match="bf16"):
            direct_conv_cuda.conv3_packed_stripe(x.float(), wp[:, :, :, :128].float())
        x48 = torch.zeros((1, 6, 6, 5, 48), dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="multiples of 32"):
            direct_conv_cuda.conv3_packed_stripe(x48, wp[:, :, :, :48].contiguous())

    @pytest.mark.parametrize("shape,view", [((1, 12, 20, 18), False), ((2, 13, 16, 21), True),
                                            ((1, 9, 11, 7), True)])
    @pytest.mark.parametrize("c2,f2", [(128, 128), (256, 128), (128, 256)])
    @pytest.mark.parametrize("fused", [False, True])
    @pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
    def test_wino43_kernel_matches_plain(self, shape, view, c2, f2, fused, out_dtype):
        xp = _input(shape, c2, 51, view)
        w = rnd(3, 3, 3, c2 // 2, f2 // 2, seed=52, scale=(13.5 * c2) ** -0.5).to("cuda")
        what = twino.transform_packed_w3_mixed(ts2d.pack_w3(w)).to(torch.bfloat16).contiguous()
        b = rnd(f2 // 2, seed=53, scale=0.1).to("cuda") if fused else None
        before = winograd43_cuda.conv3d_wino43_packed.launches
        got = winograd43_cuda.conv3d_wino43_packed(xp, what, b, leaky=fused, out_dtype=out_dtype)
        ref = twino.conv3_packed_wino43(xp, what, b, leaky=fused, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert winograd43_cuda.conv3d_wino43_packed.launches == before + 1
        assert got.dtype == out_dtype and got.shape == ref.shape
        assert _rel(got, ref) < (1e-4 if out_dtype == torch.float32 else 0.08)

    # The shapes that reach the redesigned kernel's other code paths: an output
    # of one patch, ragged D, H and W with an odd count of patches, F2 of 72,
    # 136, 192 and 256 (a ragged last column tile, up to four column blocks),
    # C2 = 256, a strided view, float32 out, weights tiled beforehand or by the
    # wrapper.
    WINO43_NEW_SHAPES = [
        ((1, 6, 18, 9), 128, 128, True),       # one patch
        ((1, 9, 11, 7), 256, 136, False),
        ((1, 20, 22, 12), 128, 192, True),
        ((2, 13, 16, 21), 128, 72, True),
        ((2, 13, 16, 21), 256, 256, False),
        ((1, 7, 37, 18), 128, 136, True),      # three H patches: an odd count
    ]

    @pytest.mark.parametrize("shape,c2,f2,view", WINO43_NEW_SHAPES)
    @pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("tiled", [False, True])
    def test_wino43_kernel_new_shapes(self, shape, c2, f2, view, out_dtype, tiled):
        xp = _input(shape, c2, 71, view)
        w = rnd(3, 3, 3, c2 // 2, f2 // 2, seed=72, scale=(13.5 * c2) ** -0.5).to("cuda")
        what = twino.transform_packed_w3_mixed(ts2d.pack_w3(w)).to(torch.bfloat16).contiguous()
        b = rnd(f2 // 2, seed=73, scale=0.1).to("cuda")
        got = winograd43_cuda.conv3d_wino43_packed(
            xp, winograd43_cuda.tile_what(what) if tiled else what, b, leaky=True,
            out_dtype=out_dtype)
        ref = twino.conv3_packed_wino43(xp, what, b, leaky=True, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == ref.shape
        assert _rel(got, ref) < (1e-4 if out_dtype == torch.float32 else 0.08)

    def test_conv_routes_on_the_card(self):
        """The bench at a small shape: every route passes its gate and B3, B4,
        B5 launch (B5 once per call, the others once per part)."""
        from jax_nbody_emulator_with_dj_tpu_torch.experiments import conv_routes

        for parts in (1, 2):
            rows = conv_routes.run((12, 20, 16), parts, reps=1, emit=lambda line: None)
            by = {r["route"]: r for r in rows}
            assert all(r["ok"] and r["ms"] > 0 for r in rows)
            assert by["B5"]["launches"] == 1
            assert by["B3"]["launches"] == by["B4"]["launches"] == by["B1"]["launches"] == parts


@pytest.mark.cuda
class TestCudaKernel:
    """The kernel against its plain version on the card (skips without one)."""

    @pytest.fixture(autouse=True)
    def _need_cuda(self):
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU and nvcc")

    @pytest.mark.parametrize("shape,cio", [((1, 12, 20, 18), (64, 64)), ((2, 13, 15, 21), (128, 64)),
                                           ((1, 10, 12, 9), (64, 128)), ((1, 7, 9, 40), (16, 52))])
    @pytest.mark.parametrize("leaky", [False, True])
    @pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
    def test_kernel_matches_plain(self, shape, cio, leaky, out_dtype):
        ci, co = cio
        dev = torch.device("cuda")
        xp = rnd(*shape, 2 * ci, seed=12).to(dev, torch.bfloat16)
        w = rnd(3, 3, 3, ci, co, seed=13, scale=0.05).to(dev)
        wh = twino.transform_packed_w3(ts2d.pack_w3(w)).to(torch.bfloat16).contiguous()
        b = rnd(co, seed=14, scale=0.1).to(dev)
        before = winograd_cuda.conv3d_wino_packed.launches
        got = winograd_cuda.conv3d_wino_packed(xp, wh, b, leaky=leaky, out_dtype=out_dtype)
        ref = twino.conv3_packed_wino(xp, wh, b, leaky=leaky, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert winograd_cuda.conv3d_wino_packed.launches == before + 1
        assert got.dtype == out_dtype and got.shape == ref.shape
        err = (got.float() - ref.float()).abs().max() / ref.float().abs().max()
        assert err < (1e-5 if out_dtype == torch.float32 else 0.01)

    def test_processor_runs_the_kernel(self):
        """A 16^3 box at mid_chan=64 on the card: the Winograd sites launch
        the kernel, and the box agrees with the run that has it off."""
        from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalConfig, create_emulator
        from jax_nbody_emulator_with_dj_tpu_torch.models.unet import init_unet

        n = 16
        tree = init_unet(2, mid_chan=64, style=True)
        box = np.random.default_rng(3).standard_normal((3, n, n, n)).astype(np.float32)
        outs = {}
        for wino in (False, True):
            cfg = HierarchicalConfig(size=(n,) * 3, slab=8, tile=(8, 8, 8),
                                     dtype=torch.bfloat16, output_dtype=torch.float32)
            cfg.wino = wino
            emu = create_emulator(premodulate=True, compute_vel=False, params=tree,
                                  premodulate_z=1.0, premodulate_Om=0.3,
                                  processor_config=cfg, device="cuda")
            before = winograd_cuda.conv3d_wino_packed.launches
            outs[wino] = emu.process_box(box, 1.0, 0.3)
            launched = winograd_cuda.conv3d_wino_packed.launches - before
            assert (launched > 0) == wino
        ref = outs[False]
        assert np.abs(outs[True] - ref).max() / np.abs(ref).max() < 0.02

    @pytest.mark.parametrize("shape,view", [((1, 12, 20, 18), False), ((2, 13, 15, 21), True)])
    @pytest.mark.parametrize("c2,f2", [(128, 128), (128, 256), (256, 128), (256, 256)])
    @pytest.mark.parametrize("leaky", [False, True])
    @pytest.mark.parametrize("fold", [False, True])
    @pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
    def test_pair_kernel_matches_plain(self, shape, view, c2, f2, leaky, fold, out_dtype):
        """B2; ``view``: xp is a window of a larger buffer (its own strides),
        ``fold=False``: bias and c are None (the raw per-part form)."""
        dev = torch.device("cuda")
        full = (shape[0], shape[1] + 3, shape[2] + 2, shape[3] + 5, c2) if view else shape + (c2,)
        xp = rnd(*full, seed=21).to(dev, torch.bfloat16)
        if view:
            xp = xp[:, 2:2 + shape[1], 1:1 + shape[2], 3:3 + shape[3]]
        sp = rnd(*shape, c2, seed=22).to(dev, torch.bfloat16)
        w = rnd(3, 3, 3, c2 // 2, f2 // 2, seed=23, scale=(27 * c2 / 2) ** -0.5).to(dev)
        wh = twino.transform_packed_w3(ts2d.pack_w3(w)).to(torch.bfloat16).contiguous()
        b = rnd(f2 // 2, seed=24, scale=0.1).to(dev) if fold else None
        c = rnd(f2, seed=25, scale=0.3).to(dev) if fold else None
        before = winograd_cuda.conv3d_wino_pair_packed.launches
        got = winograd_cuda.conv3d_wino_pair_packed(xp, sp, wh, b, c, leaky=leaky,
                                                    out_dtype=out_dtype)
        ref = twino.conv3_packed_wino_pair(xp, sp, wh, b, c, leaky=leaky, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert winograd_cuda.conv3d_wino_pair_packed.launches == before + 1
        (y, dy), (y_ref, dy_ref) = [(t[0].float(), t[1].float()) for t in (got, ref)]
        assert got[0].dtype == got[1].dtype == out_dtype and y.shape == y_ref.shape
        gate = 1e-5 if out_dtype == torch.float32 else 0.01
        assert (y - y_ref).abs().max() / y_ref.abs().max() < gate
        agree = (y > 0) == (y_ref > 0)
        assert (~agree).sum().item() < 1e-4 * agree.numel()
        dy_err = torch.where(agree, (dy - dy_ref).abs(), torch.zeros_like(dy)).max()
        assert dy_err / dy_ref.abs().max() < gate

    # The shapes that reach the redesigned kernel's other code paths: an odd
    # count of 64-row tiles (a lone last block), F2 above 128 (a second column
    # block) and not a multiple of 64 (a ragged last column tile), C2 = 256, x a
    # strided view beside a contiguous s, float32 out, the wide phase-1 pair
    # site of a 256^3 box (small D, H), weights tiled beforehand or by the wrapper.
    NEW_SHAPES = [
        ((1, 9, 11, 7), 128, 128, True),       # 140 flat rows: 3 tiles
        ((1, 9, 11, 7), 256, 136, False),
        ((1, 20, 22, 12), 128, 192, True),
        ((2, 13, 16, 21), 128, 136, True),
        ((2, 13, 16, 21), 256, 256, False),
        ((1, 6, 8, 130), 128, 128, True),      # packed-W width 129
    ]

    @pytest.mark.parametrize("shape,c2,f2,view", NEW_SHAPES)
    @pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("tiled", [False, True])
    def test_kernel_new_shapes(self, shape, c2, f2, view, out_dtype, tiled):
        xp = _input(shape, c2, 31, view)
        w = rnd(3, 3, 3, c2 // 2, f2 // 2, seed=32, scale=(13.5 * c2) ** -0.5).to("cuda")
        wh = twino.transform_packed_w3(ts2d.pack_w3(w)).to(torch.bfloat16).contiguous()
        b = rnd(f2 // 2, seed=33, scale=0.1).to("cuda")
        got = winograd_cuda.conv3d_wino_packed(
            xp, winograd_cuda.tile_wh(wh) if tiled else wh, b, leaky=True, out_dtype=out_dtype)
        ref = twino.conv3_packed_wino(xp, wh, b, leaky=True, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == ref.shape
        assert _rel(got, ref) < (1e-5 if out_dtype == torch.float32 else 0.01)

    @pytest.mark.parametrize("shape,c2,f2,view", NEW_SHAPES)
    @pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("tiled", [False, True])
    def test_pair_kernel_new_shapes(self, shape, c2, f2, view, out_dtype, tiled):
        xp = _input(shape, c2, 41, view)  # a view when ``view``; sp always contiguous
        sp = _input(shape, c2, 42, False)
        w = rnd(3, 3, 3, c2 // 2, f2 // 2, seed=43, scale=(13.5 * c2) ** -0.5).to("cuda")
        wh = twino.transform_packed_w3(ts2d.pack_w3(w)).to(torch.bfloat16).contiguous()
        b = rnd(f2 // 2, seed=44, scale=0.1).to("cuda")
        c = rnd(f2, seed=45, scale=0.3).to("cuda")
        got = winograd_cuda.conv3d_wino_pair_packed(
            xp, sp, winograd_cuda.tile_wh(wh) if tiled else wh, b, c, leaky=True,
            out_dtype=out_dtype)
        ref = twino.conv3_packed_wino_pair(xp, sp, wh, b, c, leaky=True, out_dtype=out_dtype)
        torch.cuda.synchronize()
        (y, dy), (y_ref, dy_ref) = [(t[0].float(), t[1].float()) for t in (got, ref)]
        assert got[0].dtype == got[1].dtype == out_dtype and y.shape == y_ref.shape
        gate = 1e-5 if out_dtype == torch.float32 else 0.01
        assert (y - y_ref).abs().max() / y_ref.abs().max() < gate
        agree = (y > 0) == (y_ref > 0)
        assert (~agree).sum().item() <= max(1, 1e-4 * agree.numel())
        dy_err = torch.where(agree, (dy - dy_ref).abs(), torch.zeros_like(dy)).max()
        assert dy_err / dy_ref.abs().max() < gate

    def test_vel_processor_runs_the_pair_kernel(self):
        """A 16^3 velocity box at mid_chan=64 on the card: the pair sites launch
        B2, and the box agrees with the run that has the kernels off."""
        from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalConfig, create_emulator
        from jax_nbody_emulator_with_dj_tpu_torch.models.unet import init_unet

        n = 16
        tree = init_unet(2, mid_chan=64, style=True)
        box = np.random.default_rng(3).standard_normal((3, n, n, n)).astype(np.float32)
        outs = {}
        for wino in (False, True):
            cfg = HierarchicalConfig(size=(n,) * 3, slab=8, tile=(8, 8, 8),
                                     dtype=torch.bfloat16, output_dtype=torch.float32, wino=wino)
            emu = create_emulator(premodulate=True, compute_vel=True, params=tree,
                                  premodulate_z=1.0, premodulate_Om=0.3,
                                  processor_config=cfg, device="cuda")
            before = winograd_cuda.conv3d_wino_pair_packed.launches
            outs[wino] = emu.process_box(box, 1.0, 0.3)
            launched = winograd_cuda.conv3d_wino_pair_packed.launches - before
            assert (launched > 0) == wino
        (d0, v0), (d1, v1) = outs[False], outs[True]
        assert np.isfinite(d1).all() and np.isfinite(v1).all()
        assert np.abs(d1 - d0).max() / np.abs(d0).max() < 0.02
        assert (v1 - v0).std() / v0.std() < 0.08
