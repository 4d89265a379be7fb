"""The port's CUDA kernels (B1, B2) against their plain PyTorch versions, on the card.

Skips without a CUDA device.  Imports neither JAX nor the repo's
``conftest.py`` (which imports JAX), so it runs on a machine that has only
PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py

Tolerances: float32 outputs must agree to 1e-5 relative (same roundings, only
the float32 summation order differs); bf16 outputs to 1e-2 (one bf16 rounding
of the output on either side).  B2's dy is compared where kernel and plain
version agree on the sign of y (the LeakyReLU pair's mask); the share where
they disagree must stay under 1e-4.
"""

import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d as ts2d
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd as twino
from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd_cuda


def rnd(*shape, seed=0, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    )


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
