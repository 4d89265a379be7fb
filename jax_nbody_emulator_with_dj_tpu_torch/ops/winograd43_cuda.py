"""The mixed F(2,3) x F(4,3) Winograd packed conv kernel: build, bind, launch.

Replaces ``jax_nbody_emulator_with_dj_tpu/ops/winograd43_pallas.py::
conv3d_wino43_pallas_packed`` (B3, ``conv3d_wino43_packed`` here): CUDA C++
for ``sm_90a`` (``csrc/wino_f43.cu``; its header says what bounds it and how
it is built: ``wgmma`` from shared memory in two consumer warpgroups, two
producer warpgroups that load and transform the input, a weight ring filled
by bulk asynchronous copies on mbarriers, registers rebalanced with
``setmaxnreg``, blocks that stay on their SMs), compiled at first use by
``ops/_cuda_build.py`` and bound with ``ctypes``.

The kernel reads its weights as 8 KB pieces, one per (column block of 64,
channel group, point) holding both packed-W taps, each laid out as ``wgmma``
reads it.  ``tile_what`` makes them from ``transform_packed_w3_mixed``'s
(4, 6, 2, C2, F2) output (a permutation, plus zero columns up to a multiple
of 64); a caller that passes the plain tensor has it done on every call.

A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain PyTorch
version (``ops/winograd.py::conv3_packed_wino43``), the same function with
the same roundings.  There is no other route.  The entry point counts its
kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build, s2d
from .winograd import conv3_packed_wino43, transform_packed_w3_mixed
from .winograd_cuda import TiledWh, _check, _untiled, _vec_arg

SOURCE = "wino_f43.cu"

_lib = None


class TiledWhat(TiledWh):
    """Mixed-Winograd weights in kernel B3's layout: ``tiles`` is (NB, G, 24,
    2, 4, 64, 8), element ``[nb, g, p, t, q, f, e]`` being ``what[p // 6,
    V_ORDER[p % 6], t, 32 g + 8 q + e, 64 nb + f]``, zero past ``f2``; it
    stands for the (4, 6, 2, C2, F2) tensor.  The kernel multiplies a
    D-point's H-points in the pairs (1, 2), (3, 4), (0, 5), whose columns of
    AT4 share their sums, so the pieces lie in that order."""

    __slots__ = ()
    POINTS = (4, 6)
    V_ORDER = (1, 2, 3, 4, 0, 5)
    TILE_N = 64


def tile_what(what) -> TiledWhat:
    """(4, 6, 2, C2, F2) from ``transform_packed_w3_mixed`` -> the kernel's pieces."""
    return TiledWhat.tile(what)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the entry point's argument types on a build of the source."""
    fn = lib.wino_f43_packed
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile ``csrc/wino_f43.cu`` (once per version of the source) and bind it."""
    global _lib
    if _lib is None:
        _lib = bind(_cuda_build.build(SOURCE))
    return _lib


def conv3d_wino43_packed(xp, what, bias=None, *, leaky: bool = False, out_dtype=None):
    """Kernel B3.  Packed mixed-Winograd conv: xp (B, D, H, WP, C2) ->
    (B, D-2, H-2, WP-1, F2).

    Args:
        xp: packed input; bf16 on CUDA.  Any strides with contiguous channels.
        what: (4, 6, 2, C2, F2) from ``transform_packed_w3_mixed``, or
            ``tile_what`` of it; bf16 on CUDA.
        bias: (F2/2,) unpacked or (F2,) packed float32 bias, or None.
        leaky: fuse LeakyReLU(0.01).
        out_dtype: bf16 or float32 (default: xp's dtype).
    """
    out_dtype = out_dtype or xp.dtype
    if xp.device.type == "cpu":
        return conv3_packed_wino43(xp, _untiled(what), bias, leaky=leaky, out_dtype=out_dtype)
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    _check(xp, what, out_dtype, points=(4, 6))
    b, d, h, wp, c2 = xp.shape
    f2 = what.shape[-1]
    bias = _vec_arg(bias, f2, xp.device, "bias")
    lib = build()
    wt = tile_what(what)
    y = torch.empty((b, d - 2, h - 2, wp - 1, f2), dtype=out_dtype, device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.wino_f43_packed(
        xp.data_ptr(), wt.data_ptr(), bias.data_ptr(), y.data_ptr(),
        *xp.stride()[:4], b, d, h, wp, c2, f2, int(leaky),
        int(out_dtype == torch.float32), stream,
    )
    if rc != 0:
        raise RuntimeError(f"wino_f43 kernel launch failed with CUDA error {rc}")
    conv3d_wino43_packed.launches += 1
    return y


conv3d_wino43_packed.launches = 0  # kernel launches since the last reset


def conv3d_wino43(x, w, bias=None, *, leaky: bool = False):
    """Unpacked form of kernel B3: x (B, D, H, W, C) with W even, w (3, 3, 3,
    C, Co), bias (Co,) or None -> (B, D-2, H-2, W-2, Co) in ``x.dtype``."""
    what = transform_packed_w3_mixed(s2d.pack_w3(w.to(x.dtype)))
    return s2d.unpack(conv3d_wino43_packed(s2d.pack(x), what, bias, leaky=leaky))
