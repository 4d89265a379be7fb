"""The F(2,3)^2 Winograd packed conv kernels: build, bind, launch.

Replace two kernels of ``jax_nbody_emulator_with_dj_tpu/ops/winograd_pallas.py``:
``conv3d_wino_pallas_packed`` (B1, ``conv3d_wino_packed`` here) and
``conv3d_wino_pallas_pair_packed`` (B2, ``conv3d_wino_pair_packed``).  Both
are one CUDA C++ kernel for ``sm_90a`` (``csrc/wino_f23.cu``; its header says
what bounds them and why they are built the way they are): blocks that stay
on their SMs and walk over patches of 2 x 4 Winograd tiles x 8 cells,
``wgmma`` from shared memory in two consumer warpgroups, a producer
warpgroup that loads and transforms the input, a weight ring filled by bulk
asynchronous copies on mbarriers, registers rebalanced with ``setmaxnreg``.
B2 is that kernel over thread-block clusters of two, whose blocks take x and
s of one patch, share one multicast weight stream and exchange float32
accumulators through distributed shared memory.  The kernels need a card of
compute capability 9.0 (``wgmma``, clusters; launched with
``cudaLaunchKernelEx``) and ~221 KB of shared memory a block.  The source is
compiled with ``nvcc`` into a shared library with a plain C interface the
first time a CUDA tensor reaches a kernel (``ops/_cuda_build.py``), and bound
with ``ctypes``.

The kernel reads its weights as 8 KB pieces, one per (column block, channel
group, point, tap), each laid out as ``wgmma`` reads it.  ``tile_wh`` makes
them from ``transform_packed_w3``'s (4, 4, 2, C2, F2) output (a permutation,
plus zero columns up to a multiple of 128); the model does that once when it
packs its weights (``models/blocks.py``), and a caller that passes the
(4, 4, 2, C2, F2) tensor has it done on every call.

A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain PyTorch
version (``ops/winograd.py::conv3_packed_wino``, ``conv3_packed_wino_pair``),
the same function with the same roundings.  There is no other route.  Each
entry point counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build
from .winograd import _vec, conv3_packed_wino, conv3_packed_wino_pair

SOURCE = "wino_f23.cu"
TILE_N = 128  # output channels of a weight piece (the kernel's column block)
TILE_C = 32  # input channels of a weight piece (the kernel's channel group)


class TiledWh:
    """Transformed weights in the kernel's layout.

    ``tiles`` is (NB, G, 16, 2, 4, 128, 8): column block, channel group,
    point u*4+v, packed-W tap, 8-channel step, output channel, channel; element
    ``[nb, g, p, t, q, f, e]`` is ``wh[p // 4, p % 4, t, 32 g + 8 q + e,
    128 nb + f]``, zero past ``f2``.  ``shape``, ``dtype`` and ``device``
    describe the (4, 4, 2, C2, F2) tensor it stands for.  (``POINTS``,
    ``V_ORDER`` and ``TILE_N`` are the transform's points along (D, H), the
    order the kernel takes the H-points in, and its column block; the mixed
    Winograd kernel's ``TiledWhat`` has its own.)
    """

    __slots__ = ("tiles", "f2")
    POINTS = (4, 4)
    V_ORDER = (0, 1, 2, 3)
    TILE_N = TILE_N

    def __init__(self, tiles, f2: int):
        npoints = self.POINTS[0] * self.POINTS[1]
        if tiles.dim() != 7 or tuple(tiles.shape[2:]) != (npoints, 2, TILE_C // 8, self.TILE_N, 8) \
                or not 0 < f2 <= tiles.shape[0] * self.TILE_N:
            raise ValueError(f"not tiled Winograd weights: {tuple(tiles.shape)}, F2 = {f2}")
        self.tiles, self.f2 = tiles, f2

    @property
    def shape(self):
        return torch.Size(self.POINTS + (2, self.tiles.shape[1] * TILE_C, self.f2))

    dtype = property(lambda self: self.tiles.dtype)
    device = property(lambda self: self.tiles.device)

    def dim(self):
        return 5

    def is_contiguous(self):
        return self.tiles.is_contiguous()

    def data_ptr(self):
        return self.tiles.data_ptr()

    def untiled(self):
        """The (points along D, points along H, 2, C2, F2) tensor, bit for bit."""
        nb, g = self.tiles.shape[:2]
        wh = self.tiles.permute(2, 3, 1, 4, 6, 0, 5).reshape(
            *self.POINTS, 2, g * TILE_C, nb * self.TILE_N)
        inverse = sorted(range(self.POINTS[1]), key=self.V_ORDER.__getitem__)
        return wh[:, inverse, ..., :self.f2].contiguous()

    @classmethod
    def tile(cls, wh):
        """The transformed weights ``wh`` (or ``cls`` of them already) as ``cls``."""
        if type(wh) is cls:
            return wh
        if isinstance(wh, TiledWh) or wh.dim() != 5 or tuple(wh.shape[:3]) != cls.POINTS + (2,) \
                or wh.shape[3] % TILE_C:
            raise ValueError(f"wh must be {cls.POINTS + (2,)} + (C2 % {TILE_C} == 0, F2), got "
                             f"{tuple(wh.shape)}")
        c2, f2 = wh.shape[3:]
        nb = -(-f2 // cls.TILE_N)
        padded = torch.nn.functional.pad(wh[:, list(cls.V_ORDER)], (0, nb * cls.TILE_N - f2))
        t = padded.reshape(cls.POINTS[0] * cls.POINTS[1], 2, c2 // TILE_C, TILE_C // 8, 8, nb,
                           cls.TILE_N)
        return cls(t.permute(5, 2, 0, 1, 3, 6, 4).contiguous(), f2)


def tile_wh(wh) -> TiledWh:
    """(4, 4, 2, C2, F2) from ``transform_packed_w3`` -> the kernel's pieces."""
    return TiledWh.tile(wh)


_lib = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the two entry points' argument types on a build of the source."""
    fn = lib.wino_f23_packed
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    fn = lib.wino_f23_pair_packed
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 8 + [ctypes.c_int] * 8
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile ``csrc/wino_f23.cu`` (once per version of the source) and bind it."""
    global _lib
    if _lib is None:
        _lib = bind(_cuda_build.build(SOURCE))
    return _lib


def _check(xp, wh, out_dtype, points=(4, 4)):
    """Raise on what a Winograd kernel does not take; ``points`` are the
    transform's points along (D, H): (4, 4) for F(2,3)^2, (4, 6) for the mixed form."""
    if xp.dim() != 5 or wh.dim() != 5:
        raise ValueError(f"xp must be 5-D and wh {points + (2,)} + (C2, F2), got {xp.shape}, "
                         f"{wh.shape}")
    c2, f2 = wh.shape[-2], wh.shape[-1]
    if tuple(wh.shape[:3]) != points + (2,) or xp.shape[-1] != c2:
        raise ValueError(f"wh {tuple(wh.shape)} does not match xp {tuple(xp.shape)}")
    if xp.dtype != torch.bfloat16 or wh.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bf16 xp and wh, got {xp.dtype}, {wh.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or float32, got {out_dtype}")
    if c2 % 32 or not 32 <= c2 <= 256 or f2 % 8 or f2 < 8:
        raise ValueError(f"kernel takes C2 % 32 == 0 <= 256 and F2 % 8 == 0, got {c2}, {f2}")
    if wh.device != xp.device or not wh.is_contiguous() or wh.data_ptr() % 16:
        raise ValueError("wh must be a contiguous, 16-byte aligned tensor on xp's device")
    if xp.stride(-1) != 1 or any(s % 8 for s in xp.stride()[:4]) or xp.data_ptr() % 16:
        raise ValueError(f"xp needs contiguous channels and 16-byte rows, strides {xp.stride()}")
    b, d, h, wp, _ = xp.shape
    if d < 3 or h < 3 or wp < 2 or b < 1:
        raise ValueError(f"xp {tuple(xp.shape)} is smaller than the 3x3x2 window")


def _untiled(wh):
    return wh.untiled() if isinstance(wh, TiledWh) else wh


def _vec_arg(v, f2, device, name):
    """A (F2/2,) or (F2,) float32 vector (None: zeros) as a contiguous (F2,) on ``device``."""
    if v is None:
        return torch.zeros(f2, dtype=torch.float32, device=device)
    if v.dim() != 1 or v.shape[0] not in (f2, f2 // 2):
        raise ValueError(f"{name} has shape {tuple(v.shape)}, the conv {f2} outputs")
    return _vec(v.to(device), f2).contiguous()


def conv3d_wino_packed(xp, wh, bias=None, *, leaky: bool = False, out_dtype=None):
    """Packed Winograd conv: xp (B, D, H, WP, C2) -> (B, D-2, H-2, WP-1, F2).

    Args:
        xp: packed input; bf16 on CUDA.  Any strides with contiguous channels.
        wh: (4, 4, 2, C2, F2) from ``transform_packed_w3``, or ``tile_wh`` of it;
            bf16 on CUDA.
        bias: (F2/2,) or (F2,) float32 bias, or None.
        leaky: fuse LeakyReLU(0.01).
        out_dtype: bf16 or float32 (default: xp's dtype).
    """
    out_dtype = out_dtype or xp.dtype
    if xp.device.type == "cpu":
        return conv3_packed_wino(xp, _untiled(wh), bias, leaky=leaky, out_dtype=out_dtype)
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    _check(xp, wh, out_dtype)
    b, d, h, wp, c2 = xp.shape
    f2 = wh.shape[-1]
    bias = _vec_arg(bias, f2, xp.device, "bias")
    lib = build()
    wt = tile_wh(wh)
    y = torch.empty((b, d - 2, h - 2, wp - 1, f2), dtype=out_dtype, device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.wino_f23_packed(
        xp.data_ptr(), wt.data_ptr(), bias.data_ptr(), y.data_ptr(),
        *xp.stride()[:4], b, d, h, wp, c2, f2, int(leaky),
        int(out_dtype == torch.float32), stream,
    )
    if rc != 0:
        raise RuntimeError(f"wino_f23 kernel launch failed with CUDA error {rc}")
    conv3d_wino_packed.launches += 1
    return y


conv3d_wino_packed.launches = 0  # kernel launches since the last reset


def conv3d_wino_pair_packed(xp, sp, wh, bias=None, c=None, *, leaky: bool = False,
                            out_dtype=None):
    """The fused factored-tangent pair (kernel B2) over shared ``wh``:
    ``y = conv(xp, W) + bias`` and ``dy = conv(sp, W) - c (.) conv(xp, W)``,
    with the LeakyReLU pair (dy's slope from the float32 y) when ``leaky``.

    Args:
        xp, sp: packed inputs of one shape (B, D, H, WP, C2); bf16 on CUDA.
            Each may have any strides with contiguous channels.
        wh: (4, 4, 2, C2, F2) from ``transform_packed_w3``, or ``tile_wh`` of it;
            bf16 on CUDA.
        bias, c: (F2/2,) or (F2,) float32, or None for zeros.
        leaky: fuse the LeakyReLU(0.01) pair.
        out_dtype: bf16 or float32 (default: xp's dtype).
    Returns ``(y, dy)``, each (B, D-2, H-2, WP-1, F2).
    """
    out_dtype = out_dtype or xp.dtype
    if xp.device.type == "cpu":
        return conv3_packed_wino_pair(xp, sp, _untiled(wh), bias, c, leaky=leaky,
                                      out_dtype=out_dtype)
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    if sp.shape != xp.shape or sp.device != xp.device:
        raise ValueError(f"sp {tuple(sp.shape)} on {sp.device} != xp {tuple(xp.shape)} on {xp.device}")
    _check(xp, wh, out_dtype)
    _check(sp, wh, out_dtype)
    b, d, h, wp, c2 = xp.shape
    f2 = wh.shape[-1]
    bias = _vec_arg(bias, f2, xp.device, "bias")
    c = _vec_arg(c, f2, xp.device, "c")
    lib = build()
    wt = tile_wh(wh)
    y = torch.empty((b, d - 2, h - 2, wp - 1, f2), dtype=out_dtype, device=xp.device)
    dy = torch.empty_like(y)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.wino_f23_pair_packed(
        xp.data_ptr(), sp.data_ptr(), wt.data_ptr(), bias.data_ptr(), c.data_ptr(),
        y.data_ptr(), dy.data_ptr(), *xp.stride()[:4], *sp.stride()[:4],
        b, d, h, wp, c2, f2, int(leaky), int(out_dtype == torch.float32), stream,
    )
    if rc != 0:
        raise RuntimeError(f"wino_f23 pair kernel launch failed with CUDA error {rc}")
    conv3d_wino_pair_packed.launches += 1
    return y, dy


conv3d_wino_pair_packed.launches = 0  # kernel launches since the last reset
