"""The direct packed conv kernels: build, bind, launch.

Replace two TPU kernels of the JAX package: ``ops/pallas_conv.py::
conv3d_pallas_packed`` (B4, ``conv3d_direct_packed`` here: all 18 packed taps
from one resident input window) and ``ops/stripe_conv.py::
conv3_packed_stripe`` (B5, the same name here: the input of N parts streamed
one D plane at a time).  Both are CUDA C++ for ``sm_90a`` (B4 in
``csrc/direct_conv.cu``, B5 in ``csrc/stripe_conv.cu``; their headers say what
bounds them and how they are built), compiled at first use by
``ops/_cuda_build.py`` and bound with ``ctypes``.

Both are written for Hopper: ``wgmma`` from shared memory in consumer
warpgroups, a producer warpgroup that brings the input in (B5: one D plane
at a time; B4: a patch's halo window, one 32-channel group at a time, by
blocks that stay resident and walk over patches), and a weight ring filled by
bulk asynchronous copies on mbarriers.  They read their weights as 8 KB
pieces, one per (column block, kd, channel group, kh, ka), each laid out as
``wgmma`` reads it; B5 runs them in the order they are stored, B4 with the
channel group outermost.  ``tile_wp`` makes them from ``pack_w3``'s (3, 3, 2,
C, Co) tensor (a permutation, plus zero columns up to a multiple of 128); a
caller that passes the plain tensor has it done on every call.

A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain PyTorch
version (``ops/direct_conv.py::conv3_packed_taps``).  There is no other
route.  Each entry point counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _cuda_build, s2d
from .direct_conv import as_parts, conv3_packed_taps

SOURCE = "direct_conv.cu"         # B4
STRIPE_SOURCE = "stripe_conv.cu"  # B5
MAX_PARTS = 4      # input parts one B5 launch takes
STRIPE_CTOT = 512  # most input channels, over all parts, that B5's two plane slots hold
TILE_N = 128       # output channels of a weight piece (the kernels' column block)
TILE_C = 32        # input channels of a weight piece
SMEM_MAX = 232448  # dynamic shared memory one block may use on the H100

_lib = None
_stripe_lib = None


class TiledWp:
    """Packed direct-conv weights in the layout kernels B4 and B5 read.

    ``tiles`` is (NB, 3, G, 6, 4, 128, 8): column block, kd, channel group,
    tap kh*2+ka, 8-channel step, output channel, channel; element
    ``[nb, kd, g, k, q, f, e]`` is ``wp[kd, k // 2, k % 2, 32 g + 8 q + e,
    128 nb + f]``, zero past ``co``.  ``shape``, ``dtype`` and ``device``
    describe the (3, 3, 2, C, Co) tensor it stands for.
    """

    __slots__ = ("tiles", "co")

    def __init__(self, tiles, co: int):
        if tiles.dim() != 7 or tiles.shape[1] != 3 \
                or tuple(tiles.shape[3:]) != (6, TILE_C // 8, TILE_N, 8) \
                or not 0 < co <= tiles.shape[0] * TILE_N:
            raise ValueError(f"not tiled direct-conv weights: {tuple(tiles.shape)}, Co = {co}")
        self.tiles, self.co = tiles, co

    @property
    def shape(self):
        return torch.Size((3, 3, 2, self.tiles.shape[2] * TILE_C, self.co))

    dtype = property(lambda self: self.tiles.dtype)
    device = property(lambda self: self.tiles.device)

    def dim(self):
        return 5

    def is_contiguous(self):
        return self.tiles.is_contiguous()

    def data_ptr(self):
        return self.tiles.data_ptr()

    def untiled(self):
        """The (3, 3, 2, C, Co) tensor, bit for bit."""
        nb, _, g = self.tiles.shape[:3]
        wp = self.tiles.permute(1, 3, 2, 4, 6, 0, 5).reshape(3, 3, 2, g * TILE_C, nb * TILE_N)
        return wp[..., :self.co].contiguous()


def tile_wp(wp) -> TiledWp:
    """(3, 3, 2, C, Co) from ``s2d.pack_w3`` -> the kernels' pieces."""
    if isinstance(wp, TiledWp):
        return wp
    if wp.dim() != 5 or tuple(wp.shape[:3]) != (3, 3, 2) or wp.shape[3] % TILE_C \
            or wp.shape[3] < TILE_C:
        raise ValueError(f"wp must be (3, 3, 2, C % {TILE_C} == 0, Co), got {tuple(wp.shape)}")
    c, co = wp.shape[3:]
    nb = -(-co // TILE_N)
    padded = torch.nn.functional.pad(wp, (0, nb * TILE_N - co))
    t = padded.reshape(3, 6, c // TILE_C, TILE_C // 8, 8, nb, TILE_N)
    return TiledWp(t.permute(5, 0, 2, 1, 3, 6, 4).contiguous(), co)


def _untiled(wp):
    return wp.untiled() if isinstance(wp, TiledWp) else wp


def bind_window(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare B4's entry point's argument types on a build of its source."""
    fn = lib.direct_conv_window
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 9
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def build() -> ctypes.CDLL:
    """Compile ``csrc/direct_conv.cu`` (B4; once per version of the source) and bind it."""
    global _lib
    if _lib is None:
        _lib = bind_window(_cuda_build.build(SOURCE))
    return _lib


def bind_stripe(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare B5's entry point's argument types on a build of its source."""
    fn = lib.stripe_conv
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def build_stripe() -> ctypes.CDLL:
    """Compile ``csrc/stripe_conv.cu`` (B5; once per version of the source) and bind it."""
    global _stripe_lib
    if _stripe_lib is None:
        _stripe_lib = bind_stripe(_cuda_build.build(STRIPE_SOURCE))
    return _stripe_lib


def _check_input(x, name):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bf16 inputs, {name} is {x.dtype}")
    if x.shape[-1] % 32 or x.shape[-1] < 32:
        raise ValueError(f"kernel takes channel counts that are multiples of 32, {name} has "
                         f"{x.shape[-1]}")
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:4]) or x.data_ptr() % 16:
        raise ValueError(f"{name} needs contiguous channels and 16-byte rows, strides {x.stride()}")
    b, d, h, wp, _ = x.shape
    if d < 3 or h < 3 or wp < 2 or b < 1:
        raise ValueError(f"{name} {tuple(x.shape)} is smaller than the 3x3x2 window")


def _check_weights(wp, ctot, device, out_dtype):
    if wp.dim() != 5 or tuple(wp.shape[:3]) != (3, 3, 2) or wp.shape[3] != ctot:
        raise ValueError(f"wp {tuple(wp.shape)} is not (3, 3, 2, {ctot}, Co)")
    if wp.dtype != torch.bfloat16:
        raise TypeError(f"kernel takes bf16 weights, got {wp.dtype}")
    if wp.shape[-1] % 8 or wp.shape[-1] < 8:
        raise ValueError(f"kernel takes Co % 8 == 0, got {wp.shape[-1]}")
    if wp.device != device or not wp.is_contiguous() or wp.data_ptr() % 16:
        raise ValueError("wp must be a contiguous, 16-byte aligned tensor on the input's device")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype must be bf16 or float32, got {out_dtype}")


def _bias_arg(bias, co, device):
    """The packed (Co,) float32 bias (None: zeros), contiguous on ``device``."""
    if bias is None:
        return torch.zeros(co, dtype=torch.float32, device=device)
    if bias.shape != (co,):
        raise ValueError(f"bias {tuple(bias.shape)} is not the packed ({co},) vector")
    return bias.to(device=device, dtype=torch.float32).contiguous()


def conv3d_direct_packed(xp, wp, bias_unpacked=None, *, leaky: bool = False):
    """Kernel B4.  Packed direct conv: xp (B, D, H, WP, 2C) -> (B, D-2, H-2,
    WP-1, 2C) in ``xp.dtype``.

    Args:
        xp: packed input; bf16 on CUDA.  Any strides with contiguous channels.
        wp: (3, 3, 2, 2C, 2C) packed kernel (``s2d.pack_w3``), square, or
            ``tile_wp`` of it; bf16 on CUDA.
        bias_unpacked: the unpacked (C,) float32 bias, or None.
        leaky: fuse LeakyReLU(0.01).
    """
    c2 = xp.shape[-1]
    if wp.shape[-2] != c2 or wp.shape[-1] != c2:
        raise ValueError(f"packed kernel must be square ({c2}, {c2}), got {tuple(wp.shape)}")
    if bias_unpacked is not None and bias_unpacked.shape != (c2 // 2,):
        raise ValueError(f"bias {tuple(bias_unpacked.shape)} is not the unpacked ({c2 // 2},) "
                         "vector")
    bias = None if bias_unpacked is None else s2d.pack_bias(bias_unpacked.float())
    if xp.device.type == "cpu":
        return conv3_packed_taps(xp, _untiled(wp), bias, leaky=leaky)
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    if xp.dim() != 5:
        raise ValueError(f"xp must be 5-D, got {tuple(xp.shape)}")
    _check_input(xp, "xp")
    _check_weights(wp, c2, xp.device, xp.dtype)
    bias = _bias_arg(bias, c2, xp.device)
    b, d, h, wpd, _ = xp.shape
    lib = build()
    wt = tile_wp(wp)
    y = torch.empty((b, d - 2, h - 2, wpd - 1, c2), dtype=xp.dtype, device=xp.device)
    sms = torch.cuda.get_device_properties(xp.device).multi_processor_count
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.direct_conv_window(
        xp.data_ptr(), wt.data_ptr(), bias.data_ptr(), y.data_ptr(),
        *xp.stride()[:4], b, d, h, wpd, c2, c2, int(leaky), 0, sms, stream,
    )
    if rc != 0:
        raise RuntimeError(f"direct_conv window kernel launch failed with CUDA error {rc}")
    conv3d_direct_packed.launches += 1
    return y


conv3d_direct_packed.launches = 0  # kernel launches since the last reset


def conv3d_direct(x, w, bias=None, *, leaky: bool = False):
    """Unpacked form of kernel B4: x (B, D, H, W, C) with W even, w (3, 3, 3,
    C, C), bias (C,) or None -> (B, D-2, H-2, W-2, C) in ``x.dtype``."""
    yp = conv3d_direct_packed(s2d.pack(x), s2d.pack_w3(w.to(x.dtype)), bias, leaky=leaky)
    return s2d.unpack(yp)


def stripe_block_h(ctot: int) -> int:
    """Output rows (H) of B5's block patch, 8 per consumer warpgroup: the two
    plane slots of (BH+2) x 9 cells x all input channels have to fit in shared
    memory beside the weight ring, so the patch shrinks from 16 to 8 rows (by
    8 packed cells) above 256 input channels."""
    return 16 if ctot <= 256 else 8


def stripe_smem_bytes(ctot: int, stages: int) -> int:
    """Shared memory of one B5 block (``csrc/stripe_conv.cu::smem_bytes``): the
    weight ring of 8 KB stages, two plane slots of 144 bytes per H row and 8
    channels, 9,216 bytes of bf16 staging per consumer warpgroup, 128 bias
    values and 20 mbarriers."""
    bh = stripe_block_h(ctot)
    return (stages * TILE_C * TILE_N * 2 + 2 * (ctot // 8) * (bh + 2) * 144
            + (bh // 8) * 9216 + TILE_N * 4 + 20 * 8)


def stripe_ring_stages(ctot: int) -> int:
    """Stages of B5's weight ring: as many as the plane slots leave, at most 8."""
    return min(8, (SMEM_MAX - stripe_smem_bytes(ctot, 0)) // (TILE_C * TILE_N * 2))


# The price of one more D segment, in units of one output plane's products:
# what a block does before its first product and after its last (two planes'
# loads, the ring's fill, the last plane's store, the next block's launch) and
# the uneven end of a wave.  Fitted to sweeps over the segment count on an H100
# (experiments/conv_ablation.py --segments) at four shapes; 2 to 3 pick the
# fastest cut at each.
_SEGMENT_START = 2.5


@functools.lru_cache(maxsize=None)
def stripe_segments(od: int, patches: int, sms: int) -> int:
    """How many D segments B5 cuts the ``od`` output planes into, given the
    number of (batch, h-strip, w-range, Co-tile) patches and of blocks the
    card runs at a time (``sms``: one block per SM).  A block walks one
    segment; the planes it re-reads arrive under its products, so a segment
    costs its planes plus a start-up.  More segments fill the card's SMs at
    the price of more start-ups: the count that maximises (share of the last
    wave that is busy) x (share of a block's time that is products)."""
    best, best_eff = 1, 0.0
    for nseg in range(1, od + 1):
        seg = -(-od // nseg)
        blocks = patches * -(-od // seg)
        eff = blocks / (-(-blocks // sms) * sms) * seg / (seg + _SEGMENT_START)
        if eff > best_eff + 1e-9:
            best, best_eff = nseg, eff
    return best


def conv3_packed_stripe(xps, wp, bias=None, *, leaky: bool = False, out_dtype=None):
    """Kernel B5.  Packed direct conv over the implicit channel concat of N
    parts, the input streamed one D plane at a time.

    Args:
        xps: one packed tensor (B, D, H, WP, Ci) or a sequence of up to 4
            sharing (B, D, H, WP); bf16 on CUDA.  Each part may have any
            strides with contiguous channels.
        wp: (3, 3, 2, sum(Ci), Co) packed kernel (``s2d.pack_w3`` with the
            matching ``groups``), or ``tile_wp`` of it; bf16 on CUDA.
        bias: (Co,) packed float32 bias (``s2d.pack_bias``), or None.
        leaky: fuse LeakyReLU(0.01).
        out_dtype: bf16 or float32 (default: the parts' dtype).
    Returns (B, D-2, H-2, WP-1, Co).
    """
    xps = as_parts(xps)
    out_dtype = out_dtype or xps[0].dtype
    device = xps[0].device
    if device.type == "cpu":
        return conv3_packed_taps(xps, _untiled(wp), bias, leaky=leaky, out_dtype=out_dtype)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if len(xps) > MAX_PARTS:
        raise ValueError(f"the kernel takes at most {MAX_PARTS} parts, got {len(xps)}")
    for i, x in enumerate(xps):
        _check_input(x, f"part {i}")
    cins = [x.shape[-1] for x in xps]
    ctot = sum(cins)
    if ctot > STRIPE_CTOT:
        raise ValueError(f"the kernel's plane slots hold at most {STRIPE_CTOT} input channels, "
                         f"got {ctot}")
    _check_weights(wp, ctot, device, out_dtype)
    co = wp.shape[-1]
    bias = _bias_arg(bias, co, device)
    b, d, h, wpd, _ = xps[0].shape
    od, oh, ow = d - 2, h - 2, wpd - 1
    patches = b * -(-oh // stripe_block_h(ctot)) * -(-ow // 8) * -(-co // TILE_N)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    dseg = -(-od // stripe_segments(od, patches, sms))
    lib = build_stripe()
    wt = tile_wp(wp)
    y = torch.empty((b, od, oh, ow, co), dtype=out_dtype, device=device)
    ptrs = (ctypes.c_void_p * MAX_PARTS)(*[x.data_ptr() for x in xps])
    strides = (ctypes.c_longlong * (4 * MAX_PARTS))(*[s for x in xps for s in x.stride()[:4]])
    cin_arr = (ctypes.c_int * MAX_PARTS)(*cins)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.stripe_conv(
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p),
        ctypes.cast(cin_arr, ctypes.c_void_p), len(xps),
        wt.data_ptr(), bias.data_ptr(), y.data_ptr(),
        b, d, h, wpd, ctot, co, dseg, stripe_ring_stages(ctot), int(leaky),
        int(out_dtype == torch.float32), stream,
    )
    if rc != 0:
        raise RuntimeError(f"stripe_conv kernel launch failed with CUDA error {rc}")
    conv3_packed_stripe.launches += 1
    return y


conv3_packed_stripe.launches = 0  # kernel launches since the last reset
