"""The direct packed conv kernels: build, bind, launch.

Replace two TPU kernels of the JAX package: ``ops/pallas_conv.py::
conv3d_pallas_packed`` (B4, ``conv3d_direct_packed`` here: all 18 packed taps
from one resident input window) and ``ops/stripe_conv.py::
conv3_packed_stripe`` (B5, the same name here: the input of N parts streamed
one D plane at a time).  Both are CUDA C++ for ``sm_90a`` in one source
(``csrc/direct_conv.cu``; its header says what bounds them and how they are
built), compiled at first use by ``ops/_cuda_build.py`` and bound with
``ctypes``.

A CUDA tensor runs the kernel or raises; a CPU tensor runs the plain PyTorch
version (``ops/direct_conv.py::conv3_packed_taps``).  There is no other
route.  Each entry point counts its kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda_build, s2d
from .direct_conv import as_parts, conv3_packed_taps

SOURCE = "direct_conv.cu"
MAX_PARTS = 4      # input parts one B5 launch takes
STRIPE_CTOT = 512  # most input channels, over all parts, that B5's plane ring holds

_lib = None


def build() -> ctypes.CDLL:
    """Compile ``csrc/direct_conv.cu`` (once per version of the source) and bind it."""
    global _lib
    if _lib is not None:
        return _lib
    lib = _cuda_build.build(SOURCE)
    fn = lib.direct_conv_window
    fn.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_int] * 8
        + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    fn = lib.direct_conv_stripe
    fn.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
        + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


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
        wp: (3, 3, 2, 2C, 2C) packed kernel (``s2d.pack_w3``), square; bf16 on CUDA.
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
        return conv3_packed_taps(xp, wp, bias, leaky=leaky)
    if xp.device.type != "cuda":
        raise ValueError(f"no kernel for device {xp.device}")
    if xp.dim() != 5:
        raise ValueError(f"xp must be 5-D, got {tuple(xp.shape)}")
    _check_input(xp, "xp")
    _check_weights(wp, c2, xp.device, xp.dtype)
    bias = _bias_arg(bias, c2, xp.device)
    b, d, h, wpd, _ = xp.shape
    lib = build()
    y = torch.empty((b, d - 2, h - 2, wpd - 1, c2), dtype=xp.dtype, device=xp.device)
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    rc = lib.direct_conv_window(
        xp.data_ptr(), wp.data_ptr(), bias.data_ptr(), y.data_ptr(),
        *xp.stride()[:4], b, d, h, wpd, c2, c2, int(leaky), 0, stream,
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


def stripe_segments(od: int, patches: int, sms: int) -> int:
    """How many D segments B5 cuts the ``od`` output planes into, given the
    number of (batch, h-strip, w-range, Co-tile) patches and of blocks the
    card runs at a time (``sms``: its SMs times the blocks per SM).  A block
    walks one segment and re-reads its 2 halo planes, so more segments fill
    the card's SMs at the price of re-read planes: the count that maximises
    (share of the last wave that is busy) x (share of the planes read that
    are not halo)."""
    best, best_eff = 1, 0.0
    for nseg in range(1, od + 1):
        seg = -(-od // nseg)
        blocks = patches * -(-od // seg)
        eff = blocks / (-(-blocks // sms) * sms) * seg / (seg + 2)
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
            matching ``groups``); bf16 on CUDA.
        bias: (Co,) packed float32 bias (``s2d.pack_bias``), or None.
        leaky: fuse LeakyReLU(0.01).
        out_dtype: bf16 or float32 (default: the parts' dtype).
    Returns (B, D-2, H-2, WP-1, Co).
    """
    xps = as_parts(xps)
    out_dtype = out_dtype or xps[0].dtype
    device = xps[0].device
    if device.type == "cpu":
        return conv3_packed_taps(xps, wp, bias, leaky=leaky, out_dtype=out_dtype)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if len(xps) > MAX_PARTS:
        raise ValueError(f"the kernel takes at most {MAX_PARTS} parts, got {len(xps)}")
    for i, x in enumerate(xps):
        _check_input(x, f"part {i}")
    cins = [x.shape[-1] for x in xps]
    ctot = sum(cins)
    if ctot > STRIPE_CTOT:
        raise ValueError(f"the kernel's plane ring holds at most {STRIPE_CTOT} input channels, "
                         f"got {ctot}")
    _check_weights(wp, ctot, device, out_dtype)
    co = wp.shape[-1]
    bias = _bias_arg(bias, co, device)
    b, d, h, wpd, _ = xps[0].shape
    od, oh, ow = d - 2, h - 2, wpd - 1
    bh = stripe_block_h(ctot)
    patches = b * -(-oh // bh) * -(-ow // 8) * -(-co // 128)
    slots = (torch.cuda.get_device_properties(device).multi_processor_count
             * stripe_blocks_per_sm(ctot))
    dseg = -(-od // stripe_segments(od, patches, slots))
    lib = build()
    y = torch.empty((b, od, oh, ow, co), dtype=out_dtype, device=device)
    ptrs = (ctypes.c_void_p * MAX_PARTS)(*[x.data_ptr() for x in xps])
    strides = (ctypes.c_longlong * (4 * MAX_PARTS))(*[s for x in xps for s in x.stride()[:4]])
    cin_arr = (ctypes.c_int * MAX_PARTS)(*cins)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = lib.direct_conv_stripe(
        ctypes.cast(ptrs, ctypes.c_void_p), ctypes.cast(strides, ctypes.c_void_p),
        ctypes.cast(cin_arr, ctypes.c_void_p), len(xps),
        wp.data_ptr(), bias.data_ptr(), y.data_ptr(),
        b, d, h, wpd, ctot, co, dseg, int(leaky), int(out_dtype == torch.float32), stream,
    )
    if rc != 0:
        raise RuntimeError(f"direct_conv stripe kernel launch failed with CUDA error {rc}")
    conv3_packed_stripe.launches += 1
    return y


conv3_packed_stripe.launches = 0  # kernel launches since the last reset


def stripe_block_h(ctot: int) -> int:
    """Output rows (H) of B5's block patch: the 2-slot plane ring of (BH+2) x
    9 cells x all input channels has to fit in shared memory, so the patch
    shrinks as the channel count grows (16 or 8 rows by 8 packed cells)."""
    return 16 if ctot <= 256 else 8


def stripe_blocks_per_sm(ctot: int) -> int:
    """Blocks of B5 that fit on one SM: two up to 128 input channels (where
    the kernel runs a 3-stage weight ring to make room), else one."""
    return 2 if ctot <= 128 else 1
