"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``jax_nbody_emulator_with_dj_tpu_torch/
csrc`` (one ``nvcc`` per source, all started together): B1, the F(2,3)^2
Winograd conv, and B2, its fused factored-tangent pair (``wino_f23.cu``: wgmma, mbarrier rings,
specialised warpgroups, a thread-block cluster for the pair); B4,
the direct conv with a resident window (``direct_conv.cu``), B5, the direct
conv streamed plane by plane over N parts (``stripe_conv.cu``), and B3, the
mixed F(2,3) x F(4,3) Winograd conv (``wino_f43.cu``), all three on wgmma with
mbarrier weight rings and specialised warpgroups.  Holds each against its plain PyTorch
version at the shapes its path gives it, drives the conv-route bench
(``experiments/conv_routes.py``, the path of B3, B4 and B5) at full width at
both of its default shapes and with two parts, then drives both model paths
at full width through ``create_emulator``
-> ``HierarchicalProcessor.process_box`` with seeded premodulated models
(mid_chan=64, 3 levels, bf16): the displacement model on a 128^3 box, and
the displacement+velocity model on a 128^3 box (every pair site runs B2),
each with the kernels on against the same box with them off, and one 256^3
velocity box (whose phase 1 is wider than the JAX package's pair threshold:
the port runs B2 there too, and B1 not at all).  16^3 boxes are held against
the models' own forwards on the wrap-padded input.  Then the flexible-
cosmology (style) models, the reference's default: 16^3 style disp and vel
boxes through the hierarchical runtime, kernels off and on, against the
subbox runtime on the card (the style forward, its velocity by
``torch.func.jvp``), and the style bf16 subbox against the float32 one; and
128^3 style disp and vel boxes through ``create_emulator(premodulate=False)``
-> ``HierarchicalProcessor.process_box``, whose per-box fold feeds B1 / B2,
timed, against the premodulated model folded at the same (z, Om).  Then the
other big-box runtimes (``runtimes``: the unpacked and y0-cached paths, 16^3
float32 against the packed run, 128^3 bf16 y0 cache on against off and
unpacked against packed; ``chunked``: 256^3 vel in two chunks against the
monolithic box, with a resume round trip; ``learned_vel``: a learned-dweight
velocity tree, whose tangent runs B1 three times a site, kernels on against
off) and the geometry planner (``planner``: every measured peak against its
estimate and ``memory_audit``, and the plans for 512^3 and 1024^3 on this
card).  B1 and B2 are also held against their plain versions at the y0
strip's conv shape and at a learned-tangent site.

Every phase prints one line; any failure raises (non-zero exit).  The line
before the last is a JSON summary of the kernels, the last one
``{"ok": true, "device": {...}}``.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GATE_KERNEL = 0.03  # max|d| / max|ref|, the JAX package's TPU kernel gate
GATE_PAIR_F32 = 1e-5  # B2 vs plain, float32 outputs: only the summation order differs
GATE_FLIPS = 1e-4  # share of elements where B2 and plain disagree on the sign of y
GATE_SLICE = 0.02  # rel max error of the box, wino on vs off
GATE_VEL = 0.08  # velocity: std(v1 - v0) / std(v0), the JAX package's gate
GATE_F32_VEL = 1e-3  # 16^3 f32 vel box vs model, rms: one LeakyReLU-tangent mask flip
                     # at a pre-activation within rounding of 0 moved CPU boxes by 1-3e-4
GATE_DIRECT_F32 = 1e-5  # B4/B5 vs plain, float32 out: only the summation order differs
GATE_MIXED = 0.08  # B3 (mixed Winograd), bf16 out: the JAX package's gate for its kernel
GATE_MIXED_F32 = 1e-4  # B3 vs plain, float32 out: same bf16 transforms, float32 sums reordered
                       # through AT4's entries of up to 8
CSRC = "jax_nbody_emulator_with_dj_tpu_torch/csrc/"
JAX_OPS = "jax_nbody_emulator_with_dj_tpu/ops/"
PHASE3 = (1, 142, 142, 71, 128)  # xp of the first conv of a 128^3 phase-3 tile
PHASE2A = (1, 68, 68, 34, 128)
# xp of conv_l01's first conv in a y0 strip segment: 128^3 box, tile H 128, segments of
# y0_slab_h = 68 rows (the strip's shapes: (142,74,71), (140,72,70), (138,70,69))
Y0_STRIP = (1, 140, 72, 70, 128)
RAGGED = (2, 13, 16, 21, 128)
PEAK_BOUND = 1.3  # the planner's estimate may exceed a measured peak by at most this factor
RUNS = 5  # warm process_box calls timed per configuration (median reported)


def log(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def cuda_ms(fn, n=10):
    """Mean device time of ``fn`` over ``n`` calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def phase_env():
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke run needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    log("env", python=sys.version.split()[0], torch=torch.__version__,
        cuda=torch.version.cuda, device=torch.cuda.get_device_name(0), card=card,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    return card


def phase_build():
    """One nvcc per source, all started together; then bind each library."""
    from jax_nbody_emulator_with_dj_tpu_torch.ops import (
        _cuda_build,
        direct_conv_cuda,
        winograd43_cuda,
        winograd_cuda,
    )

    sources = (winograd_cuda.SOURCE, direct_conv_cuda.SOURCE, direct_conv_cuda.STRIPE_SOURCE,
               winograd43_cuda.SOURCE)
    t0 = time.perf_counter()
    _cuda_build.build_all(sources)
    for bind in (winograd_cuda.build, direct_conv_cuda.build, direct_conv_cuda.build_stripe,
                 winograd43_cuda.build):
        bind()
    seconds = round(time.perf_counter() - t0, 3)
    for source in sources:
        # (no log when an earlier run left the library in _build/)
        ptxas = [ln.strip() for ln in _cuda_build.build_logs.get(source, "").splitlines()
                 if "Used" in ln or "spill" in ln]
        log("build", source=CSRC + source, seconds_all=seconds, ptxas=ptxas)


def phase_kernel():
    """Kernel B1 vs plain version at main-path shapes and at the shapes that
    reach each of its code paths: ragged D, H, W, an odd count of row tiles,
    F2 above 128 (more column blocks) and not a multiple of 64 (a ragged last
    column tile), C2 = 256, a strided view, float32 out, weights passed
    untiled (the wrapper tiles them) and tiled (as the model passes them)."""
    from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d
    from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd import (
        conv3_packed_wino,
        transform_packed_w3,
    )
    from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd_cuda import (
        conv3d_wino_packed,
        tile_wh,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    weights = {}

    def weight(c2, f2):  # (wh, tiled wh, OIDHW packed kernel for the library conv)
        if (c2, f2) not in weights:
            w = torch.randn((3, 3, 3, c2 // 2, f2 // 2), generator=gen, device=dev) \
                * (0.05 * (64 / c2) ** 0.5)
            wh = transform_packed_w3(s2d.pack_w3(w)).to(bf16).contiguous()
            weights[(c2, f2)] = wh, tile_wh(wh), s2d.oidhw_w3(s2d.pack_w3(w)).to(bf16)
        return weights[(c2, f2)]

    cases = [
        # (name, xp shape, F2, bias, leaky, out dtype, timed, tiled weights, strided view)
        ("phase3_entry_conv1", PHASE3, 128, True, False, bf16, True, True, False),
        ("phase3_entry_conv1", PHASE3, 128, True, True, f32, False, False, False),
        ("phase2a_conv_l1", PHASE2A, 128, True, True, bf16, True, True, False),
        ("phase2a_conv_l1", PHASE2A, 128, False, False, f32, False, False, True),
        ("decoder_conv0_256", (1, 36, 36, 18, 256), 256, True, True, bf16, False, True, False),
        ("decoder_conv1_256", (1, 36, 36, 18, 256), 128, True, True, f32, False, True, True),
        ("f2_192", (1, 20, 22, 12, 128), 192, True, True, bf16, False, True, False),
        ("f2_192", (1, 20, 22, 12, 128), 192, False, False, f32, False, False, True),
        ("f2_136_ragged_columns", RAGGED, 136, True, True, f32, False, True, True),
        ("f2_136_ragged_columns", RAGGED, 136, True, False, bf16, False, False, False),
        ("odd_tiles", (1, 9, 11, 7, 128), 128, True, True, f32, False, True, True),
        ("odd_tiles_c256", (1, 9, 11, 7, 256), 136, True, True, bf16, False, True, False),
        # the y0-cached disp path's strip
        ("y0_strip_conv_l01", Y0_STRIP, 128, True, True, bf16, False, True, True),
    ]
    cases += [("ragged", RAGGED, 128, b, lk, od, False, od == bf16, lk)
              for b in (True, False) for lk in (True, False) for od in (bf16, f32)]
    # a learned-dweight site: the tangent's two B1 launches (no bias, no act), on the
    # concat weight's parts of a seeded learned tree's conv_l1, at phase 2a's shape
    learned = _learned_site_weights(dev)
    cases += [(f"learned_tangent_{part}", PHASE2A, 128, False, False, bf16, False, True, False)
              for part in ("dW", "W")]
    rows = []
    for name, shape, f2, use_b, leaky, od, timed, tiled, view in cases:
        xp = _rand_view(shape, gen, dev, view)
        if name.startswith("learned_tangent_"):
            wt = learned[name.rsplit("_", 1)[1]]
            wh, w_oidhw = wt.untiled(), None
        else:
            wh, wt, w_oidhw = weight(shape[-1], f2)
        b = torch.randn(f2 // 2, generator=gen, device=dev) * 0.1 if use_b else None
        got = conv3d_wino_packed(xp, wt if tiled else wh, b, leaky=leaky, out_dtype=od)
        ref = conv3_packed_wino(xp, wh, b, leaky=leaky, out_dtype=od)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"{name}: bad kernel output {tuple(got.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        gate = GATE_PAIR_F32 if od == f32 else GATE_KERNEL  # float32: the summation order only
        row = dict(case=name, shape=list(shape), f2=f2, bias=use_b, leaky=leaky,
                   out=str(od).replace("torch.", ""), tiled_weights=tiled, strided_view=view,
                   max_abs_err=err, rel_err=rel, gate=gate)
        if timed:
            row["ms"] = cuda_ms(lambda: conv3d_wino_packed(xp, wt, b, leaky=leaky, out_dtype=od))
            row["plain_ms"] = cuda_ms(lambda: conv3_packed_wino(xp, wh, b, leaky=leaky, out_dtype=od))
            # the direct packed conv (cuDNN) that the path runs with wino=False
            row["library_ms"] = cuda_ms(lambda: s2d.conv3_packed(xp, w_oidhw))
            row["bound_ms"], row["bound_by"], _ = _routes().route_bound("B1", shape[1:4])
        log("kernel", **row)
        if not rel < gate:
            raise RuntimeError(f"{name}: kernel vs plain rel error {rel} >= {gate}")
        rows.append(row)
        del xp, got, ref
    torch.cuda.empty_cache()
    return rows


def _learned_site_weights(dev):
    """The tiled Winograd pieces of concat(dW, W) of conv_l1's first conv in a
    seeded learned-dweight velocity tree, as the model packs them:
    ``{"dW": ..., "W": ...}``."""
    from jax_nbody_emulator_with_dj_tpu_torch.models.blocks import pack_conv_layer_params
    from jax_nbody_emulator_with_dj_tpu_torch.models.unet import init_unet

    p = init_unet(3, style=False, vel=True)["params"]["conv_l1"]["conv_0"]
    pp = pack_conv_layer_params(p, "conv", vel=True, wino=True, dtype=torch.bfloat16, device=dev)
    return dict(zip(("dW", "W"), pp["whcat"]))


def _pair_errors(got, ref, fp32):
    """y: max error.  dy: max error where kernel and plain version agree on
    the sign of y (the LeakyReLU pair's mask), and the count of elements
    where they do not."""
    (y, dy), (y_ref, dy_ref) = [(t[0].float(), t[1].float()) for t in (got, ref)]
    y_abs = (y - y_ref).abs().max().item()
    agree = (y > 0) == (y_ref > 0)
    dy_abs = torch.where(agree, (dy - dy_ref).abs(), torch.zeros_like(dy)).max().item()
    y_err, dy_err = y_abs / y_ref.abs().max().item(), dy_abs / dy_ref.abs().max().item()
    flips = (~agree).sum().item()
    gate = GATE_PAIR_F32 if fp32 else GATE_KERNEL
    ok = y_err < gate and dy_err < gate and flips < GATE_FLIPS * y.numel()
    return dict(max_abs_err=max(y_abs, dy_abs), y_rel_err=y_err, dy_rel_err=dy_err,
                sign_flips=flips, flip_share=flips / y.numel(), gate=gate), ok


def phase_pair_kernel():
    """Kernel B2 vs its plain version at the main path's pair shapes, ragged
    ones, and the shapes of B1's phase that reach the kernel's other code
    paths; timed against the plain version, the two-singles form (two B1
    launches + a torch epilogue, what the JAX package runs above a packed-W
    width of 96) and the library form (two cuDNN convs + that epilogue)."""
    from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d
    from jax_nbody_emulator_with_dj_tpu_torch.ops.conv3d import leaky_relu_with_tangent
    from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd import (
        conv3_packed_wino_pair,
        transform_packed_w3,
    )
    from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd_cuda import (
        conv3d_wino_packed,
        conv3d_wino_pair_packed,
        tile_wh,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    whs, packed = {}, {}
    for ci, co in ((64, 64), (64, 128), (128, 64), (128, 128), (64, 96), (64, 68), (128, 68)):
        w = torch.randn((3, 3, 3, ci, co), generator=gen, device=dev) / (27 * ci) ** 0.5
        packed[(2 * ci, 2 * co)] = s2d.pack_w3(w).to(bf16)
        whs[(2 * ci, 2 * co)] = transform_packed_w3(s2d.pack_w3(w)).to(bf16).contiguous()
    cases = [
        # (name, xp shape, F2, bias and c, leaky, out dtype, timed, xp a strided view)
        ("phase3_conv_l01", (1, 142, 142, 71, 128), 128, True, True, bf16, True, False),
        ("phase3_conv_l01", (1, 142, 142, 71, 128), 128, True, True, f32, False, False),
        ("phase2a_conv_l1", (1, 68, 68, 34, 128), 128, True, True, bf16, True, False),
        ("decoder_conv0_part", (1, 36, 36, 18, 128), 256, False, False, bf16, True, False),
        ("decoder_conv1", (1, 36, 36, 18, 256), 128, True, False, bf16, True, False),
        # 256^3 phase 1: owp 129, above the JAX package's threshold for the pair kernel
        ("phase1_256_conv_l01", (1, 36, 260, 130, 128), 128, True, True, bf16, True, False),
        ("phase1_256_conv_l01", (1, 36, 260, 130, 128), 128, True, True, f32, False, True),
        ("f2_192", (1, 20, 22, 12, 128), 192, True, True, bf16, False, True),
        ("f2_192", (1, 20, 22, 12, 128), 192, False, False, f32, False, False),
        ("f2_136_ragged_columns", RAGGED, 136, True, True, f32, False, True),
        ("f2_136_ragged_columns", RAGGED, 136, True, False, bf16, False, False),
        ("odd_tiles", (1, 9, 11, 7, 128), 128, True, True, f32, False, True),
        ("odd_tiles_c256", (1, 9, 11, 7, 256), 136, True, True, bf16, False, True),
        # the y0-cached vel path's strip (a window of the padded box, as the runtime reads it)
        ("y0_strip_conv_l01", Y0_STRIP, 128, True, True, bf16, False, True),
    ]
    cases += [("ragged", (2, 13, 16, 21, 128), f2, bc, lk, od, False, view)
              for f2, bc, lk, od, view in (
                  (128, True, True, bf16, True), (128, True, True, f32, False),
                  (128, False, False, f32, True), (128, True, False, bf16, False),
                  (256, True, True, f32, True), (256, False, False, bf16, False))]
    cases += [("ragged_c256", (1, 9, 11, 7, 256), 128, True, True, f32, False, True),
              ("ragged_c256", (1, 9, 11, 7, 256), 256, True, True, bf16, False, False)]
    rows = []
    for name, shape, f2, use_bc, leaky, od, timed, view in cases:
        c2 = shape[-1]
        wh = whs[(c2, f2)]
        wt = tile_wh(wh)  # timed as the model passes them; checked as given (tiled by the wrapper)
        # xp as a window of a larger (padded) buffer, as the runtime reads it; sp contiguous
        xp = _rand_view(shape, gen, dev, view)
        sp = torch.randn(shape, generator=gen, device=dev).to(bf16)
        bias = torch.randn(f2 // 2, generator=gen, device=dev) * 0.1 if use_bc else None
        c = torch.randn(f2, generator=gen, device=dev) * 0.3 if use_bc else None
        got = conv3d_wino_pair_packed(xp, sp, wh, bias, c, leaky=leaky, out_dtype=od)
        ref = conv3_packed_wino_pair(xp, sp, wh, bias, c, leaky=leaky, out_dtype=od)
        torch.cuda.synchronize()
        for g, r in zip(got, ref):
            if g.shape != r.shape or g.dtype != r.dtype or not torch.isfinite(g).all():
                raise RuntimeError(f"{name}: bad pair kernel output {tuple(g.shape)} {g.dtype}")
        errs, ok = _pair_errors(got, ref, od == f32)
        row = dict(case=name, shape=list(shape), f2=f2, bias_c=use_bc, leaky=leaky,
                   out=str(od).replace("torch.", ""), strided_view=view, **errs)
        if timed:
            bp = s2d.pack_bias(bias) if use_bc else None

            def singles():
                z = conv3d_wino_packed(xp, wt, out_dtype=od)
                zt = conv3d_wino_packed(sp, wt, out_dtype=od)
                y = z if bp is None else z + bp.to(z.dtype)
                dy = zt if c is None else zt - c.to(z.dtype) * z
                return leaky_relu_with_tangent(y, dy) if leaky else (y, dy)

            row["ms"] = cuda_ms(lambda: conv3d_wino_pair_packed(xp, sp, wt, bias, c, leaky=leaky,
                                                                out_dtype=od))
            row["plain_ms"] = cuda_ms(lambda: conv3_packed_wino_pair(xp, sp, wh, bias, c,
                                                                     leaky=leaky, out_dtype=od))
            row["singles_ms"] = cuda_ms(singles)
            w_lib = s2d.oidhw_w3(packed[(c2, f2)])

            def library():  # one pair site with the kernels off: two cuDNN convs + epilogue
                z = s2d.conv3_packed(xp, w_lib)
                zt = s2d.conv3_packed(sp, w_lib)
                y = z if bp is None else z + bp.to(z.dtype)
                dy = zt if c is None else zt - c.to(z.dtype) * z
                return leaky_relu_with_tangent(y, dy) if leaky else (y, dy)

            row["library_ms"] = cuda_ms(library)
            routes = _routes()  # twice B1's multiplies; two inputs read, two outputs written
            macs = 2 * routes.route_macs("B1", shape[1:4], c2, f2)
            nbytes = (2 * routes.conv_bytes(shape[1:4], c2, f2, 32, n_out=1)
                      - 32 * c2 * f2 * 2)  # ... and the shared weights once
            row["bound_ms"], row["bound_by"] = routes.bound_ms(macs, nbytes)
        log("pair_kernel", **row)
        if not ok:
            raise RuntimeError(f"{name}: pair kernel vs plain version out of gate: {errs}")
        rows.append(row)
        del xp, sp, got, ref
    torch.cuda.empty_cache()
    return rows


def _routes():
    from jax_nbody_emulator_with_dj_tpu_torch.experiments import conv_routes

    return conv_routes


def _rand_view(shape, gen, dev, view):
    """A bf16 input of ``shape``; with ``view`` a window of a larger (padded)
    buffer, as the runtime reads its level buffers."""
    if not view:
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    b, d, h, wp, c = shape
    big = torch.randn((b, d + 3, h + 2, wp + 5, c), generator=gen, device=dev).to(torch.bfloat16)
    return big[:, 2:2 + d, 1:1 + h, 3:3 + wp]


def _held(phase, name, got, ref, gate, row):
    """Log one kernel-vs-plain row; raise if it is out of its gate."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype or not torch.isfinite(got).all():
        raise RuntimeError(f"{name}: bad kernel output {tuple(got.shape)} {got.dtype}")
    err = (got.float() - ref.float()).abs().max().item()
    rel = err / ref.float().abs().max().item()
    row.update(case=name, max_abs_err=err, rel_err=rel, gate=gate)
    log(phase, **row)
    if not rel < gate:
        raise RuntimeError(f"{phase} {name}: kernel vs plain rel error {rel} >= {gate}")
    return row


def phase_direct_kernel():
    """Kernel B4 (direct conv, resident window) vs its plain version, bf16, at
    the path's shapes and at those that reach each of its code paths: an
    output of exactly one patch and of less than one, an odd count of output
    planes (the second plane of the last patch masked), H not a multiple of
    16 and ragged W with odd patch counts, C of 64, 96, 256 and 320 (one to
    three column blocks, a ragged last one; two to ten channel groups through
    the three window slots), strided views, weights tiled beforehand or by
    the wrapper."""
    from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d
    from jax_nbody_emulator_with_dj_tpu_torch.ops.direct_conv import conv3_packed_taps
    from jax_nbody_emulator_with_dj_tpu_torch.ops.direct_conv_cuda import (
        conv3d_direct_packed,
        tile_wp,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    weights = {}

    def weight(c2):  # (wp, tiled wp, OIDHW packed kernel for the library conv, unpacked bias)
        if c2 not in weights:
            w = torch.randn((3, 3, 3, c2 // 2, c2 // 2), generator=gen, device=dev) \
                * (0.05 * (128 / c2) ** 0.5)
            wp = s2d.pack_w3(w).to(torch.bfloat16).contiguous()
            weights[c2] = (wp, tile_wp(wp), s2d.oidhw_w3(wp),
                           torch.randn(c2 // 2, generator=gen, device=dev) * 0.1)
        return weights[c2]

    cases = [  # (name, xp shape, bias, leaky, timed, xp a strided view)
        ("phase3_conv", PHASE3, True, True, True, False),
        ("phase3_conv", PHASE3, False, False, False, False),
        ("phase2a_conv", PHASE2A, True, True, True, False),
        ("decoder_conv_256", (1, 36, 36, 18, 256), False, True, True, False),
        ("one_patch", (1, 4, 18, 9, 128), True, True, False, True),
        ("less_than_one_patch", (1, 3, 3, 2, 128), True, False, False, False),
        ("odd_planes_ragged_h", (1, 5, 37, 18, 128), True, True, False, False),
        ("odd_patches_c256", (1, 9, 11, 7, 256), True, True, False, True),
        ("c64", (2, 7, 19, 12, 64), True, True, False, True),
        ("c96", (1, 9, 20, 10, 96), False, True, False, False),
        ("c320", (1, 7, 19, 12, 320), True, True, False, True),
        ("c320", (2, 5, 35, 9, 320), True, False, False, False),
    ]
    cases += [("ragged", RAGGED, b, lk, False, view)
              for b, lk, view in ((True, True, True), (True, False, False),
                                  (False, True, False), (False, False, True))]
    rows = []
    for n, (name, shape, use_b, leaky, timed, view) in enumerate(cases):
        xp = _rand_view(shape, gen, dev, view)
        wp, wt, w_oidhw, bias = weight(shape[-1])
        b = bias if use_b else None
        bp = None if b is None else s2d.pack_bias(b)
        tiled = n % 2 == 0  # tiled beforehand or by the wrapper, in turns
        got = conv3d_direct_packed(xp, wt if tiled else wp, b, leaky=leaky)
        ref = conv3_packed_taps(xp, wp, bp, leaky=leaky)
        row = dict(shape=list(shape), bias=use_b, leaky=leaky, out="bfloat16", strided_view=view,
                   tiled_weights=tiled)
        if timed:  # as the model would pass them: tiled once
            row["ms"] = cuda_ms(lambda: conv3d_direct_packed(xp, wt, b, leaky=leaky))
            row["plain_ms"] = cuda_ms(lambda: conv3_packed_taps(xp, wp, bp, leaky=leaky), n=3)
            row["library_ms"] = cuda_ms(lambda: s2d.conv3_packed(xp, w_oidhw))
            row["bound_ms"], row["bound_by"], _ = _routes().route_bound(
                "B4", shape[1:4], 1, shape[-1], shape[-1])
        rows.append(_held("direct_kernel", name, got, ref, GATE_KERNEL, row))
        del xp, got, ref
    torch.cuda.empty_cache()
    return rows


def phase_stripe_kernel():
    """Kernel B5 (direct conv, plane-streamed, N parts) vs its plain version:
    one to four parts, a non-square kernel, bf16 and float32 out, and the
    shapes that reach each of its code paths: an output of one patch, ragged
    D, H and W with an odd count of patches, Co of 72, 136, 192 and 256 (a
    ragged last column tile, a second column block), 256, 320 and 512 input
    channels (two consumer warpgroups, and one with an accumulator set per
    kd), strided views, weights tiled beforehand or by the wrapper."""
    from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d
    from jax_nbody_emulator_with_dj_tpu_torch.ops.direct_conv import conv3_packed_taps
    from jax_nbody_emulator_with_dj_tpu_torch.ops.direct_conv_cuda import (
        conv3_packed_stripe,
        tile_wp,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (name, part shape, packed channels per part, Co, bias, leaky, out, timed, view)
        ("phase3_conv", PHASE3, (128,), 128, True, True, bf16, True, False),
        ("phase3_conv", PHASE3, (128,), 128, False, False, f32, False, False),
        ("phase2a_conv", PHASE2A, (128,), 128, True, True, bf16, True, False),
        ("phase3_two_parts", PHASE3, (128, 128), 128, True, True, bf16, True, False),
        ("decoder_concat_conv0", (1, 36, 36, 18, 128), (128, 128), 256, True, True, bf16, True,
         False),
        ("decoder_concat_conv0", (1, 36, 36, 18, 128), (128, 128), 256, True, False, f32, False,
         True),
        ("three_parts", (1, 20, 22, 12, 128), (128, 128, 128), 128, True, True, bf16, False, False),
        ("three_parts", (1, 20, 22, 12, 128), (128, 128, 128), 128, False, False, f32, False, True),
        ("four_unequal_parts", (2, 9, 11, 10, 0), (32, 64, 128, 96), 72, True, True, f32, False,
         False),
        ("four_unequal_parts", (2, 9, 11, 10, 0), (32, 64, 128, 96), 72, True, True, bf16, False,
         True),
        ("one_patch", (1, 3, 10, 9, 0), (128,), 128, True, True, f32, False, True),
        ("one_patch_c512", (1, 3, 10, 9, 0), (256, 256), 136, True, True, bf16, False, False),
        ("c512_co136", (1, 7, 19, 12, 0), (256, 256), 136, True, True, f32, False, True),
        ("c512_co256", (2, 13, 16, 21, 0), (128, 128, 128, 128), 256, False, False, bf16, False,
         False),
        ("co192", (1, 20, 22, 12, 0), (128,), 192, True, True, bf16, False, True),
        ("co192", (1, 20, 22, 12, 0), (128,), 192, True, False, f32, False, False),
        ("odd_patches_c256", (1, 9, 11, 7, 0), (256,), 136, True, True, f32, False, True),
    ]
    cases += [("ragged", RAGGED, cins, 128, bb, lk, od, False, view)
              for cins, bb, lk, od, view in (
                  ((128,), True, True, bf16, True), ((128,), False, False, f32, False),
                  ((128, 128), True, True, f32, True), ((128, 128), False, True, bf16, False),
                  ((64, 128), True, False, f32, False))]
    rows = []
    for n, (name, shape, cins, co, use_b, leaky, od, timed, view) in enumerate(cases):
        xps = tuple(_rand_view(shape[:4] + (c,), gen, dev, view and i == 0)
                    for i, c in enumerate(cins))
        ctot = sum(cins)
        wp = (torch.randn((3, 3, 2, ctot, co), generator=gen, device=dev)
              / (13.5 * ctot) ** 0.5).to(bf16)
        wt = tile_wp(wp)  # timed as tiled once; checked tiled beforehand or by the wrapper, in turns
        tiled = n % 2 == 0
        bp = torch.randn(co, generator=gen, device=dev) * 0.1 if use_b else None
        got = conv3_packed_stripe(xps, wt if tiled else wp, bp, leaky=leaky, out_dtype=od)
        ref = conv3_packed_taps(xps, wp, bp, leaky=leaky, out_dtype=od)
        row = dict(shape=list(shape[:4]), cins=list(cins), co=co, bias=use_b, leaky=leaky,
                   out=str(od).replace("torch.", ""), strided_view=view, tiled_weights=tiled)
        if timed:
            w_oidhw = s2d.oidhw_w3(wp)
            row["ms"] = cuda_ms(lambda: conv3_packed_stripe(xps, wt, bp, leaky=leaky, out_dtype=od))
            row["plain_ms"] = cuda_ms(
                lambda: conv3_packed_taps(xps, wp, bp, leaky=leaky, out_dtype=od), n=3)
            # cuDNN on the materialised concat
            row["library_ms"] = cuda_ms(lambda: s2d.conv3_packed(
                xps[0] if len(xps) == 1 else torch.cat(xps, dim=-1), w_oidhw))
            row["bound_ms"], row["bound_by"], _ = _routes().route_bound(
                "B5", shape[1:4], len(cins), cins[0], co)
        gate = GATE_DIRECT_F32 if od == f32 else GATE_KERNEL
        rows.append(_held("stripe_kernel", name, got, ref, gate, row))
        del xps, got, ref
    torch.cuda.empty_cache()
    return rows


def phase_wino43_kernel():
    """Kernel B3 (mixed F(2,3) x F(4,3) Winograd) vs its plain version, at the
    path's shapes and at those that reach each of its code paths: an output
    of one patch, ragged D, H and W with an odd count of patches, F2 of 72,
    136, 192 and 256 (a ragged last column tile, up to four column blocks),
    C2 = 256, strided views, weights tiled beforehand or by the wrapper."""
    from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d
    from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd import (
        conv3_packed_wino43,
        transform_packed_w3_mixed,
    )
    from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd43_cuda import (
        conv3d_wino43_packed,
        tile_what,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    bf16, f32 = torch.bfloat16, torch.float32
    weights = {}

    def weight(c2, f2):  # (what, tiled what, OIDHW packed kernel for the library conv, bias)
        if (c2, f2) not in weights:
            w = torch.randn((3, 3, 3, c2 // 2, f2 // 2), generator=gen, device=dev) \
                * (0.05 * (128 / c2) ** 0.5)
            what = transform_packed_w3_mixed(s2d.pack_w3(w)).to(bf16).contiguous()
            weights[(c2, f2)] = (what, tile_what(what), s2d.oidhw_w3(s2d.pack_w3(w)).to(bf16),
                                 torch.randn(f2 // 2, generator=gen, device=dev) * 0.1)
        return weights[(c2, f2)]

    cases = [  # (name, xp shape, F2, bias, leaky, out dtype, timed, xp a strided view)
        ("phase3_conv", PHASE3, 128, True, True, bf16, True, False),
        ("phase3_conv", PHASE3, 128, False, False, f32, False, False),
        ("phase2a_conv", PHASE2A, 128, True, True, bf16, True, False),
        ("phase2a_conv", PHASE2A, 128, True, False, f32, False, False),
        ("decoder_conv1_256", (1, 36, 36, 18, 256), 128, True, True, bf16, False, False),
        ("decoder_conv0_256", (1, 36, 36, 18, 256), 256, True, True, f32, False, True),
        ("one_patch", (1, 6, 18, 9, 128), 128, True, True, f32, False, True),
        ("f2_192", (1, 20, 22, 12, 128), 192, True, True, bf16, False, True),
        ("f2_192", (1, 20, 22, 12, 128), 192, False, False, f32, False, False),
        ("f2_136_ragged_columns", RAGGED, 136, True, True, f32, False, True),
        ("f2_72", RAGGED, 72, True, False, bf16, False, False),
        ("odd_patches_c256", (1, 9, 11, 7, 256), 136, True, True, f32, False, False),
    ]
    cases += [("ragged", RAGGED, 128, b, lk, od, False, view)
              for b, lk, od, view in ((True, True, bf16, True), (True, True, f32, False),
                                      (False, False, bf16, False), (False, False, f32, True))]
    cases += [("ragged_odd", (1, 9, 11, 7, 128), 128, True, True, f32, False, True)]
    rows = []
    for n, (name, shape, f2, use_b, leaky, od, timed, view) in enumerate(cases):
        xp = _rand_view(shape, gen, dev, view)
        what, wt, w_oidhw, bias = weight(shape[-1], f2)
        b = bias if use_b else None
        tiled = n % 2 == 0  # tiled beforehand or by the wrapper, in turns
        got = conv3d_wino43_packed(xp, wt if tiled else what, b, leaky=leaky, out_dtype=od)
        ref = conv3_packed_wino43(xp, what, b, leaky=leaky, out_dtype=od)
        row = dict(shape=list(shape), f2=f2, bias=use_b, leaky=leaky,
                   out=str(od).replace("torch.", ""), strided_view=view, tiled_weights=tiled)
        if timed:
            row["ms"] = cuda_ms(lambda: conv3d_wino43_packed(xp, wt, b, leaky=leaky, out_dtype=od))
            row["plain_ms"] = cuda_ms(
                lambda: conv3_packed_wino43(xp, what, b, leaky=leaky, out_dtype=od), n=3)
            row["library_ms"] = cuda_ms(lambda: s2d.conv3_packed(xp, w_oidhw))
            row["bound_ms"], row["bound_by"], _ = _routes().route_bound("B3", shape[1:4])
        gate = GATE_MIXED_F32 if od == f32 else GATE_MIXED
        rows.append(_held("wino43_kernel", name, got, ref, gate, row))
        del xp, got, ref
    torch.cuda.empty_cache()
    return rows


def phase_conv_routes():
    """The path of B3, B4 and B5: the conv-route bench at full width, at both
    of its default shapes and with two parts.  The kernels' counts are set to
    0 just before and read just after; every route must pass its gate (the
    bench raises otherwise) and each of the three kernels must have launched."""
    from jax_nbody_emulator_with_dj_tpu_torch.ops.direct_conv_cuda import (
        conv3_packed_stripe,
        conv3d_direct_packed,
    )
    from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd43_cuda import conv3d_wino43_packed

    routes = _routes()
    wrappers = dict(B3=conv3d_wino43_packed, B4=conv3d_direct_packed, B5=conv3_packed_stripe)
    for fn in wrappers.values():
        fn.launches = 0
    rows = []
    for shape, parts in ((routes.SHAPES[0], 1), (routes.SHAPES[1], 1), (routes.SHAPES[0], 2)):
        rows += routes.run(shape, parts, "cuda",
                           emit=lambda line: log("conv_routes", **json.loads(line)))
        torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    log("conv_routes_launches", **launches)
    missing = [k for k, n in launches.items() if n <= 0]
    if missing or not all(r["ok"] for r in rows):
        raise RuntimeError(f"conv routes: kernels launched 0 times: {missing}; rows {rows}")
    return launches


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _rms(a, b):
    return float((a.astype(np.float64) - b).std() / b.astype(np.float64).std())


def _emulator(vel, seed, style=False, learned=False, **kw):
    """A seeded full-width model on the card: premodulated at (z, Om) = (0.5, 0.3),
    or with ``style`` the style model, which takes the cosmology per call; with
    ``learned`` a premodulated velocity tree whose tangent kernels are learned
    (``dweight`` without the fold's rank structure)."""
    from jax_nbody_emulator_with_dj_tpu_torch import create_emulator
    from jax_nbody_emulator_with_dj_tpu_torch.models.unet import init_unet

    params = init_unet(seed, style=False, vel=True) if learned else init_unet(seed, style=True)
    return create_emulator(premodulate=not style, compute_vel=vel, params=params,
                           premodulate_z=0.5, premodulate_Om=0.3, device="cuda", **kw)


def _config(n, **kw):
    from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalConfig

    return HierarchicalConfig(size=(n,) * 3, output_dtype=torch.float32, **kw)


def _check_box(out, n, vel, what):
    outs = out if vel else (out,)
    for o in outs:
        if o.shape != (3, n, n, n) or not np.isfinite(o).all():
            raise RuntimeError(f"{what}: bad output, shape {o.shape}")
    return outs


def phase_small_box(vel):
    """Hierarchical runtime vs the model's own forward on a wrap-padded 16^3
    box, float32: kernels off (only the summation order differs) and on
    (bf16 operands, the JAX package's gates for its kernel path)."""
    from jax_nbody_emulator_with_dj_tpu_torch.hierarchical import _wrap_pad

    n = 16
    box = np.random.default_rng(1).standard_normal((3, n, n, n)).astype(np.float32)
    xpad = _wrap_pad(torch.from_numpy(box)[None], 48)
    ref = _emulator(vel, 1).apply(xpad, 0.5, 0.3)
    ref = [t[0].cpu().numpy() for t in (ref if vel else (ref,))]
    for wino in (False, True):
        cfg = _config(n, slab=8, tile=(8, 8, 8), dtype=torch.float32, wino=wino)
        out = _check_box(_emulator(vel, 1, processor_config=cfg).process_box(box, 0.5, 0.3),
                         n, vel, "16^3 box")
        errs = dict(disp_rel_max_err=_rel(out[0], ref[0]),
                    disp_gate=GATE_SLICE if wino else 2e-4)
        ok = errs["disp_rel_max_err"] < errs["disp_gate"]
        if vel:
            errs.update(vel_rms_err=_rms(out[1], ref[1]), vel_gate=GATE_VEL if wino else GATE_F32_VEL,
                        vel_rel_max_err=_rel(out[1], ref[1]))
            ok = ok and errs["vel_rms_err"] < errs["vel_gate"]
        log("small_box_vs_model", vel=vel, wino=wino, size=n, **errs)
        if not ok:
            raise RuntimeError(f"16^3 box (vel={vel}, wino={wino}) vs model forward: {errs}")


# Every full-width box whose peak this run measures, for the planner phase:
# (label, config, vel, learned tangent, measured peak, estimate, memory_audit max_total).
PEAKS = []


def _record_peak(label, cfg, vel, proc, peak):
    """The planner's estimate of ``cfg`` (``experiments/profile_box.py``: a
    chunked config's inner run plus the staged next chunk) and the inner
    processor's ``memory_audit`` beside the measured peak."""
    from jax_nbody_emulator_with_dj_tpu_torch.experiments.profile_box import estimate

    est = estimate(cfg, vel, learned_tangent=proc.learned_tangent)
    PEAKS.append(dict(box=label, vel=vel, learned_tangent=proc.learned_tangent, peak=peak,
                      estimate=est, audit_max_total=proc.memory_audit()["max_total"]))


def _launch_counts():
    from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd_cuda as wc

    return dict(B1=wc.conv3d_wino_packed.launches, B2=wc.conv3d_wino_pair_packed.launches)


def _reset_counts():
    from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd_cuda as wc

    wc.conv3d_wino_packed.launches = wc.conv3d_wino_pair_packed.launches = 0


def _timed_box(vel, n, wino, seed=0, runs=RUNS, style=False, learned=False, label=None,
               **cfg_kw):
    """Warm-up, then ``runs`` process_box calls (the first with the kernel
    counts set to 0 just before and read just after, and the peak of
    ``torch.cuda.max_memory_allocated``), then one profiled call."""
    box = np.random.default_rng(seed).standard_normal((3, n, n, n)).astype(np.float32)
    cfg = _config(n, dtype=torch.bfloat16, wino=wino, **cfg_kw)
    emu = _emulator(vel, seed, style=style, learned=learned, processor_config=cfg)
    emu.process_box(box, 0.5, 0.3)  # warm-up (cuDNN plans, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = emu.process_box(box, 0.5, 0.3)  # returns numpy: ends in a sync
    walls = [time.perf_counter() - t0]
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for _ in range(runs - 1):
        t0 = time.perf_counter()
        emu.process_box(box, 0.5, 0.3)
        walls.append(time.perf_counter() - t0)
    emu.process_box(box, 0.5, 0.3, profile=True)
    phases = {k: round(v * 1e3, 3) for k, v in emu.processor.last_timings.items()}
    wall = float(np.median(walls))
    label = label or ("style_slice" if style else "slice")
    log(label, vel=vel, wino=emu.processor.wino, size=n, mid_chan=64, dtype="bfloat16",
        packed=cfg.packed, y0_cache=cfg.y0_cache, tile=list(cfg.tile), learned_tangent=learned,
        median_wall_s=wall, walls_s=walls, voxels_per_s=n**3 / wall, launches=launches,
        phase_ms=phases, max_memory_allocated=peak)
    _record_peak(f"{label}_{n}_{'vel' if vel else 'disp'}_wino_{emu.processor.wino}", cfg, vel,
                 emu.processor, peak)
    out = _check_box(out, n, vel, f"{n}^3 box")
    del emu
    torch.cuda.empty_cache()
    return out, launches


def phase_slice(vel):
    """A main path at full width: 128^3, mid_chan=64, bf16, kernels on and off.

    Returns the kernel launch counts and the outputs of the kernels-on run.
    The disp path runs B1 at every Winograd site; the vel path runs B2 at
    every pair site."""
    n = 128
    on, launches = _timed_box(vel, n, None, slab=32, tile=(n,) * 3)  # None: on for CUDA
    off, launches_off = _timed_box(vel, n, False, slab=32, tile=(n,) * 3)
    errs = dict(disp_rel_max_err=_rel(on[0], off[0]), disp_gate=GATE_SLICE)
    ok = errs["disp_rel_max_err"] < GATE_SLICE
    if vel:
        errs.update(vel_rms_err=_rms(on[1], off[1]), vel_gate=GATE_VEL)
        ok = ok and errs["vel_rms_err"] < GATE_VEL
    log("slice_compare", vel=vel, **errs)
    kernel = "B2" if vel else "B1"
    if launches[kernel] <= 0:
        raise RuntimeError(f"the {'vel' if vel else 'disp'} path launched {kernel} 0 times")
    if any(launches_off.values()):
        raise RuntimeError(f"wino=False still launched a kernel: {launches_off}")
    if not ok:
        raise RuntimeError(f"slice (vel={vel}) kernels on vs off: {errs}")
    return launches, on


def phase_vel_256():
    """One 256^3 velocity box: phase 1's packed-W output width (130) is above
    the JAX package's threshold for its pair kernel; the port has none, so
    every pair site runs B2 and B1 is not launched.  Returns its output."""
    out, launches = _timed_box(True, 256, None, runs=1, slab=32, tile=(128,) * 3)
    if launches["B1"] != 0 or launches["B2"] <= 0:
        raise RuntimeError(f"256^3 vel box: expected B2 at every pair site and no B1: {launches}")
    return out


def _style_box(vel, n, box, cfg):
    """The style model through ``create_emulator(premodulate=False)`` on the card."""
    return _check_box(_emulator(vel, 1, style=True, processor_config=cfg).process_box(
        box, 0.5, 0.3), n, vel, f"style {n}^3 box")


def phase_style_small_box():
    """Style disp and vel 16^3 boxes, float32: the hierarchical runtime (the
    per-box fold, kernels off and on) against the subbox runtime on the card,
    which runs the style forward itself and, for velocity, ``torch.func.jvp``
    through cuDNN's channels-last convs.  Then that subbox run in bf16 against
    float32, printed and held at the kernel path's gates."""
    from jax_nbody_emulator_with_dj_tpu_torch import SubboxConfig

    n = 16
    box = np.random.default_rng(1).standard_normal((3, n, n, n)).astype(np.float32)
    for vel in (False, True):
        ref = _style_box(vel, n, box, SubboxConfig(size=(n,) * 3, ndiv=(2, 1, 1)))
        rows = []
        for wino in (False, True):
            out = _style_box(vel, n, box, _config(n, slab=8, tile=(8, 8, 8), dtype=torch.float32,
                                                  wino=wino))
            rows.append((f"hierarchical_wino_{wino}", out, GATE_SLICE if wino else 2e-4,
                         GATE_VEL if wino else GATE_F32_VEL))
        out = _style_box(vel, n, box, SubboxConfig(size=(n,) * 3, ndiv=(2, 1, 1),
                                                    dtype=torch.bfloat16))
        rows.append(("subbox_bf16", out, GATE_SLICE, GATE_VEL))
        for name, out, disp_gate, vel_gate in rows:
            errs = dict(disp_rel_max_err=_rel(out[0], ref[0]), disp_gate=disp_gate)
            ok = errs["disp_rel_max_err"] < disp_gate
            if vel:
                errs.update(vel_rms_err=_rms(out[1], ref[1]), vel_gate=vel_gate,
                            vel_rel_max_err=_rel(out[1], ref[1]))
                ok = ok and errs["vel_rms_err"] < vel_gate
            log("style_small_box_vs_subbox", vel=vel, run=name, size=n, **errs)
            if not ok:
                raise RuntimeError(f"style 16^3 box (vel={vel}, {name}) vs subbox: {errs}")


def phase_style_slice(premodulated):
    """The style models' path at full width: 128^3, mid_chan=64, bf16, through
    ``create_emulator(premodulate=False)`` -> ``process_box``, timed as the
    premodulated slice (``fold`` in ``phase_ms`` is the per-box fold + pack),
    against ``premodulated[vel]``, the premodulated model's output of the same
    box with the style folded at the same (z, Om) and the same config (the
    ``slice`` phase's kernels-on run).  Returns the kernels' launch counts per
    style box."""
    n = 128
    launches = {}
    for vel in (False, True):
        out, launches[vel] = _timed_box(vel, n, None, style=True, slab=32, tile=(n,) * 3)
        ref = premodulated[vel]
        errs = dict(disp_rel_max_err=_rel(out[0], ref[0]), disp_gate=GATE_SLICE)
        ok = errs["disp_rel_max_err"] < GATE_SLICE
        if vel:
            errs.update(vel_rms_err=_rms(out[1], ref[1]), vel_gate=GATE_VEL,
                        vel_rel_max_err=_rel(out[1], ref[1]))
            ok = ok and errs["vel_rms_err"] < GATE_VEL
        log("style_slice_vs_premodulated", vel=vel, **errs)
        kernel = "B2" if vel else "B1"
        if launches[vel][kernel] <= 0:
            raise RuntimeError(f"the style {'vel' if vel else 'disp'} path launched {kernel} "
                               "0 times")
        if not ok:
            raise RuntimeError(f"style slice (vel={vel}) vs premodulated fold: {errs}")
    return launches


def _kernel_gates(vel, got, ref):
    """The kernel path's gates: disp rel max < 0.02, vel rms < 0.08."""
    errs = dict(disp_rel_max_err=_rel(got[0], ref[0]), disp_gate=GATE_SLICE)
    ok = errs["disp_rel_max_err"] < GATE_SLICE
    if vel:
        errs.update(vel_rms_err=_rms(got[1], ref[1]), vel_gate=GATE_VEL,
                    vel_rel_max_err=_rel(got[1], ref[1]))
        ok = ok and errs["vel_rms_err"] < GATE_VEL
    return errs, ok


def phase_runtimes(packed_on):
    """The unpacked and y0-cached hierarchical paths.  16^3 float32 boxes (kernels
    off) through each against the packed monolithic run of the same model, at
    the 16^3 gates (disp rel max < 2e-4, vel rms < 1e-3; the y0 cache at a tile
    that splits W into 4); then 128^3 bf16 disp and vel with tile (128, 128,
    64) (two W tiles share each strip), y0 cache on against off at the kernel
    gates, B1 (disp) and B2 (vel) launching in both; then 128^3 disp and vel
    unpacked (cuDNN, no kernel) against ``packed_on[vel]``, the ``slice``
    phase's kernels-on output.
    Returns the launches per box of each path."""
    n = 16
    box = np.random.default_rng(1).standard_normal((3, n, n, n)).astype(np.float32)
    for vel in (False, True):
        def run(**kw):
            cfg = _config(n, slab=8, dtype=torch.float32, wino=False, **{"tile": (8, 8, 8), **kw})
            return _check_box(_emulator(vel, 1, processor_config=cfg).process_box(box, 0.5, 0.3),
                              n, vel, "16^3 box")

        ref = run()
        for name, kw in (("unpacked", dict(packed=False)),
                         ("y0_cache", dict(y0_cache=True, tile=(8, 8, 4))),
                         ("unpacked_y0_cache", dict(packed=False, y0_cache=True, tile=(8, 8, 4)))):
            out = run(**kw)
            errs = dict(disp_rel_max_err=_rel(out[0], ref[0]), disp_gate=2e-4)
            ok = errs["disp_rel_max_err"] < 2e-4
            if vel:
                errs.update(vel_rms_err=_rms(out[1], ref[1]), vel_gate=GATE_F32_VEL,
                            vel_rel_max_err=_rel(out[1], ref[1]))
                ok = ok and errs["vel_rms_err"] < GATE_F32_VEL
            log("runtimes_small_box_vs_packed", vel=vel, run=name, size=n, **errs)
            if not ok:
                raise RuntimeError(f"16^3 {name} box (vel={vel}) vs packed: {errs}")
    launches = {}
    tile = (128, 128, 64)
    for vel in (False, True):
        kind, kernel = ("vel", "B2") if vel else ("disp", "B1")
        outs = {}
        for y0 in (False, True):
            key = f"{kind}128_tile64_y0_{y0}"
            outs[y0], launches[key] = _timed_box(vel, 128, None, runs=3, slab=32, tile=tile,
                                                 y0_cache=y0, label="runtimes_y0_cache")
            if launches[key][kernel] <= 0:
                raise RuntimeError(f"{key}: {kernel} launched 0 times")
        errs, ok = _kernel_gates(vel, outs[True], outs[False])
        log("runtimes_y0_cache_compare", vel=vel, size=128, tile=list(tile), **errs)
        if not ok:
            raise RuntimeError(f"128^3 {kind} y0 cache on vs off: {errs}")
    for vel in (False, True):
        out, lc = _timed_box(vel, 128, None, runs=3, slab=32, tile=(128,) * 3, packed=False,
                             label="runtimes_unpacked")
        launches[f"{'vel' if vel else 'disp'}128_unpacked"] = lc
        if any(lc.values()):
            raise RuntimeError(f"the unpacked path launched a kernel: {lc}")
        errs, ok = _kernel_gates(vel, out, packed_on[vel])
        log("runtimes_unpacked_vs_packed", vel=vel, size=128, **errs)
        if not ok:
            raise RuntimeError(f"128^3 unpacked (vel={vel}) vs packed: {errs}")
    return launches


def phase_chunked(mono):
    """The chunked runtime at full width: 256^3 vel bf16, ``chunks=(2, 1, 1)``
    (pad 48, inner (224, 256, 256)), through ``create_emulator`` against
    ``mono``, the 256^3 monolithic box of ``phase_vel_256``, at the kernel
    gates.  Its first call writes a resume directory (and warms up); the timed
    call (kernel counts set to 0 just before, peak memory) must equal it byte
    for byte; a second call on the directory must return the same bytes
    without any inner run (``profile_box.py --chunks 2 1 1`` gives its
    phases).  The host gather runs the native staging helper, which must
    have built.  Returns the launches per box."""
    import tempfile

    from jax_nbody_emulator_with_dj_tpu_torch import ChunkedHierarchicalConfig
    from jax_nbody_emulator_with_dj_tpu_torch.native import native_staging_available

    if not native_staging_available():
        raise RuntimeError("the native staging helper did not build (g++)")
    n = 256
    box = np.random.default_rng(0).standard_normal((3, n, n, n)).astype(np.float32)
    cfg = ChunkedHierarchicalConfig(size=(n,) * 3, chunks=(2, 1, 1), dtype=torch.bfloat16,
                                    output_dtype=torch.float32)
    emu = _emulator(True, 0, processor_config=cfg)
    proc = emu.processor
    with tempfile.TemporaryDirectory() as rdir:
        first = emu.process_box(box, 0.5, 0.3, resume_dir=rdir)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        out = emu.process_box(box, 0.5, 0.3)
        wall = time.perf_counter() - t0
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        inner_runs = []
        real = proc.inner.process_box
        proc.inner.process_box = lambda *a, **k: inner_runs.append(1) or real(*a, **k)
        resumed = emu.process_box(box, 0.5, 0.3, resume_dir=rdir)
        proc.inner.process_box = real
    same = all(np.array_equal(a, b) for a, b in zip(first, out))
    resumed_same = all(np.array_equal(a, b) for a, b in zip(resumed, first))
    errs, ok = _kernel_gates(True, _check_box(out, n, True, "chunked 256^3 box"), mono)
    log("chunked", vel=True, size=n, chunks=list(cfg.chunks), pad=cfg.pad,
        inner_size=list(cfg.inner_size), inner_tile=list(proc.inner.config.tile),
        inner_tile1=proc.inner.config.tile1, wall_s=wall, voxels_per_s=n**3 / wall,
        launches=launches, max_memory_allocated=peak,
        repeat_equal=same, resume_equal=resumed_same, resume_inner_runs=len(inner_runs),
        native_staging=True, **errs)
    _record_peak("chunked_256_vel_211", cfg, True, proc.inner, peak)
    if launches["B2"] <= 0:
        raise RuntimeError(f"the chunked vel box launched B2 0 times: {launches}")
    if not (same and resumed_same) or inner_runs:
        raise RuntimeError(f"chunked resume: repeat equal {same}, resumed equal {resumed_same}, "
                           f"inner runs on resume {len(inner_runs)}")
    if not ok:
        raise RuntimeError(f"chunked 256^3 vs monolithic: {errs}")
    del emu, proc
    torch.cuda.empty_cache()
    return launches


def phase_learned_vel():
    """A seeded learned-dweight velocity tree at full width, 128^3 bf16: the
    materialized tangent, three B1 launches a Winograd site and no B2, with the
    kernels on against off at the kernel gates.  Returns the launches per box."""
    on, launches = _timed_box(True, 128, None, runs=3, learned=True, slab=32, tile=(128,) * 3,
                              label="learned_vel")
    off, launches_off = _timed_box(True, 128, False, runs=3, learned=True, slab=32,
                                   tile=(128,) * 3, label="learned_vel")
    errs, ok = _kernel_gates(True, on, off)
    log("learned_vel_compare", size=128, **errs)
    if launches["B1"] <= 0 or launches["B2"] != 0 or any(launches_off.values()):
        raise RuntimeError(f"learned vel: expected B1 and no B2 with the kernels on, nothing "
                           f"off: {launches}, {launches_off}")
    if not ok:
        raise RuntimeError(f"learned vel 128^3 kernels on vs off: {errs}")
    return launches


def phase_planner():
    """The geometry planner on this card: for every full-width box this run
    measured, measured peak <= estimate <= 1.3 x the peak, with its
    ``memory_audit()["max_total"]`` beside it; then the plans for 512^3 and
    1024^3 vel in bf16 and float32 on this card's memory (``hbm_bytes=None``)."""
    from jax_nbody_emulator_with_dj_tpu_torch import (
        ChunkedHierarchicalConfig,
        auto_hierarchical_config,
    )
    from jax_nbody_emulator_with_dj_tpu_torch.experiments.profile_box import estimate

    bad = []
    for rec in PEAKS:
        ratio = rec["estimate"] / rec["peak"]
        rec.update(estimate_over_peak=ratio, bound=PEAK_BOUND)
        log("planner_peak", **rec)
        if not 1.0 <= ratio <= PEAK_BOUND:
            bad.append(rec["box"])
    for n in (512, 1024):
        for dtype in (torch.bfloat16, torch.float32):
            cfg = auto_hierarchical_config(n, dtype=dtype, compute_vel=True)
            geom = cfg.inner_config() if isinstance(cfg, ChunkedHierarchicalConfig) else cfg
            log("planner_plan", size=n, dtype=str(dtype).replace("torch.", ""), vel=True,
                kind=type(cfg).__name__, chunks=list(getattr(cfg, "chunks", (1, 1, 1))),
                run_size=list(geom.size), slab=geom.slab, slab_h=geom.slab_h,
                tile=list(geom.tile), tile1=geom.tile1, estimate=estimate(cfg, True),
                card_bytes=torch.cuda.mem_get_info()[1])
    if bad:
        raise RuntimeError(f"planner estimate outside [peak, {PEAK_BOUND} x peak] for {bad}")


def _kernel_entry(name, source, replaces, launches, rows):
    """One entry of the ``kernels`` line: the worst error over the kernel's
    rows, the times and the bound of its first timed row (the phase-3 shape)."""
    timed = next(r for r in rows if "ms" in r)
    return {
        "name": name, "route": "cuda", "source": CSRC + source, "replaces": JAX_OPS + replaces,
        "launches": launches, "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": timed["ms"], "plain_ms": timed["plain_ms"], "bound_ms": timed["bound_ms"],
        "bound_by": timed["bound_by"], "library_ms": timed["library_ms"],
        "shape": timed["shape"],
    }


def main():
    card = phase_env()
    sys.path.insert(0, str(ROOT))
    phase_build()
    rows = phase_kernel()
    pair_rows = phase_pair_kernel()
    phase_small_box(vel=False)
    phase_small_box(vel=True)
    launches_disp, out_disp = phase_slice(vel=False)
    launches_vel, out_vel = phase_slice(vel=True)
    out_256 = phase_vel_256()
    phase_style_small_box()
    launches_style = phase_style_slice({False: out_disp, True: out_vel})
    path_launches = phase_runtimes({False: out_disp, True: out_vel})
    path_launches["vel256_chunked_211"] = phase_chunked(out_256)
    path_launches["vel128_learned"] = phase_learned_vel()
    del out_256
    phase_planner()
    direct_rows = phase_direct_kernel()
    stripe_rows = phase_stripe_kernel()
    wino43_rows = phase_wino43_kernel()
    launches_routes = phase_conv_routes()
    kernels = [
        _kernel_entry("conv3d_wino_packed (B1, wino_f23)", "wino_f23.cu",
                      "winograd_pallas.py:259", launches_disp["B1"], rows),
        _kernel_entry("conv3d_wino_pair_packed (B2, wino_f23 pair)", "wino_f23.cu",
                      "winograd_pallas.py:558", launches_vel["B2"], pair_rows),
        _kernel_entry("conv3d_wino43_packed (B3, wino_f43)", "wino_f43.cu",
                      "winograd43_pallas.py:240", launches_routes["B3"], wino43_rows),
        _kernel_entry("conv3d_direct_packed (B4, direct_conv window)", "direct_conv.cu",
                      "pallas_conv.py:209", launches_routes["B4"], direct_rows),
        _kernel_entry("conv3_packed_stripe (B5, stripe_conv)", "stripe_conv.cu",
                      "stripe_conv.py:192", launches_routes["B5"], stripe_rows),
    ]
    kernels[1]["singles_ms"] = next(r for r in pair_rows if "ms" in r)["singles_ms"]
    # launches per 128^3 box on the style models' path (the per-box fold feeds B1 / B2)
    kernels[0]["style_launches"] = launches_style[False]["B1"]
    kernels[1]["style_launches"] = launches_style[True]["B2"]
    # launches per box of the y0-cached, unpacked, chunked and learned-tangent paths
    for entry, key in ((kernels[0], "B1"), (kernels[1], "B2")):
        entry["path_launches"] = {path: lc[key] for path, lc in path_launches.items()}
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
