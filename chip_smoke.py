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
strip's conv shape and at a learned-tangent site.  Then the science toolkit
(``science``: every field function on the card against the same function on
the CPU at 128^3, FoF from card tensors, the pipeline's functions timed at
512^3) and the science pipeline (``pipeline``: ``run_lpt_emulator_pipeline``
at 512^3 disp+vel and 256^3 disp with ``runtime="auto"``, two emulator calls
each, B2 / B1 launching, the Gaussian random field's P(k) against its EH98
input).  Then the multi-device layer on a (2, 2, 2) mesh of eight virtual
shards on the card (``sharded``: the sharded hierarchical runtime against the
single-device one at 32^3 float32, 256^3 and the 512^3 headline vel box,
B1 / B2 launching on every shard, and a style box folded once per call;
``sharded_science``: every sharded science function against its single-device
counterpart at 128^3 on (2, 2, 2) and (4, 2, 1), the GRF -> 1LPT -> density ->
P(k) chain timed at 512^3; ``dryrun``: ``parallel.dryrun.dryrun_multichip(8)``).

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


SCIENCE_N = 128  # card vs CPU comparisons
SCIENCE_TIMED_N = 512  # the pipeline's headline size
GATE_SCIENCE_FFT = 1e-5  # rel max, FFT fields: cuFFT against the CPU's FFT
GATE_SCIENCE_DEPOSIT = 1e-4  # max abs on rho/rho_bar: float32 atomics (10x the CPU tests' 1e-5)
GATE_SCIENCE_PK = 1e-5  # rtol of binned spectra, shells with a mode
GATE_SCIENCE_BISPECTRUM = 1e-4
GATE_GRF_PK = 0.03  # |mean P_measured / P_EH98 - 1| over 0.02 <= k <= 0.2 h/Mpc


def _science_compare(name, got, ref, kind):
    """Hold a card result against the CPU's; log it; raise if out of gate."""
    g, r = (np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x, np.float64)
            for x in (got, ref))
    if g.shape != r.shape or not np.isfinite(g).all():
        raise RuntimeError(f"science {name}: bad card output {g.shape}")
    err = float(np.abs(g - r).max())
    row = dict(case=name, kind=kind, max_abs_err=err)
    if kind == "fft":
        row.update(rel_err=err / float(np.abs(r).max()), gate=GATE_SCIENCE_FFT)
        ok = row["rel_err"] < GATE_SCIENCE_FFT
    elif kind == "deposit":
        row.update(gate=GATE_SCIENCE_DEPOSIT)
        ok = err < GATE_SCIENCE_DEPOSIT
    elif kind == "equal":
        row.update(gate=0.0)
        ok = err == 0.0
    else:  # binned spectra and bispectra: rtol, with a floor of rtol x max|ref| (signed sums)
        gate = GATE_SCIENCE_BISPECTRUM if kind == "bispectrum" else GATE_SCIENCE_PK
        excess = np.abs(g - r) - gate * (np.abs(r) + np.abs(r).max() * (kind != "pk"))
        row.update(worst_rel_err=float(np.max(np.abs(g - r) / np.maximum(np.abs(r), 1e-30))),
                   gate=gate)
        ok = bool((excess <= 0).all())
    log("science", **row)
    if not ok:
        raise RuntimeError(f"science {name}: card vs CPU out of gate: {row}")


def phase_science():
    """The science toolkit on the card against the same functions on the CPU, at
    128^3, float32, one seeded input for both: every field function (the GRF's
    noise core, 1LPT, the deposit in all four orders, deconvolution, the
    spectra, resizing, smoothing, Minkowski functionals, the bispectrum); then
    the host code fed from card tensors (positions, FoF native against numpy).
    Then the pipeline's functions at 512^3, timed (CUDA events, one warm-up,
    mean of 3).  Every ``irfftn`` user is held here: cuFFT's complex-to-real
    transform answers otherwise than the CPU's where its input is not
    Hermitian in the self-conjugate planes."""
    from jax_nbody_emulator_with_dj_tpu_torch import science as sci
    from jax_nbody_emulator_with_dj_tpu_torch.native import native_fof_available
    from jax_nbody_emulator_with_dj_tpu_torch.science import grf, mas, resize

    if not native_fof_available():
        raise RuntimeError("the native FoF helper did not build (g++)")
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    n, box = SCIENCE_N, 500.0
    k_tab = np.logspace(-4, 2, 512)
    p_tab = sci.eisenstein_hu_pk(k_tab)
    rng = np.random.default_rng(9)
    noise = torch.from_numpy(rng.standard_normal((n, n, n)).astype(np.float32))
    noise_up = torch.from_numpy(rng.standard_normal((2 * n,) * 3).astype(np.float32))

    def both(fn, *args):
        """fn on the card and on the CPU, each with its own copy of the tensors."""
        def on(d):
            return fn(*(a.to(d) if torch.is_tensor(a) else a for a in args))
        got = on(dev)
        torch.cuda.synchronize()
        return got, on(cpu)

    def check(name, fn, *args, kind="fft"):
        got, ref = both(fn, *args)
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        for i, (g, r) in enumerate(pairs):
            _science_compare(f"{name}[{i}]" if isinstance(got, tuple) else name, g, r, kind)
        return ref

    delta = check("grf_core", grf._colour_noise, noise, box, k_tab, p_tab)
    check("grf_core_fixed_amplitude",
          lambda x: grf._colour_noise(x, box, k_tab, p_tab, fixed_amplitude=True), noise)
    psi = check("zeldovich_displacement", sci.zeldovich_displacement, delta, box)
    for worder in (1, 2, 3, 4):
        check(f"deposit_displacement_w{worder}",
              lambda p, w=worder: mas.deposit_displacement(p, box, worder=w), psi, kind="deposit")
        check(f"displacement_to_density_w{worder}",
              lambda p, w=worder: sci.displacement_to_density(p, box, worder=w), psi)
    check("deposit_nmesh96",
          lambda p: mas.deposit_displacement(p, box, nmesh=96, worder=2), psi, kind="deposit")
    rho = mas.deposit_displacement(psi, box, worder=2)
    check("deconvolve_mas", lambda d: sci.deconvolve_mas(d, 2), rho - 1.0)
    check("mas_window", lambda d: mas.mas_window(n, 4, d.device), delta)
    delta_nl = sci.displacement_to_density(psi, box)
    check("power_spectrum", lambda d: sci.power_spectrum(d, box), delta_nl, kind="pk")
    check("cross_power", lambda a, b: sci.cross_power(a, b, box), delta_nl, delta,
          kind="signed")
    check("transfer_and_correlation",
          lambda a, b: sci.transfer_and_correlation(a, b, box), delta_nl, delta, kind="signed")
    check("upsample_modes_core", lambda d, w: resize._upsample_modes_from_noise(
        d, w, 2 * n, box, k_tab, p_tab), delta, noise_up)
    check("upsample_fourier", lambda d: sci.upsample_fourier(d, 2 * n), delta)
    check("upsample_linear", lambda d: sci.upsample_linear(d, 2 * n), delta)
    check("downsample_average", lambda d: sci.downsample_average(d, n // 2), delta)
    check("gaussian_smooth", lambda d: sci.gaussian_smooth(d, box, 8.0), delta)
    check("resize_density_grid_down", lambda d: sci.resize_density_grid(d, n // 4, box, r_smooth=8.0),
          delta)
    check("minkowski_functionals",
          lambda d: sci.minkowski_functionals(d, [-0.5, 0.0, 0.5]), delta_nl, kind="equal")
    got, ref = both(lambda d: sci.reduced_bispectrum(d, box, 0.1, 0.15, np.linspace(0.2, 3.0, 4)),
                    delta_nl)
    for key in ("B", "Q", "P3"):
        _science_compare(f"reduced_bispectrum_{key}", got[key], ref[key], "bispectrum")
    # host code fed from the card: summary metrics, positions, FoF (64^3 of the grid)
    a, b = (sci.summary_metrics(delta_nl.to(d), delta.to(d), box) for d in (dev, cpu))
    _science_compare("summary_metrics", [a[key] for key in sorted(a)],
                     [b[key] for key in sorted(b)], "signed")
    psi64 = sci.zeldovich_displacement(delta[::2, ::2, ::2].contiguous(), box)
    pos = sci.positions_from_displacement(psi64.to(dev), box)
    _science_compare("positions_from_displacement", pos,
                     sci.positions_from_displacement(psi64, box), "equal")
    b_link = 0.5 * box / (n // 2)  # half the mean spacing: groups at any seed
    t0 = time.perf_counter()
    native = sci.friends_of_friends(pos, box, b_link, nmin=2, engine="native")
    native_s = time.perf_counter() - t0
    numpy_ = sci.friends_of_friends(pos, box, b_link, nmin=2, engine="numpy")
    same = all(np.array_equal(native[key], numpy_[key]) for key in native)
    log("science", case="friends_of_friends_64", particles=len(pos), n_groups=native["n_groups"],
        native_equals_numpy=same, native_s=native_s)
    if not same or native["n_groups"] < 1:
        raise RuntimeError("FoF on the card's displacement: native and numpy engines differ")

    # the pipeline's field functions at 512^3 on the card
    nt = SCIENCE_TIMED_N
    gen = torch.Generator(device=dev).manual_seed(0)
    d512 = sci.gaussian_random_field(gen, nt, 1000.0, k_tab, p_tab, device=dev)
    p512 = sci.zeldovich_displacement(d512, 1000.0)
    rows = {
        "gaussian_random_field": lambda: sci.gaussian_random_field(
            gen, nt, 1000.0, k_tab, p_tab, device=dev),
        "zeldovich_displacement": lambda: sci.zeldovich_displacement(d512, 1000.0),
        "displacement_to_density_cic_deconvolved": lambda: sci.displacement_to_density(
            p512, 1000.0, worder=2, deconvolve=True),
        "power_spectrum": lambda: sci.power_spectrum(d512, 1000.0),
        "minkowski_functionals_3": lambda: sci.minkowski_functionals(d512, [-0.5, 0.0, 0.5]),
    }
    timed = {}
    for name, fn in rows.items():
        torch.cuda.reset_peak_memory_stats()
        timed[name] = cuda_ms(fn, n=3)
        log("science_512", function=name, size=nt, ms=timed[name],
            max_memory_allocated=torch.cuda.max_memory_allocated())
    del d512, p512
    torch.cuda.empty_cache()
    return timed


def phase_pipeline(card):
    """``run_lpt_emulator_pipeline`` on the card at the headline size: seed 42,
    512^3, 1000 Mpc/h, z=0, ``runtime="auto"`` (the planner's geometry), bf16,
    disp+vel at full width (a seeded style tree as ``_emulator`` builds it,
    folded at (z, Om)), two emulator calls, twice; then 256^3 with the
    displacement model.  The kernels' counts are set to 0 just before each run and read just
    after (both emulator calls): the vel run must launch B2, the disp run B1.
    The GRF's measured P(k) must follow the EH98 input.  Returns the launches
    of each run."""
    from jax_nbody_emulator_with_dj_tpu_torch import (
        ChunkedHierarchicalConfig,
        auto_hierarchical_config,
        run_lpt_emulator_pipeline,
    )
    from jax_nbody_emulator_with_dj_tpu_torch import science as sci
    from jax_nbody_emulator_with_dj_tpu_torch.models.unet import init_unet

    params = init_unet(0, style=True)
    launches = {}
    # the 512^3 run twice: the first pipeline call of a process pays one-off costs
    # (cuFFT plans, the first fold and pack), the second is what each later box costs
    runs = (("pipeline_512_vel", 512, True), ("pipeline_512_vel_warm", 512, True),
            ("pipeline_256_disp", 256, False))
    for label, n, vel in runs:
        cfg = auto_hierarchical_config(n, dtype=torch.bfloat16, compute_vel=vel,
                                       output_dtype=torch.float32, mid_chan=64)
        geom = cfg.inner_config() if isinstance(cfg, ChunkedHierarchicalConfig) else cfg
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        res = run_lpt_emulator_pipeline(
            seed=42, n_part=n, boxsize=1000.0, z=0.0, runtime="auto", precision="bf16",
            compute_vel=vel, mid_chan=64, num_sims=2, params=params, premodulate=True,
            device="cuda")
        wall = time.perf_counter() - t0
        launches[label] = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        outs = [res.psi_emu] + ([res.vel_emu] if vel else [])
        for o in outs + [res.psi_lpt]:
            if o.shape != (3, n, n, n) or not np.isfinite(o).all():
                raise RuntimeError(f"{label}: bad displacement/velocity {o.shape}")
        for o in (res.delta_lin, res.delta_lpt, res.delta_emu):
            if o.shape != (n, n, n) or not np.isfinite(o).all():
                raise RuntimeError(f"{label}: bad density {o.shape}")
        k, pk, counts = (t.cpu().numpy() for t in sci.power_spectrum(
            torch.from_numpy(res.delta_lin).cuda(), 1000.0))
        sel = (k >= 0.02) & (k <= 0.2) & (counts >= 1)
        k_tab = np.logspace(-4, 2, 512)
        p_in = np.exp(np.interp(np.log(k[sel]), np.log(k_tab),
                                np.log(sci.eisenstein_hu_pk(k_tab))))
        grf_ratio = float(np.mean(pk[sel] / p_in))
        staged = sum(res.timings[f"{key}_seconds"] for key in (
            "ic", "lpt", "lpt_density", "emulator_build", "emu_density"))
        staged += sum(res.timings["emulator_runs_seconds"])
        # wall time outside the timed stages: the kept fields' copies to the host
        log("pipeline", run=label, n_part=n, vel=vel, card=card, wall_s=wall,
            untimed_s=wall - staged, timings=res.timings, max_memory_allocated=peak, launches=launches[label],
            launches_per_box={key: v / 2 for key, v in launches[label].items()},
            plan=type(cfg).__name__, chunks=list(getattr(cfg, "chunks", (1, 1, 1))),
            slab=geom.slab, slab_h=geom.slab_h, tile=list(geom.tile), tile1=geom.tile1,
            grf_pk_mean_ratio=grf_ratio, grf_gate=GATE_GRF_PK, metadata_device=res.metadata["device"])
        kernel = "B2" if vel else "B1"
        if launches[label][kernel] <= 0:
            raise RuntimeError(f"{label}: {kernel} launched 0 times: {launches[label]}")
        if abs(grf_ratio - 1.0) > GATE_GRF_PK:
            raise RuntimeError(f"{label}: GRF P(k) / EH98 = {grf_ratio}")
        del res, outs
    torch.cuda.empty_cache()
    return launches


SHARDED_MESH = (2, 2, 2)
SHARDED_N = 256  # held against the single-device runtime, disp and vel
SHARDED_HEADLINE_N = 512  # the headline vel box, sharded and on one device
SHARDED_STYLE_N = 128  # one fold per call
SHARDED_SCIENCE_N = 128
GATE_SHARDED_F32 = 2e-4  # rel max, float32 disp with the kernels off: float reordering only


def _virtual_mesh(shape):
    """A mesh of ``prod(shape)`` virtual shards on the one card."""
    from jax_nbody_emulator_with_dj_tpu_torch.parallel import make_mesh

    return make_mesh(shape, devices=[torch.device("cuda")] * int(np.prod(shape)))


def _sharded_errors(field, ref, vel):
    """Rel max (and, for a velocity, rms) error of a ``ShardedField`` against a
    card tensor of the whole box, block by block on the card (no gather)."""
    diff = ref_max = 0.0
    sq_d = sq_r = s_d = s_r = 0.0
    for i, part in enumerate(field.parts):
        r = ref[field.index(i)].double()
        d = part.double() - r
        diff, ref_max = max(diff, d.abs().max().item()), max(ref_max, r.abs().max().item())
        sq_d, sq_r = sq_d + (d * d).sum().item(), sq_r + (r * r).sum().item()
        s_d, s_r = s_d + d.sum().item(), s_r + r.sum().item()
    count = float(np.prod(field.shape))
    errs = {"rel_max_err": diff / ref_max}
    if vel:  # std(v1 - v0) / std(v0), as _rms
        errs["rms_err"] = ((sq_d / count - (s_d / count) ** 2)
                           / (sq_r / count - (s_r / count) ** 2)) ** 0.5
    return errs


def _held_sharded(label, outs, refs, vel, disp_gate, vel_gate, **extra):
    errs = {"disp": _sharded_errors(outs[0], refs[0], False)}
    ok = errs["disp"]["rel_max_err"] < disp_gate
    if vel:
        errs["vel"] = _sharded_errors(outs[1], refs[1], True)
        ok = ok and errs["vel"]["rms_err"] < vel_gate
    log("sharded", case=label, errors=errs, disp_gate=disp_gate,
        vel_gate=vel_gate if vel else None, **extra)
    if not ok:
        raise RuntimeError(f"sharded {label}: against the single-device box: {errs}")


def phase_sharded(card):
    """The sharded hierarchical runtime (``parallel.ShardedHierarchicalProcessor``)
    on a (2, 2, 2) mesh of eight virtual shards on the one card, premodulated
    disp and disp+vel models at full width (``mid_chan=64``), each held against
    the single-device ``HierarchicalProcessor`` on the same box and weights:
    32^3 float32 boxes with the kernels off (disp rel max 2e-4, vel rms 1e-3),
    256^3 bf16 boxes with the kernels on (section 2's kernel gates; B1 / B2
    must launch on the sharded path), the 512^3 headline vel box (per-phase and
    exchange ms, margin bytes per boundary, peak against ``memory_audit``, B2
    launches, the single-device box's time in the same process) and a 128^3
    style vel box (one fold per call).  Returns the launches of each sharded run."""
    from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalProcessor
    from jax_nbody_emulator_with_dj_tpu_torch.parallel import ShardedHierarchicalProcessor
    from jax_nbody_emulator_with_dj_tpu_torch.parallel import sharded_hierarchical as sh

    mesh = _virtual_mesh(SHARDED_MESH)
    gen = torch.Generator(device="cuda").manual_seed(7)
    launches = {}

    def box_of(n):
        return torch.randn((3, n, n, n), generator=gen, device="cuda")

    def single(emu, cfg, box):
        out = HierarchicalProcessor(emu.model, emu.params, cfg, device="cuda").process_box(
            box, 0.5, 0.3, as_numpy=False)
        return out if isinstance(out, tuple) else (out,)

    def sharded(proc, box, **kw):
        out = proc.process_box(box, 0.5, 0.3, **kw)
        return out if isinstance(out, tuple) else (out,)

    # 32^3 (16^3 a shard), float32, kernels off: float reordering only
    box = box_of(32)
    for vel in (False, True):
        emu = _emulator(vel, 1)
        cfg = _config(32, slab=8, tile=(16, 16, 16), dtype=torch.float32, wino=False)
        proc = ShardedHierarchicalProcessor(emu.model, emu.params, mesh, cfg)
        _held_sharded(f"32_{'vel' if vel else 'disp'}_f32", sharded(proc, box),
                      single(emu, cfg, box), vel, GATE_SHARDED_F32, GATE_F32_VEL,
                      local=list(proc.config.size))

    # 256^3, bf16, kernels on
    n = SHARDED_N
    box = box_of(n)
    for vel in (False, True):
        emu = _emulator(vel, 0)
        cfg = _config(n, slab=32, tile=(128,) * 3, dtype=torch.bfloat16)
        ref = single(emu, cfg, box)
        proc = ShardedHierarchicalProcessor(emu.model, emu.params, mesh, cfg)
        sharded(proc, box)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        out = sharded(proc, box)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        label = f"sharded_{n}_{'vel' if vel else 'disp'}"
        launches[label] = _launch_counts()
        _held_sharded(label, out, ref, vel, GATE_SLICE, GATE_VEL, wall_s=wall,
                      launches=launches[label], local=list(proc.config.size),
                      tile1=proc.config.tile1)
        kernel = "B2" if vel else "B1"
        if launches[label][kernel] <= 0:
            raise RuntimeError(f"{label}: {kernel} launched 0 times: {launches[label]}")
        del emu, ref, proc, out
        torch.cuda.empty_cache()

    # the 512^3 headline vel box: one device, then sharded, in this process
    n = SHARDED_HEADLINE_N
    box = box_of(n)
    emu = _emulator(True, 0)
    cfg = _config(n, slab=32, tile=(128,) * 3, dtype=torch.bfloat16)  # the default geometry
    one = HierarchicalProcessor(emu.model, emu.params, cfg, device="cuda")
    one.process_box(box, 0.5, 0.3, as_numpy=False)  # warm-up
    torch.cuda.synchronize()
    # peaks: above what was allocated before the call (the box; for the sharded call
    # also the single-device outputs, kept to hold it against)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ref = one.process_box(box, 0.5, 0.3, as_numpy=False)
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    single_peak = torch.cuda.max_memory_allocated() - base
    del one
    torch.cuda.empty_cache()
    proc = ShardedHierarchicalProcessor(emu.model, emu.params, mesh, cfg)
    t0 = time.perf_counter()
    sharded(proc, box)  # warm-up
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = sharded(proc, box, profile=True)
    wall = time.perf_counter() - t0
    label = f"sharded_{n}_vel"
    launches[label] = _launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    audit = proc.memory_audit()
    _held_sharded(label, out, ref, True, GATE_SLICE, GATE_VEL, card=card, wall_s=wall,
                  first_call_s=first_s, single_device_s=single_s,
                  single_device_peak=single_peak,
                  phase_ms={k: round(v * 1e3, 3) for k, v in proc.last_timings.items()},
                  halo_bytes=proc.last_halo_bytes, max_memory_allocated=peak,
                  memory_audit_max_total=audit["max_total"],
                  memory_audit_max_phase=audit["devices"][audit["max_device"]]["max_phase"],
                  launches=launches[label], local=list(proc.config.size),
                  slab=proc.config.slab, tile=list(proc.config.tile), tile1=proc.config.tile1)
    if launches[label]["B2"] <= 0:
        raise RuntimeError(f"{label}: B2 launched 0 times: {launches[label]}")
    del emu, ref, proc, out, box
    torch.cuda.empty_cache()

    # a style vel box: one fold per call, shared by the eight shards
    n = SHARDED_STYLE_N
    box = box_of(n)
    emu = _emulator(True, 0, style=True)
    cfg = _config(n, slab=32, tile=(128,) * 3, dtype=torch.bfloat16)
    ref = single(emu, cfg, box)
    proc = ShardedHierarchicalProcessor(emu.model, emu.params, mesh, cfg)
    folds = []
    fold = sh._LocalHierarchical._fold_exec
    sh._LocalHierarchical._fold_exec = lambda self, z, Om: folds.append(1) or fold(self, z, Om)
    try:
        sharded(proc, box)  # warm-up
        torch.cuda.synchronize()
        folds.clear()
        _reset_counts()
        out = sharded(proc, box, profile=True)
    finally:
        sh._LocalHierarchical._fold_exec = fold
    label = f"sharded_{n}_style_vel"
    launches[label] = _launch_counts()
    _held_sharded(label, out, ref, True, GATE_SLICE, GATE_VEL, folds_per_call=len(folds),
                  fold_ms=proc.last_timings["fold"] * 1e3, launches=launches[label],
                  phase_ms={k: round(v * 1e3, 3) for k, v in proc.last_timings.items()})
    if len(folds) != 1 or launches[label]["B2"] <= 0:
        raise RuntimeError(f"{label}: {len(folds)} folds a call, launches {launches[label]}")
    del emu, ref, proc, out, box
    torch.cuda.empty_cache()
    return launches


def phase_sharded_science(card):
    """The sharded science toolkit on the card: at 128^3 on (2, 2, 2) and (4, 2, 1)
    meshes of virtual shards, each ``*_sharded`` function against the port's
    single-device function on the card (the GRF and the mode injection through
    given noise), at section 2's science gates; then the GRF -> 1LPT -> CIC
    density (deconvolved) -> P(k) chain at 512^3 on (2, 2, 2) and on one device,
    ms per stage (host clock, a device sync after each stage, after one warm-up
    chain)."""
    from jax_nbody_emulator_with_dj_tpu_torch import science as sci
    from jax_nbody_emulator_with_dj_tpu_torch.parallel import ShardedField
    from jax_nbody_emulator_with_dj_tpu_torch.science import grf, mas, resize

    dev = torch.device("cuda")
    n, box = SHARDED_SCIENCE_N, 500.0
    k_tab = np.logspace(-4, 2, 512)
    p_tab = sci.eisenstein_hu_pk(k_tab)
    gen = torch.Generator(device=dev).manual_seed(11)
    noise = torch.randn((n, n, n), generator=gen, device=dev)
    noise_up = torch.randn((2 * n,) * 3, generator=gen, device=dev)
    delta = grf._colour_noise(noise, box, k_tab, p_tab)
    psi = sci.zeldovich_displacement(delta, box)
    delta_nl = sci.displacement_to_density(psi, box)
    coarse = delta[::2, ::2, ::2].contiguous()
    thr = [-0.5, 0.0, 0.5]
    thetas = np.linspace(0.2, 3.0, 4)
    margin = n // 8  # 16 cells: the (4, 2, 1) mesh's x blocks are n/4 deep

    def field(x):
        return x.gather() if isinstance(x, ShardedField) else x

    for shape in (SHARDED_MESH, (4, 2, 1)):
        mesh = _virtual_mesh(shape)
        tag = "x".join(map(str, shape))
        cases = [
            ("grf", "fft", sci.gaussian_random_field_sharded(None, n, mesh, box, k_tab, p_tab,
                                                             white=noise), delta),
            ("zeldovich_displacement", "fft", sci.zeldovich_displacement_sharded(delta, mesh, box),
             psi),
            ("deposit_displacement", "deposit",
             sci.deposit_displacement_sharded(psi, mesh, box, worder=2, margin=margin),
             mas.deposit_displacement(psi, box, worder=2)),
            ("displacement_to_density", "deposit",
             sci.displacement_to_density_sharded(psi, mesh, box, margin=margin), delta_nl),
            ("power_spectrum", "pk", sci.power_spectrum_sharded(delta_nl, mesh, box)[1],
             sci.power_spectrum(delta_nl, box)[1]),
            ("cross_power", "signed", sci.cross_power_sharded(delta_nl, delta, mesh, box)[1],
             sci.cross_power(delta_nl, delta, box)[1]),
            ("transfer_and_correlation", "signed",
             torch.stack(sci.transfer_and_correlation_sharded(delta_nl, delta, mesh, box)),
             torch.stack(sci.transfer_and_correlation(delta_nl, delta, box))),
            ("minkowski_functionals", "equal",
             sci.minkowski_functionals_sharded(delta_nl, thr, mesh),
             sci.minkowski_functionals(delta_nl, thr)),
            ("upsample_modes", "fft",
             sci.upsample_modes_sharded(coarse, n, mesh, box, k_tab, p_tab, white=noise),
             resize._upsample_modes_from_noise(coarse, noise, n, box, k_tab, p_tab)),
            ("upsample_fourier", "fft", sci.upsample_fourier_sharded(delta, 2 * n, mesh),
             sci.upsample_fourier(delta, 2 * n)),
            ("downsample_average", "fft", sci.downsample_average_sharded(delta, n // 2, mesh),
             sci.downsample_average(delta, n // 2)),
            ("gaussian_smooth", "fft", sci.gaussian_smooth_sharded(delta, mesh, box, 8.0),
             sci.gaussian_smooth(delta, box, 8.0)),
        ]
        for name, kind, got, ref in cases:
            _science_compare(f"sharded_{tag}_{name}", field(got), ref, kind)
            del got
        bi_s = sci.reduced_bispectrum_sharded(delta_nl, mesh, box, 0.1, 0.15, thetas)
        bi_1 = sci.reduced_bispectrum(delta_nl, box, 0.1, 0.15, thetas)
        for key in ("B", "Q", "P3"):
            _science_compare(f"sharded_{tag}_reduced_bispectrum_{key}", bi_s[key], bi_1[key],
                             "bispectrum")
        m_s = sci.summary_metrics_sharded(delta_nl, delta, mesh, box)
        m_1 = sci.summary_metrics(delta_nl, delta, box)
        _science_compare(f"sharded_{tag}_summary_metrics", [m_s[k] for k in sorted(m_1)],
                         [m_1[k] for k in sorted(m_1)], "signed")
        torch.cuda.empty_cache()
    del noise, noise_up, delta, psi, delta_nl, coarse

    # the chain at 512^3: sharded on (2, 2, 2) and on one device
    nt, side = SCIENCE_TIMED_N, 1000.0
    mesh = _virtual_mesh(SHARDED_MESH)

    def chain_sharded():
        d = sci.gaussian_random_field_sharded(torch.Generator(device=dev).manual_seed(0), nt,
                                              mesh, side, k_tab, p_tab)
        yield "gaussian_random_field"
        p = sci.zeldovich_displacement_sharded(d, mesh, side)
        yield "zeldovich_displacement"
        rho = sci.displacement_to_density_sharded(p, mesh, side, worder=2, margin=nt // 16)
        del p
        yield "displacement_to_density_cic_deconvolved"
        sci.power_spectrum_sharded(rho, mesh, side)
        yield "power_spectrum"

    def chain_single():
        d = sci.gaussian_random_field(torch.Generator(device=dev).manual_seed(0), nt, side,
                                      k_tab, p_tab, device=dev)
        yield "gaussian_random_field"
        p = sci.zeldovich_displacement(d, side)
        yield "zeldovich_displacement"
        rho = sci.displacement_to_density(p, side, worder=2)
        del p
        yield "displacement_to_density_cic_deconvolved"
        sci.power_spectrum(rho, side)
        yield "power_spectrum"

    for label, chain in (("sharded_2x2x2", chain_sharded), ("single_device", chain_single)):
        for _ in chain():  # warm-up: cuFFT plans, allocator
            pass
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ms = {}
        t0 = time.perf_counter()
        for stage in chain():
            torch.cuda.synchronize()
            ms[stage] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
        log("sharded_science_512", run=label, size=nt, card=card, ms=ms, total_ms=sum(ms.values()),
            max_memory_allocated=torch.cuda.max_memory_allocated())
        torch.cuda.empty_cache()


def phase_dryrun():
    """``parallel.dryrun.dryrun_multichip(8)`` on the card: every sharded path
    on eight virtual shards, its report lines logged."""
    from jax_nbody_emulator_with_dj_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    lines = dryrun_multichip(8)
    log("dryrun", seconds=time.perf_counter() - t0, lines=lines)
    torch.cuda.empty_cache()


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
    phase_science()
    path_launches.update(phase_pipeline(card))
    path_launches.update(phase_sharded(card))
    phase_sharded_science(card)
    phase_dryrun()
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
    # launches per box of the y0-cached, unpacked, chunked and learned-tangent paths; per
    # pipeline run (two emulator calls) of the 512^3 vel and 256^3 disp pipelines; per box
    # of the sharded runs on eight virtual shards (2, 2, 2)
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
