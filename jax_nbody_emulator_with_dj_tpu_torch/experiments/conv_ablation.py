"""An ablation of the conv kernels B4 (direct conv from a resident window),
B5 (plane-streamed direct conv) and B3 (mixed F(2,3) x F(4,3) Winograd):
where each kernel's time goes.

    python3 -m jax_nbody_emulator_with_dj_tpu_torch.experiments.conv_ablation
    python3 -m jax_nbody_emulator_with_dj_tpu_torch.experiments.conv_ablation \\
        --b4 0 7 --b5 0 7 --b3 0 7 4 --segments 1 3 8 13 --shape 1,68,68,34,128

Builds ``csrc/direct_conv.cu`` once per ``--b4`` variant,
``csrc/stripe_conv.cu`` once per ``--b5`` variant and ``csrc/wino_f43.cu``
once per ``--b3`` variant, a variant being the source's ablation mask
(``DIRECT_ABLATE``, ``STRIPE_ABLATE``, ``WINO43_ABLATE``); all ``nvcc`` runs
start together.  Times each at one shape (default: the first conv of a
128^3 phase-3 tile; B5 with one part and with two), in turns over the
variants, CUDA events, mean of ``--runs`` launches after a warm-up, weights
tiled beforehand.  A variant with mask 0 is first held against the plain
PyTorch version (bf16 out: 0.03 of max |ref|, B3 0.08; float32 out: 1e-5, B3
1e-4).  A mask leaves out the weight copies (1), the input path (2; for B3
also 8: the transform only, 16: the loads only), the stores (4): 7 times the
products alone, 6 adds the weight ring, 4 the input path, 0 is the whole
kernel.  ``--segments`` times the shipped B5 with its D axis cut into that
many segments instead of ``stripe_segments``' choice.  Prints one JSON line
per variant with ptxas's registers and spills and the card's name and power
limit.  Needs one CUDA card and ``nvcc``; the shipped libraries are not
touched.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _cuda_build, direct_conv_cuda, s2d, winograd43_cuda
from ..ops.direct_conv import conv3_packed_taps
from ..ops.winograd import conv3_packed_wino43, transform_packed_w3_mixed

B4_VARIANTS = ("0", "7", "6", "4", "2", "1")
B5_VARIANTS = ("0", "7", "6", "4", "2", "1")
B3_VARIANTS = ("0", "7", "6", "4", "2", "8", "16")
PHASE3 = (1, 142, 142, 71, 128)


def _b4_defines(variant: str) -> tuple[str, ...]:
    return (f"DIRECT_ABLATE={int(variant)}",)


def _b5_defines(variant: str) -> tuple[str, ...]:
    return (f"STRIPE_ABLATE={int(variant)}",)


def _b3_defines(variant: str) -> tuple[str, ...]:
    return (f"WINO43_ABLATE={int(variant)}",)


def _ms(fn, runs):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def _ptxas(source, defines):
    log = _cuda_build.build_logs.get(" ".join((source, *defines)), "")
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "arning" in ln]


def run(b4_variants, b5_variants, b3_variants, segments, shape, f2, runs, emit=print):
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the ablation needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    if b4_variants and shape[-1] != f2:
        raise ValueError(f"B4 takes a square kernel: C2 {shape[-1]} != F2 {f2}")
    jobs = ([(direct_conv_cuda.SOURCE, _b4_defines(v)) for v in b4_variants]
            + [(direct_conv_cuda.STRIPE_SOURCE, _b5_defines(v)) for v in b5_variants]
            + [(winograd43_cuda.SOURCE, _b3_defines(v)) for v in b3_variants])
    with ThreadPoolExecutor(max_workers=max(1, len(jobs))) as pool:
        libs = list(pool.map(lambda job: _cuda_build.build(*job), jobs))
    n4, n5 = len(b4_variants), len(b5_variants)
    b4_libs, b5_libs, b3_libs = libs[:n4], libs[n4:n4 + n5], libs[n4 + n5:]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16 = torch.bfloat16
    c2 = shape[-1]
    xs = tuple(torch.randn(shape, generator=gen, device=dev).to(bf16) for _ in range(2))
    wp = (torch.randn((3, 3, 2, 2 * c2, f2), generator=gen, device=dev) / (27 * c2) ** 0.5).to(bf16)
    wp1 = wp[:, :, :, :c2].contiguous()
    wts = {1: direct_conv_cuda.tile_wp(wp1), 2: direct_conv_cuda.tile_wp(wp)}
    w = torch.randn((3, 3, 3, c2 // 2, f2 // 2), generator=gen, device=dev) / (13.5 * c2) ** 0.5
    what = transform_packed_w3_mixed(s2d.pack_w3(w)).to(bf16).contiguous()
    what_t = winograd43_cuda.tile_what(what)
    bias = torch.randn(f2, generator=gen, device=dev) * 0.1
    bias_unpacked = torch.randn(f2 // 2, generator=gen, device=dev) * 0.1

    def b4():
        return direct_conv_cuda.conv3d_direct_packed(xs[0], wts[1], bias_unpacked, leaky=True)

    def b5(parts, out=bf16):
        return direct_conv_cuda.conv3_packed_stripe(xs[:parts], wts[parts], bias, leaky=True,
                                                    out_dtype=out)

    def b3(out=bf16):
        return winograd43_cuda.conv3d_wino43_packed(xs[0], what_t, bias, leaky=True, out_dtype=out)

    rows = {}
    shipped = direct_conv_cuda._lib, direct_conv_cuda._stripe_lib, winograd43_cuda._lib
    try:
        for turn in range(2):  # in turns over the variants: two passes, the mean is reported
            for variant, lib, defines in zip(b4_variants, b4_libs, map(_b4_defines, b4_variants)):
                direct_conv_cuda._lib = direct_conv_cuda.bind_window(lib)
                row = rows.setdefault(("B4", variant), dict(kernel="B4", variant=variant,
                                                            shape=list(shape), f2=f2))
                if turn == 0:
                    row["ptxas"] = _ptxas(direct_conv_cuda.SOURCE, defines)
                    if int(variant) == 0:
                        ref = conv3_packed_taps(xs[0], wp1, s2d.pack_bias(bias_unpacked),
                                                leaky=True)
                        row["rel_err_bfloat16"] = err = _rel(b4(), ref)
                        if not err < 0.03:
                            raise RuntimeError(f"B4 variant {variant} disagrees with the plain "
                                               f"version: {err} >= 0.03")
                        del ref
                row.setdefault("ms", []).append(_ms(b4, runs))
            for variant, lib, defines in zip(b5_variants, b5_libs, map(_b5_defines, b5_variants)):
                direct_conv_cuda._stripe_lib = direct_conv_cuda.bind_stripe(lib)
                row = rows.setdefault(("B5", variant), dict(kernel="B5", variant=variant,
                                                            shape=list(shape), f2=f2))
                if turn == 0:
                    row["ptxas"] = _ptxas(direct_conv_cuda.STRIPE_SOURCE, defines)
                    if int(variant) == 0:
                        for parts in (1, 2):
                            for o, gate in ((bf16, 0.03), (torch.float32, 1e-5)):
                                ref = conv3_packed_taps(xs[:parts], (wp1, wp)[parts - 1], bias,
                                                        leaky=True, out_dtype=o)
                                err = _rel(b5(parts, o), ref)
                                row[f"rel_err_{parts}_{str(o).replace('torch.', '')}"] = err
                                if not err < gate:
                                    raise RuntimeError(f"B5 variant {variant} disagrees with the "
                                                       f"plain version: {err} >= {gate}")
                                del ref
                row.setdefault("ms_1part", []).append(_ms(lambda: b5(1), runs))
                row.setdefault("ms_2parts", []).append(_ms(lambda: b5(2), runs))
            for variant, lib, defines in zip(b3_variants, b3_libs, map(_b3_defines, b3_variants)):
                winograd43_cuda._lib = winograd43_cuda.bind(lib)
                row = rows.setdefault(("B3", variant), dict(kernel="B3", variant=variant,
                                                            shape=list(shape), f2=f2))
                if turn == 0:
                    row["ptxas"] = _ptxas(winograd43_cuda.SOURCE, defines)
                    if int(variant) == 0:
                        for o, gate in ((bf16, 0.08), (torch.float32, 1e-4)):
                            ref = conv3_packed_wino43(xs[0], what, bias, leaky=True, out_dtype=o)
                            err = _rel(b3(o), ref)
                            row[f"rel_err_{str(o).replace('torch.', '')}"] = err
                            if not err < gate:
                                raise RuntimeError(f"B3 variant {variant} disagrees with the "
                                                   f"plain version: {err} >= {gate}")
                            del ref
                row.setdefault("ms", []).append(_ms(b3, runs))
    finally:
        direct_conv_cuda._lib, direct_conv_cuda._stripe_lib, winograd43_cuda._lib = shipped

    out = []
    for row in rows.values():
        for key in [k for k in row if k.startswith("ms")]:
            row[key + "_turns"], row[key] = row[key], sum(row[key]) / len(row[key])
        row["card"] = card
        emit(json.dumps(row))
        out.append(row)

    # the shipped B5 with its D axis cut by hand
    choose = direct_conv_cuda.stripe_segments
    try:
        for nseg in segments:
            direct_conv_cuda.stripe_segments = lambda od, patches, sms, n=nseg: min(n, od)
            row = dict(kernel="B5", segments=nseg, shape=list(shape), f2=f2,
                       ms_1part=_ms(lambda: b5(1), runs), ms_2parts=_ms(lambda: b5(2), runs),
                       card=card)
            emit(json.dumps(row))
            out.append(row)
    finally:
        direct_conv_cuda.stripe_segments = choose
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--b4", nargs="*", default=list(B4_VARIANTS), help="B4 ablation masks")
    ap.add_argument("--b5", nargs="*", default=list(B5_VARIANTS), help="B5 ablation masks")
    ap.add_argument("--b3", nargs="*", default=list(B3_VARIANTS), help="B3 ablation masks")
    ap.add_argument("--segments", nargs="*", type=int, default=[],
                    help="D segment counts to time the shipped B5 with")
    ap.add_argument("--shape", default=",".join(map(str, PHASE3)),
                    help="xp as B,D,H,WP,C2 (default: the phase-3 entry conv)")
    ap.add_argument("--f2", type=int, default=128)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.b4, args.b5, args.b3, args.segments, tuple(int(v) for v in args.shape.split(",")),
        args.f2, args.runs)


if __name__ == "__main__":
    main()
