"""Cluster sizes and an ablation of the F(2,3)^2 Winograd kernels B1 and B2.

    python3 -m jax_nbody_emulator_with_dj_tpu_torch.experiments.wino_ablation
    python3 -m jax_nbody_emulator_with_dj_tpu_torch.experiments.wino_ablation \\
        --variants 1,2,0 2,4,0 --shape 1,68,68,34,128

Builds ``csrc/wino_f23.cu`` once per variant ``B1 cluster, B2 cluster,
ablation mask[, products in flight[, producer registers, consumer
registers]]`` (the source's compile-time knobs ``WINO_CLUSTER_B1``,
``WINO_CLUSTER_B2``, ``WINO_ABLATE``, ``WINO_INFLIGHT``, ``WINO_REG_*``; all
``nvcc`` runs start together), and times B1 and B2 of each at one shape
(default: the first conv of a 128^3 phase-3 tile), in turns over the
variants, CUDA events, mean of ``--runs`` launches after a warm-up.  A variant
with mask 0 is first held against the plain PyTorch versions (bf16 out: 0.03
of max |ref|; float32 out: 1e-5).  The mask leaves out the weight copies (1),
the input loads and transform (2; 8: the transform only, 16: the loads
only), the stores (4): 7 times the products alone, 6 adds the weight ring, 4
the input path, 0 is the whole kernel.  Prints one JSON line per variant with
ptxas's registers and spills and the card's name and power limit.  Needs one
CUDA card and ``nvcc``; the shipped library (``ops/winograd_cuda.build``) is
not touched.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ..ops import _cuda_build, s2d, winograd_cuda
from ..ops.winograd import conv3_packed_wino, conv3_packed_wino_pair, transform_packed_w3

DEFAULT_VARIANTS = ("1,2,0", "2,4,0", "4,4,0", "1,2,7", "1,2,6", "1,2,4", "1,2,2", "1,2,8",
                    "1,2,16", "1,2,0,2,56,224", "1,2,7,2,56,224")
PHASE3 = (1, 142, 142, 71, 128)


def _defines(variant: str) -> tuple[str, ...]:
    b1, b2, mask, *more = (int(v) for v in variant.split(","))
    names = ("WINO_INFLIGHT", "WINO_REG_PRODUCER", "WINO_REG_CONSUMER")
    return (f"WINO_CLUSTER_B1={b1}", f"WINO_CLUSTER_B2={b2}", f"WINO_ABLATE={mask}",
            *(f"{k}={n}" for k, n in zip(names, more)))


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


def run(variants, shape, f2, runs, emit=print):
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the ablation needs a GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(max_workers=len(variants)) as pool:
        libs = list(pool.map(lambda v: _cuda_build.build(winograd_cuda.SOURCE, _defines(v)),
                             variants))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    c2 = shape[-1]
    w = torch.randn((3, 3, 3, c2 // 2, f2 // 2), generator=gen, device=dev) / (13.5 * c2) ** 0.5
    wh = transform_packed_w3(s2d.pack_w3(w)).to(torch.bfloat16).contiguous()
    wt = winograd_cuda.tile_wh(wh)
    xp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    sp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
    bias = torch.randn(f2, generator=gen, device=dev) * 0.1
    c = torch.randn(f2, generator=gen, device=dev) * 0.3

    def b1(out=torch.bfloat16):
        return winograd_cuda.conv3d_wino_packed(xp, wt, bias, leaky=True, out_dtype=out)

    def b2(out=torch.bfloat16):
        return winograd_cuda.conv3d_wino_pair_packed(xp, sp, wt, bias, c, leaky=True,
                                                     out_dtype=out)

    rows = {}
    shipped = winograd_cuda._lib
    try:
        for turn in range(2):  # in turns over the variants: two passes, the mean is reported
            for variant, lib in zip(variants, libs):
                winograd_cuda._lib = winograd_cuda.bind(lib)
                row = rows.setdefault(variant, dict(variant=variant, shape=list(shape), f2=f2))
                if turn == 0:
                    key = " ".join((winograd_cuda.SOURCE, *_defines(variant)))
                    row["ptxas"] = [ln.strip() for ln in _cuda_build.build_logs.get(key, "")
                                    .splitlines() if "registers" in ln or "spill" in ln
                                    or "arning" in ln]
                    if variant.split(",")[2] == "0":
                        refs = {o: (conv3_packed_wino(xp, wh, bias, leaky=True, out_dtype=o),
                                    conv3_packed_wino_pair(xp, sp, wh, bias, c, leaky=True,
                                                           out_dtype=o))
                                for o in (torch.bfloat16, torch.float32)}
                        for o, (r1, r2) in refs.items():
                            name = str(o).replace("torch.", "")
                            y, dy = b2(o)
                            agree = (y > 0) == (r2[0] > 0)
                            errs = dict(b1=_rel(b1(o), r1), b2_y=_rel(y, r2[0]),
                                        b2_dy=_rel(torch.where(agree, dy, r2[1]), r2[1]),
                                        b2_flips=(~agree).sum().item() / agree.numel())
                            row[f"rel_err_{name}"] = errs
                            gate = 1e-5 if o == torch.float32 else 0.03
                            if not (max(errs["b1"], errs["b2_y"], errs["b2_dy"]) < gate
                                    and errs["b2_flips"] < 1e-4):
                                raise RuntimeError(f"variant {variant} disagrees with the plain "
                                                   f"versions ({name} out): {errs}")
                        del refs
                row.setdefault("b1_ms", []).append(_ms(b1, runs))
                row.setdefault("b2_ms", []).append(_ms(b2, runs))
    finally:
        winograd_cuda._lib = shipped
    out = []
    for variant in variants:
        row = rows[variant]
        row["b1_ms_turns"], row["b2_ms_turns"] = row["b1_ms"], row["b2_ms"]
        row["b1_ms"] = sum(row["b1_ms_turns"]) / 2
        row["b2_ms"] = sum(row["b2_ms_turns"]) / 2
        row["card"] = card
        emit(json.dumps(row))
        out.append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", nargs="+", default=list(DEFAULT_VARIANTS),
                    help="B1 cluster, B2 cluster, mask[, in flight[, registers]]; e.g. 2,4,0")
    ap.add_argument("--shape", default=",".join(map(str, PHASE3)),
                    help="xp as B,D,H,WP,C2 (default: the phase-3 entry conv)")
    ap.add_argument("--f2", type=int, default=128)
    ap.add_argument("--runs", type=int, default=10)
    args = ap.parse_args(argv)
    run(args.variants, tuple(int(v) for v in args.shape.split(",")), args.f2, args.runs)


if __name__ == "__main__":
    main()
