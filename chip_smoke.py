"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``jax_nbody_emulator_with_dj_tpu_torch/
csrc``, holds it against its plain PyTorch version at the shapes the main
path gives it, then drives the main path once at full width: a seeded
premodulated displacement model (mid_chan=64, 3 levels, bf16) through
``create_emulator`` -> ``HierarchicalProcessor.process_box`` on a 128^3 box,
with the Winograd kernel on, against the same box with it off.  A small box
is also held against the model's own forward on the wrap-padded input.

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
GATE_SLICE = 0.02  # rel max error of the box, wino on vs off
REPLACES = "jax_nbody_emulator_with_dj_tpu/ops/winograd_pallas.py:259"
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
    from jax_nbody_emulator_with_dj_tpu_torch.ops import winograd_cuda

    t0 = time.perf_counter()
    winograd_cuda.build()
    ptxas = [ln.strip() for ln in winograd_cuda.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("build", seconds=round(time.perf_counter() - t0, 3), ptxas=ptxas)


def phase_kernel():
    """Kernel vs plain version, bf16, at main-path and ragged shapes."""
    from jax_nbody_emulator_with_dj_tpu_torch.ops import s2d
    from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd import (
        conv3_packed_wino,
        transform_packed_w3,
    )
    from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd_cuda import conv3d_wino_packed

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn((3, 3, 3, 64, 64), generator=gen, device=dev) * 0.05
    wh = transform_packed_w3(s2d.pack_w3(w)).to(torch.bfloat16).contiguous()
    bias = torch.randn(64, generator=gen, device=dev) * 0.1
    w_oidhw = s2d.oidhw_w3(s2d.pack_w3(w)).to(torch.bfloat16)
    cases = [
        # (name, xp shape, bias, leaky, out dtype, timed)
        ("phase3_entry_conv1", (1, 142, 142, 71, 128), True, False, torch.bfloat16, True),
        ("phase3_entry_conv1", (1, 142, 142, 71, 128), True, True, torch.float32, False),
        ("phase2a_conv_l1", (1, 68, 68, 34, 128), True, True, torch.bfloat16, True),
        ("phase2a_conv_l1", (1, 68, 68, 34, 128), False, False, torch.float32, False),
    ]
    w2 = torch.randn((3, 3, 3, 128, 128), generator=gen, device=dev) * 0.03
    wh2 = transform_packed_w3(s2d.pack_w3(w2)).to(torch.bfloat16).contiguous()
    cases += [("decoder_conv0_256", (1, 36, 36, 18, 256), True, True, torch.bfloat16, False)]
    cases += [("ragged", (2, 13, 16, 21, 128), b, lk, od, False)
              for b in (True, False) for lk in (True, False)
              for od in (torch.bfloat16, torch.float32)]
    rows = []
    for name, shape, use_b, leaky, od, timed in cases:
        xp = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        b = bias if use_b else None
        wh_c = wh if shape[-1] == 128 else wh2
        if shape[-1] != 128:
            b = torch.randn(128, generator=gen, device=dev) * 0.1
        got = conv3d_wino_packed(xp, wh_c, b, leaky=leaky, out_dtype=od)
        ref = conv3_packed_wino(xp, wh_c, b, leaky=leaky, out_dtype=od)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            raise RuntimeError(f"{name}: bad kernel output {tuple(got.shape)}")
        err = (got.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        row = dict(case=name, shape=list(shape), bias=use_b, leaky=leaky,
                   out=str(od).replace("torch.", ""), max_abs_err=err, rel_err=rel)
        if timed:
            row["ms"] = cuda_ms(lambda: conv3d_wino_packed(xp, wh, b, leaky=leaky, out_dtype=od))
            row["plain_ms"] = cuda_ms(lambda: conv3_packed_wino(xp, wh, b, leaky=leaky, out_dtype=od))
            # the direct packed conv (cuDNN) that the path runs with wino=False
            row["direct_ms"] = cuda_ms(lambda: s2d.conv3_packed(xp, w_oidhw))
        log("kernel", **row)
        if not rel < GATE_KERNEL:
            raise RuntimeError(f"{name}: kernel vs plain rel error {rel} >= {GATE_KERNEL}")
        rows.append(row)
        del xp, got, ref
    torch.cuda.empty_cache()
    return rows


def phase_small_box():
    """Hierarchical runtime vs the model's own forward on a wrap-padded 16^3 box."""
    from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalConfig, create_emulator
    from jax_nbody_emulator_with_dj_tpu_torch.hierarchical import _wrap_pad
    from jax_nbody_emulator_with_dj_tpu_torch.models.unet import init_unet

    n = 16
    tree = init_unet(1, mid_chan=64, style=True)
    box = np.random.default_rng(1).standard_normal((3, n, n, n)).astype(np.float32)
    kw = dict(premodulate=True, compute_vel=False, params=tree, premodulate_z=0.5,
              premodulate_Om=0.3, device="cuda")
    emu = create_emulator(**kw)
    xpad = _wrap_pad(torch.from_numpy(box)[None], 48)
    ref = emu.apply(xpad, 0.5, 0.3)[0].cpu().numpy()
    for wino, gate in ((False, 2e-4), (True, GATE_SLICE)):
        cfg = HierarchicalConfig(size=(n,) * 3, slab=8, tile=(8, 8, 8), dtype=torch.float32,
                                 output_dtype=torch.float32, wino=wino)
        out = create_emulator(processor_config=cfg, **kw).process_box(box, 0.5, 0.3)
        rel = float(np.abs(out - ref).max() / np.abs(ref).max())
        log("small_box_vs_model", wino=wino, size=n, rel_max_err=rel, gate=gate)
        if not (np.isfinite(out).all() and rel < gate):
            raise RuntimeError(f"16^3 box (wino={wino}) vs model forward: rel {rel} >= {gate}")


def phase_slice():
    """The main path at full width: 128^3, mid_chan=64, bf16."""
    from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalConfig, create_emulator
    from jax_nbody_emulator_with_dj_tpu_torch.models.unet import init_unet
    from jax_nbody_emulator_with_dj_tpu_torch.ops.winograd_cuda import conv3d_wino_packed

    n = 128
    tree = init_unet(0, mid_chan=64, style=True)
    box = np.random.default_rng(0).standard_normal((3, n, n, n)).astype(np.float32)
    outs = {}
    for wino in (None, False):  # None: the default, on for a CUDA device
        cfg = HierarchicalConfig(size=(n,) * 3, slab=32, tile=(n,) * 3, dtype=torch.bfloat16,
                                 output_dtype=torch.float32, wino=wino)
        emu = create_emulator(premodulate=True, compute_vel=False, params=tree,
                              premodulate_z=0.5, premodulate_Om=0.3,
                              processor_config=cfg, device="cuda")
        emu.process_box(box, 0.5, 0.3)  # warm-up (cuDNN plans, allocator)
        torch.cuda.synchronize()
        conv3d_wino_packed.launches = 0
        t0 = time.perf_counter()
        out = emu.process_box(box, 0.5, 0.3)  # returns numpy: ends in a sync
        walls = [time.perf_counter() - t0]
        launches = conv3d_wino_packed.launches
        for _ in range(RUNS - 1):
            t0 = time.perf_counter()
            emu.process_box(box, 0.5, 0.3)
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls))
        emu.process_box(box, 0.5, 0.3, profile=True)
        phases = {k: round(v * 1e3, 3) for k, v in emu.processor.last_timings.items()}
        if out.shape != (3, n, n, n) or not np.isfinite(out).all():
            raise RuntimeError(f"slice output bad: shape {out.shape}")
        outs[wino] = (out, launches, wall)
        log("slice", wino=emu.processor.wino, size=n, mid_chan=64, dtype="bfloat16",
            median_wall_s=wall, walls_s=walls, voxels_per_s=n**3 / wall,
            wino_launches=launches, phase_ms=phases)
        del emu
        torch.cuda.empty_cache()
    out, launches, _ = outs[None]
    rel = float(np.abs(out - outs[False][0]).max() / np.abs(outs[False][0]).max())
    log("slice_compare", rel_max_err=rel, gate=GATE_SLICE)
    if launches <= 0:
        raise RuntimeError("the main path launched the Winograd kernel 0 times")
    if outs[False][1] != 0:
        raise RuntimeError("wino=False still launched the kernel")
    if not rel < GATE_SLICE:
        raise RuntimeError(f"slice wino on vs off: rel max err {rel} >= {GATE_SLICE}")
    return launches


def main():
    card = phase_env()
    sys.path.insert(0, str(ROOT))
    phase_build()
    rows = phase_kernel()
    phase_small_box()
    launches = phase_slice()
    main_row = next(r for r in rows if "ms" in r)
    kernels = [{
        "name": "conv3d_wino_packed (wino_f23)",
        "route": "cuda",
        "source": "jax_nbody_emulator_with_dj_tpu_torch/csrc/wino_f23.cu",
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
