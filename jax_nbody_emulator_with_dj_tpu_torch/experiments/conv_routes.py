"""Every route to the packed interior conv, side by side on one input.

    python3 -m jax_nbody_emulator_with_dj_tpu_torch.experiments.conv_routes \\
        [--shape D H WP] [--parts N] [--device cuda]

Counterpart of the JAX package's conv shoot-outs (``scripts/experiments/
microbench_pallas.py``, ``microbench_stripe.py``, ``microbench_wino43.py``,
``microbench_wino_pallas.py``).  All routes compute one function -- a VALID
3x3x3 conv in the W-parity packed layout over the channel concat of N parts,
a bias, LeakyReLU(0.01) -- at full width (128 packed channels per part, 128
out), on a seeded bf16 input and seeded weights:

    cudnn  the library's conv (``s2d.conv3_packed``, on the materialised
           concat) + bias + LeakyReLU: the yardstick
    B1     F(2,3)^2 Winograd            (``ops/winograd_cuda.py``)
    B3     mixed F(2,3) x F(4,3)        (``ops/winograd43_cuda.py``)
    B4     direct, resident window      (``ops/direct_conv_cuda.py``)
    B5     direct, plane-streamed parts (``ops/direct_conv_cuda.py``)

(each kernel's weights in its own layout, tiled once before the timed calls)

With N > 1 parts B5 takes them in one launch; B1, B3 and B4 take one input,
so they run once per part and the results are summed before the LeakyReLU,
the form the decoder's concat convs run today (``models/blocks.py::
_apply_packed_cat``).  Each route is held against the float32 plain version
(``ops/direct_conv.py::conv3_packed_taps`` on float32 copies of the
operands) at the JAX scripts' gate: max error over the reference's max
below 0.02, and below 0.08 for the mixed Winograd, its own test's gate.
One JSON line per route: ms, direct-equivalent TFLOP/s counted as the JAX
scripts count it, the least time the card could take (``bound_ms``: the
larger of the route's own multiplies at the bf16 tensor-core peak and the
function's bytes at the memory rate), kernel launches.

Timing: CUDA events around 10 calls after a warm-up call.  The JAX scripts
chain their calls in a ``fori_loop`` and sum the results to defeat XLA's
dead-code elimination and a remote dispatch floor; eager PyTorch has neither,
so events around the plain calls take that harness's place.

The device is the CUDA card unless ``--device cpu`` is given.  On the CPU
every route is its plain version, at a small default shape, and nothing is
timed: a CPU run checks the wiring and the gates, no more.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from ..hierarchical import resolve_device
from ..ops import s2d
from ..ops.direct_conv import conv3_packed_taps
from ..ops.direct_conv_cuda import conv3_packed_stripe, conv3d_direct_packed, tile_wp
from ..ops.winograd import transform_packed_w3, transform_packed_w3_mixed
from ..ops.winograd43_cuda import conv3d_wino43_packed, tile_what
from ..ops.winograd_cuda import conv3d_wino_packed, tile_wh

CHAN = 64                 # unpacked channels per part and out: the model's mid_chan
SHAPES = ((142, 142, 71), (136, 264, 132))  # narrow phase-3 and wide phase-1 inputs (D, H, WP)
CPU_SHAPE = (8, 10, 9)
GATE = 0.02               # max|y - ref| / max|ref| against the float32 plain version
GATE_MIXED = 0.08         # the mixed Winograd: BT4/AT4 entries up to 8 amplify bf16 rounding
PEAK_BF16 = 989e12        # H100 SXM dense bf16 tensor-core rate, FLOP/s
PEAK_BYTES = 3.35e12      # H100 SXM device-memory rate, bytes/s
ROUTES = ("cudnn", "B1", "B3", "B4", "B5")


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


def bound_ms(macs, nbytes):
    """(ms, "operations" or "bytes"): the least time an H100 could take for
    ``macs`` bf16 multiply-adds and ``nbytes`` of device-memory traffic."""
    t_ops, t_bytes = 2 * macs / PEAK_BF16, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def route_macs(route, shape, cin, co, batch=1):
    """Multiply-adds of one route over an input (batch, D, H, WP, cin): 18 taps
    per output position for the direct routes, 16 points x 2 packed-W taps per
    2x2 tile for F(2,3)^2 (B1), 24 x 2 per 2x4 tile for the mixed form (B3)."""
    d, h, wp = shape
    od, oh, ow = d - 2, h - 2, wp - 1
    per_cell = {
        "B1": -(-od // 2) * -(-oh // 2) * 32,
        "B3": -(-od // 2) * -(-oh // 4) * 48,
    }.get(route, od * oh * 18)
    return batch * per_cell * ow * cin * co


def conv_bytes(shape, cin, co, n_w, batch=1, out_bytes=2, n_out=1):
    """Bytes the function must move: every bf16 input and weight and the
    float32 bias read once, every output written once."""
    d, h, wp = shape
    return (batch * d * h * wp * cin * 2 + n_w * cin * co * 2 + co * 4
            + n_out * batch * (d - 2) * (h - 2) * (wp - 1) * co * out_bytes)


def route_bound(route, shape, parts=1, c2=2 * CHAN, f2=2 * CHAN, batch=1, out_bytes=2):
    """(bound_ms, bound_by, multiplies) of one route on an H100: its own
    multiply count at the bf16 peak against the function's bytes at the
    memory rate.  ``parts`` inputs of ``c2`` packed channels each."""
    macs = route_macs(route, shape, parts * c2, f2, batch)
    n_w = {"B1": 32, "B3": 48}.get(route, 18)
    ms, by = bound_ms(macs, conv_bytes(shape, parts * c2, f2, n_w, batch, out_bytes))
    return ms, by, macs


def make_case(shape, parts, device, seed=0):
    """Seeded operands: ``parts`` bf16 inputs (1, D, H, WP, 128), the (3, 3,
    3, 64 parts, 64) kernel and the (64,) bias, as numpy made them."""
    rng = np.random.default_rng(seed)
    d, h, wp = shape
    xs = tuple(torch.from_numpy(rng.standard_normal((1, d, h, wp, 2 * CHAN), dtype=np.float32))
               .to(device=device, dtype=torch.bfloat16) for _ in range(parts))
    w = torch.from_numpy(
        rng.standard_normal((3, 3, 3, CHAN * parts, CHAN), dtype=np.float32) * 0.05).to(device)
    bias = torch.from_numpy(rng.standard_normal(CHAN, dtype=np.float32) * 0.1).to(device)
    return xs, w, bias


def build_routes(xs, w, bias):
    """route name -> (callable, the wrapper whose launches it counts or None)."""
    parts = len(xs)
    bf16 = torch.bfloat16
    wp = s2d.pack_w3(w, groups=parts).to(bf16).contiguous()
    bp = s2d.pack_bias(bias)
    w_oidhw = s2d.oidhw_w3(wp)
    c2 = 2 * CHAN
    wps = [wp[:, :, :, i * c2:(i + 1) * c2].contiguous() for i in range(parts)]
    # tiled once, outside the timed calls, as the model does when it packs its weights
    whs = [tile_wh(transform_packed_w3(wi.float()).to(bf16)) for wi in wps]
    whats = [tile_what(transform_packed_w3_mixed(wi.float()).to(bf16)) for wi in wps]
    wp_tiled = tile_wp(wp)

    def per_part(conv, weights):
        """One launch per part, bias on part 0, summed, then the LeakyReLU."""
        def fn():
            z = conv(xs[0], weights[0], bias, leaky=parts == 1)
            for x, wi in zip(xs[1:], weights[1:]):
                z = z + conv(x, wi)
            return z if parts == 1 else F.leaky_relu(z, 0.01)
        return fn

    def cudnn():
        cat = xs[0] if parts == 1 else torch.cat(xs, dim=-1)
        return F.leaky_relu(s2d.conv3_packed(cat, w_oidhw) + bp.to(bf16), 0.01)

    return {
        "cudnn": (cudnn, None),
        "B1": (per_part(conv3d_wino_packed, whs), conv3d_wino_packed),
        "B3": (per_part(conv3d_wino43_packed, whats), conv3d_wino43_packed),
        "B4": (per_part(conv3d_direct_packed, [tile_wp(wi) for wi in wps]), conv3d_direct_packed),
        "B5": (lambda: conv3_packed_stripe(xs, wp_tiled, bp, leaky=True), conv3_packed_stripe),
    }, (wp, bp)


def run(shape=None, parts=1, device=None, seed=0, reps=10, emit=print):
    """Run every route at ``shape`` (D, H, WP) with ``parts`` input parts.

    Returns one row (a dict) per route and hands ``emit`` its JSON line; raises
    if a route misses its gate.  ``device=None`` is the CUDA card (and raises
    without one); on ``"cpu"`` the routes are their plain versions and ``ms``
    stays None.
    """
    device = resolve_device(device)
    on_card = device.type == "cuda"
    shape = tuple(shape) if shape is not None else (SHAPES[0] if on_card else CPU_SHAPE)
    xs, w, bias = make_case(shape, parts, device, seed)
    routes, (wp, bp) = build_routes(xs, w, bias)
    ref = conv3_packed_taps([x.float() for x in xs], wp.float(), bp, leaky=True,
                            out_dtype=torch.float32)
    scale = ref.abs().max().item()
    d, h, u = shape
    flops = d * h * (2 * u) * 27 * (CHAN * parts) * CHAN * 2  # as the JAX scripts count them
    rows = []
    for name in ROUTES:
        fn, wrapper = routes[name]
        before = wrapper.launches if wrapper is not None else 0
        y = fn()
        if on_card:
            torch.cuda.synchronize()
        launches = wrapper.launches - before if wrapper is not None else 0
        gate = GATE_MIXED if name == "B3" else GATE
        max_abs_err = (y.float() - ref).abs().max().item()
        rel = max_abs_err / scale
        ok = bool(y.shape == ref.shape and torch.isfinite(y).all().item() and rel < gate)
        del y
        bound_ms, bound_by, macs = route_bound(name, shape, parts)
        ms = cuda_ms(fn, reps) if on_card else None
        row = dict(
            route=name, shape=list(shape), parts=parts, dtype="bfloat16", ms=ms,
            direct_tflops=None if ms is None else flops / (ms * 1e-3) / 1e12,
            bound_ms=bound_ms, bound_by=bound_by, multiplies=macs, launches=launches,
            max_abs_err=max_abs_err, rel_err=rel, gate=gate, ok=ok,
            device=torch.cuda.get_device_name(device) if on_card else "cpu",
        )
        emit(json.dumps(row))
        rows.append(row)
    failed = [r["route"] for r in rows if not r["ok"]]
    if failed:
        raise RuntimeError(f"conv routes {failed} missed their gate at shape {shape}, "
                           f"{parts} part(s): {[r for r in rows if not r['ok']]}")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shape", type=int, nargs=3, default=None, metavar=("D", "H", "WP"),
                   help="input extents in packed cells (default: 142 142 71 and 136 264 132)")
    p.add_argument("--parts", type=int, default=1, help="input parts of 128 packed channels")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.shape is not None:
        shapes = [tuple(args.shape)]
    else:
        shapes = list(SHAPES) if device.type == "cuda" else [CPU_SHAPE]
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    for shape in shapes:
        run(shape, args.parts, device, seed=args.seed)


if __name__ == "__main__":
    main()
