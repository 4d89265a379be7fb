"""Which way a float32 host box should reach the card in the compute dtype.

    python3 -m jax_nbody_emulator_with_dj_tpu_torch.experiments.upload_cast \\
        [--sizes 128 512] [--repeats 5]

``process_box`` takes a float32 (3, N, N, N) numpy box and needs it on the
card in bf16.  Five orders, the same rounding in each (checked bit for bit):

- ``host``: cast the whole box on the host, upload the bf16 copy;
- ``card``: upload the float32 box, cast on the card (a float32 copy of the
  box lives on the card until the cast is done);
- ``fused``: one ``.to(device=, dtype=)`` call, which leaves the order to
  PyTorch (a blocking copy from the host converts on the host: its peak says so);
- ``host_by_channel`` / ``card_by_channel``: the same, one channel at a time
  into a bf16 box allocated first (the transient is a third as large).

Prints one JSON line per size: the median and the range of ``--repeats``
timed turns of each order in ms (host clock, device synced before and
after), the orders taken in turn within each repeat, and the peak of
``torch.cuda.max_memory_allocated`` of each order in bytes.  Needs one CUDA
card; the line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch


def host(box, dev, dtype):
    return torch.from_numpy(box).to(dtype).to(dev)


def card(box, dev, dtype):
    return torch.from_numpy(box).to(dev).to(dtype)


def fused(box, dev, dtype):
    return torch.from_numpy(box).to(device=dev, dtype=dtype)


def host_by_channel(box, dev, dtype):
    out = torch.empty(box.shape, dtype=dtype, device=dev)
    for c in range(box.shape[0]):
        out[c].copy_(torch.from_numpy(box[c]).to(dtype))
    return out


def card_by_channel(box, dev, dtype):
    out = torch.empty(box.shape, dtype=dtype, device=dev)
    for c in range(box.shape[0]):
        out[c].copy_(torch.from_numpy(box[c]).to(dev))
    return out


ORDERS = (host, card, fused, host_by_channel, card_by_channel)


def run(sizes=(128, 512), repeats=5, dtype=torch.bfloat16, emit=print):
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the measurement needs a GPU")
    card_line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rows = []
    for size in sizes:
        box = np.random.default_rng(0).standard_normal((3, size, size, size)).astype(np.float32)
        ref = host(box, dev, dtype)
        times = {f.__name__: [] for f in ORDERS}
        peak = {}
        for turn in range(repeats + 1):  # the first turn warms up and checks
            for f in ORDERS:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                out = f(box, dev, dtype)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                if turn == 0:
                    if not torch.equal(out, ref):
                        raise RuntimeError(f"{f.__name__} rounds differently at {size}^3")
                else:
                    times[f.__name__].append(dt * 1e3)
                    peak[f.__name__] = torch.cuda.max_memory_allocated() - base
                del out
        row = dict(size=size, repeats=repeats, dtype=str(dtype), threads=torch.get_num_threads(),
                   ms={k: dict(median=statistics.median(v), min=min(v), max=max(v))
                       for k, v in times.items()},
                   peak_bytes=peak, card=card_line, device=torch.cuda.get_device_name(0))
        emit(json.dumps(row))
        rows.append(row)
        del ref
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[128, 512])
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args(argv)
    run(tuple(args.sizes), args.repeats)


if __name__ == "__main__":
    main()
