"""The port's multi-device dry run on eight virtual CPU shards.

``parallel.dryrun.dryrun_multichip(8, device="cpu")`` drives every sharded
path (the sharded subbox step, the mid-4 and mid-64 sharded hierarchical
boxes, the on-mesh science chain, and the audit of every sharded estimator
against its single-device counterpart on (4, 2, 1) and (1, 2, 4)) and prints
the JAX package's report lines.  The margin bytes it reports per shard
boundary are the bytes the exchange wrote: for the level buffers, the JAX dry
run's formula (``__graft_entry__.py``: 2 x margin x the buffer's other
extents, per axis and buffer); for the input halo, whose strips span only the
axes padded before theirs, less than that formula, which pads every axis.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from jax_nbody_emulator_with_dj_tpu_torch.parallel import dryrun

torch.set_num_threads(2)  # tier-1 runs several xdist workers


@pytest.fixture(scope="module")
def run():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        lines = dryrun.dryrun_multichip(8, device="cpu")
    return lines, out.getvalue()


@pytest.fixture(scope="module")
def report(run):
    return run[0]


def test_dryrun_runs_and_prints_its_report(run):
    report, printed = run
    assert printed == "".join(line + "\n" for line in report)
    assert report[0].startswith("dryrun_multichip OK: mesh (2, 2, 2) on 8 x cpu")
    assert sum(line.startswith("asymmetric mesh (4, 2, 1) @ 48^3: 11 sharded estimators")
               or line.startswith("asymmetric mesh (1, 2, 4) @ 48^3: 11 sharded estimators")
               for line in report) == 2
    phases = report[-2]
    for name in ("scale", "exchange_input", "phase1", "exchange_h1", "phase2a", "phase2b",
                 "phase2c", "exchange_r1", "phase3"):
        assert f"{name} " in phases


def test_dryrun_halo_bytes_follow_the_jax_formula(report):
    from jax_nbody_emulator_with_dj_tpu_torch import HierarchicalConfig
    from jax_nbody_emulator_with_dj_tpu_torch.hierarchical import buf_shape, level_margins

    cfg = HierarchicalConfig(size=(16, 16, 16), slab=8, tile=(16, 16, 16), tile1=8,
                             dtype=torch.float32)

    def halo_bytes(shape, margins, axes=(1, 2, 3), nb=2):
        total = 0
        for ax, m in zip(axes, margins):
            if m:
                total += 2 * m * int(np.prod([s for i, s in enumerate(shape) if i != ax])) * 4
        return total * nb

    m = level_margins(cfg)
    # the input's strips: D over 16 x 16, H over 32 x 16, W over 32 x 32 (3 channels)
    input_bytes = 2 * 8 * 3 * 4 * (16 * 16 + 32 * 16 + 32 * 32)
    assert input_bytes < halo_bytes((1, 3, 32, 32, 32), (8, 8, 8), axes=(2, 3, 4), nb=1)
    want = {
        "input": input_bytes,
        "h1": halo_bytes(buf_shape(cfg, 64, m["h1"]), m["h1"]),
        "y1": halo_bytes(buf_shape(cfg, 64, m["y1"]), m["y1"]),
        "y2": halo_bytes(buf_shape(cfg, 64, m["y2"], 2), m["y2"]),
        "r1": halo_bytes(buf_shape(cfg, 64, m["r1"]), m["r1"]),
    }
    line = report[-1]
    assert line.startswith("exchanged halo bytes/shard-boundary: ")
    got = dict(item.rsplit(" ", 2)[:2] for item in line.split(": ", 1)[1].split(", "))
    assert {k: int(v) for k, v in got.items()} == {k: round(v / 1024) for k, v in want.items()}


def test_dryrun_needs_the_card_unless_told_otherwise():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.dryrun_multichip(8)
