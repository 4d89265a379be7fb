"""Voxelized periodic Minkowski functionals V0..V3.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science/minkowski.py``: for
each density threshold, build the excursion set's cubical complex with
periodic ``roll`` neighbor logic, count its cells (vertices n0, edges n1,
faces n2, cubes n3, int64), and apply the Crofton relations:

    V0 = n3 / N^3                      (volume fraction)
    V1 = (2/9) (n2 - 3 n3) / N^3       (surface density, up to cell units)
    V2 = (2/9) (n1 - 2 n2 + 3 n3)/N^3  (mean curvature density)
    V3 = (n0 - n1 + n2 - n3) / N^3     (Euler characteristic density)
"""

from __future__ import annotations

import torch


def _complex_counts(b):
    """Cell counts (n0, n1, n2, n3), int64, of the union-of-cubes complex of mask b."""
    def r(arr, ax):  # neighbor at the index-1 side
        return torch.roll(arr, 1, dims=ax)

    n3 = b.sum()
    # Faces normal to axis a exist where b or its a-neighbor is set (periodic).
    n2 = sum((b | r(b, ax)).sum() for ax in range(3))
    # Edges along axis a: shared by up to 4 cubes in the other two axes.
    n1 = 0
    for ax in range(3):
        o1, o2 = [d for d in range(3) if d != ax]
        n1 = n1 + (b | r(b, o1) | r(b, o2) | r(r(b, o1), o2)).sum()
    # Vertices: shared by up to 8 cubes.
    v = b
    for ax in range(3):
        v = v | r(v, ax)
    return v.sum(), n1, n2, n3


def _mf_single(delta, threshold: float):
    n = delta.shape[0]
    n0, n1, n2, n3 = (c.float() for c in _complex_counts(delta > threshold))
    vol = float(n) ** 3
    return torch.stack([
        n3 / vol,
        (2.0 / 9.0) * (n2 - 3 * n3) / vol,
        (2.0 / 9.0) * (n1 - 2 * n2 + 3 * n3) / vol,
        (n0 - n1 + n2 - n3) / vol,
    ])


def minkowski_functionals(delta, thresholds):
    """V0..V3 of the excursion sets of ``delta`` over an array of thresholds.

    Args:
        delta: (N, N, N) field (e.g. density contrast, optionally smoothed).
        thresholds: (T,) threshold values.

    Returns:
        (T, 4) float32 tensor [V0, V1, V2, V3] per threshold, on delta's device.
    """
    delta = torch.as_tensor(delta).float()
    thresholds = torch.as_tensor(thresholds, dtype=torch.float32).reshape(-1)
    return torch.stack([_mf_single(delta, float(t)) for t in thresholds])
