"""Parameter trees: conversion from the JAX package and ``.npz`` save/load.

The port keeps the JAX package's tree: ``{'params': {block: {layer: {leaf:
array}}}}`` with DHWIO kernels.  Its leaves are torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree):
    """A JAX package parameter tree (jax or numpy leaves) -> the port's tree.

    Leaves are read through ``np.asarray``, so JAX arrays convert without
    importing JAX here; floating leaves keep their precision.
    """
    if isinstance(tree, dict):
        return {k: params_from_jax(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, copy=True))


def save_params_npz(path, params: dict) -> None:
    """Save a tree in the JAX package's ``.npz`` format (a pickled dict)."""

    def to_numpy(tree):
        if isinstance(tree, dict):
            return {k: to_numpy(v) for k, v in tree.items()}
        return tree.detach().cpu().numpy()

    host = to_numpy(params)
    np.savez(path, params=np.asarray(host.get("params", host), dtype=object))


def load_params_npz(path) -> dict:
    """Load a tree saved by this module or by the JAX package's
    ``save_params_npz``.  The format is a pickle: load only files this
    project wrote."""
    with np.load(path, allow_pickle=True) as f:
        params = f["params"].item()
    return params_from_jax({"params": params})
