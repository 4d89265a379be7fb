"""Parameter trees: conversion from the JAX package, layout conversion,
casting and ``.npz`` save/load.

The port keeps the JAX package's tree: ``{'params': {block: {layer: {leaf:
array}}}}`` with DHWIO ``(K, K, K, Cin, Cout)`` kernels.  Its leaves are torch
tensors.  The original emulator's weights store kernels as OIDHW ``(Cout,
Cin, K, K, K)``; the tree's structure is the same, so converting is one
transposition per 5-D ``weight`` / ``dweight`` leaf.
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


_KERNEL_KEYS = ("weight", "dweight")


def _leaf(v):
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, copy=True))


def _convert_tree(node, to_reference: bool):
    if isinstance(node, dict) and "weight" in node:
        # DHWIO -> OIDHW is (Co, Ci, K, K, K); OIDHW -> DHWIO is (D, H, W, I, O)
        perm = (4, 3, 0, 1, 2) if to_reference else (2, 3, 4, 1, 0)
        return {k: _leaf(v).permute(perm).contiguous()
                if k in _KERNEL_KEYS and np.ndim(v) == 5 else _leaf(v)
                for k, v in node.items()}
    if isinstance(node, dict):
        return {k: _convert_tree(v, to_reference) for k, v in node.items()}
    return _leaf(node)


def convert_reference_params(ref_params: dict) -> dict:
    """Reference (OIDHW) parameter tree -> the port's (DHWIO) tree."""
    return _convert_tree(ref_params, to_reference=False)


def convert_to_reference_params(params: dict) -> dict:
    """The port's (DHWIO) parameter tree -> the reference (OIDHW) layout."""
    return _convert_tree(params, to_reference=True)


def tree_cast(params, dtype):
    """Cast all floating leaves of a tree to ``dtype``."""
    if isinstance(params, dict):
        return {k: tree_cast(v, dtype) for k, v in params.items()}
    v = _leaf(params)
    return v.to(dtype) if v.is_floating_point() else v


def tree_to(tree, device, dtype=None):
    """Every leaf on ``device``; floating leaves also cast to ``dtype`` if given."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device, dtype) for k, v in tree.items()}
    v = _leaf(tree)
    return v.to(device=device, dtype=dtype if dtype is not None and v.is_floating_point() else None)


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
