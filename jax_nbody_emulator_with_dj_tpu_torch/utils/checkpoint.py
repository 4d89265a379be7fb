"""Checkpointing: save and restore parameter trees.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/utils/checkpoint.py``, in
another format: the JAX package writes an Orbax checkpoint directory, which
needs ``orbax``; the port writes one ``torch.save`` file of the tree (CPU
tensors) and reads it back with ``weights_only=True``.  Neither package reads
the other's checkpoints: trees move between the two packages as ``.npz``
(``utils/params.py::save_params_npz`` / ``load_params_npz``).
"""

from __future__ import annotations

import os
from pathlib import Path

import torch

from .params import tree_to


def save_checkpoint(path, params: dict) -> None:
    """Save a parameter tree as one file at ``path`` (written to a temporary
    file beside it first, then renamed, so a reader never sees half a file)."""
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    torch.save(tree_to(params, "cpu"), tmp)
    os.replace(tmp, path)


def _restore_like(tree, like, where=()):
    if isinstance(like, dict):
        if not isinstance(tree, dict) or tree.keys() != like.keys():
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"checkpoint tree at {where} has {got}, expected {sorted(like)}")
        return {k: _restore_like(tree[k], v, where + (k,)) for k, v in like.items()}
    if not torch.is_tensor(tree) or tuple(tree.shape) != tuple(like.shape):
        shape = tuple(tree.shape) if torch.is_tensor(tree) else type(tree).__name__
        raise ValueError(f"checkpoint leaf {where} is {shape}, expected {tuple(like.shape)}")
    return tree.to(like.dtype)


def load_checkpoint(path, like: dict | None = None) -> dict:
    """Restore a parameter tree saved by :func:`save_checkpoint`.

    Args:
        path: the checkpoint file.
        like: optional tree (e.g. ``model.init()``): the restored tree must
            have its structure and leaf shapes, and takes its leaves' dtypes.
    """
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return tree if like is None else _restore_like(tree, like)
