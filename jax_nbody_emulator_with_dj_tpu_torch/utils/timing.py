"""Device synchronization for wall-clock timing.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/utils/timing.py``.  PyTorch
queues CUDA work and returns before the card has run it, so a host clock
around a call measures the enqueue unless the caller waits for the device.
"""

from __future__ import annotations

import dataclasses

import torch


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))


def force_sync(tree):
    """Block until the work that produces every tensor in ``tree`` is done.

    Synchronizes each CUDA device that holds a tensor of the tree (dicts,
    lists, tuples and dataclasses are walked); CPU tensors and other leaves
    need nothing.  Returns ``tree``.
    """
    devices = {t.device for t in _leaves(tree) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree
