"""Conversion of PyTorch (map2map-style) checkpoints to the port's tree.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/utils/torch_convert.py``.
The pretrained weights come from the map2map PyTorch project as a
``state_dict`` (``.pt`` / ``.pth``) with dotted module paths such as
``conv_l00.conv_0.weight``, OIDHW conv kernels and (Ci, S) style weights.
The keys, the unwrapping of training wrappers and the OIDHW -> DHWIO
transposition are the JAX package's; the leaves are float32 torch tensors
on the CPU.  A ``key_map`` hook adapts other naming conventions: it receives
each state-dict key and returns ``(block, layer, leaf)``, or None to skip it.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LEAVES = {"weight", "bias", "style_weight", "style_bias", "dweight"}


def default_key_map(key: str):
    """Map ``[module.]<block>.<layer>.<leaf>`` to a tree path.

    Drops the prefixes torch training wrappers add (``module.``, ``model.``,
    ``net.``); keys whose last part is not a parameter leaf map to None.
    """
    key = re.sub(r"^(module\.|model\.|net\.)+", "", key)
    parts = key.split(".")
    if len(parts) < 3 or parts[-1] not in _LEAVES:
        return None
    return ".".join(parts[:-2]), parts[-2], parts[-1]


def convert_torch_state_dict(state_dict, key_map=default_key_map) -> dict:
    """Torch state dict -> the port's DHWIO parameter tree.

    Conv kernels (5-D ``weight`` / ``dweight``, torch OIDHW) become
    (K, K, K, Ci, Co); other leaves pass through.  Leaves are float32 CPU
    tensors, contiguous.
    """
    params: dict = {}
    for key, value in state_dict.items():
        mapped = key_map(key)
        if mapped is None:
            continue
        block, layer, leaf = mapped
        t = value.detach().cpu() if torch.is_tensor(value) else torch.from_numpy(np.array(value))
        if leaf in ("weight", "dweight") and t.dim() == 5:
            t = t.permute(2, 3, 4, 1, 0)  # OIDHW -> DHWIO
        params.setdefault(block, {}).setdefault(layer, {})[leaf] = \
            t.to(torch.float32).contiguous()
    if not params:
        raise ValueError("no recognizable parameters in state dict; pass a custom key_map")
    return {"params": params}


def load_torch_checkpoint(path, key_map=default_key_map) -> dict:
    """Load a ``.pt`` / ``.pth`` checkpoint file and convert it.

    The file is unpickled in full (``weights_only=False``, as the JAX
    package reads it): load only checkpoints from a source you trust.
    """
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for candidate in ("state_dict", "model", "model_state_dict"):
        if isinstance(obj, dict) and candidate in obj and isinstance(obj[candidate], dict):
            obj = obj[candidate]
            break
    return convert_torch_state_dict(obj, key_map=key_map)
