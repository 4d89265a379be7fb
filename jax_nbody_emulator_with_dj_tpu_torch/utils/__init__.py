"""Parameter utilities of the PyTorch port: trees, ``.npz`` interchange with
the JAX package, checkpoints and the map2map torch-checkpoint import."""

from .checkpoint import load_checkpoint, save_checkpoint
from .params import (
    convert_reference_params,
    convert_to_reference_params,
    load_params_npz,
    params_from_jax,
    save_params_npz,
    tree_cast,
    tree_to,
)
from .torch_convert import convert_torch_state_dict, default_key_map, load_torch_checkpoint

__all__ = [
    "convert_reference_params",
    "convert_to_reference_params",
    "load_params_npz",
    "save_params_npz",
    "params_from_jax",
    "tree_cast",
    "tree_to",
    "save_checkpoint",
    "load_checkpoint",
    "convert_torch_state_dict",
    "default_key_map",
    "load_torch_checkpoint",
]
