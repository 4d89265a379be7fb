"""User-facing factory and bundle: create_emulator / NBodyEmulator.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/emulator.py``.  Ported so
far: the premodulated displacement and displacement+velocity models
(``premodulate=True``), with the style fold done at creation, and the
hierarchical runtime as their processor.  The style (non-premodulated)
models raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .cosmology import growth_factor, vel_norm
from .hierarchical import HierarchicalConfig, HierarchicalProcessor, resolve_device
from .models.cores import NBodyEmulatorCore, NBodyEmulatorVelCore
from .ops.style import premodulate_layer, style_vector
from .utils.params import convert_reference_params, load_params_npz


@dataclass
class NBodyEmulator:
    """Bundle of model + params + (optional) hierarchical processor."""

    model: NBodyEmulatorCore | NBodyEmulatorVelCore
    params: dict | None
    processor: HierarchicalProcessor | None
    premodulate: bool = False
    compute_vel: bool = True
    dtype: torch.dtype = torch.float32
    device: torch.device | str | None = None  # where ``apply`` runs (None: the CUDA card)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def apply(self, x, z, Om):
        """Run the model directly on a (padded) (B, C, D, H, W) or (C, D, H, W)
        tensor; velocity models return ``(disp, vel)``."""
        if self.params is None:
            raise ValueError("No parameters loaded; pass params= to create_emulator.")
        Dz = torch.as_tensor(growth_factor(z, Om), dtype=torch.float32)
        params = _tree_to(self.params, self.device)
        x = x.to(self.device, self.dtype)
        with torch.no_grad():
            if self.compute_vel:
                vf = torch.as_tensor(vel_norm(z, Om), dtype=torch.float32)
                return self.model.apply(params, x, Dz, vf)
            return self.model.apply(params, x, Dz)

    def process_box(self, input_box, z, Om, **kw):
        if self.processor is None:
            raise ValueError("No processor created; pass processor_config= to create_emulator.")
        return self.processor.process_box(input_box, z, Om, **kw)

    __call__ = apply


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def default_parameters_path() -> Path:
    """Where ``load_default_parameters`` looks: ``$JAX_NBODY_EMULATOR_PARAMS``
    (the JAX package's variable: both read the same file format), else the
    package's own ``model_parameters/nbody_emulator_params.npz``."""
    env = os.environ.get("JAX_NBODY_EMULATOR_PARAMS")
    if env:
        return Path(env)
    return Path(__file__).parent / "model_parameters" / "nbody_emulator_params.npz"


def load_default_parameters() -> dict:
    """Load the pretrained parameters (converted to DHWIO layout).

    The file may be this package's save format or the reference's OIDHW
    pickle: the layout is detected from the kernel shapes.  The repository
    ships no such file, so without one this raises ``FileNotFoundError``.
    """
    path = default_parameters_path()
    if not path.exists():
        raise FileNotFoundError(
            f"Pretrained parameters not found at {path}. Set "
            "JAX_NBODY_EMULATOR_PARAMS or pass params= / load_params=False."
        )
    return ensure_native_layout(load_params_npz(path))


def ensure_native_layout(params: dict) -> dict:
    """Convert an OIDHW (reference-layout) tree to DHWIO if needed."""
    # One 5-D conv kernel tells: the reference layout has the two channel dims
    # first and equal kernel dims last; a (K, K, K, Ci, Co) kernel has
    # shape[0] == shape[1] == shape[2].
    def find_kernel(node):
        if isinstance(node, dict):
            if "weight" in node and np.ndim(node["weight"]) == 5:
                return tuple(node["weight"].shape)
            for v in node.values():
                got = find_kernel(v)
                if got is not None:
                    return got
        return None

    shp = find_kernel(params)
    if shp is None or shp[0] == shp[1] == shp[2]:
        return params
    return convert_reference_params(params)


def _is_first_layer(block_name: str, layer_name: str) -> bool:
    """Layers whose input is the raw (Dz-linear) network input: conv_l00's
    conv_0 and skip."""
    return block_name == "conv_l00" and layer_name in ("conv_0", "skip")


def _modulate_tree(params: dict, s, *, vel: bool, eps: float, factors: bool = False) -> dict:
    out = {"params": {}}
    for block_name, block in params["params"].items():
        out["params"][block_name] = {
            layer_name: premodulate_layer(
                layer, s, vel=vel, first_layer=vel and _is_first_layer(block_name, layer_name),
                eps=eps, factors=factors and vel,
            ) if "style_weight" in layer else layer
            for layer_name, layer in block.items()
        }
    return out


def modulate_emulator_parameters(params: dict, z, Om, eps: float = 1e-8) -> dict:
    """Fold style into fixed-cosmology weights (displacement-only models)."""
    Dz = growth_factor(z, Om)
    s = style_vector(float(Om), float(Dz))[0]
    return _modulate_tree(params, s, vel=False, eps=eps)


def modulate_emulator_parameters_vel(params: dict, z, Om, eps: float = 1e-8) -> dict:
    """Fold style + analytic d/dDz tangents (displacement+velocity models)."""
    Dz = growth_factor(z, Om)
    s = style_vector(float(Om), float(Dz))[0]
    return _modulate_tree(params, s, vel=True, eps=eps)


def create_emulator(
    premodulate: bool = False,
    compute_vel: bool = True,
    load_params: bool = True,
    params: dict | None = None,
    processor_config=None,
    premodulate_z: float | None = None,
    premodulate_Om: float | None = None,
    dtype: torch.dtype | None = None,
    device=None,
    **model_kwargs,
) -> NBodyEmulator:
    """Build an emulator bundle.

    Args:
        premodulate: fold style into weights at creation (fixed cosmology).
            Only ``True`` is ported.
        compute_vel: the model also returns velocities (``process_box`` and
            ``apply`` then return ``(disp, vel)``).
        load_params: load the default parameters (``load_default_parameters``;
            ignored when ``params`` is given).  With ``False`` and no
            ``params`` the bundle carries none and its ``apply`` raises.
        params: parameter tree (dicts of torch tensors; DHWIO kernels, or the
            reference's OIDHW ones, converted here;
            ``utils.params.params_from_jax`` converts a JAX tree,
            ``utils.params.load_params_npz`` reads a saved one).
        processor_config: a ``HierarchicalConfig`` builds the hierarchical
            runtime for ``process_box``; it needs parameters.
        premodulate_z / premodulate_Om: fixed cosmology for the fold.
        dtype: compute dtype; ``processor_config.dtype`` wins if present.
        device: torch device of the processor and of ``apply`` (default: the CUDA
            card; raises if there is none.  Pass ``"cpu"`` to run on the CPU).
        **model_kwargs: forwarded to the model (in_chan, out_chan, mid_chan,
            eps, levels, data_format).
    """
    if not premodulate:
        raise NotImplementedError("style (non-premodulated) cores are not ported: ROADMAP item A3")
    model = (NBodyEmulatorVelCore if compute_vel else NBodyEmulatorCore)(**model_kwargs)
    device = resolve_device(device)

    if params is None and load_params:
        params = load_default_parameters()
    if params is not None:
        params = ensure_native_layout(params)
        has_style = any(
            "style_weight" in layer
            for block in params["params"].values()
            for layer in block.values()
        )
        if has_style:
            if premodulate_z is None or premodulate_Om is None:
                raise ValueError(
                    "premodulate_z and premodulate_Om are required when premodulate=True")
            fold = modulate_emulator_parameters_vel if compute_vel else modulate_emulator_parameters
            params = fold(params, premodulate_z, premodulate_Om, eps=model.eps)

    processor = None
    if processor_config is not None:
        if not isinstance(processor_config, HierarchicalConfig):
            raise NotImplementedError(
                f"{type(processor_config).__name__} is not ported: ROADMAP items A5/A6"
            )
        if params is None:
            raise ValueError("a HierarchicalProcessor packs the model's parameters when it is "
                             "built: pass params= (or load_params=True) with processor_config=")
        processor = HierarchicalProcessor(model, params, processor_config, device=device)
        dtype = processor_config.dtype
    elif dtype is None:
        dtype = torch.float32

    return NBodyEmulator(model=model, params=params, processor=processor,
                         premodulate=premodulate, compute_vel=compute_vel, dtype=dtype,
                         device=device)
