"""User-facing factory and bundle: create_emulator / NBodyEmulator.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/emulator.py``.  Ported so
far: the premodulated displacement and displacement+velocity models
(``premodulate=True``), with the style fold done at creation, and the
hierarchical runtime as their processor.  The style (non-premodulated)
models raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .cosmology import growth_factor, vel_norm
from .hierarchical import HierarchicalConfig, HierarchicalProcessor, resolve_device
from .models.cores import NBodyEmulatorCore, NBodyEmulatorVelCore
from .ops.style import premodulate_layer, style_vector


@dataclass
class NBodyEmulator:
    """Bundle of model + params + (optional) hierarchical processor."""

    model: NBodyEmulatorCore | NBodyEmulatorVelCore
    params: dict
    processor: HierarchicalProcessor | None
    device: torch.device
    dtype: torch.dtype = torch.float32

    @property
    def compute_vel(self) -> bool:
        return isinstance(self.model, NBodyEmulatorVelCore)

    def apply(self, x, z, Om):
        """Run the model directly on a (padded) (B, C, D, H, W) or (C, D, H, W)
        tensor; velocity models return ``(disp, vel)``."""
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
        params: parameter tree (dicts of torch tensors, DHWIO kernels;
            ``utils.params.params_from_jax`` converts a JAX tree,
            ``utils.params.load_params_npz`` reads a saved one).  Required:
            the port ships no pretrained weights.
        processor_config: a ``HierarchicalConfig`` builds the hierarchical
            runtime for ``process_box``.
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

    if params is None:
        raise ValueError("pass params=: the port ships no pretrained weights")
    has_style = any(
        "style_weight" in layer
        for block in params["params"].values()
        for layer in block.values()
    )
    if has_style:
        if premodulate_z is None or premodulate_Om is None:
            raise ValueError("premodulate_z and premodulate_Om are required when premodulate=True")
        fold = modulate_emulator_parameters_vel if compute_vel else modulate_emulator_parameters
        params = fold(params, premodulate_z, premodulate_Om, eps=model.eps)

    processor = None
    if processor_config is not None:
        if not isinstance(processor_config, HierarchicalConfig):
            raise NotImplementedError(
                f"{type(processor_config).__name__} is not ported: ROADMAP items A5/A6"
            )
        processor = HierarchicalProcessor(model, params, processor_config, device=device)
        dtype = processor_config.dtype
    elif dtype is None:
        dtype = torch.float32

    return NBodyEmulator(model=model, params=params, processor=processor, dtype=dtype,
                         device=device)
