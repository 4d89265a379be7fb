"""User-facing factory and bundle: create_emulator / NBodyEmulator.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/emulator.py``: the four
model cores (flexible-cosmology style models by default; premodulated ones,
with the style fold done at creation, for ``premodulate=True``), each with
displacement only or displacement+velocity, and the big-box runtimes as
their processor (``SubboxConfig`` -> ``SubboxProcessor``,
``HierarchicalConfig`` -> ``HierarchicalProcessor``,
``ChunkedHierarchicalConfig`` -> ``ChunkedHierarchicalProcessor``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .cosmology import growth_factor, vel_norm
from .hierarchical import HierarchicalConfig, HierarchicalProcessor, resolve_device
from .models.cores import (
    NBodyEmulatorCore,
    NBodyEmulatorVelCore,
    StyleNBodyEmulatorCore,
    StyleNBodyEmulatorVelCore,
)
from .ops.style import premodulate_layer, style_vector
from .subbox import SubboxConfig, SubboxProcessor
from .utils.params import convert_reference_params, load_params_npz, tree_to


@dataclass
class NBodyEmulator:
    """Bundle of model + params + (optional) big-box processor: a
    ``SubboxProcessor``, ``HierarchicalProcessor`` or
    ``ChunkedHierarchicalProcessor``."""

    model: object
    params: dict | None
    processor: object | None
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
        z, Om = np.atleast_1d(z), np.atleast_1d(Om)
        Dz = torch.as_tensor(growth_factor(z, Om), dtype=torch.float32)
        params = tree_to(self.params, self.device)
        x = x.to(self.device, self.dtype)
        args = (Dz,) if self.premodulate else (torch.as_tensor(Om, dtype=torch.float32), Dz)
        if self.compute_vel:
            args += (torch.as_tensor(vel_norm(z, Om), dtype=torch.float32),)
        with torch.no_grad():
            return self.model.apply(params, x, *args)

    def process_box(self, input_box, z, Om, desc="Processing subboxes", show_progress=True,
                    **kw):
        """The processor's ``process_box``; ``desc`` and ``show_progress`` reach
        a ``SubboxProcessor`` only, as in the JAX bundle."""
        if self.processor is None:
            raise ValueError("No processor created; pass processor_config= to create_emulator.")
        if isinstance(self.processor, SubboxProcessor):
            kw = dict(kw, desc=desc, show_progress=show_progress)
        return self.processor.process_box(input_box, z, Om, **kw)

    __call__ = apply


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


def _make_processor(model, params, config, device):
    """Dispatch a processor_config dataclass to its runtime."""
    from .chunked import ChunkedHierarchicalConfig, ChunkedHierarchicalProcessor

    if not isinstance(config, (SubboxConfig, HierarchicalConfig, ChunkedHierarchicalConfig)):
        raise TypeError(
            "processor_config must be a SubboxConfig, HierarchicalConfig, or "
            f"ChunkedHierarchicalConfig, got {type(config).__name__}"
        )
    if params is None:
        raise ValueError("a processor runs the model's parameters: pass params= (or "
                         "load_params=True) with processor_config=")
    if isinstance(config, SubboxConfig):
        return SubboxProcessor(model, params, config, device=device)
    if isinstance(config, ChunkedHierarchicalConfig):
        return ChunkedHierarchicalProcessor(model, params, config, device=device)
    return HierarchicalProcessor(model, params, config, device=device)


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
        premodulate: fold style into weights at creation (fixed cosmology);
            selects the premodulated cores, else the style cores, which take
            the cosmology per call.
        compute_vel: the model also returns velocities (``process_box`` and
            ``apply`` then return ``(disp, vel)``).
        load_params: load the default parameters (``load_default_parameters``;
            ignored when ``params`` is given).  With ``False`` and no
            ``params`` the bundle carries none and its ``apply`` raises.
        params: parameter tree (dicts of torch tensors; DHWIO kernels, or the
            reference's OIDHW ones, converted here;
            ``utils.params.params_from_jax`` converts a JAX tree,
            ``utils.params.load_params_npz`` reads a saved one).
        processor_config: the runtime of ``process_box``: a ``SubboxConfig``
            builds a ``SubboxProcessor`` (the reference's semantics), a
            ``HierarchicalConfig`` a ``HierarchicalProcessor``, a
            ``ChunkedHierarchicalConfig`` a ``ChunkedHierarchicalProcessor``;
            each needs parameters.  ``geometry.auto_hierarchical_config(size,
            ...)`` plans a config that fits the card.
        premodulate_z / premodulate_Om: fixed cosmology for the fold.
        dtype: compute dtype; ``processor_config.dtype`` wins if present.
        device: torch device of the processor and of ``apply`` (default: the CUDA
            card; raises if there is none.  Pass ``"cpu"`` to run on the CPU).
        **model_kwargs: forwarded to the model (style_size, in_chan, out_chan,
            mid_chan, eps, levels, data_format).
    """
    if premodulate:
        cls = NBodyEmulatorVelCore if compute_vel else NBodyEmulatorCore
    else:
        cls = StyleNBodyEmulatorVelCore if compute_vel else StyleNBodyEmulatorCore
    model = cls(**model_kwargs)
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
        if premodulate and has_style:
            if premodulate_z is None or premodulate_Om is None:
                raise ValueError(
                    "premodulate_z and premodulate_Om are required when premodulate=True")
            fold = modulate_emulator_parameters_vel if compute_vel else modulate_emulator_parameters
            params = fold(params, premodulate_z, premodulate_Om, eps=model.eps)

    processor = None
    if processor_config is not None:
        processor = _make_processor(model, params, processor_config, device)
        dtype = processor_config.dtype
    elif dtype is None:
        dtype = torch.float32

    return NBodyEmulator(model=model, params=params, processor=processor,
                         premodulate=premodulate, compute_vel=compute_vel, dtype=dtype,
                         device=device)
