"""Big-box runtime with the reference's semantics: the subbox decomposition.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/subbox.py``.  The periodic
box is wrap-padded once on the device by the model's receptive margin; then
for each subbox a view of its padded crop goes through the model's own
(unpacked) forward, and the result is written into its slice of output
tensors allocated once, in ``output_dtype``.  Every core runs here, the
style cores at the call's (Om, Dz) without any fold.  It is the runtime the
hierarchical one is held against.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .cosmology import growth_factor, vel_norm
from .hierarchical import resolve_device
from .models.cores import NBodyEmulatorCore, NBodyEmulatorVelCore, StyleNBodyEmulatorVelCore
from .utils.params import tree_to


@dataclass
class SubboxConfig:
    """Decomposition geometry (the JAX package's fields and checks).

    Attributes:
        size: full box spatial size (D, H, W).
        ndiv: number of divisions per axis.
        dtype: compute dtype (a torch dtype).
        output_dtype: dtype of the assembled outputs (a torch dtype).
        in_chan: input channels (3 for displacement).
        padding: per-axis (lo, hi) halo = the model's receptive margin.
    """

    size: tuple[int, int, int]
    ndiv: tuple[int, int, int]
    dtype: torch.dtype = torch.float32
    output_dtype: torch.dtype = torch.float32
    in_chan: int = 3
    padding: tuple[tuple[int, int], ...] = ((48, 48), (48, 48), (48, 48))

    def __post_init__(self):
        self.NDIM = 3
        self.size = tuple(int(s) for s in self.size)
        self.ndiv = tuple(int(d) for d in self.ndiv)
        for s, d in zip(self.size, self.ndiv):
            if s % d:
                raise ValueError(f"size {self.size} not divisible by ndiv {self.ndiv}")
        self.n_subboxes = int(np.prod(self.ndiv))
        self.crop_size = tuple(s // d for s, d in zip(self.size, self.ndiv))
        # row-major subbox index -> per-axis anchor (voxel) coordinates
        grid = np.stack(
            np.meshgrid(*[np.arange(d) for d in self.ndiv], indexing="ij"), axis=-1
        ).reshape(-1, 3)
        self.anchors = (grid * np.array(self.crop_size)).astype(np.int32)  # (n, 3)
        self.crop_extent = tuple(c + p0 + p1 for c, (p0, p1) in zip(self.crop_size, self.padding))

    def _get_anchor(self, idx: int):
        return tuple(int(a) for a in self.anchors[idx])

    def crop_indices(self, idx: int):
        """Per-axis periodic gather indices for the padded crop."""
        return [np.arange(a - p0, a + c + p1) % s
                for a, c, (p0, p1), s in zip(self.anchors[idx], self.crop_size, self.padding,
                                             self.size)]


def _wrap_pad(box, padding):
    """Periodic (lo, hi) pad of the spatial axes of a (C, D, H, W) tensor."""
    for ax, (p0, p1) in zip((1, 2, 3), padding):
        n = box.shape[ax]
        box = box.index_select(ax, torch.arange(-p0, n + p1, device=box.device) % n)
    return box


class SubboxProcessor:
    """Runs a model over all subboxes of a periodic volume, on the device.

    The model variant (premodulated or style, with or without velocity) is
    inferred from the model's type, as in the JAX package.
    """

    def __init__(self, model, params, config: SubboxConfig, loop: str = "python", device=None):
        """Args:
            loop: ``"python"`` or ``"fused"``, the JAX package's two loop
                strategies.  Both run the same Python loop here: eager PyTorch
                has no traced loop to fuse it into.
            device: where the box and the model run (default: the CUDA card;
                ``"cpu"`` runs on the CPU).
        """
        if loop not in ("python", "fused"):
            raise ValueError(f"loop must be 'python' or 'fused', got {loop!r}")
        self.loop = loop
        self.model = model
        self.config = config
        self.device = resolve_device(device)
        self.params = None if params is None else tree_to(params, self.device)
        self.premodulate = isinstance(model, (NBodyEmulatorCore, NBodyEmulatorVelCore))
        self.compute_vel = isinstance(model, (NBodyEmulatorVelCore, StyleNBodyEmulatorVelCore))
        margin = getattr(model, "margin", None)
        if margin is not None:
            for p0, p1 in config.padding:
                if p0 != margin or p1 != margin:
                    raise ValueError(f"padding {config.padding} must equal the model's "
                                     f"receptive margin {margin} per side")

    def _apply(self, x, Om, Dz, vel_fac):
        """The model on one batched crop: a tuple of one or two outputs."""
        if self.premodulate:
            args = (Dz, vel_fac) if self.compute_vel else (Dz,)
        else:
            args = (Om, Dz, vel_fac) if self.compute_vel else (Om, Dz)
        out = self.model.apply(self.params, x, *args)
        return out if self.compute_vel else (out,)

    def process_box(self, input_box, z: float, Om: float, desc: str = "Processing subboxes",
                    show_progress: bool = True, as_numpy: bool = True):
        """Process a full periodic box.

        Args:
            input_box: (C, D, H, W) displacement field (numpy or torch).
            z, Om: output redshift and matter density.
            desc, show_progress: accepted for the reference's signature; the
                loop prints nothing.
            as_numpy: return host numpy arrays; False keeps torch tensors on
                the device.

        Returns:
            displacement (C, D, H, W), or (displacement, velocity) when the
            model computes velocity.
        """
        del desc, show_progress
        cfg = self.config
        if tuple(input_box.shape) != (cfg.in_chan,) + cfg.size:
            raise ValueError(f"input_box shape {tuple(input_box.shape)} != "
                             f"{(cfg.in_chan,) + cfg.size}")
        dz = torch.tensor([float(growth_factor(z, Om))], device=self.device)
        vf = torch.tensor([float(vel_norm(z, Om)) if self.compute_vel else 0.0],
                          device=self.device)
        om = torch.tensor([float(Om)], device=self.device)
        box = torch.as_tensor(input_box if torch.is_tensor(input_box) else np.asarray(input_box))
        outs = tuple(torch.zeros((cfg.in_chan,) + cfg.size, dtype=cfg.output_dtype,
                                 device=self.device)
                     for _ in range(2 if self.compute_vel else 1))
        with torch.no_grad():
            boxp = _wrap_pad(box.to(self.device).to(cfg.dtype), cfg.padding)
            for a in cfg.anchors.tolist():
                crop = boxp[:, a[0]:a[0] + cfg.crop_extent[0], a[1]:a[1] + cfg.crop_extent[1],
                            a[2]:a[2] + cfg.crop_extent[2]]
                for out, r in zip(outs, self._apply(crop[None], om, dz, vf)):
                    out[:, a[0]:a[0] + cfg.crop_size[0], a[1]:a[1] + cfg.crop_size[1],
                        a[2]:a[2] + cfg.crop_size[2]].copy_(r[0])
        outs = tuple(o.cpu().numpy() if as_numpy else o for o in outs)
        return outs if self.compute_vel else outs[0]
