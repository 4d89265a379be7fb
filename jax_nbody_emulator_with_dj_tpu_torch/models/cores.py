"""Emulator model cores.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/models/cores.py``.  Only the
premodulated displacement core is ported so far; the style cores and the
velocity cores are ROADMAP items A2/A3.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .unet import input_margin, unet_forward


@dataclass(frozen=True)
class NBodyEmulatorCore:
    """Premodulated U-Net, displacement only: apply(params, x, Dz).

    Head (reference ``nbody_emulator_core.py``): the input is scaled by
    Dz/6, x0 is its margin crop, and disp = (net(x) + x0) * 6.
    """

    in_chan: int = 3
    out_chan: int = 3
    mid_chan: int = 64
    eps: float = 1e-8
    levels: int = 3
    data_format: str = "NCDHW"

    @property
    def margin(self) -> int:
        return input_margin(self.levels)

    def apply(self, params, x, Dz):
        """x: (B, C, D, H, W) or (C, D, H, W); Dz: scalar or (B,)."""
        unbatched = x.dim() == 4
        if unbatched:
            x = x[None]
        dz = torch.atleast_1d(torch.as_tensor(Dz, dtype=torch.float32, device=x.device))
        in_norm = dz.to(x.dtype).reshape(-1, 1, 1, 1, 1) / torch.tensor(6.0, dtype=x.dtype)
        x = x * in_norm
        m = self.margin
        if self.data_format == "NCDHW":
            x0 = x[:, :, m:-m, m:-m, m:-m]
        else:
            x0 = x[:, m:-m, m:-m, m:-m, :]
        h = unet_forward(params, x, levels=self.levels, io_fmt=self.data_format)
        out = (h + x0) * torch.tensor(6.0, dtype=h.dtype)
        return out[0] if unbatched else out

    __call__ = apply
