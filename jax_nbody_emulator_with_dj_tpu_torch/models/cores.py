"""Emulator model cores.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/models/cores.py``.  The
premodulated cores are ported (displacement, and displacement+velocity);
the style cores are ROADMAP item A3.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .unet import input_margin, unet_forward, unet_forward_vel


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


@dataclass(frozen=True)
class NBodyEmulatorVelCore(NBodyEmulatorCore):
    """Premodulated U-Net, displacement + velocity: apply(params, x, Dz, vel_fac).

    Tangents are threaded by hand through the baked ``dweight``s.  Head
    (reference ``nbody_emulator_vel_core.py``):
        disp = (h + x0) * 6
        vel  = dh * (vel_fac * 6) + x0 * (vel_fac * 6 / Dz)
    with both factors computed in float32 and cast to h's dtype.
    """

    def apply(self, params, x, Dz, vel_fac):
        """x: (B, C, D, H, W) or (C, D, H, W); Dz, vel_fac: scalars or (B,)."""
        unbatched = x.dim() == 4
        if unbatched:
            x = x[None]
        dz = torch.atleast_1d(torch.as_tensor(Dz, dtype=torch.float32, device=x.device))
        vf = torch.atleast_1d(torch.as_tensor(vel_fac, dtype=torch.float32, device=x.device))
        dz, vf = dz.reshape(-1, 1, 1, 1, 1), vf.reshape(-1, 1, 1, 1, 1)
        x = x * (dz.to(x.dtype) / torch.tensor(6.0, dtype=x.dtype))
        m = self.margin
        if self.data_format == "NCDHW":
            x0 = x[:, :, m:-m, m:-m, m:-m]
        else:
            x0 = x[:, m:-m, m:-m, m:-m, :]
        h, dh = unet_forward_vel(params, x, levels=self.levels, io_fmt=self.data_format)
        disp = (h + x0) * torch.tensor(6.0, dtype=h.dtype)
        vel = dh * (vf * 6.0).to(h.dtype) + x0 * (vf * 6.0 / dz).to(h.dtype)
        return (disp[0], vel[0]) if unbatched else (disp, vel)
