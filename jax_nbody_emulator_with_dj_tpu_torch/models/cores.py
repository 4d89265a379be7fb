"""The four emulator model cores.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/models/cores.py``, with its
fields:

  * ``StyleNBodyEmulatorCore``     flexible cosmology, displacement only:
    ``apply(params, x, Om, Dz)``;
  * ``StyleNBodyEmulatorVelCore``  flexible cosmology, displacement+velocity:
    ``apply(params, x, Om, Dz, vel_fac)``;
  * ``NBodyEmulatorCore``          premodulated, displacement only:
    ``apply(params, x, Dz)``;
  * ``NBodyEmulatorVelCore``       premodulated, displacement+velocity:
    ``apply(params, x, Dz, vel_fac)``.

A style model's velocity is ``vel_fac * d(disp)/dDz``, forward-mode AD of the
styled displacement with respect to Dz (``torch.func.jvp``), which enters at
the input scale, at style slot 1 and in the residual head.  The premodulated
velocity model threads its tangent by hand through the baked ``dweight``s.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..ops.style import style_vector
from .unet import init_unet, input_margin, unet_forward, unet_forward_vel


def _vec(v, device):
    """A scalar or (B,) value -> float32 (B,) tensor on ``device``."""
    return torch.atleast_1d(torch.as_tensor(v, dtype=torch.float32, device=device))


def _bcast(v):
    """(B,) -> (B, 1, 1, 1, 1), against 5-D activations."""
    return v.reshape(-1, 1, 1, 1, 1)


@dataclass(frozen=True)
class _CoreBase:
    style_size: int = 2
    in_chan: int = 3
    out_chan: int = 3
    mid_chan: int = 64
    eps: float = 1e-8
    levels: int = 3
    data_format: str = "NCDHW"

    # subclass flags
    _style: bool = field(default=False, repr=False)
    _vel: bool = field(default=False, repr=False)

    @property
    def margin(self) -> int:
        return input_margin(self.levels)

    def init(self, seed: int = 0):
        """Seeded random float32 parameter tree, with the JAX package's
        structure: style weights for the style cores, a learned ``dweight``
        per layer for the premodulated velocity core."""
        return init_unet(seed, levels=self.levels, in_chan=self.in_chan,
                         out_chan=self.out_chan, mid_chan=self.mid_chan, style=self._style,
                         vel=self._vel and not self._style, style_size=self.style_size)

    def _prep(self, x):
        """Batch a (C, D, H, W) input; the second value restores the output."""
        if x.dim() == 4:
            return x[None], lambda y: y[0]
        return x, lambda y: y

    def _margin_crop(self, x):
        m = self.margin
        if self.data_format == "NCDHW":
            return x[:, :, m:-m, m:-m, m:-m]
        return x[:, m:-m, m:-m, m:-m, :]

    def __call__(self, params, *args, **kw):
        return self.apply(params, *args, **kw)

    def _disp_forward(self, params, x, dz, s):
        """Scale by Dz/6 -> U-Net (styled iff ``s``) -> head (h + x0) * 6."""
        x = x * (_bcast(dz).to(x.dtype) / torch.tensor(6.0, dtype=x.dtype))
        x0 = self._margin_crop(x)
        h = unet_forward(params, x, s=s, levels=self.levels, eps=self.eps,
                         io_fmt=self.data_format)
        return (h + x0) * torch.tensor(6.0, dtype=h.dtype)


@dataclass(frozen=True)
class StyleNBodyEmulatorCore(_CoreBase):
    """Styled U-Net, displacement only: apply(params, x, Om, Dz)."""

    _style: bool = field(default=True, repr=False)
    _vel: bool = field(default=False, repr=False)

    def apply(self, params, x, Om, Dz):
        """x: (B, C, D, H, W) or (C, D, H, W); Om, Dz: scalars or (B,)."""
        x, restore = self._prep(x)
        om, dz = _vec(Om, x.device), _vec(Dz, x.device)
        return restore(self._disp_forward(params, x, dz, style_vector(om, dz)))


@dataclass(frozen=True)
class StyleNBodyEmulatorVelCore(_CoreBase):
    """Styled U-Net, displacement + velocity: apply(params, x, Om, Dz, vel_fac).

    velocity = vel_fac * d(displacement)/dDz, by ``torch.func.jvp`` of the
    styled displacement with respect to Dz (tangent ones).
    """

    _style: bool = field(default=True, repr=False)
    _vel: bool = field(default=True, repr=False)

    def apply(self, params, x, Om, Dz, vel_fac):
        """x: (B, C, D, H, W) or (C, D, H, W); Om, Dz, vel_fac: scalars or (B,)."""
        x, restore = self._prep(x)
        om, dz, vf = (_vec(v, x.device) for v in (Om, Dz, vel_fac))

        def disp_of(dz_):
            return self._disp_forward(params, x, dz_, style_vector(om, dz_))

        disp, ddisp = torch.func.jvp(disp_of, (dz,), (torch.ones_like(dz),))
        return restore(disp), restore(ddisp * _bcast(vf).to(ddisp.dtype))


@dataclass(frozen=True)
class NBodyEmulatorCore(_CoreBase):
    """Premodulated U-Net, displacement only: apply(params, x, Dz).

    Head (reference ``nbody_emulator_core.py``): the input is scaled by
    Dz/6, x0 is its margin crop, and disp = (net(x) + x0) * 6.
    """

    _style: bool = field(default=False, repr=False)
    _vel: bool = field(default=False, repr=False)

    def apply(self, params, x, Dz):
        """x: (B, C, D, H, W) or (C, D, H, W); Dz: scalar or (B,)."""
        x, restore = self._prep(x)
        return restore(self._disp_forward(params, x, _vec(Dz, x.device), None))


@dataclass(frozen=True)
class NBodyEmulatorVelCore(_CoreBase):
    """Premodulated U-Net, displacement + velocity: apply(params, x, Dz, vel_fac).

    Tangents are threaded by hand through the baked ``dweight``s.  Head
    (reference ``nbody_emulator_vel_core.py``):
        disp = (h + x0) * 6
        vel  = dh * (vel_fac * 6) + x0 * (vel_fac * 6 / Dz)
    with both factors computed in float32 and cast to h's dtype.
    """

    _style: bool = field(default=False, repr=False)
    _vel: bool = field(default=True, repr=False)

    def apply(self, params, x, Dz, vel_fac):
        """x: (B, C, D, H, W) or (C, D, H, W); Dz, vel_fac: scalars or (B,)."""
        x, restore = self._prep(x)
        dz, vf = _bcast(_vec(Dz, x.device)), _bcast(_vec(vel_fac, x.device))
        x = x * (dz.to(x.dtype) / torch.tensor(6.0, dtype=x.dtype))
        x0 = self._margin_crop(x)
        h, dh = unet_forward_vel(params, x, levels=self.levels, io_fmt=self.data_format)
        disp = (h + x0) * torch.tensor(6.0, dtype=h.dtype)
        vel = dh * (vf * 6.0).to(h.dtype) + x0 * (vf * 6.0 / dz).to(h.dtype)
        return restore(disp), restore(vel)
