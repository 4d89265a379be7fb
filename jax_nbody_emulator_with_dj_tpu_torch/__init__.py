"""PyTorch/CUDA port of the N-body emulator, for one NVIDIA H100.

A second package beside ``jax_nbody_emulator_with_dj_tpu`` (the reference it
is tested against).  Ported so far: the premodulated displacement and
displacement+velocity models on the packed hierarchical runtime, with the
F(2,3)^2 Winograd conv and its fused factored-tangent pair as CUDA kernels
for ``sm_90a`` (``csrc/wino_f23.cu``).  This package never imports JAX.
"""

from .cosmology import dlogH_dloga, growth_factor, growth_rate, hubble_rate, vel_norm
from .emulator import (
    NBodyEmulator,
    create_emulator,
    modulate_emulator_parameters,
    modulate_emulator_parameters_vel,
)
from .hierarchical import HierarchicalConfig, HierarchicalProcessor
from .models.cores import NBodyEmulatorCore, NBodyEmulatorVelCore

__version__ = "0.1.0"

__all__ = [
    "create_emulator",
    "NBodyEmulator",
    "modulate_emulator_parameters",
    "modulate_emulator_parameters_vel",
    "HierarchicalConfig",
    "HierarchicalProcessor",
    "NBodyEmulatorCore",
    "NBodyEmulatorVelCore",
    "growth_factor",
    "hubble_rate",
    "growth_rate",
    "dlogH_dloga",
    "vel_norm",
]
