"""PyTorch/CUDA port of the N-body emulator, for one NVIDIA H100.

A second package beside ``jax_nbody_emulator_with_dj_tpu`` (the reference it
is tested against).  Ported: the four model cores (flexible-cosmology style
models and premodulated ones, displacement and displacement+velocity, with
learned or folded tangent kernels); the three big-box runtimes -- subbox,
hierarchical (packed or unpacked, optionally with the y0 strip cache; a
style model's weights are folded at each box's cosmology) and chunked
hierarchical (boxes beyond one card, with resume) -- and the geometry
planner (``auto_hierarchical_config``, calibrated on the H100); the F(2,3)^2
Winograd conv and its fused factored-tangent pair as CUDA kernels for
``sm_90a`` (``csrc/wino_f23.cu``); and the three other conv routes of the
JAX package -- direct with a resident window (``csrc/direct_conv.cu``),
direct plane-streamed over N parts (``csrc/stripe_conv.cu``), mixed F(2,3) x
F(4,3) Winograd (``csrc/wino_f43.cu``) -- behind the conv-route bench
(``experiments/conv_routes.py``); and the science pipeline
(``run_lpt_emulator_pipeline``: Gaussian random field -> Zel'dovich
displacement -> emulator -> deposited density) with its single-device toolkit
(``science``: power spectra, EH98 P(k), mass assignment, resizing, Minkowski
functionals, bispectrum, halofit, FoF halos).  Entry points run on the CUDA card unless
the caller passes ``device="cpu"``.  This package never imports JAX.
"""

from .cosmology import (
    acc_norm,
    dlogD_dz,
    dlogH_dloga,
    dlogH_dz,
    growth_d_approx,
    growth_factor,
    growth_rate,
    hubble_rate,
    vel_norm,
)
from .emulator import (
    NBodyEmulator,
    create_emulator,
    default_parameters_path,
    ensure_native_layout,
    load_default_parameters,
    modulate_emulator_parameters,
    modulate_emulator_parameters_vel,
)
from .hierarchical import HierarchicalConfig, HierarchicalProcessor
from .chunked import ChunkedHierarchicalConfig, ChunkedHierarchicalProcessor
from .geometry import auto_hierarchical_config
from .subbox import SubboxConfig, SubboxProcessor
from .pipeline import PipelineResult, run_lpt_emulator_pipeline
from .models.cores import (
    NBodyEmulatorCore,
    NBodyEmulatorVelCore,
    StyleNBodyEmulatorCore,
    StyleNBodyEmulatorVelCore,
)
from .ops import (
    conv3_packed_stripe,
    conv3d_direct,
    conv3d_direct_packed,
    conv3d_wino43,
    conv3d_wino43_packed,
    conv3d_wino_packed,
    conv3d_wino_pair_packed,
)

__version__ = "0.1.0"

__all__ = [
    "create_emulator",
    "NBodyEmulator",
    "modulate_emulator_parameters",
    "modulate_emulator_parameters_vel",
    "default_parameters_path",
    "load_default_parameters",
    "ensure_native_layout",
    "SubboxConfig",
    "SubboxProcessor",
    "HierarchicalConfig",
    "HierarchicalProcessor",
    "ChunkedHierarchicalConfig",
    "ChunkedHierarchicalProcessor",
    "auto_hierarchical_config",
    "run_lpt_emulator_pipeline",
    "PipelineResult",
    "StyleNBodyEmulatorCore",
    "StyleNBodyEmulatorVelCore",
    "NBodyEmulatorCore",
    "NBodyEmulatorVelCore",
    "growth_factor",
    "hubble_rate",
    "growth_rate",
    "dlogD_dz",
    "dlogH_dz",
    "dlogH_dloga",
    "vel_norm",
    "acc_norm",
    "growth_d_approx",
    "conv3d_wino_packed",
    "conv3d_wino_pair_packed",
    "conv3d_wino43",
    "conv3d_wino43_packed",
    "conv3d_direct",
    "conv3d_direct_packed",
    "conv3_packed_stripe",
]
