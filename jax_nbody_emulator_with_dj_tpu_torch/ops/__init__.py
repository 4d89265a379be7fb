"""Ops of the PyTorch port: packing, the conv routes and their CUDA kernels.

The conv routes' public functions are re-exported here.  Each ``*_cuda``
wrapper runs its hand-written kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor.
"""

from .direct_conv import conv3_packed_taps
from .direct_conv_cuda import conv3_packed_stripe, conv3d_direct, conv3d_direct_packed
from .winograd import (
    conv3_packed_wino,
    conv3_packed_wino43,
    conv3_packed_wino_pair,
    transform_packed_w3,
    transform_packed_w3_mixed,
)
from .winograd43_cuda import conv3d_wino43, conv3d_wino43_packed
from .winograd_cuda import conv3d_wino_packed, conv3d_wino_pair_packed

__all__ = [
    "conv3_packed_taps",
    "conv3_packed_stripe",
    "conv3d_direct",
    "conv3d_direct_packed",
    "conv3_packed_wino",
    "conv3_packed_wino43",
    "conv3_packed_wino_pair",
    "transform_packed_w3",
    "transform_packed_w3_mixed",
    "conv3d_wino43",
    "conv3d_wino43_packed",
    "conv3d_wino_packed",
    "conv3d_wino_pair_packed",
]
