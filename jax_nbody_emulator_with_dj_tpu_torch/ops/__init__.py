"""Ops of the PyTorch port: the convs, style modulation, packing, the conv
routes and their CUDA kernels.

The JAX package's ``ops`` exports (the convs and the style functions) and
the conv routes' public functions are re-exported here.  Each ``*_cuda``
wrapper runs its hand-written kernel on a CUDA tensor and its plain PyTorch
version on a CPU tensor.
"""

from .conv3d import conv3d, conv3d_up, leaky_relu
from .direct_conv import conv3_packed_taps
from .direct_conv_cuda import conv3_packed_stripe, conv3d_direct, conv3d_direct_packed
from .style import (
    modulated_style_weight,
    premodulate_layer,
    style_modulation,
    style_vector,
)
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
    "conv3d",
    "conv3d_up",
    "leaky_relu",
    "style_vector",
    "style_modulation",
    "modulated_style_weight",
    "premodulate_layer",
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
