"""The model cores and the U-Net's size arithmetic (counterpart of the JAX
package's ``models``, with the same exports)."""

from .cores import (
    NBodyEmulatorCore,
    NBodyEmulatorVelCore,
    StyleNBodyEmulatorCore,
    StyleNBodyEmulatorVelCore,
)
from .unet import (
    input_margin,
    min_input_size,
    output_size,
    valid_input_size,
)

__all__ = [
    "NBodyEmulatorCore",
    "NBodyEmulatorVelCore",
    "StyleNBodyEmulatorCore",
    "StyleNBodyEmulatorVelCore",
    "input_margin",
    "output_size",
    "valid_input_size",
    "min_input_size",
]
