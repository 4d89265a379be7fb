"""Single-device science toolkit of the PyTorch port.

Counterpart of ``jax_nbody_emulator_with_dj_tpu/science``: power spectra
(``powerspec``), the EH98 linear P(k) (``linear_pk``), Gaussian random fields
(``grf``), 1LPT (``lpt``), mass assignment (``mas``), field resizing
(``resize``), Minkowski functionals (``minkowski``), the bispectrum
(``bispectrum``), halofit (``halofit``) and FoF halos with mass functions
(``halos``).  Field functions run with ``torch.fft``, ``index_add_`` and
elementwise ops on their input's device; the ones that make a field from
nothing (``gaussian_random_field``, ``white_noise_field``) default to the
CUDA card.  Tables, halofit and the halo finder are host numpy.
"""

from .bispectrum import reduced_bispectrum
from .field_sharded import (
    deconvolve_mas_sharded,
    deposit_displacement_sharded,
    displacement_to_density_sharded,
    gaussian_random_field_sharded,
    zeldovich_displacement_sharded,
)
from .grf import gaussian_random_field, white_noise_field
from .halofit import halofit_pk
from .halos import (
    empirical_hmf,
    friends_of_friends,
    friends_of_friends_slabbed,
    particle_mass_msun_h,
    positions_from_displacement,
    tinker08_hmf,
)
from .linear_pk import eisenstein_hu_pk, normalize_sigma8, sigma_r
from .lpt import displacement_to_density, zeldovich_displacement
from .mas import deconvolve_mas, deposit
from .minkowski import minkowski_functionals
from .powerspec import cross_power, power_spectrum, summary_metrics, transfer_and_correlation
from .powerspec_sharded import (
    cross_power_sharded,
    power_spectrum_sharded,
    summary_metrics_sharded,
    transfer_and_correlation_sharded,
)
from .resize import (
    downsample_average,
    gaussian_smooth,
    resize_density_grid,
    upsample_fourier,
    upsample_linear,
    upsample_modes,
)
from .resize_sharded import (
    downsample_average_sharded,
    gaussian_smooth_sharded,
    upsample_fourier_sharded,
    upsample_modes_sharded,
)
from .stats_sharded import minkowski_functionals_sharded, reduced_bispectrum_sharded

__all__ = [
    "power_spectrum",
    "cross_power",
    "transfer_and_correlation",
    "summary_metrics",
    "power_spectrum_sharded",
    "cross_power_sharded",
    "transfer_and_correlation_sharded",
    "summary_metrics_sharded",
    "gaussian_random_field_sharded",
    "zeldovich_displacement_sharded",
    "deposit_displacement_sharded",
    "displacement_to_density_sharded",
    "deconvolve_mas_sharded",
    "minkowski_functionals_sharded",
    "reduced_bispectrum_sharded",
    "upsample_modes_sharded",
    "upsample_fourier_sharded",
    "downsample_average_sharded",
    "gaussian_smooth_sharded",
    "eisenstein_hu_pk",
    "sigma_r",
    "normalize_sigma8",
    "gaussian_random_field",
    "white_noise_field",
    "zeldovich_displacement",
    "displacement_to_density",
    "deposit",
    "deconvolve_mas",
    "minkowski_functionals",
    "reduced_bispectrum",
    "upsample_modes",
    "upsample_fourier",
    "upsample_linear",
    "downsample_average",
    "gaussian_smooth",
    "resize_density_grid",
    "halofit_pk",
    "friends_of_friends",
    "friends_of_friends_slabbed",
    "positions_from_displacement",
    "empirical_hmf",
    "tinker08_hmf",
    "particle_mass_msun_h",
]
