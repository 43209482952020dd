"""Point spread functions: the scalar Huygens-Fresnel PSF and the pupil
sampling it shares with the FFT PSF. The FFT, MMDFT and vectorial PSFs come
in later slices."""

from optiland_torch.psf.fft import calculate_grid_size, pupil_grid_coords
from optiland_torch.psf.huygens_fresnel import (
    HuygensPSF,
    ScalarHuygensPSF,
    huygens_field,
    huygens_psf,
    huygens_psf_from_data,
    working_FNO,
)

__all__ = [
    "HuygensPSF",
    "ScalarHuygensPSF",
    "calculate_grid_size",
    "huygens_field",
    "huygens_psf",
    "huygens_psf_from_data",
    "pupil_grid_coords",
    "working_FNO",
]
