"""Point spread functions: the scalar and vectorial Huygens-Fresnel PSFs and
the pupil sampling they share with the FFT PSF. The FFT, MMDFT and
vectorial FFT PSFs come in later slices."""

from optiland_torch.psf.fft import calculate_grid_size, pupil_grid_coords
from optiland_torch.psf.huygens_fresnel import (
    HuygensPSF,
    ScalarHuygensPSF,
    huygens_field,
    huygens_psf,
    huygens_psf_from_data,
    vectorial_huygens_psf_from_data,
    working_FNO,
)
from optiland_torch.psf.vectorial import VectorialFFTPSF, VectorialHuygensPSF

__all__ = [
    "HuygensPSF",
    "ScalarHuygensPSF",
    "VectorialFFTPSF",
    "VectorialHuygensPSF",
    "calculate_grid_size",
    "huygens_field",
    "huygens_psf",
    "huygens_psf_from_data",
    "pupil_grid_coords",
    "vectorial_huygens_psf_from_data",
    "working_FNO",
]
