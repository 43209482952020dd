"""Vectorial PSF analyses of polarized systems.

Counterpart of ``optiland_tpu/psf/vectorial.py``. ``VectorialHuygensPSF``
sums the Huygens-Fresnel intensities of the three Cartesian components of
the exit E-field per incoherent polarization state. ``VectorialFFTPSF``
waits for the FFT PSF and raises.
"""

from __future__ import annotations

from optiland_torch.psf.huygens_fresnel import ScalarHuygensPSF


class VectorialHuygensPSF(ScalarHuygensPSF):
    """Vectorial Huygens PSF."""

    _vectorial = True


class VectorialFFTPSF:
    """Vectorial FFT PSF: comes with the FFT PSF (``FFTPSF``)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "VectorialFFTPSF is ported with the FFT PSF (psf/fft.py FFTPSF) "
            "in a later slice"
        )
