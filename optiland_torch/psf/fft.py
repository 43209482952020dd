"""Pupil sampling of the PSF analyses.

Counterpart of the sampling helpers of ``optiland_tpu/psf/fft.py``:
``calculate_grid_size`` and ``pupil_grid_coords``, in numpy. The FFT PSF
itself comes in a later slice.
"""

from __future__ import annotations

import numpy as np


def calculate_grid_size(num_rays: int) -> tuple[int, int]:
    """OpticStudio-style effective pupil sampling and FFT grid size."""
    effective = int(np.floor(32 * 2 ** ((np.log2(num_rays) - 5) / 2)))
    return effective, effective * 2


def pupil_grid_coords(num_rays: int):
    """Flattened square-grid pupil coordinates and the in-disk mask."""
    x = np.linspace(-1, 1, num_rays)
    x, y = np.meshgrid(x, x)
    x, y = x.ravel(), y.ravel()
    mask = x**2 + y**2 <= 1
    return x, y, mask
