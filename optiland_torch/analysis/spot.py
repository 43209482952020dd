"""Spot metrics: functional, differentiable spot coordinates and RMS spot
size, and the ``SpotData`` record.

Counterpart of the functional part of ``optiland_tpu/analysis/spot.py``.
``rms_spot_size`` is the optimizer operand: with a concrete wavelength and
a bundle on a CUDA device, its trace runs on the fused kernels and its
gradient on their hand-derived adjoint. ``SpotDiagram`` is ported in a
later slice (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import numpy as np
import torch

from optiland_torch.core import raygen
from optiland_torch.core import trace as trace_core
from optiland_torch.core.system import System


def spot_coordinates(system: System, Hx, Hy, Px, Py, wavelength):
    """Image-plane (x, y, intensity) of a bundle. With a concrete Python
    wavelength on a CUDA device the trace runs on the fused kernels."""
    rays = raygen.generate_rays(system, Hx, Hy, Px, Py, wavelength)
    final, _ = trace_core.trace(system, rays, record=False,
                                wavelength=wavelength)
    return final.x, final.y, final.i


def rms_spot_size(system: System, Hx, Hy, Px, Py, wavelength):
    """RMS spot radius about the centroid; differentiable."""
    x, y, _ = spot_coordinates(system, Hx, Hy, Px, Py, wavelength)
    r2 = (x - torch.mean(x)) ** 2 + (y - torch.mean(y)) ** 2
    return torch.sqrt(torch.mean(r2))


class SpotData:
    """Spot data for one (field, wavelength): intersection coordinates."""

    def __init__(self, x, y, intensity):
        self.x = _numpy(x)
        self.y = _numpy(y)
        self.intensity = _numpy(intensity)

    @property
    def centroid(self):
        return float(np.mean(self.x)), float(np.mean(self.y))

    def rms_radius(self):
        cx, cy = self.centroid
        r2 = (self.x - cx) ** 2 + (self.y - cy) ** 2
        return float(np.sqrt(np.mean(r2)))

    def geometric_radius(self):
        cx, cy = self.centroid
        r = np.sqrt((self.x - cx) ** 2 + (self.y - cy) ** 2)
        return float(np.max(r))


def _numpy(v):
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    return np.asarray(v)
