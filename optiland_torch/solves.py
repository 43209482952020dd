"""Solves: constraints resolved by adjusting system parameters.

The port's copy of ``optiland_tpu/solves.py``'s ``QuickFocusSolve`` (the
solve ``Optic.image_solve`` runs); the other solves are not ported yet.
"""

from __future__ import annotations

import numpy as np

from optiland_torch.core.system import positions


class QuickFocusSolve:
    """Move the image plane to the axial position that minimizes the RMS
    spot of a hexapolar fan at the on-axis field."""

    def __init__(self, optic):
        self.optic = optic
        if len(optic.surfaces.surfaces) <= 2:
            raise ValueError("Cannot optimize an empty optical system")

    def optimal_focus_distance(self, Hx=0, Hy=0, wavelength=None, num_rays=5,
                               distribution="hexapolar"):
        """The mean over the rays of the z where each comes closest to the
        axis: z + t N with t = -(L x + M y) / (L^2 + M^2)."""
        if wavelength is None:
            wavelength = self.optic.primary_wavelength
        rays = self.optic.trace(Hx=Hx, Hy=Hy, wavelength=wavelength,
                                num_rays=num_rays, distribution=distribution)
        L, M, N, x, y, z = (getattr(rays, k).detach().cpu().numpy()
                            for k in ("L", "M", "N", "x", "y", "z"))
        A = L**2 + M**2
        B = L * x + M * y
        with np.errstate(divide="ignore", invalid="ignore"):
            t_opt = np.where(A != 0, -B / A, np.nan)
        return float(np.nanmean(z + t_opt * N))

    def apply(self):
        z_focus = self.optimal_focus_distance()
        surfs = self.optic.surfaces.surfaces
        pos = positions(self.optic.system.stack).detach().cpu().numpy()
        # the thickness before the image plane takes the shift
        surfs[-2].thickness = float(surfs[-2].thickness + (z_focus - pos[-1]))
        self.optic._invalidate()
