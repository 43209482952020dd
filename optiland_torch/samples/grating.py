"""The grating systems: the three golden grating lenses of the JAX package's
``tests/test_adv_geometries.py`` (traced there against the original
Optiland), a tilted variant, and a coated grating for the polarized trace.

Each has EPD 10 mm, angle fields 0 and 3 degrees and 0.55 um:

  * ``plane_grating``: a biconvex N-BK7 singlet (R 30 / -30, 5 mm) as the
    stop, then a plane transmission grating of period 10 um, groove angle
    0.3 rad and order 1, 20 mm before the image plane;
  * ``curved_grating``: a grating on a conic substrate (R 100, k -0.5) of
    N-BK7 as the stop, period 25 um, groove angle 0.1 rad, order -1, then a
    plane surface and 30 mm to the image;
  * ``refl_grating``: a plane reflective grating (a mirror) of period 5 um,
    groove angle 0, order 1, as the stop, and the image 30 mm back;
  * ``tilted_grating``: ``plane_grating`` with the grating tilted by
    ``TILT_RX`` (5 degrees) about x, the usual spectrograph mount;
  * ``coated_grating``: ``plane_grating`` with Fresnel coatings on the
    singlet's surfaces, polarized.

The builders take the class they build with (the port's ``Optic`` by
default), so another package with the same API builds the same
prescription from it.
"""

from __future__ import annotations

import numpy as np

TILT_RX = float(np.radians(5.0))
WAVELENGTH = 0.55


def _optic(optic):
    if optic is None:
        from optiland_torch.optic import Optic as optic
    return optic()


def _common(o):
    o.set_aperture("EPD", 10.0)
    o.fields.set_type("angle")
    o.fields.add(y=0)
    o.fields.add(y=3)
    o.wavelengths.add(WAVELENGTH, is_primary=True)
    return o


def plane_grating(optic=None):
    o = _optic(optic)
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    o.surfaces.add(index=1, radius=30.0, thickness=5.0, material="N-BK7",
                   is_stop=True)
    o.surfaces.add(index=2, radius=-30.0, thickness=5.0)
    o.surfaces.add(index=3, surface_type="grating", thickness=20.0,
                   grating_order=1, grating_period=10.0,
                   groove_orientation_angle=0.3)
    o.surfaces.add(index=4)
    return _common(o)


def curved_grating(optic=None):
    o = _optic(optic)
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    o.surfaces.add(index=1, surface_type="grating", radius=100.0, conic=-0.5,
                   thickness=10.0, material="N-BK7", is_stop=True,
                   grating_order=-1, grating_period=25.0,
                   groove_orientation_angle=0.1)
    o.surfaces.add(index=2, radius=np.inf, thickness=30.0)
    o.surfaces.add(index=3)
    return _common(o)


def refl_grating(optic=None):
    o = _optic(optic)
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    o.surfaces.add(index=1, surface_type="grating", radius=np.inf,
                   thickness=-30.0, material="mirror", is_stop=True,
                   grating_order=1, grating_period=5.0,
                   groove_orientation_angle=0.0)
    o.surfaces.add(index=2)
    return _common(o)


def tilted_grating(optic=None):
    o = plane_grating(optic)
    o.surfaces.surfaces[3].rx = TILT_RX
    o._invalidate()
    return o


def coated_grating(polarization="H", optic=None):
    o = plane_grating(optic)
    for k in (1, 2):
        o.surfaces.surfaces[k].coating = "fresnel"
    o.set_polarization(polarization)
    return o


BUILDERS = {"plane_grating": plane_grating, "curved_grating": curved_grating,
            "refl_grating": refl_grating, "tilted_grating": tilted_grating}
NAMES = tuple(BUILDERS)
