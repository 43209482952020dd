"""The freeform singlets: ``bench.py``'s singlet frame for its
non-standard surfaces (``bench.py:131-143``, the nurbs and grid_sag
classes) with surface 1 a Cartesian freeform.

Surface 1 is the freeform, the stop, 6 mm of N-BK7; surface 2 has R = -60
mm and 30 mm to the image plane; EPD 10 mm, angle fields 0 and
``FIELD_Y`` degrees, 0.55 um. Surface 1 takes the golden parameter set of
each family (the JAX package's ``tests/test_geometries.py``), ``FAMILIES``:

  * "polynomial": R 50, k -0.5, the 3 x 3 table ``CMAT`` of x^i y^j;
  * "chebyshev": R 50, k -0.5, ``CMAT`` of T_i(x / 6) T_j(y / 7);
  * "toroidal": rotation radius 100, y-z radius 50, conic -0.5, the
    y-polynomial (1e-5 y^2, -1e-8 y^4);
  * "biconic": x radius 80, conic -0.2, y radius 50, conic -0.8.

``CMAT5`` is ``CMAT`` widened to a 5 x 5 table by x^4 and y^4 terms. The
merit and field steps run at ``H`` = (Hx, Hy) = (0.3, 0.7), off both
axes. ``freeform_singlet(tilted=True)`` tilts surface 1 by 1 degree about
x, as bench's tilted_asphere does; ``coated_freeform`` puts Fresnel
coatings on both lens surfaces and polarizes the light.

The builders take the class they build with (the port's ``Optic`` by
default), so another package with the same API builds the same
prescription from it.
"""

from __future__ import annotations

import numpy as np

CMAT = ((0.0, 1e-4, -1e-6), (2e-4, 1e-5, 0.0), (1e-6, 0.0, 1e-8))
CMAT5 = (
    (0.0, 1e-4, -1e-6, 0.0, -1e-7),
    (2e-4, 1e-5, 0.0, 0.0, 0.0),
    (1e-6, 0.0, 1e-8, 0.0, 0.0),
    (0.0, 0.0, 0.0, 0.0, 0.0),
    (2e-7, 0.0, 0.0, 0.0, 0.0),
)

FAMILIES = {
    "polynomial": dict(surface_type="polynomial", radius=50.0, conic=-0.5,
                       coefficients=CMAT),
    "chebyshev": dict(surface_type="chebyshev", radius=50.0, conic=-0.5,
                      coefficients=CMAT, norm_x=6.0, norm_y=7.0),
    "toroidal": dict(surface_type="toroidal", radius_x=100.0,
                     radius_y=50.0, conic=-0.5,
                     toroidal_coeffs_poly_y=(1e-5, -1e-8)),
    "biconic": dict(surface_type="biconic", radius_x=80.0, conic_x=-0.2,
                    radius_y=50.0, conic_y=-0.8),
}
FIELD_Y = 5.0  # degrees, the second field
H = (0.3, 0.7)  # the merit and field steps' normalized field
TILT_RX = float(np.radians(1.0))
WAVELENGTH = 0.55


def freeform_singlet(family="polynomial", optic=None, tilted=False,
                     **surface):
    """The singlet with surface 1 of ``family`` (``optic``: the class to
    build with, the port's ``Optic`` by default); ``surface`` overrides
    the family's keyword arguments (e.g. ``coefficients=CMAT5``)."""
    if optic is None:
        from optiland_torch.optic import Optic as optic
    o = optic()
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    o.surfaces.add(index=1, thickness=6.0, material="N-BK7", is_stop=True,
                   **{**FAMILIES[family], **surface})
    o.surfaces.add(index=2, radius=-60.0, thickness=30.0)
    o.surfaces.add(index=3)
    o.set_aperture("EPD", 10.0)
    o.fields.set_type("angle")
    o.fields.add(y=0.0)
    o.fields.add(y=FIELD_Y)
    o.wavelengths.add(WAVELENGTH, is_primary=True)
    if tilted:
        o.surfaces.surfaces[1].rx = TILT_RX
        o._invalidate()
    return o


def coated_freeform(family="polynomial", polarization="H", optic=None):
    """The singlet with Fresnel coatings on both lens surfaces, in
    ``polarization``."""
    o = freeform_singlet(family, optic)
    for k in (1, 2):
        o.surfaces.surfaces[k].coating = "fresnel"
    o.set_polarization(polarization)
    return o
