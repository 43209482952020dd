"""The freeform singlets: ``bench.py``'s singlet frame for its
non-standard surfaces (``bench.py:131-143``, the nurbs and grid_sag
classes) with surface 1 a Cartesian freeform or an aux-bearing sag.

Surface 1 is the freeform, the stop, 6 mm of N-BK7; surface 2 has R = -60
mm and 30 mm to the image plane; EPD 10 mm, angle fields 0 and
``FIELD_Y`` degrees, 0.55 um. Surface 1 takes the golden parameter set of
each family (the JAX package's ``tests/test_geometries.py``), ``FAMILIES``:

  * "polynomial": R 50, k -0.5, the 3 x 3 table ``CMAT`` of x^i y^j;
  * "chebyshev": R 50, k -0.5, ``CMAT`` of T_i(x / 6) T_j(y / 7);
  * "toroidal": rotation radius 100, y-z radius 50, conic -0.5, the
    y-polynomial (1e-5 y^2, -1e-8 y^4);
  * "biconic": x radius 80, conic -0.2, y radius 50, conic -0.8;
  * "zernike": R 50, k -0.5, the fringe terms ``ZC`` over norm radius 8
    (the JAX package's ``tests/test_geometries.py``);
  * "forbes_qbfs": R 40, k -0.8, Qbfs terms {0: 1e-4, 1: -2e-5, 2: 3e-6,
    4: 1e-7} over norm radius 12 (its ``tests/test_adv_geometries.py``);
  * "forbes_q2d": R 40, k 0, the six Q2d terms ``Q2D`` over norm radius
    12 (the same file's ``q2d_lens``).

``ZC36`` is a 36-term fringe Zernike (the reference's default term
count) with small seeded coefficients: a coefficient table of NC_MAX
columns.

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
ZC = (0.001, -0.002, 0.0005, 0.0003, 0.0001, 0.0002)
ZC36 = tuple(float(v) for v in np.random.default_rng(36).normal(0, 2e-5, 36))
QBFS = {0: 1e-4, 1: -2e-5, 2: 3e-6, 4: 1e-7}
Q2D = {("a", 0, 0): 5e-5, ("a", 0, 1): -1e-5, ("a", 2, 0): 2e-5,
       ("b", 2, 0): -1e-5, ("a", 1, 1): 4e-6, ("b", 3, 1): 2e-6}
FAMILIES.update({
    "zernike": dict(surface_type="zernike", radius=50.0, conic=-0.5,
                    coefficients=ZC, norm_radius=8.0, zernike_type="fringe"),
    "forbes_qbfs": dict(surface_type="forbes_qbfs", radius=40.0, conic=-0.8,
                        radial_terms=QBFS, norm_radius=12.0),
    "forbes_q2d": dict(surface_type="forbes_q2d", radius=40.0, conic=0.0,
                       freeform_coeffs=Q2D, norm_radius=12.0),
})
# the aux-bearing families (kernel K6b's last three)
AUX_FAMILIES = ("zernike", "forbes_qbfs", "forbes_q2d")
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


def deep_aux(optic=None):
    """A 20-surface system: a Zernike surface (the stop) and a Q2d one
    (radius -300 mm) of the families' golden sets, then nine plano-convex
    N-BK7 plates; EPD 10 mm, fields 0 and 1 deg, 0.55 um. Past 16 surfaces:
    the kernels' deep_free build."""
    if optic is None:
        from optiland_torch.optic import Optic as optic
    o = optic()
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    o.surfaces.add(**FAMILIES["zernike"], thickness=1.0, material="N-BK7",
                   is_stop=True)
    o.surfaces.add(**{**FAMILIES["forbes_q2d"], "radius": -300.0},
                   thickness=2.0)
    for k in range(1, 9):
        o.surfaces.add(radius=np.inf, thickness=1.0, material="N-BK7")
        o.surfaces.add(radius=-200.0 * (k + 1), thickness=2.0)
    o.surfaces.add()
    o.set_aperture("EPD", 10.0)
    o.fields.set_type("angle")
    o.fields.add(y=0.0)
    o.fields.add(y=1.0)
    o.wavelengths.add(WAVELENGTH, is_primary=True)
    return o


def coated_freeform(family="polynomial", polarization="H", optic=None):
    """The singlet with Fresnel coatings on both lens surfaces, in
    ``polarization``."""
    o = freeform_singlet(family, optic)
    for k in (1, 2):
        o.surfaces.surfaces[k].coating = "fresnel"
    o.set_polarization(polarization)
    return o
