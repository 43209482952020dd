"""The NURBS systems: the two golden NURBS lenses of the JAX package's
``tests/test_adv_geometries.py`` (traced there against the original
Optiland, ``tests/goldens/nurbs.npz``) and the B-spline paraboloid singlet
of its kernel tests, built from their formulas (no data file), with a
tilted and a coated variant.

Each is a NURBS front surface of N-BK7 (6 mm) as the stop, a conic back
surface R -60 and 30 mm to the image plane, at 0.55 um with angle fields 0
and 3 degrees:

  * ``rational_nurbs``: the golden explicit net, 7 x 7 control points on
    [-7, 7]^2 with z = r^2 / 160 + 1e-4 x y, weight 1.2 at the centre
    (1 elsewhere), degree 3 both ways, clamped uniform knots; EPD 10 mm;
  * ``fitted_nurbs``: the golden conic fit, R 50, k -0.5, normalization 8
    mm, ``n_points`` 7 both ways (``core/nurbs.build_nurbs_def``, The NURBS
    Book A9.7); EPD 10 mm;
  * ``bspline_nurbs``: the kernel tests' B-spline paraboloid, ``nn`` x
    ``nn`` points (5 by default) on [-6, 6]^2 with z = r^2 / 180, unit
    weights, degree 3 (a Bezier patch at nn = 4); EPD 8 mm, field 0 only;
  * ``tilted_nurbs``: ``rational_nurbs`` with the NURBS surface tilted by
    ``TILT_RX`` (3 degrees) about x;
  * ``coated_nurbs``: ``rational_nurbs`` with Fresnel coatings on both
    lens surfaces, polarized.

The builders take the class they build with (the port's ``Optic`` by
default), so another package with the same API builds the same
prescription from it.
"""

from __future__ import annotations

import numpy as np

TILT_RX = float(np.radians(3.0))
WAVELENGTH = 0.55


def _optic(optic):
    if optic is None:
        from optiland_torch.optic import Optic as optic
    return optic()


def rational_net():
    """(P, W, knots) of the golden rational net."""
    n, deg = 7, 3
    xs = np.linspace(-7, 7, n)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    Z = (X**2 + Y**2) / (2 * 80.0) + 1e-4 * X * Y
    P = np.stack([X, Y, Z], axis=0)
    W = np.ones((n, n))
    W[3, 3] = 1.2
    kn = np.concatenate([np.zeros(deg), np.linspace(0, 1, n - deg + 1),
                         np.ones(deg)])
    return P, W, kn


def _singlet(o, epd=10.0, fields=(0.0, 3.0), **front):
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    o.surfaces.add(index=1, surface_type="nurbs", thickness=6.0,
                   material="N-BK7", is_stop=True, **front)
    o.surfaces.add(index=2, radius=-60.0, thickness=30.0)
    o.surfaces.add(index=3)
    o.set_aperture("EPD", epd)
    o.fields.set_type("angle")
    for y in fields:
        o.fields.add(y=y)
    o.wavelengths.add(WAVELENGTH, is_primary=True)
    return o


def rational_nurbs(optic=None):
    P, W, kn = rational_net()
    return _singlet(_optic(optic), control_points=P.tolist(),
                    weights=W.tolist(), u_degree=3, v_degree=3,
                    u_knots=list(kn), v_knots=list(kn))


def fitted_nurbs(optic=None):
    return _singlet(_optic(optic), radius=50.0, conic=-0.5,
                    nurbs_norm_x=8.0, nurbs_norm_y=8.0, n_points_u=7,
                    n_points_v=7)


def bspline_nurbs(optic=None, nn=5):
    xs = np.linspace(-6, 6, nn)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    P = np.stack([X, Y, (X**2 + Y**2) / (2 * 90.0)], axis=0)
    return _singlet(_optic(optic), epd=8.0, fields=(0.0,),
                    control_points=P.tolist(),
                    weights=np.ones((nn, nn)).tolist(), u_degree=3,
                    v_degree=3)


def tilted_nurbs(optic=None):
    o = rational_nurbs(optic)
    o.surfaces.surfaces[1].rx = TILT_RX
    o._invalidate()
    return o


def coated_nurbs(polarization="H", optic=None):
    o = rational_nurbs(optic)
    for k in (1, 2):
        o.surfaces.surfaces[k].coating = "fresnel"
    o.set_polarization(polarization)
    return o


BUILDERS = {"rational_nurbs": rational_nurbs, "fitted_nurbs": fitted_nurbs,
            "bspline_nurbs": bspline_nurbs}
NAMES = tuple(BUILDERS)
