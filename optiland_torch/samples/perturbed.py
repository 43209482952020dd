"""Perturbed variants of the sample systems: tilted surfaces and other
dispersion formulas.

``toleranced_cooke`` is the Cooke triplet with every lens surface tilted by
0.5-2 mrad about each axis and decentred by 0.01-0.05 mm (``TOLERANCES``),
as a tolerance run perturbs a design, through the builder's own ``rx``/
``dx`` keywords: the JAX suite's tilted Cooke triplet
(``tests/test_pallas_trace.py::test_pallas_tilted_matches_xla``: one
surface tilted by rx, one decentred by dy) widened to every lens surface.
``tilted_singlet`` is ``bench.py``'s polarized singlet
(``samples.polarized.bench_polarized``) with surface 1 tilted and
decentred (``SINGLET_TILT``). ``zoo_system`` gives the Cooke triplet's
system with each medium's dispersion replaced by a catalog row of another
formula code (``ZOO_CODES``), so that with the Cooke glasses' codes 0, 2
and 3 a trace evaluates every code the polychromatic kernels take.
``tilted_asphere`` is ``bench.py``'s class of that name: the aspheric
singlet with its asphere tilted by 1 degree about x; ``odd_asphere`` the
aspheric singlet with its surface an ODD_ASPHERE (``ODD_COEFFS``);
``coated_asphere`` the singlet with Fresnel coatings, polarized.

The builders take the classes they build with (the port's by default), so
another package with the same API builds the same prescription from them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optiland_torch.materials import dispersion
from optiland_torch.materials.catalog import get_catalog
from optiland_torch.samples import polarized

# surface: (rx, ry, rz) in radians, (dx, dy) in mm
TOLERANCES = {
    1: (1.0e-3, -0.5e-3, 2.0e-3, 0.02, -0.01),
    2: (-1.5e-3, 0.8e-3, -0.6e-3, -0.03, 0.04),
    3: (0.7e-3, 1.2e-3, 1.0e-3, 0.05, 0.02),
    4: (-0.5e-3, -1.8e-3, 0.9e-3, -0.01, -0.05),
    5: (2.0e-3, 0.6e-3, -1.4e-3, 0.04, 0.03),
    6: (-0.9e-3, 1.5e-3, 0.5e-3, -0.02, -0.03),
}
SINGLET_TILT = (2.0e-3, -1.0e-3, 1.5e-3, 0.03, -0.02)

# the medium after each surface of the Cooke triplet in zoo_system: object
# space a gas (6); glasses 1, 4, 9; gaps 11, 5, 8; image space 7. The
# catalog holds no Buchdahl (11) row: ZOO_BUCHDAHL stands in.
ZOO_CODES = (6, 1, 11, 4, 5, 9, 8, 7)
ZOO_BUCHDAHL = (1.0003, -0.001, 0.0005, -0.0002, 0.5876, 2.5)


def perturb(lens, table):
    """Tilt and decentre the surfaces of ``lens`` by ``table`` (surface ->
    (rx, ry, rz, dx, dy)); returns the lens."""
    for s, (rx, ry, rz, dx, dy) in table.items():
        surf = lens.surfaces.surfaces[s]
        surf.rx, surf.ry, surf.rz, surf.dx, surf.dy = rx, ry, rz, dx, dy
    lens._invalidate()
    return lens


def toleranced_cooke(cooke=None):
    """The Cooke triplet (``cooke``: its class, the port's by default) with
    every lens surface tilted and decentred by ``TOLERANCES``."""
    if cooke is None:
        from optiland_torch.samples.objectives import CookeTriplet as cooke
    return perturb(cooke(), TOLERANCES)


def tilted_singlet(zero=False, classes=None):
    """``bench.py``'s polarized singlet with surface 1 tilted and decentred
    by ``SINGLET_TILT`` (``zero``: by zero angles and offsets); ``classes``
    as ``samples.polarized``'s builders take them."""
    lens = polarized.bench_polarized("polarized", classes=classes)
    return perturb(lens, {1: (0.0,) * 5 if zero else SINGLET_TILT})


# ODD_ASPHERE variant of the aspheric singlet: the even surface's r^4 and
# r^6 terms as odd-power coefficients (C_i of r^(i+1)), with r^3 and r^5
# terms added and no cone (r^1) term
ODD_COEFFS = (0.0, -2.248851e-4, 2.0e-6, -4.690412e-6, 1.0e-8, -6.404376e-8)


def _singlet(cls):
    if cls is None:
        from optiland_torch.samples.objectives import AsphericSinglet as cls
    return cls()


def tilted_asphere(singlet=None):
    """``bench.py``'s tilted_asphere: the aspheric singlet (``singlet``:
    its class, the port's by default) with surface 1 tilted by 1 degree
    about x."""
    lens = _singlet(singlet)
    lens.surfaces.surfaces[1].rx = float(np.radians(1.0))
    lens._invalidate()
    return lens


def odd_asphere(singlet=None):
    """The aspheric singlet with its asphere an ODD_ASPHERE of
    ``ODD_COEFFS``."""
    lens = _singlet(singlet)
    surf = lens.surfaces.surfaces[1]
    surf.surface_type = "odd_asphere"
    surf.coefficients = ODD_COEFFS
    lens._invalidate()
    return lens


def coated_asphere(polarization="H", singlet=None):
    """The aspheric singlet with Fresnel coatings on both lens surfaces, in
    ``polarization``."""
    lens = _singlet(singlet)
    for k in (1, 2):
        lens.surfaces.surfaces[k].coating = "fresnel"
    lens.set_polarization(polarization)
    return lens


def catalog_row(code, wavelengths, n_range=(1.0, 3.5)):
    """The zero-padded coefficients of the first catalog row of formula
    ``code`` whose index lies inside ``n_range`` at every one of
    ``wavelengths`` (um); ``(-inf, inf)`` takes the first finite one."""
    a = get_catalog().arrays
    off, co = a["coeffs_off"], a["coeffs"]
    w = torch.tensor(wavelengths, dtype=torch.float64)
    for i in np.where(a["formula_code"] == code)[0]:
        c = dispersion.pad_coefficients(co[off[i]:off[i + 1]])
        n = dispersion.n_formula_scalar_terms(code, torch.tensor(c).unbind(),
                                              w)
        if bool(((n > n_range[0]) & (n < n_range[1])).all()):
            return c
    raise ValueError(f"no catalog row of formula code {code} has an index "
                     f"in {n_range} over {wavelengths}")


def zoo_system(system, wavelengths=(0.48, 0.55, 0.65)):
    """The Cooke triplet's ``system`` with the medium after surface s given
    the formula ``ZOO_CODES[s]`` and a catalog row of it that is physical
    over ``wavelengths``."""
    rows = [dispersion.pad_coefficients(ZOO_BUCHDAHL)
            if code == dispersion.BUCHDAHL else catalog_row(code, wavelengths)
            for code in ZOO_CODES]
    like = system.stack.mat_coeffs
    return system.replace(
        stack=system.stack.replace(mat_coeffs=torch.as_tensor(
            np.array(rows), dtype=like.dtype, device=like.device)),
        cfg=dataclasses.replace(system.cfg, mat_formulas=ZOO_CODES))
