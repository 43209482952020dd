"""Polarized sample systems.

``coated_doublet`` is examples/08's Fresnel-coated N-BK7 singlet (R 50 /
-50, 5 mm thick, 45 mm to the image, EPD 20, fields 0 and 5 degrees,
0.55 um) with any coating on its two lens surfaces; its image plane is
uncoated. ``polarized_system`` gives that singlet, or a two-mirror system,
for one coat kind of ``KINDS`` (the polarized kernels' coat branches).
``bench_polarized`` gives the polarized step classes of ``bench.py``: the
same singlet with the field 0 alone, in H polarization. ``coated_plates``
stacks Fresnel-coated N-BK7 plates, more surfaces than the kernels' stock
build holds.

Every builder takes ``classes``, the (Optic, coatings module,
IdealMaterial, ThinFilmStack) it builds with: the port's by default.
Another package with the same API builds the same prescription from them,
so one definition serves the port and a reference it is compared with.
"""

from __future__ import annotations

import numpy as np

# coat kinds of polarized_system: "polarizer" and "retarder" put both axis
# coatings on the singlet, in either order; "tmm" has a simple coating on
# its second surface; "mirror" a Fresnel and a simple coating
KINDS = ("fresnel", "none", "simple", "polarizer", "retarder", "tmm",
         "mirror")
BENCH_CLASSES = ("polarized", "polarized_axis", "polarized_tmm")


def _classes(classes):
    if classes is not None:
        return classes
    from optiland_torch import coatings
    from optiland_torch.materials import IdealMaterial
    from optiland_torch.optic import Optic
    from optiland_torch.thin_film import ThinFilmStack

    return Optic, coatings, IdealMaterial, ThinFilmStack


def ar_coating(n_layers=2, substrate=1.52, absorbing=False, classes=None):
    """A dielectric AR stack on ``substrate``: a quarter wave of n = 1.38
    at 0.55 um, then (``n_layers`` 2) 80 nm of n = 2.35; with ``absorbing``
    one 100 um layer of n = 2.35 + 0.2 i instead."""
    _, coatings, Ideal, Stack = _classes(classes)
    st = Stack(Ideal(1.0), Ideal(substrate), reference_wl_um=0.55)
    if absorbing:
        st.add_layer(Ideal(2.35, 0.2), 100.0)
        return coatings.ThinFilmCoating(st)
    st.add_layer_qwot(Ideal(1.38))
    if n_layers > 1:
        st.add_layer(Ideal(2.35), 0.08)
    return coatings.ThinFilmCoating(st)


def coated_doublet(polarization="H", coat="fresnel", coat2=None, epd=20.0,
                   fields=(0.0, 5.0), classes=None):
    """examples/08's coated singlet; ``coat2`` None repeats ``coat`` on the
    second surface; ``polarization`` None leaves the optic unpolarized."""
    Optic = _classes(classes)[0]
    o = Optic()
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    kw = {"coating": coat} if coat else {}
    kw2 = {"coating": coat2 if coat2 is not None else coat} if (
        coat or coat2) else {}
    o.surfaces.add(index=1, radius=50.0, thickness=5.0, material="N-BK7",
                   is_stop=True, **kw)
    o.surfaces.add(index=2, radius=-50.0, thickness=45.0, **kw2)
    o.surfaces.add(index=3)
    o.set_aperture("EPD", epd)
    o.fields.set_type("angle")
    for y in fields:
        o.fields.add(y=y)
    o.wavelengths.add(0.55, is_primary=True)
    if polarization:
        o.set_polarization(polarization)
    return o


def coated_mirror(polarization="H", coated=True, classes=None):
    """A two-mirror system (a parabola of R -120, then R -40); ``coated``
    puts a Fresnel coating on the first mirror and a simple one on the
    second."""
    Optic, coatings, _, _ = _classes(classes)
    kw1 = {"coating": "fresnel"} if coated else {}
    kw2 = {"coating": coatings.SimpleCoating(0.1, 0.9)} if coated else {}
    o = Optic()
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    o.surfaces.add(index=1, radius=-120.0, thickness=-40.0, is_stop=True,
                   material="mirror", conic=-1.0, **kw1)
    o.surfaces.add(index=2, radius=-40.0, thickness=50.0, material="mirror",
                   **kw2)
    o.surfaces.add(index=3)
    o.set_aperture("EPD", 30.0)
    o.fields.set_type("angle")
    o.fields.add(y=0)
    o.wavelengths.add(0.55, is_primary=True)
    o.set_polarization(polarization)
    return o


def polarized_system(kind, polarization="H", classes=None):
    """The optic of one coat kind of ``KINDS``."""
    cl = _classes(classes)
    coatings = cl[1]
    if kind == "mirror":
        return coated_mirror(polarization, classes=cl)
    coats = {
        "fresnel": ("fresnel", None),
        "none": (None, None),
        "simple": (coatings.SimpleCoating(0.9, 0.05),
                   coatings.SimpleCoating(0.8, 0.1)),
        "polarizer": (coatings.PolarizerCoating(axis=(1, 0.3, 0)),
                      coatings.RetarderCoating(np.pi / 3, axis=(0.2, 1, 0))),
        "retarder": (coatings.RetarderCoating(np.pi / 2, axis=(1, 0.3, 0)),
                     coatings.PolarizerCoating(axis=(0.2, 1, 0))),
        "tmm": (ar_coating(classes=cl), coatings.SimpleCoating(0.95, 0.04)),
    }[kind]
    return coated_doublet(polarization, *coats, classes=cl)


def bench_polarized(name="polarized", classes=None):
    """One of bench.py's polarized classes (``BENCH_CLASSES``): the singlet
    at EPD 20 with the field 0 alone, H polarization, and Fresnel coatings
    ("polarized"), a polarizer then a quarter-wave retarder
    ("polarized_axis"), or a two-layer AR stack on both surfaces
    ("polarized_tmm")."""
    cl = _classes(classes)
    coatings = cl[1]
    c1, c2 = {
        "polarized": ("fresnel", None),
        "polarized_axis": (coatings.PolarizerCoating(axis=(1, 0.3, 0)),
                           coatings.RetarderCoating(np.pi / 2,
                                                    axis=(0.2, 1, 0))),
        "polarized_tmm": (ar_coating(classes=cl), ar_coating(classes=cl)),
    }[name]
    return coated_doublet("H", c1, c2, fields=(0.0,), classes=cl)


def coated_plates(polarization="H", n=8, classes=None):
    """``n`` Fresnel-coated plates of N-BK7 (a plane face, 1 mm of glass,
    then a face of R -200 k for plate k, and 2 mm of air): 2 n + 2
    surfaces, EPD 10, the field 0, 0.55 um; 8 plates take the kernels' deep
    build."""
    Optic = _classes(classes)[0]
    o = Optic()
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    for k in range(n):
        o.surfaces.add(radius=np.inf, thickness=1.0, material="N-BK7",
                       is_stop=k == 0, coating="fresnel")
        o.surfaces.add(radius=-200.0 * (k + 1), thickness=2.0,
                       coating="fresnel")
    o.surfaces.add()
    o.set_aperture(aperture_type="EPD", value=10)
    o.fields.add(y=0)
    o.wavelengths.add(value=0.55, is_primary=True)
    o.set_polarization(polarization)
    return o
