"""Data-driven sample systems: the prescriptions of the JAX package's
``optiland_tpu/database/samples.json``, read in place by path (nothing of
that package is imported), built with the port's ``Optic``.

Counterpart of ``optiland_tpu/samples/registry.py``. ``build_sample(name)``
builds one system; ``SAMPLE_SPECS`` holds every prescription, and
``missing(name)`` says what the port lacks to build it, if anything. A
system that needs a module the port has not yet carried raises
NotImplementedError naming it: ray aiming (``set_ray_aiming``, for the
wide-angle and projection lenses that set it) and object-height fields
(UVProjectionLens).
"""

from __future__ import annotations

import json
import os

import numpy as np

from optiland_torch.materials import IdealMaterial
from optiland_torch.optic import Optic
from optiland_torch.physical_apertures import RadialAperture

SAMPLES_PATH = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "optiland_tpu", "database",
    "samples.json"))

with open(SAMPLES_PATH) as _fh:
    SAMPLE_SPECS: dict = json.load(_fh)


def _value(v):
    return {"inf": np.inf, "-inf": -np.inf}.get(v, v) if isinstance(v, str) \
        else v


def _material(spec):
    if isinstance(spec, str):
        return spec  # "mirror", "air", or a catalog name
    if "ideal_index" in spec:
        return IdealMaterial(spec["ideal_index"], spec.get("absorb", 0.0))
    if "abbe_index" in spec:
        raise NotImplementedError("Abbe-number materials are ported in a "
                                  "later slice")
    if "reference" in spec:
        return (spec["name"], spec["reference"])
    return spec["name"]


def missing(name: str):
    """What the port lacks to build sample ``name``, or None."""
    spec = SAMPLE_SPECS[name]
    if spec.get("ray_aiming"):
        return ("ray aiming (Optic.set_ray_aiming, the JAX package's "
                "core/aiming.py)")
    if spec["fields"]["type"] != "angle":
        return (f"{spec['fields']['type']!r} fields (the JAX package's "
                "raygen object-space launch)")
    return None


def build_sample(name: str) -> Optic:
    """Instantiate one sample system from its stored prescription. Raises
    NotImplementedError for a system that needs a module the port lacks
    (``missing``)."""
    lack = missing(name)
    if lack is not None:
        raise NotImplementedError(f"sample {name} needs {lack}, which is "
                                  "ported in a later slice")
    spec = SAMPLE_SPECS[name]
    o = Optic(name)
    for row in spec["surfaces"]:
        kwargs = dict(row)
        kwargs["radius"] = _value(kwargs.get("radius", np.inf))
        kwargs["thickness"] = _value(kwargs.get("thickness", 0.0))
        if "material" in kwargs:
            kwargs["material"] = _material(kwargs["material"])
        ap = kwargs.get("aperture")
        if isinstance(ap, dict) and "radial" in ap:
            kwargs["aperture"] = RadialAperture(
                r_max=float(_value(ap["radial"]["r_max"])),
                r_min=float(ap["radial"]["r_min"]))
        o.surfaces.add(**kwargs)
    ap = spec.get("aperture")
    if ap:
        o.set_aperture(ap["type"], ap["value"])
    fd = spec["fields"]
    o.fields.set_type(fd["type"])
    for f in fd["points"]:
        o.fields.add(x=f["x"], y=f["y"], vx=f.get("vx", 0.0),
                     vy=f.get("vy", 0.0))
    for w in spec["wavelengths"]:
        o.wavelengths.add(w["value"], is_primary=w["is_primary"])
    return o
