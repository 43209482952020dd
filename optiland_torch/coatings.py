"""Surface coatings: intensity scaling and Jones-based polarized models.

Counterpart of ``optiland_tpu/coatings.py``. Coatings are static
per-surface objects. In the trace they act after the refraction or
reflection: they may scale the ray intensity and, in polarized traces,
give the per-ray Jones matrix that updates the polarization matrix p.

Each coating converts to a plain record of its kind and numbers
(``record``) and back (``coating_from_record``); two coatings are equal when
their records are. The records:

  * ``("simple", T, R)``
  * ``("fresnel", material_pre, material_post)``
  * ``("polarizer", (ax, ay, az))`` with a unit axis
  * ``("retarder", retardance, (ax, ay, az))`` with a unit axis
  * ``("thin_film", incident, substrate, ((layer_material, thickness_um),
    ...))``

where each material is a ``BaseMaterial.record``.
"""

from __future__ import annotations

import numpy as np
import torch

from optiland_torch.materials import material_from_record
from optiland_torch.polarization import (
    BaseJones,
    JonesFresnel,
    JonesLinearPolarizer,
    JonesLinearRetarder,
    JonesThinFilm,
)


class BaseCoating:
    #: True when the coating's physics needs the polarization matrix
    polarization_dependent = False

    def intensity_factor(self, reflect: bool):
        """Scalar intensity multiplier."""
        return 1.0

    def jones(self) -> BaseJones | None:
        """Jones model applied in polarized traces (None = identity)."""
        return None

    @staticmethod
    def compute_aoi(L0, M0, N0, nx, ny, nz):
        """Angle of incidence from the pre-interaction directions."""
        dot = torch.abs(nx * L0 + ny * M0 + nz * N0)
        return torch.arccos(torch.clamp(dot, -1.0, 1.0))

    def record(self) -> tuple:
        raise NotImplementedError(f"{type(self).__name__} has no record")

    def __eq__(self, other):
        return type(self) is type(other) and self.record() == other.record()

    def __hash__(self):
        return hash(self.record())


class SimpleCoating(BaseCoating):
    """Fixed transmittance and reflectance."""

    def __init__(self, transmittance: float, reflectance: float = 0):
        self.transmittance = transmittance
        self.reflectance = reflectance
        self.absorptance = 1 - reflectance - transmittance

    def intensity_factor(self, reflect: bool):
        return self.reflectance if reflect else self.transmittance

    def record(self):
        return ("simple", float(self.transmittance), float(self.reflectance))


class FresnelCoating(BaseCoating):
    """Fresnel amplitude coefficients of the bare interface."""

    polarization_dependent = True

    def __init__(self, material_pre, material_post):
        self.material_pre = material_pre
        self.material_post = material_post
        self._jones = JonesFresnel(material_pre, material_post)

    def jones(self):
        return self._jones

    def record(self):
        return ("fresnel", self.material_pre.record(),
                self.material_post.record())


class PolarizerCoating(BaseCoating):
    """Linear polarizer coating."""

    polarization_dependent = True

    def __init__(self, axis=(1, 0, 0)):
        self._jones = JonesLinearPolarizer(axis)

    def jones(self):
        return self._jones

    def record(self):
        return ("polarizer", tuple(float(v) for v in self._jones.axis))


class RetarderCoating(BaseCoating):
    """Linear retarder coating."""

    polarization_dependent = True

    def __init__(self, retardance, axis=None, *, theta=None):
        self._jones = JonesLinearRetarder(retardance, axis=axis, theta=theta)

    def jones(self):
        return self._jones

    def record(self):
        return ("retarder", float(self._jones.retardance),
                tuple(float(v) for v in self._jones.axis))


class ThinFilmCoating(BaseCoating):
    """Multilayer coating driven by a ThinFilmStack's TMM."""

    polarization_dependent = True

    def __init__(self, stack):
        self.stack = stack
        self._jones = JonesThinFilm(stack)

    def jones(self):
        return self._jones

    def record(self):
        st = self.stack
        return ("thin_film", st.incident_material.record(),
                st.substrate_material.record(),
                tuple((l.material.record(), float(l.thickness_um))
                      for l in st.layers))


def coating_from_record(rec) -> BaseCoating:
    """The coating of a record (see the module docstring). Raises
    NotImplementedError for a kind the port does not have."""
    if not (isinstance(rec, tuple) and rec and isinstance(rec[0], str)):
        raise NotImplementedError(f"coatings: {rec!r} is not a coating record")
    kind = rec[0]
    if kind == "simple":
        return SimpleCoating(rec[1], rec[2])
    if kind == "fresnel":
        return FresnelCoating(material_from_record(rec[1]),
                              material_from_record(rec[2]))
    if kind in ("polarizer", "retarder"):
        c = (PolarizerCoating(rec[1]) if kind == "polarizer"
             else RetarderCoating(rec[1], axis=rec[2]))
        # the record's axis is already a unit vector: keep it as it is
        c._jones.axis = np.asarray(rec[-1], dtype=float)
        return c
    if kind == "thin_film":
        from optiland_torch.thin_film import ThinFilmStack

        st = ThinFilmStack(material_from_record(rec[1]),
                           material_from_record(rec[2]))
        for mat, d in rec[3]:
            st.add_layer(material_from_record(mat), d)
        return ThinFilmCoating(st)
    raise NotImplementedError(f"coatings: the coating kind {kind!r} is not "
                              "ported")


__all__ = [
    "BaseCoating",
    "FresnelCoating",
    "PolarizerCoating",
    "RetarderCoating",
    "SimpleCoating",
    "ThinFilmCoating",
    "coating_from_record",
]
