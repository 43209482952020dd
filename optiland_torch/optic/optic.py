"""User-facing Optic builder with the JAX package's construction API.

Counterpart of ``optiland_tpu/optic/optic.py`` (a subset): ``SurfaceDef``,
``SurfaceGroup.add`` for the "standard" and "plane" surface types, the field,
wavelength and aperture groups, and ``Optic`` with ``set_aperture``,
``system`` (compiled on the configured device and dtype, cached,
invalidated on mutation) and a ``paraxial`` view with ``f2``. Pickups,
solves, coatings, coordinate systems, the other surface types and ``trace``
come in later slices and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from optiland_torch import config
from optiland_torch.core import geometry as geom
from optiland_torch.core import paraxial as paraxial_core
from optiland_torch.core.system import SurfaceStack, System, SystemConfig
from optiland_torch.materials import AIR, BaseMaterial, resolve_material

_GEOM_CODES = {
    "standard": geom.STANDARD,
    "plane": geom.PLANE,
}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is ported in a later slice")


@dataclasses.dataclass
class SurfaceDef:
    """Mutable builder record for one surface."""

    radius: float = np.inf
    thickness: float = 0.0
    conic: float = 0.0
    material: Any = "air"
    is_stop: bool = False
    surface_type: str = "standard"
    dx: float = 0.0
    dy: float = 0.0
    dz: float = 0.0  # z-decenter on top of the cumulative-thickness vertex
    rx: float = 0.0
    ry: float = 0.0
    rz: float = 0.0
    aperture: float | None = None  # physical semi-diameter via diameter value
    comment: str = ""

    # resolved at compile time
    _material_obj: BaseMaterial | None = None
    _is_reflective: bool = False


class SurfaceGroup:
    """Ordered list of surface definitions with the JAX package's add API."""

    def __init__(self, optic: "Optic"):
        self._optic = optic
        self.surfaces: list[SurfaceDef] = []

    def add(
        self,
        index: int | None = None,
        radius: float = np.inf,
        thickness: float = 0.0,
        conic: float = 0.0,
        material: Any = "air",
        is_stop: bool = False,
        surface_type: str = "standard",
        dx: float = 0.0,
        dy: float = 0.0,
        dz: float = 0.0,
        rx: float = 0.0,
        ry: float = 0.0,
        rz: float = 0.0,
        aperture: float | None = None,
        comment: str = "",
        **kwargs,
    ):
        """Add a "standard" or "plane" surface."""
        if surface_type not in _GEOM_CODES:
            raise _later(f"surface_type {surface_type!r}")
        if kwargs:
            raise _later(f"surface argument(s) {sorted(kwargs)}")
        if aperture is not None and not isinstance(aperture, (int, float)):
            raise _later("physical aperture objects")
        sd = SurfaceDef(
            radius=radius, thickness=thickness, conic=conic,
            material=material, is_stop=is_stop, surface_type=surface_type,
            dx=dx, dy=dy, dz=dz, rx=rx, ry=ry, rz=rz, aperture=aperture,
            comment=comment,
        )
        if index is None:
            index = len(self.surfaces)
        self.surfaces.insert(index, sd)
        self._optic._invalidate()
        return sd

    @property
    def stop_index(self) -> int:
        for i, s in enumerate(self.surfaces):
            if s.is_stop:
                return i
        return 1


@dataclasses.dataclass
class Field:
    x: float = 0.0
    y: float = 0.0
    vx: float = 0.0
    vy: float = 0.0
    weight: float = 1.0


class FieldGroup:
    """Field list and field type."""

    def __init__(self, optic: "Optic"):
        self._optic = optic
        self.fields: list[Field] = []
        self.field_type = "angle"
        self.telecentric = False

    def set_type(self, field_type=None, **kwargs):
        if field_type is None:
            field_type = kwargs.pop("type", None)
        self.field_type = field_type
        self._optic._invalidate()

    def add(self, x: float = 0.0, y: float = 0.0, vx: float = 0.0,
            vy: float = 0.0, weight: float = 1.0):
        if weight < 0:
            raise ValueError(f"Field weight must be non-negative, got {weight}.")
        self.fields.append(Field(x=x, y=y, vx=vx, vy=vy, weight=float(weight)))
        self._optic._invalidate()

    @property
    def x_fields(self):
        return np.array([f.x for f in self.fields])

    @property
    def y_fields(self):
        return np.array([f.y for f in self.fields])


@dataclasses.dataclass
class Wavelength:
    value: float
    is_primary: bool = False
    weight: float = 1.0


class WavelengthGroup:
    """Wavelength list. Values in um."""

    def __init__(self, optic: "Optic"):
        self._optic = optic
        self.wavelengths: list[Wavelength] = []

    def add(self, value: float, is_primary: bool = False, unit: str = "um",
            weight: float = 1.0):
        scale = {"nm": 1e-3, "um": 1.0, "mm": 1e3, "cm": 1e4,
                 "m": 1e6}[unit.lower()]
        self.wavelengths.append(
            Wavelength(value * scale, is_primary, weight=float(weight))
        )
        self._optic._invalidate()

    @property
    def primary_index(self) -> int:
        for i, w in enumerate(self.wavelengths):
            if w.is_primary:
                return i
        return 0

    def get_wavelengths(self):
        return [w.value for w in self.wavelengths]


class Aperture:
    def __init__(self, ap_type: str, value: float):
        self.ap_type = ap_type
        self.value = value


class ParaxialView:
    """Paraxial properties of an Optic's compiled system."""

    def __init__(self, optic: "Optic"):
        self._optic = optic

    def f2(self):
        """Back (effective) focal length."""
        return paraxial_core.f2(self._optic.system)


class Optic:
    """Top-level optical system builder."""

    def __init__(self, name: str | None = None):
        self.name = name
        self.surfaces = SurfaceGroup(self)
        self.fields = FieldGroup(self)
        self.wavelengths = WavelengthGroup(self)
        self.aperture: Aperture | None = None
        self._system_cache: System | None = None

    def set_aperture(self, aperture_type: str, value: float):
        """Set the system aperture."""
        if aperture_type not in ("EPD", "imageFNO", "objectNA",
                                 "float_by_stop_size"):
            raise ValueError(f"Unknown aperture type {aperture_type}")
        self.aperture = Aperture(aperture_type, value)
        self._invalidate()

    def _invalidate(self):
        self._system_cache = None

    @property
    def system(self) -> System:
        """Compile (or fetch cached) the system on the configured device."""
        if self._system_cache is None:
            self._system_cache = self._compile()
        return self._system_cache

    @property
    def paraxial(self) -> ParaxialView:
        return ParaxialView(self)

    def _compile(self) -> System:
        dev, dt = config.device(), config.dtype()
        surfs = self.surfaces.surfaces
        if len(surfs) < 3:
            raise ValueError("System needs at least object, one surface, image.")
        if self.aperture is None:
            raise ValueError("No aperture is defined on the optical system.")
        if not self.wavelengths.wavelengths:
            raise ValueError("No wavelengths defined on the optical system.")
        if not self.fields.fields:
            raise ValueError("No fields defined on the optical system.")
        S = len(surfs)

        # Resolve materials; mirror => reflective with unchanged medium.
        prev_mat = AIR
        for s in surfs:
            spec = s.material
            if isinstance(spec, str) and spec.lower() == "mirror":
                s._is_reflective = True
                s._material_obj = prev_mat
            else:
                s._is_reflective = False
                s._material_obj = resolve_material(spec)
            prev_mat = s._material_obj

        mats = [s._material_obj for s in surfs]
        max_nt = max([m.n_table.shape[0] for m in mats] + [0])
        max_kt = max([m.k_table.shape[0] for m in mats] + [0])

        def pad_table(tab, n):
            if n == 0:
                return np.zeros((0, 2))
            if tab.shape[0] == 0:
                # benign placeholder: flat zeros over a dummy range
                out = np.zeros((n, 2))
                out[:, 0] = np.linspace(0.1, 20.0, n)
                return out
            return np.vstack([tab, np.repeat(tab[-1:], n - tab.shape[0], axis=0)])

        geom_code = []
        for s in surfs:
            code = _GEOM_CODES[s.surface_type]
            if code == geom.STANDARD and np.isinf(s.radius):
                code = geom.PLANE
            geom_code.append(code)

        def tensor(vals):
            return torch.as_tensor(np.asarray(vals, dtype=np.float64),
                                   dtype=dt, device=dev)

        def col(attr):
            return tensor([float(getattr(s, attr)) for s in surfs])

        stack = SurfaceStack(
            radius=col("radius"),
            conic=col("conic"),
            coeffs=tensor(np.zeros((S, 1))),
            geo_p1=tensor(np.ones(S)),
            geo_p2=tensor(np.ones(S)),
            thickness=col("thickness"),
            dx=col("dx"), dy=col("dy"), dz=col("dz"),
            rx=col("rx"), ry=col("ry"), rz=col("rz"),
            ap_max=tensor([
                float(s.aperture) / 2 if s.aperture is not None else np.inf
                for s in surfs
            ]),
            mat_coeffs=tensor(np.stack([m.padded_coefficients for m in mats])),
            ntab=tensor(np.stack([pad_table(m.n_table, max_nt) for m in mats])),
            ktab=tensor(np.stack([pad_table(m.k_table, max_kt) for m in mats])),
        )

        none = (None,) * S
        cfg = SystemConfig(
            num_surfaces=S,
            stop_index=self.surfaces.stop_index,
            obj_infinite=bool(np.isinf(surfs[0].thickness)),
            geom_codes=tuple(geom_code),
            mat_formulas=tuple(int(m.formula_code) for m in mats),
            reflective=tuple(bool(s._is_reflective) for s in surfs),
            geom_aux=none,
            apertures=none,
            interactions=none,
            coatings=none,
            bsdfs=none,
            polarized=False,
            has_tilts=any(v != 0 for s in surfs for v in (s.rx, s.ry, s.rz)),
            has_absorption=any(m.has_absorption for m in mats),
            aperture_type=self.aperture.ap_type,
            field_type=self.fields.field_type,
            primary_index=self.wavelengths.primary_index,
            obj_telecentric=self.fields.telecentric,
        )

        return System(
            stack=stack,
            aperture_value=tensor(self.aperture.value),
            field_x=tensor(self.fields.x_fields),
            field_y=tensor(self.fields.y_fields),
            vig_x=tensor([f.vx for f in self.fields.fields]),
            vig_y=tensor([f.vy for f in self.fields.fields]),
            wavelengths=tensor(self.wavelengths.get_wavelengths()),
            cfg=cfg,
        )

    def trace(self, *args, **kwargs):
        raise _later("Optic.trace (the reference trace, ROADMAP Queue 1 item 3)")
