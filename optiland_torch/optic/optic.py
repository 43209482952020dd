"""User-facing Optic builder with the JAX package's construction API.

Counterpart of ``optiland_tpu/optic/optic.py`` (a subset): ``SurfaceDef``,
``SurfaceGroup.add`` for the "standard" and "plane" surface types, the field,
wavelength and aperture groups, and ``Optic`` with ``set_aperture``,
``system`` (compiled on the configured device and dtype, cached,
invalidated on mutation), a ``paraxial`` view with ``f2``, ``EPL``, ``XPL``
and ``EPD``, and the real-ray entry points ``trace`` and ``trace_generic``
with their ``TraceResult``.
Pickups, solves, coatings, coordinate systems, ray aimers other than the
paraxial one and the other surface types come in later slices and raise
here.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from optiland_torch import config
from optiland_torch.core import geometry as geom
from optiland_torch.core import paraxial as paraxial_core
from optiland_torch.core import raygen
from optiland_torch.core import trace as trace_core
from optiland_torch.core.distributions import create_distribution
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

    @property
    def max_field(self):
        if not self.fields:
            return 0.0
        return float(np.max(np.sqrt(self.x_fields**2 + self.y_fields**2)))

    def get_field_coords(self):
        """Normalized (Hx, Hy) of every field."""
        m = self.max_field
        if m == 0:
            return [(0.0, 0.0)]
        return [(float(f.x / m), float(f.y / m)) for f in self.fields]


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

    @property
    def primary_wavelength(self) -> float:
        return self.wavelengths[self.primary_index].value


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

    def EPL(self):
        """Entrance pupil location relative to surface 1."""
        return paraxial_core.EPL(self._optic.system)

    def XPL(self):
        """Exit pupil location relative to the image surface."""
        return paraxial_core.XPL(self._optic.system)

    def EPD(self):
        """Entrance pupil diameter."""
        return paraxial_core.EPD(self._optic.system)


class TraceResult:
    """Traced rays and, when recorded, the per-surface history: ``x`` ..
    ``opd``, ``w``, ``i`` (also ``intensity``), ``rays`` and ``history``
    (a dict of (S, R) tensors, or None)."""

    def __init__(self, final, history):
        self.rays = final
        self.history = history
        for name in ("x", "y", "z", "L", "M", "N", "opd", "w"):
            setattr(self, name, getattr(final, name))
        self.i = final.i
        self.intensity = final.i

    def __repr__(self):
        return f"TraceResult({self.x.shape[0]} rays)"


def _concrete_wavelength(wavelength):
    """float(wavelength) for a number or a one-element tensor that needs no
    gradient; the tensor itself otherwise, which keeps the trace
    differentiable with respect to it (and off the fused kernels)."""
    if torch.is_tensor(wavelength) and wavelength.requires_grad:
        return wavelength
    return float(wavelength)


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

    @property
    def primary_wavelength(self) -> float:
        return self.wavelengths.primary_wavelength

    @property
    def polarization_state(self):
        """None: polarized systems come with the polarization slice."""
        return None

    def _run_trace(self, Hx, Hy, Px, Py, wavelength, record):
        system = self.system
        like = system.stack.radius
        Hx, Hy, Px, Py = (torch.as_tensor(v, dtype=like.dtype, device=like.device)
                          for v in (Hx, Hy, Px, Py))
        rays = raygen.generate_rays(system, Hx, Hy, Px, Py, wavelength)
        # a concrete wavelength lets record=False traces run on the fused
        # kernels on a CUDA device
        final, history = trace_core.trace(system, rays, record=record,
                                          wavelength=wavelength)
        return TraceResult(final, history)

    def trace(self, Hx=0.0, Hy=0.0, wavelength=None, num_rays: int = 100,
              distribution="hexapolar", record: bool = True) -> TraceResult:
        """Trace a pupil distribution of real rays for one or more fields.

        ``num_rays`` is passed to the distribution's ``generate_points``
        (for ``hexapolar``, the number of rings). Several fields repeat the
        pupil pattern once per field."""
        if wavelength is None:
            wavelength = self.primary_wavelength
        wavelength = _concrete_wavelength(wavelength)
        if isinstance(distribution, str):
            distribution = create_distribution(distribution)
            distribution.generate_points(num_rays)
        Px = np.atleast_1d(np.asarray(distribution.x, float))
        Py = np.atleast_1d(np.asarray(distribution.y, float))
        Hx = np.atleast_1d(np.asarray(Hx, float))
        Hy = np.atleast_1d(np.asarray(Hy, float))
        if len(Hx) > 1 or len(Hy) > 1:
            nf, npup = len(Hx), len(Px)
            Hx, Hy = np.repeat(Hx, npup), np.repeat(Hy, npup)
            Px, Py = np.tile(Px, nf), np.tile(Py, nf)
        # one field broadcasts against the pupil: the same values as
        # repeating it per ray, computed once
        return self._run_trace(Hx, Hy, Px, Py, wavelength, record)

    def trace_generic(self, Hx, Hy, Px, Py, wavelength,
                      record: bool = True) -> TraceResult:
        """Trace rays at explicit field/pupil coordinates (broadcast against
        each other)."""
        Hx, Hy, Px, Py = np.broadcast_arrays(
            np.atleast_1d(np.asarray(Hx, float)),
            np.atleast_1d(np.asarray(Hy, float)),
            np.atleast_1d(np.asarray(Px, float)),
            np.atleast_1d(np.asarray(Py, float)),
        )
        return self._run_trace(Hx, Hy, Px, Py,
                               _concrete_wavelength(wavelength), record)
