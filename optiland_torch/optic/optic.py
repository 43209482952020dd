"""User-facing Optic builder with the JAX package's construction API.

Counterpart of ``optiland_tpu/optic/optic.py`` (a subset): ``SurfaceDef``,
``SurfaceGroup.add`` for the "standard", "plane", "even_asphere",
"odd_asphere", "polynomial", "chebyshev", "toroidal", "biconic",
"zernike", "forbes_qbfs", "forbes_q2d", "nurbs" and "grating" surface types (with
the JAX package's arguments),
a semi-diameter or a ``RadialAperture`` as the physical aperture, and an
optional coating (a coating object or the "fresnel" shorthand), the field,
wavelength and aperture groups, and ``Optic`` with ``set_aperture``,
``set_polarization``, ``system`` (compiled on the configured device and
dtype, cached, invalidated on mutation), a ``paraxial`` view with ``f2``,
``EPL``, ``XPL`` and ``EPD``, and the real-ray entry points ``trace`` and
``trace_generic`` with their ``TraceResult``; a polarized optic's trace
gives the polarized exit intensity and the polarization matrix p.
Pickups, solves, coordinate systems, ray aimers other than the paraxial
one and the other surface types come in later slices and raise here.
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
from optiland_torch.core.nurbs import build_nurbs_def
from optiland_torch.core.system import (
    SurfaceStack, System, SystemConfig, nurbs_aux_of,
)
from optiland_torch.materials import AIR, BaseMaterial, resolve_material
from optiland_torch.polarization import (
    create_polarization, exit_fields, polarized_intensity,
)

_GEOM_CODES = {
    "standard": geom.STANDARD,
    "plane": geom.PLANE,
    "even_asphere": geom.EVEN_ASPHERE,
    "odd_asphere": geom.ODD_ASPHERE,
    "polynomial": geom.POLYNOMIAL_XY,
    "chebyshev": geom.CHEBYSHEV,
    "toroidal": geom.TOROIDAL,
    "biconic": geom.BICONIC,
    "zernike": geom.ZERNIKE_SAG,
    "forbes_qbfs": geom.FORBES_QBFS,
    "forbes_q2d": geom.FORBES_Q2D,
    "nurbs": geom.NURBS,
}
# the JAX package's other surface types, and what they wait for
_QUEUE2_TYPES = ("grid_sag",)


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
    coefficients: tuple = ()
    dx: float = 0.0
    dy: float = 0.0
    dz: float = 0.0  # z-decenter on top of the cumulative-thickness vertex
    rx: float = 0.0
    ry: float = 0.0
    rz: float = 0.0
    aperture: Any = None  # a diameter (float) or a RadialAperture
    comment: str = ""
    coating: Any = None  # BaseCoating or "fresnel"
    # extended geometry parameters (the JAX package's): the y radius and
    # conic (biconic, toroidal) or the normalization radii (chebyshev)
    geo_p1: float = 1.0
    geo_p2: float = 1.0
    # static extras (the JAX package's geom_aux): a Zernike scheme, a Qbfs
    # term count, a Q2d (n, m) layout, a grating's ("grating", order)
    geo_aux: Any = None

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
        coefficients=(),
        dx: float = 0.0,
        dy: float = 0.0,
        dz: float = 0.0,
        rx: float = 0.0,
        ry: float = 0.0,
        rz: float = 0.0,
        aperture=None,
        comment: str = "",
        coating=None,
        **kwargs,
    ):
        """Add a surface, optionally with a physical ``aperture`` (a
        diameter or a ``RadialAperture``) and a coating (``coating`` a
        coating object or "fresnel", the bare interface between the
        adjacent materials). Surface types, with the JAX package's
        arguments:

          * "standard", "plane";
          * "even_asphere", "odd_asphere": ``coefficients`` C_i of
            r^(2i+2) (even) or r^(i+1) (odd);
          * "polynomial": ``coefficients`` C[i, j] of x^i y^j, a 2-D table
            embedded in a square, row-major (a flat one is read as such);
          * "chebyshev": the same of T_i(x / norm_x) T_j(y / norm_y);
          * "toroidal": ``radius_x`` the radius of rotation, ``radius_y``
            and ``conic`` the y-z profile's, ``toroidal_coeffs_poly_y`` its
            terms of y^2, y^4, ...;
          * "biconic": ``radius_x``, ``conic_x``, ``radius_y``,
            ``conic_y``;
          * "zernike": ``coefficients`` of the scheme's terms,
            ``norm_radius``, ``zernike_type`` ("fringe" by default,
            "standard", "noll");
          * "forbes_qbfs": ``radial_terms`` {n: a_n}, ``norm_radius``;
          * "forbes_q2d": ``freeform_coeffs`` {("a" | "b", m, n): c},
            ``norm_radius``;
          * "grating": ``grating_period`` (um, into geo_p1),
            ``groove_orientation_angle`` (rad, into geo_p2) and
            ``grating_order`` (into geo_aux, ("grating", m)) on a plane
            (infinite ``radius``) or conic substrate;
          * "nurbs": ``control_points`` (3, nu, nv) and ``weights``
            (nu, nv), ``u_degree``/``v_degree`` and ``u_knots``/
            ``v_knots`` (Bezier when only the points are given, clamped
            uniform knots by default), or without control points a fit of
            the conic ``radius``/``conic`` over ``nurbs_norm_x``/``_y``
            about ``nurbs_x_center``/``_y_center`` on ``n_points_u``/``_v``
            + 1 samples (``core/nurbs.build_nurbs_def``); the coefficient
            row is the flat net, the structure goes into geo_aux.

        The other type of the JAX package ("grid_sag") comes in a later
        slice (ROADMAP Queue 2) and raises."""
        from optiland_torch.physical_apertures import RadialAperture

        if surface_type in _QUEUE2_TYPES:
            raise NotImplementedError(
                f"surface_type {surface_type!r} is ported in a later slice "
                "(ROADMAP Queue 2)")
        if surface_type not in _GEOM_CODES and surface_type != "grating":
            raise _later(f"surface_type {surface_type!r}")
        geo_p1, geo_p2, geo_aux = 1.0, 1.0, None
        coeff_arr = np.asarray(coefficients, dtype=float)
        if surface_type in ("polynomial", "chebyshev") and coeff_arr.ndim == 2:
            # embed the (i, j) table in a square, row-major
            side = max(coeff_arr.shape)
            sq = np.zeros((side, side))
            sq[: coeff_arr.shape[0], : coeff_arr.shape[1]] = coeff_arr
            coeff_arr = sq
        if surface_type == "chebyshev":
            geo_p1 = kwargs.pop("norm_x", None) or 1.0
            geo_p2 = kwargs.pop("norm_y", None) or 1.0
        elif surface_type == "biconic":
            radius = kwargs.pop("radius_x", radius)
            conic = kwargs.pop("conic_x", conic)
            geo_p1 = kwargs.pop("radius_y", np.inf)
            geo_p2 = kwargs.pop("conic_y", 0.0)
        elif surface_type == "toroidal":
            radius = kwargs.pop("radius_x", radius)
            geo_p1 = kwargs.pop("radius_y", np.inf)
            geo_p2 = conic  # the conic of the y-z profile
            tor = kwargs.pop("toroidal_coeffs_poly_y", None)
            if tor is not None and np.size(tor):
                coeff_arr = np.asarray(tor, dtype=float)
        elif surface_type == "zernike":
            geo_p1 = kwargs.pop("norm_radius", None) or 1.0
            geo_aux = (kwargs.pop("zernike_type", "fringe"),)
        elif surface_type == "forbes_qbfs":
            # radial_terms {n: a_n} -> the dense coefficient row
            terms = kwargs.pop("radial_terms", None) or {}
            geo_p1 = kwargs.pop("norm_radius", None) or 1.0
            n_terms = (max(terms) + 1) if terms else 0
            coeff_arr = np.zeros(n_terms)
            for n, v in terms.items():
                coeff_arr[n] = v
            geo_aux = ("qbfs", n_terms)
        elif surface_type == "forbes_q2d":
            # freeform_coeffs {("a" | "b", m, n): c} -> the coefficient row
            # and its (n, m_signed) layout, sorted by (n, m, a/b)
            terms = kwargs.pop("freeform_coeffs", None) or {}
            geo_p1 = kwargs.pop("norm_radius", None) or 1.0
            nms, vals = [], []
            for (ab, m, n), v in sorted(
                    terms.items(), key=lambda kv: (kv[0][2], kv[0][1],
                                                   kv[0][0])):
                nms.append((n, m if ab.lower() == "a" else -m))
                vals.append(v)
            coeff_arr = np.asarray(vals, float)
            geo_aux = ("q2d", tuple(nms))
        elif surface_type == "grating":
            # the period and groove angle are differentiable parameters,
            # the order a static extra
            geo_p1 = kwargs.pop("grating_period", np.inf)
            geo_p2 = kwargs.pop("groove_orientation_angle", 0.0)
            geo_aux = ("grating", int(kwargs.pop("grating_order", 0)))
        elif surface_type == "nurbs":
            coeff_arr, geo_aux = build_nurbs_def(
                radius=radius,
                conic=conic,
                control_points=kwargs.pop("control_points", None),
                weights=kwargs.pop("weights", None),
                u_degree=kwargs.pop("u_degree", None),
                v_degree=kwargs.pop("v_degree", None),
                u_knots=kwargs.pop("u_knots", None),
                v_knots=kwargs.pop("v_knots", None),
                nurbs_norm_x=kwargs.pop("nurbs_norm_x", None),
                nurbs_norm_y=kwargs.pop("nurbs_norm_y", None),
                x_center=kwargs.pop("nurbs_x_center", 0.0),
                y_center=kwargs.pop("nurbs_y_center", 0.0),
                n_points_u=kwargs.pop("n_points_u", 5),
                n_points_v=kwargs.pop("n_points_v", 5),
            )
            geo_aux = nurbs_aux_of(geo_aux)
        if kwargs:
            raise _later(f"surface argument(s) {sorted(kwargs)}")
        if aperture is not None and not isinstance(
                aperture, (int, float, RadialAperture)):
            raise _later("physical aperture objects other than "
                         "RadialAperture")
        coefficients = tuple(float(c) for c in np.ravel(coeff_arr))
        sd = SurfaceDef(
            radius=radius, thickness=thickness, conic=conic,
            material=material, is_stop=is_stop, surface_type=surface_type,
            coefficients=coefficients,
            dx=dx, dy=dy, dz=dz, rx=rx, ry=ry, rz=rz, aperture=aperture,
            comment=comment, coating=coating, geo_p1=float(geo_p1),
            geo_p2=float(geo_p2), geo_aux=geo_aux,
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
    (a dict of (S, R) tensors, or None). A polarized trace also has ``p``,
    the (R, 3, 3) complex polarization matrices, and ``get_exit_fields``."""

    def __init__(self, final, history):
        self.rays = final
        self.history = history
        for name in ("x", "y", "z", "L", "M", "N", "opd", "w"):
            setattr(self, name, getattr(final, name))
        self.i = final.i
        self.intensity = final.i
        if history is not None and "p" in history:
            self.p = history["p"]
            self._i0 = history.get("i0")

    def get_exit_fields(self, state):
        """The exit 3D E-field(s) of a polarized trace: a list of (R, 3)
        complex tensors (``polarization.exit_fields``)."""
        i0 = self._i0 if self._i0 is not None else torch.ones_like(self.x)
        return exit_fields(self.p, state, self.rays.L0, self.rays.M0,
                           self.rays.N0, i0)

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
        self.polarization = "ignore"
        self._system_cache: System | None = None

    def set_aperture(self, aperture_type: str, value: float):
        """Set the system aperture."""
        if aperture_type not in ("EPD", "imageFNO", "objectNA",
                                 "float_by_stop_size"):
            raise ValueError(f"Unknown aperture type {aperture_type}")
        self.aperture = Aperture(aperture_type, value)
        self._invalidate()

    def set_polarization(self, polarization):
        """Set the polarization mode: "ignore", a PolarizationState, or a
        named state ("unpolarized", "H", "V", "L+45", "L-45", "RCP",
        "LCP")."""
        if isinstance(polarization, str) and polarization != "ignore":
            polarization = create_polarization(polarization)
        self.polarization = polarization
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
        coatings = []
        for i, s in enumerate(surfs):
            c = s.coating
            if isinstance(c, str) and c.lower() == "fresnel":
                from optiland_torch.coatings import FresnelCoating

                c = FresnelCoating(mats[i - 1] if i > 0 else AIR, mats[i])
            coatings.append(c)
        if self.polarization == "ignore" and any(
            c is not None and c.polarization_dependent for c in coatings
        ):
            raise ValueError(
                "Polarization must be set when surfaces have "
                "polarization-dependent coatings."
            )
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
            # a grating's substrate is a plane or a conic; the diffraction is
            # its interaction
            code = _GEOM_CODES.get(s.surface_type, geom.STANDARD)
            if code == geom.STANDARD and np.isinf(s.radius):
                code = geom.PLANE
            geom_code.append(code)

        def tensor(vals):
            return torch.as_tensor(np.asarray(vals, dtype=np.float64),
                                   dtype=dt, device=dev)

        def col(attr):
            return tensor([float(getattr(s, attr)) for s in surfs])

        # geometry coefficients, zero-padded to the widest surface's
        max_nc = max([len(s.coefficients) for s in surfs] + [1])
        coeffs = np.zeros((S, max_nc))
        for i, s in enumerate(surfs):
            coeffs[i, : len(s.coefficients)] = s.coefficients

        def numeric_ap(s):
            return isinstance(s.aperture, (int, float))

        stack = SurfaceStack(
            radius=col("radius"),
            conic=col("conic"),
            coeffs=tensor(coeffs),
            geo_p1=col("geo_p1"),
            geo_p2=col("geo_p2"),
            thickness=col("thickness"),
            dx=col("dx"), dy=col("dy"), dz=col("dz"),
            rx=col("rx"), ry=col("ry"), rz=col("rz"),
            ap_max=tensor([
                float(s.aperture) / 2 if numeric_ap(s) else np.inf
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
            geom_aux=tuple(s.geo_aux for s in surfs),
            apertures=tuple(None if s.aperture is None or numeric_ap(s)
                            else s.aperture for s in surfs),
            interactions=tuple(
                s.geo_aux if s.surface_type == "grating" else None
                for s in surfs),
            coatings=tuple(coatings),
            bsdfs=none,
            polarized=self.polarization != "ignore",
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
        """The PolarizationState, or None when polarization is ignored."""
        if self.polarization == "ignore":
            return None
        return self.polarization

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
        if system.cfg.polarized:
            # the exit intensity of the polarization matrices, from the
            # launch directions and the launch intensity
            i_pol = polarized_intensity(history["p"], self.polarization_state,
                                        rays.L, rays.M, rays.N, rays.i)
            final = final.replace(i=i_pol)
            history["i0"] = rays.i
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

    def image_solve(self):
        """Quick-focus the image plane: move it to the axial position of
        least RMS spot of an on-axis hexapolar fan
        (``solves.QuickFocusSolve``)."""
        from optiland_torch.solves import QuickFocusSolve

        QuickFocusSolve(self).apply()
