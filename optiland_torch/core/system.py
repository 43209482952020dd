"""Compiled system description: dataclasses of per-surface tensors.

Counterpart of ``optiland_tpu/core/system.py``:

  * ``SurfaceStack`` — stacked per-surface tensors (row 0 = object surface,
    last row = image surface). Every floating-point leaf may require grad.
  * ``SystemConfig`` — frozen, hashable static structure (counts, flags,
    modes), the same fields as the JAX package's.
  * ``System`` — both, plus the system-level tensors (aperture value, fields,
    wavelengths).

``system_from_numpy`` is the carry-across function: it builds a ``System``
from the JAX package's parameters given as numpy arrays, so the same
prescription can be fed to both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optiland_torch import config
from optiland_torch.materials import dispersion


@dataclasses.dataclass
class SurfaceStack:
    """Stacked per-surface parameters (S rows incl. object and image).

    Attributes:
        radius: (S,) radii of curvature (inf for planes).
        conic: (S,) conic constants.
        coeffs: (S, NC) geometry coefficient vectors (zero-padded).
        geo_p1, geo_p2: (S,) extra geometry scalars.
        thickness: (S,) axial distance from surface s to s+1; row 0 is the
            object distance (may be inf), last row is 0.
        dx, dy, dz: (S,) decenters (dz adds to the cumulative-thickness
            vertex position).
        rx, ry, rz: (S,) Euler tilt angles (radians).
        ap_max: (S,) physical-aperture semi-diameters (inf = unbounded).
        mat_coeffs: (S, MAX_COEFFS) dispersion coefficients of material_post.
        ntab: (S, T, 2) tabulated wavelength/index data (T may be 0).
        ktab: (S, TK, 2) tabulated wavelength/extinction data (TK may be 0).
    """

    radius: torch.Tensor
    conic: torch.Tensor
    coeffs: torch.Tensor
    geo_p1: torch.Tensor
    geo_p2: torch.Tensor
    thickness: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    rx: torch.Tensor
    ry: torch.Tensor
    rz: torch.Tensor
    ap_max: torch.Tensor
    mat_coeffs: torch.Tensor
    ntab: torch.Tensor
    ktab: torch.Tensor

    @property
    def num_surfaces(self) -> int:
        return self.radius.shape[0]

    def leaves(self) -> dict:
        """Name -> tensor for every leaf, in field order."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def replace(self, **changes) -> "SurfaceStack":
        return dataclasses.replace(self, **changes)


STACK_FIELDS = tuple(f.name for f in dataclasses.fields(SurfaceStack))


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Hashable static structure of a system (the JAX package's fields)."""

    num_surfaces: int
    stop_index: int
    obj_infinite: bool
    geom_codes: tuple  # tuple[int], per surface
    mat_formulas: tuple  # tuple[int], material_post per surface
    reflective: tuple  # tuple[bool], per surface
    geom_aux: tuple = None  # tuple[hashable|None], static per-surface extras
    apertures: tuple = None  # tuple[aperture|None], static clip objects
    interactions: tuple = None  # tuple[spec|None]; None = refract/reflect
    coatings: tuple = None  # tuple[coating|None]
    bsdfs: tuple = None  # tuple[bsdf|None]
    polarized: bool = False
    has_tilts: bool = False
    has_absorption: bool = False
    aperture_type: str = "EPD"
    field_type: str = "angle"
    primary_index: int = 0
    obj_telecentric: bool = False


@dataclasses.dataclass
class System:
    """A complete optical system: stack + system-level parameters."""

    stack: SurfaceStack
    aperture_value: torch.Tensor  # scalar
    field_x: torch.Tensor  # (F,)
    field_y: torch.Tensor  # (F,)
    vig_x: torch.Tensor  # (F,)
    vig_y: torch.Tensor  # (F,)
    wavelengths: torch.Tensor  # (W,)
    cfg: SystemConfig

    @property
    def primary_wavelength(self):
        return self.wavelengths[self.cfg.primary_index]

    def replace(self, **changes) -> "System":
        return dataclasses.replace(self, **changes)


SYSTEM_FIELDS = ("aperture_value", "field_x", "field_y", "vig_x", "vig_y",
                 "wavelengths")


def positions(stack: SurfaceStack) -> torch.Tensor:
    """Vertex z-positions of all surfaces (surface 1 at z = 0).

    pos[0] = -thickness[0] (object distance, possibly -inf);
    pos[k] = sum of thickness[1:k] for k >= 1.
    """
    t = stack.thickness
    inner = torch.cat([t.new_zeros((1,)), torch.cumsum(t[1:-1], dim=0)])
    return torch.cat([(-t[0])[None], inner])


def scalar_like(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a tensor of ``like``'s dtype and device. A Python or numpy
    number is written on the device rather than copied from the host, since
    a host-to-device copy waits for the device to drain its queue."""
    if torch.is_tensor(v):
        return v.to(dtype=like.dtype, device=like.device)
    if np.ndim(v) == 0:
        return torch.full((), float(v), dtype=like.dtype, device=like.device)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


_STATIC: dict = {}


def static_tensor(values, dtype, device) -> torch.Tensor:
    """Tensor of static per-surface values (codes or flags of a
    ``SystemConfig``) on ``device``, copied to the device once per
    (values, dtype, device). Callers share it and only read it."""
    key = (tuple(values), dtype, str(device))
    t = _STATIC.get(key)
    if t is None:
        t = torch.tensor(key[0], dtype=dtype, device=device)
        _STATIC[key] = t
    return t


def interp(x, xp, fp):
    """``jnp.interp`` in torch: linear interpolation with constant ends.

    Same arithmetic as the JAX implementation (right-sided search, a
    guarded zero-width interval), so values and gradients match. ``xp`` and
    ``fp`` may carry leading batch dimensions, one table per row; ``x`` then
    holds the matching leading dimensions and any number of points per row.
    """
    x = scalar_like(x, xp)
    xp = xp.contiguous()
    lead = xp.shape[:-1]
    xf = x.reshape(*lead, -1)
    i = torch.clamp(
        torch.searchsorted(xp, xf.detach().contiguous(), right=True),
        1, xp.shape[-1] - 1,
    )
    xp0, xp1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    fp0, fp1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    df = fp1 - fp0
    dx = xp1 - xp0
    delta = xf - xp0
    eps = float(np.spacing(torch.finfo(xp.dtype).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(
        dx0, fp0, fp0 + (delta / torch.where(dx0, torch.ones_like(dx), dx)) * df,
    )
    f = torch.where(xf < xp[..., :1], fp[..., :1], f)
    f = torch.where(xf > xp[..., -1:], fp[..., -1:], f)
    return f.reshape(x.shape)


def n_of(formula_code: int, mat_coeffs, ntab, w):
    """Refractive index of one surface's material_post at wavelength(s) w."""
    if formula_code == dispersion.TABULATED_N:
        return interp(w, ntab[:, 0], ntab[:, 1])
    return dispersion.n_formula_static(formula_code, mat_coeffs, w)


def k_of(ktab, w):
    """Extinction coefficient from a per-surface table (zeros if empty)."""
    w = scalar_like(w, ktab)
    if ktab.shape[0] == 0:
        return torch.zeros_like(w)
    return interp(w, ktab[:, 0], ktab[:, 1])


def k_all(stack: SurfaceStack, w) -> torch.Tensor:
    """(S,) extinction coefficients of every surface's material_post at
    scalar w: ``k_of`` of each row, as one batched interpolation."""
    kt = stack.ktab
    w = scalar_like(w, kt)
    if kt.shape[1] == 0:
        return kt.new_zeros(kt.shape[0])
    return interp(w.expand(kt.shape[0]), kt[..., 0], kt[..., 1])


def n_all(stack: SurfaceStack, cfg: SystemConfig, w) -> torch.Tensor:
    """(S,) refractive indices of every surface's material_post at scalar w."""
    w = scalar_like(w, stack.radius)
    return torch.stack([
        n_of(cfg.mat_formulas[s], stack.mat_coeffs[s], stack.ntab[s], w)
        for s in range(cfg.num_surfaces)
    ])


# Config entries that hold per-surface objects the port does not model yet
# (apertures: all but RadialAperture, geometry extras but those of the
# aux-bearing families and gratings, and interactions but gratings, checked
# apart).
_OBJECT_FIELDS = ("bsdfs",)


def is_grating(entry):
    """True for a grating's extras or interaction, ``("grating", m)`` with
    an integer diffraction order m."""
    return (isinstance(entry, tuple) and len(entry) == 2
            and entry[0] == "grating"
            and isinstance(entry[1], (int, np.integer)))


def is_nurbs_aux(aux):
    """True for a NURBS net's static structure, ``("nurbs", nu, nv, p, q,
    u_knots, v_knots)``: its control-point counts, degrees and knot
    vectors (nu + p + 1 and nv + q + 1 knots)."""
    if not (isinstance(aux, tuple) and len(aux) == 7 and aux[0] == "nurbs"):
        return False
    _, nu, nv, p, q, uk, vk = aux
    return (all(isinstance(k, (int, np.integer)) for k in (nu, nv, p, q))
            and isinstance(uk, tuple) and isinstance(vk, tuple)
            and len(uk) == nu + p + 1 and len(vk) == nv + q + 1)


def carried_aux(code, aux):
    """True for the geometry extras the port carries: a Zernike scheme
    ``(scheme,)``, ``("qbfs", n_terms)`` and ``("q2d", nms)`` on a surface
    of that family, ``("grating", m)`` on a PLANE or STANDARD surface, a
    NURBS net's structure (``is_nurbs_aux``) on a NURBS surface, which
    needs one (None anywhere else)."""
    from optiland_torch.core import geometry as geom
    from optiland_torch.zernike import ZERNIKE_CLASSES

    if aux is None:
        return code != geom.NURBS
    if not isinstance(aux, tuple) or not aux:
        return False
    if code == geom.NURBS:
        return is_nurbs_aux(aux)
    if is_grating(aux):
        return code in (geom.PLANE, geom.STANDARD)
    if code == geom.ZERNIKE_SAG:
        return len(aux) == 1 and aux[0] in ZERNIKE_CLASSES
    if code == geom.FORBES_QBFS:
        return len(aux) == 2 and aux[0] == "qbfs"
    if code == geom.FORBES_Q2D:
        return len(aux) == 2 and aux[0] == "q2d"
    return False


def nurbs_aux_of(aux):
    """A NURBS structure with plain Python numbers (other extras as they
    are): another package's knots may be numpy scalars."""
    if isinstance(aux, tuple) and len(aux) == 7 and aux[0] == "nurbs":
        _, nu, nv, p, q, uk, vk = aux
        return ("nurbs", int(nu), int(nv), int(p), int(q),
                tuple(float(k) for k in uk), tuple(float(k) for k in vk))
    return aux


def system_from_numpy(arrays: dict, cfg_fields: dict) -> System:
    """Build the port's ``System`` from another package's parameters.

    ``arrays`` maps every ``SurfaceStack`` field name and the system-level
    names (aperture_value, field_x, field_y, vig_x, vig_y, wavelengths) to
    numpy arrays; ``cfg_fields`` maps ``SystemConfig`` field names to their
    values. Coatings come as records (``coatings.coating_from_record``: the
    kind and its numbers), one per surface or None, and so do apertures
    (``BaseAperture.to_dict`` of a ``RadialAperture``), and ``polarized``
    as a bool. The tensors take the configured dtype and device. Raises
    ``NotImplementedError`` for the per-surface config objects the port does
    not carry yet (other apertures, BSDFs, interactions but gratings,
    geometry extras) and for a coating record of a kind it does not have.
    Geometry extras are carried for the aux-bearing families (a Zernike
    scheme, a Qbfs term count, a Q2d (n, m) layout), NURBS surfaces (the
    net's structure ``("nurbs", nu, nv, p, q, u_knots, v_knots)``, its
    knots as floats) and gratings, as tuples; interactions only as gratings, ``("grating", m)`` (the thin
    lens and phase interactions come in a later slice).
    """
    from optiland_torch.coatings import coating_from_record
    from optiland_torch.physical_apertures import RadialAperture

    cfg_fields = dict(cfg_fields)
    aps = cfg_fields.get("apertures")
    if aps is not None:
        if not all(a is None or (isinstance(a, dict)
                                 and a.get("type") == "RadialAperture")
                   for a in aps):
            raise NotImplementedError(
                f"system_from_numpy: config entry 'apertures' holds {aps!r}; "
                "only None entries and RadialAperture records are carried "
                "so far"
            )
        cfg_fields["apertures"] = tuple(
            None if a is None else RadialAperture(float(a["r_max"]),
                                                  float(a["r_min"]))
            for a in aps)
    aux = cfg_fields.get("geom_aux")
    if aux is not None:
        aux = tuple(nurbs_aux_of(a) for a in aux)
        if not all(carried_aux(c, a)
                   for c, a in zip(cfg_fields["geom_codes"], aux)):
            raise NotImplementedError(
                f"system_from_numpy: config entry 'geom_aux' holds {aux!r}; "
                "only None entries, the extras of ZERNIKE_SAG, "
                "FORBES_QBFS, FORBES_Q2D and NURBS surfaces and gratings on "
                "PLANE and STANDARD ones are carried so far"
            )
        cfg_fields["geom_aux"] = aux
    inter = cfg_fields.get("interactions")
    if inter is not None:
        inter = tuple(inter)
        if not all(i is None or is_grating(i) for i in inter):
            raise NotImplementedError(
                f"system_from_numpy: config entry 'interactions' holds "
                f"{inter!r}; only None entries and gratings ('grating', m) "
                "are carried so far (thin lens and phase: a later slice)"
            )
        cfg_fields["interactions"] = inter
    for name in _OBJECT_FIELDS:
        vals = cfg_fields.get(name)
        if vals is not None and any(v is not None for v in vals):
            raise NotImplementedError(
                f"system_from_numpy: config entry {name!r} holds objects "
                f"{vals!r}; only None entries are carried so far"
            )
    if cfg_fields.get("coatings") is not None:
        cfg_fields["coatings"] = tuple(
            None if c is None else coating_from_record(c)
            for c in cfg_fields["coatings"]
        )
    cfg_fields["polarized"] = bool(cfg_fields.get("polarized", False))
    for name in ("geom_codes", "mat_formulas", "reflective"):
        cfg_fields[name] = tuple(cfg_fields[name])
    cfg = SystemConfig(**cfg_fields)
    missing = [k for k in STACK_FIELDS + SYSTEM_FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"system_from_numpy: missing arrays {missing}")
    dev, dt = config.device(), config.dtype()

    def tensor(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=dt,
                               device=dev)

    stack = SurfaceStack(**{k: tensor(arrays[k]) for k in STACK_FIELDS})
    return System(stack=stack, cfg=cfg,
                  **{k: tensor(arrays[k]) for k in SYSTEM_FIELDS})
