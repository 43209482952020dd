"""Wavefront analysis: OPD relative to a reference sphere or plane at the
exit pupil.

Counterpart of ``optiland_tpu/wavefront/__init__.py``: the chief-ray,
centroid and best-fit strategies, each with a reference sphere or plane,
``fit_and_remove_tilt`` and the ``Wavefront`` controller. Invalid rays are
handled by weight masks, not by removing them, as in the JAX package.

The traces pass their concrete wavelength to ``core.trace.trace``, so a
bundle on a CUDA device runs on the trace kernels (K5a forward, K5b in the
backward); on the CPU the plain engine traces it. Polarized systems come
with the polarization slice and raise.

OPD is returned in waves; wavelengths are micrometers, lengths millimeters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from optiland_torch.core import paraxial, raygen
from optiland_torch.core import trace as trace_core
from optiland_torch.core.distributions import create_distribution
from optiland_torch.core.system import System, n_all, positions, scalar_like


@dataclasses.dataclass
class WavefrontData:
    """Computed wavefront samples at the exit pupil."""

    pupil_x: torch.Tensor
    pupil_y: torch.Tensor
    pupil_z: torch.Tensor
    opd: torch.Tensor  # waves
    intensity: torch.Tensor
    radius: torch.Tensor  # reference sphere radius (inf for plane)
    # the exit E-fields of polarized systems; None here (polarization slice)
    E_exits: tuple = None
    # reference center (cx, cy, cz) of the centroid and best-fit strategies
    center: tuple = None

    def replace(self, **changes) -> "WavefrontData":
        return dataclasses.replace(self, **changes)


def _sphere_path_length(x, y, z, L, M, N, center, R, n_medium):
    """Optical path from image-surface ray positions back to a reference
    sphere."""
    xc, yc, zc = center
    Lb, Mb, Nb = -L, -M, -N
    a = Lb**2 + Mb**2 + Nb**2
    b = 2 * (Lb * (x - xc) + Mb * (y - yc) + Nb * (z - zc))
    c = (
        x**2 + y**2 + z**2
        - 2 * (x * xc + y * yc + z * zc)
        + xc**2 + yc**2 + zc**2
        - R**2
    )
    d = torch.clamp(b**2 - 4 * a * c, min=0.0)
    sq = torch.sqrt(d)
    t1 = (-b - sq) / (2 * a)
    t2 = (-b + sq) / (2 * a)
    t = torch.where(t1 < 0, t2, t1)
    return n_medium * t


def _plane_path_length(x, y, z, L, M, N, point, normal, n_medium):
    """Optical path back to a reference plane."""
    px, py, pz = point
    nx, ny, nz = normal
    Lb, Mb, Nb = -L, -M, -N
    num = (x - px) * nx + (y - py) * ny + (z - pz) * nz
    den = Lb * nx + Mb * ny + Nb * nz
    den = torch.where(den.abs() < 1e-12, 1e-12, den)
    return n_medium * (-num / den)


def _tilt_correction(system: System, Hx, Hy, Px, Py):
    """Launch-plane tilt term for infinite-conjugate angle fields."""
    if system.cfg.field_type != "angle" or not system.cfg.obj_infinite:
        return 0.0
    max_field = torch.max(torch.sqrt(system.field_x**2 + system.field_y**2))
    tx = torch.tan(torch.deg2rad(Hx * max_field))
    ty = torch.tan(torch.deg2rad(Hy * max_field))
    uz = 1.0 / torch.sqrt(1.0 + tx**2 + ty**2)
    ux, uy = tx * uz, ty * uz
    epd = paraxial.EPD(system)
    return ux * Px * epd / 2 + uy * Py * epd / 2


def _trace_field(system: System, Hx, Hy, Px, Py, wavelength):
    """Final rays of pupil samples (Px, Py) of one field. The concrete
    wavelength sends a CUDA bundle to the trace kernels."""
    rays = raygen.generate_rays(system, Hx, Hy, Px, Py, wavelength)
    final, _ = trace_core.trace(system, rays, record=False,
                                wavelength=wavelength)
    return final


def compute_wavefront_data(
    system: System,
    Hx,
    Hy,
    wavelength,
    Px,
    Py,
    strategy: str = "chief_ray",
    reference_type: str = "sphere",
    robust_trim_std: float = 3.0,
    pol_state=None,
) -> WavefrontData:
    """Exit-pupil wavefront samples for one field and wavelength.

    Differentiable with respect to every leaf of the system. ``strategy``
    in {"chief_ray", "centroid", "best_fit"}; ``reference_type`` in
    {"sphere", "plane"}. ``wavelength`` is a number (um).
    """
    if pol_state is not None:
        raise NotImplementedError(
            "polarized wavefronts (E_exits, polarized intensity) come with "
            "the polarization slice (kernels K8/K9)"
        )
    if strategy not in ("chief_ray", "centroid", "best_fit"):
        raise ValueError(f"Unknown wavefront strategy: {strategy}")
    like = system.stack.radius
    Px = torch.atleast_1d(scalar_like(Px, like))
    Py = torch.atleast_1d(scalar_like(Py, like))
    n_image = n_all(system.stack, system.cfg, system.primary_wavelength)[-1]
    pos = positions(system.stack)
    inf = torch.full((), float("inf"), dtype=like.dtype, device=like.device)

    if strategy == "chief_ray":
        chief = _trace_field(system, Hx, Hy, 0.0, 0.0, wavelength)
        xc, yc, zc = chief.x[0], chief.y[0], chief.z[0]
        pupil_z = paraxial.XPL(system) + pos[-1]
        if reference_type == "sphere":
            R = torch.sqrt(xc**2 + yc**2 + (zc - pupil_z) ** 2)

            def ref_pl(r):
                return _sphere_path_length(r.x, r.y, r.z, r.L, r.M, r.N,
                                           (xc, yc, zc), R, n_image)
        else:
            normal = (chief.L[0], chief.M[0], chief.N[0])
            R = inf

            def ref_pl(r):
                return _plane_path_length(r.x, r.y, r.z, r.L, r.M, r.N,
                                          (xc, yc, zc), normal, n_image)

        opd_ref = chief.opd - ref_pl(chief)
        opd_ref = opd_ref + _tilt_correction(system, Hx, Hy, 0.0, 0.0)

        rays = _trace_field(system, Hx, Hy, Px, Py, wavelength)
        opd_img = ref_pl(rays)
        opd = rays.opd - opd_img
        opd = opd + _tilt_correction(system, Hx, Hy, Px, Py)

        opd_wv = (opd_ref[0] - opd) / (wavelength * 1e-3)
        t = opd_img / n_image
        return WavefrontData(
            pupil_x=rays.x - t * rays.L,
            pupil_y=rays.y - t * rays.M,
            pupil_z=rays.z - t * rays.N,
            opd=opd_wv,
            intensity=rays.i,
            radius=R,
        )

    rays = _trace_field(system, Hx, Hy, Px, Py, wavelength)
    opd0 = rays.opd + _tilt_correction(system, Hx, Hy, Px, Py)

    finite = (
        torch.isfinite(rays.x) & torch.isfinite(rays.y)
        & torch.isfinite(rays.z) & torch.isfinite(rays.L)
        & torch.isfinite(rays.M) & torch.isfinite(rays.N)
        & torch.isfinite(opd0) & (rays.i != 0)
    )
    w = torch.where(finite, torch.clamp(rays.i, min=0.0), 0.0)

    def mclean(a):
        return torch.where(finite, a, 0.0)

    x, y, z = mclean(rays.x), mclean(rays.y), mclean(rays.z)
    L, M, N = mclean(rays.L), mclean(rays.M), mclean(rays.N)
    s = mclean(opd0) / n_image
    wx, wy, wz = x - s * L, y - s * M, z - s * N  # wavefront points

    def wsum(a, w, tw):
        return torch.sum(a * w) / tw

    tw = torch.sum(w)
    tw = torch.where(tw == 0, 1.0, tw)
    cx, cy, cz = wsum(x, w, tw), wsum(y, w, tw), wsum(z, w, tw)
    # unweighted statistics over the valid rays, as the reference's
    nv = torch.clamp(finite.sum(), min=1)

    if robust_trim_std and robust_trim_std > 0 and strategy == "centroid":
        d_img = torch.sqrt((x - cx) ** 2 + (y - cy) ** 2 + (z - cz) ** 2)
        mean_d = torch.sum(torch.where(finite, d_img, 0.0)) / nv
        var_d = torch.sum(torch.where(finite, (d_img - mean_d) ** 2, 0.0)) / nv
        std_d = torch.sqrt(var_d)
        keep = d_img <= mean_d + robust_trim_std * std_d
        w = torch.where(std_d > 0, w * keep, w)
        tw = torch.sum(w)
        tw = torch.where(tw == 0, 1.0, tw)
        cx, cy, cz = wsum(x, w, tw), wsum(y, w, tw), wsum(z, w, tw)

    def mean_normal():
        ml, mm, mn = wsum(L, w, tw), wsum(M, w, tw), wsum(N, w, tw)
        norm = torch.sqrt(ml**2 + mm**2 + mn**2)
        norm = torch.where(norm == 0, 1.0, norm)
        return ml / norm, mm / norm, mn / norm

    center_out = (cx, cy, cz)
    if strategy == "centroid":
        if reference_type == "sphere":
            d_wf = torch.sqrt((wx - cx) ** 2 + (wy - cy) ** 2 + (wz - cz) ** 2)
            R = torch.sum(w * d_wf) / tw
            opd_img = _sphere_path_length(rays.x, rays.y, rays.z, rays.L,
                                          rays.M, rays.N, (cx, cy, cz), R,
                                          n_image)
        else:
            R = inf
            opd_img = _plane_path_length(rays.x, rays.y, rays.z, rays.L,
                                         rays.M, rays.N, (cx, cy, cz),
                                         mean_normal(), n_image)
    elif reference_type == "sphere":
        # best fit: algebraic least-squares sphere through the wavefront
        # points, |p - c|^2 = R^2 -> 2 p.c + (R^2 - |c|^2) = |p|^2
        A = torch.stack([2 * wx, 2 * wy, 2 * wz, torch.ones_like(wx)], dim=1)
        b = wx**2 + wy**2 + wz**2
        Aw = A * w[:, None]
        AtA = Aw.T @ A + 1e-12 * torch.eye(4, dtype=A.dtype, device=A.device)
        sol = torch.linalg.solve(AtA, Aw.T @ b)
        cx, cy, cz = sol[0], sol[1], sol[2]
        R = torch.sqrt(sol[3] + cx**2 + cy**2 + cz**2)
        center_out = (cx, cy, cz)
        opd_img = _sphere_path_length(rays.x, rays.y, rays.z, rays.L, rays.M,
                                      rays.N, (cx, cy, cz), R, n_image)
    else:
        # best-fit plane: weighted centroid of the wavefront points and the
        # normal from the mean direction
        center_out = (wsum(wx, w, tw), wsum(wy, w, tw), wsum(wz, w, tw))
        R = inf
        opd_img = _plane_path_length(rays.x, rays.y, rays.z, rays.L, rays.M,
                                     rays.N, center_out, mean_normal(),
                                     n_image)

    opd = opd0 - opd_img
    mean_opd = torch.sum(torch.where(finite, opd, 0.0)) / nv
    opd_wv = (mean_opd - opd) / (wavelength * 1e-3)
    t = opd_img / n_image
    return WavefrontData(
        pupil_x=rays.x - t * rays.L,
        pupil_y=rays.y - t * rays.M,
        pupil_z=rays.z - t * rays.N,
        opd=opd_wv,
        intensity=rays.i,
        radius=R,
        center=center_out,
    )


def fit_and_remove_tilt(data: WavefrontData, remove_piston: bool = False,
                        ridge: float = 1e-12):
    """Weighted least-squares removal of tilt (and optionally piston)."""
    x, y = data.pupil_x, data.pupil_y
    w = torch.sqrt(torch.clamp(data.intensity, min=0.0))
    X = torch.stack([torch.ones_like(x), x, y], dim=1)
    Xw = X * w[:, None]
    XtX = Xw.T @ Xw + ridge * torch.eye(3, dtype=X.dtype, device=X.device)
    coeffs = torch.linalg.solve(XtX, Xw.T @ (data.opd * w))
    if not remove_piston:
        coeffs = torch.cat([coeffs.new_zeros(1), coeffs[1:]])
    return data.opd - X @ coeffs


class Wavefront:
    """Wavefront analysis controller: WavefrontData for each (field,
    wavelength) pair."""

    def __init__(
        self,
        optic,
        fields="all",
        wavelengths="all",
        num_rays: int = 12,
        distribution="hexapolar",
        strategy: str = "chief_ray",
        afocal: bool = False,
        remove_tilt: bool = False,
        **kwargs,
    ):
        self.optic = optic
        if fields == "all":
            fields = optic.fields.get_field_coords()
        if wavelengths == "all":
            wavelengths = optic.wavelengths.get_wavelengths()
        elif wavelengths == "primary":
            wavelengths = [optic.primary_wavelength]
        self.fields = fields
        self.wavelengths = wavelengths
        if isinstance(distribution, str):
            distribution = create_distribution(distribution)
            distribution.generate_points(num_rays)
        self.distribution = distribution
        self.strategy = strategy
        self.reference_type = "plane" if afocal else "sphere"
        self.remove_tilt = remove_tilt
        self.data = {}
        self._generate_data()

    def _generate_data(self):
        system = self.optic.system
        Px = np.asarray(self.distribution.x, float)
        Py = np.asarray(self.distribution.y, float)
        for field in self.fields:
            for wl in self.wavelengths:
                data = compute_wavefront_data(
                    system, field[0], field[1], wl, Px, Py,
                    strategy=self.strategy,
                    reference_type=self.reference_type,
                    pol_state=self.optic.polarization_state,
                )
                if self.remove_tilt:
                    data = data.replace(opd=fit_and_remove_tilt(data))
                self.data[(tuple(field), wl)] = data

    def get_data(self, field, wl) -> WavefrontData:
        return self.data[(tuple(field), wl)]


__all__ = [
    "Wavefront",
    "WavefrontData",
    "compute_wavefront_data",
    "fit_and_remove_tilt",
]
