"""Pure elementwise ray kernels: rotation, refraction, reflection, grating
diffraction, normalize.

Counterpart of ``optiland_tpu/ops/kernels.py``: the vector-physics building
blocks of the per-surface trace step as pure functions over per-ray tensors
(vector Snell refraction with incident-aligned normals, mirror reflection,
Euler-angle bundle rotations), and the grating branch of the JAX package's
step (``optiland_tpu/core/trace.py``, the "grating" interaction):
the groove vector and the vector diffraction. Vignetted rays are masked by
intensity by the callers and never removed, so shapes stay fixed.
"""

from __future__ import annotations

import torch

from optiland_torch.core import geometry as geom


def rotate_x(y, z, M, N, rx):
    """Rotate positions/directions about the x-axis by angle rx."""
    c, s = torch.cos(rx), torch.sin(rx)
    return y * c - z * s, y * s + z * c, M * c - N * s, M * s + N * c


def rotate_y(x, z, L, N, ry):
    """Rotate positions/directions about the y-axis by angle ry."""
    c, s = torch.cos(ry), torch.sin(ry)
    return x * c + z * s, -x * s + z * c, L * c + N * s, -L * s + N * c


def rotate_z(x, y, L, M, rz):
    """Rotate positions/directions about the z-axis by angle rz."""
    c, s = torch.cos(rz), torch.sin(rz)
    return x * c - y * s, x * s + y * c, L * c - M * s, L * s + M * c


def align_normal(L, M, N, nx, ny, nz):
    """Flip surface normals to point against the incident rays.

    Returns the aligned (nx, ny, nz) and |cos| of the incidence angle.
    """
    dot = L * nx + M * ny + N * nz
    sgn = torch.sign(dot)
    return nx * sgn, ny * sgn, nz * sgn, torch.abs(dot)


def refract(L, M, N, nx, ny, nz, n1, n2):
    """Vector Snell refraction.

    Total internal reflection gives NaN directions, as in the JAX package;
    callers mask intensity.
    """
    u = n1 / n2
    nx, ny, nz, dot = align_normal(L, M, N, nx, ny, nz)
    root = torch.sqrt(1 - u**2 * (1 - dot**2))
    tx = u * L + nx * root - u * nx * dot
    ty = u * M + ny * root - u * ny * dot
    tz = u * N + nz * root - u * nz * dot
    return tx, ty, tz


def reflect(L, M, N, nx, ny, nz):
    """Mirror reflection about the (incident-aligned) surface normal."""
    nx, ny, nz, dot = align_normal(L, M, N, nx, ny, nz)
    return L - 2 * dot * nx, M - 2 * dot * ny, N - 2 * dot * nz


def normalize(L, M, N):
    """Normalize direction cosines."""
    mag = torch.sqrt(L**2 + M**2 + N**2)
    return L / mag, M / mag, N / mag



def grating_vector(code, radius, conic, alpha, x, y, nx, ny, nz):
    """The unit groove vector f of a grating of groove angle ``alpha`` at
    local (x, y), on a PLANE substrate (-sin alpha, cos alpha, 0), on a
    STANDARD one -normalize(n x t) of the raw (unflipped) surface normal n
    and the groove tangent t = (1, tan alpha, dz/dxi) / |.|, dz/dxi = (x +
    y tan alpha) / (R sqrt(max(1 - (1 + k) r^2 / R^2, 1e-14)))."""
    if code == geom.PLANE:
        ones = torch.ones_like(x)
        return (-torch.sin(alpha) * ones, torch.cos(alpha) * ones,
                torch.zeros_like(x))
    if code != geom.STANDARD:
        raise ValueError(f"a grating's substrate is PLANE or STANDARD, not "
                         f"geometry code {code}")
    r2 = x * x + y * y
    denom = radius * torch.sqrt(
        torch.clamp(1 - (1 + conic) * r2 / radius**2, min=1e-14))
    ta = torch.tan(alpha)
    dzd = (x + y * ta) / denom
    tmag = torch.sqrt(1 + ta * ta + dzd * dzd)
    tx, ty, tz = 1.0 / tmag, ta / tmag, dzd / tmag
    gx = ny * tz - nz * ty
    gy = -nx * tz + nz * tx
    gz = nx * ty - ny * tx
    gmag = torch.sqrt(gx * gx + gy * gy + gz * gz)
    return -gx / gmag, -gy / gmag, -gz / gmag


def grating_diffract(L, M, N, nx, ny, nz, adot, f, period, mlam, n_pre,
                     n_post, reflective):
    """Vector grating diffraction by conservation of the tangential
    momentum with the grating vector (m lambda / d) f.

    (nx, ny, nz) is the normal aligned against the rays, ``adot`` |cos| of
    the angle of incidence, ``f`` the groove vector (``grating_vector``),
    ``mlam`` the order times the wavelength (um; a scalar or per ray), and
    ``period`` d in um, corrected for the groove vector's transverse
    projection d / sqrt(max(fx^2 + fy^2, 1e-12)). A reflective grating
    keeps the incident medium (``n_post`` is n_pre there). Returns the
    diffracted directions and the mask of propagating orders: an evanescent
    order gets a zero root (its intensity is the caller's to zero), taken
    so that no NaN reaches a gradient."""
    fx, fy, fz = f
    d_eff = period / torch.sqrt(torch.clamp(fx * fx + fy * fy, min=1e-12))
    fn = fx * nx + fy * ny + fz * nz
    Ptx = d_eff * n_pre * (L - adot * nx) + mlam * (fx - fn * nx)
    Pty = d_eff * n_pre * (M - adot * ny) + mlam * (fy - fn * ny)
    Ptz = d_eff * n_pre * (N - adot * nz) + mlam * (fz - fn * nz)
    rad = (d_eff * n_post) ** 2 - (Ptx**2 + Pty**2 + Ptz**2)
    ok = rad >= 0
    root = torch.where(ok, torch.sqrt(torch.where(ok, rad, 1.0)), 0.0)
    D = d_eff * n_post
    sp = -1.0 if reflective else 1.0
    return ((sp * Ptx + nx * root) / D, (sp * Pty + ny * root) / D,
            (sp * Ptz + nz * root) / D, ok)
