"""Geometry: sag, surface normal and ray-surface intersection, PLANE and
STANDARD (conic) families.

Counterpart of ``optiland_tpu/core/geometry.py``, with the same integer
codes and the same formulas (curvature-form conic, closed-form root choice,
``rsqrt`` normal), so values and autograd gradients match the JAX package's.
The Newton-from-sag families, grid sag and NURBS are ported with the K6
kernel branches in a later slice; asking for them raises.
"""

from __future__ import annotations

import torch

# Geometry codes (stable; the JAX package's values)
PLANE = 0
STANDARD = 1
EVEN_ASPHERE = 2
ODD_ASPHERE = 3
POLYNOMIAL_XY = 4
CHEBYSHEV = 5
ZERNIKE_SAG = 6
TOROIDAL = 7
BICONIC = 8
FORBES_QBFS = 9
FORBES_Q2D = 10
GRID_SAG = 11
NURBS = 12

# Families this slice covers.
SUPPORTED_CODES = frozenset({PLANE, STANDARD})


def _unsupported(code):
    return NotImplementedError(
        f"geometry code {code} is ported with the Newton-sag, grid-sag and "
        "NURBS families (ROADMAP Queue 1 item 8, kernel K6) in a later slice"
    )


def _conic_sag(radius, conic, x2py2):
    # Curvature form: cu = 1/R is exactly 0 for a flat (R = inf), which keeps
    # the value and its derivatives finite.
    cu = 1.0 / radius
    return (cu * x2py2) / (1 + torch.sqrt(1 - (1 + conic) * cu**2 * x2py2))


def _normal_plane(x_like):
    zeros = torch.zeros_like(x_like)
    return zeros, zeros, -torch.ones_like(x_like)


def _normal_standard(radius, conic, x, y):
    # rsqrt form, as in the JAX package: one transcendental op per
    # normalization (the kernels use the same form).
    r2 = x**2 + y**2
    cu = 1.0 / radius
    inv_denom = cu * torch.rsqrt(1 - (1 + conic) * cu**2 * r2)
    dfdx = x * inv_denom
    dfdy = y * inv_denom
    inv_mag = torch.rsqrt(dfdx**2 + dfdy**2 + 1)
    return dfdx * inv_mag, dfdy * inv_mag, -inv_mag


def surface_normal_static(code: int, radius, conic, coeffs, x, y, p1=1.0,
                          p2=1.0, aux=None):
    """Unit surface normal at local (x, y), pointing toward -z at the vertex."""
    if code == PLANE:
        return _normal_plane(x)
    if code == STANDARD:
        return _normal_standard(radius, conic, x, y)
    raise _unsupported(code)


def _distance_plane(x, y, z, L, M, N):
    N_safe = torch.where(N.abs() > 1e-14, N, 1e-14)
    return -z / N_safe


def _distance_standard(radius, conic, x, y, z, L, M, N):
    """Closed-form conic intersection, choosing the root nearest the vertex
    plane (curvature form: degrades to the plane equation when R = inf)."""
    k = conic
    cu = 1.0 / radius
    a = cu * (k * N**2 + L**2 + M**2 + N**2)
    b = 2 * (cu * (k * N * z + L * x + M * y + N * z) - N)
    c = cu * (k * z**2 + x**2 + y**2 + z**2) - 2 * z
    d = b**2 - 4 * a * c
    sqrt_d = torch.sqrt(torch.clamp(d, min=0.0))
    sqrt_d = torch.where(d < 0, float("nan"), sqrt_d)
    # Citardauq-stable root pair: q/a and c/q; c/q stays finite as a -> 0.
    s = torch.where(b >= 0, 1.0, -1.0).to(b.dtype)
    q = -0.5 * (b + s * sqrt_d)
    q_safe = torch.where(q == 0, 1.0, q)
    a_safe = torch.where(a == 0, 1.0, a)
    t1 = torch.where(a == 0, float("inf"), q / a_safe)
    t2 = torch.where(q == 0, 0.0, c / q_safe)
    z1 = z + t1 * N
    z2 = z + t2 * N
    return torch.where(z1.abs() <= z2.abs(), t1, t2)


def distance_static(code: int, radius, conic, x, y, z, L, M, N):
    """Ray parameter t to the surface for a PLANE or STANDARD surface."""
    if code == PLANE:
        return _distance_plane(x, y, z, L, M, N)
    if code == STANDARD:
        return _distance_standard(radius, conic, x, y, z, L, M, N)
    raise _unsupported(code)
