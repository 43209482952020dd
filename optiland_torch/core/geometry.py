"""Geometry: sag, surface normal and ray-surface intersection, PLANE,
STANDARD (conic) and the radial Newton-from-sag families EVEN_ASPHERE and
ODD_ASPHERE.

Counterpart of ``optiland_tpu/core/geometry.py``, with the same integer
codes and the same formulas (curvature-form conic, closed-form root choice,
``rsqrt`` normal), so values and autograd gradients match the JAX package's.

The two aspheres are radial: s = conic(r^2) + g(rho) with g(rho) = sum_i
C_i rho^(i+1), rho = r^2 (even) or r (odd). Their normal is the sag's
derivative, ds/dx = x W and ds/dy = y W, written out (``sag_point``)
where the JAX package takes it by forward-mode AD; the values agree to
rounding. The odd family's terms have zero slope at exactly r = 0, as the
JAX package's guarded square root gives them. Their intersection is
Newton's method from the conic (or plane) guess, with the clamp on
|f'| and the one stopped-then-differentiable correction step that gives
the implicit-function gradient (``distance_static``). The other
Newton-from-sag families, grid sag and NURBS are ported with the rest of
kernel K6 in a later slice; asking for them raises.
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

# Families the port covers, and those of them solved by Newton's method.
NEWTON_CODES = frozenset({EVEN_ASPHERE, ODD_ASPHERE})
SUPPORTED_CODES = frozenset({PLANE, STANDARD}) | NEWTON_CODES

# Newton iterations of the plain engine's intersection (the JAX package's
# XLA path; its kernels take ``newton_iters``, 10 by default).
NEWTON_ITERS = 16


def _unsupported(code):
    return NotImplementedError(
        f"geometry code {code} is ported with the other Newton-sag, grid-sag "
        "and NURBS families (ROADMAP Queue 1 item 3, kernel K6) in a later "
        "slice"
    )


def _conic_sag(radius, conic, x2py2):
    # Curvature form: cu = 1/R is exactly 0 for a flat (R = inf), which keeps
    # the value and its derivatives finite.
    cu = 1.0 / radius
    return (cu * x2py2) / (1 + torch.sqrt(1 - (1 + conic) * cu**2 * x2py2))


def _poly_horner(coeffs, rho):
    """(P, G1) of the coefficient row at rho: P = sum C_i rho^i and
    G1 = sum (i+1) C_i rho^i, so that g = rho P and g' = G1."""
    P = torch.zeros_like(rho)
    G1 = torch.zeros_like(rho)
    for i in range(coeffs.shape[-1] - 1, -1, -1):
        P = P * rho + coeffs[..., i]
        G1 = G1 * rho + (i + 1) * coeffs[..., i]
    return P, G1


def sag_point(code, radius, conic, coeffs, r2, grad=False):
    """The radial terms of a Newton family at r^2 = x^2 + y^2: (s, W),
    the sag and W with ds/dx = x W, ds/dy = y W (the conic's cu / q, plus
    2 g'(r^2) even or g'(r) / r odd; the odd terms are 0 at exactly
    r = 0). With ``grad`` also what the hand adjoints read: dW/dr^2,
    ds/dcu, ds/dk, dW/dcu, dW/dk (cu = 1 / radius, k = conic), rho (r^2
    even, r odd) and beta, with ds/dC_i = rho^(i+1) and dW/dC_i = (i+1)
    beta rho^i (beta = 2 even, 1 / r odd, 0 at r = 0)."""
    cu = 1.0 / radius
    e = (1 + conic) * cu**2
    q = torch.sqrt(1 - e * r2)
    s = cu * r2 / (1 + q)
    W = cu / q
    even = code == EVEN_ASPHERE
    if even:
        rho = r2
    else:
        at0 = r2 == 0
        rho = torch.where(at0, 0.0, torch.sqrt(torch.where(at0, 1.0, r2)))
        r_s = torch.where(at0, 1.0, rho)
    P, G1 = _poly_horner(coeffs, rho)
    if even:
        s, W = s + P * rho, W + 2 * G1
    else:
        s, W = s + P * rho, W + torch.where(at0, 0.0, G1 / r_s)
    if not grad:
        return s, W
    nc = coeffs.shape[-1]
    # d(g' / r)/dr^2 (odd): sum (i+1)(i-1) C_i r^i / (2 r^3); 2 g'' (even)
    H = torch.zeros_like(rho)
    for i in range(nc - 1, -1 if not even else 0, -1):
        w = (i + 1) * (i - 1) if not even else 2 * i * (i + 1)
        H = H * rho + w * coeffs[..., i]
    q3 = q**3
    Wr = cu * e / (2 * q3)
    if even:
        Wr, beta = Wr + H, torch.full_like(rho, 2.0)
    else:
        Wr = Wr + torch.where(at0, 0.0, H / (2 * r_s**3))
        beta = torch.where(at0, 0.0, 1.0 / r_s)
    s_cu = r2 / (q * (1 + q))
    s_k = cu**3 * r2**2 / (2 * q * (1 + q)**2)
    return s, W, Wr, s_cu, s_k, 1.0 / q3, cu**3 * r2 / (2 * q3), rho, beta


def sag_static(code: int, radius, conic, coeffs, x, y):
    """Surface sag at local coordinates (x, y)."""
    if code == PLANE:
        return torch.zeros_like(x)
    if code == STANDARD:
        return _conic_sag(radius, conic, x**2 + y**2)
    if code in NEWTON_CODES:
        return sag_point(code, radius, conic, coeffs, x**2 + y**2)[0]
    raise _unsupported(code)


def _normal_newton(code, radius, conic, coeffs, x, y):
    # the sag's derivative (x W, y W), normalized in the rsqrt form
    _, W = sag_point(code, radius, conic, coeffs, x**2 + y**2)
    dfdx, dfdy = x * W, y * W
    inv_mag = torch.rsqrt(dfdx**2 + dfdy**2 + 1)
    return dfdx * inv_mag, dfdy * inv_mag, -inv_mag


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
    if code in NEWTON_CODES:
        return _normal_newton(code, radius, conic, coeffs, x, y)
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


def newton_step(code, radius, conic, coeffs, x, y, z, L, M, N, t):
    """One Newton step t - f/f' on f(t) = z + t N - s(x + t L, y + t M),
    with f' = N - (s_x L + s_y M) clamped to 1e-14 where |f'| <= 1e-14."""
    X, Y = x + t * L, y + t * M
    s, W = sag_point(code, radius, conic, coeffs, X**2 + Y**2)
    f = z + t * N - s
    dfdt = N - W * (X * L + Y * M)
    dfdt = torch.where(dfdt.abs() > 1e-14, dfdt, 1e-14)
    return t - f / dfdt


def newton_start(radius, conic, x, y, z, L, M, N):
    """Newton's first guess: the conic's closed form, or the plane's where
    that is not finite."""
    t0 = _distance_standard(radius, conic, x, y, z, L, M, N)
    return torch.where(torch.isfinite(t0), t0,
                       _distance_plane(x, y, z, L, M, N))


def distance_static(code: int, radius, conic, x, y, z, L, M, N, coeffs=None,
                    newton_iters=NEWTON_ITERS):
    """Ray parameter t to the surface in its local frame. The Newton
    families take ``newton_iters`` steps from ``newton_start`` without a
    gradient, then one differentiable step: the implicit-function gradient
    dt/dtheta = -f_theta / f_t (plus the f f'_theta / f'^2 term of that
    step), as the JAX package forms it."""
    if code == PLANE:
        return _distance_plane(x, y, z, L, M, N)
    if code == STANDARD:
        return _distance_standard(radius, conic, x, y, z, L, M, N)
    if code not in NEWTON_CODES:
        raise _unsupported(code)
    with torch.no_grad():
        t = newton_start(radius, conic, x, y, z, L, M, N)
        for _ in range(newton_iters):
            t = newton_step(code, radius, conic, coeffs, x, y, z, L, M, N, t)
    return newton_step(code, radius, conic, coeffs, x, y, z, L, M, N,
                       t.detach())
