"""Geometry: sag, surface normal and ray-surface intersection, PLANE,
STANDARD (conic), the radial Newton-from-sag families EVEN_ASPHERE and
ODD_ASPHERE, and the Cartesian ones POLYNOMIAL_XY, CHEBYSHEV, TOROIDAL and
BICONIC, and NURBS.

Counterpart of ``optiland_tpu/core/geometry.py``, with the same integer
codes and the same formulas (curvature-form conic, closed-form root choice,
``rsqrt`` normal), so values and autograd gradients match the JAX package's.

The two aspheres are radial: s = conic(r^2) + g(rho) with g(rho) = sum_i
C_i rho^(i+1), rho = r^2 (even) or r (odd). Their normal is the sag's
derivative, ds/dx = x W and ds/dy = y W, written out (``sag_point``)
where the JAX package takes it by forward-mode AD; the values agree to
rounding. The odd family's terms have zero slope at exactly r = 0, as the
JAX package's guarded square root gives them.

The Cartesian families have separate x and y slopes (``cart_point``: s,
s_x, s_y, and for the hand adjoints the Hessian and the derivatives with
respect to the radius, the conic, p1 and p2):

  * POLYNOMIAL_XY: conic + sum_ij C[i, j] x^i y^j, the coefficient row a
    row-major square of side ceil(sqrt(nc)) of the system-wide padded width
    nc (so a narrower table is read with the widest surface's side, as in
    the JAX package);
  * CHEBYSHEV: conic + sum_ij C[i, j] T_i(x / p1) T_j(y / p2), same layout.
    Its normal is the reference's, not the sag's derivative: dT_n(t) =
    n sin(n acos(clip(t))) / sqrt(max(1 - t^2, 1e-14)) with no 1 / p
    chain-rule factor, normalized with 1 / sqrt; Newton's f' takes the true
    derivative. Outside |t| < 1 the clip's zero derivative meets acos's
    infinite one, and the gradient through the normal is NaN, as JAX's is;
  * TOROIDAL: the y-z profile z_y(y) (radius p1, conic p2, even polynomial
    sum_i C_i y^(2i+2)) rotated about an axis at the radius R; NaN where
    (R - z_y)^2 < x^2, and z_y alone where R is infinite (a cylinder, whose
    gradient is NaN in JAX: the branch not taken sends 0 inf into it);
  * BICONIC: cx x^2 / (1 + qx) + cy y^2 / (1 + qy) (radius R and conic k in
    x, p1 and p2 in y), the roots clamped at 0.

Where the JAX package clamps a root at 0 (the toroid's profile and the
biconic), its forward-mode slope past the clamp is 0 inf = NaN; so are the
slopes here, and the ray through it is NaN.

The aux-bearing families (``AUX_CODES``) are Cartesian too; their static
extras (the config's ``geom_aux``) decide how the coefficient row is read:

  * ZERNIKE_SAG: conic + sum_i c_i Z_i(r / p1, phi), the scheme's first nc
    terms (nc the padded width, so padded slots are terms with a zero
    coefficient), scheme ``aux[0]`` ("standard" without aux);
  * FORBES_QBFS: the Forbes base conic (root clamped at 0) + phi(r^2) u^2
    (1 - u^2) sum_n a_n Q_n(u^2), u^2 = r^2 / p1^2, the first ``aux[1]``
    coefficients, 0 past u^2 = 1; phi the conic factor, both radicands
    clamped at 1e-12;
  * FORBES_Q2D: the same base and factor times u^2 (1 - u^2) S_0(u^2) +
    sum_m [Re (x + iy)^m S_a,m + Im (x + iy)^m S_b,m] / p1^m, u^2 = (r^2 +
    1e-12) / p1^2, the (n, m) layout ``aux[1]``, 0 past u^2 = 1.

``sag_static`` transcribes the JAX package's sags. The slopes and the
derivatives (``cart_point``) read the row laid out by ``aux_layout``: a
static linear map takes the surface's coefficients to slots grouped in
blocks of one azimuthal order m, cos or sin, and each block's radial
functions follow one three-term recurrence in v = u^2 (monomials of
rho^2 for Zernike, the Forbes Clenshaw bases for Qbfs and Q2d) with its
constants in the layout. At exactly r = 0 a Zernike surface has the
reference's guarded slopes: every Zernike term's slope, and its
derivatives, is 0 there.

Every Newton family intersects by Newton's method from the conic (or
plane) guess of the surface's radius and conic, with the clamp on |f'|,
f' = N - (s_x L + s_y M), and the one stopped-then-differentiable
correction step that gives the implicit-function gradient
(``distance_static``).

NURBS surfaces (``core/nurbs.py``; their ``geom_aux`` the static net
structure ``("nurbs", nu, nv, p, q, u_knots, v_knots)``, their coefficient
row the flat control points and weights) have their own solve: the sag and
the normal by a 2x2 Newton on the parameters (u, v) whose surface point
has the query's (x, y), the distance by the two-plane parameter solve of
``nurbs.intersect``. Grid sag is ported in a later slice; asking for it
raises.
"""

from __future__ import annotations

import functools
import math
from types import SimpleNamespace

import numpy as np
import torch

from optiland_torch.core import forbes, nurbs
from optiland_torch.zernike import ZERNIKE_CLASSES, _radial_coeff_table

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

# Families the port covers, and those of them solved by Newton's method:
# the radial ones (``sag_point``) and the Cartesian ones (``cart_point``),
# among them the aux-bearing ones, whose row ``aux_layout`` lays out.
RADIAL_CODES = frozenset({EVEN_ASPHERE, ODD_ASPHERE})
AUX_CODES = frozenset({ZERNIKE_SAG, FORBES_QBFS, FORBES_Q2D})
CART_CODES = frozenset({POLYNOMIAL_XY, CHEBYSHEV, TOROIDAL,
                        BICONIC}) | AUX_CODES
NEWTON_CODES = RADIAL_CODES | CART_CODES
# NURBS is not a Newton family: it solves for its parameters (u, v)
SUPPORTED_CODES = frozenset({PLANE, STANDARD, NURBS}) | NEWTON_CODES

# Newton iterations of the plain engine's intersection (the JAX package's
# XLA path; its kernels take ``newton_iters``, 10 by default).
NEWTON_ITERS = 16


def _unsupported(code):
    return NotImplementedError(
        f"geometry code {code} (grid sag) is ported in a later slice "
        "(ROADMAP Queue 2)"
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


# ---------------------------------------------------------------------------
# Cartesian families: the JAX package's sags, transcribed (the reference of
# ``sag_static``), and ``cart_point``, their slopes and derivatives
# ---------------------------------------------------------------------------


def table_side(nc):
    """Side of the square coefficient table of a POLYNOMIAL_XY or CHEBYSHEV
    surface: ceil(sqrt(nc)) of the padded width nc."""
    side = math.isqrt(nc)
    return side + 1 if side * side < nc else side


def _inv_radius(r):
    """1 / r, exactly 0 for an infinite r, with derivative -1 / r^2 (0 at
    infinity): the JAX package's double-where curvature."""
    r = torch.as_tensor(r)
    inf = torch.isinf(r)
    return torch.where(inf, 0.0, 1.0 / torch.where(inf, 1.0, r))


def _sag_polynomial_xy(radius, conic, coeffs, x, y):
    z = _conic_sag(radius, conic, x**2 + y**2)
    nc = coeffs.shape[-1]
    side = table_side(nc)
    acc = torch.zeros_like(x)
    for i in range(side - 1, -1, -1):
        row = torch.zeros_like(y)
        for j in range(side - 1, -1, -1):
            idx = i * side + j
            row = row * y + (coeffs[idx] if idx < nc else 0.0)
        acc = acc * x + row
    return z + acc


def _chebyshev_eval(n_max, t):
    """T_0 .. T_n_max at t by the recurrence."""
    terms = [torch.ones_like(t)]
    if n_max >= 1:
        terms.append(t)
    for _ in range(2, n_max + 1):
        terms.append(2 * t * terms[-1] - terms[-2])
    return terms


def _sag_chebyshev(radius, conic, coeffs, p1, p2, x, y):
    z = _conic_sag(radius, conic, x**2 + y**2)
    nc = coeffs.shape[-1]
    side = table_side(nc)
    tx = _chebyshev_eval(side - 1, x / p1)
    ty = _chebyshev_eval(side - 1, y / p2)
    acc = torch.zeros_like(x)
    for i in range(side):
        for j in range(side):
            idx = i * side + j
            if idx < nc:
                acc = acc + coeffs[idx] * tx[i] * ty[j]
    return z + acc


def _toroidal_zy(p1, p2, coeffs, y):
    y2 = y**2
    c = _inv_radius(p1)
    root = torch.clamp(1.0 - (1.0 + p2) * c**2 * y2, min=0.0)
    z_y = c * y2 / (1.0 + torch.sqrt(root))
    acc = torch.zeros_like(y)
    for i in range(coeffs.shape[-1] - 1, -1, -1):
        acc = acc * y2 + coeffs[i]
    return z_y + acc * y2


def _sag_toroidal(radius, conic, coeffs, p1, p2, x, y):
    z_y = _toroidal_zy(p1, p2, coeffs, y)
    R = torch.as_tensor(radius)
    inside = (R - z_y) ** 2 - x**2
    z = z_y + (R - z_y) - torch.sign(R - z_y) * torch.sqrt(
        torch.where(inside < 0, float("nan"), inside))
    return torch.where(torch.isinf(R), z_y, z)


def _sag_biconic(radius, conic, coeffs, p1, p2, x, y):
    cx = _inv_radius(radius)
    cy = _inv_radius(p1)
    rx = torch.clamp(1.0 - (1.0 + conic) * cx**2 * x**2, min=0.0)
    ry = torch.clamp(1.0 - (1.0 + p2) * cy**2 * y**2, min=0.0)
    return (cx * x**2 / (1.0 + torch.sqrt(rx))
            + cy * y**2 / (1.0 + torch.sqrt(ry)))


def _clip_unit(t):
    """clip(t, -1, 1) with the JAX package's derivative: 1 inside, 0
    outside by a multiplicative mask, so that an infinite derivative
    downstream (acos' at +-1) gives NaN there as in the reference."""
    m = (t.abs() < 1).to(t.dtype)
    return m * t + (1 - m) * torch.sign(t)


def _basis_1d(code, v, p, n, normal=False):
    """The n one-dimensional basis functions of a coefficient table along
    one coordinate v (x or y) and their derivatives, by recurrence: lists
    f, f1, f2 (value, d/dv, d^2/dv^2) and fp, f1p (d/dp of f and f1, p the
    normalization). POLYNOMIAL_XY's are the powers v^i (f_{i+1} = v f_i,
    f1_{i+1} = v f1_i + f_i, f2_{i+1} = v f2_i + 2 f1_i; no p); CHEBYSHEV's
    T_i(t), t = v / p, by the three-term recurrences of T, T' and T''. With
    ``normal`` also g, g1, gp: the reference's normal term dT_i(t) (no
    1 / p factor) and its d/dv and d/dp."""
    zero = torch.zeros_like(v)
    f, f1, f2 = [torch.ones_like(v)], [zero], [zero]
    if code == POLYNOMIAL_XY:
        for _ in range(1, n):
            f, f1, f2 = (f + [v * f[-1]], f1 + [v * f1[-1] + f[-1]],
                         f2 + [v * f2[-1] + 2 * f1[-1]])
        return SimpleNamespace(f=f, f1=f1, f2=f2, fp=[zero] * n,
                               f1p=[zero] * n)
    t = v / p
    # T, T', T'' in t, from T_-1 = t, T'_-1 = 1, T''_-1 = 0 (so T_1 = t)
    T, T1, T2 = f, [zero], [zero]
    P, P1, P2 = t, torch.ones_like(v), zero
    for _ in range(1, n):
        T, T1, T2, P, P1, P2 = (
            T + [2 * t * T[-1] - P], T1 + [2 * T[-1] + 2 * t * T1[-1] - P1],
            T2 + [4 * T1[-1] + 2 * t * T2[-1] - P2], T[-1], T1[-1], T2[-1])
    f1 = [d / p for d in T1]
    f2 = [d / (p * p) for d in T2]
    b = SimpleNamespace(f=T, f1=f1, f2=f2, fp=[-t * d for d in f1],
                        f1p=[-t * d2 - d1 / p for d1, d2 in zip(f1, f2)])
    if normal:
        c = _clip_unit(t)
        th = torch.acos(c)
        omt = 1 - t * t
        D = torch.sqrt(torch.clamp(omt, min=1e-14))
        dD = torch.where(omt > 1e-14, -t / D, 0.0)
        dth = -torch.rsqrt(1 - c * c) * (t.abs() < 1).to(t.dtype)
        b.g, b.g1, b.gp = [zero], [zero], [zero]
        for i in range(1, n):
            num = i * torch.sin(i * th)
            dd = i * i * torch.cos(i * th) * dth / D - num * dD / (D * D)
            b.g.append(num / D)
            b.g1.append(dd / p)
            b.gp.append(-t * b.g1[-1])
    return b


def _table_sums(code, coeffs, p1, p2, X, Y, grad, normal):
    """The coefficient table's sums at (X, Y): P, Px, Py and with ``grad``
    the Hessian (Pxx, Pxy = d Px/dY, Pyx = d Py/dX, Pyy) and the p1, p2
    derivatives; with ``normal`` (CHEBYSHEV) the reference's normal terms
    in place of Px and Py. Row by row: each row i of the table is summed
    over j with the y basis, then weighted by the x basis at i (rows
    past the padded width nc are skipped)."""
    nc = coeffs.shape[-1]
    side = table_side(nc)
    nx = normal and code == CHEBYSHEV
    bx = _basis_1d(code, X, p1, side, nx)
    by = _basis_1d(code, Y, p2, side, nx)
    keys = ("P", "Px", "Py", "Pxx", "Pxy", "Pyx", "Pyy", "Pp1", "Pp2",
            "Pxp1", "Pxp2", "Pyp1", "Pyp2")
    o = dict.fromkeys(keys, torch.zeros_like(X))
    kinds = ("f", "f1", "f2", "fp", "f1p") + (("g", "g1", "gp") if nx
                                             else ())
    for i in range(side):
        if i * side >= nc:
            break
        r = dict.fromkeys(kinds, torch.zeros_like(Y))
        for j in range(min(side, nc - i * side)):
            C = coeffs[i * side + j]
            for kd in kinds:
                r[kd] = r[kd] + C * getattr(by, kd)[j]
        ax = {kd: getattr(bx, kd)[i] for kd in kinds}
        if nx:
            terms = (("P", "f", "f"), ("Px", "g", "f"), ("Py", "f", "g"),
                     ("Pxx", "g1", "f"), ("Pxy", "g", "f1"),
                     ("Pyx", "f1", "g"), ("Pyy", "f", "g1"),
                     ("Pp1", "fp", "f"), ("Pp2", "f", "fp"),
                     ("Pxp1", "gp", "f"), ("Pxp2", "g", "fp"),
                     ("Pyp1", "fp", "g"), ("Pyp2", "f", "gp"))
        else:
            terms = (("P", "f", "f"), ("Px", "f1", "f"), ("Py", "f", "f1"),
                     ("Pxx", "f2", "f"), ("Pxy", "f1", "f1"),
                     ("Pyx", "f1", "f1"), ("Pyy", "f", "f2"),
                     ("Pp1", "fp", "f"), ("Pp2", "f", "fp"),
                     ("Pxp1", "f1p", "f"), ("Pxp2", "f1", "fp"),
                     ("Pyp1", "fp", "f1"), ("Pyp2", "f", "f1p"))
        for k, a, b in terms[:3] + (terms[3:] if grad else ()):
            o[k] = o[k] + ax[a] * r[b]
    return o


# ---------------------------------------------------------------------------
# The aux-bearing families: the JAX package's sags, transcribed, and the
# laid-out row that ``cart_point`` and the kernels read
# ---------------------------------------------------------------------------

# A slot's row in a layout table: the recurrence constants (a, b, c, e),
# then the flag 4 |m| + 2 sin + pre
LAY_COLS = 5
# u^2 = (r^2 + Q2D_EPS) / p1^2 of a Q2d surface (the reference's rho floor)
Q2D_EPS = 1e-12


def _qbfs_consts(n):
    """(a, b, c, e) of the Qbfs slots: phi_0 = 2, phi_1 = (3 - 4v) phi_0,
    phi_k = (2 - 4v) phi_(k-1) - phi_(k-2), the basis that the Pn
    Clenshaw sum 2 (b_0 + b_1) expands to."""
    return ([(0.0, 0.0, 0.0, 2.0), (3.0, -4.0, 0.0, 0.0)]
            + [(2.0, -4.0, 1.0, 0.0)] * max(n - 2, 0))[:n]


def _q2d_consts(n, m):
    """(a, b, c, e) of the slots of a Q2d block of azimuthal order m >= 1:
    phi_0 = 1/2, phi_k = (a_(k-1) + b_(k-1) v) phi_(k-1) - c_(k-1)
    phi_(k-2) with the Clenshaw constants of order k - 1, so that
    sum_k d_k phi_k = alpha_0 / 2; for m = 1 past three terms e_3 = -2/5
    starts the - 2/5 alpha_3 correction in the same recurrence."""
    out = [(0.0, 0.0, 0.0, 0.5)]
    for k in range(1, n):
        a, b, c = forbes.abc_q2d_clenshaw(k - 1, m)
        e = -0.4 if (m == 1 and n - 1 > 2 and k == 3) else 0.0
        out.append((float(a), float(b), float(c) if k >= 2 else 0.0, e))
    return out


@functools.lru_cache(maxsize=None)
def aux_layout(code, aux, nc):
    """The laid-out row of an aux-bearing surface of padded width nc:
    (slots, T). ``slots`` holds per slot (a, b, c, e, m, sin, pre): its
    radial function phi_j(v) = (a + b v) phi_(j-1) - c phi_(j-2) + e
    (a = b = c = 0 where a block starts), times v (1 - v) where ``pre``,
    times Re (sin = 0) or Im (sin = 1) of ((x + iy) / p1)^m. T is the
    (slots, nc) numpy matrix that takes the surface's coefficient row to
    the slots' coefficients. Blocks come in order of m, cos before sin."""
    slots, rows = [], []

    def block(m, sin, pre, consts, T, cols):
        for j, (a, b, c, e) in enumerate(consts):
            slots.append((a, b, c, e, m, sin, pre))
            row = np.zeros(nc)
            for i, col in enumerate(cols):
                if col is not None:
                    row[col] += T[j, i]
            rows.append(row)

    if code == ZERNIKE_SAG:
        cls = ZERNIKE_CLASSES[(aux or ("standard",))[0]]
        idx = cls._generate_indices(nc)
        for am, sin in sorted({(abs(m), int(m < 0)) for _, m in idx}):
            terms = [(i, n, m) for i, (n, m) in enumerate(idx)
                     if (abs(m), int(m < 0)) == (am, sin)]
            J = max((n - am) // 2 for _, n, _ in terms) + 1
            T = np.zeros((J, len(terms)))
            for t, (_, n, m) in enumerate(terms):
                for p, cv in zip(*_radial_coeff_table(n, am)):
                    T[(p - am) // 2, t] += cv * cls._norm_constant(n, m)
            consts = [(0.0, 0.0, 0.0, 1.0)] + [(0.0, 1.0, 0.0, 0.0)] * (J - 1)
            block(am, sin, 0, consts, T, [i for i, _, _ in terms])
    elif code == FORBES_QBFS:
        n = int(aux[1])
        if n:
            block(0, 0, 1, _qbfs_consts(n), forbes.qbfs_basis_matrix(n),
                  list(range(n)))
    elif code == FORBES_Q2D:
        cm0, a_sl, b_sl = forbes.q2d_partition(aux[1])
        if cm0:
            block(0, 0, 1, _qbfs_consts(len(cm0)),
                  forbes.qbfs_basis_matrix(len(cm0)), cm0)
        for m in range(1, max([0, *a_sl, *b_sl]) + 1):
            for sin, sl in ((0, a_sl), (1, b_sl)):
                if m in sl:
                    n = len(sl[m])
                    block(m, sin, 0, _q2d_consts(n, m),
                          forbes.q2d_basis_matrix(n, m), sl[m])
    else:
        raise ValueError(f"geometry code {code} has no aux layout")
    T = np.stack(rows) if rows else np.zeros((0, nc))
    T.setflags(write=False)
    return tuple(slots), T


def layout_rows(slots, width):
    """A layout's rows of a layout table of ``width`` slots (LAY_COLS
    values each; the slots past the layout's are zero, which reads as
    phi = 0)."""
    rows = [(a, b, c, e, float(4 * m + 2 * sin + pre))
            for a, b, c, e, m, sin, pre in slots]
    return rows + [(0.0,) * LAY_COLS] * (width - len(rows))


def slots_of(rows):
    """The slots of a layout table's rows (``layout_rows``' inverse)."""
    out = []
    for a, b, c, e, f in rows:
        f = int(f)
        out.append((a, b, c, e, f // 4, (f // 2) % 2, f % 2))
    return tuple(out)


def aux_row(code, aux, coeffs):
    """(laid-out row, slots) of an aux-bearing surface's coefficient row:
    the linear map of ``aux_layout``, differentiable in ``coeffs``."""
    slots, T = aux_layout(code, aux, coeffs.shape[-1])
    return coeffs.new_tensor(T) @ coeffs, slots


def _sag_zernike(radius, conic, coeffs, p1, x, y, aux):
    r2 = x**2 + y**2
    z = _conic_sag(radius, conic, r2)
    zern = ZERNIKE_CLASSES[(aux or ("standard",))[0]](coeffs=coeffs)
    # the guarded origin: rho and phi with zero derivatives at r = 0
    at0 = r2 == 0
    rho = torch.where(at0, 0.0, torch.sqrt(torch.where(at0, 1.0, r2))) / p1
    phi = torch.atan2(y, torch.where(at0, 1.0, x))
    return z + zern.poly(rho, phi)


def _forbes_base_sag(radius, conic, r2):
    radius = torch.as_tensor(radius)
    sqrt_arg = 1 - (1 + conic) * r2 / radius**2
    safe = torch.sqrt(torch.where(sqrt_arg < 0, 0.0, sqrt_arg))
    z = r2 / (radius * (1 + safe))
    return torch.where(torch.isinf(radius), torch.zeros_like(r2), z)


def _forbes_conic_factor(radius, conic, r2):
    radius = torch.as_tensor(radius)
    c2 = torch.where(torch.isinf(radius), 0.0, 1.0 / radius**2)
    num = torch.clamp(1 - conic * c2 * r2, min=1e-12)
    den = torch.clamp(1 - (conic + 1) * c2 * r2, min=1e-12)
    return torch.sqrt(num) / torch.sqrt(den)


def _sag_forbes_qbfs(radius, conic, coeffs, p1, x, y, aux):
    r2 = x**2 + y**2
    usq = r2 / (p1 * p1)
    poly = forbes.clenshaw_qbfs([coeffs[i] for i in range(aux[1])], usq)
    dep = usq * (1 - usq) * _forbes_conic_factor(radius, conic, r2) * poly
    return (_forbes_base_sag(radius, conic, r2)
            + torch.where(usq > 1, 0.0, dep))


def _sag_forbes_q2d(radius, conic, coeffs, p1, x, y, aux):
    cm0, a_sl, b_sl = forbes.q2d_partition(aux[1])
    r2 = x**2 + y**2
    usq = (r2 + Q2D_EPS) / (p1 * p1)
    zero = torch.zeros_like(usq)

    def vals(sl):
        return [coeffs[i] if i is not None else 0.0 for i in sl]

    m0 = forbes.clenshaw_qbfs(vals(cm0), usq) if cm0 else zero
    gt0 = zero
    # u^m cos(m theta), u^m sin(m theta) by the (x + iy)^m recurrence
    c_m, s_m = torch.ones_like(usq), zero
    c1, s1 = x / p1, y / p1
    for m in range(1, max([0, *a_sl, *b_sl]) + 1):
        c_m, s_m = c_m * c1 - s_m * s1, s_m * c1 + c_m * s1
        sa = forbes.q2d_series_sum(vals(a_sl[m]), m, usq) if m in a_sl \
            else zero
        sb = forbes.q2d_series_sum(vals(b_sl[m]), m, usq) if m in b_sl \
            else zero
        gt0 = gt0 + c_m * sa + s_m * sb
    phi = _forbes_conic_factor(radius, conic, r2)
    dep = usq * (1 - usq) * phi * m0 + phi * gt0
    return (_forbes_base_sag(radius, conic, r2)
            + torch.where(usq > 1, 0.0, dep))


def _slot_terms(slots, p1, X, Y, eps, grad):
    """Per slot of a layout at (X, Y): (m, (A, Ax, Ay[, Axx, Axy, Ayy]),
    (F, F1[, F2])): A the slot's angular factor Re or Im of z^m, z = (X +
    iY) / p1, with its derivatives, and F its radial function (with the
    v (1 - v) factor where ``pre``) and F1, F2 its derivatives in v =
    (X^2 + Y^2 + eps) / p1^2."""
    v = (X * X + Y * Y + eps) / (p1 * p1)
    ip = 1.0 / p1
    zr, zi = X * ip, Y * ip
    zero = torch.zeros_like(X)
    P0, P1, P2 = (torch.ones_like(X), zero), (zero, zero), (zero, zero)
    mc = 0
    f1 = f2 = d1 = d2 = e1 = e2 = zero  # phi, phi', phi'' of j-1, j-2
    for a, b, c, e, m, sin, pre in slots:
        while mc < m:
            P2, P1 = P1, P0
            P0 = (P0[0] * zr - P0[1] * zi, P0[0] * zi + P0[1] * zr)
            mc += 1
        g = a + b * v
        ph = g * f1 - c * f2 + e
        dph = b * f1 + g * d1 - c * d2
        ddph = 2 * b * d1 + g * e1 - c * e2
        f1, f2, d1, d2, e1, e2 = ph, f1, dph, d1, ddph, e1
        if pre:
            w = v * (1 - v)
            F, F1 = w * ph, (1 - 2 * v) * ph + w * dph
            F2 = -2 * ph + 2 * (1 - 2 * v) * dph + w * ddph
        else:
            F, F1, F2 = ph, dph, ddph
        k1, k2 = m * ip, m * (m - 1) * ip * ip
        if sin:
            A = (P0[1], k1 * P1[1], k1 * P1[0], k2 * P2[1], k2 * P2[0],
                 -k2 * P2[1])
        else:
            A = (P0[0], k1 * P1[0], -k1 * P1[1], k2 * P2[0], -k2 * P2[1],
                 -k2 * P2[0])
        yield m, A if grad else A[:3], (F, F1, F2) if grad else (F, F1)


def _conic_factor_terms(cu, k, r2):
    """The Forbes conic factor Phi(r^2) = sqrt(num / den), num = max(1 - k
    cu^2 r^2, 1e-12), den = max(1 - (k + 1) cu^2 r^2, 1e-12), and its
    derivatives: (Phi, Phi_r, Phi_rr, Phi_k, Phi_rk, Phi_c, Phi_rc), r for
    r^2 and c for cu^2 (a clamped radicand passes no derivative)."""
    c2 = cu * cu
    nr, dr = 1 - k * c2 * r2, 1 - (k + 1) * c2 * r2
    mn, md = (nr > 1e-12).to(r2.dtype), (dr > 1e-12).to(r2.dtype)
    num, den = torch.clamp(nr, min=1e-12), torch.clamp(dr, min=1e-12)
    Phi = torch.sqrt(num) / torch.sqrt(den)
    n_r, d_r = -k * c2 * mn, -(k + 1) * c2 * md
    a, b = n_r / num, d_r / den
    g = (a - b) / 2
    out = [Phi, Phi * g, Phi * (g * g + (b * b - a * a) / 2)]
    for n_v, d_v, n_rv, d_rv in ((-c2 * r2 * mn, -c2 * r2 * md, -c2 * mn,
                                  -c2 * md),
                                 (-k * r2 * mn, -(k + 1) * r2 * md, -k * mn,
                                  -(k + 1) * md)):
        gv = (n_v / num - d_v / den) / 2
        g_v = (n_rv / num - a * n_v / num - d_rv / den + b * d_v / den) / 2
        out += [Phi * gv, Phi * (gv * g + g_v)]
    return out


def _aux_point(code, radius, conic, q, p1, slots, X, Y, grad):
    """``cart_point`` of an aux-bearing family: ``q`` the laid-out row,
    ``slots`` its layout."""
    zern = code == ZERNIKE_SAG
    zero = torch.zeros_like(X)
    r2 = X * X + Y * Y
    # the base conic: the curvature form (ZERNIKE_SAG) or Forbes' clamped
    # root, whose slopes are 0 inf = NaN where it clamps (as JAX's AD)
    cu = 1.0 / radius if zern else _inv_radius(radius)
    e = (1 + conic) * cu**2
    vq = 1 - e * r2
    q0 = torch.sqrt(vq if zern else torch.clamp(vq, min=0.0))
    W = cu / q0
    if not zern:
        W = torch.where(q0 == 0, float("nan"), W)
    eps = Q2D_EPS if code == FORBES_Q2D else 0.0
    sums = ("S", "Sx", "Sy") + (("Sxx", "Sxy", "Syy", "Sp", "Sxp", "Syp")
                               if grad else ())
    o = dict.fromkeys(sums, zero)
    v = (r2 + eps) / (p1 * p1)
    vx, vy, vxx = 2 * X / (p1 * p1), 2 * Y / (p1 * p1), 2 / (p1 * p1)
    for j, (m, A, F) in enumerate(_slot_terms(slots, p1, X, Y, eps, grad)):
        c = q[j]
        o["S"] = o["S"] + c * (A[0] * F[0])
        o["Sx"] = o["Sx"] + c * (A[1] * F[0] + A[0] * F[1] * vx)
        o["Sy"] = o["Sy"] + c * (A[2] * F[0] + A[0] * F[1] * vy)
        if grad:
            o["Sxx"] = o["Sxx"] + c * (A[3] * F[0] + 2 * A[1] * F[1] * vx
                                       + A[0] * F[2] * vx * vx
                                       + A[0] * F[1] * vxx)
            o["Sxy"] = o["Sxy"] + c * (A[4] * F[0] + A[1] * F[1] * vy
                                       + A[2] * F[1] * vx
                                       + A[0] * F[2] * vx * vy)
            o["Syy"] = o["Syy"] + c * (A[5] * F[0] + 2 * A[2] * F[1] * vy
                                       + A[0] * F[2] * vy * vy
                                       + A[0] * F[1] * vxx)
            o["Sp"] = o["Sp"] - c * (m * A[0] * F[0]
                                     + 2 * v * A[0] * F[1]) / p1
            for key, Ad, vd in (("Sxp", A[1], vx), ("Syp", A[2], vy)):
                o[key] = o[key] - c * (m * Ad * F[0] + 2 * v * Ad * F[1]
                                       + m * A[0] * F[1] * vd
                                       + 2 * v * A[0] * F[2] * vd
                                       + 2 * A[0] * F[1] * vd) / p1
    if zern:
        # the reference's guarded origin: no Zernike slope at r = 0
        at0 = r2 == 0
        for key in sums[1:]:
            if key != "Sp":
                o[key] = torch.where(at0, 0.0, o[key])
        ph = (torch.ones_like(X),) + (zero,) * 6
        keep = torch.ones_like(X)
    else:
        ph = _conic_factor_terms(cu, conic, r2)
        keep = (v <= 1).to(X.dtype)
    Phi, Pr, Prr, Pk, Prk, Pc, Prc = (keep * t for t in ph)
    S, Sx, Sy = o["S"], o["Sx"], o["Sy"]
    out = SimpleNamespace(
        s=cu * r2 / (1 + q0) + Phi * S,
        sx=X * W + 2 * X * Pr * S + Phi * Sx,
        sy=Y * W + 2 * Y * Pr * S + Phi * Sy)
    if not grad:
        return out
    # the coefficient weights (coef_weights): of s, then of the slopes
    out.zy = (Phi, 2 * X * Pr, 2 * Y * Pr,
              torch.where(r2 == 0, 0.0, Phi) if zern else Phi)
    Wr = cu * e / (2 * q0**3)
    out.hxx = (W + 2 * X * X * Wr + 2 * Pr * S + 4 * X * X * Prr * S
               + 4 * X * Pr * Sx + Phi * o["Sxx"])
    out.hxy = (2 * X * Y * Wr + 4 * X * Y * Prr * S + 2 * X * Pr * Sy
               + 2 * Y * Pr * Sx + Phi * o["Sxy"])
    out.hyx = out.hxy
    out.hyy = (W + 2 * Y * Y * Wr + 2 * Pr * S + 4 * Y * Y * Prr * S
               + 4 * Y * Pr * Sy + Phi * o["Syy"])
    mcu2 = -cu * cu  # d cu / dR
    dc2 = 2 * cu * mcu2  # d cu^2 / dR
    out.dR = (mcu2 * r2 / (q0 * (1 + q0)) + dc2 * Pc * S,
              mcu2 * X / q0**3 + dc2 * (2 * X * Prc * S + Pc * Sx),
              mcu2 * Y / q0**3 + dc2 * (2 * Y * Prc * S + Pc * Sy))
    Wk = cu**3 * r2 / (2 * q0**3)
    out.dk = (cu**3 * r2**2 / (2 * q0 * (1 + q0) ** 2) + Pk * S,
              X * Wk + 2 * X * Prk * S + Pk * Sx,
              Y * Wk + 2 * Y * Prk * S + Pk * Sy)
    Sp = o["Sp"]
    out.dp1 = (Phi * Sp, 2 * X * Pr * Sp + Phi * o["Sxp"],
               2 * Y * Pr * Sp + Phi * o["Syp"])
    out.dp2 = (zero, zero, zero)
    return out


def cart_point(code, radius, conic, coeffs, p1, p2, X, Y, grad=False,
               normal=False, lay=None):
    """A Cartesian family's sag and slopes at (X, Y): s, sx, sy. With
    ``normal`` the slopes are those of the normal (CHEBYSHEV's reference
    convention; the true slopes for the others). With ``grad`` also what
    the hand adjoints read: the slopes' derivatives hxx = d sx/dX, hxy =
    d sx/dY, hyx = d sy/dX, hyy = d sy/dY, and the triples (d s, d sx,
    d sy) with respect to the radius (dR), the conic (dk), p1 (dp1) and p2
    (dp2); TOROIDAL adds zy = (ds, dsx, dsy, dsy') of its profile z_y and
    of z_y' (what its coefficients reach), an aux-bearing family the
    weights of ``coef_weights``. An aux-bearing family reads ``coeffs``
    as its laid-out row and ``lay`` as its slots (``aux_row``)."""
    if code in AUX_CODES:
        return _aux_point(code, radius, conic, coeffs, p1, lay, X, Y, grad)
    zero = torch.zeros_like(X)
    if code in (POLYNOMIAL_XY, CHEBYSHEV):
        cu = 1.0 / radius
        e = (1 + conic) * cu**2
        r2 = X**2 + Y**2
        q = torch.sqrt(1 - e * r2)
        W = cu / q
        t = _table_sums(code, coeffs, p1, p2, X, Y, grad, normal)
        o = SimpleNamespace(s=cu * r2 / (1 + q) + t["P"], sx=X * W + t["Px"],
                            sy=Y * W + t["Py"])
        if not grad:
            return o
        Wr = cu * e / (2 * q**3)
        o.hxx = W + 2 * X * X * Wr + t["Pxx"]
        o.hxy = 2 * X * Y * Wr + t["Pxy"]
        o.hyx = 2 * X * Y * Wr + t["Pyx"]
        o.hyy = W + 2 * Y * Y * Wr + t["Pyy"]
        mcu2 = -cu * cu  # d cu / dR
        o.dR = (mcu2 * r2 / (q * (1 + q)), mcu2 * X / q**3, mcu2 * Y / q**3)
        Wk = cu**3 * r2 / (2 * q**3)
        o.dk = (cu**3 * r2**2 / (2 * q * (1 + q) ** 2), X * Wk, Y * Wk)
        o.dp1 = (t["Pp1"], t["Pxp1"], t["Pyp1"])
        o.dp2 = (t["Pp2"], t["Pxp2"], t["Pyp2"])
        return o
    if code == BICONIC:
        cx, cy = _inv_radius(radius), _inv_radius(p1)
        qx = torch.sqrt(torch.clamp(1 - (1 + conic) * cx**2 * X**2, min=0.0))
        qy = torch.sqrt(torch.clamp(1 - (1 + p2) * cy**2 * Y**2, min=0.0))
        clamped = (qx == 0) | (qy == 0)
        o = SimpleNamespace(
            s=cx * X**2 / (1 + qx) + cy * Y**2 / (1 + qy),
            sx=torch.where(clamped, float("nan"), cx * X / qx),
            sy=torch.where(clamped, float("nan"), cy * Y / qy))
        if not grad:
            return o
        o.hxx, o.hxy, o.hyx, o.hyy = cx / qx**3, zero, zero, cy / qy**3
        mcx2, mcy2 = -cx * cx, -cy * cy
        o.dR = (mcx2 * X**2 / (qx * (1 + qx)), mcx2 * X / qx**3, zero)
        o.dk = (cx**3 * X**4 / (2 * qx * (1 + qx) ** 2),
                X * cx**3 * X**2 / (2 * qx**3), zero)
        o.dp1 = (mcy2 * Y**2 / (qy * (1 + qy)), zero, mcy2 * Y / qy**3)
        o.dp2 = (cy**3 * Y**4 / (2 * qy * (1 + qy) ** 2), zero,
                 Y * cy**3 * Y**2 / (2 * qy**3))
        return o
    if code != TOROIDAL:
        raise _unsupported(code)
    # the profile z_y(Y), its derivatives, and theirs in cy, p2
    cy = _inv_radius(p1)
    Y2 = Y * Y
    qy = torch.sqrt(torch.clamp(1 - (1 + p2) * cy**2 * Y2, min=0.0))
    A = torch.zeros_like(Y)
    A1 = torch.zeros_like(Y)
    A2 = torch.zeros_like(Y)
    for i in range(coeffs.shape[-1] - 1, -1, -1):
        A = A * Y2 + coeffs[i]
        A1 = A1 * Y2 + (2 * i + 2) * coeffs[i]
        A2 = A2 * Y2 + (2 * i + 2) * (2 * i + 1) * coeffs[i]
    zy = cy * Y2 / (1 + qy) + A * Y2
    zy1 = torch.where(qy == 0, float("nan"), cy * Y / qy) + A1 * Y
    R = torch.as_tensor(radius, dtype=X.dtype, device=X.device)
    cyl = torch.isinf(R)
    D = R - zy
    inside = D**2 - X**2
    sq = torch.sqrt(torch.where(inside < 0, float("nan"), inside))
    sg = torch.sign(D)
    G = sg * D / sq
    sxv = sg * X / sq
    o = SimpleNamespace(
        s=torch.where(cyl, zy, zy + D - sg * sq),
        sx=torch.where(qy == 0, float("nan"), torch.where(cyl, 0.0, sxv)),
        sy=torch.where(cyl, zy1, G * zy1))
    if not grad:
        return o
    zy2 = cy / qy**3 + A2
    sq3 = sq**3
    o.zy = (G, sg * X * D / sq3, sg * X * X * zy1 / sq3, G)
    o.hxx = sg * D * D / sq3
    o.hxy = o.hyx = sg * X * D * zy1 / sq3
    o.hyy = zy2 * G + sg * X * X * zy1 * zy1 / sq3
    o.dR = (1 - G, -o.zy[1], -o.zy[2])
    o.dk = (zero, zero, zero)
    # through z_y: d/dcy, then dcy/dp1 = -cy^2; d/dp2
    zy_cy, zy1_cy = Y2 / (qy * (1 + qy)), Y / qy**3
    zy_p2 = cy**3 * Y2**2 / (2 * qy * (1 + qy) ** 2)
    zy1_p2 = Y * cy**3 * Y2 / (2 * qy**3)
    mcy2 = -cy * cy
    o.dp1 = tuple(mcy2 * v for v in (
        o.zy[0] * zy_cy, o.zy[1] * zy_cy, o.zy[2] * zy_cy + o.zy[3] * zy1_cy))
    o.dp2 = (o.zy[0] * zy_p2, o.zy[1] * zy_p2,
             o.zy[2] * zy_p2 + o.zy[3] * zy1_p2)
    # a cylinder: the JAX package's branch not taken gives 0 inf = NaN in
    # every derivative that reaches R or z_y
    nan = torch.full_like(X, float("nan"))
    if bool(cyl):
        o.zy = (nan,) * 4
        o.hxx = o.hxy = o.hyx = o.hyy = nan
        o.dR = o.dp1 = o.dp2 = (nan,) * 3
    return o


def cart_reads(code):
    """(conic, p1, p2): whether a Cartesian family's sag reads them beyond
    the Newton start. The JAX package gives a parameter the sag does not
    read no cotangent at all, not 0 x a NaN one, so the adjoints give it
    none either (POLYNOMIAL_XY reads no p1, p2; TOROIDAL no conic; the
    aux-bearing families no p2)."""
    return (code != TOROIDAL, code != POLYNOMIAL_XY,
            code != POLYNOMIAL_XY and code not in AUX_CODES)


def coef_weights(code, pt, g_s, g_sx, g_sy):
    """The per-ray weights (a, b, c) of a Cartesian family's coefficient
    cotangents at a point, from the cotangents of its s, sx and sy
    (``coef_columns`` expands them): the cotangents themselves for the
    coefficient tables, those of z_y and z_y' for TOROIDAL, none for
    BICONIC; for an aux-bearing family those of the slots' departure
    (the Forbes factor and cut folded in, ``pt.zy``)."""
    if code in AUX_CODES:
        z0, z1, z2, z3 = pt.zy
        return g_s * z0 + g_sx * z1 + g_sy * z2, g_sx * z3, g_sy * z3
    if code == TOROIDAL:
        zs, zx, zy, zyp = pt.zy
        return g_s * zs + g_sx * zx + g_sy * zy, g_sy * zyp, 0.0 * g_s
    if code == BICONIC:
        return 0.0 * g_s, 0.0 * g_s, 0.0 * g_s
    return g_s, g_sx, g_sy


def coef_columns(code, nc, p1, p2, Xs, Ys, ws, X1, Y1, w1, lay=None):
    """The nc per-ray coefficient cotangents of a Cartesian surface from
    its weights ``ws`` = (a, b, c) at the Newton point (Xs, Ys) and ``w1``
    at the normal's point (X1, Y1): column (i, j) of a table takes
    a phi + b d phi/dx + c d phi/dy there (at (X1, Y1) the normal's basis,
    CHEBYSHEV's reference convention); TOROIDAL's column i takes
    a y^(2i+2) + b (2i+2) y^(2i+1) at each point; BICONIC has none; the
    slot j of an aux-bearing family's laid-out row (its layout ``lay``)
    a psi_j + b d psi_j/dx + c d psi_j/dy, psi_j the slot's function."""
    cols = [torch.zeros_like(Xs) for _ in range(nc)]
    if code == BICONIC:
        return cols
    if code in AUX_CODES:
        eps = Q2D_EPS if code == FORBES_Q2D else 0.0
        for X, Y, (a, b, c) in ((Xs, Ys, ws), (X1, Y1, w1)):
            vx, vy = 2 * X / (p1 * p1), 2 * Y / (p1 * p1)
            for j, (_, A, F) in enumerate(_slot_terms(lay, p1, X, Y, eps,
                                                      False)):
                cols[j] = cols[j] + (a * (A[0] * F[0])
                                     + b * (A[1] * F[0] + A[0] * F[1] * vx)
                                     + c * (A[2] * F[0] + A[0] * F[1] * vy))
        return cols
    if code == TOROIDAL:
        for Y, (a, b, _) in ((Ys, ws), (Y1, w1)):
            pw = Y
            for i in range(nc):
                cols[i] = cols[i] + (a * pw * Y + b * (2 * i + 2) * pw)
                pw = pw * (Y * Y)
        return cols
    side = table_side(nc)
    for X, Y, (a, b, c), normal in ((Xs, Ys, ws, False), (X1, Y1, w1, True)):
        nx = normal and code == CHEBYSHEV
        bx = _basis_1d(code, X, p1, side, nx)
        by = _basis_1d(code, Y, p2, side, nx)
        dx, dy = (bx.g, by.g) if nx else (bx.f1, by.f1)
        for idx in range(nc):
            i, j = divmod(idx, side)
            cols[idx] = cols[idx] + (a * (bx.f[i] * by.f[j])
                                     + b * (dx[i] * by.f[j])
                                     + c * (bx.f[i] * dy[j]))
    return cols


def sag_static(code: int, radius, conic, coeffs, x, y, p1=1.0, p2=1.0,
               aux=None):
    """Surface sag at local coordinates (x, y); ``aux`` the surface's
    static extras (the aux-bearing families')."""
    if code == PLANE:
        return torch.zeros_like(x)
    if code == STANDARD:
        return _conic_sag(radius, conic, x**2 + y**2)
    if code in RADIAL_CODES:
        return sag_point(code, radius, conic, coeffs, x**2 + y**2)[0]
    if code == POLYNOMIAL_XY:
        return _sag_polynomial_xy(radius, conic, coeffs, x, y)
    if code == CHEBYSHEV:
        return _sag_chebyshev(radius, conic, coeffs, p1, p2, x, y)
    if code == TOROIDAL:
        return _sag_toroidal(radius, conic, coeffs, p1, p2, x, y)
    if code == BICONIC:
        return _sag_biconic(radius, conic, coeffs, p1, p2, x, y)
    if code == ZERNIKE_SAG:
        return _sag_zernike(radius, conic, coeffs, p1, x, y, aux)
    if code == FORBES_QBFS:
        return _sag_forbes_qbfs(radius, conic, coeffs, p1, x, y, aux)
    if code == FORBES_Q2D:
        return _sag_forbes_q2d(radius, conic, coeffs, p1, x, y, aux)
    if code == NURBS:
        return nurbs.sag(coeffs, aux, x, y)
    raise _unsupported(code)


def _normal_newton(code, radius, conic, coeffs, x, y, p1, p2, lay=None):
    """The sag's derivative (x W, y W) of a radial family, (sx, sy) of a
    Cartesian one (CHEBYSHEV's reference convention), normalized in the
    rsqrt form (CHEBYSHEV: 1 / sqrt, as the reference)."""
    if code in RADIAL_CODES:
        _, W = sag_point(code, radius, conic, coeffs, x**2 + y**2)
        dfdx, dfdy = x * W, y * W
    else:
        pt = cart_point(code, radius, conic, coeffs, p1, p2, x, y,
                        normal=True, lay=lay)
        dfdx, dfdy = pt.sx, pt.sy
    if code == CHEBYSHEV:
        inv_mag = 1.0 / torch.sqrt(dfdx**2 + dfdy**2 + 1)
    else:
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


def _laid_out(code, coeffs, aux, lay):
    """(row, slots) that ``cart_point`` reads: an aux-bearing family's row
    laid out by ``aux`` unless ``lay`` (the slots of a row already laid
    out) is given; other families' rows as they are."""
    if code in AUX_CODES and lay is None:
        return aux_row(code, aux, coeffs)
    return coeffs, lay


def surface_normal_static(code: int, radius, conic, coeffs, x, y, p1=1.0,
                          p2=1.0, aux=None, lay=None):
    """Unit surface normal at local (x, y), pointing toward -z at the
    vertex. An aux-bearing family takes its static extras ``aux``, or its
    laid-out row as ``coeffs`` and its slots as ``lay``."""
    if code == PLANE:
        return _normal_plane(x)
    if code == STANDARD:
        return _normal_standard(radius, conic, x, y)
    if code in NEWTON_CODES:
        coeffs, lay = _laid_out(code, coeffs, aux, lay)
        return _normal_newton(code, radius, conic, coeffs, x, y, p1, p2, lay)
    if code == NURBS:
        return nurbs.surface_normal(coeffs, aux, x, y)
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


def newton_step(code, radius, conic, coeffs, x, y, z, L, M, N, t, p1=1.0,
                p2=1.0, lay=None):
    """One Newton step t - f/f' on f(t) = z + t N - s(x + t L, y + t M),
    with f' = N - (s_x L + s_y M) clamped to 1e-14 where |f'| <= 1e-14 (a
    radial family's s_x = X W, s_y = Y W)."""
    X, Y = x + t * L, y + t * M
    if code in RADIAL_CODES:
        s, W = sag_point(code, radius, conic, coeffs, X**2 + Y**2)
        dfdt = N - W * (X * L + Y * M)
    else:
        pt = cart_point(code, radius, conic, coeffs, p1, p2, X, Y, lay=lay)
        s = pt.s
        dfdt = N - (pt.sx * L + pt.sy * M)
    f = z + t * N - s
    dfdt = torch.where(dfdt.abs() > 1e-14, dfdt, 1e-14)
    return t - f / dfdt


def newton_start(radius, conic, x, y, z, L, M, N):
    """Newton's first guess: the conic's closed form, or the plane's where
    that is not finite."""
    t0 = _distance_standard(radius, conic, x, y, z, L, M, N)
    return torch.where(torch.isfinite(t0), t0,
                       _distance_plane(x, y, z, L, M, N))


def newton_stopped(code, radius, conic, coeffs, x, y, z, L, M, N,
                   newton_iters=NEWTON_ITERS, p1=1.0, p2=1.0, lay=None):
    """The stopped iterate of a Newton family: ``newton_iters`` steps from
    ``newton_start`` without a gradient (``coeffs`` and ``lay`` as
    ``cart_point`` reads them)."""
    with torch.no_grad():
        t = newton_start(radius, conic, x, y, z, L, M, N)
        for _ in range(newton_iters):
            t = newton_step(code, radius, conic, coeffs, x, y, z, L, M, N, t,
                            p1, p2, lay)
    return t


def distance_static(code: int, radius, conic, x, y, z, L, M, N, coeffs=None,
                    newton_iters=NEWTON_ITERS, p1=1.0, p2=1.0, aux=None,
                    lay=None, stopped=False):
    """Ray parameter t to the surface in its local frame. The Newton
    families take ``newton_iters`` steps from ``newton_start`` (the
    surface's radius and conic) without a gradient, then one
    differentiable step: the implicit-function gradient dt/dtheta =
    -f_theta / f_t (plus the f f'_theta / f'^2 term of that step), as the
    JAX package forms it. ``aux`` and ``lay`` as in
    ``surface_normal_static``. With ``stopped``: (t, the stopped iterate
    ``newton_stopped``, None for a family that takes no Newton step)."""
    t_s = None
    if code == PLANE:
        t = _distance_plane(x, y, z, L, M, N)
    elif code == STANDARD:
        t = _distance_standard(radius, conic, x, y, z, L, M, N)
    elif code == NURBS:
        t = nurbs.distance(coeffs, aux, x, y, z, L, M, N)
    elif code not in NEWTON_CODES:
        raise _unsupported(code)
    else:
        coeffs, lay = _laid_out(code, coeffs, aux, lay)
        t_s = newton_stopped(code, radius, conic, coeffs, x, y, z, L, M, N,
                             newton_iters, p1, p2, lay)
        t = newton_step(code, radius, conic, coeffs, x, y, z, L, M, N, t_s,
                        p1, p2, lay)
    return (t, t_s) if stopped else t
