"""NURBS / B-spline / Bezier surfaces: Cox-de Boor basis values with their
first and second derivatives, the rational net's point and tangents, the
two-plane (u, v) Newton solve of the ray intersection, and the build-time
conic fit.

Counterpart of ``optiland_tpu/core/nurbs.py``. Knot vectors and degrees are
static (a surface's ``geom_aux``: ``("nurbs", nu, nv, p, q, u_knots,
v_knots)``), so the basis recurrence unrolls into elementwise torch ops;
the control points and weights are the surface's coefficient row, flat
``[P.ravel(), W.ravel()]`` (P of shape (3, nu, nv), W of (nu, nv)), and
stay differentiable. The derivatives of the basis are written by hand:
``basis_ders`` carries the recurrence forward in u (what the JAX package's
``jax.jvp`` of ``basis_list`` forms), to second order for the kernels'
hand adjoint (``ops/step.py``). The fitting code is numpy, copied from the
JAX package (The NURBS Book A9.7).

The solve (``_newton_uv``) runs a fixed count of clipped 2x2 Newton steps
without a gradient, then one more from the stopped point through which
autograd runs: the implicit-function gradient of the JAX package, with
``.detach()`` for its ``stop_gradient``. The clip to [0, 1]^2 is
``minimum(maximum(., 0), 1)``, whose derivative at exactly 0 or 1 is 1/2,
as ``jnp.clip``'s. The plain engine takes ``_uv_iters`` steps (12 in
float32, 24 in float64, the JAX package's XLA path); the kernels and their
plain versions take ``newton_iters`` (``intersect(..., iters=)``).
"""

from __future__ import annotations

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Runtime basis evaluation (torch; static knots/degree)
# ---------------------------------------------------------------------------


def basis_list(knots: tuple, n: int, p: int, u):
    """Cox-de Boor basis values N_{i,p}(u), i = 0..n, as a list of tensors
    shaped like ``u``; at u equal to the last knot the n-th degree-0
    indicator is 1, as in the JAX package."""
    return basis_ders(knots, n, p, u, order=0)[0]


def basis_ders(knots: tuple, n: int, p: int, u, order: int = 1):
    """[N, dN/du, ...]: the basis values and their first ``order``
    derivatives (0 to 2), each a list of n + 1 tensors, from the recurrence
    differentiated forward: with a = (u - U_i) / (U_{i+k} - U_i) and
    c = (U_{i+k+1} - u) / (U_{i+k+1} - U_{i+1}) (0 where the span is
    empty), N_{i,k} = a N_{i,k-1} + c N_{i+1,k-1}, its derivative
    a' N + a N' + c' N_+ + c N'_+, and the second 2 a' N' + a N'' +
    2 c' N'_+ + c N''_+."""
    U = knots
    m = n + p + 1
    zero = torch.zeros_like(u)
    one = torch.ones_like(u)
    N = []
    for i in range(m):
        ind = torch.where((u >= U[i]) & (u < U[i + 1]), one, zero)
        if i == n:
            ind = ind + torch.where(u == U[-1], one, zero)
        N.append(ind)
    ders = [N] + [[zero] * m for _ in range(order)]
    for k in range(1, p + 1):
        m = m - 1
        nxt = [[] for _ in range(order + 1)]
        for i in range(m):
            d1 = U[i + k] - U[i]
            d2 = U[i + k + 1] - U[i + 1]
            a = (u - U[i]) / d1 if d1 != 0 else None
            c = (U[i + k + 1] - u) / d2 if d2 != 0 else None
            da = 1.0 / d1 if d1 != 0 else 0.0
            dc = -1.0 / d2 if d2 != 0 else 0.0
            for o in range(order + 1):
                v = zero
                lo, hi = ders[o][i], ders[o][i + 1]
                if a is not None:
                    v = a * lo
                    if o:
                        v = v + o * da * ders[o - 1][i]
                if c is not None:
                    v = v + c * hi
                    if o:
                        v = v + o * dc * ders[o - 1][i + 1]
                nxt[o].append(v)
        ders = nxt
    return [d[: n + 1] for d in ders]


def basis_matrix(knots: tuple, n: int, p: int, u):
    """(n+1, Q) basis values N_{i,p}(u) via Cox-de Boor."""
    return torch.stack(basis_list(knots, n, p, u))


def unpack_pw(coeffs, aux):
    """Split the flat coefficient row into (P, W)."""
    _, nu, nv, _, _, _, _ = aux
    P = coeffs[: 3 * nu * nv].reshape(3, nu, nv)
    W = coeffs[3 * nu * nv: 4 * nu * nv].reshape(nu, nv)
    return P, W


def homogeneous(P, W, aux, u, v, order=1):
    """The homogeneous sums of the net at (u, v): a dict of (H, w) pairs,
    H the (3, Q) sum of N_i(u) N_j(v) W_ij P_ij and w that of N_i N_j W_ij,
    under "" and, with ``order`` >= 1, their u- and v-derivatives "u",
    "v", with ``order`` 2 also "uu", "uv", "vv"."""
    _, nu, nv, p, q, uk, vk = aux
    Bu = [torch.stack(b) for b in basis_ders(uk, nu - 1, p, u, order)]
    Bv = [torch.stack(b) for b in basis_ders(vk, nv - 1, q, v, order)]
    Pw = P * W[None]
    pairs = {"": (0, 0)}
    if order >= 1:
        pairs.update(u=(1, 0), v=(0, 1))
    if order >= 2:
        pairs.update(uu=(2, 0), uv=(1, 1), vv=(0, 2))
    out = {}
    for name, (a, b) in pairs.items():
        A = torch.einsum("ij,jQ->iQ", W, Bv[b])
        Ah = torch.einsum("dij,jQ->diQ", Pw, Bv[b])
        out[name] = (torch.einsum("diQ,iQ->dQ", Ah, Bu[a]),
                     torch.einsum("iQ,iQ->Q", A, Bu[a]))
    return out


def rational(h):
    """The surface point S and, where ``h`` has them, its derivatives, from
    the homogeneous sums of ``homogeneous``: S = H / w (w = 1 where it is
    0, as in the JAX package), S_u = (H_u - S w_u) / w, S_uu = (H_uu -
    2 S_u w_u - S w_uu) / w, S_uv = (H_uv - S_u w_v - S_v w_u - S w_uv) /
    w."""
    H, w = h[""]
    w = torch.where(w == 0, 1.0, w)
    out = {"": H / w}
    S = out[""]
    for d in ("u", "v"):
        if d in h:
            Hd, wd = h[d]
            out[d] = (Hd - S * wd) / w
    for d, (a, b) in (("uu", ("u", "u")), ("uv", ("u", "v")),
                      ("vv", ("v", "v"))):
        if d in h:
            Hd, wd = h[d]
            out[d] = (Hd - out[a] * h[b][1] - out[b] * h[a][1] - S * wd) / w
    return out, w


def nurbs_eval(P, W, aux, u, v):
    """Evaluate the surface at parameters (u, v): returns (3, Q)
    coordinates."""
    return rational(homogeneous(P, W, aux, u, v, order=0))[0][""]


def _param_guess(P, x, y):
    """Initial (u, v) from the control net's x/y bounding box (the net is a
    regular x-major grid for fitted and sample-constructed surfaces)."""
    x0, x1 = P[0, 0, 0], P[0, -1, -1]
    y0, y1 = P[1, 0, 0], P[1, -1, -1]
    u0 = (x - x0) / torch.where(x1 - x0 == 0, 1.0, x1 - x0)
    v0 = (y - y0) / torch.where(y1 - y0 == 0, 1.0, y1 - y0)
    return clip01(u0), clip01(v0)


def clip01(u):
    """u clipped to [0, 1] with ``jnp.clip``'s derivative (1/2 at exactly
    0 or 1)."""
    return torch.minimum(torch.maximum(u, torch.zeros_like(u)),
                         torch.ones_like(u))


def _uv_iters(dtype) -> int:
    """Parameter-space Newton iteration count of the plain engine by dtype
    (the JAX package's XLA path): 12 in float32, 24 in float64."""
    return 12 if dtype == torch.float32 else 24


def _newton_uv(residual_fn, u, v, iters: int | None = None):
    """Fixed-count clipped 2x2 Newton on (u, v) in [0, 1]^2.

    ``residual_fn(u, v)`` returns the residual pair and its Jacobian,
    ((f1, f2), (f1_u, f2_u), (f1_v, f2_v)). ``iters`` steps run without a
    gradient; then one step from the stopped point, through which autograd
    runs (the implicit-function gradient, residual terms included)."""
    if iters is None:
        iters = _uv_iters(u.dtype)
    with torch.no_grad():
        for _ in range(iters):
            u, v = _uv_step(residual_fn, u, v)
    return _uv_step(residual_fn, u.detach(), v.detach())


def _uv_step(residual_fn, u, v):
    """One clipped 2x2 Newton step, |det| < 1e-14 clamped to 1e-14."""
    (f1, f2), (f1u, f2u), (f1v, f2v) = residual_fn(u, v)
    det = f1u * f2v - f1v * f2u
    det = torch.where(det.abs() < 1e-14, 1e-14, det)
    du = (f1 * f2v - f2 * f1v) / det
    dv = (f2 * f1u - f1 * f2u) / det
    return clip01(u - du), clip01(v - dv)


def _planes(x, y, z, L, M, N):
    """The two planes whose intersection line is the ray (Martin et al.):
    normals N1, N2 and offsets d1, d2; the first is chosen by
    L > M and L > N."""
    mask = (L > M) & (L > N)
    hyp1 = torch.sqrt(L * L + M * M)
    hyp2 = torch.sqrt(N * N + M * M)
    hyp1 = torch.where(hyp1 == 0, 1.0, hyp1)
    hyp2 = torch.where(hyp2 == 0, 1.0, hyp2)
    N1x = torch.where(mask, M / hyp1, 0.0)
    N1y = torch.where(mask, -L / hyp1, N / hyp2)
    N1z = torch.where(mask, 0.0, -M / hyp2)
    N2x = N1y * N - N1z * M
    N2y = N1z * L - N1x * N
    N2z = N1x * M - N1y * L
    d1 = -(N1x * x + N1y * y + N1z * z)
    d2 = -(N2x * x + N2y * y + N2z * z)
    return (N1x, N1y, N1z), (N2x, N2y, N2z), d1, d2


def plane_residual(P, W, aux, N1, N2, d1, d2):
    """The residual of the two-plane solve, f_k = N_k . S(u, v) + d_k, as
    ``_newton_uv`` takes it (with its Jacobian)."""

    def residual(u, v):
        S = rational(homogeneous(P, W, aux, u, v))[0]
        return ((dot3(N1, S[""]) + d1, dot3(N2, S[""]) + d2),
                (dot3(N1, S["u"]), dot3(N2, S["u"])),
                (dot3(N1, S["v"]), dot3(N2, S["v"])))

    return residual


def dot3(a, b):
    """a . b of two 3-vectors given as triples."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    """a x b of two 3-vectors given as triples."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _unit_normal(Su, Sv):
    """The unit normal Su x Sv / |.| (|.| = 1 where it is 0), oriented
    toward -z at the vertex."""
    nx, ny, nz = cross3(Su, Sv)
    mag = torch.sqrt(nx * nx + ny * ny + nz * nz)
    mag = torch.where(mag == 0, 1.0, mag)
    nx, ny, nz = nx / mag, ny / mag, nz / mag
    flip = torch.sign(torch.where(nz == 0, 1.0, -nz))
    return nx * flip, ny * flip, nz * flip


def _xy_solve(P, W, aux, x, y):
    """(u, v) of the surface point whose (x, y) is the query."""

    def residual(u, v):
        S = rational(homogeneous(P, W, aux, u, v))[0]
        return ((S[""][0] - x, S[""][1] - y), (S["u"][0], S["u"][1]),
                (S["v"][0], S["v"][1]))

    u0, v0 = _param_guess(P, x, y)
    return _newton_uv(residual, u0, v0)


def sag(coeffs, aux, x, y):
    """Sag: z of the surface point whose (x, y) matches the query."""
    P, W = unpack_pw(coeffs, aux)
    x = torch.atleast_1d(x)
    y = torch.atleast_1d(y)
    u, v = _xy_solve(P, W, aux, x, y)
    return nurbs_eval(P, W, aux, u, v)[2]


def surface_normal(coeffs, aux, x, y):
    """Unit normal from the cross product of the parametric tangents at
    the point whose (x, y) is the query."""
    P, W = unpack_pw(coeffs, aux)
    x = torch.atleast_1d(x)
    y = torch.atleast_1d(y)
    u, v = _xy_solve(P, W, aux, x, y)
    S = rational(homogeneous(P, W, aux, u, v))[0]
    return _unit_normal(S["u"], S["v"])


def intersect(coeffs, aux, x, y, z, L, M, N, iters=None):
    """Ray-surface distance and unit normal from one two-plane parameter
    solve (Martin et al., "Practical ray tracing of trimmed NURBS
    surfaces"): the converged (u, v) is the intersection's parameter
    point, where the normal is the cross product of the parametric
    tangents. ``iters``: the solve's stopped steps (``_uv_iters`` by
    default)."""
    P, W = unpack_pw(coeffs, aux)
    residual = plane_residual(P, W, aux, *_planes(x, y, z, L, M, N))
    u0, v0 = _param_guess(P, x, y)
    u, v = _newton_uv(residual, u0, v0, iters)
    S = rational(homogeneous(P, W, aux, u, v))[0]
    Sx, Sy, Sz = S[""]
    t = torch.sqrt((Sx - x) ** 2 + (Sy - y) ** 2 + (Sz - z) ** 2)
    return t, _unit_normal(S["u"], S["v"])


def distance(coeffs, aux, x, y, z, L, M, N):
    """Ray-surface distance via the two-plane formulation (see
    intersect)."""
    return intersect(coeffs, aux, x, y, z, L, M, N)[0]


# ---------------------------------------------------------------------------
# Build-time fitting (numpy; replicates the reference's A9.7 approximation)
# ---------------------------------------------------------------------------


def _basis_one(degree, knots, span, knot):
    """Single basis function N_{span,degree}(knot)
    (The NURBS Book A2.4; reference: nurbs_basis_functions.py basis_function_one)."""
    if (span == 0 and knot == knots[0]) or (
        span == len(knots) - degree - 2 and knot == knots[-1]
    ):
        return 1.0
    if knot < knots[span] or knot >= knots[span + degree + 1]:
        return 0.0
    N = [0.0] * (degree + 1)
    for j in range(degree + 1):
        if knots[span + j] <= knot < knots[span + j + 1]:
            N[j] = 1.0
    for k in range(1, degree + 1):
        saved = 0.0
        if N[0] != 0.0:
            saved = ((knot - knots[span]) * N[0]) / (
                knots[span + k] - knots[span]
            )
        for j in range(degree - k + 1):
            Uleft = knots[span + j + 1]
            Uright = knots[span + j + k + 1]
            if N[j + 1] == 0.0:
                N[j] = saved
                saved = 0.0
            else:
                temp = N[j + 1] / (Uright - Uleft)
                N[j] = saved + (Uright - knot) * temp
                saved = (knot - Uleft) * temp
    return N[0]


def _params_curve(points):
    """Chord-length parameters (The NURBS Book eq. 9.4-9.5)."""
    num = len(points)
    cds = [0.0] * (num + 1)
    cds[-1] = 1.0
    for i in range(1, num):
        cds[i] = float(np.linalg.norm(np.asarray(points[i]) - np.asarray(points[i - 1])))
    d = sum(cds[1:-1])
    return [sum(cds[: i + 1]) / d for i in range(num)]


def _params_surface(points, size_u, size_v):
    uk_temp = []
    for v in range(size_v):
        pts_u = [points[v + (size_v * u)] for u in range(size_u)]
        uk_temp += _params_curve(pts_u)
    uk = [
        sum(uk_temp[u + (size_u * v)] for v in range(size_v)) / size_v
        for u in range(size_u)
    ]
    vl_temp = []
    for u in range(size_u):
        pts_v = [points[v + (size_v * u)] for v in range(size_v)]
        vl_temp += _params_curve(pts_v)
    vl = [
        sum(vl_temp[v + (size_v * u)] for u in range(size_u)) / size_u
        for v in range(size_v)
    ]
    return uk, vl


def _knot_vector(degree, num_dpts, num_cpts, params):
    """Knot placement ensuring occupied spans (The NURBS Book eq. 9.68-9.69)."""
    kv = [0.0] * (degree + 1)
    d = float(num_dpts) / float(num_cpts - degree)
    for j in range(1, num_cpts - degree):
        i = int(j * d)
        alpha = (j * d) - i
        kv.append(((1.0 - alpha) * params[i - 1]) + (alpha * params[i]))
    kv += [1.0] * (degree + 1)
    return kv


def approximate_surface(points, size_u, size_v, degree_u, degree_v):
    """Global LSQ surface approximation (The NURBS Book A9.7;
    reference: nurbs_fitting.py:16-118). Returns (ctrlpts flat list,
    num_cpts_u, num_cpts_v, kv_u, kv_v)."""
    num_cpts_u = size_u - 1
    num_cpts_v = size_v - 1
    dim = len(points[0])
    uk, vl = _params_surface(points, size_u, size_v)
    kv_u = _knot_vector(degree_u, size_u, num_cpts_u, uk)
    kv_v = _knot_vector(degree_v, size_v, num_cpts_v, vl)

    Nu = np.array([
        [_basis_one(degree_u, kv_u, j, uk[i]) for j in range(1, num_cpts_u - 1)]
        for i in range(1, size_u - 1)
    ])
    NtNu = Nu.T @ Nu

    ctrl_tmp = [[0.0] * dim for _ in range(num_cpts_u * size_v)]
    for j in range(size_v):
        ctrl_tmp[j] = list(points[j])
        ctrl_tmp[j + size_v * (num_cpts_u - 1)] = list(
            points[j + size_v * (size_u - 1)]
        )
        pt0 = points[j]
        ptm = points[j + size_v * (size_u - 1)]
        rku = []
        for i in range(1, size_u - 1):
            ptk = points[j + size_v * i]
            n0p = _basis_one(degree_u, kv_u, 0, uk[i])
            nnp = _basis_one(degree_u, kv_u, num_cpts_u - 1, uk[i])
            rku.append([
                a - b * n0p - c * nnp
                for a, b, c in zip(ptk, pt0, ptm)
            ])
        ru = np.zeros((num_cpts_u - 2, dim))
        for i in range(1, num_cpts_u - 1):
            for idx, pt in enumerate(rku):
                b1 = _basis_one(degree_u, kv_u, i, uk[idx + 1])
                ru[i - 1] += np.asarray(pt) * b1
        x = np.linalg.solve(NtNu, ru)
        for i in range(1, num_cpts_u - 1):
            ctrl_tmp[j + size_v * i] = list(x[i - 1])

    Nv = np.array([
        [_basis_one(degree_v, kv_v, j, vl[i]) for j in range(1, num_cpts_v - 1)]
        for i in range(1, size_v - 1)
    ])
    NtNv = Nv.T @ Nv

    ctrlpts = [[0.0] * dim for _ in range(num_cpts_u * num_cpts_v)]
    for i in range(num_cpts_u):
        ctrlpts[num_cpts_v * i] = list(ctrl_tmp[size_v * i])
        ctrlpts[num_cpts_v - 1 + num_cpts_v * i] = list(
            ctrl_tmp[size_v - 1 + size_v * i]
        )
        pt0 = ctrl_tmp[size_v * i]
        ptm = ctrl_tmp[size_v - 1 + size_v * i]
        rkv = []
        for j in range(1, size_v - 1):
            ptk = ctrl_tmp[j + size_v * i]
            n0p = _basis_one(degree_v, kv_v, 0, vl[j])
            nnp = _basis_one(degree_v, kv_v, num_cpts_v - 1, vl[j])
            rkv.append([
                a - b * n0p - c * nnp
                for a, b, c in zip(ptk, pt0, ptm)
            ])
        rv = np.zeros((num_cpts_v - 2, dim))
        for j in range(1, num_cpts_v - 1):
            for idx, pt in enumerate(rkv):
                b1 = _basis_one(degree_v, kv_v, j, vl[idx + 1])
                rv[j - 1] += np.asarray(pt) * b1
        xsol = np.linalg.solve(NtNv, rv)
        for j in range(1, num_cpts_v - 1):
            ctrlpts[j + num_cpts_v * i] = list(xsol[j - 1])

    return ctrlpts, num_cpts_u, num_cpts_v, kv_u, kv_v


def clamped_knots(degree: int, n_ctrl: int):
    """Uniform clamped knot vector (reference: nurbs_geometry.py:133-147)."""
    interior = np.linspace(0, 1, n_ctrl - degree + 1)
    return tuple(
        [0.0] * degree + list(interior) + [1.0] * degree
    )


def build_nurbs_def(
    radius=np.inf,
    conic=0.0,
    control_points=None,
    weights=None,
    u_degree=None,
    v_degree=None,
    u_knots=None,
    v_knots=None,
    nurbs_norm_x=None,
    nurbs_norm_y=None,
    x_center=0.0,
    y_center=0.0,
    n_points_u: int = 5,
    n_points_v: int = 5,
):
    """Resolve the reference's NURBS construction modes into
    (coeffs_flat, aux) (reference: nurbs_geometry.py:84-330).

    Modes: explicit control points (Bezier / B-Spline / full NURBS), or a
    base-conic fit over the normalization rectangle (A9.7 approximation).
    """
    norm_x = 1.0 if nurbs_norm_x is None else float(nurbs_norm_x)
    norm_y = 1.0 if nurbs_norm_y is None else float(nurbs_norm_y)
    if control_points is None:
        # Fit the base conic (reference: nurbs_geometry.py:868-940)
        size_u = n_points_u + 1
        size_v = n_points_v + 1
        xs = np.linspace(x_center - norm_x, x_center + norm_x, size_u)
        ys = np.linspace(y_center - norm_y, y_center + norm_y, size_v)
        X, Y = np.meshgrid(xs, ys)
        if np.isinf(radius):
            Z = np.zeros_like(X)
        else:
            r2 = X**2 + Y**2
            Z = r2 / (radius * (1 + np.sqrt(1 - (1 + conic) * r2 / radius**2)))
        pts = np.stack([X.T, Y.T, Z.T], axis=0)
        xp = pts.reshape(3, -1).T.tolist()
        deg = 3
        ctrl, ncu, ncv, kv_u, kv_v = approximate_surface(
            xp, size_u, size_v, deg, deg
        )
        P = np.asarray(ctrl).T.reshape(3, ncu, ncv)
        W = np.ones((ncu, ncv))
        u_degree = v_degree = deg
        u_knots = tuple(kv_u)
        v_knots = tuple(kv_v)
    else:
        P = np.asarray(control_points, float)
        ncu, ncv = P.shape[1], P.shape[2]
        if weights is None and u_degree is None and u_knots is None:
            # Bezier: degree = count - 1
            u_degree, v_degree = ncu - 1, ncv - 1
        if u_degree is None:
            u_degree = 3
        if v_degree is None:
            v_degree = 3
        if u_knots is None:
            u_knots = clamped_knots(u_degree, ncu)
        else:
            u_knots = tuple(float(k) for k in np.asarray(u_knots).ravel())
        if v_knots is None:
            v_knots = clamped_knots(v_degree, ncv)
        else:
            v_knots = tuple(float(k) for k in np.asarray(v_knots).ravel())
        W = (
            np.ones((ncu, ncv)) if weights is None
            else np.asarray(weights, float)
        )
    coeffs = np.concatenate([P.ravel(), W.ravel()])
    aux = ("nurbs", int(P.shape[1]), int(P.shape[2]), int(u_degree),
           int(v_degree), tuple(u_knots), tuple(v_knots))
    return coeffs, aux
