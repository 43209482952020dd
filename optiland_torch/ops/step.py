"""The surface step shared by the op modules: the plain PyTorch version of the
device step in ``csrc/step.cuh`` and its hand-derived adjoint.

Counterpart of ``_step_tile`` in ``optiland_tpu/ops/pallas_trace.py``:
its PLANE, STANDARD, tilt, annular-aperture, EVEN_ASPHERE/ODD_ASPHERE,
POLYNOMIAL_XY/CHEBYSHEV/TOROIDAL/BICONIC and ZERNIKE_SAG/FORBES_QBFS/
FORBES_Q2D branches. An aux-bearing surface (the last three) reads its
laid-out coefficient row ``c`` and the slots ``lay`` of its layout
(``geom.aux_layout``: the static extras JAX keeps in ``geom_aux``). Two forms, chosen by the
length of the state:

  * the merit form, state (x, y, z, L, M, N): geometry only, which is all
    the fused merit reads (``ops/fused_trace.py``);
  * the full form, state (x, y, z, L, M, N, i, opd): also Beer-Lambert
    absorption in the medium before the surface (where its flag is set),
    the optical path and the circular clip on ``P_APMAX``, as the generic
    and field traces return them (``ops/fast_trace.py``).

A surface of a Newton family (``geom.NEWTON_CODES``) intersects by
``newton_iters`` Newton steps on f(t) = z(t) - sag(x(t), y(t)) from the
conic (or plane) guess, then one more step from that point held fixed,
through which the gradient runs (the implicit-function gradient of the
JAX package's kernels); its normal is the sag's derivative. Its adjoint
takes the cotangent through that one step, the f f'_theta / f'^2 term
included, and through the normal with the sag's second derivative
(``geom.sag_point``; for a Cartesian family ``geom.cart_point``: the
slopes' Hessian and their radius, conic, p1 and p2 derivatives, with
CHEBYSHEV's normal the reference's convention), and gives the cotangents
of the surface's coefficient row after the param columns (a Cartesian
family's from its per-ray weights, ``geom.coef_columns``, then those of
P_G1 and P_G2). With the ``inner`` flag (an
annular aperture) the full step also zeroes the intensity of a ray with
x^2 + y^2 < ap_min^2, after the circular clip.

With the ``grating`` flag (K6c: a PLANE or STANDARD surface whose
interaction is a grating, ``("grating", m)``) the step diffracts instead of
refracting or reflecting: the groove vector of period P_G1 (um) and groove
angle P_G2 (``kernels.grating_vector``, on a STANDARD substrate from the
raw, unflipped normal) and the vector diffraction with P_MLAM = m times the
wavelength (``kernels.grating_diffract``); the full step zeroes the
intensity of an evanescent order, and a reflective grating keeps n_pre.
Its adjoint gives the P_G1 and P_G2 cotangents after the param columns
(and, through the groove frame, more of the radius and conic ones); none
for P_MLAM, which the JAX package builds from a float. The sign of the
normal and the two clamps (1e-14 under the substrate's root, 1e-12 under
d_eff's) pass no derivative where they bind, and an evanescent order's
zero root none.

A NURBS surface (K6d; ``lay`` its net's structure ``("nurbs", nu, nv, p,
q, u_knots, v_knots)``, ``c`` its row, the control points then the
weights) intersects by ``nurbs.intersect`` with ``newton_iters`` stopped
steps of the two-plane (u, v) solve, which gives the normal too. Its
adjoint (``nurbs_forward``, ``nurbs_adjoint``) takes the cotangents of t
and of the normal through the one corrected step at the stopped point:
the normal through the net's second derivatives, the clip as
``jnp.clip``'s derivative, the correction through the Jacobian at the
stopped point and the ray's planes, the residual term kept; the net's
cotangents follow the rational quotient (``net_cotangent``) and are
nonzero only on the ray's span. The cotangents of its coefficient row
follow the param columns, as a Newton family's.

For the polarized traces (``ops/pol_trace.py``) the step also gives its
"extras": the local pre- and post-interaction directions and adot, the
cosine of the angle of incidence; and its adjoint takes their cotangents.

A tilted surface (the ``tilted`` flag of the adjoint, set where a tilt
angle is nonzero or not finite) rotates the ray into its frame, z then y
then x by the negated angles, and back in reverse order after the
interaction (``_rot_local``/``_rot_global`` of the JAX package); the
adjoint routes every cotangent through those rotations and gives the true
d/d(rx, ry, rz). An untilted surface keeps the zero-tilt form: each
rotation contributes its generator, which is what the general form gives
at zero angles.

In the polychromatic traces the index after the surface is a per-ray
tensor (``n_post``, from the surface's dispersion formula) instead of the
table's P_NPOST column.

The CUDA device step is a line-by-line transcription of these two
functions, instantiated once per form; change them together.
"""

from __future__ import annotations

import numpy as np
import torch

from types import SimpleNamespace

from optiland_torch.core import geometry as geom
from optiland_torch.core import nurbs
from optiland_torch.core.nurbs import cross3, dot3
from optiland_torch.ops import kernels

# param table columns (the JAX package's layout)
(
    P_RADIUS, P_CONIC, P_POS, P_NPOST, P_APMAX, P_KPRE,
    P_DX, P_DY, P_RX, P_RY, P_RZ, P_G1, P_G2, P_APMIN,
    P_MLAM,  # m * wavelength for grating surfaces (0 elsewhere)
) = range(15)
NUM_P = 15

# Columns of the param table that the merit's gradient reaches, in the
# order the backward kernels accumulate them per surface.
GRAD_COLS = (P_RADIUS, P_CONIC, P_POS, P_NPOST, P_DX, P_DY, P_RX, P_RY, P_RZ)
# The full step's gradient also reaches the absorption column.
FULL_GRAD_COLS = GRAD_COLS + (P_KPRE,)

# Beer-Lambert factor exp(ABS * k_pre * t): k_pre = k / wavelength (um), t mm
ABS = -4 * np.pi

# The columns a Cartesian family's cotangents reach after its coefficient
# row: p1 and p2.
CART_COLS = (P_G1, P_G2)


def split_cols(code, cols, base, nc, grating=False):
    """``step_adjoint_plain``'s cotangents as ((param column, value) pairs,
    coefficient cotangents): the ``base`` columns (GRAD_COLS or
    FULL_GRAD_COLS), then for a Cartesian family or a grating P_G1 and
    P_G2; the nc coefficient cotangents of a Newton family, else none."""
    pairs = list(zip(base, cols))
    if grating:
        return pairs + list(zip(CART_COLS, cols[len(base):])), ()
    coef = cols[len(base):len(base) + nc]
    if code in geom.CART_CODES:
        pairs += list(zip(CART_COLS, cols[len(base) + nc:]))
    return pairs, coef


def _rot_local(x, y, z, L, M, N, rx, ry, rz):
    """Localize rotation R_x(-rx) R_y(-ry) R_z(-rz) of positions and
    directions (the JAX package's order)."""
    x, y, L, M = kernels.rotate_z(x, y, L, M, -rz)
    x, z, L, N = kernels.rotate_y(x, z, L, N, -ry)
    y, z, M, N = kernels.rotate_x(y, z, M, N, -rx)
    return x, y, z, L, M, N


def _rot_global(x, y, z, L, M, N, rx, ry, rz):
    y, z, M, N = kernels.rotate_x(y, z, M, N, rx)
    x, z, L, N = kernels.rotate_y(x, z, L, N, ry)
    x, y, L, M = kernels.rotate_z(x, y, L, M, rz)
    return x, y, z, L, M, N


def _rot_ab_adjoint(v, g, c, s):
    """Reverse of one rotation (a, b) <- (a c - b s, a s + b c) by the
    angle phi (cos c, sin s) of the pairs v = (a', b', A', B'), its outputs,
    whose cotangents are g. Returns (d/d phi, the inputs, their
    cotangents): both pairs rotated back by -phi."""
    a, b, A, B = v
    ga, gb, gA, gB = g
    dphi = -ga * b + gb * a - gA * B + gB * A
    back = (a * c + b * s, -a * s + b * c, A * c + B * s, -A * s + B * c)
    gback = (ga * c + gb * s, -ga * s + gb * c, gA * c + gB * s,
             -gA * s + gB * c)
    return dphi, back, gback


def _cos_sin(p):
    """(cos rx, sin rx, cos ry, sin ry, cos rz, sin rz) of a param row."""
    return tuple(f(p[c]) for c in (P_RX, P_RY, P_RZ)
                 for f in (torch.cos, torch.sin))


def _rot_global_adjoint(p, v, g):
    """Reverse of ``_rot_global`` by the tilts of param row ``p`` at the
    local state v = (x, y, z, L, M, N) it rotates, for the cotangents g of
    its outputs: returns the cotangents of v and (d/drx, d/dry, d/drz). The
    rotations run forward to the outputs, then back one by one (rotate_z is
    the (x, y) rotation by rz, rotate_y the (x, z) rotation by -ry,
    rotate_x the (y, z) rotation by rx)."""
    cx, sx, cy, sy, cz, sz = _cos_sin(p)
    x, y, z, L, M, N = _rot_global(*v, p[P_RX], p[P_RY], p[P_RZ])
    gx, gy, gz, gL, gM, gN = g
    d_rz, (x, y, L, M), (gx, gy, gL, gM) = _rot_ab_adjoint(
        (x, y, L, M), (gx, gy, gL, gM), cz, sz)
    d, (x, z, L, N), (gx, gz, gL, gN) = _rot_ab_adjoint(
        (x, z, L, N), (gx, gz, gL, gN), cy, -sy)
    d_ry = -d
    d_rx, _, (gy, gz, gM, gN) = _rot_ab_adjoint(
        (y, z, M, N), (gy, gz, gM, gN), cx, sx)
    return (gx, gy, gz, gL, gM, gN), (d_rx, d_ry, d_rz)


def _rot_local_adjoint(p, v, g):
    """Reverse of ``_rot_local`` by the tilts of param row ``p`` at its
    output, the local state v = (x, y, z, L, M, N), for the cotangents g of
    v: returns the cotangents of its input and (d/drx, d/dry, d/drz)."""
    cx, sx, cy, sy, cz, sz = _cos_sin(p)
    x, y, z, L, M, N = v
    gx, gy, gz, gL, gM, gN = g
    d, (y, z, M, N), (gy, gz, gM, gN) = _rot_ab_adjoint(
        (y, z, M, N), (gy, gz, gM, gN), cx, -sx)
    d_rx = -d
    d_ry, (x, z, L, N), (gx, gz, gL, gN) = _rot_ab_adjoint(
        (x, z, L, N), (gx, gz, gL, gN), cy, sy)
    d, _, (gx, gy, gL, gM) = _rot_ab_adjoint(
        (x, y, L, M), (gx, gy, gL, gM), cz, -sz)
    d_rz = -d
    return (gx, gy, gz, gL, gM, gN), (d_rx, d_ry, d_rz)


def clip01_grad(U):
    """d clip(U, 0, 1) / dU as ``jnp.clip`` forms it: 1 inside, 1/2 at
    exactly 0 or 1, 0 outside."""
    lo = torch.where(U > 0, 1.0, torch.where(U == 0, 0.5, 0.0))
    hi = torch.where(U < 1, 1.0, torch.where(U == 1, 0.5, 0.0))
    return lo * hi


def nurbs_forward(c, net, x, y, z, L, M, N, iters):
    """The kernels' NURBS intersection (``nurbs.intersect`` with ``iters``
    stopped steps) with the intermediates its adjoint reads: the planes,
    the stopped point (us, vs) and the net's sums there, the correction
    step, the corrected point (u1, v1) with the second derivatives, t and
    the normal."""
    P, W = nurbs.unpack_pw(c, net)
    N1, N2, d1, d2 = nurbs._planes(x, y, z, L, M, N)
    residual = nurbs.plane_residual(P, W, net, N1, N2, d1, d2)
    us, vs = nurbs._param_guess(P, x, y)
    for _ in range(iters):
        us, vs = nurbs._uv_step(residual, us, vs)
    hs = nurbs.homogeneous(P, W, net, us, vs, 1)
    Ss, ws = nurbs.rational(hs)
    f1, f2 = dot3(N1, Ss[""]) + d1, dot3(N2, Ss[""]) + d2
    f1u, f2u = dot3(N1, Ss["u"]), dot3(N2, Ss["u"])
    f1v, f2v = dot3(N1, Ss["v"]), dot3(N2, Ss["v"])
    det = f1u * f2v - f1v * f2u
    clamped = det.abs() < 1e-14
    det = torch.where(clamped, 1e-14, det)
    du = (f1 * f2v - f2 * f1v) / det
    dv = (f2 * f1u - f1 * f2u) / det
    U, V = us - du, vs - dv
    u1, v1 = nurbs.clip01(U), nurbs.clip01(V)
    h1 = nurbs.homogeneous(P, W, net, u1, v1, 2)
    S1, w1 = nurbs.rational(h1)
    D = tuple(a - b for a, b in zip(S1[""], (x, y, z)))
    t = torch.sqrt(dot3(D, D))
    n = cross3(S1["u"], S1["v"])
    mag = torch.sqrt(dot3(n, n))
    mag = torch.where(mag == 0, 1.0, mag)
    nh = tuple(v / mag for v in n)
    flip = torch.sign(torch.where(nh[2] == 0, 1.0, -nh[2]))
    return SimpleNamespace(
        P=P, W=W, net=net, r0=(x, y, z), k=(L, M, N), N1=N1, N2=N2,
        us=us, vs=vs, hs=hs, Ss=Ss, ws=ws, f=(f1, f2, f1u, f2u, f1v, f2v),
        det=det, clamped=clamped, du=du, dv=dv, U=U, V=V, u1=u1, v1=v1,
        h1=h1, S1=S1, w1=w1, D=D, t=t, mag=mag, nh=nh, flip=flip,
        normal=tuple(v * flip for v in nh))


def net_cotangent(P, W, net, u, v, h, S, w, gS, gSu, gSv):
    """The cotangents (g_P (3, nu, nv, R), g_W (nu, nv, R)) of the control
    points and weights from those of the surface point S and its tangents
    S_u, S_v at (u, v), through the rational quotient: with the homogeneous
    cotangents g_H = (g_S - (w_u g_Su + w_v g_Sv) / w) / w, g_Hu = g_Su / w,
    g_Hv = g_Sv / w, g_w, g_wu, g_wv (``nurbs.rational`` reversed), a
    control point (i, j) takes W_ij (b g_H + b_u g_Hu + b_v g_Hv) and its
    weight P_ij . (same) + b g_w + b_u g_wu + b_v g_wv, b = N_i(u) N_j(v),
    b_u, b_v its derivatives: nonzero on the (p + 1)(q + 1) points of the
    ray's span only."""
    _, nu, nv, p, q, uk, vk = net
    wu, wv = h["u"][1], h["v"][1]
    gSt = tuple(a - (wu * b + wv * c) / w for a, b, c in zip(gS, gSu, gSv))
    gH = torch.stack([a / w for a in gSt])
    gHu = torch.stack([a / w for a in gSu])
    gHv = torch.stack([a / w for a in gSv])
    gw = -(dot3(gSt, S[""]) + dot3(gSu, S["u"]) + dot3(gSv, S["v"])) / w
    gwu = -dot3(gSu, S[""]) / w
    gwv = -dot3(gSv, S[""]) / w
    Bu, dBu = (torch.stack(b) for b in nurbs.basis_ders(uk, nu - 1, p, u))
    Bv, dBv = (torch.stack(b) for b in nurbs.basis_ders(vk, nv - 1, q, v))
    b = Bu[:, None] * Bv[None]
    bu = dBu[:, None] * Bv[None]
    bv = Bu[:, None] * dBv[None]
    G = (b[None] * gH[:, None, None] + bu[None] * gHu[:, None, None]
         + bv[None] * gHv[:, None, None])
    gP = W[None, :, :, None] * G
    gW = (P[..., None] * G).sum(0) + b * gw + bu * gwu + bv * gwv
    return gP, gW


def nurbs_adjoint(fw, g_t, g_n):
    """Reverse of ``nurbs_forward`` for the cotangents of t and of the
    normal (before the step's sign alignment): returns those of the local
    position (x, y, z), of the direction (L, M, N) and the (4 nu nv, R)
    cotangents of the net's row [P.ravel(), W.ravel()]. The correction
    step is differentiated at the stopped point, its Jacobian through the
    net's tangents there and the planes, with the term proportional to
    the residual f kept; the clip passes ``clip01_grad``, the det clamp
    and the sign nothing."""
    P, W, net = fw.P, fw.W, fw.net
    f1, f2, f1u, f2u, f1v, f2v = fw.f
    det, S1 = fw.det, fw.S1
    # the normal: Su x Sv / |.|, flipped toward -z
    g_nh = tuple(fw.flip * v for v in g_n)
    nd = dot3(fw.nh, g_nh)
    g_nr = tuple((a - h * nd) / fw.mag for a, h in zip(g_nh, fw.nh))
    g_Su1 = cross3(S1["v"], g_nr)
    g_Sv1 = cross3(g_nr, S1["u"])
    # t = |S1 - r0|
    g_S1 = tuple(g_t * d / fw.t for d in fw.D)
    g_r0 = [-v for v in g_S1]
    g_u1 = dot3(g_S1, S1["u"]) + dot3(g_Su1, S1["uu"]) + dot3(g_Sv1, S1["uv"])
    g_v1 = dot3(g_S1, S1["v"]) + dot3(g_Su1, S1["uv"]) + dot3(g_Sv1, S1["vv"])
    gP, gW = net_cotangent(P, W, net, fw.u1, fw.v1, fw.h1, S1, fw.w1, g_S1,
                           g_Su1, g_Sv1)
    # u1 = clip(us - du), v1 = clip(vs - dv), (us, vs) stopped
    g_du = -g_u1 * clip01_grad(fw.U)
    g_dv = -g_v1 * clip01_grad(fw.V)
    # du = (f1 f2v - f2 f1v) / det, dv = (f2 f1u - f1 f2u) / det
    g_f1 = (g_du * f2v - g_dv * f2u) / det
    g_f2 = (g_dv * f1u - g_du * f1v) / det
    g_f1u = g_dv * f2 / det
    g_f2u = -g_dv * f1 / det
    g_f1v = -g_du * f2 / det
    g_f2v = g_du * f1 / det
    g_det = torch.where(fw.clamped, 0.0,
                        -(g_du * fw.du + g_dv * fw.dv) / det)
    g_f1u = g_f1u + g_det * f2v
    g_f2v = g_f2v + g_det * f1u
    g_f1v = g_f1v - g_det * f2u
    g_f2u = g_f2u - g_det * f1v
    # f_k = N_k . S + d_k, f_ku = N_k . S_u, f_kv = N_k . S_v at (us, vs)
    Ss, N1, N2 = fw.Ss, fw.N1, fw.N2
    g_N1 = [g_f1 * a + g_f1u * b + g_f1v * c
            for a, b, c in zip(Ss[""], Ss["u"], Ss["v"])]
    g_N2 = [g_f2 * a + g_f2u * b + g_f2v * c
            for a, b, c in zip(Ss[""], Ss["u"], Ss["v"])]
    g_Ss = tuple(g_f1 * a + g_f2 * b for a, b in zip(N1, N2))
    g_Sus = tuple(g_f1u * a + g_f2u * b for a, b in zip(N1, N2))
    g_Svs = tuple(g_f1v * a + g_f2v * b for a, b in zip(N1, N2))
    gPs, gWs = net_cotangent(P, W, net, fw.us, fw.vs, fw.hs, Ss, fw.ws,
                             g_Ss, g_Sus, g_Svs)
    # d_k = -N_k . r0
    for j in range(3):
        g_N1[j] = g_N1[j] - g_f1 * fw.r0[j]
        g_N2[j] = g_N2[j] - g_f2 * fw.r0[j]
        g_r0[j] = g_r0[j] - g_f1 * N1[j] - g_f2 * N2[j]
    # N2 = N1 x k
    k = fw.k
    gk = list(cross3(g_N2, N1))
    g_N1 = [a + b for a, b in zip(g_N1, cross3(k, g_N2))]
    # N1 = (M, -L, 0) / |(L, M)| where L > M and L > N, else
    # (0, N, -M) / |(N, M)|
    L, M, N = k
    mask = (L > M) & (L > N)
    h1 = torch.sqrt(L * L + M * M)
    h2 = torch.sqrt(N * N + M * M)
    h1 = torch.where(h1 == 0, 1.0, h1)
    h2 = torch.where(h2 == 0, 1.0, h2)
    a1 = (N1[0] * g_N1[0] + N1[1] * g_N1[1])
    ga = (g_N1[0] - N1[0] * a1) / h1, (g_N1[1] - N1[1] * a1) / h1
    a2 = (N1[1] * g_N1[1] + N1[2] * g_N1[2])
    gb = (g_N1[1] - N1[1] * a2) / h2, (g_N1[2] - N1[2] * a2) / h2
    gk[0] = gk[0] + torch.where(mask, -ga[1], 0.0)
    gk[1] = gk[1] + torch.where(mask, ga[0], -gb[1])
    gk[2] = gk[2] + torch.where(mask, 0.0, gb[0])
    g_net = torch.cat([(gP + gPs).reshape(-1, gP.shape[-1]),
                       (gW + gWs).reshape(-1, gW.shape[-1])])
    return tuple(g_r0), tuple(gk), g_net


def step_plain(code, refl, p, n_pre, st, absorbs=False, extras=False,
               n_post=None, c=None, newton_iters=10, inner=False, lay=None,
               grating=False):
    """One surface step on per-ray tensors; returns (state, n_next), and
    with ``extras`` also (L0, M0, N0, L1, M1, N1, adot, t_s): the
    local-frame pre- and post-interaction directions, |cos| of the angle of
    incidence, and a Newton family's stopped iterate (None for the other
    families), from which ``step_adjoint_plain`` may start its reverse
    step.

    ``st`` is (x, y, z, L, M, N), or (x, y, z, L, M, N, i, opd) for the full
    step; ``absorbs`` (full step only) applies the Beer-Lambert factor of
    ``p[P_KPRE]``; ``n_post``, when given, is the per-ray index after the
    surface (polychromatic traces), else ``p[P_NPOST]``. ``c`` is the
    surface's coefficient row (read by the Newton families, which take
    ``newton_iters`` steps; an aux-bearing family's laid-out row, whose
    slots are ``lay``); ``inner`` (full step only) applies the annular
    clip on ``p[P_APMIN]``; ``grating`` diffracts (P_G1, P_G2, P_MLAM).
    The tilt rotations
    always run, as in the JAX package under ``jax.grad``, where traced
    tilts keep the rotation code: at zero tilt they are exact identities
    (the kernels skip them there), and autograd through them gives the tilt
    derivatives that the hand adjoint reproduces."""
    full = len(st) == 8
    x, y, z, L, M, N = st[:6]
    radius, conic, pos = p[P_RADIUS], p[P_CONIC], p[P_POS]
    rot = (p[P_RX], p[P_RY], p[P_RZ])
    x = x - p[P_DX]
    y = y - p[P_DY]
    zl = z - pos
    x, y, zl, L, M, N = _rot_local(x, y, zl, L, M, N, *rot)
    p1, p2 = p[P_G1], p[P_G2]
    t_s = None
    if code == geom.NURBS:
        # the two-plane solve gives the normal too (``lay``: the net)
        t, nrm = nurbs.intersect(c, lay, x, y, zl, L, M, N,
                                 iters=newton_iters)
    else:
        t, t_s = geom.distance_static(code, radius, conic, x, y, zl, L, M, N,
                                      coeffs=c, newton_iters=newton_iters,
                                      p1=p1, p2=p2, lay=lay, stopped=True)
    x = x + t * L
    y = y + t * M
    zl = zl + t * N
    extra = ()
    if full:
        i, opd = st[6], st[7]
        if absorbs:
            i = i * torch.exp(ABS * p[P_KPRE] * t * 1e3)
        opd = opd + torch.abs(t * n_pre)
        r2 = x * x + y * y
        i = torch.where(r2 > p[P_APMAX] * p[P_APMAX], 0.0, i)
        if inner:
            i = torch.where(r2 < p[P_APMIN] * p[P_APMIN], 0.0, i)
        extra = (i, opd)
    if code == geom.NURBS:
        nx, ny, nz = nrm
    else:
        nx, ny, nz = geom.surface_normal_static(code, radius, conic, c, x, y,
                                                p1, p2, lay=lay)
    raw = (nx, ny, nz)  # the groove frame reads the unflipped normal
    dot = L * nx + M * ny + N * nz
    sgn = torch.sign(dot)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn
    adot = torch.abs(dot)
    k0 = (L, M, N)
    if grating:
        if refl:
            n_post = n_pre
        elif n_post is None:
            n_post = p[P_NPOST]
        f = kernels.grating_vector(code, radius, conic, p2, x, y, *raw)
        L, M, N, ok = kernels.grating_diffract(L, M, N, nx, ny, nz, adot, f,
                                               p1, p[P_MLAM], n_pre, n_post,
                                               refl)
        if full:
            extra = (torch.where(ok, extra[0], 0.0), extra[1])
        n_next = n_post
    elif refl:
        L = L - 2 * adot * nx
        M = M - 2 * adot * ny
        N = N - 2 * adot * nz
        n_next = n_pre
    else:
        if n_post is None:
            n_post = p[P_NPOST]
        u = n_pre / n_post
        root = torch.sqrt(1 - u * u * (1 - adot * adot))
        L = u * L + nx * (root - u * adot)
        M = u * M + ny * (root - u * adot)
        N = u * N + nz * (root - u * adot)
        n_next = n_post
    ext = k0 + (L, M, N, adot, t_s)
    x, y, zl, L, M, N = _rot_global(x, y, zl, L, M, N, *rot)
    x = x + p[P_DX]
    y = y + p[P_DY]
    out = (x, y, zl + pos, L, M, N) + extra
    return (out, n_next, ext) if extras else (out, n_next)


def step_adjoint_plain(code, refl, p, n_pre, st, g, absorbs=False,
                       g_ext=None, tilted=False, n_post=None, c=None,
                       newton_iters=10, inner=False, lay=None,
                       grating=False, t_s=None):
    """Reverse sweep through one surface step.

    ``st`` is the step's input state, ``g`` the cotangents of its outputs:
    (x, y, z, L, M, N, n_next) for the merit step, plus (i, opd) for the
    full one; ``g_ext``, when given, those of the step's extras (L0, M0,
    N0, L1, M1, N1, adot). Returns the cotangents of the input state, of
    n_pre, and of the param columns GRAD_COLS (FULL_GRAD_COLS for the full
    step), all per ray. With ``tilted`` the cotangents pass through the
    surface's rotations and the tilt columns get the derivative at its
    angles; without, those at zero tilt, where each rotation contributes its
    generator (the extras are local-frame directions, so theirs count too).
    ``n_post`` is the per-ray index after the surface of a polychromatic
    trace (its cotangent is the P_NPOST column's). The clip (and with
    ``inner`` the annular clip) passes no cotangent to a clipped ray's
    intensity, and none to the positions that decide it. For a Newton
    family the param columns are followed by the cotangents of the
    coefficient row ``c`` (one per coefficient), for a Cartesian one then
    by those of P_G1 and P_G2, and for a ``grating`` by those of P_G1 and
    P_G2 (``split_cols`` takes them apart). ``t_s``, when given, is a
    Newton family's stopped iterate from ``step_plain``'s extras, which the
    reverse step starts from instead of solving again (the Newton builds'
    backwards keep it from their forward sweep). The CUDA kernels' reverse
    step is a line-by-line transcription of this one."""
    full = len(g) == 9
    x, y, z, L, M, N = st[:6]
    gx, gy, gz, gL_o, gM_o, gN_o, g_nn = g[:7]
    R, k, pos = p[P_RADIUS], p[P_CONIC], p[P_POS]
    dx, dy = p[P_DX], p[P_DY]
    npost = p[P_NPOST] if n_post is None else n_post
    std = code == geom.STANDARD
    newton = code in geom.RADIAL_CODES
    cart = code in geom.CART_CODES
    nrb = code == geom.NURBS
    p1, p2 = p[P_G1], p[P_G2]

    # ---- recompute the forward intermediates (in the surface's frame) ----
    xl = x - dx
    yl = y - dy
    zl = z - pos
    if tilted:
        xl, yl, zl, L, M, N = _rot_local(xl, yl, zl, L, M, N, p[P_RX],
                                         p[P_RY], p[P_RZ])
    if std:
        cu = 1.0 / R
        A = k * N**2 + L**2 + M**2 + N**2
        a = cu * A
        Bq = k * N * zl + L * xl + M * yl + N * zl
        b = 2 * (cu * Bq - N)
        Cq = k * zl**2 + xl**2 + yl**2 + zl**2
        c = cu * Cq - 2 * zl
        d = b**2 - 4 * a * c
        sqrt_d = torch.sqrt(torch.clamp(d, min=0.0))
        sqrt_d = torch.where(d < 0, float("nan"), sqrt_d)
        sg = torch.where(b >= 0, 1.0, -1.0).to(b.dtype)
        q = -0.5 * (b + sg * sqrt_d)
        a0 = a == 0
        q0 = q == 0
        t1 = torch.where(a0, float("inf"), q / torch.where(a0, 1.0, a))
        t2 = torch.where(q0, 0.0, c / torch.where(q0, 1.0, q))
        use1 = torch.abs(zl + t1 * N) <= torch.abs(zl + t2 * N)
        t = torch.where(use1, t1, t2)
    elif newton:
        # the stopped iterate t_s, then the one step through which the
        # gradient runs
        if t_s is None:
            t_s = geom.newton_stopped(code, R, k, c, xl, yl, zl, L, M, N,
                                      newton_iters)
        cu = 1.0 / R
        Xs, Ys = xl + t_s * L, yl + t_s * M
        (s_s, W_s, Wr_s, scu_s, sk_s, Wcu_s, Wk_s, rho_s,
         beta_s) = geom.sag_point(code, R, k, c, Xs**2 + Ys**2, grad=True)
        f = zl + t_s * N - s_s
        fp = N - W_s * (Xs * L + Ys * M)
        okf = fp.abs() > 1e-14
        fp = torch.where(okf, fp, 1e-14)
        t = t_s - f / fp
    elif cart:
        # the stopped iterate, then the one step through which the gradient
        # runs: f' = N - (sx L + sy M) at (Xs, Ys)
        if t_s is None:
            t_s = geom.newton_stopped(code, R, k, c, xl, yl, zl, L, M, N,
                                      newton_iters, p1, p2, lay)
        Xs, Ys = xl + t_s * L, yl + t_s * M
        ps = geom.cart_point(code, R, k, c, p1, p2, Xs, Ys, grad=True,
                             lay=lay)
        f = zl + t_s * N - ps.s
        fp = N - (ps.sx * L + ps.sy * M)
        okf = fp.abs() > 1e-14
        fp = torch.where(okf, fp, 1e-14)
        t = t_s - f / fp
    elif nrb:
        fw = nurbs_forward(c, lay, xl, yl, zl, L, M, N, newton_iters)
        t = fw.t
    else:
        big = torch.abs(N) > 1e-14
        Ns = torch.where(big, N, 1e-14)
        t = -zl / Ns
    x1 = xl + t * L
    y1 = yl + t * M
    if std:
        r2 = x1**2 + y1**2
        qn = 1 - (1 + k) * cu**2 * r2
        rq = torch.rsqrt(qn)
        invd = cu * rq
        fx = x1 * invd
        fy = y1 * invd
        im = torch.rsqrt(fx**2 + fy**2 + 1)
        nx, ny, nz = fx * im, fy * im, -im
    elif newton:
        (_, W1, Wr1, _, _, Wcu1, Wk1, rho1,
         beta1) = geom.sag_point(code, R, k, c, x1**2 + y1**2, grad=True)
        fx = x1 * W1
        fy = y1 * W1
        im = torch.rsqrt(fx**2 + fy**2 + 1)
        nx, ny, nz = fx * im, fy * im, -im
    elif cart:
        # the normal's slopes (CHEBYSHEV: the reference's, and 1 / sqrt)
        p1n = geom.cart_point(code, R, k, c, p1, p2, x1, y1, grad=True,
                              normal=True, lay=lay)
        fx, fy = p1n.sx, p1n.sy
        if code == geom.CHEBYSHEV:
            im = 1.0 / torch.sqrt(fx**2 + fy**2 + 1)
        else:
            im = torch.rsqrt(fx**2 + fy**2 + 1)
        nx, ny, nz = fx * im, fy * im, -im
    elif nrb:
        nx, ny, nz = fw.normal
    else:
        nx, ny, nz = geom._normal_plane(x1)
    dot = L * nx + M * ny + N * nz
    sgn = torch.sign(dot)
    nxs, nys, nzs = nx * sgn, ny * sgn, nz * sgn
    adot = torch.abs(dot)

    z1 = zl + t * N
    # the local post-interaction directions
    if grating:
        # the groove vector (from the raw normal), d_eff, the tangential
        # momentum P, its root and D = d_eff n_post
        mlam = p[P_MLAM]
        if refl:
            npost = n_pre
        if std:
            qg = 1 - (1 + k) * r2 / R**2
            sqq = torch.sqrt(torch.clamp(qg, min=1e-14))
            den_g = R * sqq
            ta = torch.tan(p2)
            dzd = (x1 + y1 * ta) / den_g
            tmag = torch.sqrt(1 + ta * ta + dzd * dzd)
            tv = (1.0 / tmag, ta / tmag, dzd / tmag)
            gv = (ny * tv[2] - nz * tv[1], -nx * tv[2] + nz * tv[0],
                  nx * tv[1] - ny * tv[0])
            gmag = torch.sqrt(gv[0]**2 + gv[1]**2 + gv[2]**2)
            fv = tuple(-v / gmag for v in gv)
        else:
            ones = torch.ones_like(x1)
            fv = (-torch.sin(p2) * ones, torch.cos(p2) * ones,
                  torch.zeros_like(x1))
        ffg = fv[0]**2 + fv[1]**2
        ffc = torch.clamp(ffg, min=1e-12)
        d_eff = p1 / torch.sqrt(ffc)
        fn = fv[0] * nxs + fv[1] * nys + fv[2] * nzs
        kv = (L - adot * nxs, M - adot * nys, N - adot * nzs)
        Pv = tuple(d_eff * n_pre * kv[j] + mlam * (fv[j] - fn * ns)
                   for j, ns in enumerate((nxs, nys, nzs)))
        D = d_eff * npost
        rad = D * D - (Pv[0]**2 + Pv[1]**2 + Pv[2]**2)
        ok_g = rad >= 0
        root = torch.where(ok_g, torch.sqrt(torch.where(ok_g, rad, 1.0)),
                           0.0)
        spg = -1.0 if refl else 1.0
        Lo = (spg * Pv[0] + nxs * root) / D
        Mo = (spg * Pv[1] + nys * root) / D
        No = (spg * Pv[2] + nzs * root) / D
    elif refl:
        Lo = L - 2 * adot * nxs
        Mo = M - 2 * adot * nys
        No = N - 2 * adot * nzs
    else:
        u = n_pre / npost
        root = torch.sqrt(1 - u * u * (1 - adot * adot))
        w = root - u * adot
        Lo = u * L + nxs * w
        Mo = u * M + nys * w
        No = u * N + nzs * w

    # ---- globalize: rotate back (tilted), then x = x1 + dx, y = y1 + dy,
    # z = z1 + pos ----
    g_dx = gx
    g_dy = gy
    g_pos = gz
    if tilted:
        (gx, gy, gz, gL_o, gM_o, gN_o), g_glob = _rot_global_adjoint(
            p, (x1, y1, z1, Lo, Mo, No), (gx, gy, gz, gL_o, gM_o, gN_o))
    g_x1, g_y1, g_z1 = gx, gy, gz
    # cotangents of the local post-interaction directions: the output's and
    # the extras' L1, M1, N1
    gL_i, gM_i, gN_i = gL_o, gM_o, gN_o
    if g_ext is not None:
        gL_i, gM_i, gN_i = gL_o + g_ext[3], gM_o + g_ext[4], gN_o + g_ext[5]

    # ---- interact ----
    if grating:
        # k_out = (+-P + ns root) / D
        g_P = [spg * v / D for v in (gL_i, gM_i, gN_i)]
        g_nxs = gL_i * root / D
        g_nys = gM_i * root / D
        g_nzs = gN_i * root / D
        g_root = (gL_i * nxs + gM_i * nys + gN_i * nzs) / D
        g_D = -(gL_i * Lo + gM_i * Mo + gN_i * No) / D
        # root = sqrt(rad) where the order propagates, else 0
        g_rad = torch.where(
            ok_g, g_root * 0.5 / torch.sqrt(torch.where(ok_g, rad, 1.0)), 0.0)
        g_D = g_D + 2 * D * g_rad
        g_P = [gp - 2 * pv * g_rad for gp, pv in zip(g_P, Pv)]
        # D = d_eff n_post; P = d_eff n_pre (k - adot ns) + mlam (f - fn ns)
        g_deff = g_D * npost + n_pre * (g_P[0] * kv[0] + g_P[1] * kv[1]
                                        + g_P[2] * kv[2])
        g_npost_g = g_D * d_eff
        g_npre = d_eff * (g_P[0] * kv[0] + g_P[1] * kv[1] + g_P[2] * kv[2])
        gL, gM, gN = (d_eff * n_pre * v for v in g_P)
        gPn = g_P[0] * nxs + g_P[1] * nys + g_P[2] * nzs
        g_adot = -d_eff * n_pre * gPn
        g_fn = -mlam * gPn
        g_nxs = g_nxs - (d_eff * n_pre * adot + mlam * fn) * g_P[0]
        g_nys = g_nys - (d_eff * n_pre * adot + mlam * fn) * g_P[1]
        g_nzs = g_nzs - (d_eff * n_pre * adot + mlam * fn) * g_P[2]
        g_f = [mlam * g_P[0] + g_fn * nxs, mlam * g_P[1] + g_fn * nys,
               mlam * g_P[2] + g_fn * nzs]
        g_nxs = g_nxs + g_fn * fv[0]
        g_nys = g_nys + g_fn * fv[1]
        g_nzs = g_nzs + g_fn * fv[2]
        # d_eff = d / sqrt(max(fx^2 + fy^2, 1e-12))
        g_p1 = g_deff / torch.sqrt(ffc)
        g_ff = torch.where(ffg > 1e-12, -0.5 * g_deff * d_eff / ffc, 0.0)
        g_f[0] = g_f[0] + 2 * fv[0] * g_ff
        g_f[1] = g_f[1] + 2 * fv[1] * g_ff
        if refl:
            g_npre = g_npre + g_nn + g_npost_g
            g_npost = torch.zeros_like(gx)
        else:
            g_npost = g_nn + g_npost_g
    elif refl:
        gL, gM, gN = gL_i, gM_i, gN_i
        g_nxs = -2 * adot * gL_i
        g_nys = -2 * adot * gM_i
        g_nzs = -2 * adot * gN_i
        g_adot = -2 * (nxs * gL_i + nys * gM_i + nzs * gN_i)
        g_npre = g_nn
        g_npost = torch.zeros_like(gx)
    else:
        gL, gM, gN = u * gL_i, u * gM_i, u * gN_i
        g_nxs = w * gL_i
        g_nys = w * gM_i
        g_nzs = w * gN_i
        g_w = nxs * gL_i + nys * gM_i + nzs * gN_i
        g_u = L * gL_i + M * gM_i + N * gN_i - adot * g_w
        g_adot = -u * g_w
        g_u = g_u - g_w * u * (1 - adot * adot) / root
        g_adot = g_adot + g_w * u * u * adot / root
        g_npre = g_u / npost
        g_npost = g_nn - g_u * u / npost
    if g_ext is not None:
        # the extras' local pre-interaction directions and adot
        gL, gM, gN = gL + g_ext[0], gM + g_ext[1], gN + g_ext[2]
        g_adot = g_adot + g_ext[6]
    # adot = L nxs + M nys + N nzs (the sign folded into the normal)
    gL = gL + nxs * g_adot
    gM = gM + nys * g_adot
    gN = gN + nzs * g_adot
    g_nxs = g_nxs + L * g_adot
    g_nys = g_nys + M * g_adot
    g_nzs = g_nzs + N * g_adot

    g_k = torch.zeros_like(gx)
    g_cu = torch.zeros_like(gx)
    g_Rg = 0.0
    g_nraw = (0.0, 0.0, 0.0)
    if grating and std:
        # the groove frame: f = -g / |g|, g = n x t (raw n),
        # t = (1, ta, dzd) / tmag
        g_gh = [-v for v in g_f]
        gh = [v / gmag for v in gv]
        ghd = gh[0] * g_gh[0] + gh[1] * g_gh[1] + gh[2] * g_gh[2]
        g_g = [(g_gh[j] - gh[j] * ghd) / gmag for j in range(3)]
        g_nraw = (tv[1] * g_g[2] - tv[2] * g_g[1],
                  tv[2] * g_g[0] - tv[0] * g_g[2],
                  tv[0] * g_g[1] - tv[1] * g_g[0])
        g_t = (g_g[1] * nz - g_g[2] * ny, g_g[2] * nx - g_g[0] * nz,
               g_g[0] * ny - g_g[1] * nx)
        gtd = tv[0] * g_t[0] + tv[1] * g_t[1] + tv[2] * g_t[2]
        g_ta = (g_t[1] - tv[1] * gtd) / tmag
        g_dzd = (g_t[2] - tv[2] * gtd) / tmag
        # dzd = (x1 + y1 ta) / den_g, den_g = R sqrt(max(qg, 1e-14))
        g_x1 = g_x1 + g_dzd / den_g
        g_y1 = g_y1 + g_dzd * ta / den_g
        g_ta = g_ta + g_dzd * y1 / den_g
        g_den = -g_dzd * dzd / den_g
        g_p2 = g_ta * (1 + ta * ta)
        g_Rg = g_den * sqq
        g_qg = torch.where(qg > 1e-14, g_den * R * 0.5 / sqq, 0.0)
        g_k = g_k - g_qg * r2 / R**2
        g_Rg = g_Rg + g_qg * 2 * (1 + k) * r2 / R**3
        g_x1 = g_x1 - 2 * x1 * g_qg * (1 + k) / R**2
        g_y1 = g_y1 - 2 * y1 * g_qg * (1 + k) / R**2
    elif grating:
        # f = (-sin p2, cos p2, 0)
        g_p2 = -torch.cos(p2) * g_f[0] - torch.sin(p2) * g_f[1]
    # ---- normal (STANDARD; the plane normal is constant) ----
    if std:
        g_nx = sgn * g_nxs + g_nraw[0]
        g_ny = sgn * g_nys + g_nraw[1]
        g_nz = sgn * g_nzs + g_nraw[2]
        g_fx = g_nx * im
        g_fy = g_ny * im
        g_im = g_nx * fx + g_ny * fy - g_nz
        g_mg = -0.5 * g_im * im * im * im
        g_fx = g_fx + 2 * fx * g_mg
        g_fy = g_fy + 2 * fy * g_mg
        g_x1 = g_x1 + g_fx * invd
        g_y1 = g_y1 + g_fy * invd
        g_invd = g_fx * x1 + g_fy * y1
        g_cu = g_cu + g_invd * rq
        g_qn = -0.5 * g_invd * cu * rq * rq * rq
        g_k = g_k - g_qn * cu**2 * r2
        g_cu = g_cu - g_qn * (1 + k) * 2 * cu * r2
        g_r2 = -g_qn * (1 + k) * cu**2
        g_x1 = g_x1 + 2 * x1 * g_r2
        g_y1 = g_y1 + 2 * y1 * g_r2
    elif newton:
        # n = (x1 W1, y1 W1, -1) rsqrt(.), W1 = W(x1^2 + y1^2)
        g_nx, g_ny, g_nz = sgn * g_nxs, sgn * g_nys, sgn * g_nzs
        g_fx = g_nx * im
        g_fy = g_ny * im
        g_im = g_nx * fx + g_ny * fy - g_nz
        g_mg = -0.5 * g_im * im * im * im
        g_fx = g_fx + 2 * fx * g_mg
        g_fy = g_fy + 2 * fy * g_mg
        g_x1 = g_x1 + g_fx * W1
        g_y1 = g_y1 + g_fy * W1
        g_W1 = g_fx * x1 + g_fy * y1
        g_r2 = g_W1 * Wr1
        g_x1 = g_x1 + 2 * x1 * g_r2
        g_y1 = g_y1 + 2 * y1 * g_r2
        g_cu = g_cu + g_W1 * Wcu1
        g_k = g_k + g_W1 * Wk1
        cc1 = g_W1 * beta1
    elif cart:
        # n = (fx, fy, -1) im, (fx, fy) the normal's slopes at (x1, y1)
        g_nx, g_ny, g_nz = sgn * g_nxs, sgn * g_nys, sgn * g_nzs
        g_fx = g_nx * im
        g_fy = g_ny * im
        g_im = g_nx * fx + g_ny * fy - g_nz
        g_mg = -0.5 * g_im * im * im * im
        g_fx = g_fx + 2 * fx * g_mg
        g_fy = g_fy + 2 * fy * g_mg
        g_x1 = g_x1 + g_fx * p1n.hxx + g_fy * p1n.hyx
        g_y1 = g_y1 + g_fx * p1n.hxy + g_fy * p1n.hyy
        g_Rd = g_fx * p1n.dR[1] + g_fy * p1n.dR[2]
        g_k = g_k + g_fx * p1n.dk[1] + g_fy * p1n.dk[2]
        g_p1 = g_fx * p1n.dp1[1] + g_fy * p1n.dp1[2]
        g_p2 = g_fx * p1n.dp2[1] + g_fy * p1n.dp2[2]
        w1 = geom.coef_weights(code, p1n, 0.0 * g_fx, g_fx, g_fy)
    elif nrb:
        # the normal comes from the solve (its cotangent goes there)
        g_nrb = (sgn * g_nxs, sgn * g_nys, sgn * g_nzs)

    # ---- propagate: x1 = xl + t L, y1 = yl + t M, z1 = zl + t N ----
    g_xl, g_yl, g_zl = g_x1, g_y1, g_z1
    g_t = g_x1 * L + g_y1 * M + g_z1 * N
    gL = gL + g_x1 * t
    gM = gM + g_y1 * t
    gN = gN + g_z1 * t

    # ---- clip, absorption, OPD (full step) ----
    if full:
        i_in = st[6]
        g_i, g_opd = g[7], g[8]
        r2c = x1 * x1 + y1 * y1
        clipped = r2c > p[P_APMAX] * p[P_APMAX]
        if inner:
            clipped = clipped | (r2c < p[P_APMIN] * p[P_APMIN])
        if grating:
            clipped = clipped | ~ok_g
        g_i = torch.where(clipped, 0.0, g_i)
        g_kpre = torch.zeros_like(gx)
        if absorbs:
            kpre = p[P_KPRE]
            e = torch.exp(ABS * kpre * t * 1e3)
            g_a = g_i * i_in * e
            g_t = g_t + g_a * (ABS * kpre * 1e3)
            g_kpre = g_a * (ABS * t * 1e3)
            g_i = g_i * e
        s_tn = torch.sign(t * n_pre)
        g_t = g_t + g_opd * s_tn * n_pre
        g_npre = g_npre + g_opd * s_tn * t

    # ---- intersect ----
    if std:
        # t = q/a (root 1, a != 0) or c/q (root 2, q != 0); 0 otherwise
        ok1 = use1 & ~a0
        ok2 = ~use1 & ~q0
        a_s = torch.where(a0, 1.0, a)
        q_s = torch.where(q0, 1.0, q)
        g_q = torch.where(ok1, g_t / a_s, torch.where(ok2, -g_t * t2 / q_s, 0.0))
        g_a = torch.where(ok1, -g_t * t1 / a_s, 0.0)
        g_c = torch.where(ok2, g_t / q_s, 0.0)
        g_b = -0.5 * g_q
        g_sd = -0.5 * sg * g_q
        g_d = g_sd * 0.5 / sqrt_d
        g_b = g_b + 2 * b * g_d
        g_a = g_a - 4 * c * g_d
        g_c = g_c - 4 * a * g_d
        # a = cu A
        g_cu = g_cu + g_a * A
        g_A = g_a * cu
        g_k = g_k + g_A * N**2
        gL = gL + 2 * L * g_A
        gM = gM + 2 * M * g_A
        gN = gN + 2 * N * (k + 1) * g_A
        # b = 2 (cu B - N)
        g_cu = g_cu + 2 * g_b * Bq
        g_B = 2 * g_b * cu
        gN = gN - 2 * g_b
        g_k = g_k + g_B * N * zl
        gN = gN + g_B * (k * zl + zl)
        g_zl = g_zl + g_B * (k * N + N)
        gL = gL + g_B * xl
        g_xl = g_xl + g_B * L
        gM = gM + g_B * yl
        g_yl = g_yl + g_B * M
        # c = cu C - 2 zl
        g_cu = g_cu + g_c * Cq
        g_C = g_c * cu
        g_zl = g_zl - 2 * g_c
        g_k = g_k + g_C * zl**2
        g_xl = g_xl + 2 * xl * g_C
        g_yl = g_yl + 2 * yl * g_C
        g_zl = g_zl + 2 * zl * (k + 1) * g_C
        g_R = -g_cu * cu**2
    elif newton:
        # t = t_s - f / f' at the stopped t_s: f = zl + t_s N - s(X, Y),
        # f' = N - W (X L + Y M), X = xl + t_s L, Y = yl + t_s M
        g_f = -g_t / fp
        g_fp = torch.where(okf, g_t * f / (fp * fp), 0.0)
        g_zl = g_zl + g_f
        gN = gN + g_f * t_s + g_fp
        g_s = -g_f
        g_W = -g_fp * (Xs * L + Ys * M)
        gL = gL - g_fp * W_s * Xs
        gM = gM - g_fp * W_s * Ys
        g_X = -g_fp * W_s * L
        g_Y = -g_fp * W_s * M
        # ds/dr^2 = W / 2
        g_r2 = g_s * W_s * 0.5 + g_W * Wr_s
        g_X = g_X + 2 * Xs * g_r2
        g_Y = g_Y + 2 * Ys * g_r2
        g_cu = g_cu + g_s * scu_s + g_W * Wcu_s
        g_k = g_k + g_s * sk_s + g_W * Wk_s
        g_xl = g_xl + g_X
        g_yl = g_yl + g_Y
        gL = gL + g_X * t_s
        gM = gM + g_Y * t_s
        g_R = -g_cu * cu**2
        # dC_i = g_s rho_s^(i+1) + (i+1) (g_W beta_s rho_s^i + cc1 rho1^i)
        cs = g_W * beta_s
        pw_s = torch.ones_like(rho_s)
        pw_1 = torch.ones_like(rho1)
        g_coef = []
        for i in range(c.shape[-1]):
            g_coef.append(g_s * pw_s * rho_s + (i + 1) * (cs * pw_s
                                                          + cc1 * pw_1))
            pw_s = pw_s * rho_s
            pw_1 = pw_1 * rho1
    elif cart:
        # t = t_s - f / f' at the stopped t_s: f = zl + t_s N - s(X, Y),
        # f' = N - (sx L + sy M), X = xl + t_s L, Y = yl + t_s M
        g_f = -g_t / fp
        g_fp = torch.where(okf, g_t * f / (fp * fp), 0.0)
        g_zl = g_zl + g_f
        gN = gN + g_f * t_s + g_fp
        g_s = -g_f
        g_sx = -g_fp * L
        g_sy = -g_fp * M
        gL = gL - g_fp * ps.sx
        gM = gM - g_fp * ps.sy
        g_X = g_s * ps.sx + g_sx * ps.hxx + g_sy * ps.hyx
        g_Y = g_s * ps.sy + g_sx * ps.hxy + g_sy * ps.hyy
        g_R = g_Rd + g_s * ps.dR[0] + g_sx * ps.dR[1] + g_sy * ps.dR[2]
        g_k = g_k + g_s * ps.dk[0] + g_sx * ps.dk[1] + g_sy * ps.dk[2]
        g_p1 = g_p1 + g_s * ps.dp1[0] + g_sx * ps.dp1[1] + g_sy * ps.dp1[2]
        g_p2 = g_p2 + g_s * ps.dp2[0] + g_sx * ps.dp2[1] + g_sy * ps.dp2[2]
        ws = geom.coef_weights(code, ps, g_s, g_sx, g_sy)
        reads_k, reads_p1, reads_p2 = geom.cart_reads(code)
        if not reads_k:
            g_k = torch.zeros_like(g_k)
        if not reads_p1:
            g_p1 = torch.zeros_like(g_p1)
        if not reads_p2:
            g_p2 = torch.zeros_like(g_p2)
        g_xl = g_xl + g_X
        g_yl = g_yl + g_Y
        gL = gL + g_X * t_s
        gM = gM + g_Y * t_s
        g_coef = geom.coef_columns(code, c.shape[-1], p1, p2, Xs, Ys, ws, x1,
                                   y1, w1, lay) + [g_p1, g_p2]
    elif nrb:
        g_r0, g_k3, g_net = nurbs_adjoint(fw, g_t, g_nrb)
        g_xl = g_xl + g_r0[0]
        g_yl = g_yl + g_r0[1]
        g_zl = g_zl + g_r0[2]
        gL = gL + g_k3[0]
        gM = gM + g_k3[1]
        gN = gN + g_k3[2]
        g_R = torch.zeros_like(gx)
        g_coef = list(g_net.unbind(0))
        g_coef += [torch.zeros_like(gx)] * (c.shape[-1] - len(g_coef))
    else:
        g_zl = g_zl - g_t / Ns
        gN = gN + torch.where(big, g_t * zl / (Ns * Ns), 0.0)
        g_R = torch.zeros_like(gx)

    # ---- tilts: through the rotations (tilted), or at zero, where the
    # localize rotates by -angle, the globalize by +angle and each
    # rotation's derivative is its generator acting on the state ----
    if tilted:
        (g_xl, g_yl, g_zl, gL, gM, gN), g_loc = _rot_local_adjoint(
            p, (xl, yl, zl, L, M, N), (g_xl, g_yl, g_zl, gL, gM, gN))
        g_rx, g_ry, g_rz = (a + b for a, b in zip(g_glob, g_loc))
    else:
        g_rx = (g_yl * zl - g_zl * yl + gM * N - gN * M
                - gy * z1 + gz * y1 - gM_o * No + gN_o * Mo)
        g_ry = (-g_xl * zl + g_zl * xl - gL * N + gN * L
                + gx * z1 - gz * x1 + gL_o * No - gN_o * Lo)
        g_rz = (g_xl * yl - g_yl * xl + gL * M - gM * L
                - gx * y1 + gy * x1 - gL_o * Mo + gM_o * Lo)

    # ---- localize: xl = x - dx, yl = y - dy, zl = z - pos ----
    g_dx = g_dx - g_xl
    g_dy = g_dy - g_yl
    g_pos = g_pos - g_zl
    g_in = (g_xl, g_yl, g_zl, gL, gM, gN)
    cols = (g_R + g_Rg, g_k, g_pos, g_npost, g_dx, g_dy, g_rx, g_ry, g_rz)
    if full:
        g_in = g_in + (g_i, g_opd)
        cols = cols + (g_kpre,)
    if newton or cart or nrb:
        cols = cols + tuple(g_coef)
    if grating:
        cols = cols + (g_p1, g_p2)
    return g_in, g_npre, cols
