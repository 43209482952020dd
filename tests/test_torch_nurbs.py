"""optiland_torch's NURBS surfaces (kernel K6d) through core/nurbs.py, the
plain engine, the kernels' plain versions and the entry points, against the
JAX package and the original Optiland, on the CPU in float64.

  * ``core/nurbs.py`` against the JAX package's on a rational 4 x 4 net
    (degrees 2 and 3), at knots and at the box's edges: the basis values
    and their first and second derivatives (``jax.jvp`` of its recurrence),
    ``nurbs_eval``, ``sag``, ``surface_normal`` and ``intersect`` to
    1e-13, the conic fit (``approximate_surface``, ``build_nurbs_def``)
    exactly;
  * the golden traces of the original Optiland (``tests/goldens/nurbs.npz``:
    the explicit rational net and the conic fit, 91 rays each) through
    ``Optic.trace`` (the plain engine) and the generic kernel's plain
    version to rtol 1e-8, atol 1e-10, the JAX package's own tolerance;
  * the hand adjoint of ``step_plain`` with a NURBS surface against
    ``jax.vjp`` of the JAX package's in-kernel step ``_step_tile`` (eager,
    2 Newton steps) on rays that clip at the box's edges, take the other
    plane pair (L > M and L > N) or cross the surface backwards, and at
    the det clamp, to rtol 1e-9 with atol 1e-11 x the largest entry; and
    against autograd of ``step_plain`` (every flag) to rtol 1e-10;
  * each plain kernel version (merit, field, generic, poly, polarized
    backwards) against autograd of its plain forward, to rtol 1e-9 of
    the largest entry;
  * ``trace_fast``, ``trace_fast_field`` and ``spot_rms_fast_field`` of
    each NURBS lens (and ``trace_fast_poly``) against the plain engine:
    values to rtol 1e-12, every stack leaf's gradient to 1e-9 of the
    largest entry (10 kernel Newton steps against the engine's 24, both
    converged);
  * ``Optic``'s four construction modes and ``system_from_numpy`` of a JAX
    NURBS system against the JAX package's stack and extras; the launch
    checks (the nurbs build, its refusals and the net's bound); a control
    point's gradient against central differences (as the JAX package's
    ``test_nurbs_control_point_gradient``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch.core import geometry as tg
from optiland_torch.core import nurbs as tn
from optiland_torch.core import raygen as traygen
from optiland_torch.core import trace as ttrace
from optiland_torch.core.system import STACK_FIELDS, system_from_numpy
from optiland_torch.ops import fast_trace as ftr
from optiland_torch.ops import fused_trace as ft
from optiland_torch.ops import launch
from optiland_torch.ops import pol_trace as pt
from optiland_torch.ops import step
from optiland_torch.optic import Optic as TOptic
from optiland_torch.polarization import create_polarization
from optiland_torch.samples import nurbs as ns
from optiland_tpu.core import nurbs as jn
from optiland_tpu.ops import pallas_trace as jpt
from optiland_tpu.optic import Optic as JOptic
from tests.test_torch_freeform import f64, np_of, pupil, with_leaves

WL = ns.WAVELENGTH
H = (0.3, 0.7)
GOLDEN_COLS = ("x", "y", "L", "M", "N", "i")
N_JAX = 24  # rays of the tests against JAX's eager NURBS code


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


def small_net(flat=False):
    """(coefficient row, structure) of a rational 4 x 4 net on [-5, 5]^2,
    degree 2 in u and 3 in v: a perturbed paraboloid, or (``flat``) the
    plane z = 0."""
    rng = np.random.default_rng(0)
    xs = np.linspace(-5, 5, 4)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    Z = 0 * X if flat else (X**2 + Y**2) / 60 + 0.02 * rng.normal(
        size=X.shape)
    W = 1 + 0.3 * rng.random((4, 4))
    return tn.build_nurbs_def(control_points=np.stack([X, Y, Z]), weights=W,
                              u_degree=2, v_degree=3)


def _jnp(*vals):
    return [jnp.asarray(v) for v in vals]


# ---------------------------------------------------------------------------
# core/nurbs.py against the JAX package's
# ---------------------------------------------------------------------------


def test_basis_and_net_match_jax():
    """Basis values, first and second derivatives and the net's point at
    knots, inside spans and at both ends of the box."""
    c, net = small_net()
    _, nu, nv, p, q, uk, vk = net
    u = np.array([0.0, 0.1, 1 / 3, 0.5, 0.77, 1.0])
    for knots, n, deg in ((uk, nu - 1, p), (vk, nv - 1, q)):
        got = tn.basis_ders(knots, n, deg, f64(u), 2)

        def basis(w, knots=knots, n=n, deg=deg):
            return jn.basis_list(knots, n, deg, w)

        ones = jnp.ones(u.shape)
        ref0 = basis(jnp.asarray(u))
        ref1 = jax.jvp(basis, (jnp.asarray(u),), (ones,))[1]
        ref2 = jax.jvp(lambda w: jax.jvp(basis, (w,), (ones,))[1],
                       (jnp.asarray(u),), (ones,))[1]
        for order, ref in enumerate((ref0, ref1, ref2)):
            for a, b in zip(got[order], ref):
                np.testing.assert_allclose(np_of(a), np.asarray(b),
                                           rtol=1e-13, atol=1e-13,
                                           err_msg=f"order {order}")
    v = np.array([0.2, 0.0, 0.9, 1.0, 0.5, 1 / 3])
    P, W = tn.unpack_pw(f64(c), net)
    Pj, Wj = jn.unpack_pw(jnp.asarray(c), net)
    np.testing.assert_allclose(
        np_of(tn.nurbs_eval(P, W, net, f64(u), f64(v))),
        np.asarray(jn.nurbs_eval(Pj, Wj, net, *_jnp(u, v))), rtol=1e-13,
        atol=1e-13)


def test_sag_normal_intersect_match_jax():
    """sag, surface_normal and intersect (24 Newton steps in f64) on points
    inside the net, on its edge and outside it (clipped to the box)."""
    c, net = small_net()
    # N_JAX points (the eager JAX ops of the module's tests share shapes)
    x = np.resize([-4.9, -1.0, 0.0, 0.5, 2.0, 5.0, 6.5], N_JAX)
    y = np.resize([0.3, 2.0, -5.0, 0.0, 1.0, -1.0, 6.0], N_JAX)
    z = np.full(N_JAX, -1.0)
    L = np.resize([0.1, 0.75, 0.0, -0.1, 0.05, 0.2, -0.3], N_JAX)
    M = np.resize([0.05, 0.1, 0.2, 0.0, -0.1, 0.3, 0.1], N_JAX)
    N = np.sqrt(1 - L**2 - M**2)
    tc, jc = f64(c), jnp.asarray(c)
    np.testing.assert_allclose(
        np_of(tn.sag(tc, net, f64(x), f64(y))),
        np.asarray(jn.sag(jc, net, *_jnp(x, y))), rtol=1e-13, atol=1e-13)
    for a, b in zip(tn.surface_normal(tc, net, f64(x), f64(y)),
                    jn.surface_normal(jc, net, *_jnp(x, y))):
        np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=1e-13,
                                   atol=1e-13)
    t, nrm = tn.intersect(tc, net, *(f64(v) for v in (x, y, z, L, M, N)))
    jt, jnrm = jn.intersect(jc, net, *_jnp(x, y, z, L, M, N))
    np.testing.assert_allclose(np_of(t), np.asarray(jt), rtol=1e-13)
    for a, b in zip(nrm, jnrm):
        np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=1e-13,
                                   atol=1e-13)


def test_nonuniform_net_matches_jax():
    """The non-uniform net of samples/nurbs.py (degree 2 x 3, a repeated
    interior u knot, rational): basis values and derivatives, the net's
    point and the intersection (24 Newton steps in f64) against the JAX
    package's core/nurbs, at its knots (the repeated one too), at 0 and 1,
    inside spans and past the box."""
    P, W, uk, vk = ns.nonuniform_net()
    net = ("nurbs", 6, 5, 2, 3, uk, vk)
    c = np.concatenate([P.ravel(), W.ravel()])
    u = np.array([0.0, 0.1, 0.25, 0.3, 0.625, 0.9, 1.0, 0.375])
    for knots, n, deg in ((uk, 5, 2), (vk, 4, 3)):
        got = tn.basis_ders(knots, n, deg, f64(u), 2)

        def basis(w, knots=knots, n=n, deg=deg):
            return jn.basis_list(knots, n, deg, w)

        ones = jnp.ones(u.shape)

        def ders(w, basis=basis, ones=ones):
            return (basis(w), jax.jvp(basis, (w,), (ones,))[1],
                    jax.jvp(lambda w: jax.jvp(basis, (w,), (ones,))[1],
                            (w,), (ones,))[1])

        for order, ref in enumerate(ders(jnp.asarray(u))):
            for a, b in zip(got[order], ref):
                np.testing.assert_allclose(np_of(a), np.asarray(b),
                                           rtol=1e-13, atol=1e-12,
                                           err_msg=f"order {order}")
    v = u[::-1].copy()
    Pt, Wt = tn.unpack_pw(f64(c), net)
    Pj, Wj = jn.unpack_pw(jnp.asarray(c), net)
    np.testing.assert_allclose(
        np_of(tn.nurbs_eval(Pt, Wt, net, f64(u), f64(v))),
        np.asarray(jn.nurbs_eval(Pj, Wj, net, *_jnp(u, v))), rtol=1e-13,
        atol=1e-13)
    x = np.resize([-7.0, -3.5, 1.75, 0.2, 5.0, 7.0, 8.0], N_JAX)
    y = np.resize([-1.75, 7.0, -7.0, 0.0, 3.0, -2.0, 1.0], N_JAX)
    z = np.full(N_JAX, -1.0)
    L = np.resize([0.0, 0.05, -0.1, 0.1, 0.0, -0.05, 0.02], N_JAX)
    M = np.resize([0.0, -0.05, 0.1, 0.0, 0.1, 0.05, -0.02], N_JAX)
    N = np.sqrt(1 - L**2 - M**2)
    t, nrm = tn.intersect(f64(c), net, *(f64(w) for w in (x, y, z, L, M, N)))
    jt, jnrm = jn.intersect(jnp.asarray(c), net, *_jnp(x, y, z, L, M, N))
    np.testing.assert_allclose(np_of(t), np.asarray(jt), rtol=1e-13)
    for a, b in zip(nrm, jnrm):
        np.testing.assert_allclose(np_of(a), np.asarray(b), rtol=1e-13,
                                   atol=1e-13)


def test_fit_matches_jax():
    """The conic fit (A9.7) and every construction mode's row and
    structure, exactly."""
    pts = [[x, y, (x * x + y * y) / 90] for x in np.linspace(-4, 4, 6)
           for y in np.linspace(-3, 3, 5)]
    got = tn.approximate_surface(pts, 6, 5, 3, 2)
    ref = jn.approximate_surface(pts, 6, 5, 3, 2)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(ref[0]))
    assert got[1:] == ref[1:]
    P = np.stack(list(np.meshgrid(np.linspace(-2, 2, 5),
                                  np.linspace(-2, 2, 4), indexing="ij"))
                 + [np.zeros((5, 4))])
    for kw in ({"radius": 40.0, "conic": -1.2, "nurbs_norm_x": 6.0,
                "nurbs_norm_y": 5.0, "n_points_u": 6, "x_center": 0.5},
               {"control_points": P},
               {"control_points": P, "u_degree": 2, "v_degree": 2},
               {"control_points": P, "weights": np.ones((5, 4)),
                "u_knots": [0, 0, 0, 0.3, 0.6, 1, 1, 1], "u_degree": 2}):
        (a, aux_a), (b, aux_b) = (tn.build_nurbs_def(**kw),
                                  jn.build_nurbs_def(**kw))
        np.testing.assert_array_equal(a, b)
        assert aux_a == aux_b


# ---------------------------------------------------------------------------
# The golden traces of the original Optiland
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,key", [("rational_nurbs", "explicit"),
                                      ("fitted_nurbs", "fitted")])
def test_golden_traces(name, key):
    """Optic.trace (the plain engine, 24 Newton steps) and the generic
    kernel's plain version (10) reproduce the original Optiland's rays."""
    g = np.load("tests/goldens/nurbs.npz")
    lens = ns.BUILDERS[name]()
    rays = lens.trace(Hy=1.0, num_rays=5)
    gen = traygen.generate_rays(lens.system, 0.0, 1.0, *(
        f64(v) for v in _hexapolar(5)), WL)
    fast = ftr.trace_fast(lens.system, gen, WL)
    for c in GOLDEN_COLS:
        for got in (rays, fast):
            np.testing.assert_allclose(np_of(getattr(got, c)),
                                       g[f"{key}_{c}"], rtol=1e-8,
                                       atol=1e-10, err_msg=c)


def _hexapolar(num_rings):
    """The pupil samples of Optic.trace's default distribution."""
    from optiland_torch.core.distributions import create_distribution

    d = create_distribution("hexapolar")
    d.generate_points(num_rings)
    return np_of(d.x), np_of(d.y)


# ---------------------------------------------------------------------------
# The step and its hand adjoint
# ---------------------------------------------------------------------------


def _params(tilted):
    p = np.zeros(step.NUM_P)
    p[step.P_RADIUS], p[step.P_POS] = np.inf, 3.0
    p[step.P_NPOST], p[step.P_APMAX] = 1.6, 6.0
    p[step.P_DX], p[step.P_DY], p[step.P_KPRE] = 0.1, -0.05, 0.01
    if tilted:
        p[step.P_RX], p[step.P_RY], p[step.P_RZ] = 0.01, -0.02, 0.015
    return p


def _rays(n, seed):
    """n rays over and past the net's box (some clip at its edges), half
    going +z from before the surface, half -z from behind it; the first
    four steep in x (L > M and L > N: the other plane pair)."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-6.5, 6.5, n), rng.uniform(-6.5, 6.5, n)
    L, M = rng.normal(0, 0.08, n), rng.normal(0, 0.08, n)
    L[:4], M[:4] = [0.75, 0.8, 0.7, 0.76], [0.1, -0.1, 0.05, 0.0]
    back = np.arange(n) % 2 == 1
    N = np.sqrt(1 - L**2 - M**2) * np.where(back, -1.0, 1.0)
    z = np.where(back, 8.0, -2.0)
    i, opd = rng.uniform(0.5, 1, n), rng.uniform(0, 1, n)
    return [x, y, z, L, M, N, i, opd]


def _port_step(p, st, c, net, refl, full, tilted, g, g_np, iters):
    """step_adjoint_plain: ({column: sum}, net cotangents, state
    cotangents, n_pre's) and the forward outputs."""
    ts = tuple(f64(v) for v in (st if full else st[:6]))
    tp, tc = f64(p), f64(c)
    out, n_next = step.step_plain(tg.NURBS, refl, tp, f64(1.0), ts,
                                  absorbs=full, c=tc, newton_iters=iters,
                                  lay=net)
    gt = tuple(f64(v) for v in g[:6]) + (f64(g_np),) + (
        tuple(f64(v) for v in g[6:]) if full else ())
    g_in, g_npre, cols = step.step_adjoint_plain(
        tg.NURBS, refl, tp, f64(1.0), ts, gt, absorbs=full, tilted=tilted,
        c=tc, newton_iters=iters, lay=net)
    base = step.FULL_GRAD_COLS if full else step.GRAD_COLS
    pairs, coef = step.split_cols(tg.NURBS, cols, base, len(c))
    return ({k: float(v.sum()) for k, v in pairs},
            np.array([float(v.sum()) for v in coef]),
            [np_of(v) for v in g_in], float(g_npre.sum()), out, n_next)


def _assert_step_vs_jax(p, st, c, net, refl, full, tilted, seed, iters=2):
    """The port's step and hand adjoint against JAX's in-kernel step and
    its vjp (rotation code on, as under jax.grad)."""
    rng = np.random.default_rng(seed)
    n = st[0].shape[0]
    g = [rng.normal(size=n) for _ in range(8)]
    if not full:
        g[6] = g[7] = np.zeros(n)
    g_np = rng.normal(size=n)
    cols, coef, g_in, g_npre, out, _ = _port_step(p, st, c, net, refl, full,
                                                  tilted, g, g_np, iters)

    def f(P, C, xs, npre):
        out = jpt._step_tile(1, tg.NURBS, refl, True, net,
                             lambda s, k: P[k], lambda s, k: C[k], len(c),
                             tuple(xs) + (npre, None), iters,
                             has_absorption=full)
        return out[:8], jnp.broadcast_to(out[8], xs[0].shape)

    args = (jnp.asarray(p), jnp.asarray(c), _jnp(*st), jnp.asarray(1.0))
    ref, pull = jax.vjp(f, *args)
    jp, jc, jx, jn_ = pull((tuple(jnp.asarray(v) for v in g),
                            jnp.asarray(g_np)))
    for k, o in enumerate(out):
        np.testing.assert_allclose(np_of(o), np.asarray(ref[0][k]),
                                   rtol=1e-12, atol=1e-12,
                                   err_msg=f"output {k}")
    scale = max(abs(float(jp[k])) for k in cols)
    for k, v in cols.items():
        np.testing.assert_allclose(v, float(jp[k]), rtol=1e-9,
                                   atol=1e-11 * scale, err_msg=f"column {k}")
    jc = np.asarray(jc)
    np.testing.assert_allclose(coef, jc, rtol=1e-9,
                               atol=1e-11 * np.abs(jc).max(), err_msg="net")
    for k, (a, b) in enumerate(zip(g_in, jx)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-9,
                                   atol=1e-11 * np.abs(b).max(),
                                   err_msg=f"state {k}")
    np.testing.assert_allclose(g_npre, float(jn_), rtol=1e-9)
    return coef


def test_step_adjoint_matches_jax_step_tile():
    """A paraboloid-like rational net, a tilted refracting surface (the
    full form): rays clipped at the box's edges, the other plane pair,
    rays from behind; the net's cotangent reaches every control point only
    through the rays' spans. (Reflection and the merit form share their
    code with the other families; the hand adjoint holds them against
    autograd below.)"""
    c, net = small_net()
    st = _rays(N_JAX, 3)
    x, y, z, L, M, N = (f64(v) for v in st[:6])
    fw = step.nurbs_forward(f64(c), net, x - 0.1, y + 0.05, z - 3.0, L, M,
                            N, 2)
    assert bool(((fw.U < 0) | (fw.U > 1) | (fw.V < 0) | (fw.V > 1)).any())
    assert bool(((L > M) & (L > N)).any())
    coef = _assert_step_vs_jax(_params(True), st, c, net, False, True, True,
                               4)
    assert np.abs(coef).min() > 0


def test_step_at_the_det_clamp():
    """On the plane z = 0, rays parallel to it (N = 0; one of each plane
    pair) make the 2x2 Jacobian singular (det = -k . (Su x Sv) = 0): the
    clamp binds, the step clips to the box, and neither passes a
    derivative, as in JAX's kernel step; other rays beside them are
    regular."""
    c, net = small_net(flat=True)
    st = _rays(N_JAX, 5)
    for j, (L, M) in enumerate(((0.8, 0.6), (-0.6, 0.8))):
        st[3][j], st[4][j], st[5][j] = L, M, 0.0
    x, y, z, L, M, N = (f64(v) for v in st[:6])
    fw = step.nurbs_forward(f64(c), net, x - 0.1, y + 0.05, z - 3.0, L, M,
                            N, 2)
    assert bool(fw.clamped[:2].all()) and not bool(fw.clamped[2:].any())
    _assert_step_vs_jax(_params(False), st, c, net, False, True, False, 6)


# ---------------------------------------------------------------------------
# The kernels' span-local net columns (csrc/nurbs_step.cuh), transcribed
# ---------------------------------------------------------------------------


def _span(U, m, n, u):
    """csrc/nurbs_step.cuh: nu_span, the binary search in fixed steps: the
    largest k with U[k] <= u, the span where k < m, n at u = U[m], else
    -1."""
    k, step = -1, 16
    while step:
        if k + step <= m and U[k + step] <= u:
            k += step
        step //= 2
    i0 = k if k < m else -1
    return n if u == U[m] else i0


def _span_basis(U, n, p, u):
    """csrc/nurbs_step.cuh: nu_basis<T, 1> at one u: the span i0 (that of
    the knot interval [U_i, U_i+1) holding u, n at the last knot, -1
    outside: nu_span) and the values N[r] and first derivatives D[r] of
    basis function i0 - r, r = 0..p, by the triangle on the span, whose a
    and c multiply by the knot table's reciprocal knot differences
    (ops/launch.py: _recips; 0 for an empty interval)."""
    nk = n + p + 2
    m = nk - 1
    rc = launch._recips(U, n + 1, p)
    i0 = _span(U, m, n, u)
    N, D = [0.0] * (p + 1), [0.0] * (p + 1)
    if i0 >= 0:
        N[0] = 1.0
    for k in range(1, p + 1):
        rk = rc[(k - 1) * nk:k * nk]
        for r in range(k, -1, -1):
            i = i0 - r
            nv = dv = 0.0
            if 0 <= i <= m - 1 - k:
                da = rk[i]
                a = (u - U[i]) * da
                nv, dv = a * N[r], da * N[r] + a * D[r]
                if r >= 1:
                    dc = rk[i + 1]
                    c = (U[i + k + 1] - u) * dc
                    nv += c * N[r - 1]
                    dv += -dc * N[r - 1] + c * D[r - 1]
            N[r], D[r] = nv, dv
    return i0, N, D


@pytest.mark.parametrize("knots", [
    (0.0, 0.0, 0.0, 0.25, 0.25, 0.625, 1.0, 1.0, 1.0),
    (0.0,) * 4 + (0.375,) + (1.0,) * 4,
    (0.0,) * 8 + (0.1, 0.2, 0.25, 0.4, 0.5, 0.7, 0.75, 0.9) + (1.0,) * 8,
    (0.0, 0.1, 0.2, 0.2, 0.2, 0.6, 0.7, 1.0, 1.3),
    (0.0, 1.0)])
def test_span_search_matches_the_scan(knots):
    """The kernels' binary span search (nu_span) finds the span of the
    linear scan it replaced (the last i with U[i] <= u < U[i + 1], n at
    the last knot, -1 outside) for every u: at each knot (repeated ones
    too), between them, at 0 and 1, past both ends and NaN; clamped and
    unclamped rows, 2 to NU_KMAX knots."""
    U = knots
    m = len(U) - 1
    n = m - 1  # any n: the last knot's span
    us = sorted(set(U)) + [(a + b) / 2 for a, b in zip(U, U[1:])] + [
        -0.5, -1e-300, 0.0, 1.0, 1.0 + 1e-16, 2.0, float("nan"),
        float(np.nextafter(1.0, 0.0)), float(np.nextafter(U[-1], 2.0))]
    for u in us:
        scan = -1
        for i in range(m):
            if U[i] <= u < U[i + 1]:
                scan = i
        if u == U[m]:
            scan = n
        assert _span(U, m, n, u) == scan, u


def _homog_cot(S, Su, Sv, w, wu, wv, gS, gSu, gSv):
    """csrc/nurbs_step.cuh: nu_homog_cot: g_H, g_Hu, g_Hv, g_w, g_wu, g_wv
    of one point."""
    gSt = gS - (wu * gSu + wv * gSv) / w
    return (list(gSt / w) + list(gSu / w) + list(gSv / w)
            + [-(gSt @ S + gSu @ Su + gSv @ Sv) / w, -(gSu @ S) / w,
               -(gSv @ S) / w])


def _span_columns(P, W, net, rays):
    """The kernels' net columns, transcribed (csrc/nurbs_step.cuh:
    nurbs_own_cols): each ray's record (the spans and basis of both its
    points, the homogeneous cotangents there) adds, on the (p + 1)(q + 1)
    control points of each point's span only, to the sums G (of b g_H +
    b_u g_Hu + b_v g_Hv) and g (of b g_w + b_u g_wu + b_v g_wv) of the
    control point, rays in order, the stopped point before the corrected
    one; then the control points' columns are W G and the weights' P . G
    + g."""
    _, nu, nv, p, q, uk, vk = net
    G = np.zeros((3, nu, nv))
    g = np.zeros((nu, nv))
    for points in rays:
        for (u, v), cot in points:
            iu, Nu, Du = _span_basis(uk, nu - 1, p, u)
            iv, Nv, Dv = _span_basis(vk, nv - 1, q, v)
            for ru in range(p + 1):
                for rv in range(q + 1):
                    i, j = iu - ru, iv - rv
                    if i < 0 or j < 0:
                        continue
                    b, bu = Nu[ru] * Nv[rv], Du[ru] * Nv[rv]
                    bv = Nu[ru] * Dv[rv]
                    for d in range(3):
                        G[d, i, j] += (b * cot[d] + bu * cot[3 + d]
                                       + bv * cot[6 + d])
                    g[i, j] += b * cot[9] + bu * cot[10] + bv * cot[11]
    return W[None] * G, (P * G).sum(0) + g


def _random_net(rng, nu, nv, p, q, knots):
    """(coefficient row, structure) of a random rational nu x nv net of
    degrees (p, q) on clamped knots: uniform, random interior ones, or
    with an interior knot repeated."""
    def kv(n, deg):
        inner = n - deg - 1
        if knots == "uniform" or inner == 0:
            mid = np.linspace(0, 1, inner + 2)[1:-1]
        else:
            mid = np.sort(rng.uniform(0.1, 0.9, inner))
            if knots == "repeated" and inner >= 2:
                mid[1] = mid[0]
        return tuple(float(k) for k in np.concatenate(
            [np.zeros(deg + 1), mid, np.ones(deg + 1)]))

    xs, ys = np.linspace(-4, 4, nu), np.linspace(-3, 3, nv)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    Z = 0.05 * (X**2 + Y**2) + 0.1 * rng.normal(size=X.shape)
    Wt = 0.7 + 0.6 * rng.random((nu, nv))
    c = np.concatenate([np.stack([X, Y, Z]).ravel(), Wt.ravel()])
    return c, ("nurbs", nu, nv, p, q, kv(nu, p), kv(nv, q))


@pytest.mark.parametrize("nu,nv,p,q,knots", [
    (2, 2, 1, 1, "uniform"), (4, 3, 2, 1, "random"),
    (5, 4, 1, 3, "random"), (4, 4, 3, 3, "uniform"),
    (6, 5, 2, 3, "repeated"), (7, 7, 3, 3, "random"),
    (6, 7, 3, 2, "repeated")])
def test_span_columns_match_dense_net_cotangent(nu, nv, p, q, knots):
    """The kernels' span-local column arithmetic (the spans of both
    points, the last knot's span at u or v = 1, the box's edge at 0, at
    interior and repeated knots) against the dense net_cotangent of
    ops/step.py, summed over 64 random rays, to 1e-12."""
    rng = np.random.default_rng(nu * 100 + nv * 10 + p + q)
    c, net = _random_net(rng, nu, nv, p, q, knots)
    _, _, _, _, _, uk, vk = net
    R = 64
    edges = np.array([0.0, 1.0] + list(uk[p + 1:nu]) + list(vk[q + 1:nv]))
    uv = rng.random((2, 2, R))
    uv[:, :, :len(edges)] = rng.choice(edges, size=(2, 2, len(edges)))
    uv[0, 0, :4], uv[1, 0, :4] = (0.0, 1.0, 1.0, 0.0), (1.0, 0.0, 1.0, 0.0)
    P, W = tn.unpack_pw(f64(c), net)
    gP = torch.zeros_like(P)
    gW = torch.zeros_like(W)
    records = [[] for _ in range(R)]
    for k in range(2):
        u, v = f64(uv[0, k]), f64(uv[1, k])
        h = tn.homogeneous(P, W, net, u, v, 1)
        S, w = tn.rational(h)
        gS, gSu, gSv = (f64(rng.normal(size=(3, R))) for _ in range(3))
        a, b = step.net_cotangent(P, W, net, u, v, h, S, w, tuple(gS),
                                  tuple(gSu), tuple(gSv))
        gP, gW = gP + a.sum(-1), gW + b.sum(-1)
        Sx, Sux, Svx = (S[d].numpy() for d in ("", "u", "v"))
        wu, wv = h["u"][1].numpy(), h["v"][1].numpy()
        for r in range(R):
            records[r].append(((uv[0, k, r], uv[1, k, r]), _homog_cot(
                Sx[:, r], Sux[:, r], Svx[:, r], float(w[r]), wu[r], wv[r],
                gS[:, r].numpy(), gSu[:, r].numpy(), gSv[:, r].numpy())))
    sP, sW = _span_columns(P.numpy(), W.numpy(), net, records)
    scale = max(float(gP.abs().max()), float(gW.abs().max()))
    np.testing.assert_allclose(sP, gP.numpy(), rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(sW, gW.numpy(), rtol=0, atol=1e-12 * scale)


@pytest.mark.parametrize("form", ["merit", "full"])
@pytest.mark.parametrize("tilted", [False, True])
@pytest.mark.parametrize("refl", [False, True])
def test_step_adjoint_matches_autograd(refl, tilted, form):
    """The hand adjoint against autograd of step_plain (its one
    differentiable Newton step), every flag, a zero-padded row."""
    c, net = small_net()
    c = np.concatenate([c, np.zeros(5)])
    full = form == "full"
    st = _rays(40, 7)
    rng = np.random.default_rng(8)
    g = [rng.normal(size=40) for _ in range(8)]
    g_np = rng.normal(size=40)
    cols, coef, g_in, g_npre, _, _ = _port_step(_params(tilted), st, c, net,
                                                refl, full, tilted, g, g_np,
                                                6)
    tp = f64(_params(tilted), requires_grad=True)
    tc = f64(c, requires_grad=True)
    npre = f64(1.0, requires_grad=True)
    xs = [f64(v, requires_grad=True) for v in (st if full else st[:6])]
    out, n_next = step.step_plain(tg.NURBS, refl, tp, npre, tuple(xs),
                                  absorbs=full, c=tc, newton_iters=6,
                                  lay=net)
    loss = sum((o * f64(gv)).sum() for o, gv in zip(out, g)) + (
        n_next * f64(g_np)).sum()
    gp, gc, gn, *gx = torch.autograd.grad(loss, [tp, tc, npre] + xs)
    scale = float(gp.abs().max())
    for k, v in cols.items():
        np.testing.assert_allclose(v, float(gp[k]), rtol=1e-10,
                                   atol=1e-12 * scale, err_msg=f"col {k}")
    np.testing.assert_allclose(coef, np_of(gc), rtol=1e-10,
                               atol=1e-12 * float(gc.abs().max()))
    assert np.all(coef[-5:] == 0)
    for a, b in zip(g_in, gx):
        np.testing.assert_allclose(a, np_of(b), rtol=1e-10,
                                   atol=1e-12 * float(b.abs().max()))
    np.testing.assert_allclose(g_npre, float(gn), rtol=1e-10)


# ---------------------------------------------------------------------------
# The kernels' plain versions and the entry points
# ---------------------------------------------------------------------------


def _inputs(system, n=48, seed=3):
    Px, Py = (f64(a) for a in pupil(n, seed))
    with torch.no_grad():
        params = ft.build_param_table(system, WL)
        aim = ft.aim_vector(system, *H)
        rays = traygen.generate_rays(system, *H, Px, Py, WL)
    ins = [getattr(rays, k) for k in ftr.RAY_FIELDS]
    coeffs, lay = launch.kernel_tables(system, torch.float64)
    rng = np.random.default_rng(seed)
    cots = [f64(rng.normal(size=n)) for _ in range(8)]
    return params, aim, Px, Py, ins, coeffs.detach(), lay, cots


def _grad_of(fn, tensors):
    """Autograd of fn(*tensors) (a scalar) with respect to each tensor."""
    leaves = [t.detach().clone().requires_grad_() for t in tensors]
    return [np_of(g) for g in torch.autograd.grad(fn(*leaves), leaves)]


def _flat_close(got, ref, what):
    got, ref = np_of(got), np.concatenate([np.ravel(r) for r in ref])
    np.testing.assert_allclose(got, ref, rtol=1e-9,
                               atol=1e-9 * np.abs(ref).max(), err_msg=what)


def test_plain_kernels_match_autograd():
    """The hand-derived backwards of K5b, K4, K3, the poly K5b and K9 (both
    modes) on the rational lens against autograd of their forwards."""
    system = ns.rational_nurbs().system
    params, aim, Px, Py, ins, coeffs, lay, cots = _inputs(system)
    spec = ftr.fast_spec(system, field=True)
    nc = coeffs.shape[1]

    def dot(outs, cs):
        return sum((o * c).sum() for o, c in zip(outs, cs))

    din, flat = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots, coeffs,
                                         lay)
    ref = _grad_of(lambda p, c, *r: dot(ftr.trace_fast_plain(
        p, spec, r, c, lay), cots), [params, coeffs] + ins)
    _flat_close(flat, ref[:2], "trace_bwd")
    for a, b in zip(din, ref[2:]):
        np.testing.assert_allclose(np_of(a), b, rtol=1e-9,
                                   atol=1e-9 * np.abs(b).max())
    flat = ftr.trace_fast_field_bwd_plain(params, aim, spec, nc, Px, Py, cots,
                                          coeffs, lay)
    ref = _grad_of(lambda p, c, a: dot(ftr.trace_fast_field_plain(
        p, a, spec, Px, Py, c, lay), cots), [params, coeffs, aim])
    _flat_close(flat, ref, "trace_field_bwd")
    mspec = ft._spec_of(system)
    R = Px.shape[0]
    rows = ft.merit_fwd_plain(params, aim, mspec, R, Px=Px, Py=Py,
                              coeffs=coeffs, lay=lay)
    _, xbar, ybar = ft._chan_combine(rows, R)
    stats = torch.stack([xbar, ybar, 1.0 / R + 0 * xbar, 0 * xbar])
    flat = ft.merit_bwd_plain(params, aim, stats, mspec, nc, R, Px=Px, Py=Py,
                              coeffs=coeffs, lay=lay)

    def merit(p, c, a):
        x, y = ft.trace_xy_plain(p, a, mspec, Px, Py, coeffs=c, lay=lay)
        return (((x - xbar) ** 2 + (y - ybar) ** 2) / R).sum()

    _flat_close(flat, _grad_of(merit, [params, coeffs, aim]), "merit_bwd")
    # the poly mode: a wavelength per ray
    pspec = ftr.poly_spec(system)
    pparams = ftr.build_poly_table(system)
    mats = system.stack.mat_coeffs
    ins9 = ins + [f64(np.resize([0.48, 0.55, 0.65], R))]
    _, flat = ftr.trace_bwd_poly_plain(pparams, mats, pspec, nc, ins9, cots,
                                       coeffs, lay)
    ref = _grad_of(lambda p, c, m: dot(ftr.trace_fwd_poly_plain(
        p, m, pspec, ins9, c, lay), cots), [pparams, coeffs, mats])
    _flat_close(flat, ref, "trace_bwd_poly")
    # K9, both modes, on the coated lens
    csys = ns.coated_nurbs("H").system
    params, _, _, _, ins, coeffs, lay, _ = _inputs(csys)
    cspec = pt.pol_spec(csys, WL)
    coat = pt.build_coat_table(csys, WL, torch.float64, torch.device("cpu"))
    rng = np.random.default_rng(4)
    pcots = [f64(rng.normal(size=R)) for _ in range(pt.N_POL)]
    for states, intensity in ((None, False), (pt.pol_states(
            create_polarization("H")), True)):
        c = pcots[:8] if intensity else pcots
        _, flat = pt.pol_bwd_plain(params, coat, cspec, ins, c, states,
                                   intensity, coeffs, nc, with_coeffs=True,
                                   lay=lay)
        ref = _grad_of(lambda p, cf, cc: dot(pt.pol_fwd_plain(
            p, cc, cspec, ins, states, intensity, cf, lay), c),
            [params, coeffs, coat])
        _flat_close(flat, ref, f"pol_bwd intensity={intensity}")


@pytest.mark.parametrize("name", ns.NAMES + ("tilted_nurbs",))
def test_entry_points_match_plain_engine(name):
    """trace_fast, trace_fast_field and spot_rms_fast_field (the kernels'
    plain versions and hand adjoints, 10 Newton steps) against the plain
    engine (autograd, 24; its tilt code on): values and every leaf's
    gradient, the net's among them."""
    build = getattr(ns, name)
    system = build().system
    assert ftr._build(ftr.fast_spec(system, field=True)) == launch.NURBS
    assert ft._build(ft._spec_of(system)) == launch.NURBS
    Px, Py = (f64(a) for a in pupil(48, 6))

    def merit(f):
        return (f.x**2 + 2 * f.y**2 + f.L * f.M).mean() + (f.i * f.opd).mean()

    res = {}
    # the engine with its tilt code on, as the kernels' tilt gradients are;
    # but not for an on-axis bundle (L = M = 0 at the NURBS surface), where
    # autograd of the plane pair's unused hypotenuse sqrt(L^2 + M^2) at 0
    # gives the engine (as JAX's) a NaN rx gradient and the hand adjoint a
    # finite one (ROADMAP Queue 3): there the tilt columns are not compared
    gate = float(system.field_y.abs().max()) > 0
    tilted = system.replace(cfg=dataclasses.replace(system.cfg,
                                                    has_tilts=gate))
    for entry in ("engine", "trace_fast", "trace_fast_field", "spot",
                  "spot_engine"):
        s2, leaves = with_leaves(tilted if "engine" in entry else system)
        if entry == "engine":
            f, _ = ttrace.trace(s2, traygen.generate_rays(s2, *H, Px, Py, WL),
                                record=False)
            v = merit(f)
        elif entry == "trace_fast":
            v = merit(ftr.trace_fast(
                s2, traygen.generate_rays(s2, *H, Px, Py, WL), WL))
        elif entry == "trace_fast_field":
            v = merit(ftr.trace_fast_field(s2, *H, Px, Py, WL))
        elif entry == "spot":
            v = ft.spot_rms_fast_field(s2, *H, WL, Px=Px, Py=Py)
        else:
            f, _ = ttrace.trace(s2, traygen.generate_rays(s2, *H, Px, Py, WL),
                                record=False)
            v = ((f.x - f.x.mean()) ** 2 + (f.y - f.y.mean()) ** 2).mean()
        v.backward()
        res[entry] = (float(v.detach()), {
            k: np.zeros(t.shape) if t.grad is None else np_of(t.grad)
            for k, t in leaves.items()})
    for entry, ref in (("trace_fast", "engine"), ("trace_fast_field",
                                                  "engine"),
                       ("spot", "spot_engine")):
        assert res[entry][0] == pytest.approx(res[ref][0], rel=1e-12)
        got, want = res[entry][1], res[ref][1]
        scale = max(np.abs(v).max() for v in want.values() if v.size)
        for k in want:
            if gate or k not in ("rx", "ry", "rz"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-9,
                                           atol=1e-9 * scale,
                                           err_msg=f"{entry} {k}")
        assert np.abs(got["coeffs"][1]).max() > 0


def test_poly_entry_point_matches_plain_engine():
    """trace_fast_poly (a wavelength per ray) against the plain engine of
    the same system without absorption (the poly kernels apply none), its
    tilt code on."""
    system = ns.rational_nurbs().system
    Px, Py = (f64(a) for a in pupil(48, 7))
    w = f64(np.resize([0.48, 0.55, 0.65], 48))

    def run(fast):
        sys_ = system if fast else system.replace(cfg=dataclasses.replace(
            system.cfg, has_absorption=False, has_tilts=True))
        s2, leaves = with_leaves(sys_)
        rays = traygen.generate_rays(s2, *H, Px, Py, WL).replace(w=w)
        f = (ftr.trace_fast_poly(s2, rays) if fast
             else ttrace.trace(s2, rays, record=False)[0])
        v = (f.x**2 + f.y**2 + f.opd).mean()
        v.backward()
        return float(v.detach()), {
            k: np.zeros(t.shape) if t.grad is None else np_of(t.grad)
            for k, t in leaves.items()}

    (v, g), (v0, g0) = run(True), run(False)
    assert v == pytest.approx(v0, rel=1e-12)
    scale = max(np.abs(a).max() for a in g0.values() if a.size)
    for k in g:
        np.testing.assert_allclose(g[k], g0[k], rtol=1e-9, atol=1e-9 * scale,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# Builder, system_from_numpy, launch checks, finite differences
# ---------------------------------------------------------------------------


def test_optic_modes_and_system_from_numpy_match_jax():
    """The golden rational and conic-fit lenses and a Bezier patch (points
    only) build the JAX package's stack and extras; system_from_numpy
    carries a JAX NURBS system, which traces as the port's own."""
    def bezier(optic):
        o = optic()
        P = np.stack(np.meshgrid(np.linspace(-6, 6, 4), np.linspace(-6, 6, 4),
                                 indexing="ij"))
        P = np.concatenate([P, (P[:1] ** 2 + P[1:] ** 2) / 200])
        return ns._singlet(o, control_points=P.tolist())

    for build in (ns.rational_nurbs, ns.fitted_nurbs, ns.bspline_nurbs,
                  bezier):
        tsys, jsys = build(TOptic).system, build(JOptic).system
        assert tsys.cfg.geom_codes == tuple(jsys.cfg.geom_codes)
        assert tsys.cfg.geom_aux == tuple(jsys.cfg.geom_aux)
        for k in STACK_FIELDS:
            np.testing.assert_array_equal(np_of(getattr(tsys.stack, k)),
                                          np.asarray(getattr(jsys.stack, k)),
                                          err_msg=k)
    arrays = {k: np.asarray(getattr(jsys.stack, k)) for k in STACK_FIELDS}
    arrays.update({k: np.asarray(getattr(jsys, k)) for k in
                   ("aperture_value", "field_x", "field_y", "vig_x", "vig_y",
                    "wavelengths")})
    cfg = {f.name: getattr(jsys.cfg, f.name)
           for f in dataclasses.fields(jsys.cfg)
           if f.name in {g.name for g in dataclasses.fields(tsys.cfg)}}
    cfg["coatings"], cfg["apertures"] = tsys.cfg.coatings, tsys.cfg.apertures
    back = system_from_numpy(arrays, cfg)
    assert back.cfg.geom_aux == tsys.cfg.geom_aux
    Px, Py = (f64(a) for a in pupil(16, 2))
    a, _ = ttrace.trace(back, traygen.generate_rays(back, *H, Px, Py, WL))
    b, _ = ttrace.trace(tsys, traygen.generate_rays(tsys, *H, Px, Py, WL))
    for k in ftr.RAY_FIELDS:
        torch.testing.assert_close(getattr(a, k), getattr(b, k), rtol=0,
                                   atol=0)
    bad = dict(cfg, geom_aux=(None, ("nurbs", 4, 4, 3, 3, (0.0,), ()),
                              None, None))
    with pytest.raises(NotImplementedError, match="geom_aux"):
        system_from_numpy(arrays, bad)


def test_launch_checks_take_nurbs():
    """The nurbs build, the knot table, and the combinations no build
    covers, each named."""
    system = ns.rational_nurbs().system
    coeffs, kn = launch.kernel_tables(system, torch.float64)
    # the surfaces' rows, then the tail's two (csrc/nurbs_step.cuh:
    # nu_tail): E, ns, the offsets and net slots, the reciprocal knot
    # differences of the clamped uniform knots (0, 0, 0, 0, 1/4, .., 1, 1)
    assert tuple(kn.shape) == (6, launch.NU_KT) and launch.knot_rows(kn) == 6
    tail = kn[4:].reshape(-1).tolist()
    assert tail[:10] == [2, 1, 0, 10, 0, 0, 0, 0, 0, 0]
    rc = ([0.0] * 3 + [4.0] * 4 + [0.0] * 4
          + [0.0] * 2 + [4.0, 2, 2, 2, 4] + [0.0] * 4
          + [0.0, 4, 2, 4 / 3, 4 / 3, 2, 4] + [0.0] * 4)
    assert tail[10:43] == rc and tail[43:76] == rc
    assert launch.net_of(kn[1]) == system.cfg.geom_aux[1]
    assert float(kn[0].abs().max()) == 0 and coeffs.shape[1] == 4 * 49
    assert launch.lay_row(kn, tg.NURBS, 1) == system.cfg.geom_aux[1]
    codes = (0, tg.NURBS, 1, 0)
    assert launch.build_of(codes, (False,) * 4) == launch.NURBS
    assert launch.build_of(codes, (False, True, False, False)) == launch.NURBS
    assert launch.entry_name("trace_fwd", launch.NURBS) == "trace_fwd_nurbs"
    assert launch.sag_surfaces(codes, launch.NURBS) == (1,)
    assert launch.block_width(196, launch.NURBS) == 196
    for kw, what in (({"codes": (0, tg.NURBS, tg.EVEN_ASPHERE, 0)},
                      "EVEN_ASPHERE"),
                     ({"grat": (False, False, True, False)}, "a grating"),
                     ({"inner": (False, True, False, False)},
                      "annular clip"),
                     ({"codes": (0, tg.NURBS) + (1,) * 16}, "18 surfaces")):
        c = kw.get("codes", codes)
        with pytest.raises(NotImplementedError, match=what):
            launch.build_of(c, (False,) * len(c), kw.get("inner", ()),
                            kw.get("grat", ()))
    # every net of up to 8 x 8 points at any degree passes the bound; a
    # wider one, a higher degree or more knots are named
    assert launch._nurbs_bound(("nurbs", 8, 8, 7, 7, (0.0,) * 16,
                                (0.0,) * 16)) is None
    assert "NC_NURBS" in launch._nurbs_bound(("nurbs", 9, 8, 3, 3,
                                              (0.0,) * 13, (0.0,) * 12))
    assert "NU_PMAX" in launch._nurbs_bound(("nurbs", 9, 2, 8, 1,
                                             (0.0,) * 18, (0.0,) * 4))
    assert "NU_KMAX" in launch._nurbs_bound(("nurbs", 30, 2, 1, 1,
                                             (0.0,) * 32, (0.0,) * 4))
    assert "decrease" in launch._nurbs_bound(("nurbs", 2, 2, 1, 1,
                                              (0.0, 0, 1, 0.5), (0.0,) * 4))
    with pytest.raises(ValueError, match="knot table"):
        launch.check_cuda_inputs(ft.build_param_table(system, WL),
                                 ftr.fast_spec(system), coeffs=coeffs)
    # on the CPU a net past the bound traces: its knot table is wider
    xs = np.linspace(-5, 5, 30)
    P = np.stack(np.broadcast_arrays(xs[:, None], np.array([-1.0, 1.0]),
                                     np.zeros((30, 2))))
    wide = ns._singlet(TOptic(), control_points=P.tolist(),
                       weights=np.ones((30, 2)).tolist(), u_degree=1,
                       v_degree=1).system
    _, kw = launch.kernel_tables(wide, torch.float64)
    assert kw.shape[1] == 4 + 2 * 32 > launch.NU_KT
    assert launch.net_of(kw[1]) == wide.cfg.geom_aux[1]
    # a NURBS surface beside an aux-bearing one: one table, not both
    o = ns.rational_nurbs()
    o.surfaces.add(index=3, surface_type="zernike", thickness=1.0,
                   coefficients=[0.0, 1e-3], norm_radius=5.0)
    with pytest.raises(NotImplementedError, match="aux-bearing"):
        launch.kernel_tables(o.system, torch.float64)


def test_control_point_gradient_matches_finite_differences():
    """The image's y moments through the plain engine: the gradient of the
    centre control point's z against central differences (the JAX
    package's test_nurbs_control_point_gradient), and through the
    generic kernel's plain version."""
    xs = np.linspace(-7, 7, 7)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    P = np.stack([X, Y, (X**2 + Y**2) / (2 * 80.0)])
    system = ns._singlet(TOptic(), control_points=P.tolist(),
                         weights=np.ones((7, 7)).tolist(), u_degree=3,
                         v_degree=3).system
    idx = 2 * 49 + 3 * 7 + 3  # z of the centre control point

    def loss(val, fast=False):
        coeffs = system.stack.coeffs.clone()
        coeffs[1, idx] = val
        s = system.replace(stack=system.stack.replace(coeffs=coeffs))
        rays = traygen.generate_rays(s, f64([0.0] * 3), f64([1.0] * 3),
                                     f64([0.0, 0.5, 0.9]), f64([0.0] * 3),
                                     WL)
        fin = (ftr.trace_fast(s, rays, WL) if fast
               else ttrace.trace(s, rays, record=False)[0])
        return (fin.y**2).sum()

    v0 = float(system.stack.coeffs[1, idx])
    fd = (float(loss(f64(v0 + 1e-6))) - float(loss(f64(v0 - 1e-6)))) / 2e-6
    for fast in (False, True):
        v = f64(v0, requires_grad=True)
        (g,) = torch.autograd.grad(loss(v, fast), [v])
        assert abs(float(g)) > 1e-8
        np.testing.assert_allclose(float(g), fd, rtol=1e-6)
