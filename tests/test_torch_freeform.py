"""optiland_torch's Cartesian freeforms (kernel K6b: POLYNOMIAL_XY,
CHEBYSHEV, TOROIDAL, BICONIC) against the JAX package, on the CPU in
float64, where the wrappers run the kernels' plain versions.

  * geometry: sag, slopes and normal of each family against JAX's
    functions (rtol 1e-12; the normal's slopes are written out where JAX
    takes them by AD) and the goldens of the original Optiland
    (``tests/goldens/geometries.npz``, JAX's own tolerances: sag rtol
    1e-9, normal rtol 1e-6), the Newton distance and the derivatives of
    all three with respect to radius, conic, p1, p2 and the coefficients
    against ``jax.jacfwd`` (rtol 1e-9);
  * the hand adjoint of the step against autograd of ``step_plain``, for
    each family, tilted and untilted, merit, full, polarized-extras and
    mirror forms, and CHEBYSHEV inside and outside its normalization
    (outside, the reference's clip makes the gradient NaN: the same NaN
    set), to rtol 1e-10 with atol 1e-12 x the largest entry;
  * the freeform singlets (``samples/freeform.py``) through ``trace``,
    ``rms_spot_size``, ``trace_fast`` (K5a/K5b), ``trace_fast_field``
    (K1/K4), ``spot_rms_fast_field`` (K2/K3), ``trace_fast_poly`` (poly
    mode) and ``trace_fast_pol_intensity`` (K8/K9 on the Fresnel-coated
    XY singlet) against the JAX package's XLA path: values to rtol 1e-8
    with atol 1e-9 mm (1e-12 for directions), and the gradient of every
    stack leaf, geo_p1, geo_p2 and coeffs included, to rtol 1e-7 of the
    largest entry where JAX's is finite, with the same NaN set;
  * the plain versions of K5a (XY), K1 and K2 (toroidal), the poly mode
    (Chebyshev) and K8 (coated XY) against the JAX package's kernels in
    interpret mode (rtol 1e-10, atol 1e-12);
  * the XY table layout (a 2 x 2 table beside a 3 x 3 one is read with
    side 3, as in the JAX package), the toroid's NaN set (outside its
    rotation domain; a cylinder's NaN gradient), the ``Optic`` builder of
    the four types and its refusals, ``system_from_numpy``, and paraxial
    f2 of the toroidal singlet.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch.analysis import rms_spot_size
from optiland_torch.core import geometry as tg
from optiland_torch.core import raygen as traygen
from optiland_torch.core import trace as ttrace
from optiland_torch.core.rays import RealRays as TRays
from optiland_torch.core.system import STACK_FIELDS, system_from_numpy
from optiland_torch.ops import fast_trace as ftr
from optiland_torch.ops import fused_trace as ft
from optiland_torch.ops import launch
from optiland_torch.ops import pol_trace as pt
from optiland_torch.ops import step
from optiland_torch.optic import Optic as TOptic
from optiland_torch.polarization import create_polarization as t_state
from optiland_torch.samples import freeform as ff
from optiland_tpu.core import geometry as jg
from optiland_tpu.core import raygen as jraygen
from optiland_tpu.core import trace as jtrace
from optiland_tpu.ops import pallas_trace as jpt
from optiland_tpu.ops.pallas_pol import trace_fast_pol as j_fast_pol
from optiland_tpu.optic import Optic as JOptic
from optiland_tpu.polarization import create_polarization as j_state
from optiland_tpu.polarization import polarized_intensity as j_ipol
from tests.torch_shared import value_and_jacfwd

WL = ff.WAVELENGTH
H = ff.H
FIELDS = ftr.RAY_FIELDS
# the four Cartesian families (the aux-bearing ones: test_torch_zernike.py,
# test_torch_forbes.py)
FAMS = tuple(f for f in ff.FAMILIES if f not in ff.AUX_FAMILIES)
CODES = {"polynomial": tg.POLYNOMIAL_XY, "chebyshev": tg.CHEBYSHEV,
         "toroidal": tg.TOROIDAL, "biconic": tg.BICONIC}
CMAT = np.asarray(ff.CMAT).ravel()
# family -> (radius, conic, coefficients, p1, p2): the goldens' sets
# (the JAX package's tests/test_geometries.py)
GOLDEN = {
    "polynomial": (50.0, -0.5, CMAT, 1.0, 1.0),
    "chebyshev": (50.0, -0.5, CMAT, 6.0, 7.0),
    "toroidal": (100.0, 0.0, np.array([1e-5, -1e-8]), 50.0, -0.5),
    "biconic": (80.0, -0.2, np.zeros(0), 50.0, -0.8),
}
N_RAYS = 120


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


def pupil(n, seed):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n)) * 0.97
    th = rng.uniform(0, 2 * np.pi, size=n)
    return r * np.cos(th), r * np.sin(th)


def f64(v, **kw):
    return torch.tensor(v, dtype=torch.float64, **kw)


def np_of(v):
    return v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)


def port_rays(jrays):
    return TRays(**{k: torch.tensor(np.asarray(getattr(jrays, k)))
                    for k in FIELDS + ("w",)})


def with_leaves(system):
    leaves = {k: v.detach().clone().requires_grad_(v.numel() > 0)
              for k, v in system.stack.leaves().items()}
    return system.replace(stack=system.stack.replace(**leaves)), leaves


def assert_grads(got, ref, rtol=1e-7):
    """Every stack leaf: the same NaN set, and within rtol of JAX's where
    JAX's is finite, atol rtol x its largest finite entry."""
    scale = max(float(np.nanmax(np.abs(v))) for v in ref.values() if v.size)
    for k in STACK_FIELDS:
        g = (np.zeros(ref[k].shape) if got[k] is None
             else got[k].detach().numpy())
        np.testing.assert_array_equal(np.isnan(g), np.isnan(ref[k]),
                                      err_msg=f"{k}: NaN set")
        fin = np.isfinite(ref[k])
        np.testing.assert_allclose(g[fin], ref[k][fin], rtol=rtol,
                                   atol=rtol * scale, err_msg=k)


def assert_rays(got, ref, keys=FIELDS, rtol=1e-8):
    for k in keys:
        atol = 1e-12 if k in ("L", "M", "N", "i") else 1e-9
        np.testing.assert_allclose(np_of(getattr(got, k)),
                                   np.asarray(getattr(ref, k)), rtol=rtol,
                                   atol=atol, err_msg=k)


def merit_of(xp, f):
    """A merit that reads every output: positions, OPD and intensity."""
    return (xp.mean(f.x**2 + f.y**2) + 1e-3 * xp.mean(f.opd)
            + 0.3 * xp.mean(f.i))


def singlets(family, **kw):
    return (ff.freeform_singlet(family, TOptic, **kw).system,
            ff.freeform_singlet(family, JOptic, **kw).system)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fam", FAMS)
def test_geometry_matches_jax_and_goldens(fam):
    code = CODES[fam]
    R, k, c, p1, p2 = GOLDEN[fam]
    g = np.load("tests/goldens/geometries.npz")
    s = tg.sag_static(code, f64(R), f64(k), f64(c), f64(g["x"]), f64(g["y"]),
                      f64(p1), f64(p2))
    np.testing.assert_allclose(s.numpy(), g[f"{fam}_sag"], rtol=1e-9,
                               atol=1e-12)
    nrm = tg.surface_normal_static(code, f64(R), f64(k), f64(c), f64(g["x"]),
                                   f64(g["y"]), f64(p1), f64(p2))
    for a, key in zip(nrm, ("nx", "ny", "nz")):
        np.testing.assert_allclose(a.numpy(), g[f"{fam}_{key}"], rtol=1e-6,
                                   atol=1e-9)
    # against JAX's functions, with derivatives in every parameter
    rng = np.random.default_rng(3)
    n = 30
    x, y = rng.uniform(-4.5, 4.5, n), rng.uniform(-4.5, 4.5, n)
    z = np.full(n, -2.0)
    L, M = rng.normal(0, 0.05, n), rng.normal(0, 0.05, n)
    N = np.sqrt(1 - L**2 - M**2)
    J = [jnp.asarray(v) for v in (x, y, z, L, M, N)]
    T = [torch.tensor(v) for v in (x, y, z, L, M, N)]
    c = np.asarray(c if c.size else np.zeros(1))

    def jfun(th):
        R_, k_, p1_, p2_, cc = th[0], th[1], th[2], th[3], th[4:]
        t = jg.distance_static(code, R_, k_, cc, *J, p1=p1_, p2=p2_)
        nr = jg.surface_normal_static(code, R_, k_, cc, J[0], J[1], p1=p1_,
                                      p2=p2_)
        sg = jg.sag_static(code, R_, k_, cc, J[0], J[1], p1=p1_, p2=p2_)
        return jnp.concatenate([t, sg, *nr])

    def tfun(th):
        R_, k_, p1_, p2_, cc = th[0], th[1], th[2], th[3], th[4:]
        t = tg.distance_static(code, R_, k_, *T, coeffs=cc, p1=p1_, p2=p2_)
        nr = tg.surface_normal_static(code, R_, k_, cc, T[0], T[1], p1_,
                                      p2_)
        sg = tg.sag_static(code, R_, k_, cc, T[0], T[1], p1_, p2_)
        return torch.cat([t, sg, *nr])

    theta = np.concatenate([[R, k, p1, p2], c])
    ref, jac_ref = value_and_jacfwd(jfun, theta)
    got = tfun(torch.tensor(theta)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-13)
    jac = torch.autograd.functional.jacobian(tfun, torch.tensor(theta))
    np.testing.assert_allclose(jac.numpy(), jac_ref, rtol=1e-9,
                               atol=1e-12 * np.abs(jac_ref).max())


@pytest.mark.parametrize("fam", FAMS)
def test_slopes_and_hessian_match_autograd(fam):
    """cart_point's slopes against autograd of the transcribed sag, and
    its Hessian and parameter derivatives against autograd of its slopes
    (the normal's, CHEBYSHEV's convention, too)."""
    code = CODES[fam]
    R, k, c, p1, p2 = GOLDEN[fam]
    rng = np.random.default_rng(5)
    X = f64(rng.uniform(-4, 4, 25), requires_grad=True)
    Y = f64(rng.uniform(-4.5, 4.5, 25), requires_grad=True)
    th = [f64(v, requires_grad=True) for v in (R, k, p1, p2)]
    C = f64(c if c.size else np.zeros(1), requires_grad=True)
    s = tg.sag_static(code, th[0], th[1], C, X, Y, th[2], th[3])
    gx, gy = torch.autograd.grad(s.sum(), (X, Y), create_graph=True)
    for normal in (False, True):
        pt_ = tg.cart_point(code, th[0], th[1], C, th[2], th[3], X, Y,
                            grad=True, normal=normal)
        if not normal or code != tg.CHEBYSHEV:
            torch.testing.assert_close(pt_.s, s, rtol=1e-13, atol=1e-15)
            torch.testing.assert_close(pt_.sx, gx, rtol=1e-12, atol=1e-15)
            torch.testing.assert_close(pt_.sy, gy, rtol=1e-12, atol=1e-15)
        for val, hx, hy, j in ((pt_.sx, pt_.hxx, pt_.hxy, 1),
                               (pt_.sy, pt_.hyx, pt_.hyy, 2)):
            auto = torch.autograd.grad(val.sum(), [X, Y] + th,
                                       retain_graph=True, allow_unused=True,
                                       materialize_grads=True)
            hand = [hx, hy] + [d[j].sum() for d in (pt_.dR, pt_.dk, pt_.dp1,
                                                    pt_.dp2)]
            for a, b in zip(hand, auto):
                torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-15)


# ---------------------------------------------------------------------------
# The hand adjoint of the step
# ---------------------------------------------------------------------------

# family -> (radius, conic, coefficients, p1, p2) of the adjoint's surface
STEP_SETS = {
    "polynomial": (50.0, -0.5, CMAT, 1.0, 1.0),
    "chebyshev": (50.0, -0.5, CMAT, 6.0, 7.0),
    # |x / p1| > 1 for some rays: the reference's NaN gradient
    "chebyshev_outside": (50.0, -0.5, CMAT, 3.0, 7.0),
    "toroidal": (100.0, -0.5, np.array([1e-5, -1e-8]), 50.0, -0.5),
    "biconic": (80.0, -0.2, np.zeros(1), 50.0, -0.8),
}


@pytest.mark.parametrize("form", ["merit", "full", "extras", "mirror"])
@pytest.mark.parametrize("tilted", [False, True])
@pytest.mark.parametrize("fam", list(STEP_SETS))
def test_step_adjoint_matches_autograd(fam, tilted, form):
    code = CODES[fam.removesuffix("_outside")]
    R, k, C, p1, p2 = STEP_SETS[fam]
    c = torch.tensor(C)
    rng = np.random.default_rng(11)
    n = 60
    p = torch.zeros(step.NUM_P, dtype=torch.float64)
    p[step.P_RADIUS], p[step.P_CONIC], p[step.P_POS] = R, k, 3.0
    p[step.P_NPOST], p[step.P_APMAX] = 1.6, 6.0
    p[step.P_DX], p[step.P_DY], p[step.P_KPRE] = 0.1, -0.05, 0.01
    p[step.P_G1], p[step.P_G2] = p1, p2
    if tilted:
        p[step.P_RX], p[step.P_RY], p[step.P_RZ] = 0.01, -0.02, 0.015
    x, y = (torch.tensor(rng.uniform(-5, 5, n)) for _ in range(2))
    L, M = (torch.tensor(rng.normal(0, 0.05, n)) for _ in range(2))
    st = [x, y, torch.full((n,), -2.0, dtype=torch.float64), L, M,
          torch.sqrt(1 - L**2 - M**2)]
    full = form != "merit"
    if full:
        st += [torch.tensor(rng.uniform(0.5, 1, n)),
               torch.tensor(rng.uniform(0, 1, n))]
    refl, extras = form == "mirror", form == "extras"
    n_pre = torch.tensor(1.0, dtype=torch.float64)
    pg, cg, ng = (v.clone().requires_grad_() for v in (p, c, n_pre))
    sg = [v.clone().requires_grad_() for v in st]
    out = step.step_plain(code, refl, pg, ng, tuple(sg), absorbs=full,
                          extras=extras, c=cg)
    cots = [torch.tensor(rng.normal(size=n)) for _ in range(len(out[0]) + 1)]
    loss = sum((o * g).sum() for o, g in zip(out[0] + (out[1],), cots))
    g_ext = None
    if extras:
        g_ext = [torch.tensor(rng.normal(size=n)) for _ in range(7)]
        loss = loss + sum((o * g).sum() for o, g in zip(out[2], g_ext))
    auto = torch.autograd.grad(loss, [pg, cg, ng] + sg, allow_unused=True,
                               materialize_grads=True)
    g = tuple(cots[:6]) + (cots[-1],) + tuple(cots[6:-1])
    g_in, g_npre, cols = step.step_adjoint_plain(
        code, refl, p, n_pre, tuple(st), g, absorbs=full, g_ext=g_ext,
        tilted=tilted, c=c)
    base = step.FULL_GRAD_COLS if full else step.GRAD_COLS
    pairs, coef = step.split_cols(code, cols, base, c.shape[0])
    assert [col for col, _ in pairs] == list(base) + [step.P_G1, step.P_G2]
    dp = torch.stack([v.sum() for _, v in pairs])
    dc = torch.stack([v.sum() for v in coef])

    def close(a, b, what):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), what
        fin = ~torch.isnan(b)
        torch.testing.assert_close(
            a[fin], b[fin], rtol=1e-10,
            atol=1e-12 * float(b[fin].abs().max() if fin.any() else 1),
            msg=what)

    close(dp, auto[0][[col for col, _ in pairs]], "param columns")
    close(dc, auto[1], "coefficients")
    close(g_npre.sum(), auto[2], "n_pre")
    for k_, (a, b) in enumerate(zip(g_in, auto[3:])):
        close(a, b, f"state {k_}")
    if fam == "chebyshev_outside":
        # the rays past |x / p1| = 1 have a NaN gradient, as in JAX
        assert bool(torch.isnan(g_in[0]).any())
        assert not bool(torch.isnan(g_in[0]).all())
    else:
        assert bool(torch.isfinite(dp).all())
    if fam not in ("biconic", "chebyshev_outside"):
        assert float(dc.abs().min()) > 0


# ---------------------------------------------------------------------------
# The freeform singlets against the JAX package's XLA path
# ---------------------------------------------------------------------------

SYSTEMS = {fam: (fam, {}) for fam in FAMS}
SYSTEMS["polynomial_tilted"] = ("polynomial", {"tilted": True})
SYSTEMS["polynomial_5x5"] = ("polynomial", {"coefficients": ff.CMAT5})


@functools.lru_cache(maxsize=None)
def jax_ref(name):
    """A launch bundle of system ``name``, and the values and gradients
    (every stack leaf) of the generic, field and merit entries through
    JAX's XLA path, the tilt gate open (so its tilt gradients are the
    kernels'); computed once per system and worker."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    Px, Py = (jnp.asarray(a) for a in pupil(N_RAYS, 6))
    fam, kw = SYSTEMS[name]
    jsys = ff.freeform_singlet(fam, JOptic, **kw).system
    jsys = jsys.replace(cfg=dataclasses.replace(jsys.cfg, has_tilts=True))
    rays = jraygen.generate_rays(jsys, *H, Px, Py, WL)

    def merits(stack):
        s = jsys.replace(stack=stack)
        f, _ = jtrace.trace(s, jraygen.generate_rays(s, *H, Px, Py, WL),
                            record=False)
        spot = jnp.mean((f.x - f.x.mean()) ** 2 + (f.y - f.y.mean()) ** 2)
        return jnp.stack([merit_of(jnp, f), spot])

    # one forward, pulled back once per merit: no batched (jacrev) copy of
    # the backward to compile
    vals, pull = jax.vjp(merits, jsys.stack)
    grads = [pull(jnp.eye(2)[j])[0] for j in range(2)]
    final, _ = jtrace.trace(jsys, rays, record=False)
    mp.undo()
    return dict(
        rays=rays, final=final, values=np.asarray(vals),
        grads=[{k: np.asarray(getattr(g, k)) for k in STACK_FIELDS}
               for g in grads])


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_freeform_paths_match_jax_xla(name):
    """trace (the plain engine), trace_fast, trace_fast_field and
    spot_rms_fast_field of a freeform singlet: values and the gradient of
    every stack leaf against JAX's XLA path."""
    fam, kw = SYSTEMS[name]
    ref = jax_ref(name)
    tsys = ff.freeform_singlet(fam, TOptic, **kw).system
    assert ftr.fast_supported(tsys, True) and ft.fused_supported(tsys)
    spec = ftr.fast_spec(tsys, field=True)
    assert launch.build_of(spec[0], spec[3], spec[-2]) == launch.FREE
    rays = port_rays(ref["rays"])
    final, _ = ttrace.trace(tsys, rays, record=False)
    assert_rays(final, ref["final"])
    assert_rays(ftr.trace_fast(tsys, rays, WL), ref["final"])
    Px, Py = (torch.tensor(a) for a in pupil(N_RAYS, 6))
    for entry in ("trace_fast", "trace_fast_field", "spot_rms_fast_field"):
        s2, leaves = with_leaves(tsys)
        if entry == "spot_rms_fast_field":
            val = ft.spot_rms_fast_field(s2, *H, WL, Px=Px, Py=Py)
            j = 1
        else:
            if entry == "trace_fast":
                f = ftr.trace_fast(s2, traygen.generate_rays(s2, *H, Px, Py,
                                                             WL), WL)
            else:
                f = ftr.trace_fast_field(s2, *H, Px, Py, WL)
            val = merit_of(torch, f)
            j = 0
        val.backward()
        assert float(val.detach()) == pytest.approx(ref["values"][j],
                                                    rel=1e-9)
        got = {k: v.grad for k, v in leaves.items()}
        assert_grads(got, ref["grads"][j])
        if fam != "biconic":
            assert float(got["coeffs"][1].abs().max()) > 0
        if fam != "polynomial":
            assert float(got["geo_p1"][1].abs()) > 0
    # rms_spot_size (generic path: generate_rays, then the plain engine on
    # the CPU), its tilt gate open as the reference's
    s2, leaves = with_leaves(tsys.replace(
        cfg=dataclasses.replace(tsys.cfg, has_tilts=True)))
    v = rms_spot_size(s2, *H, Px, Py, WL)
    (v**2).backward()
    assert float(v.detach()) ** 2 == pytest.approx(ref["values"][1],
                                                   rel=1e-9)
    assert_grads({k: l.grad for k, l in leaves.items()}, ref["grads"][1])


def _poly_rays(jrays):
    w = jnp.asarray(np.array([0.48, 0.55, 0.65])[np.arange(N_RAYS) % 3])
    return jrays.replace(w=w)


def test_freeform_poly_matches_jax():
    """trace_fast_poly of the Chebyshev singlet, wavelengths cycling by ray:
    JAX's kernel (interpret mode) and the gradient of JAX's XLA path."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    tsys, jsys = singlets("chebyshev")
    jsys = jsys.replace(cfg=dataclasses.replace(jsys.cfg, has_tilts=True))
    jr = _poly_rays(jax_ref("chebyshev")["rays"])
    assert ftr.poly_spec(tsys) is not None
    assert_rays(ftr.trace_fast_poly(tsys, port_rays(jr)),
                jpt.trace_fast_poly(jsys, jr), rtol=1e-10)

    # no intensity term: the polychromatic trace applies no absorption,
    # the XLA path does (N-BK7 carries k data)
    def merit(stack):
        f, _ = jtrace.trace(jsys.replace(stack=stack), jr, record=False)
        return jnp.mean(f.x**2 + f.y**2) + 1e-3 * jnp.mean(f.opd)

    val, g = jax.value_and_grad(merit)(jsys.stack)
    mp.undo()
    s2, leaves = with_leaves(tsys)
    f = ftr.trace_fast_poly(s2, port_rays(jr))
    v = torch.mean(f.x**2 + f.y**2) + 1e-3 * torch.mean(f.opd)
    v.backward()
    assert float(v.detach()) == pytest.approx(float(val), rel=1e-9)
    assert_grads({k: l.grad for k, l in leaves.items()},
                 {k: np.asarray(getattr(g, k)) for k in STACK_FIELDS})


def test_freeform_pol_matches_jax():
    """K8/K9 on the Fresnel-coated XY singlet in H: the plain version of
    K8 against JAX's kernel (interpret mode), and the polarized merit's
    value and gradient through trace_fast_pol_intensity against JAX's XLA
    path."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    tsys = ff.coated_freeform("polynomial", "H", TOptic).system
    jsys = ff.coated_freeform("polynomial", "H", JOptic).system
    jsys = jsys.replace(cfg=dataclasses.replace(jsys.cfg, has_tilts=True))
    Px, Py = (jnp.asarray(a) for a in pupil(N_RAYS, 9))
    jr = jraygen.generate_rays(jsys, *H, Px, Py, WL)
    ref, p_ref = j_fast_pol(jsys, jr, WL)
    got, p = pt.trace_fast_pol(tsys, port_rays(jr), WL)
    assert_rays(got, ref, rtol=1e-10)
    np.testing.assert_allclose(np_of(p), np.asarray(p_ref), rtol=1e-10,
                               atol=1e-12)
    state = j_state("H")

    def merit(stack):
        out, hist = jtrace.trace(jsys.replace(stack=stack), jr, record=False)
        i = j_ipol(hist["p"], state, jr.L, jr.M, jr.N, jr.i)
        return jnp.mean(out.x**2 + out.y**2) + 0.3 * jnp.mean(i)

    val, g = jax.value_and_grad(merit)(jsys.stack)
    mp.undo()
    s2, leaves = with_leaves(tsys)
    out = pt.trace_fast_pol_intensity(s2, port_rays(jr), WL,
                                      state=t_state("H"))
    v = torch.mean(out.x**2 + out.y**2) + 0.3 * torch.mean(out.i)
    v.backward()
    assert float(v.detach()) == pytest.approx(float(val), rel=1e-9)
    assert_grads({k: l.grad for k, l in leaves.items()},
                 {k: np.asarray(getattr(g, k)) for k in STACK_FIELDS})


@pytest.mark.parametrize("fam", ["polynomial", "toroidal"])
def test_plain_kernels_match_jax_kernels(fam):
    """The plain versions of K5a (trace_fast), K1 (trace_fast_field) and K2
    (spot_rms_fast_field) against the JAX package's kernels in interpret
    mode."""
    tsys, jsys = singlets(fam)
    assert jpt.pallas_supported(jsys)
    Px, Py = pupil(N_RAYS, 6)
    jr = jraygen.generate_rays(jsys, *H, jnp.asarray(Px), jnp.asarray(Py),
                               WL)
    if fam == "polynomial":
        assert_rays(ftr.trace_fast(tsys, port_rays(jr), WL),
                    jpt.trace_fast(jsys, jr, WL), rtol=1e-10)
        return
    tPx, tPy = f64(Px), f64(Py)
    assert_rays(ftr.trace_fast_field(tsys, *H, tPx, tPy, WL),
                jpt.trace_fast_field(jsys, *H, jnp.asarray(Px),
                                     jnp.asarray(Py), WL), rtol=1e-10)
    ref = float(jpt.spot_rms_fast_field(jsys, *H, WL, Px=jnp.asarray(Px),
                                        Py=jnp.asarray(Py)))
    assert float(ft.spot_rms_fast_field(tsys, *H, WL, Px=tPx, Py=tPy)) == \
        pytest.approx(ref, rel=1e-10)


# ---------------------------------------------------------------------------
# Layout, NaN sets, builder, paraxial
# ---------------------------------------------------------------------------


def _two_tables(optic):
    """The XY singlet with its second surface a 2 x 2 XY table: the padded
    width is the 3 x 3 table's, so the 2 x 2 one is read with side 3."""
    o = ff.freeform_singlet("polynomial", optic)
    o.surfaces.surfaces[2].surface_type = "polynomial"
    o.surfaces.surfaces[2].coefficients = (0.0, 1e-4, 2e-4, 0.0)
    o._invalidate()
    return o


def test_xy_layout_quirk_matches_jax(monkeypatch):
    monkeypatch.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    tsys = _two_tables(TOptic).system
    jsys = _two_tables(JOptic).system
    assert tsys.stack.coeffs.shape[1] == 9
    row = tsys.stack.coeffs[2]
    x, y = f64([1.5, -2.0]), f64([0.5, 3.0])
    # read with side 3: C[0, 1] = 1e-4 (y), C[0, 2] = 2e-4 (y^2)
    s = tg.sag_static(tg.POLYNOMIAL_XY, f64(np.inf), f64(0.0), row, x, y)
    torch.testing.assert_close(s, 1e-4 * y + 2e-4 * y**2, rtol=1e-14,
                               atol=0)
    Px, Py = pupil(N_RAYS, 2)
    jr = jraygen.generate_rays(jsys, *H, jnp.asarray(Px), jnp.asarray(Py),
                               WL)
    ref, _ = jtrace.trace(jsys, jr, record=False)
    assert_rays(ftr.trace_fast(tsys, port_rays(jr), WL), ref)


def _toroid(radius_x, optic):
    return ff.freeform_singlet("toroidal", optic, radius_x=radius_x)


@pytest.mark.parametrize("radius_x", [4.0, np.inf])
def test_toroid_nan_set_matches_jax(radius_x, monkeypatch):
    """A rotation radius of 4 mm leaves (R - z_y)^2 < x^2 for the outer
    rays (NaN, as in JAX); an infinite one is a cylinder, whose values are
    finite and whose gradient is NaN where JAX's is (the branch not
    taken)."""
    monkeypatch.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    tsys = _toroid(radius_x, TOptic).system
    jsys = _toroid(radius_x, JOptic).system
    jsys = jsys.replace(cfg=dataclasses.replace(jsys.cfg, has_tilts=True))
    def rays_of(Px, Py):
        return jraygen.generate_rays(jsys, *H, jnp.asarray(Px),
                                     jnp.asarray(Py), WL)

    # N_RAYS rays, the shapes of the other JAX references (their compiled
    # operations are shared)
    jr = rays_of(*pupil(N_RAYS, 4))
    ref, _ = jtrace.trace(jsys, jr, record=False)
    got = ftr.trace_fast(tsys, port_rays(jr), WL)
    for k in FIELDS:
        a, b = np_of(getattr(got, k)), np.asarray(getattr(ref, k))
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=k)
        fin = np.isfinite(b)
        np.testing.assert_allclose(a[fin], b[fin], rtol=1e-8, atol=1e-9,
                                   err_msg=k)
    assert np.isnan(np.asarray(ref.x)).any() == np.isfinite(radius_x)
    # the gradient over N_RAYS rays inside the domain (past it every
    # downstream term is NaN in both, in ways their formulations decide),
    # picked by the port, whose NaN set is JAX's (above)
    Px, Py = pupil(4 * N_RAYS, 4)
    inside = torch.isfinite(ftr.trace_fast(
        tsys, port_rays(rays_of(Px, Py)), WL).x).numpy()
    assert inside.sum() >= N_RAYS
    pick = np.flatnonzero(inside)[:N_RAYS]
    jr = rays_of(Px[pick], Py[pick])

    def merit(stack):
        f, _ = jtrace.trace(jsys.replace(stack=stack), jr, record=False)
        return jnp.sum(f.x**2 + f.y**2)

    g = jax.grad(merit)(jsys.stack)
    s2, leaves = with_leaves(tsys)
    f = ftr.trace_fast(s2, port_rays(jr), WL)
    (f.x**2 + f.y**2).sum().backward()
    ref_g = {k: np.asarray(getattr(g, k)) for k in STACK_FIELDS}
    assert_grads({k: l.grad for k, l in leaves.items()}, ref_g)
    # a cylinder's gradient is NaN where JAX's is: its radius's among them
    assert np.isnan(ref_g["radius"][1]) == (not np.isfinite(radius_x))


def test_optic_builder_round_trip():
    """surfaces.add builds the four types with JAX's keyword arguments
    into the same stack, system_from_numpy carries it, and the type of
    a later slice (grid sag) raises naming ROADMAP Queue 2."""
    for fam in FAMS:
        tsys, jsys = singlets(fam)
        assert tsys.cfg.geom_codes == tuple(jsys.cfg.geom_codes)
        for k in ("radius", "conic", "geo_p1", "geo_p2", "coeffs"):
            np.testing.assert_array_equal(
                np_of(getattr(tsys.stack, k)),
                np.asarray(getattr(jsys.stack, k)), err_msg=f"{fam} {k}")
        arrays = {k: np.asarray(getattr(jsys.stack, k)) for k in STACK_FIELDS}
        arrays.update({k: np_of(getattr(tsys, k)) for k in
                       ("aperture_value", "field_x", "field_y", "vig_x",
                        "vig_y", "wavelengths")})
        cfg = {f.name: getattr(tsys.cfg, f.name)
               for f in dataclasses.fields(tsys.cfg)}
        back = system_from_numpy(arrays, cfg)
        for k in ("geo_p1", "geo_p2", "coeffs"):
            torch.testing.assert_close(getattr(back.stack, k),
                                       getattr(tsys.stack, k), rtol=0,
                                       atol=0)
    o = TOptic()
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    for kind, kw in (("grid_sag", {}),):
        with pytest.raises(NotImplementedError, match="Queue 2"):
            o.surfaces.add(index=1, surface_type=kind, **kw)


def test_toroidal_paraxial_f2_matches_jax():
    t = ff.freeform_singlet("toroidal", TOptic)
    j = ff.freeform_singlet("toroidal", JOptic)
    assert float(t.system.stack.geo_p1[1]) == 50.0
    assert float(t.paraxial.f2()) == pytest.approx(float(j.paraxial.f2()),
                                                   rel=1e-12)
    # the meridional radius is what the paraxial trace reads: a toroid of
    # y radius 50 focuses as the XY singlet's R 50 base does
    xy = ff.freeform_singlet("polynomial", TOptic)
    assert float(t.paraxial.f2()) == pytest.approx(float(xy.paraxial.f2()),
                                                   rel=1e-12)


def test_kernel_checks_take_the_freeforms():
    """The coverage, build choice and CUDA-input checks take the four
    codes; a coefficient table past NC_MAX = 36 columns is refused."""
    tsys = ff.freeform_singlet("chebyshev").system
    spec = ftr.fast_spec(tsys)
    assert launch.covered(tsys.cfg) and spec is not None
    assert launch.build_of(spec[0], spec[3], spec[-2]) == launch.FREE
    assert launch.block_width(9, launch.FREE) == 11
    assert launch.block_width(9, launch.SAG) == 9
    # past STOCK_SURF surfaces the Cartesian branch has its own deep build
    deep = (spec[0][0],) * (launch.STOCK_SURF + 1)
    assert launch.build_of(deep, (False,) * len(deep)) == launch.DEEP
    deep = deep[:-1] + (tg.TOROIDAL,)
    assert launch.build_of(deep, (False,) * len(deep)) == launch.DEEP_FREE
    assert launch.block_width(9, launch.DEEP) == 9
    assert launch.block_width(9, launch.DEEP_FREE) == 11
    assert launch.NC_MAX == 36
    params = ft.build_param_table(tsys, WL)
    launch.check_cuda_inputs(params, spec, coeffs=params.new_zeros(4, 36))
    with pytest.raises(NotImplementedError, match="NC_MAX = 36"):
        launch.check_cuda_inputs(params, spec, coeffs=params.new_zeros(4, 37))
