"""optiland_torch's Zernike polynomials (``optiland_torch/zernike``) and the
ZERNIKE_SAG geometry against the JAX package, on the CPU in float64.

  * the terms of the three schemes against JAX's functions and the goldens
    of the original Optiland (``tests/goldens/zernike_deep.npz``, all 36
    terms at JAX's tolerances), the indices, radial derivatives and
    Cartesian derivatives, and ``ZernikeFit`` against JAX's fit;
  * the sag, normal and Newton distance of a Zernike surface of each
    scheme against JAX's functions (rtol 1e-12) and the golden set
    (``geometries.npz``: sag rtol 1e-9, normal rtol 1e-6), their
    derivatives in radius, conic, p1 (norm radius) and the coefficients
    against ``jax.jacfwd`` (rtol 1e-9), and the slopes, Hessian and
    parameter derivatives of ``cart_point`` against autograd of the sag;
  * the term count that follows the table's padded width nc (a padded slot
    is a term with a zero coefficient, whose gradient is nonzero, as
    JAX's), and the guarded origin: at exactly r = 0 the normal is (0, 0,
    -1) and the gradient JAX's, while at r = 1e-9 the slopes are the
    limit's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch import zernike as tz
from optiland_torch.core import geometry as tg
from optiland_tpu import zernike as jz
from optiland_tpu.core import geometry as jg

ZC = np.array([0.001, -0.002, 0.0005, 0.0003, 0.0001, 0.0002])
SCHEMES = ("standard", "fringe", "noll")


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


def f64(v, **kw):
    return torch.tensor(v, dtype=torch.float64, **kw)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_terms_match_jax_and_goldens(scheme):
    g = np.load("tests/goldens/zernike_deep.npz")
    r, phi = g["r"], g["phi"]
    tcls, jcls = tz.ZERNIKE_CLASSES[scheme], jz.ZERNIKE_CLASSES[scheme]
    t = tcls(coeffs=torch.ones(36, dtype=torch.float64))
    assert t.indices == jcls(coeffs=np.ones(36)).indices
    terms = np.stack([v.numpy() for v in t.terms(f64(r), f64(phi))])
    np.testing.assert_allclose(terms, g[f"{scheme}_terms"], rtol=1e-9,
                               atol=1e-12)
    rng = np.random.default_rng(4)
    c = rng.normal(size=21)
    x, y = rng.uniform(-0.7, 0.7, 40), rng.uniform(-0.7, 0.7, 40)
    rr, pp = np.hypot(x, y), np.arctan2(y, x)
    tc, jc = tcls(coeffs=f64(c)), jcls(coeffs=jnp.asarray(c))
    np.testing.assert_allclose(tc.poly(f64(rr), f64(pp)).numpy(),
                               np.asarray(jc.poly(rr, pp)), rtol=1e-12,
                               atol=1e-14)
    for a, b in zip(tc.derivatives_cartesian(f64(x), f64(y)),
                    jc.derivatives_cartesian(jnp.asarray(x),
                                             jnp.asarray(y))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-11,
                                   atol=1e-12)
    for n, m in tc.indices:
        np.testing.assert_allclose(
            tz.radial_derivative(n, m, f64(rr)).numpy(),
            np.asarray(jz.radial_derivative(n, m, jnp.asarray(rr))),
            rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_fit_matches_jax(scheme):
    rng = np.random.default_rng(8)
    x, y = rng.uniform(-0.7, 0.7, 300), rng.uniform(-0.7, 0.7, 300)
    true = rng.normal(size=15)
    z = np.asarray(jz.ZERNIKE_CLASSES[scheme](coeffs=true).poly(
        np.hypot(x, y), np.arctan2(y, x)))
    z = z + 1e-3 * rng.normal(size=z.shape)
    tf = tz.ZernikeFit(f64(x), f64(y), f64(z), scheme, 15)
    jf = jz.ZernikeFit(x, y, z, scheme, 15)
    np.testing.assert_allclose(tf.coeffs.numpy(), np.asarray(jf.coeffs),
                               rtol=1e-9, atol=1e-12)
    assert float(tf.rms_error()) == pytest.approx(float(jf.rms_error()),
                                                  rel=1e-9)
    np.testing.assert_allclose(
        tf.predict(f64(0.3 + 0 * x[:5]), f64(x[:5])).numpy(),
        np.asarray(jf.predict(0.3 + 0 * x[:5], x[:5])), rtol=1e-11)


# scheme -> (coefficients, p1): the golden set, and wider seeded ones
ZSETS = {
    "fringe": (ZC, 8.0),
    "standard": (np.random.default_rng(2).normal(0, 1e-4, 15), 6.0),
    "noll": (np.random.default_rng(3).normal(0, 1e-4, 12), 6.0),
}


def _rays(n=30, seed=3):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-4.5, 4.5, n), rng.uniform(-4.5, 4.5, n)
    x[0] = y[0] = 0.0  # the vertex ray, at exactly r = 0
    L, M = rng.normal(0, 0.05, n), rng.normal(0, 0.05, n)
    L[0] = M[0] = 0.0
    return x, y, np.full(n, -2.0), L, M, np.sqrt(1 - L**2 - M**2)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_geometry_matches_jax_and_goldens(scheme):
    c, p1 = ZSETS[scheme]
    aux = (scheme,)
    code = tg.ZERNIKE_SAG
    if scheme == "fringe":
        g = np.load("tests/goldens/geometries.npz")
        args = (f64(50.0), f64(-0.5), f64(ZC), f64(g["x"]), f64(g["y"]),
                f64(8.0), f64(1.0))
        np.testing.assert_allclose(tg.sag_static(code, *args, aux=aux),
                                   g["zernike_sag"], rtol=1e-9, atol=1e-12)
        nrm = tg.surface_normal_static(code, *args, aux=aux)
        for a, key in zip(nrm, ("nx", "ny", "nz")):
            np.testing.assert_allclose(a.numpy(), g[f"zernike_{key}"],
                                       rtol=1e-6, atol=1e-9)
    J = [jnp.asarray(v) for v in _rays()]
    T = [torch.tensor(v) for v in _rays()]

    def jfun(th):
        R_, k_, p1_, cc = th[0], th[1], th[2], th[3:]
        t = jg.distance_static(code, R_, k_, cc, *J, p1=p1_, aux=aux)
        nr = jg.surface_normal_static(code, R_, k_, cc, J[0], J[1], p1=p1_,
                                      aux=aux)
        sg = jg.sag_static(code, R_, k_, cc, J[0], J[1], p1=p1_, aux=aux)
        return jnp.concatenate([t, sg, *nr])

    def tfun(th):
        R_, k_, p1_, cc = th[0], th[1], th[2], th[3:]
        t = tg.distance_static(code, R_, k_, *T, coeffs=cc, p1=p1_, aux=aux)
        nr = tg.surface_normal_static(code, R_, k_, cc, T[0], T[1], p1_,
                                      aux=aux)
        sg = tg.sag_static(code, R_, k_, cc, T[0], T[1], p1_, aux=aux)
        return torch.cat([t, sg, *nr])

    theta = np.concatenate([[50.0, -0.5, p1], c])
    ref = np.asarray(jfun(jnp.asarray(theta)))
    np.testing.assert_allclose(tfun(torch.tensor(theta)).numpy(), ref,
                               rtol=1e-12, atol=1e-13)
    jac_ref = np.asarray(jax.jacfwd(jfun)(jnp.asarray(theta)))
    jac = torch.autograd.functional.jacobian(tfun, torch.tensor(theta))
    np.testing.assert_allclose(jac.numpy(), jac_ref, rtol=1e-9,
                               atol=1e-12 * np.abs(jac_ref).max())


@pytest.mark.parametrize("scheme", SCHEMES)
def test_slopes_and_hessian_match_autograd(scheme):
    """cart_point's slopes against autograd of the transcribed sag, and its
    Hessian and parameter derivatives against autograd of its slopes."""
    c, p1 = ZSETS[scheme]
    rng = np.random.default_rng(5)
    X = f64(rng.uniform(-4, 4, 25), requires_grad=True)
    Y = f64(rng.uniform(-4.5, 4.5, 25), requires_grad=True)
    th = [f64(v, requires_grad=True) for v in (50.0, -0.5, p1, 1.0)]
    C = f64(c, requires_grad=True)
    aux = (scheme,)
    s = tg.sag_static(tg.ZERNIKE_SAG, th[0], th[1], C, X, Y, th[2], th[3],
                      aux=aux)
    gx, gy = torch.autograd.grad(s.sum(), (X, Y), create_graph=True)
    q, slots = tg.aux_row(tg.ZERNIKE_SAG, aux, C)
    pt = tg.cart_point(tg.ZERNIKE_SAG, th[0], th[1], q, th[2], th[3], X, Y,
                       grad=True, lay=slots)
    torch.testing.assert_close(pt.s, s, rtol=1e-13, atol=1e-15)
    torch.testing.assert_close(pt.sx, gx, rtol=1e-12, atol=1e-15)
    torch.testing.assert_close(pt.sy, gy, rtol=1e-12, atol=1e-15)
    for val, hx, hy, j in ((pt.sx, pt.hxx, pt.hxy, 1),
                           (pt.sy, pt.hyx, pt.hyy, 2)):
        auto = torch.autograd.grad(val.sum(), [X, Y] + th, retain_graph=True,
                                   allow_unused=True, materialize_grads=True)
        hand = [hx, hy] + [d[j].sum() for d in (pt.dR, pt.dk, pt.dp1,
                                                 pt.dp2)]
        for a, b in zip(hand, auto):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-15)


def test_layout_is_the_padded_width():
    """The laid-out row has nc slots for every scheme and width (each
    azimuthal order's radial orders are an unbroken run), and the slots'
    sum is the terms' sum at any point."""
    for scheme in SCHEMES:
        for nc in (1, 6, 11, 36):
            slots, T = tg.aux_layout(tg.ZERNIKE_SAG, (scheme,), nc)
            assert len(slots) == nc and T.shape == (nc, nc)
    c = f64(np.random.default_rng(1).normal(size=36))
    x, y = f64([0.3, -1.2, 2.0]), f64([0.7, 0.4, -1.1])
    s = tg.sag_static(tg.ZERNIKE_SAG, f64(np.inf), f64(0.0), c, x, y,
                      f64(3.0), aux=("noll",))
    q, slots = tg.aux_row(tg.ZERNIKE_SAG, ("noll",), c)
    pt = tg.cart_point(tg.ZERNIKE_SAG, f64(np.inf), f64(0.0), q, f64(3.0),
                       None, x, y, lay=slots)
    torch.testing.assert_close(pt.s, s, rtol=1e-12, atol=1e-14)


def test_padded_slots_and_the_origin_match_jax():
    """A 6-term fringe surface in a table of width 9 reads 9 terms: the
    sag's gradient in the padded slots is nonzero, as JAX's. At exactly
    r = 0 the normal is (0, 0, -1), the slopes' coefficient gradient 0;
    at r = 1e-9 the tilt terms' slope is the limit's."""
    code, aux = tg.ZERNIKE_SAG, ("fringe",)
    cpad = np.concatenate([ZC, np.zeros(3)])
    x = np.array([0.0, 1e-9, 2.5, -3.0])
    y = np.array([0.0, 0.0, 1.5, 0.5])

    def jfun(cc):
        nr = jg.surface_normal_static(code, 50.0, -0.5, cc, jnp.asarray(x),
                                      jnp.asarray(y), p1=8.0, aux=aux)
        sg = jg.sag_static(code, 50.0, -0.5, cc, jnp.asarray(x),
                           jnp.asarray(y), p1=8.0, aux=aux)
        return jnp.concatenate([sg, *nr])

    def tfun(cc):
        nr = tg.surface_normal_static(code, f64(50.0), f64(-0.5), cc,
                                      f64(x), f64(y), f64(8.0), aux=aux)
        sg = tg.sag_static(code, f64(50.0), f64(-0.5), cc, f64(x), f64(y),
                           f64(8.0), aux=aux)
        return torch.cat([sg, *nr])

    ref = np.asarray(jfun(jnp.asarray(cpad)))
    got = tfun(f64(cpad)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)
    nx, ny, nz = got[4:8], got[8:12], got[12:16]
    assert (nx[0], ny[0], nz[0]) == (0.0, 0.0, -1.0)
    np.testing.assert_allclose([nx[1], ny[1]], [-2.5e-4, 6.25e-5],
                               rtol=1e-6)
    jac_ref = np.asarray(jax.jacfwd(jfun)(jnp.asarray(cpad)))
    jac = torch.autograd.functional.jacobian(tfun, f64(cpad)).numpy()
    np.testing.assert_allclose(jac, jac_ref, rtol=1e-9,
                               atol=1e-13 * np.abs(jac_ref).max())
    assert np.abs(jac_ref[:4, 6:]).max() > 0  # the padded terms' sag
    assert np.abs(jac_ref[[4, 8], :]).max() == 0  # no slope at r = 0
