"""optiland_torch's Forbes machinery (``core/forbes.py``) and the
FORBES_QBFS and FORBES_Q2D geometries against the JAX package, on the CPU
in float64.

  * the static basis matrices, the Clenshaw constants and the torch
    Clenshaw sums against JAX's (rtol 1e-13);
  * the sag, normal and Newton distance of Qbfs and Q2d surfaces (the
    goldens' sets, a Q2d layout with empty radial slots, and an m = 1
    series long enough for its - 2/5 alpha_3 term) against JAX's
    functions (rtol 1e-12), rays past u^2 = 1 included, their derivatives
    against ``jax.jacfwd`` (rtol 1e-9), and ``cart_point``'s slopes,
    Hessian and parameter derivatives against autograd of the sag;
  * the laid-out rows: the slots' sum is the Clenshaw sum, a Q2d layout
    denser than its coefficients, and the Qbfs and Q2d lenses of the JAX
    package's ``tests/test_adv_geometries.py`` through ``Optic.trace``
    against ``tests/goldens/adv_geom.npz`` at its tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch.core import forbes as tf
from optiland_torch.core import geometry as tg
from optiland_torch.optic import Optic as TOptic
from optiland_torch.samples import freeform as ff
from optiland_tpu.core import forbes as jf
from optiland_tpu.core import geometry as jg


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


def f64(v, **kw):
    return torch.tensor(v, dtype=torch.float64, **kw)


def _q2d_layout(terms):
    """(nms, values) of a freeform_coeffs dict, as the builders lay it."""
    items = sorted(terms.items(), key=lambda kv: (kv[0][2], kv[0][1],
                                                  kv[0][0]))
    return (tuple((n, m if ab == "a" else -m) for (ab, m, n), _ in items),
            np.array([v for _, v in items]))


def test_basis_and_clenshaw_match_jax():
    for n in (1, 2, 5, 9):
        np.testing.assert_allclose(tf.qbfs_basis_matrix(n),
                                   jf.qbfs_basis_matrix(n), rtol=1e-15)
        for m in (1, 2, 3, 5):
            np.testing.assert_allclose(tf.q2d_basis_matrix(n, m),
                                       jf.q2d_basis_matrix(n, m), rtol=1e-15)
            for k in range(n):
                assert tf.abc_q2d_clenshaw(k, m) == \
                    jf._abc_q2d_clenshaw(k, m)
    u = np.linspace(0, 1, 17)
    rng = np.random.default_rng(2)
    for n in (1, 3, 6):
        c = rng.normal(size=n)
        np.testing.assert_allclose(
            tf.clenshaw_qbfs(list(f64(c)), f64(u)).numpy(),
            np.asarray(jf.clenshaw_qbfs(list(jnp.asarray(c)),
                                        jnp.asarray(u))), rtol=1e-13,
            atol=1e-15)
        for m in (1, 2, 4):
            np.testing.assert_allclose(
                tf.q2d_series_sum(list(f64(c)), m, f64(u)).numpy(),
                np.asarray(jf.q2d_series_sum(list(jnp.asarray(c)), m,
                                             jnp.asarray(u))), rtol=1e-13,
                atol=1e-15)
    nms = ((0, 0), (2, 0), (1, 1), (3, -1), (0, 2))
    assert tf.q2d_partition(nms) == jf.q2d_partition(nms)


# name -> (code, radius, conic, coefficients, p1, aux)
SETS = {
    "qbfs": (tg.FORBES_QBFS, 40.0, -0.8,
             np.array([1e-4, -2e-5, 3e-6, 0.0, 1e-7, 0.0]), 4.0,
             ("qbfs", 5)),
    "q2d": (tg.FORBES_Q2D, 40.0, 0.3,
            np.append(_q2d_layout(ff.Q2D)[1], 0.0), 4.0,
            ("q2d", _q2d_layout(ff.Q2D)[0])),
    # radial slots with no coefficient (n = 1 of m = 0, n = 0 of m = 3)
    "q2d_sparse": (tg.FORBES_Q2D, -35.0, 0.0,
                   np.array([2e-5, 1e-5, -3e-6, 4e-6]), 5.0,
                   ("q2d", ((0, 0), (2, 0), (1, 3), (2, -3)))),
    # an m = 1 series past three terms: the - 2/5 alpha_3 correction
    "q2d_m1": (tg.FORBES_Q2D, 40.0, 0.3,
               np.array([1e-5, 2e-6, -3e-6, 4e-6, 1e-6, 2e-5, 3e-6]), 4.0,
               ("q2d", ((0, 1), (1, 1), (2, 1), (3, 1), (4, 1), (2, 0),
                        (1, -2)))),
}


def _rays(n=30, seed=3):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-4.5, 4.5, n), rng.uniform(-4.5, 4.5, n)
    x[0] = y[0] = 0.0
    L, M = rng.normal(0, 0.05, n), rng.normal(0, 0.05, n)
    L[0] = M[0] = 0.0
    return x, y, np.full(n, -2.0), L, M, np.sqrt(1 - L**2 - M**2)


@pytest.mark.parametrize("name", list(SETS))
def test_geometry_matches_jax(name):
    code, R, k, c, p1, aux = SETS[name]
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

    theta = np.concatenate([[R, k, p1], c])
    ref = np.asarray(jfun(jnp.asarray(theta)))
    np.testing.assert_allclose(tfun(torch.tensor(theta)).numpy(), ref,
                               rtol=1e-12, atol=1e-13)
    jac_ref = np.asarray(jax.jacfwd(jfun)(jnp.asarray(theta)))
    jac = torch.autograd.functional.jacobian(tfun, torch.tensor(theta))
    np.testing.assert_allclose(jac.numpy(), jac_ref, rtol=1e-9,
                               atol=1e-12 * np.abs(jac_ref).max())
    # rays past u^2 = 1 (the cut) are among them
    assert (np.hypot(*_rays()[:2]) > p1).any()


@pytest.mark.parametrize("name", list(SETS))
def test_slopes_and_hessian_match_autograd(name):
    code, R, k, c, p1, aux = SETS[name]
    rng = np.random.default_rng(5)
    X = f64(rng.uniform(-4, 4, 25), requires_grad=True)
    Y = f64(rng.uniform(-4.5, 4.5, 25), requires_grad=True)
    th = [f64(v, requires_grad=True) for v in (R, k, p1, 1.0)]
    C = f64(c, requires_grad=True)
    s = tg.sag_static(code, th[0], th[1], C, X, Y, th[2], th[3], aux=aux)
    gx, gy = torch.autograd.grad(s.sum(), (X, Y), create_graph=True)
    q, slots = tg.aux_row(code, aux, C)
    pt = tg.cart_point(code, th[0], th[1], q, th[2], th[3], X, Y, grad=True,
                       lay=slots)
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
    auto = torch.autograd.grad(pt.s.sum(), th, allow_unused=True,
                               materialize_grads=True)
    for d, b in zip((pt.dR, pt.dk, pt.dp1, pt.dp2), auto):
        torch.testing.assert_close(d[0].sum(), b, rtol=1e-10, atol=1e-15)


def test_layouts():
    """Qbfs reads its first n_terms slots (none past them); a Q2d layout
    is as wide as its dense radial slots, which can pass its coefficient
    count."""
    slots, T = tg.aux_layout(tg.FORBES_QBFS, ("qbfs", 5), 6)
    assert len(slots) == 5 and not T[:, 5].any()
    assert tg.aux_layout(tg.FORBES_QBFS, ("qbfs", 0), 3)[1].shape == (0, 3)
    nms = ((0, 0), (6, 0), (4, 2))
    slots, T = tg.aux_layout(tg.FORBES_Q2D, ("q2d", nms), 3)
    assert len(slots) == 7 + 5 and T.shape == (12, 3)
    assert [s[4:] for s in slots] == [(0, 0, 1)] * 7 + [(2, 0, 0)] * 5
    # the layout table's rows round-trip
    rows = tg.layout_rows(slots, 14)
    assert tg.slots_of(rows)[:12] == slots and len(rows) == 14


def _adv_lens(family):
    """The JAX package's qbfs_lens / q2d_lens (tests/test_adv_geometries.py)
    built with the port: the freeform singlet frame, fields 0 and 3 deg."""
    o = TOptic()
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    o.surfaces.add(index=1, thickness=6.0, material="N-BK7", is_stop=True,
                   **ff.FAMILIES[family])
    o.surfaces.add(index=2, radius=-60.0, thickness=30.0)
    o.surfaces.add(index=3)
    o.set_aperture("EPD", 10.0)
    o.fields.set_type("angle")
    o.fields.add(y=0)
    o.fields.add(y=3)
    o.wavelengths.add(0.55, is_primary=True)
    return o


@pytest.mark.parametrize("tag, family", [("qbfs", "forbes_qbfs"),
                                         ("q2d", "forbes_q2d")])
def test_adv_goldens(tag, family):
    g = np.load("tests/goldens/adv_geom.npz")
    rays = _adv_lens(family).trace(Hy=1.0, num_rays=5)
    for c in ("x", "y", "L", "M", "N", "i"):
        np.testing.assert_allclose(getattr(rays, c).numpy(), g[f"{tag}_{c}"],
                                   rtol=1e-7, atol=1e-9, err_msg=c)
