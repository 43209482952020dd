"""optiland_torch's radial aspheres (kernel K6b: EVEN_ASPHERE, ODD_ASPHERE)
against the JAX package, on the CPU in float64, where the wrappers run the
kernels' plain versions.

  * geometry: the sag, normal and Newton distance of both families against
    JAX's functions, the vertex r = 0 included (where the odd family's terms
    have zero slope), values to rtol 1e-12 and their derivatives with
    respect to radius, conic and coefficients to rtol 1e-9 (the normal's
    derivative is written out where JAX takes it by AD);
  * the hand adjoint of the step against autograd of ``step_plain``, for
    each family, tilted and untilted, annular flag on and off, merit and
    full forms, to rtol 1e-10;
  * the kernels' plain versions (trace_fwd K5a, trace_field_fwd K1,
    merit_fwd K2, trace_fwd_poly) against the JAX package's kernels in
    interpret mode on the aspheric singlet (and trace_fwd on its odd
    variant): rtol 1e-10 with atol 1e-12 (the JAX test's tolerance is
    1e-8 / 1e-10; both take 10 Newton steps);
  * gradients with respect to every stack leaf, the coefficient table
    included (nonzero), of trace_fast, trace_fast_field and
    spot_rms_fast_field on the singlet, its odd variant and bench.py's
    tilted asphere, against jax.grad of the JAX package's XLA path on its
    unrolled engine (16 Newton steps against the kernels' 10): rtol 1e-7
    with atol 1e-12 x the largest entry (the untilted systems' tilt
    gradients aside: the XLA path runs no rotation there);
  * the slice end to end on the tilted asphere: ``Optic.trace`` and
    ``rms_spot_size`` against the JAX package's XLA path (rtol 1e-9) and
    ``spot_rms_fast_field`` with explicit samples against its kernel
    (rtol 1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch.analysis import rms_spot_size
from optiland_torch.core import geometry as tg
from optiland_torch.core import raygen as traygen
from optiland_torch.core.rays import RealRays as TRays
from optiland_torch.core.system import STACK_FIELDS
from optiland_torch.ops import fast_trace as ftr
from optiland_torch.ops import fused_trace as ft
from optiland_torch.ops import step
from optiland_torch.samples import AsphericSinglet as TSinglet
from optiland_torch.samples import perturbed
from optiland_tpu.analysis import spot as jspot
from optiland_tpu.core import geometry as jg
from optiland_tpu.core import raygen as jraygen
from optiland_tpu.core import trace as jtrace
from optiland_tpu.ops import pallas_trace as jpt
from optiland_tpu.samples import AsphericSinglet as JSinglet
from tests.torch_shared import value_and_jacfwd

WL = 0.587
H = (0.0, 0.0)
FIELDS = ftr.RAY_FIELDS
CODES = {"even": tg.EVEN_ASPHERE, "odd": tg.ODD_ASPHERE}
COEFFS = {"even": (-2.2e-3, 4.6e-5, -6.4e-7),
          "odd": (0.0, -2.2e-3, 3.0e-5, 4.6e-5, -6.4e-7)}


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


def pupil(n, seed):
    """n pupil points on the unit disk, the first the centre (the chief ray
    of an on-axis field lands on the vertex)."""
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n)) * 0.97
    th = rng.uniform(0, 2 * np.pi, size=n)
    r[0] = 0.0
    return r * np.cos(th), r * np.sin(th)


def np_of(v):
    return v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)


def systems(kind):
    """(port system, JAX system) of the singlet ("even"), its odd variant
    or bench.py's tilted asphere."""
    build = {"even": lambda cls: cls(), "odd": perturbed.odd_asphere,
             "tilted": perturbed.tilted_asphere}[kind]
    return build(TSinglet).system, build(JSinglet).system


def with_leaves(system):
    leaves = {k: v.detach().clone().requires_grad_(v.numel() > 0)
              for k, v in system.stack.leaves().items()}
    return system.replace(stack=system.stack.replace(**leaves)), leaves


def assert_grads(got, ref, rtol, skip=()):
    scale = max(float(np.nanmax(np.abs(v))) for v in ref.values() if v.size)
    for k in STACK_FIELDS:
        if k in skip:
            continue
        g = np.zeros(ref[k].shape) if got[k] is None else got[k].numpy()
        fin = np.isfinite(ref[k])
        np.testing.assert_allclose(g[fin], ref[k][fin], rtol=rtol,
                                   atol=1e-12 * scale, err_msg=k)


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fam", ["even", "odd"])
def test_geometry_matches_jax(fam):
    code, c = CODES[fam], np.array(COEFFS[fam])
    rng = np.random.default_rng(4)
    n = 40
    x, y = rng.uniform(-4, 4, n), rng.uniform(-4, 4, n)
    x[0] = y[0] = 0.0
    z = np.full(n, -3.0)
    L, M = rng.normal(0, 0.05, n), rng.normal(0, 0.05, n)
    L[0] = M[0] = 0.0
    N = np.sqrt(1 - L**2 - M**2)
    R, k = 25.0, -0.6
    J = [jnp.asarray(v) for v in (x, y, z, L, M, N)]
    T = [torch.tensor(v) for v in (x, y, z, L, M, N)]

    def jfun(theta):
        cc = theta[2:]
        t = jg.distance_static(code, theta[0], theta[1], cc, *J)
        nrm = jg.surface_normal_static(code, theta[0], theta[1], cc, J[0],
                                       J[1])
        s = jg.sag_static(code, theta[0], theta[1], cc, J[0], J[1])
        return jnp.concatenate([t, s, *nrm])

    def tfun(theta):
        cc = theta[2:]
        t = tg.distance_static(code, theta[0], theta[1], *T, coeffs=cc)
        nrm = tg.surface_normal_static(code, theta[0], theta[1], cc, T[0],
                                       T[1])
        s = tg.sag_static(code, theta[0], theta[1], cc, T[0], T[1])
        return torch.cat([t, s, *nrm])

    theta = np.concatenate([[R, k], c])
    ref, jac_ref = value_and_jacfwd(jfun, theta)
    got = tfun(torch.tensor(theta)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14)
    # the vertex: zero slope (the odd terms too)
    assert got[2 * n] == 0.0 and got[3 * n] == 0.0
    jac = torch.autograd.functional.jacobian(tfun, torch.tensor(theta))
    np.testing.assert_allclose(jac.numpy(), jac_ref, rtol=1e-9,
                               atol=1e-12 * np.abs(jac_ref).max())


# ---------------------------------------------------------------------------
# The hand adjoint of the step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form, inner", [
    ("merit", False), ("full", False), ("full", True), ("extras", False),
    ("extras", True), ("mirror", False), ("mirror", True)])
@pytest.mark.parametrize("tilted", [False, True])
@pytest.mark.parametrize("fam", ["even", "odd"])
def test_step_adjoint_matches_autograd(fam, tilted, form, inner):
    code = CODES[fam]
    c = torch.tensor(COEFFS[fam], dtype=torch.float64)
    rng = np.random.default_rng(11)
    n = 60
    p = torch.zeros(step.NUM_P, dtype=torch.float64)
    p[step.P_RADIUS], p[step.P_CONIC], p[step.P_POS] = 25.0, -0.7, 3.0
    p[step.P_NPOST], p[step.P_APMAX], p[step.P_APMIN] = 1.6, 6.0, 1.5
    p[step.P_DX], p[step.P_DY], p[step.P_KPRE] = 0.1, -0.05, 0.01
    if tilted:
        p[step.P_RX], p[step.P_RY], p[step.P_RZ] = 0.01, -0.02, 0.015
    x, y = (torch.tensor(rng.uniform(-5, 5, n)) for _ in range(2))
    x[0], y[0] = 0.1, -0.05  # onto the vertex (untilted)
    L, M = (torch.tensor(rng.normal(0, 0.05, n)) for _ in range(2))
    L[0] = M[0] = 0.0
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
                          extras=extras, c=cg, inner=inner)
    cots = [torch.tensor(rng.normal(size=n)) for _ in range(len(out[0]) + 1)]
    loss = sum((o * g).sum() for o, g in zip(out[0] + (out[1],), cots))
    g_ext = None
    if extras:
        g_ext = [torch.tensor(rng.normal(size=n)) for _ in range(7)]
        loss = loss + sum((o * g).sum() for o, g in zip(out[2], g_ext))
    auto = torch.autograd.grad(loss, [pg, cg, ng] + sg)
    g = tuple(cots[:6]) + (cots[-1],) + tuple(cots[6:-1])
    g_in, g_npre, cols = step.step_adjoint_plain(
        code, refl, p, n_pre, tuple(st), g, absorbs=full, g_ext=g_ext,
        tilted=tilted, c=c, inner=inner)
    gc = step.FULL_GRAD_COLS if full else step.GRAD_COLS
    dp = torch.stack([v.sum() for v in cols[:len(gc)]])
    dc = torch.stack([v.sum() for v in cols[len(gc):]])

    def close(a, b, what):
        torch.testing.assert_close(a, b, rtol=1e-10,
                                   atol=1e-12 * float(b.abs().max()),
                                   msg=what)

    close(dp, auto[0][list(gc)], "param columns")
    close(dc, auto[1], "coefficients")
    assert float(dc.abs().min()) > 0 or fam == "odd"
    close(g_npre.sum(), auto[2], "n_pre")
    for k, (a, b) in enumerate(zip(g_in, auto[3:])):
        close(a, b, f"state {k}")


# ---------------------------------------------------------------------------
# The kernels' plain versions against the JAX package's kernels
# ---------------------------------------------------------------------------


def port_rays(jrays):
    return TRays(**{k: torch.tensor(np.asarray(getattr(jrays, k)))
                    for k in FIELDS + ("w",)})


def _rays_close(got, ref, rtol=1e-10, atol=1e-12):
    for k in FIELDS:
        np.testing.assert_allclose(np_of(getattr(got, k)),
                                   np.asarray(getattr(ref, k)), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("fam", ["even", "odd"])
def test_plain_kernels_match_jax_kernels(fam):
    tsys, jsys = systems(fam)
    assert jpt.pallas_supported(jsys) and ftr.fast_supported(tsys, True)
    Px, Py = pupil(200, 5)
    jrays = jraygen.generate_rays(jsys, *H, jnp.asarray(Px), jnp.asarray(Py),
                                  WL)
    # K5a
    _rays_close(ftr.trace_fast(tsys, port_rays(jrays), WL),
                jpt.trace_fast(jsys, jrays, WL))
    if fam == "odd":
        return
    # K1, K2
    tPx, tPy = torch.tensor(Px), torch.tensor(Py)
    _rays_close(ftr.trace_fast_field(tsys, *H, tPx, tPy, WL),
                jpt.trace_fast_field(jsys, *H, jnp.asarray(Px),
                                     jnp.asarray(Py), WL))
    ref = float(jpt.spot_rms_fast_field(jsys, *H, WL, Px=jnp.asarray(Px),
                                        Py=jnp.asarray(Py)))
    assert float(ft.spot_rms_fast_field(tsys, *H, WL, Px=tPx, Py=tPy)) == \
        pytest.approx(ref, rel=1e-10)
    # the poly mode of K5a, wavelengths cycling by ray
    w = np.array([0.48, 0.55, 0.65])[np.arange(200) % 3]
    jr = jrays.replace(w=jnp.asarray(w))
    tr = port_rays(jrays).replace(w=torch.tensor(w))
    _rays_close(ftr.trace_fast_poly(tsys, tr), jpt.trace_fast_poly(jsys, jr))


@pytest.mark.parametrize("kind", ["even", "odd", "tilted"])
def test_gradients_match_jax_xla(kind, monkeypatch):
    """Every stack leaf's gradient, the coefficient table's included, of
    the three entries against jax.grad of the XLA path."""
    monkeypatch.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    tsys, jsys = systems(kind)
    Px, Py = pupil(150, 6)
    jPx, jPy = jnp.asarray(Px), jnp.asarray(Py)

    def jmerits(stack):
        s = jsys.replace(stack=stack)
        f, _ = jtrace.trace(s, jraygen.generate_rays(s, *H, jPx, jPy, WL),
                            record=False)
        spot = jnp.mean((f.x - f.x.mean()) ** 2 + (f.y - f.y.mean()) ** 2)
        return jnp.stack([jnp.mean(f.x**2 + f.y**2) + 1e-3 * jnp.mean(f.opd)
                          + 0.3 * jnp.mean(f.i), spot])

    vals = jmerits(jsys.stack)
    jac = jax.jacrev(jmerits)(jsys.stack)
    ref = [{k: np.asarray(getattr(jac, k))[j] for k in STACK_FIELDS}
           for j in range(2)]
    tPx, tPy = torch.tensor(Px), torch.tensor(Py)
    for entry in ("trace_fast", "trace_fast_field", "spot_rms_fast_field"):
        s2, leaves = with_leaves(tsys)
        if entry == "spot_rms_fast_field":
            val = ft.spot_rms_fast_field(s2, *H, WL, Px=tPx, Py=tPy)
            j = 1
        else:
            if entry == "trace_fast":
                f = ftr.trace_fast(s2, traygen.generate_rays(
                    s2, *H, tPx, tPy, WL), WL)
            else:
                f = ftr.trace_fast_field(s2, *H, tPx, tPy, WL)
            val = (torch.mean(f.x**2 + f.y**2) + 1e-3 * torch.mean(f.opd)
                   + 0.3 * torch.mean(f.i))
            j = 0
        val.backward()
        assert float(val.detach()) == pytest.approx(float(vals[j]), rel=1e-9)
        got = {k: v.grad for k, v in leaves.items()}
        # the XLA path runs no rotation for a system without a tilt (its
        # tilt gate is closed), so its tilt gradients are 0 there, where
        # the kernels give the true derivatives, as the JAX package's do
        assert_grads(got, ref[j], 1e-7,
                     skip=() if kind == "tilted" else ("rx", "ry", "rz"))
        assert float(got["coeffs"][1].abs().min()) > 0 or kind == "odd"


# ---------------------------------------------------------------------------
# The slice end to end
# ---------------------------------------------------------------------------


def test_tilted_asphere_end_to_end(monkeypatch):
    monkeypatch.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    tlens = perturbed.tilted_asphere()
    jlens = perturbed.tilted_asphere(JSinglet)
    got = tlens.trace(Hy=0.0, num_rays=8, record=False)
    ref = jlens.trace(Hy=0.0, num_rays=8, record=False)
    for k in ("x", "y", "z", "L", "M", "N", "opd", "i"):
        np.testing.assert_allclose(np_of(getattr(got, k)),
                                   np.asarray(getattr(ref, k)), rtol=1e-9,
                                   atol=1e-12, err_msg=k)
    Px, Py = pupil(120, 8)
    tsys, jsys = tlens.system, jlens.system
    v = rms_spot_size(tsys, *H, torch.tensor(Px), torch.tensor(Py), WL)
    v_ref = jspot.rms_spot_size(jsys, *H, jnp.asarray(Px), jnp.asarray(Py),
                                WL)
    assert float(v) == pytest.approx(float(v_ref), rel=1e-9)
    m = ft.spot_rms_fast_field(tsys, *H, WL, Px=torch.tensor(Px),
                               Py=torch.tensor(Py))
    m_ref = jpt.spot_rms_fast_field(jsys, *H, WL, Px=jnp.asarray(Px),
                                    Py=jnp.asarray(Py))
    assert float(m) == pytest.approx(float(m_ref), rel=1e-10)
    assert float(m) == pytest.approx(float(v) ** 2, rel=1e-9)


def test_coated_asphere_pol_matches_jax_kernel():
    """The polarized plain version (K8, full mode) on the Fresnel-coated
    asphere in H against the JAX package's kernel in interpret mode: rays
    to rtol 1e-10 with atol 1e-12, p to atol 1e-12."""
    from optiland_torch.ops import pol_trace as pt
    from optiland_tpu.ops.pallas_pol import trace_fast_pol as j_fast_pol

    tsys = perturbed.coated_asphere("H").system
    jsys = perturbed.coated_asphere("H", JSinglet).system
    Px, Py = pupil(150, 9)
    jrays = jraygen.generate_rays(jsys, *H, jnp.asarray(Px), jnp.asarray(Py),
                                  WL)
    ref, p_ref = j_fast_pol(jsys, jrays, WL)
    got, p = pt.trace_fast_pol(tsys, port_rays(jrays), WL)
    _rays_close(got, ref)
    np.testing.assert_allclose(np_of(p), np.asarray(p_ref), rtol=1e-10,
                               atol=1e-12)
