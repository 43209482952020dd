"""optiland_torch's aux-bearing sag families (kernel K6b's ZERNIKE_SAG,
FORBES_QBFS, FORBES_Q2D) through the kernels' plain versions and the
entry points, against the JAX package, on the CPU in float64.

  * the hand adjoint of the step against autograd of ``step_plain`` for
    each family on its laid-out row, tilted and untilted, merit, full,
    polarized-extras and mirror forms (rtol 1e-10, atol 1e-12 x the
    largest entry), with no cotangent for P_G2, which they do not read;
  * the Zernike, Qbfs and Q2d singlets (``samples/freeform.py``) through
    ``trace``, ``rms_spot_size``, ``trace_fast``, ``trace_fast_field``
    and ``spot_rms_fast_field``, the Q2d singlet through
    ``trace_fast_poly`` and the Fresnel-coated Zernike singlet through
    ``trace_fast_pol_intensity``, against the JAX package's XLA path:
    values to rtol 1e-8 with atol 1e-9 mm (1e-12 for directions), the
    gradient of every stack leaf (geo_p1 and coeffs included) to rtol 1e-7
    of the largest entry where JAX's is finite, with the same NaN set;
  * the plain versions of K5a and K1/K2 against the JAX package's kernels
    in interpret mode, and the on-axis chief ray at exactly r = 0 on the
    Zernike surface beside one at r ~ 1e-9;
  * the ``Optic`` builder of the three types (all three Zernike schemes),
    ``system_from_numpy``'s round trip of their extras, the refusals of
    the types still to come, and the kernel checks (coverage, the aux
    builds, the laid-out table and its NC_MAX bound).
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
from optiland_torch.core.system import STACK_FIELDS, system_from_numpy
from optiland_torch.ops import fast_trace as ftr
from optiland_torch.ops import fused_trace as ft
from optiland_torch.ops import launch
from optiland_torch.ops import pol_trace as pt
from optiland_torch.ops import step
from optiland_torch.optic import Optic as TOptic
from optiland_torch.polarization import create_polarization as t_state
from optiland_torch.samples import freeform as ff
from optiland_tpu.core import raygen as jraygen
from optiland_tpu.core import trace as jtrace
from optiland_tpu.ops import pallas_trace as jpt
from optiland_tpu.ops.pallas_pol import trace_fast_pol as j_fast_pol
from optiland_tpu.optic import Optic as JOptic
from optiland_tpu.polarization import create_polarization as j_state
from optiland_tpu.polarization import polarized_intensity as j_ipol
from tests.test_torch_freeform import (
    assert_grads, assert_rays, f64, merit_of, np_of, port_rays, pupil,
    with_leaves,
)

WL = ff.WAVELENGTH
H = ff.H
N_RAYS = 120
AUX = ff.AUX_FAMILIES
CODES = {"zernike": tg.ZERNIKE_SAG, "forbes_qbfs": tg.FORBES_QBFS,
         "forbes_q2d": tg.FORBES_Q2D}


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


# ---------------------------------------------------------------------------
# The hand adjoint of the step
# ---------------------------------------------------------------------------

# family -> (radius, conic, coefficients, p1, aux): p1 small enough that
# some rays pass u^2 = 1 (the Forbes cut)
STEP_SETS = {
    "zernike": (50.0, -0.5, np.random.default_rng(1).normal(0, 1e-4, 15),
                8.0, ("fringe",)),
    "forbes_qbfs": (40.0, -0.8, np.array([1e-4, -2e-5, 3e-6, 0.0, 1e-7]),
                    4.0, ("qbfs", 5)),
    "forbes_q2d": (40.0, 0.3,
                   np.array([1e-5, 2e-6, -3e-6, 4e-6, 1e-6, 2e-5, 3e-6]), 4.0,
                   ("q2d", ((0, 1), (1, 1), (2, 1), (3, 1), (4, 1), (2, 0),
                            (1, -2)))),
}


@pytest.mark.parametrize("form", ["merit", "full", "extras", "mirror"])
@pytest.mark.parametrize("tilted", [False, True])
@pytest.mark.parametrize("fam", AUX)
def test_step_adjoint_matches_autograd(fam, tilted, form):
    code = CODES[fam]
    R, k, C, p1, aux = STEP_SETS[fam]
    q, slots = tg.aux_row(code, aux, torch.tensor(C))
    rng = np.random.default_rng(11)
    n = 60
    p = torch.zeros(step.NUM_P, dtype=torch.float64)
    p[step.P_RADIUS], p[step.P_CONIC], p[step.P_POS] = R, k, 3.0
    p[step.P_NPOST], p[step.P_APMAX] = 1.6, 6.0
    p[step.P_DX], p[step.P_DY], p[step.P_KPRE] = 0.1, -0.05, 0.01
    p[step.P_G1], p[step.P_G2] = p1, 2.0
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
    pg, cg, ng = (v.clone().requires_grad_() for v in (p, q, n_pre))
    sg = [v.clone().requires_grad_() for v in st]
    out = step.step_plain(code, refl, pg, ng, tuple(sg), absorbs=full,
                          extras=extras, c=cg, lay=slots)
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
        tilted=tilted, c=q, lay=slots)
    base = step.FULL_GRAD_COLS if full else step.GRAD_COLS
    pairs, coef = step.split_cols(code, cols, base, q.shape[0])
    assert [col for col, _ in pairs] == list(base) + [step.P_G1, step.P_G2]
    dp = torch.stack([v.sum() for _, v in pairs])
    dc = torch.stack([v.sum() for v in coef])

    def close(a, b, what):
        assert torch.equal(torch.isnan(a), torch.isnan(b)), what
        torch.testing.assert_close(a, b, rtol=1e-10,
                                   atol=1e-12 * float(b.abs().max()),
                                   msg=what)

    close(dp, auto[0][[col for col, _ in pairs]], "param columns")
    close(dc, auto[1], "coefficients")
    close(g_npre.sum(), auto[2], "n_pre")
    for k_, (a, b) in enumerate(zip(g_in, auto[3:])):
        close(a, b, f"state {k_}")
    assert float(dp[-1]) == 0 and float(dp[-2].abs()) > 0  # p2, p1
    assert float(dc.abs().min()) > 0


# ---------------------------------------------------------------------------
# The singlets against the JAX package's XLA path
# ---------------------------------------------------------------------------

SYSTEMS = {fam: (fam, {}) for fam in AUX}
SYSTEMS["zernike_tilted"] = ("zernike", {"tilted": True})


@functools.lru_cache(maxsize=None)
def jax_ref(name):
    """A launch bundle of system ``name``, and the values and gradients
    (every stack leaf) of the generic, field and merit entries through
    JAX's XLA path, the tilt gate open; once per system and worker."""
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

    vals, pull = jax.vjp(merits, jsys.stack)
    grads = [pull(jnp.eye(2)[j])[0] for j in range(2)]
    final, _ = jtrace.trace(jsys, rays, record=False)
    mp.undo()
    return dict(
        rays=rays, final=final, values=np.asarray(vals),
        grads=[{k: np.asarray(getattr(g, k)) for k in STACK_FIELDS}
               for g in grads])


@pytest.mark.parametrize("name", list(SYSTEMS))
def test_aux_paths_match_jax_xla(name):
    """trace (the plain engine), trace_fast, trace_fast_field,
    spot_rms_fast_field and rms_spot_size of an aux-bearing singlet: values
    and the gradient of every stack leaf against JAX's XLA path."""
    fam, kw = SYSTEMS[name]
    ref = jax_ref(name)
    tsys = ff.freeform_singlet(fam, TOptic, **kw).system
    assert ftr.fast_supported(tsys, True) and ft.fused_supported(tsys)
    spec = ftr.fast_spec(tsys, field=True)
    assert launch.build_of(spec[0], spec[3], spec[-2]) == launch.AUX
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
        assert float(got["coeffs"][1].abs().max()) > 0
        assert float(got["geo_p1"][1].abs()) > 0
    s2, leaves = with_leaves(tsys.replace(
        cfg=dataclasses.replace(tsys.cfg, has_tilts=True)))
    v = rms_spot_size(s2, *H, Px, Py, WL)
    (v**2).backward()
    assert float(v.detach()) ** 2 == pytest.approx(ref["values"][1],
                                                   rel=1e-9)
    assert_grads({k: l.grad for k, l in leaves.items()}, ref["grads"][1])


def test_aux_poly_matches_jax():
    """trace_fast_poly of the Q2d singlet, wavelengths cycling by ray: JAX's
    kernel (interpret mode) and the gradient of JAX's XLA path."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    tsys = ff.freeform_singlet("forbes_q2d", TOptic).system
    jsys = ff.freeform_singlet("forbes_q2d", JOptic).system
    jsys = jsys.replace(cfg=dataclasses.replace(jsys.cfg, has_tilts=True))
    w = jnp.asarray(np.array([0.48, 0.55, 0.65])[np.arange(N_RAYS) % 3])
    jr = jax_ref("forbes_q2d")["rays"].replace(w=w)
    assert ftr.poly_spec(tsys) is not None
    assert_rays(ftr.trace_fast_poly(tsys, port_rays(jr)),
                jpt.trace_fast_poly(jsys, jr), rtol=1e-10)

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


def test_aux_pol_matches_jax():
    """K8/K9 on the Fresnel-coated Zernike singlet in H: the plain version
    of K8 against JAX's kernel (interpret mode), and the polarized merit's
    value and gradient through trace_fast_pol_intensity against JAX's XLA
    path."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    tsys = ff.coated_freeform("zernike", "H", TOptic).system
    jsys = ff.coated_freeform("zernike", "H", JOptic).system
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


@pytest.mark.parametrize("fam", ["zernike", "forbes_qbfs"])
def test_plain_kernels_match_jax_kernels(fam):
    """The plain versions of K5a (trace_fast) and K1 (trace_fast_field) and
    K2 (spot_rms_fast_field) against the JAX package's kernels in
    interpret mode."""
    tsys = ff.freeform_singlet(fam, TOptic).system
    jsys = ff.freeform_singlet(fam, JOptic).system
    assert jpt.pallas_supported(jsys)
    Px, Py = pupil(N_RAYS, 6)
    if fam == "zernike":
        jr = jraygen.generate_rays(jsys, *H, jnp.asarray(Px),
                                   jnp.asarray(Py), WL)
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


def test_vertex_ray_matches_jax(monkeypatch):
    """The on-axis field's chief ray meets the Zernike surface at exactly
    r = 0, where JAX's guarded sag has no Zernike slope; a ray at r ~ 1e-9
    has the limit's. trace_fast's values and gradient against JAX's XLA
    path, over those two rays and a third."""
    monkeypatch.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    tsys = ff.freeform_singlet("zernike", TOptic).system
    jsys = ff.freeform_singlet("zernike", JOptic).system
    jsys = jsys.replace(cfg=dataclasses.replace(jsys.cfg, has_tilts=True))
    Px, Py = np.array([0.0, 2e-10, 0.5]), np.array([0.0, 0.0, -0.3])
    jr = jraygen.generate_rays(jsys, 0.0, 0.0, jnp.asarray(Px),
                               jnp.asarray(Py), WL)
    assert float(jr.x[0]) == 0.0 and float(jr.y[0]) == 0.0

    def merit(stack):
        f, _ = jtrace.trace(jsys.replace(stack=stack), jr, record=False)
        return jnp.sum(f.x + 2 * f.y + f.L + 3 * f.M)

    val, g = jax.value_and_grad(merit)(jsys.stack)
    s2, leaves = with_leaves(tsys)
    f = ftr.trace_fast(s2, port_rays(jr), WL)
    v = (f.x + 2 * f.y + f.L + 3 * f.M).sum()
    v.backward()
    assert float(f.x[0].detach()) == 0.0 and float(f.L[0].detach()) == 0.0
    assert float(v.detach()) == pytest.approx(float(val), rel=1e-9,
                                              abs=1e-12)
    assert_grads({k: l.grad for k, l in leaves.items()},
                 {k: np.asarray(getattr(g, k)) for k in STACK_FIELDS})


# ---------------------------------------------------------------------------
# Builder, system_from_numpy, kernel checks
# ---------------------------------------------------------------------------


def test_optic_builder_round_trip():
    """surfaces.add builds the three types (and the three Zernike schemes)
    with JAX's keyword arguments into the same stack and extras,
    system_from_numpy carries them, and NURBS and grid sag still raise
    naming ROADMAP Queue 2."""
    cases = [(fam, {}) for fam in AUX] + [
        ("zernike", {"zernike_type": s}) for s in ("standard", "noll")]
    for fam, kw in cases:
        tsys = ff.freeform_singlet(fam, TOptic, **kw).system
        jsys = ff.freeform_singlet(fam, JOptic, **kw).system
        assert tsys.cfg.geom_codes == tuple(jsys.cfg.geom_codes)
        assert tsys.cfg.geom_aux == tuple(jsys.cfg.geom_aux)
        for k in ("radius", "conic", "geo_p1", "geo_p2", "coeffs"):
            np.testing.assert_array_equal(
                np_of(getattr(tsys.stack, k)),
                np.asarray(getattr(jsys.stack, k)), err_msg=f"{fam} {k}")
        arrays = {k: np.asarray(getattr(jsys.stack, k)) for k in STACK_FIELDS}
        arrays.update({k: np_of(getattr(tsys, k)) for k in
                       ("aperture_value", "field_x", "field_y", "vig_x",
                        "vig_y", "wavelengths")})
        cfg = {f.name: getattr(jsys.cfg, f.name)
               for f in dataclasses.fields(jsys.cfg)
               if f.name in {g.name for g in dataclasses.fields(tsys.cfg)}}
        cfg["coatings"] = tsys.cfg.coatings
        cfg["apertures"] = tsys.cfg.apertures
        back = system_from_numpy(arrays, cfg)
        assert back.cfg.geom_aux == tsys.cfg.geom_aux
        assert hash(back.cfg) == hash(tsys.cfg)
        torch.testing.assert_close(back.stack.coeffs, tsys.stack.coeffs,
                                   rtol=0, atol=0)
    for aux in (("nurbs", 3), ["fringe"], ("qbfs", 5)):
        # NURBS extras, a list, and Qbfs extras on a Zernike surface
        bad = dict(cfg, geom_aux=(None, aux, None, None))
        with pytest.raises(NotImplementedError, match="geom_aux"):
            system_from_numpy(arrays, bad)
    o = TOptic()
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    for kind, kw in (("nurbs", {}), ("grid_sag", {})):
        with pytest.raises(NotImplementedError, match="Queue 2"):
            o.surfaces.add(index=1, surface_type=kind, **kw)


def test_kernel_checks_take_the_aux_families():
    """Coverage and the aux builds take the three codes; the laid-out
    table is the padded width, or a wider Q2d layout's, up to NC_MAX; an
    aux-bearing spec needs its layout table."""
    tsys = ff.freeform_singlet("zernike", coefficients=ff.ZC36).system
    spec = ftr.fast_spec(tsys)
    assert launch.covered(tsys.cfg) and spec is not None
    assert launch.build_of(spec[0], spec[3], spec[-2]) == launch.AUX
    assert launch.block_width(36, launch.AUX) == 38
    deep = (tg.STANDARD,) * launch.STOCK_SURF + (tg.FORBES_Q2D,)
    assert launch.build_of(deep, (False,) * len(deep)) == launch.DEEP_AUX
    # an aux-bearing surface beside another Cartesian one: the aux build
    assert launch.build_of((0, tg.POLYNOMIAL_XY, tg.ZERNIKE_SAG, 0),
                           (False,) * 4) == launch.AUX
    coeffs, lay = launch.kernel_tables(tsys, torch.float64)
    assert coeffs.shape == (4, 36) and lay.shape == (4, 36, tg.LAY_COLS)
    assert not lay[0].any() and lay[1].any()
    params = ft.build_param_table(tsys, WL)
    launch.check_cuda_inputs(params, spec, coeffs=coeffs, lay=lay)
    with pytest.raises(ValueError, match="layout table"):
        launch.check_cuda_inputs(params, spec, coeffs=coeffs)
    # the plain versions too: each aux-bearing row reads its slots
    assert launch.lay_row(lay, tg.ZERNIKE_SAG, 1) == tg.aux_layout(
        tg.ZERNIKE_SAG, ("fringe",), 36)[0]
    assert launch.lay_row(None, tg.STANDARD, 2) is None
    with pytest.raises(ValueError, match="layout table"):
        launch.lay_row(None, tg.ZERNIKE_SAG, 1)
    # a Q2d layout of 6 radial orders in each of 7 azimuthal blocks
    wide = {("a", m, n): 1e-6 for m in range(4) for n in range(6)}
    wide.update({("b", m, n): 1e-6 for m in range(1, 4) for n in range(6)})
    o = ff.freeform_singlet("forbes_q2d", freeform_coeffs=wide)
    assert o.system.stack.coeffs.shape[1] == 42
    with pytest.raises(NotImplementedError, match="NC_MAX = 36"):
        launch.kernel_tables(o.system, torch.float64)
    # a dense Q2d layout wider than its coefficients
    o = ff.freeform_singlet("forbes_q2d",
                            freeform_coeffs={("a", 0, 0): 1e-5,
                                             ("a", 0, 5): 1e-6})
    coeffs, lay = launch.kernel_tables(o.system, torch.float64)
    assert o.system.stack.coeffs.shape[1] == 2 and coeffs.shape[1] == 6


def test_kernel_tables_share_one_buffer_and_builds_are_flag_bits():
    """kernel_tables lays the coefficient and layout tables back to back in
    one buffer, which the kernels read without a copy; the layout table is
    cached per structure. Each build is the OR of the flag bits of what it
    compiles in, and build_of takes the least one that covers a spec."""
    tsys = ff.freeform_singlet("forbes_q2d").system
    coeffs, lay = launch.kernel_tables(tsys, torch.float64)
    assert launch.device_table(coeffs, lay) is coeffs
    flat = torch.cat([coeffs.reshape(-1), lay.reshape(-1)])
    assert torch.equal(launch.device_table(coeffs.clone(), lay.clone()), flat)
    hits = launch._layout_table.cache_info().hits
    coeffs2, lay2 = launch.kernel_tables(tsys, torch.float64)
    assert launch._layout_table.cache_info().hits == hits + 1
    assert torch.equal(coeffs2, coeffs) and torch.equal(lay2, lay)
    assert launch.kernel_tables(ff.freeform_singlet("polynomial").system,
                                torch.float64)[1] is None
    bits = {launch.STOCK: 0, launch.TILT: launch.BIT_TILT,
            launch.SAG: launch.BIT_TILT | launch.BIT_SAG}
    bits[launch.FREE] = bits[launch.SAG] | launch.BIT_CART
    bits[launch.AUX] = bits[launch.FREE] | launch.BIT_AUX
    bits.update({launch.DEEP: bits[launch.SAG] | launch.BIT_DEEP,
                 launch.DEEP_FREE: bits[launch.FREE] | launch.BIT_DEEP,
                 launch.DEEP_AUX: bits[launch.AUX] | launch.BIT_DEEP,
                 launch.GRAT: launch.BIT_TILT | launch.BIT_GRAT})
    assert all(b == v for b, v in bits.items())
    assert set(bits) == set(launch.BUILD_SUFFIX)
    for b in bits:
        # a grating's block in the grating build: P_G1 and P_G2
        assert launch.block_width(9, b) == (
            2 if b & launch.BIT_GRAT else 11 if b & launch.BIT_CART else 9)
    P, S, E = tg.PLANE, tg.STANDARD, tg.EVEN_ASPHERE
    deep = launch.STOCK_SURF + 1
    for codes, tilted, inner, build in (
            ((P, S, P), (False, True, False), (), launch.TILT),
            ((P, S, P), (False,) * 3, (False, True, False), launch.SAG),
            ((P, E, tg.TOROIDAL, P), (False,) * 4, (), launch.FREE),
            ((P, S) * (deep // 2 + 1), (False,) * (deep + 1), (),
             launch.DEEP),
            ((P, tg.ZERNIKE_SAG) + (S,) * deep, (False,) * (deep + 2), (),
             launch.DEEP_AUX)):
        assert launch.build_of(codes, tilted, inner) == build
