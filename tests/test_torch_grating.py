"""optiland_torch's grating diffraction (kernel K6c) through the plain
engine, the kernels' plain versions and the entry points, against the JAX
package and the original Optiland, on the CPU in float64.

  * the three golden grating lenses (``samples/grating.py``, the JAX
    package's ``tests/test_adv_geometries.py``) through ``Optic.trace``
    against ``tests/goldens/adv_geom.npz`` at that file's rtol 1e-7 / atol
    1e-9;
  * the hand adjoint of ``step_plain(grating=True)`` against ``jax.vjp``
    of the JAX package's in-kernel step ``_step_tile`` (plane and conic
    substrates, transmissive and reflective, tilted and untilted, the
    merit and full forms, rays on both sides of the surface so that the
    normal's sign flips), on an evanescent order, and on a ray at the rim
    of a sphere where both clamps bind; and against ``jax.vjp`` of its
    XLA step; to rtol 1e-10 with atol 1e-12 x the largest entry (sums of
    60 terms in another order);
  * ``trace``, ``rms_spot_size``, ``trace_fast``, ``trace_fast_field`` and
    ``spot_rms_fast_field`` (explicit pupil samples) of each grating system
    against the JAX package: values to rtol 1e-9, the gradient of every
    stack leaf (the grating's geo_p1 and geo_p2, radius and conic among
    them) to rtol 1e-9 of the largest entry, against JAX's XLA path with
    the tilt gate open (``tests/test_pallas_trace.py`` holds JAX's
    interpret-mode kernel gradient to that path at rtol 1e-9); the plain
    versions of K5a, K1 and K2 against JAX's kernels in interpret mode;
  * the polychromatic grating trace (a wavelength per ray) and the
    polarized, coated one through the plain engine against JAX's XLA path,
    values and gradients;
  * the ``Optic`` builder, ``system_from_numpy``'s round trip of the
    grating extras and interactions, the launch checks (the grat build and
    its refusals), and the thin lens and phase interactions, which still
    raise.
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
from optiland_torch.ops import kernels as tk
from optiland_torch.ops import launch
from optiland_torch.ops import step
from optiland_torch.optic import Optic as TOptic
from optiland_torch.polarization import create_polarization as t_state
from optiland_torch.polarization import polarized_intensity as t_ipol
from optiland_torch.samples import grating as gs
from optiland_tpu.core import raygen as jraygen
from optiland_tpu.core import trace as jtrace
from optiland_tpu.core.system import positions as jpositions
from optiland_tpu.ops import pallas_trace as jpt
from optiland_tpu.optic import Optic as JOptic
from optiland_tpu.polarization import create_polarization as j_state
from optiland_tpu.polarization import polarized_intensity as j_ipol
from tests.test_torch_freeform import (
    assert_grads, assert_rays, f64, merit_of, np_of, port_rays, pupil,
    with_leaves,
)

WL = gs.WAVELENGTH
H = (0.3, 0.7)
N_RAYS = 60
GOLDEN_COLS = ("x", "y", "L", "M", "N", "i")


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


def systems(name):
    """(port, JAX) systems of grating sample ``name``."""
    return (gs.BUILDERS[name](TOptic).system, gs.BUILDERS[name](JOptic).system)


# ---------------------------------------------------------------------------
# The golden traces of the original Optiland
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["plane_grating", "curved_grating",
                                  "refl_grating"])
def test_golden_traces(name):
    g = np.load("tests/goldens/adv_geom.npz")
    rays = gs.BUILDERS[name]().trace(Hy=1.0, num_rays=5)
    for c in GOLDEN_COLS:
        np.testing.assert_allclose(np_of(getattr(rays, c)), g[f"{name}_{c}"],
                                   rtol=1e-7, atol=1e-9, err_msg=c)


# ---------------------------------------------------------------------------
# The step and its hand adjoint
# ---------------------------------------------------------------------------


def _params(code, tilted, R=40.0, period=10.0, alpha=0.3, mlam=0.55):
    p = np.zeros(step.NUM_P)
    p[step.P_RADIUS] = R if code == 1 else np.inf
    p[step.P_CONIC], p[step.P_POS] = -0.5, 3.0
    p[step.P_NPOST], p[step.P_APMAX] = 1.6, 6.0
    p[step.P_DX], p[step.P_DY], p[step.P_KPRE] = 0.1, -0.05, 0.01
    p[step.P_G1], p[step.P_G2], p[step.P_MLAM] = period, alpha, mlam
    if tilted:
        p[step.P_RX], p[step.P_RY], p[step.P_RZ] = 0.01, -0.02, 0.015
    return p


def _rays(n, seed, spread=0.05):
    """n rays, half from before the surface going +z, half from behind it
    going -z (the normal's sign flips between them)."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-5, 5, n), rng.uniform(-5, 5, n)
    L, M = rng.normal(0, spread, n), rng.normal(0, spread, n)
    back = np.arange(n) % 2 == 1
    N = np.sqrt(1 - L**2 - M**2) * np.where(back, -1.0, 1.0)
    z = np.where(back, 8.0, -2.0)
    i, opd = rng.uniform(0.5, 1, n), rng.uniform(0, 1, n)
    return [x, y, z, L, M, N, i, opd]


def _jax_step(code, refl, p, st, n_pre, full, g, g_np):
    """jax.vjp of the JAX package's in-kernel step (its rotation code on,
    as under jax.grad): (param cotangents, state cotangents, n_pre's); the
    index after the surface, uniform, is taken per ray."""

    def f(P, xs, npre):
        state = tuple(xs) + (npre, None)
        out = jpt._step_tile(1, code, refl, True, None, lambda s, c: P[c],
                             None, 0, state, 10, has_absorption=full,
                             grating=True)
        return out[:8], jnp.broadcast_to(out[8], xs[0].shape)

    args = (jnp.asarray(p), [jnp.asarray(v) for v in st], jnp.asarray(n_pre))
    _, pull = jax.vjp(f, *args)
    gp, gx, gn = pull((tuple(jnp.asarray(v) for v in g), jnp.asarray(g_np)))
    return np.asarray(gp), [np.asarray(v) for v in gx], float(gn)


def _port_step(code, refl, p, st, n_pre, full, g, g_np, tilted):
    """step_adjoint_plain: ({column: sum}, state cotangents, n_pre's), and
    the step's forward outputs."""
    ts = tuple(f64(v) for v in (st if full else st[:6]))
    tp = f64(p)
    out, n_next = step.step_plain(code, refl, tp, f64(n_pre), ts,
                                  absorbs=full, grating=True)
    gt = tuple(f64(v) for v in g[:6]) + (f64(g_np),) + (
        tuple(f64(v) for v in g[6:]) if full else ())
    g_in, g_npre, cols = step.step_adjoint_plain(
        code, refl, tp, f64(n_pre), ts, gt, absorbs=full, tilted=tilted,
        grating=True)
    base = step.FULL_GRAD_COLS if full else step.GRAD_COLS
    pairs, coef = step.split_cols(code, cols, base, 1, grating=True)
    assert [c for c, _ in pairs] == list(base) + [step.P_G1, step.P_G2]
    assert coef == ()
    return ({c: float(v.sum()) for c, v in pairs},
            [np_of(v) for v in g_in], float(g_npre.sum()), out, n_next)


def _assert_step(code, refl, p, st, full, tilted, seed, rtol=1e-10):
    """The port's step and hand adjoint against the JAX package's
    in-kernel step and its vjp (cotangents to ``rtol``, the grating's P_G1
    and P_G2 always to 1e-10); returns the port's forward outputs."""
    rng = np.random.default_rng(seed)
    n = st[0].shape[0]
    g = [rng.normal(size=n) for _ in range(8)]
    if not full:
        g[6] = g[7] = np.zeros(n)
    n_pre, g_np = 1.0, rng.normal(size=n)
    cols, g_in, g_npre, out, n_next = _port_step(code, refl, p, st, n_pre,
                                                 full, g, g_np, tilted)
    jp, jx, jn = _jax_step(code, refl, p, st, n_pre, full, g, g_np)
    ref = jpt._step_tile(1, code, refl, True, None,
                         lambda s, c: jnp.asarray(p)[c], None, 0,
                         tuple(jnp.asarray(v) for v in st) + (
                             jnp.asarray(n_pre), None), 10,
                         has_absorption=full, grating=True)
    for k, o in enumerate(out):
        np.testing.assert_allclose(np_of(o), np.asarray(ref[k]), rtol=1e-12,
                                   atol=1e-12, err_msg=f"output {k}")
    assert float(n_next) == float(ref[8])
    # the param columns (P_MLAM gets none: JAX builds it from a float)
    scale = max(abs(jp[c]) for c in cols)
    for c, v in cols.items():
        tol = 1e-10 if c in (step.P_G1, step.P_G2) else rtol
        np.testing.assert_allclose(v, jp[c], rtol=tol, atol=1e-12 * scale,
                                   err_msg=f"column {c}")
    for k, (a, b) in enumerate(zip(g_in, jx)):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=1e-12 * np.abs(b).max(),
                                   err_msg=f"state {k}")
    np.testing.assert_allclose(g_npre, jn, rtol=rtol)
    assert cols[step.P_G1] != 0 and cols[step.P_G2] != 0
    if refl:
        # a reflective grating keeps n_pre: P_NPOST is not read
        assert cols[step.P_NPOST] == 0 and float(n_next) == 1.0
    return out


@pytest.mark.parametrize("form", ["merit", "full"])
@pytest.mark.parametrize("tilted", [False, True])
@pytest.mark.parametrize("refl", [False, True])
@pytest.mark.parametrize("code", [0, 1], ids=["plane", "conic"])
def test_step_adjoint_matches_jax_step_tile(code, refl, tilted, form):
    _assert_step(code, refl, _params(code, tilted), _rays(60, 11), form ==
                 "full", tilted, 12)


@pytest.mark.parametrize("code", [0, 1], ids=["plane", "conic"])
def test_step_evanescent_order(code):
    """A fine grating (period 1 um) sends part of the bundle evanescent:
    those rays get zero intensity, a zero root, and no NaN anywhere in
    the adjoint, as in JAX's kernel."""
    p = _params(code, False, period=1.0)
    p[step.P_APMAX] = np.inf  # no clip: a zero intensity is evanescent
    out = _assert_step(code, False, p, _rays(60, 5, spread=0.25), True,
                       False, 6)
    assert 5 <= int((out[6] == 0).sum()) < 60


def test_step_clamps_bind_at_the_rim():
    """A ray crossing a sphere (R 4) at its rim, where the conic's root
    1 - (1 + k) r^2 / R^2 falls below 1e-14 and the groove vector's
    transverse part below 1e-6: both clamps bind and pass no derivative,
    as jax.vjp of JAX's kernel step gives, beside ordinary rays. At the rim
    the surface normal divides by sqrt(5e-15) ~ 7e-8, so the rounding of
    its radius, conic and position derivatives is amplified ~1e7: those
    cotangents are held to rtol 1e-8, P_G1 and P_G2 to 1e-10."""
    R, qn = 4.0, 5e-15
    p = _params(1, False, R=R, alpha=0.0)
    p[step.P_CONIC], p[step.P_POS], p[step.P_DX], p[step.P_DY] = 0, 0, 0, 0
    p[step.P_APMAX] = np.inf
    st = _rays(8, 3)
    st[0], st[1] = 0.5 * st[0], 0.5 * st[1]  # inside the sphere's rim
    st[0][0], st[1][0], st[2][0] = 0.0, 10.0, R * (1 - np.sqrt(qn))
    st[3][0], st[4][0], st[5][0] = 0.0, -1.0, 0.0
    out = _assert_step(1, False, p, st, True, False, 4, rtol=1e-8)
    x1, y1 = out[0][:1], out[1][:1]
    assert 1 - float(y1[0]) ** 2 / R**2 < 1e-14
    # the groove vector at the rim ray lies along z
    nrm = tg.surface_normal_static(1, f64(R), f64(0.0), None, x1, y1)
    f = tk.grating_vector(1, f64(R), f64(0.0), f64(0.0), x1, y1, *nrm)
    assert float(f[0][0] ** 2 + f[1][0] ** 2) < 1e-12


@pytest.mark.parametrize("name,s", [("curved_grating", 1),
                                    ("refl_grating", 1),
                                    ("tilted_grating", 3)])
def test_step_adjoint_matches_jax_xla_step(name, s):
    """The port's step at the grating surface of a system against jax.vjp
    of JAX's XLA step (``core/trace.py``), through the system's own
    parameters: every state cotangent and n_pre's, and the radius, conic,
    geo_p1, geo_p2, decentre, tilt and position cotangents."""
    tsys, jsys = systems(name)
    jsys = jsys.replace(cfg=dataclasses.replace(jsys.cfg, has_tilts=True))
    n = 40
    st = _rays(n, 21)
    pos = jpositions(jsys.stack)[s]
    st[2] = np.where(st[5] > 0, -2.0, 8.0) + float(pos)
    rng = np.random.default_rng(22)
    g = [rng.normal(size=n) for _ in range(8)]
    g_np = rng.normal(size=n)
    n_pre = 1.0
    leaves = ("radius", "conic", "geo_p1", "geo_p2", "dx", "dy", "dz", "rx",
              "ry", "rz")

    def f(vals, xs, npre):
        stack = jsys.stack.replace(**{
            k: getattr(jsys.stack, k).at[s].set(v)
            for k, v in zip(leaves, vals)})
        state = tuple(xs[:6]) + (xs[6], xs[7], jnp.full(n, WL), npre, None,
                                 None)
        out = jtrace._surface_step(stack, jsys.cfg, s, pos, state)
        return out[:8], jnp.broadcast_to(out[9], (n,))

    vals = [getattr(jsys.stack, k)[s] for k in leaves]
    _, pull = jax.vjp(f, vals, [jnp.asarray(v) for v in st],
                      jnp.asarray(n_pre))
    jv, jx, jn = pull((tuple(jnp.asarray(v) for v in g), jnp.asarray(g_np)))
    p = np_of(ft.build_param_table(tsys, WL)[s])
    tilted = bool(np.any(p[[step.P_RX, step.P_RY, step.P_RZ]] != 0))
    cols, g_in, g_npre, _, _ = _port_step(
        tsys.cfg.geom_codes[s], tsys.cfg.reflective[s], p, st, n_pre, True,
        g, g_np, tilted)
    col_of = {"radius": step.P_RADIUS, "conic": step.P_CONIC,
              "geo_p1": step.P_G1, "geo_p2": step.P_G2, "dx": step.P_DX,
              "dy": step.P_DY, "dz": step.P_POS, "rx": step.P_RX,
              "ry": step.P_RY, "rz": step.P_RZ}
    scale = max(abs(float(v)) for v in jv)
    for k, v in zip(leaves, jv):
        if k in ("radius", "conic") and tsys.cfg.geom_codes[s] == 0:
            continue  # a plane reads neither
        np.testing.assert_allclose(cols[col_of[k]], float(v), rtol=1e-10,
                                   atol=1e-12 * scale, err_msg=k)
    for k, (a, b) in enumerate(zip(g_in, jx)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10,
                                   atol=1e-12 * float(np.abs(b).max()),
                                   err_msg=f"state {k}")
    np.testing.assert_allclose(g_npre, float(jn), rtol=1e-10)


# ---------------------------------------------------------------------------
# The entry points against the JAX package
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def jax_ref(name):
    """A launch bundle of system ``name`` and the values and gradients
    (every stack leaf) of the generic merit and the spot through JAX's XLA
    path, the tilt gate open; once per system and worker."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    Px, Py = (jnp.asarray(a) for a in pupil(N_RAYS, 6))
    jsys = gs.BUILDERS[name](JOptic).system
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


@pytest.mark.parametrize("name", gs.NAMES)
def test_grating_paths_match_jax(name):
    """trace (the plain engine), trace_fast, trace_fast_field,
    spot_rms_fast_field and rms_spot_size of a grating system: values and
    the gradient of every stack leaf against JAX's XLA path, the
    grating's period and groove angle (and, on the conic, its radius and
    conic) nonzero among them."""
    ref = jax_ref(name)
    tsys = gs.BUILDERS[name]().system
    assert ftr.fast_supported(tsys, True) and ft.fused_supported(tsys)
    spec = ftr.fast_spec(tsys, field=True)
    g = spec[4].index(True)
    assert ftr._build(spec) == ft._build(ft._spec_of(tsys)) == launch.GRAT
    rays = port_rays(ref["rays"])
    final, _ = ttrace.trace(tsys, rays, record=False)
    assert_rays(final, ref["final"], rtol=1e-9)
    assert_rays(ftr.trace_fast(tsys, rays, WL), ref["final"], rtol=1e-9)
    Px, Py = (torch.tensor(a) for a in pupil(N_RAYS, 6))
    for entry in ("trace_fast", "trace_fast_field", "spot_rms_fast_field"):
        s2, leaves = with_leaves(tsys)
        if entry == "spot_rms_fast_field":
            val, j = ft.spot_rms_fast_field(s2, *H, WL, Px=Px, Py=Py), 1
        else:
            f = (ftr.trace_fast(s2, traygen.generate_rays(s2, *H, Px, Py, WL),
                                WL) if entry == "trace_fast"
                 else ftr.trace_fast_field(s2, *H, Px, Py, WL))
            val, j = merit_of(torch, f), 0
        val.backward()
        assert float(val.detach()) == pytest.approx(ref["values"][j],
                                                    rel=1e-9)
        got = {k: v.grad for k, v in leaves.items()}
        assert_grads(got, ref["grads"][j], rtol=1e-9)
        for k in ("geo_p1", "geo_p2") + (
                ("radius", "conic") if name == "curved_grating" else ()):
            assert float(got[k][g].abs()) > 0, (entry, k)
    s2, leaves = with_leaves(tsys.replace(
        cfg=dataclasses.replace(tsys.cfg, has_tilts=True)))
    v = rms_spot_size(s2, *H, Px, Py, WL)
    (v**2).backward()
    assert float(v.detach()) ** 2 == pytest.approx(ref["values"][1],
                                                   rel=1e-9)
    assert_grads({k: l.grad for k, l in leaves.items()}, ref["grads"][1],
                 rtol=1e-9)


def test_plain_kernels_match_jax_kernels():
    """The plain versions of K5a (trace_fast, plane grating), K1
    (trace_fast_field, curved grating) and K2 (spot_rms_fast_field,
    reflective grating) against the JAX package's kernels in interpret
    mode."""
    Px, Py = pupil(N_RAYS, 6)
    tsys, jsys = systems("plane_grating")
    assert jpt.pallas_supported(jsys)
    jr = jraygen.generate_rays(jsys, *H, jnp.asarray(Px), jnp.asarray(Py), WL)
    assert_rays(ftr.trace_fast(tsys, port_rays(jr), WL),
                jpt.trace_fast(jsys, jr, WL), rtol=1e-10)
    tsys, jsys = systems("curved_grating")
    assert_rays(ftr.trace_fast_field(tsys, *H, f64(Px), f64(Py), WL),
                jpt.trace_fast_field(jsys, *H, jnp.asarray(Px),
                                     jnp.asarray(Py), WL), rtol=1e-10)
    tsys, jsys = systems("refl_grating")
    ref = float(jpt.spot_rms_fast_field(jsys, *H, WL, Px=jnp.asarray(Px),
                                        Py=jnp.asarray(Py)))
    assert float(ft.spot_rms_fast_field(tsys, *H, WL, Px=f64(Px),
                                        Py=f64(Py))) == pytest.approx(
        ref, rel=1e-10)


def test_poly_grating_matches_jax_xla(monkeypatch):
    """A wavelength per ray through the plane grating: the plain engine
    (the JAX package's poly kernels take no grating, so neither do the
    port's) against JAX's XLA path, value and every leaf's gradient."""
    monkeypatch.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    tsys, jsys = systems("plane_grating")
    jsys = jsys.replace(cfg=dataclasses.replace(jsys.cfg, has_tilts=True))
    w = jnp.asarray(np.array([0.48, 0.55, 0.65])[np.arange(N_RAYS) % 3])
    jr = jax_ref("plane_grating")["rays"].replace(w=w)
    assert ftr.poly_spec(tsys) is None
    with pytest.raises(NotImplementedError, match="no grating"):
        ftr.trace_fast_poly(tsys, port_rays(jr))

    def merit(stack):
        f, _ = jtrace.trace(jsys.replace(stack=stack), jr, record=False)
        return jnp.mean(f.x**2 + f.y**2) + 1e-3 * jnp.mean(f.opd)

    val, g = jax.value_and_grad(merit)(jsys.stack)
    s2, leaves = with_leaves(tsys.replace(
        cfg=dataclasses.replace(tsys.cfg, has_tilts=True)))
    f, _ = ttrace.trace(s2, port_rays(jr), record=False)
    v = torch.mean(f.x**2 + f.y**2) + 1e-3 * torch.mean(f.opd)
    v.backward()
    assert float(v.detach()) == pytest.approx(float(val), rel=1e-9)
    assert_grads({k: l.grad for k, l in leaves.items()},
                 {k: np.asarray(getattr(g, k)) for k in STACK_FIELDS},
                 rtol=1e-9)


def test_polarized_coated_grating_matches_jax_xla(monkeypatch):
    """The Fresnel-coated plane grating in H through the plain engine
    (the polarized kernels take no grating, as JAX's): the polarization
    matrices and the polarized merit's value and gradient against JAX's
    XLA path."""
    monkeypatch.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    tsys = gs.coated_grating("H", TOptic).system
    jsys = gs.coated_grating("H", JOptic).system
    jsys = jsys.replace(cfg=dataclasses.replace(jsys.cfg, has_tilts=True))
    assert not launch.covered(tsys.cfg, coated=True)
    jr = jax_ref("plane_grating")["rays"]
    ref, hist = jtrace.trace(jsys, jr, record=False)
    got, thist = ttrace.trace(tsys, port_rays(jr), record=False)
    assert_rays(got, ref, rtol=1e-10)
    np.testing.assert_allclose(np_of(thist["p"]), np.asarray(hist["p"]),
                               rtol=1e-10, atol=1e-12)
    state = j_state("H")

    def merit(stack):
        out, h = jtrace.trace(jsys.replace(stack=stack), jr, record=False)
        i = j_ipol(h["p"], state, jr.L, jr.M, jr.N, jr.i)
        return jnp.mean(out.x**2 + out.y**2) + 0.3 * jnp.mean(i)

    val, g = jax.value_and_grad(merit)(jsys.stack)
    s2, leaves = with_leaves(tsys.replace(
        cfg=dataclasses.replace(tsys.cfg, has_tilts=True)))
    tr = port_rays(jr)
    out, h = ttrace.trace(s2, tr, record=False)
    i = t_ipol(h["p"], t_state("H"), tr.L, tr.M, tr.N, tr.i)
    v = torch.mean(out.x**2 + out.y**2) + 0.3 * torch.mean(i)
    v.backward()
    assert float(v.detach()) == pytest.approx(float(val), rel=1e-9)
    assert_grads({k: l.grad for k, l in leaves.items()},
                 {k: np.asarray(getattr(g, k)) for k in STACK_FIELDS},
                 rtol=1e-9)


# ---------------------------------------------------------------------------
# Builder, system_from_numpy, launch checks, refusals
# ---------------------------------------------------------------------------


def test_optic_builder_and_system_from_numpy_round_trip():
    """surfaces.add builds the gratings with JAX's keyword arguments into
    the same stack, codes, extras and interactions; system_from_numpy
    carries them; extras or interactions it does not carry raise."""
    for name in gs.NAMES:
        tsys, jsys = systems(name)
        assert tsys.cfg.geom_codes == tuple(jsys.cfg.geom_codes)
        assert tsys.cfg.geom_aux == tuple(jsys.cfg.geom_aux)
        assert tsys.cfg.interactions == tuple(jsys.cfg.interactions)
        for k in ("radius", "conic", "geo_p1", "geo_p2", "rx"):
            np.testing.assert_array_equal(
                np_of(getattr(tsys.stack, k)),
                np.asarray(getattr(jsys.stack, k)), err_msg=f"{name} {k}")
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
        assert back.cfg == tsys.cfg and hash(back.cfg) == hash(tsys.cfg)
    S = len(cfg["geom_codes"])
    for field, bad in (("interactions", ("thin_lens",)),
                       ("interactions", ("phase", object())),
                       ("interactions", ("grating", 1.5)),
                       ("geom_aux", ("grating", "1"))):
        vals = [None] * S
        vals[1] = bad
        with pytest.raises(NotImplementedError, match=field):
            system_from_numpy(arrays, dict(cfg, **{field: tuple(vals)}))
    # a grating's extras on a Newton family are not carried
    codes = list(cfg["geom_codes"])
    codes[3] = 2
    with pytest.raises(NotImplementedError, match="geom_aux"):
        system_from_numpy(arrays, dict(cfg, geom_codes=tuple(codes)))


def test_launch_checks_and_refusals():
    """The grat build covers gratings beside PLANE and STANDARD surfaces up
    to STOCK_SURF; beside a Newton family, an annular clip or past
    STOCK_SURF build_of raises naming the combination; the polarized
    kernels and the polychromatic ones take no grating."""
    tsys = gs.curved_grating().system
    spec, mspec = ftr.fast_spec(tsys, field=True), ft._spec_of(tsys)
    assert spec[4] == (False, True, False, False) == mspec[3]
    assert launch.build_of(spec[0], spec[3], spec[-2], spec[4]) == launch.GRAT
    assert launch.block_width(7, launch.GRAT) == 2
    assert launch.sag_surfaces(spec[0], launch.GRAT, spec[4]) == (1,)
    assert launch.sag_columns(spec[0], 7, launch.GRAT, spec[4]) == 2
    params = ft.build_param_table(tsys, WL)
    assert float(params[1, step.P_MLAM]) == pytest.approx(-1 * WL)
    assert float(params[0, step.P_MLAM]) == 0.0
    launch.check_cuda_inputs(params, spec, coeffs=params.new_zeros(4, 1))
    P, S, E, T = 0, 1, 2, 7
    g = (False, True, False)
    for codes, inner, n, what in (
            ((P, E, P), (), 3, "EVEN_ASPHERE"),
            ((P, S, T), (), 3, "TOROIDAL"),
            ((P, S, P), (False, False, True), 3, "annular clip"),
            ((P,) * 17, (), 17, "17 surfaces")):
        grat = g + (False,) * (n - 3)
        with pytest.raises(NotImplementedError, match=what):
            launch.build_of(codes, (False,) * n, inner, grat)
    assert launch.covered(tsys.cfg) and not launch.covered(tsys.cfg,
                                                            coated=True)
    with pytest.raises(NotImplementedError, match="no grating"):
        ftr._check_poly(params, params.new_zeros(4, 1),
                        spec[:4] + ((0,) * 4,) + spec[4:],
                        (), params.new_zeros(4, 1), None)
    assert ftr.poly_spec(tsys) is None


def test_thin_lens_and_phase_still_raise():
    """The thin lens and phase interactions come in a later slice: the
    plain engine, the kernels' coverage, the param table and
    system_from_numpy refuse them; the paraxial surface type raises in the
    builder."""
    tsys = gs.plane_grating().system
    for inter in (("thin_lens",), ("phase", object())):
        vals = list(tsys.cfg.interactions)
        vals[3] = inter
        bad = tsys.replace(cfg=dataclasses.replace(
            tsys.cfg, interactions=tuple(vals)))
        rays = traygen.generate_rays(bad, *H, f64([0.1]), f64([0.2]), WL)
        with pytest.raises(NotImplementedError, match="thin lens, phase"):
            ttrace.trace(bad, rays)
        assert not launch.covered(bad.cfg) and ftr.fast_spec(bad) is None
        with pytest.raises(NotImplementedError, match="thin lenses, phase"):
            ft.build_param_table(bad, WL)
        with pytest.raises(NotImplementedError, match="later slice"):
            ftr.trace_fast(bad, rays, WL)
    o = TOptic()
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    with pytest.raises(NotImplementedError, match="paraxial"):
        o.surfaces.add(index=1, surface_type="paraxial", f=50.0)
