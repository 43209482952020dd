"""The Newton families' reverse step started from the forward's stopped
iterate (the Newton builds of merit_bwd and trace_bwd keep t_s from their
forward sweep instead of solving again), on the CPU in float64.

For EVEN_ASPHERE, ODD_ASPHERE, POLYNOMIAL_XY, CHEBYSHEV, TOROIDAL,
BICONIC, ZERNIKE_SAG, FORBES_QBFS and FORBES_Q2D, tilted and untilted, one
batch of rays through the full step (absorption, OPD and the clip):

  * ``step_adjoint_plain`` fed the t_s of ``step_plain``'s extras against
    the one that solves again: every cotangent within 1e-13 of the largest
    entry (the two take the same steps on the same inputs);
  * the same against ``jax.vjp`` of the JAX package's step
    (``pallas_trace._step_tile``, whose Newton branch differentiates one
    step at the stopped iterate): rtol 1e-10 with atol 1e-12 x the largest
    entry, the step tests' tolerance, with the same NaN set; an
    aux-bearing family's coefficient cotangents mapped back from its
    laid-out row (``geometry.aux_row`` is linear in the coefficients), and
    the untilted surface's tilt columns left out (the JAX step runs no
    rotation there, the port gives the zero-tilt generators);
  * the plain backwards (``merit_bwd_plain``, ``trace_fast_bwd_plain``) of
    the XY and Q2d singlets against the same sweeps solving again in
    reverse, within 1e-13 of the largest entry;
  * the step with its extras, as the polarized backward runs it (the stock
    and tilt builds' STANDARD step, untilted and tilted, and the even
    asphere's kept Newton step, tilted): ``step_plain``'s extras (the local
    pre- and post-interaction directions and adot) against the JAX step's
    ``want_extras`` to rtol 1e-12 with atol 1e-14, and
    ``step_adjoint_plain`` fed the extras' cotangents ``g_ext`` and the
    kept t_s against ``jax.vjp`` of the step and its extras at the step
    tests' tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch.core import geometry as tg
from optiland_torch.core import raygen as traygen
from optiland_torch.ops import fast_trace as ftr
from optiland_torch.ops import fused_trace as ft
from optiland_torch.ops import launch
from optiland_torch.ops import step
from optiland_torch.samples import freeform as ff
from optiland_tpu.ops import pallas_trace as jpt

# fewer Newton steps than the kernels' 10: the JAX reference runs op by op
# (10 steps of the Zernike sag take ~10 s), and a stopped iterate further
# from the root gives the f f'_theta / f'^2 term of the last step weight
NITERS = 4
CMAT = tuple(np.asarray(ff.CMAT).ravel())
# family -> (code, radius, conic, coefficients, p1, p2, aux); the Forbes
# norm radii small enough that some rays pass u^2 = 1
CASES = {
    "even": (tg.EVEN_ASPHERE, 25.0, -0.7, (-2.2e-3, 4.6e-5, -6.4e-7), 0.0,
             0.0, None),
    "odd": (tg.ODD_ASPHERE, 25.0, -0.7, (0.0, -2.2e-3, 3.0e-5, 4.6e-5,
                                          -6.4e-7), 0.0, 0.0, None),
    "polynomial": (tg.POLYNOMIAL_XY, 50.0, -0.5, CMAT, 1.0, 1.0, None),
    "chebyshev": (tg.CHEBYSHEV, 50.0, -0.5, CMAT, 6.0, 7.0, None),
    "toroidal": (tg.TOROIDAL, 100.0, -0.5, (1e-5, -1e-8), 50.0, -0.5, None),
    "biconic": (tg.BICONIC, 80.0, -0.2, (0.0,), 50.0, -0.8, None),
    "zernike": (tg.ZERNIKE_SAG, 50.0, -0.5, ff.ZC, 8.0, 0.0, ("fringe",)),
    "forbes_qbfs": (tg.FORBES_QBFS, 40.0, -0.8, (1e-4, -2e-5, 3e-6, 0.0,
                                                 1e-7), 4.0, 0.0,
                    ("qbfs", 5)),
    "forbes_q2d": (tg.FORBES_Q2D, 40.0, 0.3, (1e-5, 2e-6, -3e-6, 4e-6, 1e-6,
                                              2e-5, 3e-6), 4.0, 0.0,
                   ("q2d", ((0, 1), (1, 1), (2, 1), (3, 1), (4, 1), (2, 0),
                            (1, -2)))),
}
TILT_COLS = (step.P_RX, step.P_RY, step.P_RZ)
# and the STANDARD step of the stock and tilt builds (one unread
# coefficient), for the step with its extras
ALL_CASES = dict(CASES, standard=(tg.STANDARD, 25.0, -0.7, (0.0,), 0.0,
                                  0.0, None))


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


def surface(fam, tilted):
    """(code, param row, raw coefficients, the kernels' row, its slots,
    aux) of the case's surface."""
    code, R, k, C, p1, p2, aux = ALL_CASES[fam]
    p = torch.zeros(step.NUM_P, dtype=torch.float64)
    p[step.P_RADIUS], p[step.P_CONIC], p[step.P_POS] = R, k, 3.0
    p[step.P_NPOST], p[step.P_APMAX] = 1.6, 6.0
    p[step.P_DX], p[step.P_DY], p[step.P_KPRE] = 0.1, -0.05, 0.01
    p[step.P_G1], p[step.P_G2] = p1, p2
    if tilted:
        p[step.P_RX], p[step.P_RY], p[step.P_RZ] = 0.01, -0.02, 0.015
    C = torch.tensor(C, dtype=torch.float64)
    q, slots = (tg.aux_row(code, aux, C) if code in tg.AUX_CODES
                else (C, None))
    return code, p, C, q, slots, aux


def rays(n=40, seed=11):
    """One batch of full-form input states and the cotangents of the step's
    outputs (x, y, z, L, M, N, n_next, i, opd)."""
    rng = np.random.default_rng(seed)
    x, y = (torch.tensor(rng.uniform(-5, 5, n)) for _ in range(2))
    L, M = (torch.tensor(rng.normal(0, 0.05, n)) for _ in range(2))
    st = (x, y, torch.full((n,), -2.0, dtype=torch.float64), L, M,
          torch.sqrt(1 - L**2 - M**2), torch.tensor(rng.uniform(0.5, 1, n)),
          torch.tensor(rng.uniform(0, 1, n)))
    g = tuple(torch.tensor(rng.normal(size=n)) for _ in range(9))
    return st, g


def adjoint(fam, tilted, keep):
    """step_adjoint_plain's (per-ray input cotangents, n_pre's, param
    column sums {col: value}, coefficient row sums) on the case, started
    from step_plain's stopped iterate (``keep``) or solving again."""
    code, p, _, q, slots, _ = surface(fam, tilted)
    st, g = rays()
    n_pre = torch.tensor(1.0, dtype=torch.float64)
    _, _, ext = step.step_plain(code, False, p, n_pre, st, absorbs=True,
                                extras=True, c=q, lay=slots,
                                newton_iters=NITERS)
    assert ext[7] is not None
    g_in, g_npre, cols = step.step_adjoint_plain(
        code, False, p, n_pre, st, g, absorbs=True, tilted=tilted, c=q,
        lay=slots, newton_iters=NITERS, t_s=ext[7] if keep else None)
    pairs, coef = step.split_cols(code, cols, step.FULL_GRAD_COLS,
                                  q.shape[0])
    return (g_in, g_npre, {col: v.sum() for col, v in pairs},
            torch.stack([v.sum() for v in coef]))


def assert_close(a, b, rtol, atol_of_max, what):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                  err_msg=f"{what}: NaN set")
    fin = np.isfinite(b)
    scale = float(np.abs(b[fin]).max()) if fin.any() else 0.0
    np.testing.assert_allclose(a[fin], b[fin], rtol=rtol,
                               atol=atol_of_max * scale, err_msg=what)


def jax_adjoint(fam, tilted):
    """jax.vjp of the JAX package's step on the case: (per-ray cotangents of
    x, y, z, L, M, N, i, opd and n_pre, the param row's, the raw
    coefficients')."""
    code, p, C, _, _, aux = surface(fam, tilted)
    st, g = rays()
    nc = C.shape[0]

    def f(pv, cv, *state):
        out = jpt._step_tile(1, code, False, tilted, aux,
                             lambda s, col: pv[col], lambda s, ci: cv[ci],
                             nc, tuple(state) + (None,), NITERS)
        return out[:9]

    args = [jnp.asarray(p.numpy()), jnp.asarray(C.numpy())] + [
        jnp.asarray(v.numpy()) for v in st] + [jnp.ones(st[0].shape[0])]
    _, pull = jax.vjp(f, *args)
    # the outputs (x, y, z, L, M, N, i, opd, n_next); a refraction's n_next
    # is the table's P_NPOST, one scalar for every ray
    cot = [jnp.asarray(v.numpy()) for v in g[:6] + g[7:]] + [
        jnp.asarray(float(g[6].sum()))]
    gp, gc, *gs = pull(tuple(cot))
    return [np.asarray(v) for v in gs], np.asarray(gp), np.asarray(gc)


@pytest.mark.parametrize("tilted", [False, True])
@pytest.mark.parametrize("fam", list(CASES))
def test_kept_iterate_matches_resolve_and_jax_vjp(fam, tilted):
    kept = adjoint(fam, tilted, keep=True)
    again = adjoint(fam, tilted, keep=False)
    for k, (a, b) in enumerate(zip(kept[0], again[0])):
        assert_close(a, b, 0.0, 1e-13, f"state {k}")
    assert_close(kept[1], again[1], 0.0, 1e-13, "n_pre")
    assert kept[2].keys() == again[2].keys()
    assert_close(torch.stack(list(kept[2].values())),
                 torch.stack(list(again[2].values())), 0.0, 1e-13,
                 "param columns")
    assert_close(kept[3], again[3], 0.0, 1e-13, "coefficients")

    g_in, g_npre, cols, dq = kept
    ref_state, ref_p, ref_c = jax_adjoint(fam, tilted)
    for k, (a, b) in enumerate(zip(g_in, ref_state)):
        assert_close(a, b, 1e-10, 1e-12, f"state {k} against JAX")
    assert_close(g_npre, ref_state[8], 1e-10, 1e-12, "n_pre against JAX")
    keys = [c for c in cols if tilted or c not in TILT_COLS]
    assert_close(torch.stack([cols[c] for c in keys]), ref_p[keys], 1e-10,
                 1e-12, "param columns against JAX")
    code, _, C, _, _, aux = surface(fam, tilted)
    if code in tg.AUX_CODES:
        # the laid-out row's cotangents back to the coefficients
        Cg = C.clone().requires_grad_()
        dq = torch.autograd.grad(tg.aux_row(code, aux, Cg)[0], Cg, dq)[0]
    assert_close(dq, ref_c, 1e-10, 1e-12, "coefficients against JAX")


def _resolving(monkeypatch):
    """Make step_adjoint_plain solve again whatever t_s it is given."""
    adjoint_ = step.step_adjoint_plain

    def again(*a, **k):
        k["t_s"] = None
        return adjoint_(*a, **k)

    monkeypatch.setattr(ft, "step_adjoint_plain", again)
    monkeypatch.setattr(ftr, "step_adjoint_plain", again)


@pytest.mark.parametrize("fam", ["polynomial", "forbes_q2d"])
def test_plain_backwards_keep_the_iterate(fam, monkeypatch):
    system = ff.freeform_singlet(fam).system
    wl = float(system.wavelengths[system.cfg.primary_index])
    params = ft.build_param_table(system, wl)
    aim = ft.aim_vector(system, *ff.H)
    coeffs, lay = launch.kernel_tables(system, torch.float64)
    nc = coeffs.shape[1]
    rng = np.random.default_rng(3)
    r = np.sqrt(rng.uniform(size=64)) * 0.97
    th = rng.uniform(0, 2 * np.pi, size=64)
    Px, Py = torch.tensor(r * np.cos(th)), torch.tensor(r * np.sin(th))
    stats = torch.tensor([0.01, 0.02, 1.0 / 64, 0.0], dtype=torch.float64)
    mspec = ft._spec_of(system)
    spec = ftr.fast_spec(system, field=False)
    ins = traygen.generate_rays(system, *ff.H, Px, Py, wl)
    ins = [getattr(ins, k) for k in ftr.RAY_FIELDS]
    cots = [torch.tensor(rng.normal(size=64)) for _ in range(8)]

    def run():
        m = ft.merit_bwd_plain(params, aim, stats, mspec, nc, 64, Px=Px,
                               Py=Py, coeffs=coeffs, lay=lay)
        din, t = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots,
                                          coeffs=coeffs, lay=lay)
        return [m, t] + list(din)

    kept = run()
    _resolving(monkeypatch)
    for k, (a, b) in enumerate(zip(kept, run())):
        assert_close(a, b, 0.0, 1e-13, f"output {k}")
    assert float(kept[0][system.cfg.num_surfaces * step.NUM_P:].abs().max()
                 ) > 0  # the coefficient gradient is there


@pytest.mark.parametrize("fam,tilted", [("standard", False),
                                        ("standard", True), ("even", True)])
def test_step_extras_match_jax(fam, tilted):
    code, p, C, q, slots, aux = surface(fam, tilted)
    st, g = rays()
    gx = rays(seed=12)[1][:7]  # the extras' cotangents
    n_pre = torch.tensor(1.0, dtype=torch.float64)
    _, _, ext = step.step_plain(code, False, p, n_pre, st, absorbs=True,
                                extras=True, c=q, lay=slots,
                                newton_iters=NITERS)
    g_in, g_npre, cols = step.step_adjoint_plain(
        code, False, p, n_pre, st, g, absorbs=True, g_ext=tuple(gx),
        tilted=tilted, c=q, lay=slots, newton_iters=NITERS, t_s=ext[7])
    pairs, _ = step.split_cols(code, cols, step.FULL_GRAD_COLS, q.shape[0])
    cols = {col: v.sum() for col, v in pairs}

    def f(pv, cv, *state):
        out, extras = jpt._step_tile(
            1, code, False, tilted, aux, lambda s, col: pv[col],
            lambda s, ci: cv[ci], C.shape[0], tuple(state) + (None,),
            NITERS, want_extras=True)
        return tuple(out[:9]) + tuple(extras)

    args = [jnp.asarray(p.numpy()), jnp.asarray(C.numpy())] + [
        jnp.asarray(v.numpy()) for v in st] + [jnp.ones(st[0].shape[0])]
    jout, pull = jax.vjp(f, *args)
    for k in range(7):
        assert_close(ext[k], jout[9 + k], 1e-12, 1e-14, f"extra {k}")
    cot = [jnp.asarray(v.numpy()) for v in g[:6] + g[7:]] + [
        jnp.asarray(float(g[6].sum()))] + [jnp.asarray(v.numpy()) for v in gx]
    gp, _, *gs = pull(tuple(cot))
    for k, (a, b) in enumerate(zip(g_in, gs)):
        assert_close(a, b, 1e-10, 1e-12, f"state {k} against JAX")
    assert_close(g_npre, gs[8], 1e-10, 1e-12, "n_pre against JAX")
    keys = [c for c in cols if tilted or c not in TILT_COLS]
    assert_close(torch.stack([cols[c] for c in keys]), np.asarray(gp)[keys],
                 1e-10, 1e-12, "param columns against JAX")
