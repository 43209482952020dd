"""optiland_torch's trace kernels on tilted surfaces (the tilt branch of
kernel K6 in K1-K5 and K8-K9) against the JAX package, on the CPU in
float64, where the wrappers run the kernels' plain versions.

The systems (``optiland_torch.samples.perturbed``) are the toleranced
Cooke triplet, every lens surface tilted by 0.5-2 mrad about each axis and
decentred by 0.01-0.05 mm, and bench.py's Fresnel-coated singlet with its
first surface tilted, built with either package's classes.

  * forward: ``trace_fast`` (K5a), ``trace_fast_field`` (K1),
    ``spot_rms_fast_field`` with explicit samples (K2), ``trace_fast_pol``
    and ``trace_fast_pol_intensity`` (K8) against the JAX package's Pallas
    kernels in interpret mode, as its suite runs them: rays to rtol 1e-8
    with atol 1e-10 (the JAX test's tolerance), p to atol 1e-12;
  * gradients of each entry's merit with respect to every stack leaf, the
    tilts rx, ry, rz included (K5b, K4, K3, K9), to rtol 1e-8 with atol
    1e-12 x the largest entry wherever JAX's is finite. The JAX kernels'
    gradients in interpret mode take minutes to compile on the CPU; JAX's
    XLA path traces the same rotations (its tilt gate is open for these
    systems) and is the reference;
  * the hand adjoints against autograd of the plain forwards, and the zero
    tilt: the general adjoint with every surface flagged as tilted, at zero
    angles, against the untilted code (rtol 1e-12).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pol_systems as tps
from optiland_torch import config
from optiland_torch.core import raygen as traygen
from optiland_torch.core.rays import RealRays as TRays
from optiland_torch.core.system import STACK_FIELDS
from optiland_torch.ops import fast_trace as ftr
from optiland_torch.ops import fused_trace as ft
from optiland_torch.ops import pol_trace as pt
from optiland_torch.ops import step
from optiland_torch.polarization import create_polarization as t_state
from optiland_torch.samples import CookeTriplet as TCooke
from optiland_torch.samples import perturbed
from optiland_tpu.core import raygen as jraygen
from optiland_tpu.core import trace as jtrace
from optiland_tpu.ops import pallas_trace as jpt
from optiland_tpu.ops.pallas_pol import (
    trace_fast_pol as j_fast_pol,
    trace_fast_pol_intensity as j_fast_pol_intensity,
)
from optiland_tpu.polarization import create_polarization as j_state
from optiland_tpu.polarization import polarized_intensity as j_ipol
from optiland_tpu.samples import CookeTriplet as JCooke
from tests.torch_shared import SharedRefs

H = (0.0, 0.7)
WL = 0.55
N_RAYS = 128
FIELDS = ftr.RAY_FIELDS


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield
    config.set_device("cpu")
    config.set_precision("float64")


def pupil(n=N_RAYS, seed=21):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n)) * 0.95
    th = rng.uniform(0, 2 * np.pi, size=n)
    return r * np.cos(th), r * np.sin(th)


def np_of(v):
    return v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)


def merit_of(m, f):
    """Spot size, transmission and path (K1, K4, K5a, K5b)."""
    return m.mean(f.x**2 + f.y**2) + 0.3 * m.mean(f.i) + 1e-3 * m.mean(f.opd)


def spot_of(m, f):
    """The RMS-spot merit (K2, K3)."""
    return m.mean((f.x - m.mean(f.x)) ** 2 + (f.y - m.mean(f.y)) ** 2)


def pol_merit(m, x, y, i):
    """bench.py's polarized merit: the spread of (x i, y i)."""
    x, y = x * i, y * i
    return m.mean((x - m.mean(x)) ** 2 + (y - m.mean(y)) ** 2)


def assert_grads(got, ref):
    scale = max(float(np.nanmax(np.abs(v))) for v in ref.values() if v.size)
    for k in STACK_FIELDS:
        if ref[k].size == 0:
            continue
        fin = np.isfinite(ref[k])
        np.testing.assert_allclose(got[k][fin], ref[k][fin], rtol=1e-8,
                                   atol=1e-12 * scale, err_msg=k)


def with_leaves(system):
    leaves = {k: v.detach().clone().requires_grad_(v.numel() > 0)
              for k, v in system.stack.leaves().items()}
    return system.replace(stack=system.stack.replace(**leaves)), leaves


def grads_of(leaves):
    return {k: (np.zeros(tuple(v.shape)) if v.grad is None
                else v.grad.numpy()) for k, v in leaves.items()}


@pytest.fixture(scope="module")
def jax_cooke(tmp_path_factory):
    """The toleranced Cooke triplet in the JAX package, each part when a
    test first reads it (once per session: ``torch_shared.SharedRefs``):
    its launch bundle ("rays"), the interpret-mode kernels' outputs
    ("fast", "field": K5a, K1; "merit": K2) and, through its XLA path, the
    two merits' values ("values") and their values and gradients ("trace",
    "spot", both rows of one Jacobian, "jacobian")."""
    refs = SharedRefs(tmp_path_factory, "tilts_cooke",
                      lambda part: _jax_cooke(part, refs))
    return refs


def _jax_cooke(part, refs):
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    jsys = perturbed.toleranced_cooke(JCooke).system
    assert jsys.cfg.has_tilts and jpt.pallas_supported(jsys)
    Px, Py = (jnp.asarray(a) for a in pupil())
    rays = jraygen.generate_rays(jsys, *H, Px, Py, WL)

    def merits(stack):
        s = jsys.replace(stack=stack)
        f, _ = jtrace.trace(s, jraygen.generate_rays(s, *H, Px, Py, WL),
                            record=False)
        return jnp.stack([merit_of(jnp, f), spot_of(jnp, f)])

    if part == "rays":
        out = rays
    elif part == "fast":
        out = jpt.trace_fast(jsys, rays, WL)
    elif part == "field":
        out = jpt.trace_fast_field(jsys, *H, Px, Py, WL)
    elif part == "merit":
        out = float(jpt.spot_rms_fast_field(jsys, *H, WL, Px=Px, Py=Py))
    elif part == "values":
        out = [float(v) for v in merits(jsys.stack)]
    elif part == "jacobian":
        jac = jax.jacrev(merits)(jsys.stack)
        out = ([float(v) for v in merits(jsys.stack)],
               {k: np.asarray(getattr(jac, k)) for k in STACK_FIELDS})
    else:
        vals, jac = refs["jacobian"]
        j = ("trace", "spot").index(part)
        out = (vals[j], {k: v[j] for k, v in jac.items()})
    mp.undo()
    return out


@functools.lru_cache(maxsize=None)
def jax_singlet_system():
    """The tilted singlet in the JAX package."""
    jsys = perturbed.tilted_singlet(classes=tps.classes("jax")).system
    assert jsys.cfg.has_tilts
    return jsys


@pytest.fixture(scope="module")
def jax_singlet(tmp_path_factory):
    """The tilted singlet's references, each part when a test first reads
    it (once per session: ``torch_shared.SharedRefs``): "kernel", a launch
    bundle and the interpret-mode polarized kernel (both modes, H);
    "grads", jax.grad of the polarized merit through its XLA path."""
    return SharedRefs(tmp_path_factory, "tilts_singlet", _jax_singlet)


def _jax_singlet(part):
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    jsys = jax_singlet_system()
    Px, Py = tps.pupil(N_RAYS, 7)
    rays = jraygen.generate_rays(jsys, *H, jnp.asarray(Px), jnp.asarray(Py),
                                 WL)
    state = j_state("H")
    if part == "kernel":
        fast, p = j_fast_pol(jsys, rays, WL)
        inten = j_fast_pol_intensity(jsys, rays, WL, state=state).i
        out = dict(rays=rays, fast=fast, p=p, i=inten)
    else:

        def merit(stack):
            out, hist = jtrace.trace(jsys.replace(stack=stack), rays,
                                     record=False)
            i = j_ipol(hist["p"], state, rays.L, rays.M, rays.N, rays.i)
            return pol_merit(jnp, out.x, out.y, i)

        val, g = jax.value_and_grad(merit)(jsys.stack)
        out = dict(rays=rays, value=float(val),
                   grads={k: np.asarray(getattr(g, k)) for k in STACK_FIELDS})
    mp.undo()
    return out


def port_rays(jrays):
    return TRays(**{k: torch.tensor(np.asarray(getattr(jrays, k)))
                    for k in FIELDS + ("w",)})


def cooke():
    return perturbed.toleranced_cooke().system


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def test_specs_flag_every_tilted_surface():
    system = cooke()
    flags = (False,) + (True,) * 6 + (False,)
    assert ftr.fast_spec(system)[3] == flags
    assert ftr.fast_spec(system, field=True)[3] == flags
    assert ft._spec_of(system)[2] == flags
    assert ftr.poly_spec(system)[3] == flags
    singlet = perturbed.tilted_singlet().system
    assert pt.pol_spec(singlet, WL)[5] == (False, True) + (False,) * (
        singlet.cfg.num_surfaces - 2)


@pytest.mark.parametrize("entry", ["trace_fast", "trace_fast_field"])
def test_tilted_trace_matches_jax_kernel(jax_cooke, entry):
    if entry == "trace_fast":
        out = ftr.trace_fast(cooke(), port_rays(jax_cooke["rays"]), WL)
        ref = jax_cooke["fast"]
    else:
        Px, Py = (torch.tensor(a) for a in pupil())
        out = ftr.trace_fast_field(cooke(), *H, Px, Py, WL)
        ref = jax_cooke["field"]
    for k in FIELDS:
        np.testing.assert_allclose(np_of(getattr(out, k)),
                                   np.asarray(getattr(ref, k)), rtol=1e-8,
                                   atol=1e-10, err_msg=k)


def test_tilted_merit_matches_jax_kernel(jax_cooke):
    Px, Py = (torch.tensor(a) for a in pupil())
    val = ft.spot_rms_fast_field(cooke(), *H, WL, Px=Px, Py=Py)
    assert float(val) == pytest.approx(jax_cooke["merit"], rel=1e-10)
    assert float(val) == pytest.approx(jax_cooke["values"][1], rel=1e-10)


@pytest.mark.parametrize("entry", ["trace_fast", "trace_fast_field",
                                   "spot_rms_fast_field"])
def test_tilted_gradients_match_jax(jax_cooke, entry):
    s2, leaves = with_leaves(cooke())
    Px, Py = (torch.tensor(a) for a in pupil())
    if entry == "spot_rms_fast_field":
        val = ft.spot_rms_fast_field(s2, *H, WL, Px=Px, Py=Py)
        ref_val, ref = jax_cooke["spot"]
    else:
        if entry == "trace_fast":
            f = ftr.trace_fast(s2, traygen.generate_rays(s2, *H, Px, Py, WL),
                               WL)
        else:
            f = ftr.trace_fast_field(s2, *H, Px, Py, WL)
        val = merit_of(torch, f)
        ref_val, ref = jax_cooke["trace"]
    val.backward()
    assert float(val.detach()) == pytest.approx(ref_val, rel=1e-10)
    got = grads_of(leaves)
    assert_grads(got, ref)
    for k in ("rx", "ry", "rz"):
        assert np.abs(got[k][1:7]).min() > 0, k


def test_tilted_pol_matches_jax_kernel(jax_singlet):
    ref = jax_singlet["kernel"]
    system = tps.carried(jax_singlet_system())
    rays = port_rays(ref["rays"])
    out, p = pt.trace_fast_pol(system, rays, WL)
    for k in FIELDS:
        np.testing.assert_allclose(np_of(getattr(out, k)),
                                   np.asarray(getattr(ref["fast"], k)),
                                   rtol=1e-8, atol=1e-10, err_msg=k)
    np.testing.assert_allclose(np_of(p), np.asarray(ref["p"]),
                               rtol=1e-9, atol=1e-12)
    out = pt.trace_fast_pol_intensity(system, rays, WL, state=t_state("H"))
    np.testing.assert_allclose(np_of(out.i), np.asarray(ref["i"]),
                               rtol=1e-8, atol=1e-10)


def test_tilted_pol_gradients_match_jax(jax_singlet):
    ref = jax_singlet["grads"]
    system = tps.carried(jax_singlet_system())
    s2, leaves = with_leaves(system)
    out = pt.trace_fast_pol_intensity(s2, port_rays(ref["rays"]), WL,
                                      state=t_state("H"))
    val = pol_merit(torch, out.x, out.y, out.i)
    val.backward()
    assert float(val.detach()) == pytest.approx(ref["value"], rel=1e-10)
    got = grads_of(leaves)
    assert_grads(got, ref["grads"])
    assert np.abs(got["rx"][1]) > 0 and np.abs(got["rz"][1]) > 0


# ---------------------------------------------------------------------------
# The hand adjoints, and the zero tilt
# ---------------------------------------------------------------------------


def _close(a, b, rtol, what):
    for k, (u, v) in enumerate(zip(a, b)):
        fin = torch.isfinite(v)
        torch.testing.assert_close(
            u[fin], v[fin], rtol=rtol,
            atol=1e-12 * float(v[fin].abs().max() + 1e-300),
            msg=f"{what} {k}")


def _inputs(system, seed):
    rng = np.random.default_rng(seed)
    Px, Py = (torch.tensor(a) for a in pupil(200, seed))
    with torch.no_grad():
        rays = traygen.generate_rays(system, *H, Px, Py, WL)
        params = ft.build_param_table(system, WL)
        aim = ft.aim_vector(system, *H)
    ins = [getattr(rays, k).detach().contiguous() for k in FIELDS]
    ins[6] = torch.tensor(rng.uniform(0.5, 1, 200))
    ins[7] = torch.tensor(rng.uniform(0, 1, 200))
    cots = [torch.tensor(rng.normal(size=200)) for _ in range(pt.N_POL)]
    return params, aim, Px, Py, ins, cots


def test_tilted_adjoints_match_autograd():
    """trace_bwd, trace_field_bwd and merit_bwd's plain versions on the
    toleranced Cooke triplet against autograd of the plain forwards (rtol
    1e-10: sums of 200 terms in another order)."""
    system = cooke()
    spec = ftr.fast_spec(system, field=True)
    params, aim, Px, Py, ins, cots = _inputs(system, 3)
    S, nc = len(spec[0]), 1
    p = params.clone().requires_grad_()
    insg = [t.clone().requires_grad_() for t in ins]
    out = ftr.trace_fast_plain(p, spec, insg)
    auto = torch.autograd.grad(sum((o * c).sum() for o, c in
                                   zip(out, cots)), [p] + insg)
    din, flat = ftr.trace_bwd(params, spec, nc, ins, cots[:8])
    _close([flat], [torch.cat([auto[0].reshape(-1), torch.zeros(S * nc)])],
           1e-10, "trace_bwd")
    _close(din, auto[1:], 1e-10, "trace_bwd input cotangent")
    p, a = params.clone().requires_grad_(), aim.clone().requires_grad_()
    out = ftr.trace_fast_field_plain(p, a, spec, Px, Py)
    gp, ga = torch.autograd.grad(sum((o * c).sum() for o, c in
                                     zip(out, cots)), [p, a])
    flat = ftr.trace_field_bwd(params, aim, spec, nc, Px, Py, cots[:8])
    _close([flat], [torch.cat([gp.reshape(-1), torch.zeros(S * nc), ga])],
           1e-10, "trace_field_bwd")
    mspec = ft._spec_of(system)
    stats = torch.tensor([0.01, -0.3, 1.0 / 200, 0.0], dtype=torch.float64)
    p, a = params.clone().requires_grad_(), aim.clone().requires_grad_()
    x, y = ft.trace_xy_plain(p, a, mspec, Px, Py)
    loss = stats[2] * ((x - stats[0]) ** 2 + (y - stats[1]) ** 2).sum()
    gp, ga = torch.autograd.grad(loss, [p, a])
    flat = ft.merit_bwd(params, aim, stats, mspec, nc, 200, Px=Px, Py=Py)
    _close([flat], [torch.cat([gp.reshape(-1), torch.zeros(S * nc), ga])],
           1e-10, "merit_bwd")


def test_tilted_pol_adjoint_matches_autograd():
    system = perturbed.tilted_singlet().system
    spec = pt.pol_spec(system, WL)
    params, _, _, _, ins, cots = _inputs(system, 4)
    coat = pt.build_coat_table(system, WL, torch.float64, "cpu")
    S = len(spec[0])
    for intensity, states in ((False, None), (True, pt.pol_states(
            t_state("H")))):
        c = cots[:8] if intensity else cots
        p = params.clone().requires_grad_()
        cg = coat.clone().requires_grad_()
        insg = [t.clone().requires_grad_() for t in ins]
        out = pt.pol_fwd_plain(p, cg, spec, insg, states, intensity)
        auto = torch.autograd.grad(sum((o * v).sum() for o, v in
                                       zip(out, c)), [p, cg] + insg)
        din, flat = pt.pol_bwd_plain(params, coat, spec, ins, c, states,
                                     intensity)
        ref = torch.cat([auto[0].reshape(-1), auto[1].reshape(-1)])
        _close([flat], [ref], 1e-10, f"pol_bwd intensity={intensity}")
        _close(din, auto[2:], 1e-10, f"pol_bwd din intensity={intensity}")
        assert flat[: S * step.NUM_P].reshape(S, -1)[1, step.P_RX] != 0


def _forced(spec, part):
    """``spec`` with every tilt flag (spec part ``part``) set."""
    return spec[:part] + ((True,) * len(spec[0]),) + spec[part + 1:]


def test_zero_tilt_flag_forced_on_matches_untilted_code():
    """At zero angles the general tilt adjoint (every surface flagged) gives
    what the untilted code gives, the rotations' generators included, in
    each backward: trace_bwd, trace_field_bwd, merit_bwd, pol_bwd."""
    system = TCooke().system
    spec = ftr.fast_spec(system, field=True)
    assert not any(spec[3])
    params, aim, Px, Py, ins, cots = _inputs(system, 5)
    on = _forced(spec, 3)
    a = ftr.trace_bwd(params, spec, 1, ins, cots[:8])
    b = ftr.trace_bwd(params, on, 1, ins, cots[:8])
    _close([a[1]] + list(a[0]), [b[1]] + list(b[0]), 1e-12, "trace_bwd")
    assert float(a[1].reshape(-1)[: 8 * step.NUM_P].reshape(8, -1)[
        1:7, step.P_RX].abs().min()) > 0
    _close([ftr.trace_field_bwd(params, aim, spec, 1, Px, Py, cots[:8])],
           [ftr.trace_field_bwd(params, aim, on, 1, Px, Py, cots[:8])],
           1e-12, "trace_field_bwd")
    mspec = ft._spec_of(system)
    stats = torch.tensor([0.01, -0.3, 1.0 / 200, 0.0], dtype=torch.float64)
    _close([ft.merit_bwd(params, aim, stats, mspec, 1, 200, Px=Px, Py=Py)],
           [ft.merit_bwd(params, aim, stats, _forced(mspec, 2), 1, 200,
                         Px=Px, Py=Py)], 1e-12, "merit_bwd")
    # the forward is the same either way (the plain versions always rotate,
    # exactly, at zero)
    for u, v in zip(ftr.trace_fast_plain(params, spec, ins),
                    ftr.trace_fast_plain(params, on, ins)):
        assert torch.equal(u, v)
    singlet = perturbed.tilted_singlet(zero=True).system
    pspec = pt.pol_spec(singlet, WL)
    assert not any(pspec[5])
    params, _, _, _, ins, cots = _inputs(singlet, 6)
    coat = pt.build_coat_table(singlet, WL, torch.float64, "cpu")
    a = pt.pol_bwd_plain(params, coat, pspec, ins, cots)
    b = pt.pol_bwd_plain(params, coat, _forced(pspec, 5), ins, cots)
    _close([a[1]] + list(a[0]), [b[1]] + list(b[0]), 1e-12, "pol_bwd")
