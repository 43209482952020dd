"""optiland_torch's polarized trace against the JAX package, on the CPU in
float64: the plain engine (``core.trace.trace`` of a polarized system)
against JAX's XLA trace, the plain version of kernel K8 against JAX's
polarized Pallas kernel in interpret mode (forward only: its interpret-mode
adjoint costs minutes), the hand adjoint of K9 against autograd, the
gradients of polarized merits against ``jax.grad`` of JAX's XLA path, and
the polarized ``Optic.trace`` with its exit fields.

The systems are the JAX suite's own (``tests/torch_pol_systems.py``), fed
to the port through ``system_from_numpy`` (the coatings as records) or
built with its ``Optic``; the launch bundles and cotangents come from numpy
seeds. The JAX side runs its unrolled engine
(``OPTILAND_TPU_TRACE_ENGINE=unrolled``). Tolerances: rays to rtol 1e-9
with atol 1e-11 and p to atol 1e-12 (the JAX suite's own), the hand
adjoint to rtol 1e-10 of autograd, every gradient to rtol 1e-8 with atol
1e-12 x the largest entry where JAX's is finite. The intensity mode's
vector form (``fields``: the launch states' fields carried through the
surfaces in place of p, as pol_bwd's kernel runs it) against ``jax.vjp``
of the JAX package's plain intensity chain (``_chain_pol_intensity``) on
the tilted singlet, one and two states: the exit intensity to 1e-13 of
the largest, every cotangent to 1e-12 of its array's largest (1e-12 of
the largest entry for the parameter and coat gradients, the untilted
surfaces' tilt columns left out: the JAX step runs no rotation there).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pol_systems as tps
from optiland_torch import config
from optiland_torch.core import raygen as traygen
from optiland_torch.core import trace as ttrace
from optiland_torch.core.rays import RealRays as TRays
from optiland_torch.core.system import STACK_FIELDS
from optiland_torch.ops import fused_trace as ft
from optiland_torch.ops import pol_trace as pt
from optiland_torch.polarization import create_polarization as t_state
from optiland_torch.polarization import polarized_intensity as t_ipol
from optiland_tpu.core import raygen as jraygen
from optiland_tpu.core import trace as jtrace
from optiland_torch.samples import perturbed
from optiland_tpu.ops import pallas_pol as jpp
from optiland_tpu.ops.pallas_pol import (
    trace_fast_pol as j_fast_pol,
    trace_fast_pol_intensity as j_fast_pol_intensity,
)
from optiland_tpu.polarization import create_polarization as j_state
from optiland_tpu.polarization import polarized_intensity as j_ipol

WL = 0.55
FIELDS = ("x", "y", "z", "L", "M", "N", "i", "opd")
# the interpret-mode kernel per system, which together hold every coat
# kind: fresnel; polarizer and retarder; tmm and simple; the Fresnel- and
# simple-coated mirrors; none on every image plane. The intensity mode runs
# one state on each of three of them.
KERNEL_KINDS = ("fresnel", "polarizer", "tmm", "mirror")
STATE_OF = {"H": "fresnel", "RCP": "polarizer", "unpolarized": "tmm"}
STATES = tuple(STATE_OF)


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield
    config.set_device("cpu")
    config.set_precision("float64")


@pytest.fixture(scope="module")
def unrolled():
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    yield
    mp.undo()


def np_of(v):
    return v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)


def jax_bundle(jsys, n, seed, Hy=0.5):
    Px, Py = tps.pupil(n, seed)
    H = jnp.zeros(n)
    return jraygen.generate_rays(jsys, H, H + Hy, jnp.asarray(Px),
                                 jnp.asarray(Py), WL)


def port_rays(jrays):
    return TRays(**{k: torch.tensor(np.asarray(getattr(jrays, k)))
                    for k in FIELDS + ("w",)})


def assert_rays(got, ref, fields=FIELDS):
    for k in fields:
        np.testing.assert_allclose(np_of(getattr(got, k)),
                                   np.asarray(getattr(ref, k)), rtol=1e-9,
                                   atol=1e-11, err_msg=k)


def assert_p(got, ref):
    np.testing.assert_allclose(np_of(got), np.asarray(ref), rtol=1e-9,
                               atol=1e-12)


# The JAX references, per kernel kind, computed when a test first reads
# them (each test reads only its kind's: under --dist load a module fixture
# of every kind ran on every worker that got one of these tests).


@functools.lru_cache(maxsize=None)
def jax_case(kind):
    """The JAX system of kernel kind ``kind`` and a 300-ray bundle."""
    jsys = tps.build(kind, "jax").system
    return jsys, jax_bundle(jsys, 300, 11, Hy=0.0 if kind == "mirror" else 0.5)


@functools.lru_cache(maxsize=None)
def jax_xla(kind):
    """The XLA trace of ``jax_case(kind)``: (rays, p) (under ``unrolled``)."""
    jsys, rays = jax_case(kind)
    xla, hist = jtrace.trace(jsys, rays, record=False)
    return xla, hist["p"]


@functools.lru_cache(maxsize=None)
def jax_fast(kind):
    """The interpret-mode kernel's (rays, p) of ``jax_case(kind)``."""
    return j_fast_pol(*jax_case(kind), WL)


@functools.lru_cache(maxsize=None)
def jax_intensity(state):
    """The interpret-mode intensity kernel of ``state`` on its kind's case."""
    jsys, rays = jax_case(STATE_OF[state])
    return j_fast_pol_intensity(jsys, rays, WL, state=j_state(state)).i


@pytest.mark.parametrize("kind", KERNEL_KINDS)
def test_plain_engine_matches_jax_xla(unrolled, kind):
    jsys, jrays = jax_case(kind)
    ref_xla, ref_p = jax_xla(kind)
    system = tps.carried(jsys)
    rays = port_rays(jrays)
    out, hist = ttrace.trace(system, rays, record=False)
    assert_rays(out, ref_xla)
    assert_p(hist["p"], ref_p)
    for a, b in ((out.L0, rays.L), (out.N0, rays.N)):
        assert torch.equal(a, b)
    # with a history: the same rays and p
    out_h, hist_h = ttrace.trace(system, rays, record=True)
    assert_p(hist_h["p"], ref_p)
    assert hist_h["x"].shape == (system.cfg.num_surfaces, 300)


@pytest.mark.parametrize("kind", KERNEL_KINDS)
def test_kernel_plain_matches_jax_interpret(unrolled, kind):
    jsys, jrays = jax_case(kind)
    ref_fast, ref_p = jax_fast(kind)
    system = tps.carried(jsys)
    assert pt.pol_supported(system, WL)
    out, p = pt.trace_fast_pol(system, port_rays(jrays), WL)
    assert_rays(out, ref_fast)
    assert_p(p, ref_p)


@pytest.mark.parametrize("state", STATES)
def test_kernel_plain_intensity_matches_jax_interpret(unrolled, state):
    jsys, jrays = jax_case(STATE_OF[state])
    system = tps.carried(jsys)
    rays = port_rays(jrays)
    st = None if state == "unpolarized" else t_state(state)
    out = pt.trace_fast_pol_intensity(system, rays, WL, state=st)
    np.testing.assert_allclose(np_of(out.i), np.asarray(jax_intensity(state)),
                               rtol=1e-9, atol=1e-12)
    # = the full mode followed by the exit intensity of the launch state
    full, p = pt.trace_fast_pol(system, rays, WL)
    torch.testing.assert_close(
        out.i, t_ipol(p, st, rays.L, rays.M, rays.N, rays.i), rtol=1e-12,
        atol=1e-14)


def _hand_vs_autograd(kind, states, intensity, seed):
    system = tps.build(kind, "torch").system
    spec = pt.pol_spec(system, WL)
    rng = np.random.default_rng(seed)
    n = 64
    Px, Py = tps.pupil(n, seed)
    from optiland_torch.core import raygen

    rays = raygen.generate_rays(system, 0.0, 0.0 if kind == "mirror" else 0.5,
                                torch.tensor(Px), torch.tensor(Py), WL)
    ins = [getattr(rays, k).detach().clone() for k in FIELDS]
    ins[6] = torch.tensor(rng.uniform(0.5, 1.0, n))
    ins[7] = torch.tensor(rng.uniform(size=n))
    params = ft.build_param_table(system, WL).detach()
    coat = pt.build_coat_table(system, WL, torch.float64, "cpu").clone()
    cots = [torch.tensor(rng.normal(size=n))
            for _ in range(8 if intensity else pt.N_POL)]
    pg, cg = params.clone().requires_grad_(), coat.clone().requires_grad_()
    ig = [t.clone().requires_grad_() for t in ins]
    out = pt.pol_fwd_plain(pg, cg, spec, ig, states, intensity)
    auto = torch.autograd.grad(sum((o * c).sum() for o, c in zip(out, cots)),
                               [pg, cg] + ig, allow_unused=True)
    auto = [torch.zeros_like(t) if a is None else a
            for a, t in zip(auto, [pg, cg] + ig)]
    # one scale for all: some entries are rounding noise about an exact
    # zero (unpolarized light through a polarizer does not see its axis)
    scale = max(float(a.abs().max()) for a in auto)
    din, flat = pt.pol_bwd_plain(params, coat, spec, ins, cots, states,
                                 intensity)
    S = len(spec[0])
    got = [flat[: S * 15].reshape(S, 15), flat[S * 15:].reshape(coat.shape)]
    for a, b, what in zip(got + list(din), auto,
                          ["params", "coat"] + list(FIELDS)):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12 * scale,
                                   msg=f"{kind} {what}")


@pytest.mark.parametrize("kind", tps.KINDS)
@pytest.mark.parametrize("mode", ["full", "H", "unpolarized"])
def test_hand_adjoint_matches_autograd(kind, mode):
    states = None if mode == "full" else pt.pol_states(
        None if mode == "unpolarized" else t_state(mode))
    _hand_vs_autograd(kind, states, mode != "full", 3)


@pytest.mark.parametrize("state", ["H", "unpolarized"])
def test_fields_form_matches_jax_plain_chain(state):
    jsys = perturbed.tilted_singlet(classes=tps.classes("jax")).system
    system = perturbed.tilted_singlet().system
    n = 16
    Px, Py = tps.pupil(n, 7)
    rays = traygen.generate_rays(system, 0.0, 0.7, torch.tensor(Px),
                                 torch.tensor(Py), WL)
    ins = [getattr(rays, k) for k in FIELDS]
    rng = np.random.default_rng(3)
    cots = [rng.normal(size=n) for _ in range(8)]
    spec = jpp._spec_of(jsys, 10, poly=False)
    kinds = jpp._coat_kinds(jsys, WL)
    scalars = jpp._pol_scalars_of(None if state == "unpolarized"
                                  else j_state(state))
    S = jsys.cfg.num_surfaces

    def chain(pv, cv, cov, *r):
        return jpp._chain_pol_intensity(
            spec, kinds, scalars, lambda s, c: pv[s, c],
            lambda s, c: cv[s, c], lambda s, c: cov[s, c], *r)

    coeffs = jsys.stack.coeffs
    out, pull = jax.vjp(chain, jpp.build_param_table(jsys, WL),
                        coeffs if coeffs.shape[1] else jnp.zeros((S, 1)),
                        jpp.build_coat_table(jsys, WL),
                        *[jnp.asarray(t.numpy()) for t in ins])
    gp, _, gcoat, *gin = pull(tuple(jnp.asarray(c) for c in cots))

    tspec = pt.pol_spec(system, WL)
    params = ft.build_param_table(system, WL)
    coat = pt.build_coat_table(system, WL, torch.float64, "cpu")
    states = pt.pol_states(None if state == "unpolarized"
                           else t_state(state))
    assert len(states) == (2 if state == "unpolarized" else 1)
    got = pt.pol_fwd_plain(params, coat, tspec, ins, states, True,
                           fields=True)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(out[6]), rtol=0,
                               atol=1e-13 * float(np.abs(out[6]).max()))
    din, flat = pt.pol_bwd_plain(params, coat, tspec, ins,
                                 [torch.tensor(c) for c in cots], states,
                                 True, fields=True)
    for k, (a, b) in enumerate(zip(din, gin)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-12 * float(np.abs(b).max()),
                                   err_msg=FIELDS[k])
    gp, gcoat = np.asarray(gp), np.asarray(gcoat)
    dp = flat[:S * 15].reshape(S, 15).numpy()
    dcoat = flat[S * 15:].reshape(S, -1).numpy()
    keep = np.ones_like(gp, dtype=bool)
    untilted = [s for s in range(S) if not tspec[5][s]]
    keep[np.ix_(untilted, [8, 9, 10])] = False
    assert any(tspec[5])
    np.testing.assert_allclose(dp[keep], gp[keep], rtol=0,
                               atol=1e-12 * float(np.abs(gp).max()))
    np.testing.assert_allclose(dcoat, gcoat[:, :dcoat.shape[1]], rtol=0,
                               atol=1e-12 * float(np.abs(gcoat).max()))


@functools.lru_cache(maxsize=None)
def singlet_case():
    """The JAX suite's 3-surface Fresnel singlet (R 50, 45 mm to the
    image, H) and a fixed 150-ray bundle."""
    from optiland_tpu.optic import Optic

    o = Optic()
    o.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    o.surfaces.add(index=1, radius=50.0, thickness=45.0, material="N-BK7",
                   is_stop=True, coating="fresnel")
    o.surfaces.add(index=2)
    o.set_aperture("EPD", 20.0)
    o.fields.set_type("angle")
    o.fields.add(y=0)
    o.wavelengths.add(0.55, is_primary=True)
    o.set_polarization("H")
    jsys = o.system
    return jsys, jax_bundle(jsys, 150, 5)


@functools.lru_cache(maxsize=None)
def singlet_grad(name):
    """jax.value_and_grad over every stack leaf of one merit of the
    singlet's XLA trace (under ``unrolled``; each test computes only its
    own): "suite", the suite's y^2 i_pol + |p|^2; "bench", bench.py's
    spread of (x i_pol, y i_pol), with the tilt gate open as the kernels
    trace (their zero-tilt derivatives)."""
    jsys, rays = singlet_case()
    state = j_state("H")

    def merit_suite(stack):
        out, hist = jtrace.trace(jsys.replace(stack=stack), rays,
                                 record=False)
        p = hist["p"]
        ip = j_ipol(p, state, rays.L, rays.M, rays.N, out.i)
        return jnp.mean(out.y**2 * ip) + jnp.mean(jnp.abs(p) ** 2)

    tilted = jsys.replace(cfg=dataclasses.replace(jsys.cfg, has_tilts=True))

    def merit_bench(stack):
        out, hist = jtrace.trace(tilted.replace(stack=stack), rays,
                                 record=False)
        i = j_ipol(hist["p"], state, rays.L, rays.M, rays.N, rays.i)
        x, y = out.x * i, out.y * i
        return jnp.mean((x - jnp.mean(x)) ** 2 + (y - jnp.mean(y)) ** 2)

    merit = {"suite": merit_suite, "bench": merit_bench}[name]
    return jax.value_and_grad(merit)(jsys.stack)


def port_leaves(jsys):
    system = tps.carried(jsys)
    leaves = {k: v.clone().requires_grad_() for k, v in
              system.stack.leaves().items()}
    return system.replace(stack=system.stack.replace(**leaves)), leaves


def assert_grads(leaves, jgrad):
    scale = max(float(np.nanmax(np.abs(np.asarray(getattr(jgrad, k)))))
                for k in STACK_FIELDS if np.asarray(getattr(jgrad, k)).size)
    for k in STACK_FIELDS:
        ref = np.asarray(getattr(jgrad, k))
        if ref.size == 0:
            continue
        got = leaves[k].grad
        got = np.zeros_like(ref) if got is None else got.numpy()
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-8,
                                   atol=1e-12 * scale, err_msg=k)


def test_polarized_merit_gradient_matches_jax(unrolled):
    jsys, jrays = singlet_case()
    value, jgrad = singlet_grad("suite")
    system, leaves = port_leaves(jsys)
    rays = port_rays(jrays)
    out, hist = ttrace.trace(system, rays, record=False)
    p = hist["p"]
    ip = t_ipol(p, t_state("H"), rays.L, rays.M, rays.N, out.i)
    merit = (out.y**2 * ip).mean() + (p.real**2 + p.imag**2).mean()
    merit.backward()
    assert float(merit.detach()) == pytest.approx(float(value), rel=1e-12)
    assert_grads(leaves, jgrad)


def test_kernel_merit_gradient_matches_jax(unrolled):
    # the bench step through the kernels' plain versions and the hand
    # adjoint (trace_fast_pol_intensity on CPU tensors) against jax.grad of
    # JAX's XLA path with the tilt gate open
    jsys, jrays = singlet_case()
    value, jgrad = singlet_grad("bench")
    system, leaves = port_leaves(jsys)
    out = pt.trace_fast_pol_intensity(system, port_rays(jrays), WL,
                                      state=t_state("H"))
    x, y = out.x * out.i, out.y * out.i
    merit = ((x - x.mean()) ** 2 + (y - y.mean()) ** 2).mean()
    merit.backward()
    assert float(merit.detach()) == pytest.approx(float(value), rel=1e-12)
    assert_grads(leaves, jgrad)


@pytest.mark.parametrize("state", STATES)
def test_optic_trace_and_exit_fields_match_jax(state, unrolled):
    jo = tps.pol_doublet("jax", state)
    to = tps.pol_doublet("torch", state)
    rj = jo.trace(Hy=1.0, num_rays=5)
    rt = to.trace(Hy=1.0, num_rays=5)
    assert_rays(rt, rj, fields=("x", "y", "z", "L", "M", "N", "i", "opd"))
    assert_p(rt.p, rj.p)
    np.testing.assert_allclose(rt.history["i0"].numpy(),
                               np.asarray(rj.history["i0"]), rtol=1e-12)
    for a, b in zip(rt.get_exit_fields(to.polarization_state),
                    rj.get_exit_fields(jo.polarization_state)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-12)
    # without a history: the same polarized intensity
    rt2 = to.trace(Hy=1.0, num_rays=5, record=False)
    torch.testing.assert_close(rt2.i, rt.i, rtol=1e-12, atol=1e-14)


def test_support_and_errors():
    fresnel = tps.build("fresnel", "torch").system
    absorbing = tps.pol_doublet("torch", coat=tps.tmm_coating(
        "torch", absorbing=True)).system
    assert pt._coat_kinds(fresnel, WL) == ("none", "fresnel", "fresnel",
                                           "none")
    assert pt._coat_kinds(absorbing, WL)[1] == "unsupported"
    assert not pt.kernel_eligible(absorbing, WL)
    tmm = tps.build("tmm", "torch").system
    assert pt._coat_kinds(tmm, WL)[1] == ("tmm", 2)
    assert pt.build_coat_table(tmm, WL, torch.float64, "cpu").shape == (4, 6)
    # a high-index incidence medium gives internal evanescence: not eligible
    low = tps.pol_doublet("torch", coat=tps.tmm_coating("torch",
                                                        substrate=0.9))
    assert not pt.pol_supported(low.system, WL)
    from optiland_torch.core import raygen

    rays = raygen.generate_rays(absorbing, 0.0, 0.5, torch.zeros(3),
                                torch.zeros(3), WL)
    with pytest.raises(ValueError, match="kernel-eligible"):
        pt.trace_fast_pol(absorbing, rays, WL)
    # the plain engine traces it
    out, hist = ttrace.trace(absorbing, rays, record=False)
    assert torch.isfinite(hist["p"]).all()
    # a tilted system runs on the kernels' plain versions, and agrees with
    # the plain engine
    rx = torch.zeros(4, dtype=torch.float64)
    rx[1] = 0.01
    tilted = fresnel.replace(stack=fresnel.stack.replace(rx=rx))
    assert pt.pol_spec(tilted, WL)[5] == (False, True, False, False)
    frays = raygen.generate_rays(fresnel, 0.0, 0.5, torch.zeros(3),
                                 torch.zeros(3), WL)
    out, p = pt.trace_fast_pol(tilted, frays, WL)
    ref, hist = ttrace.trace(tilted.replace(cfg=dataclasses.replace(
        tilted.cfg, has_tilts=True)), frays, record=False)
    torch.testing.assert_close(out.y, ref.y, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(p, hist["p"], rtol=1e-10, atol=1e-12)
