"""optiland_torch's generic and field traces (``ops/fast_trace.py``) against
the JAX package, on the CPU in float64.

On the CPU every op wrapper runs its kernel's plain PyTorch version, so
these tests hold the plain versions of K1, K4, K5a and K5b, their
hand-derived adjoints and the op layer around them to the JAX package:

  * the forward values to JAX's ``trace_fast`` / ``trace_fast_field``, run
    in interpret mode as the JAX package's own tests run them, once per
    module, at 300 rays;
  * the gradients to the JAX path of the same kind. The JAX kernels'
    gradient (``jax.grad`` through the Pallas backward in interpret mode)
    takes minutes to compile on the CPU; it equals the XLA path's once the
    tilt gate is opened (``has_tilts=True``: under ``jax.grad`` the kernels
    keep the rotation code) and every medium attenuates (under ``jax.grad``
    the kernels' absorption mask sees traced k tables and keeps every
    exp), so the XLA path with ``has_tilts=True`` is the reference;
  * ``rms_spot_size`` end to end to JAX's, value and gradient.

Tolerances: forward values to rtol 1e-9 with atol 1e-12 x each array's
largest entry; stack-leaf gradients to rtol 1e-8 with atol 1e-12 x the
largest entry wherever the JAX gradient is finite; the hand adjoint to
autograd to rtol 1e-10 with atol 1e-12 x the largest entry (sums of 300
terms in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch.analysis import SpotData, rms_spot_size
from optiland_torch.core import geometry as geom
from optiland_torch.core import raygen as traygen
from optiland_torch.core import trace as ttrace
from optiland_torch.core.system import STACK_FIELDS
from optiland_torch.ops import fast_trace as ftr
from optiland_torch.ops import fused_trace as ft
from optiland_torch.ops import step
from optiland_torch.optic import Optic as TOptic
from optiland_torch.samples import CookeTriplet as TCooke
from optiland_tpu.analysis import spot as jspot
from optiland_tpu.core import raygen as jraygen
from optiland_tpu.core import trace as jtrace
from optiland_tpu.ops import pallas_trace as jpt
from optiland_tpu.optic import Optic as JOptic
from optiland_tpu.samples import CookeTriplet as JCooke
from tests.torch_shared import SharedRefs, shared

H = (0.0, 0.7)
WL = 0.55
N_RAYS = 300
KINDS = ("cooke", "mirror", "vignetted")


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield
    config.set_device("cpu")
    config.set_precision("float64")


def mirror(cls):
    """A concave conic mirror focusing an on-axis bundle (the reflect
    branch of the trace and of its adjoint)."""
    lens = cls()
    lens.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    lens.surfaces.add(index=1, radius=-200.0, thickness=-100.0,
                      material="mirror", is_stop=True, conic=-0.5)
    lens.surfaces.add(index=2)
    lens.set_aperture(aperture_type="EPD", value=20)
    lens.fields.set_type(field_type="angle")
    lens.fields.add(y=0)
    lens.fields.add(y=1)
    lens.wavelengths.add(value=0.55, is_primary=True)
    return lens


def vignetted(cls):
    """The Cooke triplet with a 2 mm semi-aperture at the stop (the clip)."""
    lens = cls()
    lens.surfaces.surfaces[4].aperture = 4.0
    lens._invalidate()
    return lens


def build(kind, package):
    cooke, optic = {"torch": (TCooke, TOptic), "jax": (JCooke, JOptic)}[package]
    return {"cooke": cooke, "mirror": lambda: mirror(optic),
            "vignetted": lambda: vignetted(cooke)}[kind]().system


def pupil(n=N_RAYS, seed=3):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return r * np.cos(th), r * np.sin(th)


def np_of(v):
    return v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)


def assert_rays(port, ref, rtol=1e-9):
    for k in ftr.RAY_FIELDS:
        a, b = np_of(getattr(port, k)), np_of(getattr(ref, k))
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=1e-12 * np.abs(b).max(), err_msg=k)


# ---------------------------------------------------------------------------
# Forward: the plain K5a and K1 against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_forward(tmp_path_factory):
    """JAX trace_fast and trace_fast_field for each system, and the launch
    bundle trace_fast was given (per system, once per session:
    ``torch_shared.SharedRefs``)."""
    return SharedRefs(tmp_path_factory, "fast_forward", _jax_forward)


def _jax_forward(kind):
    Px, Py = (jnp.asarray(a) for a in pupil())
    jsys = build(kind, "jax")
    rays = jraygen.generate_rays(jsys, *H, Px, Py, WL)
    return {
        "rays": rays,
        "fast": jpt.trace_fast(jsys, rays, WL),
        "field": jpt.trace_fast_field(jsys, *H, Px, Py, WL),
    }


def bundle_of(jrays):
    """The port's RealRays of the JAX launch bundle (exactly its values)."""
    from optiland_torch.core.rays import RealRays

    t = {k: torch.tensor(np.asarray(getattr(jrays, k)))
         for k in ftr.RAY_FIELDS + ("w",)}
    return RealRays(**t)


@pytest.mark.parametrize("kind", KINDS)
def test_trace_fast_matches_jax_kernel(jax_forward, kind):
    ref = jax_forward[kind]
    system = build(kind, "torch")
    out = ftr.trace_fast(system, bundle_of(ref["rays"]), WL)
    assert_rays(out, ref["fast"])
    np.testing.assert_array_equal(np_of(out.w), np.asarray(ref["fast"].w))
    if kind == "vignetted":
        i = np_of(out.i)
        assert (i == 0).any() and (i > 0).any()


@pytest.mark.parametrize("kind", KINDS)
def test_trace_fast_field_matches_jax_kernel(jax_forward, kind):
    ref = jax_forward[kind]["field"]
    Px, Py = (torch.tensor(a) for a in pupil())
    out = ftr.trace_fast_field(build(kind, "torch"), *H, Px, Py, WL)
    assert_rays(out, ref)
    np.testing.assert_array_equal(np_of(out.w), np.asarray(ref.w))


def test_fast_paths_agree_with_the_reference_trace():
    """trace_fast = trace(record=False) and trace_fast_field =
    generate_rays + trace on the same system (rtol 1e-9: the field launch
    is the closed form of the paraxial aim)."""
    system = build("vignetted", "torch")
    Px, Py = (torch.tensor(a) for a in pupil())
    rays = traygen.generate_rays(system, *H, Px, Py, WL)
    ref, _ = ttrace.trace(system, rays, record=False)
    assert_rays(ftr.trace_fast(system, rays, WL), ref)
    assert_rays(ftr.trace_fast_field(system, *H, Px, Py, WL), ref)


# ---------------------------------------------------------------------------
# Gradients against the JAX path of the same kind
# ---------------------------------------------------------------------------


def merit_of(m, f):
    """A merit over every traced quantity: spot size, transmission, path."""
    return m.mean(f.x**2 + f.y**2) + 0.3 * m.mean(f.i) + 1e-3 * m.mean(f.opd)


@pytest.fixture(scope="module")
def jax_grads(tmp_path_factory):
    """jax.value_and_grad over every stack leaf of generate_rays + the XLA
    trace with the tilt gate open (the kernels' gradient), per system (once
    per session: ``torch_shared.SharedRefs``)."""
    return SharedRefs(tmp_path_factory, "fast_grads", _jax_grads)


def _jax_grads(kind):
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    Px, Py = (jnp.asarray(a) for a in pupil())
    jsys = build(kind, "jax")
    jsys = jsys.replace(cfg=dataclasses.replace(jsys.cfg, has_tilts=True))

    def merit(stack):
        s = jsys.replace(stack=stack)
        rays = jraygen.generate_rays(s, *H, Px, Py, WL)
        f, _ = jtrace.trace(s, rays, record=False)
        return merit_of(jnp, f)

    val, g = jax.value_and_grad(merit)(jsys.stack)
    mp.undo()
    return float(val), {k: np.asarray(getattr(g, k)) for k in STACK_FIELDS}


def with_leaves(system, skip=()):
    leaves = {k: v.detach().clone().requires_grad_(v.numel() > 0
                                                   and k not in skip)
              for k, v in system.stack.leaves().items()}
    return system.replace(stack=system.stack.replace(**leaves)), leaves


def grads_of(leaves):
    return {k: (np.zeros(tuple(v.shape)) if v.grad is None
                else v.grad.numpy()) for k, v in leaves.items()}


def assert_grads(got, ref, rtol=1e-8, leaves=STACK_FIELDS):
    scale = max(float(np.abs(v[np.isfinite(v)]).max(initial=0))
                for v in ref.values())
    for k in leaves:
        fin = np.isfinite(ref[k])
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k][fin], ref[k][fin], rtol=rtol,
                                   atol=1e-12 * scale, err_msg=k)


def run_entry(entry, system):
    Px, Py = (torch.tensor(a) for a in pupil())
    if entry == "trace_fast":
        rays = traygen.generate_rays(system, *H, Px, Py, WL)
        return ftr.trace_fast(system, rays, WL)
    return ftr.trace_fast_field(system, *H, Px, Py, WL)


@pytest.mark.parametrize("kind", ["cooke", "vignetted"])
@pytest.mark.parametrize("entry", ["trace_fast", "trace_fast_field"])
def test_gradients_match_jax(jax_grads, entry, kind):
    s2, leaves = with_leaves(build(kind, "torch"))
    val = merit_of(torch, run_entry(entry, s2))
    val.backward()
    ref_val, ref = jax_grads[kind]
    assert float(val.detach()) == pytest.approx(ref_val, rel=1e-10)
    got = grads_of(leaves)
    assert_grads(got, ref)
    # the zero-tilt derivatives are there, as under the JAX kernels' grad
    assert np.abs(got["rx"][1:-1]).max() > 0


def test_absorption_mask_follows_the_k_values():
    """From the values (and equal to the JAX package's mask) when the k
    tables are not differentiated; every surface when they are. The other
    leaves' gradients do not depend on it."""
    system = build("cooke", "torch")
    codes, refl, absorbs, tilted = ftr.fast_spec(system)[:4]
    assert tilted == (False,) * 8
    jmask = jpt._absorption_mask(build("cooke", "jax"))
    assert absorbs == tuple(jmask) == (False, False, True, False, True,
                                       False, True, False)
    s2, leaves = with_leaves(system)
    assert ftr.fast_spec(s2)[2] == (False,) + (True,) * 7
    with torch.no_grad():
        assert ftr.fast_spec(s2)[2] == absorbs
    no_abs = system.replace(cfg=dataclasses.replace(system.cfg,
                                                    has_absorption=False))
    assert ftr.fast_spec(no_abs)[2] == (False,) * 8
    # gradients of the other leaves with the mask read from the values
    a, la = with_leaves(system, skip=("ktab",))
    merit_of(torch, run_entry("trace_fast", a)).backward()
    b, lb = with_leaves(system)
    merit_of(torch, run_entry("trace_fast", b)).backward()
    ga, gb = grads_of(la), grads_of(lb)
    for k in STACK_FIELDS:
        if k != "ktab":
            fin = np.isfinite(gb[k])
            np.testing.assert_allclose(ga[k][fin], gb[k][fin], rtol=1e-12,
                                       atol=1e-300, err_msg=k)


def test_spec_and_support():
    system = build("cooke", "torch")
    assert ftr.fast_supported(system) and ftr.fast_supported(system, True)
    tilted = system.replace(stack=system.stack.replace(
        rx=system.stack.rx + torch.tensor([0, 0, 0.01, 0, 0, 0, 0, 0.0])))
    nan_tilt = system.replace(stack=system.stack.replace(
        rz=system.stack.rz + torch.tensor([0, float("nan")] + [0.0] * 6)))
    # tilted surfaces are flagged (a nonzero or non-finite angle) and traced
    assert ftr.fast_spec(tilted)[3] == (False, False, True) + (False,) * 5
    assert ftr.fast_spec(nan_tilt)[3] == (False, True) + (False,) * 6
    Px = torch.zeros(4, dtype=torch.float64)
    rays = traygen.generate_rays(system, *H, Px, Px, WL)
    ref, _ = ttrace.trace(tilted.replace(cfg=dataclasses.replace(
        tilted.cfg, has_tilts=True)), rays, record=False)
    assert_rays(ftr.trace_fast(tilted, rays, WL), ref)
    assert ftr.fast_supported(tilted, True)
    lens = TOptic()
    lens.surfaces.add(index=0, radius=np.inf, thickness=80.0)
    lens.surfaces.add(index=1, radius=35.0, thickness=6.0, material="N-BK7",
                      is_stop=True)
    lens.surfaces.add(index=2, radius=-35.0, thickness=60.0)
    lens.surfaces.add(index=3)
    lens.set_aperture("EPD", 8.0)
    lens.fields.add(y=0)
    lens.fields.add(y=5.0)
    lens.wavelengths.add(0.55, is_primary=True)
    finite = lens.system
    assert ftr.fast_supported(finite) and not ftr.fast_supported(finite, True)
    with pytest.raises(NotImplementedError, match="later slice"):
        ftr.trace_fast_field(finite, *H, Px, Px, WL)


# ---------------------------------------------------------------------------
# The hand adjoint against autograd
# ---------------------------------------------------------------------------


def _tables(system):
    with torch.no_grad():
        return ft.build_param_table(system, WL), ft.aim_vector(system, *H)


@pytest.mark.parametrize("code", [geom.PLANE, geom.STANDARD])
@pytest.mark.parametrize("refl", [False, True])
@pytest.mark.parametrize("absorbs", [False, True])
def test_full_step_adjoint_matches_autograd(code, refl, absorbs):
    """One full step (intensity, OPD, clip) on random states, per
    (code, reflective, absorbs), against autograd of the plain step."""
    rng = np.random.default_rng(7)
    R = 200
    # radius, conic, pos, n_post, ap_max, k_pre (k / wavelength), dx, dy
    p = torch.tensor([-30.0, -0.6, 5.0, 1.62, 2.5, 2e-6, 0.1, -0.2,
                      0, 0, 0, 1, 1, 0, 0], dtype=torch.float64)
    n_pre = torch.tensor(1.0003, dtype=torch.float64)
    d = np.stack([rng.normal(0, 0.1, R), rng.normal(0, 0.1, R),
                  np.ones(R)])
    d /= np.linalg.norm(d, axis=0)
    st = [torch.tensor(rng.normal(0, 2, R)), torch.tensor(rng.normal(0, 2, R)),
          torch.tensor(rng.normal(-1, 0.2, R))]
    st += [torch.tensor(v) for v in d]
    st += [torch.tensor(rng.uniform(0.2, 1, R)),
           torch.tensor(rng.uniform(0, 3, R))]
    g = [torch.tensor(rng.normal(size=R)) for _ in range(9)]
    g[6] = torch.tensor(rng.normal(size=R))  # n_next cotangent

    pl = p.clone().requires_grad_()
    npl = n_pre.clone().requires_grad_()
    sl = [t.clone().requires_grad_() for t in st]
    out, n_next = step.step_plain(code, refl, pl, npl, tuple(sl), absorbs)
    assert 0 < int((out[6] == 0).sum()) < R  # the clip runs
    outs = list(out[:6]) + [n_next] + list(out[6:])
    loss = sum((o * c).sum() for o, c in zip(outs, g))
    auto = torch.autograd.grad(loss, [pl, npl] + sl, allow_unused=True)
    g_in, g_npre, cols = step.step_adjoint_plain(code, refl, p, n_pre,
                                                 tuple(st), tuple(g), absorbs)
    hand_p = torch.zeros(step.NUM_P, dtype=torch.float64)
    for col, v in zip(step.FULL_GRAD_COLS, cols):
        hand_p[col] = v.sum()
    ref_p = auto[0]
    np.testing.assert_allclose(hand_p.numpy(), ref_p.numpy(), rtol=1e-10,
                               atol=1e-12 * float(ref_p.abs().max()))
    assert float(g_npre.sum()) == pytest.approx(float(auto[1]), rel=1e-10)
    for k in range(8):
        ref = auto[2 + k]
        ref = torch.zeros(R, dtype=torch.float64) if ref is None else ref
        np.testing.assert_allclose(g_in[k].numpy(), ref.numpy(), rtol=1e-10,
                                   atol=1e-12 * float(ref.abs().max() + 1),
                                   err_msg=str(k))


@pytest.mark.parametrize("kind", KINDS)
def test_chain_adjoints_match_autograd(kind):
    system = build(kind, "torch")
    spec = ftr.fast_spec(system)
    params, aim = _tables(system)
    S, nc = len(spec[0]), 1
    rng = np.random.default_rng(11)
    Px, Py = (torch.tensor(a) for a in pupil())
    cots = [torch.tensor(rng.normal(size=N_RAYS)) for _ in range(8)]

    # field (K4)
    p, a = params.clone().requires_grad_(), aim.clone().requires_grad_()
    out = ftr.trace_fast_field_plain(p, a, spec, Px, Py)
    loss = sum((o * c).sum() for o, c in zip(out, cots))
    gp, ga = torch.autograd.grad(loss, [p, a])
    hand = ftr.trace_field_bwd(params, aim, spec, nc, Px, Py, cots)
    ref = torch.cat([gp.reshape(-1), torch.zeros(S * nc), ga])
    np.testing.assert_allclose(hand.numpy(), ref.numpy(), rtol=1e-10,
                               atol=1e-12 * float(ref.abs().max()))
    dp = hand[: S * step.NUM_P].reshape(S, step.NUM_P)
    other = [c for c in range(step.NUM_P) if c not in step.FULL_GRAD_COLS]
    assert torch.count_nonzero(dp[:, other]) == 0

    # generic (K5b), from a bundle with random intensities and paths
    rays = traygen.generate_rays(system, *H, Px, Py, WL)
    ins = [getattr(rays, k).detach().contiguous() for k in ftr.RAY_FIELDS]
    ins[6] = torch.tensor(rng.uniform(0.5, 1, N_RAYS))
    ins[7] = torch.tensor(rng.uniform(0, 1, N_RAYS))
    p = params.clone().requires_grad_()
    insg = [t.clone().requires_grad_() for t in ins]
    out = ftr.trace_fast_plain(p, spec, insg)
    loss = sum((o * c).sum() for o, c in zip(out, cots))
    auto = torch.autograd.grad(loss, [p] + insg)
    din, flat = ftr.trace_bwd(params, spec, nc, ins, cots)
    ref = torch.cat([auto[0].reshape(-1), torch.zeros(S * nc)])
    np.testing.assert_allclose(flat.numpy(), ref.numpy(), rtol=1e-10,
                               atol=1e-12 * float(ref.abs().max()))
    for k in range(8):
        np.testing.assert_allclose(din[k].numpy(), auto[1 + k].numpy(),
                                   rtol=1e-10,
                                   atol=1e-12 * float(auto[1 + k].abs().max()),
                                   err_msg=ftr.RAY_FIELDS[k])


def test_cpu_wrappers_run_the_plain_versions():
    ftr.reset_launch_counts()
    system = build("cooke", "torch")
    spec = ftr.fast_spec(system)
    params, aim = _tables(system)
    Px, Py = (torch.tensor(a) for a in pupil(50))
    out = ftr.trace_field_fwd(params, aim, spec, Px, Py)
    ref = ftr.trace_fast_field_plain(params, aim, spec, Px, Py)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert all(torch.equal(a, b) for a, b in
               zip(ftr.trace_fwd(params, spec, out),
                   ftr.trace_fast_plain(params, spec, out)))
    assert ftr.LAUNCHES == {
        **{k: 0 for n in ("trace_fwd", "trace_bwd", "trace_field_fwd",
                          "trace_field_bwd", "trace_fwd_poly",
                          "trace_bwd_poly")
           for k in (n, n + "_tilt", n + "_sag", n + "_free", n + "_deep",
                     n + "_deep_free", n + "_aux", n + "_deep_aux",
                     n + "_nurbs")},
        # the grating build: the monochromatic kernels only
        **{n + "_grat": 0 for n in ("trace_fwd", "trace_bwd",
                                    "trace_field_fwd", "trace_field_bwd")}}
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        ftr.trace_fwd(params.to("meta"), spec, out)


# ---------------------------------------------------------------------------
# rms_spot_size end to end
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_rms(tmp_path_factory):
    """rms_spot_size's value, gradient and spot through JAX's XLA path
    (once per session, ``torch_shared.shared``)."""
    val, grads, xyi = shared(tmp_path_factory, "fast_rms", _jax_rms)
    return val, grads, jspot.SpotData(*(jnp.asarray(a) for a in xyi))


def _jax_rms():
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    jsys = JCooke().system
    Px, Py = (jnp.asarray(a) for a in pupil())

    def f(stack):
        return jspot.rms_spot_size(jsys.replace(stack=stack), *H, Px, Py, WL)

    val, g = jax.value_and_grad(f)(jsys.stack)
    x, y, i = jspot.spot_coordinates(jsys, *H, Px, Py, WL)
    ref = (float(val), {k: np.asarray(getattr(g, k)) for k in STACK_FIELDS},
           (x, y, i))
    mp.undo()
    return ref


def test_rms_spot_size_matches_jax(jax_rms):
    s2, leaves = with_leaves(build("cooke", "torch"))
    Px, Py = (torch.tensor(a) for a in pupil())
    val = rms_spot_size(s2, *H, Px, Py, WL)
    val.backward()
    ref_val, ref, ref_spot = jax_rms
    assert float(val.detach()) == pytest.approx(ref_val, rel=1e-10)
    assert_grads(grads_of(leaves), ref)
    from optiland_torch.analysis import spot_coordinates

    spot = SpotData(*spot_coordinates(build("cooke", "torch"), *H, Px, Py,
                                      WL))
    assert spot.rms_radius() == pytest.approx(ref_spot.rms_radius(),
                                              rel=1e-10)
    assert spot.geometric_radius() == pytest.approx(
        ref_spot.geometric_radius(), rel=1e-10)
    np.testing.assert_allclose(spot.centroid, ref_spot.centroid, rtol=1e-9,
                               atol=1e-12)
