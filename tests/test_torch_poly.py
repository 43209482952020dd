"""optiland_torch's polychromatic trace (``ops/fast_trace.trace_fast_poly``,
the poly mode of kernels K5a and K5b) against the JAX package, on the CPU
in float64, where the wrappers run the kernels' plain versions.

  * ``n_formula_scalar_terms``, the per-term dispersion form the kernels
    evaluate, for every formula code it covers (0-9 and 11) on a catalog
    row of each code (codes 0 and 11 have none: a constant and a Buchdahl
    glass), against JAX's to rtol 1e-14; its derivative with respect to
    every coefficient, written by hand for the kernels' adjoint, against
    ``jax.jacrev`` of JAX's to rtol 1e-10 (atol 1e-12 x the largest entry:
    derivatives that vanish but for rounding);
  * ``trace_fast_poly`` against JAX's ``trace_fast_poly`` (its Pallas
    kernel in interpret mode, as the JAX suite runs it) on the Cooke
    triplet and on the JAX suite's Abbe doublet carried across with a
    tilted surface, at wavelengths 0.48/0.55/0.65 um cycling by ray:
    outputs to rtol 1e-8 / atol 1e-10, the JAX test's tolerance;
  * the gradient of a merit over the traced rays with respect to every
    stack leaf, ``mat_coeffs`` included, to rtol 1e-8 with atol 1e-12 x the
    largest entry wherever JAX's is finite. The JAX kernels' gradient in
    interpret mode takes two minutes to compile on the CPU; JAX's XLA path
    with the same per-ray wavelengths computes the same function (the
    per-ray index of the same formulas, the tilts' rotations) and is the
    reference. The Cooke triplet carries k data, which the XLA path applies
    and the polychromatic kernels do not (as in the JAX package), so its
    merit reads no intensity.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch.core import raygen as traygen
from optiland_torch.core.rays import RealRays as TRays
from optiland_torch.core.system import (
    STACK_FIELDS, SYSTEM_FIELDS, system_from_numpy,
)
from optiland_torch.materials import dispersion as t_disp
from optiland_torch.ops import fast_trace as ftr
from optiland_torch.samples import CookeTriplet as TCooke
from optiland_torch.samples import perturbed
from optiland_tpu.core import raygen as jraygen
from optiland_tpu.core import trace as jtrace
from optiland_tpu.materials import dispersion as j_disp
from optiland_tpu.ops import pallas_trace as jpt
from optiland_tpu.samples import CookeTriplet as JCooke
from tests.torch_shared import SharedRefs

H = (0.0, 0.7)
N_RAYS = 96
WLS = (0.48, 0.55, 0.65)
FIELDS = ftr.RAY_FIELDS
CODES = (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 11)


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield
    config.set_device("cpu")
    config.set_precision("float64")


# ---------------------------------------------------------------------------
# The scalar-term dispersion and its hand derivative
# ---------------------------------------------------------------------------


def _coefficients(code):
    """The padded coefficients of the first catalog row of ``code`` whose
    index is finite over the test wavelengths."""
    if code == t_disp.CONST_N:
        return t_disp.pad_coefficients([1.7])
    if code == t_disp.BUCHDAHL:
        return t_disp.pad_coefficients([1.62, -0.1, 0.03, -0.01, 0.5876,
                                        2.5])
    return perturbed.catalog_row(code, _W, n_range=(-np.inf, np.inf))


_W = np.array([0.42, 0.48, 0.55, 0.65, 0.9])


@pytest.mark.parametrize("code", CODES)
def test_scalar_terms_match_jax(code):
    c = _coefficients(code)
    a = np.asarray(j_disp.n_formula_scalar_terms(
        code, [float(v) for v in c], jnp.asarray(_W)))
    b = t_disp.n_formula_scalar_terms(code, torch.tensor(c).unbind(),
                                      torch.tensor(_W)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-14)


@pytest.mark.parametrize("code", CODES)
def test_scalar_term_derivative_matches_jax_grad(code):
    c = _coefficients(code)

    def n_of(cv):
        return j_disp.n_formula_scalar_terms(
            code, [cv[i] for i in range(cv.shape[0])], jnp.asarray(_W))

    ref = np.asarray(jax.jacrev(n_of)(jnp.asarray(c)))  # (wavelengths, nm)
    n, dn = t_disp.n_formula_scalar_grad(code, torch.tensor(c).unbind(),
                                         torch.tensor(_W))
    got = np.stack([np.zeros(len(_W)) if v is None else v.numpy()
                    for v in dn], axis=1)
    np.testing.assert_allclose(n.numpy(), np.asarray(n_of(jnp.asarray(c))),
                               rtol=1e-14)
    # NaN where JAX's is (d(x^y)/dx at x = y = 0, the reference's own)
    np.testing.assert_allclose(got, ref, rtol=1e-10,
                               atol=1e-12 * np.nanmax(np.abs(ref)))
    # None marks exactly the coefficients the formula does not read
    for j, v in enumerate(dn):
        if v is None:
            assert (ref[:, j] == 0).all(), j


# ---------------------------------------------------------------------------
# trace_fast_poly against the JAX package
# ---------------------------------------------------------------------------


def _abbe_doublet():
    """The JAX suite's Abbe doublet (tests/test_pallas_trace.py), with its
    second surface tilted and decentred."""
    from optiland_tpu.materials import AbbeMaterial
    from optiland_tpu.optic import Optic

    lens = Optic("abbe doublet")
    lens.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    lens.surfaces.add(index=1, radius=30.0, thickness=4.0,
                      material=AbbeMaterial(1.5168, 64.17), is_stop=True)
    lens.surfaces.add(index=2, radius=-25.0, thickness=2.0,
                      material=AbbeMaterial(1.6727, 32.2), rx=0.004,
                      ry=-0.002, dy=0.03)
    lens.surfaces.add(index=3, radius=-80.0, thickness=40.0)
    lens.surfaces.add(index=4)
    lens.set_aperture("EPD", 10.0)
    lens.fields.add(y=0)
    lens.fields.add(y=1)
    lens.wavelengths.add(0.55, is_primary=True)
    return lens.system


def carried(jsys):
    arrays = {k: np.asarray(getattr(jsys.stack, k)) for k in STACK_FIELDS}
    arrays.update({k: np.asarray(getattr(jsys, k)) for k in SYSTEM_FIELDS})
    cfg = {f.name: getattr(jsys.cfg, f.name)
           for f in dataclasses.fields(jsys.cfg)}
    return system_from_numpy(arrays, cfg)


def pupil(n=N_RAYS, seed=5):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n)) * 0.95
    th = rng.uniform(0, 2 * np.pi, size=n)
    return r * np.cos(th), r * np.sin(th)


def wavelengths(n=N_RAYS):
    return np.tile(WLS, -(-n // 3))[:n]


def merit_of(m, f, with_i):
    """Spot size, path and directions, and (with_i) the transmission."""
    v = (m.mean(f.x**2 + f.y**2) + 1e-3 * m.mean(f.opd)
         + m.mean(f.L * f.M) + 0.1 * m.mean(f.N))
    return v + 0.3 * m.mean(f.i) if with_i else v


SYSTEMS = {"cooke": (lambda: JCooke().system, False),
           "abbe": (_abbe_doublet, True)}


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """Per system and part, each when a test first reads it (once per
    session: ``torch_shared.SharedRefs``): "fast", its launch bundle with
    per-ray wavelengths and JAX's trace_fast_poly of it (interpret mode);
    "grads", the value and gradient of the merit through JAX's XLA path."""
    return SharedRefs(tmp_path_factory, "poly", _jax_ref)


def _jax_ref(key):
    name, part = key
    build, with_i = SYSTEMS[name]
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    Px, Py = (jnp.asarray(a) for a in pupil())
    w = jnp.asarray(wavelengths())
    # the tilt gate open: under jax.grad the kernels keep the rotation
    # code, and so give the zero-tilt derivatives
    jsys = build()
    jsys = jsys.replace(cfg=dataclasses.replace(jsys.cfg, has_tilts=True))
    if part == "fast":
        rays = jraygen.generate_rays(jsys, *H, Px, Py, 0.55).replace(w=w)
        out = dict(rays=rays, fast=jpt.trace_fast_poly(jsys, rays))
    else:

        def merit(stack):
            s = jsys.replace(stack=stack)
            r = jraygen.generate_rays(s, *H, Px, Py, w)
            f, _ = jtrace.trace(s, r, record=False)
            return merit_of(jnp, f, with_i)

        val, g = jax.value_and_grad(merit)(jsys.stack)
        out = dict(value=float(val),
                   grads={k: np.asarray(getattr(g, k)) for k in STACK_FIELDS})
    mp.undo()
    return out


def port_system(name):
    return TCooke().system if name == "cooke" else carried(_abbe_doublet())


def np_of(v):
    return v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)


def test_poly_spec_and_support():
    cooke = TCooke().system
    spec = ftr.poly_spec(cooke)
    assert spec[:4] == ftr.fast_spec(cooke)[:4]
    assert spec[4] == (0, 3, 0, 2, 0, 3, 0, 0)
    assert spec[5:] == ftr.fast_spec(cooke)[4:]
    # the Cooke triplet carries k data: the kernels trace it (without its
    # absorption), but it is no pallas_supported(poly=True) system
    assert cooke.cfg.has_absorption and not ftr.poly_supported(cooke)
    assert ftr.poly_supported(carried(_abbe_doublet()))
    tab = cooke.replace(cfg=dataclasses.replace(
        cooke.cfg, mat_formulas=(0, t_disp.TABULATED_N) + (0,) * 6))
    assert ftr.poly_spec(tab) is None
    rays = traygen.generate_rays(cooke, *H, torch.zeros(3), torch.zeros(3),
                                 0.55)
    with pytest.raises(NotImplementedError, match="trace_fast_poly"):
        ftr.trace_fast_poly(tab, rays)


@pytest.mark.parametrize("name", SYSTEMS)
def test_trace_fast_poly_matches_jax_kernel(jax_refs, name):
    ref = jax_refs[name, "fast"]
    rays = TRays(**{k: torch.tensor(np.asarray(getattr(ref["rays"], k)))
                    for k in FIELDS + ("w",)})
    out = ftr.trace_fast_poly(port_system(name), rays)
    for k in FIELDS:
        np.testing.assert_allclose(np_of(getattr(out, k)),
                                   np.asarray(getattr(ref["fast"], k)),
                                   rtol=1e-8, atol=1e-10, err_msg=k)
    np.testing.assert_array_equal(np_of(out.w), wavelengths())
    # the wavelengths differ per ray, and the trace sees them: the same
    # bundle at one wavelength lands elsewhere
    mono = ftr.trace_fast(port_system(name), rays, 0.55)
    assert float((mono.y - out.y).abs().max()) > 1e-6


@pytest.mark.parametrize("name", SYSTEMS)
def test_trace_fast_poly_gradients_match_jax(jax_refs, name):
    ref = jax_refs[name, "grads"]
    with_i = SYSTEMS[name][1]
    system = port_system(name)
    leaves = {k: v.detach().clone().requires_grad_(v.numel() > 0)
              for k, v in system.stack.leaves().items()}
    s2 = system.replace(stack=system.stack.replace(**leaves))
    Px, Py = (torch.tensor(a) for a in pupil())
    w = torch.tensor(wavelengths())
    rays = traygen.generate_rays(s2, *H, Px, Py, w)
    f = ftr.trace_fast_poly(s2, rays)
    val = merit_of(torch, f, with_i)
    val.backward()
    assert float(val.detach()) == pytest.approx(ref["value"], rel=1e-10)
    got = {k: (np.zeros(tuple(v.shape)) if v.grad is None
               else v.grad.numpy()) for k, v in leaves.items()}
    scale = max(float(np.abs(v[np.isfinite(v)]).max(initial=0))
                for v in ref["grads"].values())
    for k in STACK_FIELDS:
        if k == "ktab":  # the XLA path absorbs, the poly kernels do not
            continue
        fin = np.isfinite(ref["grads"][k])
        np.testing.assert_allclose(got[k][fin], ref["grads"][k][fin],
                                   rtol=1e-8, atol=1e-12 * scale, err_msg=k)
    g = got["mat_coeffs"]
    assert np.abs(g[np.isfinite(g)]).max() > 0
    # the padded Sellmeier-2 terms of the Cooke triplet's glasses get
    # nonzero gradients, as in the JAX package (d n / d B = 1 / (2 n))
    if name == "cooke":
        assert (g[3, 11:18:2] != 0).all()
    else:
        assert np.abs(got["rx"][2]) > 0 and np.abs(got["dy"][2]) > 0


def test_poly_adjoint_matches_autograd():
    """The hand adjoint of the polychromatic chain (trace_bwd_poly's plain
    version) against autograd of its forward, on the Cooke triplet with two
    tilted surfaces, random per-ray wavelengths, intensities and
    cotangents (rtol 1e-10: sums of 200 terms in another order)."""
    system = TCooke().system
    rx = torch.zeros(8, dtype=torch.float64)
    rx[2], rx[5] = 2e-3, -1e-3
    system = system.replace(stack=system.stack.replace(rx=rx))
    spec = ftr.poly_spec(system)
    assert spec[3][2] and spec[3][5]
    rng = np.random.default_rng(17)
    Px, Py = (torch.tensor(a) for a in pupil(200, 9))
    rays = traygen.generate_rays(system, *H, Px, Py, 0.55)
    ins = [getattr(rays, k).detach().contiguous() for k in FIELDS]
    ins[6] = torch.tensor(rng.uniform(0.5, 1, 200))
    ins[7] = torch.tensor(rng.uniform(0, 1, 200))
    ins.append(torch.tensor(rng.uniform(0.45, 0.7, 200)))
    cots = [torch.tensor(rng.normal(size=200)) for _ in range(8)]
    with torch.no_grad():
        params = ftr.build_poly_table(system)
    mats = system.stack.mat_coeffs.detach().clone()
    S, nm, nc = 8, mats.shape[1], 1
    p = params.clone().requires_grad_()
    m = mats.clone().requires_grad_()
    insg = [t.clone().requires_grad_() for t in ins[:8]]
    out = ftr.trace_fwd_poly_plain(p, m, spec, insg + ins[8:])
    loss = sum((o * c).sum() for o, c in zip(out, cots))
    auto = torch.autograd.grad(loss, [p, m] + insg)
    din, flat = ftr.trace_bwd_poly(params, mats, spec, nc, ins, cots)
    ref = torch.cat([auto[0].reshape(-1), torch.zeros(S * nc),
                     auto[1].reshape(-1)])
    fin = torch.isfinite(ref)
    torch.testing.assert_close(flat[fin], ref[fin], rtol=1e-10,
                               atol=1e-12 * float(ref[fin].abs().max()))
    assert flat.shape == (S * (15 + nc + nm),)
    for k in range(8):
        torch.testing.assert_close(din[k], auto[2 + k], rtol=1e-10,
                                   atol=1e-12 * float(auto[2 + k].abs().max()
                                                      + 1))
    # the CPU wrappers ran the plain versions and launched nothing
    assert sum(ftr.LAUNCHES.values()) == 0
