"""optiland_torch's reference trace against the JAX package, on the CPU in
float64: pupil distributions, ``generate_rays``, ``core.trace.trace`` (with
and without history), ``Optic.trace`` / ``trace_generic``, and the
stack-leaf gradient of a merit over the traced rays.

The JAX side runs its XLA path with the unrolled engine
(``OPTILAND_TPU_TRACE_ENGINE=unrolled``: for the 8-surface Cooke triplet the
JAX package would otherwise pick its scan engine, which the port does not
have); each reference is computed once per module. The reference goldens
(``tests/goldens/cooke.npz``, from the original Optiland) are a second
check.

Tolerances: rays and history to rtol 1e-8, atol 1e-9, as the JAX package's
own golden tests; the generated launch bundle to rtol 1e-12 (the same
formulas); every stack-leaf gradient to rtol 1e-8 with atol 1e-12 x the
largest entry wherever the JAX gradient is finite (it is NaN in the object
row's radius and in the object/image rows' index coefficient, the
reference's own behaviour, ROADMAP Queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch.core import distributions as tdist
from optiland_torch.core import raygen as traygen
from optiland_torch.core import trace as ttrace
from optiland_torch.core.rays import RealRays
from optiland_torch.core.system import STACK_FIELDS
from optiland_torch.optic import Optic as TOptic
from optiland_torch.samples import CookeTriplet as TCooke
from optiland_tpu.core import distributions as jdist
from optiland_tpu.core import raygen as jraygen
from optiland_tpu.core import trace as jtrace
from optiland_tpu.optic import Optic as JOptic
from optiland_tpu.samples import CookeTriplet as JCooke

# the golden cases of tests/test_trace.py: (Hx, Hy, wavelength, rings)
CASES = {
    "onaxis": (0.0, 0.0, 0.55, 6),
    "field1": (0.0, 1.0, 0.55, 6),
    "field07_blue": (0.0, 0.7, 0.48, 5),
    "fieldx": (0.5, 0.5, 0.65, 4),
}
COMPONENTS = ("x", "y", "z", "L", "M", "N", "i", "opd")
HISTORY = ("x", "y", "z", "L", "M", "N", "intensity", "opd")


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield
    config.set_device("cpu")
    config.set_precision("float64")


@pytest.fixture(scope="module")
def unrolled():
    """The JAX package's unrolled engine, for the whole module."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    yield
    mp.undo()


def vignetted(cls):
    """The Cooke triplet with a 2 mm semi-aperture at the stop."""
    lens = cls()
    lens.surfaces.surfaces[4].aperture = 4.0
    lens._invalidate()
    return lens


def finite_singlet(cls):
    """A singlet imaging an object 80 mm away (finite conjugates)."""
    o = cls()
    o.surfaces.add(index=0, radius=np.inf, thickness=80.0)
    o.surfaces.add(index=1, radius=35.0, thickness=6.0, material="N-BK7",
                   is_stop=True)
    o.surfaces.add(index=2, radius=-35.0, thickness=60.0)
    o.surfaces.add(index=3)
    o.set_aperture("EPD", 8.0)
    o.fields.set_type("angle")
    o.fields.add(y=0)
    o.fields.add(y=5.0)
    o.wavelengths.add(0.55, is_primary=True)
    return o


def np_of(v):
    if torch.is_tensor(v):
        return v.detach().numpy()
    return np.asarray(v)


def assert_rays(port, ref, rtol=1e-8, atol=1e-9, fields=COMPONENTS):
    for k in fields:
        np.testing.assert_allclose(np_of(getattr(port, k)),
                                   np_of(getattr(ref, k)), rtol=rtol,
                                   atol=atol, err_msg=k)


# ---------------------------------------------------------------------------
# Distributions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(tdist._DISTRIBUTIONS))
@pytest.mark.parametrize("n", [1, 6, 11])
def test_distribution_matches_jax(name, n):
    if name in ("random", "sobol"):
        cls = name.capitalize() + "Distribution"
        a = getattr(tdist, cls)(seed=5).generate_points(n)
        b = getattr(jdist, cls)(seed=5).generate_points(n)
    else:
        a = tdist.create_distribution(name).generate_points(n)
        b = jdist.create_distribution(name).generate_points(n)
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.y, b.y)
    if name == "gaussian_quad":
        np.testing.assert_array_equal(a.weights, b.weights)


def test_distribution_errors():
    with pytest.raises(ValueError, match="Invalid distribution"):
        tdist.create_distribution("spiral")
    with pytest.raises(ValueError, match="rings or spokes"):
        tdist.GaussianQuadrature().generate_points(0)
    hexa = tdist.create_distribution("hexapolar").generate_points(3)
    assert hexa.x.shape == (1 + 3 * 3 * 4,)


# ---------------------------------------------------------------------------
# generate_rays
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("field", [(0.0, 0.0), (0.0, 0.7), (0.3, -1.0)])
@pytest.mark.parametrize("build", ["cooke", "finite"])
def test_generate_rays_matches_jax(field, build):
    jlens = JCooke() if build == "cooke" else finite_singlet(JOptic)
    tlens = TCooke() if build == "cooke" else finite_singlet(TOptic)
    rng = np.random.default_rng(1)
    Px, Py = rng.uniform(-1, 1, 40), rng.uniform(-1, 1, 40)
    ref = jraygen.generate_rays(jlens.system, *field, jnp.asarray(Px),
                                jnp.asarray(Py), 0.55)
    got = traygen.generate_rays(tlens.system, *field, torch.tensor(Px),
                                torch.tensor(Py), 0.55)
    assert got.x.shape == (40,)
    assert_rays(got, ref, rtol=1e-12, atol=1e-13,
                fields=COMPONENTS + ("w",))
    # per-ray fields give the same rays as one broadcast field
    per_ray = traygen.generate_rays(tlens.system, np.full(40, field[0]),
                                    np.full(40, field[1]), Px, Py, 0.55)
    assert_rays(per_ray, got, rtol=0, atol=0)


def test_generate_rays_later_slices_raise():
    lens = TCooke()
    with pytest.raises(NotImplementedError, match="apodization"):
        traygen.generate_rays(lens.system, 0.0, 0.0, 0.0, 0.0, 0.55,
                              apodization=object())
    o = finite_singlet(TOptic)
    o.fields.set_type("object_height")
    with pytest.raises(NotImplementedError, match="later slice"):
        traygen.generate_rays(o.system, 0.0, 1.0, 0.0, 0.0, 0.55)


# ---------------------------------------------------------------------------
# trace and Optic.trace against the JAX package and the goldens
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_traces(unrolled):
    """JAX Optic.trace results (unrolled XLA engine) for the golden cases,
    the vignetted case, several fields and trace_generic."""
    out = {}
    lens = JCooke()
    for case, (Hx, Hy, wl, rings) in CASES.items():
        out[case] = lens.trace(Hx=Hx, Hy=Hy, wavelength=wl, num_rays=rings)
    out["vignetted"] = vignetted(JCooke).trace(Hy=1.0, num_rays=8)
    out["fields"] = lens.trace(Hx=[0.0, 0.2], Hy=[0.0, 1.0], num_rays=3,
                               record=False)
    out["generic"] = lens.trace_generic(
        Hx=[0.0, 0.1, 0.2], Hy=0.5, Px=[0.0, 0.3, -0.7], Py=0.2,
        wavelength=0.6, record=False,
    )
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_optic_trace_matches_jax_and_goldens(goldens, jax_traces, case):
    Hx, Hy, wl, rings = CASES[case]
    res = TCooke().trace(Hx=Hx, Hy=Hy, wavelength=wl, num_rays=rings,
                         distribution="hexapolar")
    ref = jax_traces[case]
    assert_rays(res, ref)
    g = goldens("cooke")
    for comp in COMPONENTS:
        np.testing.assert_allclose(np_of(getattr(res, comp)),
                                   g[f"{case}_{comp}"], rtol=1e-8, atol=1e-9,
                                   err_msg=comp)
    # history: every row against JAX, rows 1.. against the goldens (the
    # reference's launch row depends on its aim point)
    for comp in HISTORY:
        mine = np_of(res.history[comp])
        np.testing.assert_allclose(mine, np.asarray(ref.history[comp]),
                                   rtol=1e-8, atol=1e-9, err_msg=comp)
        if comp in ("x", "y", "z", "opd", "intensity"):
            gold = g[f"{case}_hist_{comp}"]
            assert mine.shape == gold.shape
            np.testing.assert_allclose(mine[1:], gold[1:], rtol=1e-8,
                                       atol=1e-9, err_msg=comp)


def test_vignetted_trace_matches_jax(jax_traces):
    res = vignetted(TCooke).trace(Hy=1.0, num_rays=8)
    assert_rays(res, jax_traces["vignetted"])
    i = np_of(res.i)
    assert (i == 0).any() and (i > 0).any()
    assert np.isfinite(np_of(res.x)).all()


def test_multi_field_and_generic_traces_match_jax(jax_traces):
    lens = TCooke()
    res = lens.trace(Hx=[0.0, 0.2], Hy=[0.0, 1.0], num_rays=3, record=False)
    assert res.x.shape == (2 * 37,) and res.history is None
    assert_rays(res, jax_traces["fields"])
    res = lens.trace_generic(Hx=[0.0, 0.1, 0.2], Hy=0.5, Px=[0.0, 0.3, -0.7],
                             Py=0.2, wavelength=0.6, record=False)
    assert_rays(res, jax_traces["generic"])
    assert float(res.w[0]) == 0.6
    assert lens.primary_wavelength == 0.55


def test_record_false_is_the_last_history_row():
    system = TCooke().system
    rays = traygen.generate_rays(system, 0.0, 0.7,
                                 torch.linspace(-1, 1, 9),
                                 torch.zeros(9), 0.55)
    final, hist = ttrace.trace(system, rays, record=True)
    fast, none = ttrace.trace(system, rays, record=False, wavelength=0.55)
    assert none is None
    assert hist["x"].shape == (8, 9)
    for k, name in zip(COMPONENTS, HISTORY):
        assert torch.equal(getattr(final, k), hist[name][-1])
        assert torch.equal(getattr(fast, k), getattr(final, k))
    assert torch.equal(hist["x"][0], rays.x)
    assert isinstance(final.replace(L0=rays.L), RealRays)


def _tilted(system, device="cpu"):
    """The system with a 0.01 rad tilt about x at surface 2, gate open."""
    rx = torch.zeros(system.cfg.num_surfaces, dtype=torch.float64)
    rx[2] = 0.01
    stack = system.stack.replace(rx=system.stack.rx + rx.to(device))
    return system.replace(stack=stack,
                          cfg=dataclasses.replace(system.cfg, has_tilts=True))


def test_record_false_traces_tilted_systems_on_the_cpu():
    # the kernels do not take tilts yet; on the CPU the plain engine traces
    # them with or without history
    system = _tilted(TCooke().system)
    rays = traygen.generate_rays(system, 0.0, 0.7,
                                 torch.linspace(-1, 1, 9),
                                 torch.zeros(9), 0.55)
    final, _ = ttrace.trace(system, rays, record=True)
    fast, none = ttrace.trace(system, rays, record=False, wavelength=0.55)
    untilted, _ = ttrace.trace(TCooke().system, rays, record=False,
                               wavelength=0.55)
    assert none is None
    for k in COMPONENTS:
        assert torch.equal(getattr(fast, k), getattr(final, k))
    assert not torch.allclose(fast.y, untilted.y)


def test_trace_later_slices_raise():
    system = TCooke().system
    rays = traygen.generate_rays(system, 0.0, 0.0, 0.0, 0.0, 0.55)
    for name in ("apertures", "interactions", "bsdfs"):
        vals = (None,) * 7 + (("x",),)
        bad = system.replace(cfg=dataclasses.replace(system.cfg,
                                                     **{name: vals}))
        with pytest.raises(NotImplementedError, match="later slice"):
            ttrace.trace(bad, rays)
    # coatings are ported (slice 4): a simple coating scales the intensity
    from optiland_torch.coatings import SimpleCoating

    coated = system.replace(cfg=dataclasses.replace(
        system.cfg, coatings=(None,) * 7 + (SimpleCoating(0.5),)))
    out, _ = ttrace.trace(coated, rays)
    ref, _ = ttrace.trace(system, rays)
    torch.testing.assert_close(out.i, 0.5 * ref.i)


# ---------------------------------------------------------------------------
# Gradients against jax.grad of the XLA trace
# ---------------------------------------------------------------------------

GRAD_FIELD = (0.0, 0.7)


def _pupil(n=64, seed=4):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n)) * 0.9
    th = rng.uniform(0, 2 * np.pi, n)
    return r * np.cos(th), r * np.sin(th)


def merit_of(m, x, y, i, opd):
    """A merit over every traced quantity: spot size, transmission, path."""
    return (m.mean(x**2 + y**2) + 0.3 * m.mean(i) + 1e-3 * m.mean(opd))


@pytest.fixture(scope="module")
def jax_trace_grads(unrolled):
    """jax.value_and_grad over every stack leaf of generate_rays + the XLA
    trace, for the Cooke triplet and its vignetted version."""
    out = {}
    Px, Py = (jnp.asarray(a) for a in _pupil())
    for kind, jsys in (("cooke", JCooke().system),
                       ("vignetted", vignetted(JCooke).system)):

        def merit(stack, jsys=jsys):
            s = jsys.replace(stack=stack)
            rays = jraygen.generate_rays(s, *GRAD_FIELD, Px, Py, 0.55)
            f, _ = jtrace.trace(s, rays, record=False)
            return merit_of(jnp, f.x, f.y, f.i, f.opd)

        val, g = jax.value_and_grad(merit)(jsys.stack)
        out[kind] = (float(val), {k: np.asarray(getattr(g, k))
                                  for k in STACK_FIELDS})
    return out


def with_leaves(system):
    leaves = {k: v.detach().clone().requires_grad_(v.numel() > 0)
              for k, v in system.stack.leaves().items()}
    return system.replace(stack=system.stack.replace(**leaves)), leaves


def port_grads(system, trace_fn):
    s2, leaves = with_leaves(system)
    Px, Py = (torch.tensor(a) for a in _pupil())
    val = trace_fn(s2, Px, Py)
    val.backward()
    return float(val.detach()), {
        k: (np.zeros(tuple(v.shape)) if v.grad is None else v.grad.numpy())
        for k, v in leaves.items()
    }


def assert_grads(got, ref, rtol=1e-8):
    scale = max(float(np.abs(v[np.isfinite(v)]).max(initial=0))
                for v in ref.values())
    for k in STACK_FIELDS:
        fin = np.isfinite(ref[k])
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k][fin], ref[k][fin], rtol=rtol,
                                   atol=1e-12 * scale, err_msg=k)


@pytest.mark.parametrize("kind", ["cooke", "vignetted"])
def test_trace_gradients_match_jax(jax_trace_grads, kind):
    system = (TCooke() if kind == "cooke" else vignetted(TCooke)).system

    def run(s, Px, Py):
        rays = traygen.generate_rays(s, *GRAD_FIELD, Px, Py, 0.55)
        f, _ = ttrace.trace(s, rays, record=False)
        return merit_of(torch, f.x, f.y, f.i, f.opd)

    val, grads = port_grads(system, run)
    ref_val, ref = jax_trace_grads[kind]
    assert val == pytest.approx(ref_val, rel=1e-12)
    assert_grads(grads, ref)
    # the XLA path applies Beer-Lambert on every surface, so every k table,
    # air's too, gets a gradient; its tilt gate is closed for this system
    assert (grads["ktab"][:7, :, 1] != 0).any(axis=1).all()
    assert not grads["rx"].any()
