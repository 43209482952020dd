"""optiland_torch's annular apertures (kernel K6a) against the JAX package,
on the CPU in float64, where the wrappers run the kernels' plain versions.

  * ``RadialAperture``: its clip and dict form equal to the JAX package's;
    the other aperture shapes raise until they are ported;
  * ``system_from_numpy`` carries RadialAperture records and refuses any
    other aperture object;
  * HubbleTelescope (r_min 177.8 mm on the primary, EPD 2400 mm, the
    0.15 degree field): the clip mask of ``trace_fast`` (the plain version
    of K5a) equal to the JAX package's kernel in interpret mode, with the
    obscuration clipping rays; rays to rtol 1e-9 with 2e-8 mm absolute on
    positions and OPD (the JAX test's tolerance at the metre scale);
  * the plain engine (``core.trace``: the aperture object's clip),
    ``Optic.trace`` and ``rms_spot_size`` against the JAX package's XLA
    path, and ``spot_rms_fast_field`` with explicit samples against its
    kernel, to the same tolerances (the merit counts every ray, clipped or
    not, in both packages).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_pol_systems as tps
from optiland_torch import config
from optiland_torch import physical_apertures as tap
from optiland_torch.analysis import rms_spot_size
from optiland_torch.core import raygen as traygen
from optiland_torch.core import trace as ttrace
from optiland_torch.core.rays import RealRays as TRays
from optiland_torch.ops import fast_trace as ftr
from optiland_torch.ops import fused_trace as ft
from optiland_torch.ops import launch
from optiland_torch.samples import registry
from optiland_tpu import physical_apertures as jap
from optiland_tpu.analysis import spot as jspot
from optiland_tpu.core import raygen as jraygen
from optiland_tpu.core import trace as jtrace
from optiland_tpu.ops import pallas_trace as jpt
from optiland_tpu.samples import HubbleTelescope as JHubble

WL = 0.55
H = (0.0, 1.0)
FIELDS = ftr.RAY_FIELDS
POSITIONS = ("x", "y", "z", "opd")


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


def pupil(n, seed):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n)) * 0.98
    th = rng.uniform(0, 2 * np.pi, size=n)
    return r * np.cos(th), r * np.sin(th)


def np_of(v):
    return v.detach().numpy() if torch.is_tensor(v) else np.asarray(v)


def assert_metre(got, ref, names=FIELDS):
    for k in names:
        np.testing.assert_allclose(
            np_of(getattr(got, k)), np.asarray(getattr(ref, k)), rtol=1e-9,
            atol=2e-8 if k in POSITIONS else 1e-12, err_msg=k)


def test_radial_aperture_matches_jax():
    rng = np.random.default_rng(1)
    x, y = rng.uniform(-3, 3, 500), rng.uniform(-3, 3, 500)
    i = rng.uniform(0.5, 1, 500)
    for r_max, r_min in ((2.5, 0.0), (2.5, 1.0), (np.inf, 0.7)):
        a, b = tap.RadialAperture(r_max, r_min), jap.RadialAperture(r_max,
                                                                    r_min)
        got = a.clip(torch.tensor(i), torch.tensor(x), torch.tensor(y))
        ref = b.clip(jnp.asarray(i), jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert a.to_dict() == b.to_dict()
        c = tap.BaseAperture.from_dict(b.to_dict())
        assert type(c) is tap.RadialAperture and c.to_dict() == a.to_dict()
        assert a.extent == b.extent
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        tap.OffsetRadialAperture(2.0, 0.5, 0.1, 0.0)
    with pytest.raises(NotImplementedError, match="later slice"):
        tap.BaseAperture.from_dict(
            jap.OffsetRadialAperture(2.0, 0.5, 0.1, 0.0).to_dict())


def test_system_from_numpy_carries_radial_apertures():
    jsys = JHubble().system
    tsys = tps.carried(jsys)
    aps = tsys.cfg.apertures
    assert [type(a).__name__ if a else None for a in aps] == [
        type(a).__name__ if a else None for a in jsys.cfg.apertures]
    assert aps[2].r_min == pytest.approx(177.80035) and aps[2].r_max == np.inf
    assert launch.covered(tsys.cfg) and launch.inner_flags(tsys.cfg) == (
        False, False, True, False, False)
    spec = ftr.fast_spec(tsys, field=True)
    assert spec[-2] == launch.inner_flags(tsys.cfg)
    assert launch.build_of(spec[0], spec[3], spec[-2]) == launch.SAG
    # the columns the kernels read: r_max, r_min of the aperture object
    p = ft.build_param_table(tsys, WL)
    assert float(p[2, 13]) == pytest.approx(177.80035)
    assert float(p[2, 4]) == np.inf
    # another aperture object is refused
    off = jsys.replace(cfg=jsys.cfg.__class__(**{
        **{f: getattr(jsys.cfg, f) for f in jsys.cfg.__dataclass_fields__},
        "apertures": (None, None, jap.OffsetRadialAperture(1e3, 1.0, 5.0),
                      None, None)}))
    with pytest.raises(NotImplementedError, match="apertures"):
        tps.carried(off)


@pytest.fixture(scope="module")
def jax_hubble():
    """HubbleTelescope in the JAX package: a launch bundle, its kernel's
    output (interpret mode), its XLA path, and the merit and spot size."""
    mp = pytest.MonkeyPatch()
    mp.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    lens = JHubble()
    jsys = lens.system
    Px, Py = pupil(300, 2)
    jPx, jPy = jnp.asarray(Px), jnp.asarray(Py)
    rays = jraygen.generate_rays(jsys, *H, jPx, jPy, WL)
    out = {"Px": Px, "Py": Py, "rays": rays,
           "fast": jpt.trace_fast(jsys, rays, WL),
           "xla": jtrace.trace(jsys, rays, record=False)[0],
           "merit": float(jpt.spot_rms_fast_field(jsys, *H, WL, Px=jPx,
                                                  Py=jPy)),
           "rms": float(jspot.rms_spot_size(jsys, *H, jPx, jPy, WL)),
           "optic": lens.trace(Hy=1.0, num_rays=6, record=False)}
    mp.undo()
    return out


def port_rays(jrays):
    return TRays(**{k: torch.tensor(np.asarray(getattr(jrays, k)))
                    for k in FIELDS + ("w",)})


def test_hubble_clip_matches_jax_kernel(jax_hubble):
    tsys = registry.build_sample("HubbleTelescope").system
    got = ftr.trace_fast(tsys, port_rays(jax_hubble["rays"]), WL)
    ref = jax_hubble["fast"]
    mask = np.asarray(ref.i) > 0
    np.testing.assert_array_equal(np_of(got.i) > 0, mask)
    r2 = jax_hubble["Px"] ** 2 + jax_hubble["Py"] ** 2
    assert (~mask & (r2 < 0.1)).any()  # the obscuration clips rays
    assert_metre(got, ref)


def test_hubble_end_to_end_matches_jax(jax_hubble):
    tlens = registry.build_sample("HubbleTelescope")
    tsys = tlens.system
    final, _ = ttrace.trace(tsys, port_rays(jax_hubble["rays"]),
                            record=False)
    assert_metre(final, jax_hubble["xla"])
    np.testing.assert_array_equal(np_of(final.i) > 0,
                                  np.asarray(jax_hubble["fast"].i) > 0)
    assert_metre(tlens.trace(Hy=1.0, num_rays=6, record=False),
                 jax_hubble["optic"])
    Px, Py = (torch.tensor(a) for a in (jax_hubble["Px"], jax_hubble["Py"]))
    v = rms_spot_size(tsys, *H, Px, Py, WL)
    assert float(v) == pytest.approx(jax_hubble["rms"], rel=1e-9)
    m = ft.spot_rms_fast_field(tsys, *H, WL, Px=Px, Py=Py)
    assert float(m) == pytest.approx(jax_hubble["merit"], rel=1e-9)
    assert float(m) == pytest.approx(float(v) ** 2, rel=1e-9)
    rays = traygen.generate_rays(tsys, *H, Px, Py, WL)
    assert torch.equal(ttrace.trace(tsys, rays, record=True)[1]["x"][-1],
                       ttrace.trace(tsys, rays, record=False)[0].x)
