"""optiland_torch's sample registry (``samples/registry.py``: the JAX
package's ``samples.json`` read in place) and the deep systems it brings to
the kernels, on the CPU in float64.

  * every sample the port builds has every stack leaf equal to the JAX
    package's build of it (rtol 1e-14; no trace is compiled) and the same
    structure; every sample it does not build raises NotImplementedError
    naming what it lacks (ray aiming, object-height fields);
  * depth: ObjectiveUS008879901 (26 surfaces) is covered by the kernels'
    deep build, and the plain version of their forward (``trace_fast``)
    agrees with the JAX package's XLA path on its unrolled engine (rtol
    1e-9, atol 1e-10 on positions and OPD of ~0.5 m paths).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch.core.rays import RealRays as TRays
from optiland_torch.core.system import STACK_FIELDS, SYSTEM_FIELDS
from optiland_torch.ops import fast_trace as ftr
from optiland_torch.ops import launch
from optiland_torch.samples import registry
from optiland_tpu.core import raygen as jraygen
from optiland_tpu.core import trace as jtrace
from optiland_tpu.samples import registry as jregistry

NAMES = sorted(registry.SAMPLE_SPECS)


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


@pytest.mark.parametrize("name", NAMES)
def test_registry_matches_jax(name):
    if registry.missing(name):
        with pytest.raises(NotImplementedError,
                           match="ray aiming|fields"):
            registry.build_sample(name)
        return
    t, j = registry.build_sample(name).system, jregistry.build_sample(
        name).system
    for k in STACK_FIELDS:
        a, b = getattr(t.stack, k).numpy(), np.asarray(getattr(j.stack, k))
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=0, err_msg=k)
    for k in SYSTEM_FIELDS:
        np.testing.assert_allclose(getattr(t, k).numpy(),
                                   np.asarray(getattr(j, k)), rtol=1e-14,
                                   err_msg=k)
    for f in ("num_surfaces", "stop_index", "obj_infinite", "geom_codes",
              "mat_formulas", "reflective", "has_absorption",
              "aperture_type", "field_type", "primary_index"):
        assert getattr(t.cfg, f) == getattr(j.cfg, f), f
    assert [a and a.to_dict() for a in t.cfg.apertures] == [
        a and a.to_dict() for a in j.cfg.apertures]
    # every sample the port builds runs on the kernels (past 16 surfaces
    # on the deep build)
    assert launch.covered(t.cfg)


def test_registry_raises_naming_what_is_missing():
    missing = {n: registry.missing(n) for n in NAMES}
    assert {n for n, m in missing.items() if m} == {
        "ProjectionLens120FOV", "ProjectionLens160FOV", "WideAngle100FOV",
        "WideAngle170FOV", "UVProjectionLens"}
    with pytest.raises(NotImplementedError, match="set_ray_aiming"):
        registry.build_sample("WideAngle170FOV")
    with pytest.raises(NotImplementedError, match="object_height"):
        registry.build_sample("UVProjectionLens")


def test_deep_plain_trace_matches_jax(monkeypatch):
    monkeypatch.setenv("OPTILAND_TPU_TRACE_ENGINE", "unrolled")
    name = "ObjectiveUS008879901"
    tsys = registry.build_sample(name).system
    jsys = jregistry.build_sample(name).system
    assert tsys.cfg.num_surfaces == 26
    spec = ftr.fast_spec(tsys, field=True)
    assert spec is not None
    assert launch.build_of(spec[0], spec[3], spec[-2]) == launch.DEEP
    rng = np.random.default_rng(3)
    r = np.sqrt(rng.uniform(size=120)) * 0.95
    th = rng.uniform(0, 2 * np.pi, size=120)
    Px, Py = jnp.asarray(r * np.cos(th)), jnp.asarray(r * np.sin(th))
    wl = float(jsys.wavelengths[jsys.cfg.primary_index])
    jrays = jraygen.generate_rays(jsys, 0.0, 0.7, Px, Py, wl)
    ref, _ = jtrace.trace(jsys, jrays, record=False)
    rays = TRays(**{k: torch.tensor(np.asarray(getattr(jrays, k)))
                    for k in ftr.RAY_FIELDS + ("w",)})
    got = ftr.trace_fast(tsys, rays, wl)
    for k in ftr.RAY_FIELDS:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-9,
                                   atol=1e-10, err_msg=k)
    assert (np.asarray(ref.i) > 0).all()
