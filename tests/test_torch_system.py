"""optiland_torch's system model, materials and launch side against the JAX
package, on the CPU in float64.

The same prescription goes through both packages; data passes between them
as numpy arrays. Tolerances: arrays built from the same numbers are equal;
index and paraxial values agree to rtol 1e-14/1e-12 (the same formulas,
evaluated in another order at most).
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optiland_torch
from optiland_torch import config
from optiland_torch.core import paraxial as t_paraxial
from optiland_torch.core import raygen as t_raygen
from optiland_torch.core.system import (
    STACK_FIELDS, SYSTEM_FIELDS, interp, k_all, k_of, n_all, scalar_like,
    static_tensor, system_from_numpy,
)
from optiland_torch.materials import dispersion as t_disp
from optiland_torch.samples import CookeTriplet as TorchCooke
from optiland_tpu.core import paraxial as j_paraxial
from optiland_tpu.core import raygen as j_raygen
from optiland_tpu.core import system as j_system
from optiland_tpu.materials import dispersion as j_disp
from optiland_tpu.samples import CookeTriplet as JaxCooke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield
    config.set_device("cpu")
    config.set_precision("float64")


@pytest.fixture(scope="module")
def jax_cooke():
    return JaxCooke().system


def jax_to_numpy(system):
    """The carry-across inputs: every leaf as numpy, the config as a dict."""
    arrays = {k: np.asarray(getattr(system.stack, k)) for k in STACK_FIELDS}
    arrays.update({k: np.asarray(getattr(system, k)) for k in SYSTEM_FIELDS})
    cfg = {f.name: getattr(system.cfg, f.name)
           for f in dataclasses.fields(system.cfg)}
    return arrays, cfg


def test_import_blocks_jax_and_optiland_tpu():
    """Every module of the port imports, CookeTriplet builds, traces and
    gives a Huygens PSF, and a polarized optic traces and gives a vectorial
    PSF, with jax and optiland_tpu made unimportable."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "optiland_tpu"):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import optiland_torch
        for m in pkgutil.walk_packages(optiland_torch.__path__,
                                       "optiland_torch."):
            importlib.import_module(m.name)
        optiland_torch.set_device("cpu")
        from optiland_torch.samples import CookeTriplet
        lens = CookeTriplet()
        assert lens.system.stack.radius.shape == (8,)
        res = lens.trace(num_rays=3)
        assert res.x.shape == (37,) and res.history["x"].shape == (8, 37)
        from optiland_torch.psf import HuygensPSF
        psf = HuygensPSF(lens, (0.0, 0.7), 0.55, num_rays=8, image_size=4)
        assert psf.psf.shape == (4, 4) and 0 < psf.strehl_ratio() <= 1.2
        # the polarized path: a coated optic, its trace and vectorial PSF
        from optiland_torch.optic import Optic
        o = Optic()
        o.surfaces.add(index=0, radius=float("inf"), thickness=float("inf"))
        o.surfaces.add(index=1, radius=50.0, thickness=5.0,
                       material="N-BK7", is_stop=True, coating="fresnel")
        o.surfaces.add(index=2, radius=-50.0, thickness=45.0,
                       coating="fresnel")
        o.surfaces.add(index=3)
        o.set_aperture("EPD", 4.0)
        o.fields.add(y=0)
        o.wavelengths.add(0.55, is_primary=True)
        o.set_polarization("H")
        r = o.trace(num_rays=3)
        assert r.p.shape == (37, 3, 3)
        vpsf = HuygensPSF(o, (0.0, 0.0), 0.55, num_rays=8, image_size=4)
        assert type(vpsf).__name__ == "VectorialHuygensPSF"
        print(float(lens.paraxial.f2()))
        assert not any(k.split(".")[0] in ("jax", "optiland_tpu")
                       for k in sys.modules)
        """
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert abs(float(out.stdout.strip()) - 49.99978307143) < 1e-10


def test_building_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config.set_device("cuda")
    with pytest.raises(RuntimeError, match=r"set_device\('cpu'\)"):
        TorchCooke().system


def test_config_knobs():
    assert config.get_device() == "cpu" and config.dtype() == torch.float64
    config.set_precision("float32")
    assert config.dtype() == torch.float32
    assert config.get_precision() == "float32"
    assert TorchCooke().system.stack.radius.dtype == torch.float32
    with pytest.raises(ValueError):
        config.set_precision("bfloat16")
    with pytest.raises(ValueError):
        config.set_device("mps")
    assert optiland_torch.set_device is config.set_device


def test_cooke_arrays_equal_jax(jax_cooke):
    port = TorchCooke().system
    for k in STACK_FIELDS:
        a = np.asarray(getattr(jax_cooke.stack, k))
        b = getattr(port.stack, k).numpy()
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    for k in SYSTEM_FIELDS:
        np.testing.assert_array_equal(getattr(port, k).numpy(),
                                      np.asarray(getattr(jax_cooke, k)))
    assert dataclasses.astuple(port.cfg) == dataclasses.astuple(jax_cooke.cfg)
    assert port.cfg.geom_codes == (0, 1, 1, 1, 1, 1, 1, 0)
    assert port.cfg.mat_formulas == (0, 3, 0, 2, 0, 3, 0, 0)
    assert port.cfg.has_absorption


@pytest.mark.parametrize("wl", [0.48, 0.55, 0.65])
def test_n_all_matches_jax(jax_cooke, wl):
    port = TorchCooke().system
    a = np.asarray(j_system.n_all(jax_cooke.stack, jax_cooke.cfg, wl))
    b = n_all(port.stack, port.cfg, wl).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-14, atol=0)


def test_f2_matches_verify_value():
    assert abs(float(TorchCooke().paraxial.f2()) - 49.99978307143) < 1e-10


def test_pupil_scalars_and_abcd_match_jax(jax_cooke):
    port = TorchCooke().system
    epl_j, epd_j = j_paraxial.pupil_scalars(jax_cooke)
    epl_t, epd_t = t_paraxial.pupil_scalars(port)
    np.testing.assert_allclose(float(epl_t), float(epl_j), rtol=1e-12)
    np.testing.assert_allclose(float(epd_t), float(epd_j), rtol=1e-12)
    np.testing.assert_allclose(
        t_paraxial.abcd_prefix(port).numpy(),
        np.asarray(j_paraxial.abcd_prefix(jax_cooke)), rtol=1e-12, atol=1e-14,
    )
    ys_j, us_j = j_paraxial.trace_generic(jax_cooke, 1.0, 0.1, -5.0,
                                          reverse=True, skip=1)
    ys_t, us_t = t_paraxial.trace_generic(port, 1.0, 0.1, -5.0,
                                          reverse=True, skip=1)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-12)
    np.testing.assert_allclose(us_t.numpy(), np.asarray(us_j), rtol=1e-12)


@pytest.mark.parametrize("H", [(0.0, 0.0), (0.0, 0.7), (0.3, -0.9)])
def test_vig_factor_matches_jax(jax_cooke, H):
    port = TorchCooke().system
    a = j_raygen.get_vig_factor(jax_cooke, jnp.asarray(H[0]),
                                jnp.asarray(H[1]))
    b = t_raygen.get_vig_factor(port, H[0], H[1])
    assert [float(v) for v in b] == [float(v) for v in a]


def test_system_from_numpy_matches(jax_cooke):
    arrays, cfg = jax_to_numpy(jax_cooke)
    carried = system_from_numpy(arrays, cfg)
    port = TorchCooke().system
    for k in STACK_FIELDS:
        assert torch.equal(getattr(carried.stack, k), getattr(port.stack, k)), k
    for k in SYSTEM_FIELDS:
        assert torch.equal(getattr(carried, k), getattr(port, k)), k
    assert carried.cfg == port.cfg
    assert hash(carried.cfg) == hash(port.cfg)


@pytest.mark.parametrize("field", ["coatings", "apertures", "interactions",
                                   "bsdfs", "geom_aux"])
def test_system_from_numpy_rejects_objects(jax_cooke, field):
    arrays, cfg = jax_to_numpy(jax_cooke)
    vals = list(cfg[field])
    vals[2] = ("thin_lens",) if field == "interactions" else object()
    cfg[field] = tuple(vals)
    with pytest.raises(NotImplementedError, match=field):
        system_from_numpy(arrays, cfg)


def test_system_from_numpy_requires_every_array(jax_cooke):
    arrays, cfg = jax_to_numpy(jax_cooke)
    del arrays["ktab"]
    with pytest.raises(KeyError, match="ktab"):
        system_from_numpy(arrays, cfg)


def test_k_of_matches_jax(jax_cooke):
    port = TorchCooke().system
    for s in range(port.cfg.num_surfaces):
        for wl in (0.3, 0.48, 0.55, 0.9, 30.0):
            a = float(j_system.k_of(jax_cooke.stack.ktab[s], jnp.asarray(wl)))
            b = float(k_of(port.stack.ktab[s], wl))
            assert b == pytest.approx(a, rel=1e-14, abs=0), (s, wl)


def test_k_all_matches_k_of_per_row(jax_cooke):
    port = TorchCooke().system
    for wl in (0.3, 0.48, 0.55, 0.9, 30.0):
        a = np.array([float(j_system.k_of(jax_cooke.stack.ktab[s],
                                          jnp.asarray(wl)))
                      for s in range(port.cfg.num_surfaces)])
        b = k_all(port.stack, wl).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-14, atol=0)


def test_batched_interp_matches_each_row():
    rng = np.random.default_rng(1)
    xp = np.sort(rng.uniform(0, 10, (4, 9)), axis=1)
    xp[2, 3] = xp[2, 2]  # a zero-width interval in one row
    fp = rng.normal(size=(4, 9))
    x = rng.uniform(-1, 11, (4, 6))
    got = interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp))
    assert got.shape == (4, 6)
    for r in range(4):
        want = np.asarray(jnp.interp(jnp.asarray(x[r]), jnp.asarray(xp[r]),
                                     jnp.asarray(fp[r])))
        np.testing.assert_allclose(got[r].numpy(), want, rtol=1e-14,
                                   atol=1e-15)


def test_scalar_like_and_static_tensor():
    like = torch.zeros(3, dtype=torch.float32)
    s = scalar_like(0.55, like)
    assert s.shape == () and s.dtype == torch.float32 and float(s) == \
        pytest.approx(0.55)
    assert scalar_like(np.float64(2.0), like).dtype == torch.float32
    assert scalar_like([1.0, 2.0], like).shape == (2,)
    t = torch.tensor(3.0, dtype=torch.float64)
    assert scalar_like(t, like).dtype == torch.float32
    m = static_tensor((True, False, True), torch.bool, "cpu")
    assert m.dtype == torch.bool and m.tolist() == [True, False, True]
    assert static_tensor([True, False, True], torch.bool, "cpu") is m
    codes = static_tensor((0, 1, 1, 0), torch.int32, "cpu")
    assert codes.dtype == torch.int32 and codes.tolist() == [0, 1, 1, 0]


def test_interp_matches_jnp_interp():
    rng = np.random.default_rng(0)
    xp = np.sort(rng.uniform(0, 10, 12))
    xp[5] = xp[4]  # a zero-width interval, which jnp.interp guards
    fp = rng.normal(size=12)
    x = np.concatenate([rng.uniform(-1, 11, 50), xp])
    a = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    b = interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-14, atol=1e-15)


_FORMULA_CASES = {
    j_disp.CONST_N: [1.7],
    j_disp.FORMULA_1: [0.1, 1.03, 0.07, 0.23, 0.14, 1.01, 10.2],
    j_disp.FORMULA_2: [0.0, 1.03, 0.006, 0.23, 0.02, 1.01, 103.5],
    j_disp.FORMULA_3: [2.27, -0.01, 2, 0.012, -2, 0.0002, -4],
    j_disp.FORMULA_4: [2.1, 0.02, 2, 0.3, 2, 0.01, 1, 0.2, 2, 0.001, 2],
    j_disp.FORMULA_5: [1.5, 0.004, -2, 0.0001, -4],
    j_disp.FORMULA_6: [0.0, 0.0581, 238.0, 0.0017, 57.4],
    j_disp.FORMULA_7: [1.6, 0.006, 0.0002, -0.001, 1e-5],
    j_disp.FORMULA_8: [0.2, 0.1, 0.01, -0.001],
    j_disp.FORMULA_9: [2.3, 0.02, 0.05, 0.01, 0.9, 0.3],
    j_disp.BUCHDAHL: [1.62, -0.1, 0.03, -0.01, 0.5876, 2.5],
}


@pytest.mark.parametrize("code", sorted(_FORMULA_CASES))
def test_dispersion_formulas_match_jax(code):
    c = t_disp.pad_coefficients(_FORMULA_CASES[code])
    w = np.array([0.45, 0.55, 0.7, 1.2])
    a = np.asarray(j_disp.n_formula_static(code, jnp.asarray(c),
                                           jnp.asarray(w)))
    b = t_disp.n_formula_static(code, torch.tensor(c), torch.tensor(w)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-14)


@pytest.mark.parametrize("code", sorted(_FORMULA_CASES))
def test_scalar_term_dispersion_matches_jax(code):
    """The per-term form the polychromatic kernels evaluate, on scalar
    coefficients as the kernels read them, against the JAX package's."""
    c = t_disp.pad_coefficients(_FORMULA_CASES[code])
    w = np.array([0.45, 0.55, 0.7, 1.2])
    a = np.asarray(j_disp.n_formula_scalar_terms(
        code, [float(v) for v in c], jnp.asarray(w)))
    b = t_disp.n_formula_scalar_terms(
        code, torch.tensor(c).unbind(), torch.tensor(w)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-14)
    with pytest.raises(NotImplementedError, match="scalar-term"):
        t_disp.n_formula_scalar_terms(t_disp.TABULATED_N, c, torch.tensor(w))


def test_unported_surface_types_raise():
    lens = TorchCooke()
    with pytest.raises(NotImplementedError, match="grid_sag"):
        lens.surfaces.add(index=2, surface_type="grid_sag")
    # Optic.trace is ported; the image-height field types are not yet
    lens.fields.set_type("paraxial_image_height")
    with pytest.raises(NotImplementedError, match="later slice"):
        lens.trace()


def test_real_rays_create_broadcasts():
    from optiland_torch.core.rays import RealRays

    x = torch.linspace(-1, 1, 5, dtype=torch.float64)
    rays = RealRays.create(x, 0.5, 0.0, 0.0, 0.0, 1.0, 1.0, 0.55)
    assert rays.num_rays == 5
    assert rays.y.shape == (5,) and rays.y.dtype == torch.float64
    assert torch.equal(rays.opd, torch.zeros(5, dtype=torch.float64))


@pytest.mark.parametrize("fn", ["conic_sag", "normal_standard",
                                "distance_standard", "distance_plane"])
def test_geometry_matches_jax(fn):
    from optiland_torch.core import geometry as t_geom
    from optiland_tpu.core import geometry as j_geom

    rng = np.random.default_rng(11)
    n = 64
    x, y = rng.uniform(-4, 4, n), rng.uniform(-4, 4, n)
    z = rng.uniform(-1, 1, n)
    L, M = rng.uniform(-0.2, 0.2, n), rng.uniform(-0.2, 0.2, n)
    N = np.sqrt(1 - L**2 - M**2)
    R, k = 22.0, -0.6
    args = {
        "conic_sag": ((R, k, x**2 + y**2), "_conic_sag"),
        "normal_standard": ((R, k, x, y), "_normal_standard"),
        "distance_standard": ((R, k, x, y, z, L, M, N), "_distance_standard"),
        "distance_plane": ((x, y, z, L, M, N), "_distance_plane"),
    }[fn]
    a = getattr(j_geom, args[1])(*(jnp.asarray(v) for v in args[0]))
    b = getattr(t_geom, args[1])(
        *(torch.as_tensor(v, dtype=torch.float64) for v in args[0]))
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for u, v in zip(b, a):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), rtol=1e-13,
                                   atol=1e-15)


def test_unsupported_geometry_codes_raise():
    from optiland_torch.core import geometry as t_geom

    x = torch.zeros(3, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="grid sag"):
        t_geom.surface_normal_static(t_geom.GRID_SAG, 10.0, 0.0, None, x, x)
    with pytest.raises(NotImplementedError, match="grid sag"):
        t_geom.distance_static(t_geom.GRID_SAG, 10.0, 0.0, x, x, x, x, x,
                               x + 1)
