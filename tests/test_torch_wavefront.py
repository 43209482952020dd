"""optiland_torch's wavefront analysis and pupil functions against the JAX
package, on the CPU in float64.

``compute_wavefront_data`` for the three strategies, both reference types
and two fields, on the same pupil samples (numpy, seeded): every length to
1e-10 mm and rtol 1e-10 (the same formulas on the same trace, which agrees
with the JAX package's to a few rounding units). The OPD is compared as a length too
(waves times the wavelength): it divides differences of ~75 mm optical
paths by 0.55e-3 mm, so a few rounding units of the path (1e-13 mm) read
~2e-10 waves. ``Wavefront`` against the reference
goldens ``wf_*`` of ``tests/goldens/wave_cooke.npz`` at the JAX suite's own
tolerances (``tests/test_wavefront_psf.py``). ``EPL``, ``XPL`` and ``EPD``
for the four aperture types to rtol 1e-12.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch.optic import Optic as TOptic
from optiland_torch.samples import CookeTriplet as TCooke
from optiland_torch.wavefront import Wavefront as TWavefront
from optiland_torch.wavefront import WavefrontData
from optiland_torch.wavefront import compute_wavefront_data as t_wavefront
from optiland_torch.wavefront import fit_and_remove_tilt as t_fit
from optiland_tpu.core import paraxial as jparaxial
from optiland_tpu.optic import Optic as JOptic
from optiland_tpu.samples import CookeTriplet as JCooke
from optiland_tpu.wavefront import compute_wavefront_data as j_wavefront
from optiland_tpu.wavefront import fit_and_remove_tilt as j_fit

ARRAYS = ("pupil_x", "pupil_y", "pupil_z", "opd", "intensity")


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


def _pupil(n=48, seed=11):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n)) * 0.95
    th = rng.uniform(0, 2 * np.pi, n)
    return r * np.cos(th), r * np.sin(th)


def _close(got, ref, scale=1.0, what=""):
    """|got - ref| <= 1e-10 (1 + |ref|), both in mm after ``scale``."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got * scale, np.asarray(ref) * scale,
                               rtol=1e-10, atol=1e-10, err_msg=what)


@functools.lru_cache(maxsize=None)
def jax_wavefront(strategy, ref, hy):
    """JAX's wavefront data of one case (each test computes only its own:
    under --dist load a module fixture of all twelve ran on every
    worker)."""
    Px, Py = _pupil()
    return j_wavefront(JCooke().system, 0.0, hy, 0.55, Px, Py,
                       strategy=strategy, reference_type=ref)


@pytest.mark.parametrize("hy", [0.0, 1.0])
@pytest.mark.parametrize("ref", ["sphere", "plane"])
@pytest.mark.parametrize("strategy", ["chief_ray", "centroid", "best_fit"])
def test_compute_wavefront_data_matches_jax(strategy, ref, hy):
    Px, Py = _pupil()
    got = t_wavefront(TCooke().system, 0.0, hy, 0.55, Px, Py,
                      strategy=strategy, reference_type=ref)
    want = jax_wavefront(strategy, ref, hy)
    assert isinstance(got, WavefrontData)
    wl_mm = 0.55e-3
    for name in ARRAYS:
        _close(getattr(got, name), getattr(want, name),
               scale=wl_mm if name == "opd" else 1.0, what=name)
    radius = float(got.radius)
    if ref == "plane":
        assert radius == np.inf and float(want.radius) == np.inf
    else:
        _close(got.radius, want.radius, what="radius")
    if strategy == "chief_ray":
        assert got.center is None and want.center is None
    else:
        for a, b in zip(got.center, want.center):
            _close(a, b, what="center")
    if ref == "sphere":
        # tilt removal of the same data (with a plane reference the samples
        # sit at the focus, where the least-squares tilt is ill-conditioned)
        same = got.replace(**{k: torch.tensor(np.asarray(getattr(want, k)))
                              for k in ARRAYS})
        for piston in (False, True):
            _close(t_fit(same, remove_piston=piston),
                   j_fit(want, remove_piston=piston), scale=wl_mm,
                   what=f"fit_and_remove_tilt, piston {piston}")


@pytest.mark.parametrize("hy", [0.0, 1.0])
@pytest.mark.parametrize("strategy", ["chief_ray", "centroid"])
def test_wavefront_matches_goldens(goldens, strategy, hy):
    g = goldens("wave_cooke")
    wf = TWavefront(TCooke(), num_rays=6, strategy=strategy)
    assert wf.fields == [(0.0, 0.0), (0.0, 0.7), (0.0, 1.0)]
    assert wf.wavelengths == [0.48, 0.55, 0.65]
    d = wf.get_data((0.0, hy), 0.55)
    tag = f"{strategy}_{hy:g}"
    np.testing.assert_allclose(d.opd.numpy(), g[f"wf_{tag}_opd"], rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(d.pupil_x.numpy(), g[f"wf_{tag}_px"],
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(d.pupil_y.numpy(), g[f"wf_{tag}_py"],
                               rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.ravel(d.radius.numpy()),
                               g[f"wf_{tag}_radius"], rtol=1e-7, atol=1e-9)


def test_wavefront_options_and_errors():
    lens = TCooke()
    wf = TWavefront(lens, fields=[(0.0, 0.5)], wavelengths="primary",
                    num_rays=3, afocal=True, remove_tilt=True)
    d = wf.get_data((0.0, 0.5), 0.55)
    assert wf.reference_type == "plane" and float(d.radius) == np.inf
    # tilt removed: the weighted least-squares tilt of the result is ~0
    assert torch.isfinite(d.opd).all()
    again = t_fit(d)
    assert float((again - d.opd).abs().max()) < 1e-9 * float(d.opd.abs().max())
    with pytest.raises(ValueError, match="Unknown wavefront strategy"):
        t_wavefront(lens.system, 0.0, 0.0, 0.55, [0.0], [0.0],
                    strategy="zonal")
    # a polarization state on an unpolarized system changes nothing, as in
    # the JAX package: no E_exits, the trace's own intensity
    plain = t_wavefront(lens.system, 0.0, 0.5, 0.55, [0.1], [0.2])
    with_state = t_wavefront(lens.system, 0.0, 0.5, 0.55, [0.1], [0.2],
                             pol_state=object())
    assert with_state.E_exits is None
    assert torch.equal(with_state.intensity, plain.intensity)
    assert lens.polarization_state is None


@pytest.mark.parametrize("strategy", ["chief_ray", "centroid", "best_fit"])
def test_polarized_wavefront_matches_jax(strategy):
    """The polarized doublet (Fresnel coatings, RCP) at full field: the
    polarized intensity and the exit E-fields (one per state) to 1e-10."""
    import torch_pol_systems as tps

    Px, Py = _pupil(n=40, seed=3)
    to, jo = tps.pol_doublet("torch", "RCP"), tps.pol_doublet("jax", "RCP")
    got = t_wavefront(to.system, 0.0, 1.0, 0.55, Px, Py, strategy=strategy,
                      pol_state=to.polarization_state)
    ref = jax.jit(lambda s: j_wavefront(
        s, 0.0, 1.0, 0.55, Px, Py, strategy=strategy,
        pol_state=jo.polarization_state))(jo.system)
    for k in ARRAYS:
        _close(getattr(got, k), getattr(ref, k),
               0.55e-3 if k == "opd" else 1.0, k)
    assert len(got.E_exits) == len(ref.E_exits) == 1
    _close(got.E_exits[0], ref.E_exits[0], what="E_exits")


# ---------------------------------------------------------------------------
# EPL, XPL, EPD for the four aperture types
# ---------------------------------------------------------------------------


def _finite_singlet(cls):
    """A singlet imaging an object 80 mm away (finite conjugates), stop
    behind the lens so that EPL runs the reverse trace."""
    o = cls()
    o.surfaces.add(index=0, radius=np.inf, thickness=80.0)
    o.surfaces.add(index=1, radius=35.0, thickness=6.0, material="N-BK7")
    o.surfaces.add(index=2, radius=-35.0, thickness=4.0)
    o.surfaces.add(index=3, radius=np.inf, thickness=56.0, is_stop=True)
    o.surfaces.add(index=4)
    o.fields.set_type("angle")
    o.fields.add(y=0)
    o.fields.add(y=5.0)
    o.wavelengths.add(0.55, is_primary=True)
    return o


APERTURES = [
    ("cooke", "EPD", 10.0),
    ("cooke", "imageFNO", 4.0),
    ("cooke", "float_by_stop_size", 8.0),
    ("finite", "objectNA", 0.05),
    ("finite", "float_by_stop_size", 3.0),
    ("finite", "EPD", 6.0),
]


@pytest.mark.parametrize("build, ap_type, value", APERTURES)
def test_pupil_functions_match_jax(build, ap_type, value):
    lenses = []
    for cooke_cls, optic_cls in ((TCooke, TOptic), (JCooke, JOptic)):
        lens = cooke_cls() if build == "cooke" else _finite_singlet(optic_cls)
        lens.set_aperture(ap_type, value)
        lenses.append(lens)
    tlens, jlens = lenses
    for name in ("EPL", "XPL", "EPD"):
        got = float(getattr(tlens.paraxial, name)())
        want = float(getattr(jparaxial, name)(jlens.system))
        assert np.isfinite(want), (name, want)
        assert got == pytest.approx(want, rel=1e-12, abs=1e-12), name
