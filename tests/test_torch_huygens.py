"""optiland_torch's Huygens-Fresnel PSF against the JAX package, on the CPU
in float64.

  * The field: the plain sum (``huygens_field``) and the kernel path's
    Function on CPU tensors (``huygens_field_fast``, plain versions with the
    hand adjoints) against JAX's ``huygens_field`` and its Pallas kernel in
    interpret mode, to 1e-9 of the largest |field|. The JAX suite's case
    puts the pupil normals against the image, so its obliquity factors,
    and with them the field, are ~1e-8 of the sum of |term|, and the two
    orders of summation differ by more than 1e-9 of so small a field;
    here the same pupil has its normals towards the image, which gives a
    field of the size of that sum.
  * The gradient with respect to all 8 inputs (and the reference radius)
    against ``jax.grad`` of both, each scaled by max(1, its largest entry)
    as the JAX suite scales it, to 1e-8.
  * The plain adjoints of the three kernels against autograd of the plain
    forward, to rtol 1e-10 with atol 1e-12 x each array's largest entry,
    and the sums of |term| that bound the kernels' rounding.
  * ``HuygensPSF`` on the Cooke triplet against the reference golden
    ``huygens_onaxis`` (rtol 1e-4, atol 1e-5, the JAX suite's) and against
    JAX's ``HuygensPSF`` on its jnp path (``OPTILAND_TPU_NATIVE=0``) to
    1e-9 of the peak.
  * The whole slice: the gradient of one PSF pixel with respect to every
    stack leaf against ``jax.grad``, where JAX is finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch.core.system import STACK_FIELDS
from optiland_torch.ops import huygens as hu
from optiland_torch.psf import HuygensPSF as THuygensPSF
from optiland_torch.psf import huygens_field as t_field
from optiland_torch.psf import huygens_psf as t_psf
from optiland_torch.samples import CookeTriplet as TCooke
from optiland_tpu.ops.pallas_huygens import huygens_field_pallas
from optiland_tpu.psf import HuygensPSF as JHuygensPSF
from optiland_tpu.psf import huygens_psf as j_psf
from optiland_tpu.psf.huygens_fresnel import huygens_field as j_field
from optiland_tpu.samples import CookeTriplet as JCooke
from tests.torch_shared import shared


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


def _case(P=700, Q=300, seed=0):
    """The JAX suite's case (tests/test_pallas_huygens.py), as numpy."""
    rng = np.random.default_rng(seed)
    image = [rng.uniform(-0.01, 0.01, P), rng.uniform(-0.01, 0.01, P),
             np.zeros(P)]
    th = rng.uniform(0, 2 * np.pi, Q)
    r = np.sqrt(rng.uniform(size=Q)) * 5.0
    Rp = 50.0
    px, py = r * np.cos(th), r * np.sin(th)
    pz = -np.sqrt(Rp**2 - px**2 - py**2)
    amp = rng.uniform(0.5, 1.0, Q)
    opd = rng.normal(0.0, 1e-4, Q)
    return [*image, px, py, pz, amp, opd], 0.55e-3, Rp


T_FIELDS = {"plain": t_field, "kernel_path": hu.huygens_field_fast}
J_FIELDS = {"jnp": j_field, "pallas": huygens_field_pallas}


@pytest.mark.parametrize("P, Q", [(700, 300), (257, 129), (1, 129)])
def test_field_matches_jax(P, Q):
    arrays, wl, Rp = _case(P, Q)
    Rp = -Rp  # the normals towards the image
    refs = {name: np.asarray(fn(*map(jnp.asarray, arrays), wl, Rp))
            for name, fn in J_FIELDS.items()}
    scale = float(np.abs(refs["jnp"]).max())
    k = 2 * np.pi / wl
    tensors = list(map(torch.tensor, arrays))
    zero = torch.zeros(P, dtype=torch.float64)
    s1, _ = hu.term_sums(tensors[:3], hu.pupil_arrays(*tensors[3:], k, Rp),
                         zero, zero, k)
    # a field within two orders of the sum of |term| (the JAX suite's
    # orientation gives ~1e-8), which a zero or wrongly phased field would
    # miss by far more than the tolerance
    assert scale > 1e-2 * float(s1[0].max())
    hu.reset_launch_counts()
    for name, fn in T_FIELDS.items():
        got = fn(*map(torch.tensor, arrays), wl, Rp)
        assert got.dtype == torch.complex128 and got.shape == (P,)
        for ref_name, ref in refs.items():
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=1e-9 * scale,
                                       err_msg=f"{name} vs {ref_name}")
    # CPU tensors never reach a kernel
    assert sum(hu.LAUNCHES.values()) == 0


def _loss(m, f):
    return (m.abs(f) ** 2).sum() + m.imag(f).sum()


@pytest.fixture(scope="module")
def jax_field_grads(tmp_path_factory):
    """jax.grad of each JAX field sum's loss (once per session,
    ``torch_shared.shared``)."""
    return shared(tmp_path_factory, "huygens_field_grads", _jax_field_grads)


def _jax_field_grads():
    arrays, wl, Rp = _case(P=85, Q=137, seed=3)
    args = tuple(map(jnp.asarray, arrays))
    out = {}
    for name, fn in J_FIELDS.items():
        out[name] = jax.grad(lambda *a, fn=fn: _loss(jnp, fn(*a, wl, Rp)),
                             argnums=tuple(range(8)))(*args)
    # the reference radius: the plain path differentiates it
    out["Rp"] = jax.grad(lambda r: _loss(jnp, j_field(*args, wl, r)))(
        jnp.asarray(Rp))
    return out


@pytest.mark.parametrize("name", list(T_FIELDS))
def test_field_gradients_match_jax(jax_field_grads, name):
    arrays, wl, Rp = _case(P=85, Q=137, seed=3)
    args = [torch.tensor(a, requires_grad=True) for a in arrays]
    rp = torch.tensor(Rp, requires_grad=True)
    _loss(torch, T_FIELDS[name](*args, wl, rp)).backward()
    labels = ("ix", "iy", "iz", "px", "py", "pz", "amp", "opd")
    for ref_name in J_FIELDS:
        for label, a, gr in zip(labels, args, jax_field_grads[ref_name]):
            gr = np.asarray(gr)
            scale = max(1.0, float(np.abs(gr).max()))
            np.testing.assert_allclose(a.grad.numpy() / scale, gr / scale,
                                       rtol=1e-8, atol=1e-8,
                                       err_msg=f"{name} vs {ref_name}: "
                                       f"{label}")
    g_rp = float(jax_field_grads["Rp"])
    assert float(rp.grad) == pytest.approx(g_rp, rel=1e-8,
                                           abs=1e-8 * max(1.0, abs(g_rp)))


@pytest.mark.parametrize("P, Q", [(67, 53), (1, 129)])
def test_plain_adjoints_match_autograd(P, Q):
    arrays, wl, Rp = _case(P, Q, seed=5)
    k = 2 * np.pi / wl
    rng = np.random.default_rng(7)
    img = [torch.tensor(a, requires_grad=True) for a in arrays[:3]]
    px, py, pz, amp, opd = (torch.tensor(a) for a in arrays[3:])
    pup = [t.detach().requires_grad_() for t in
           hu.pupil_arrays(px, py, pz, amp, opd, k, Rp)]
    g_re, g_im = (torch.tensor(rng.normal(size=P)) for _ in range(2))
    re, im = hu.huygens_fwd_plain(img, pup, k, chunk=16)
    auto = torch.autograd.grad((re * g_re).sum() + (im * g_im).sum(),
                               img + pup)
    hand = (hu.huygens_bwd_img_plain(img, pup, g_re, g_im, k, chunk=16)
            + hu.huygens_bwd_pup_plain(img, pup, g_re, g_im, k, chunk=16))
    names = ("ix", "iy", "iz", "px", "py", "pz", "nx", "ny", "nz", "pre",
             "pim")
    for name, a, b in zip(names, hand, auto):
        torch.testing.assert_close(a, b, rtol=1e-10,
                                   atol=1e-12 * float(b.abs().max()),
                                   msg=name)
    # the wrappers on CPU tensors run the plain versions (other chunking)
    hu.reset_launch_counts()
    for a, b in zip(hu.huygens_bwd_img(img, pup, g_re, g_im, k)
                    + hu.huygens_bwd_pup(img, pup, g_re, g_im, k), hand):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-13 * float(
            b.abs().max()))
    assert sum(hu.LAUNCHES.values()) == 0
    # the sums of |term| and |term|^2 bound the sums they come from
    s1, s2 = hu.term_sums(img, pup, g_re, g_im, k, chunk=16)
    for a, b, c in zip((re, im) + hand, s1, s2):
        assert a.shape == b.shape == c.shape
        assert bool((b >= a.detach().abs() * (1 - 1e-12)).all())
        assert bool((c <= b * b * (1 + 1e-12)).all() and (c > 0).all())


def test_f32_error_bounds_separate_rounding_from_a_wrong_sum():
    """The f32 plain version on f32 inputs stands in for an f32 kernel: it
    lies within both bounds of ``error_ratios`` against the f64 sum of the
    same values, while a zero output and a sum with k off by 1e-3 miss the
    RMS bound by more than twice."""
    P, Q = 512, 1024
    arrays, wl, Rp = _case(P, Q, seed=11)
    k = 2 * np.pi / wl
    t = list(map(torch.tensor, arrays))
    rng = np.random.default_rng(12)
    groups = (t[:3], hu.pupil_arrays(*t[3:], k, -Rp),
              [torch.tensor(rng.normal(size=P)) for _ in range(2)])
    img, pup, cots = ([v.float().double() for v in g] for g in groups)

    def outputs(img, pup, cots, k):
        return (hu.huygens_fwd_plain(img, pup, k)
                + hu.huygens_bwd_img_plain(img, pup, *cots, k)
                + hu.huygens_bwd_pup_plain(img, pup, *cots, k))

    ref = outputs(img, pup, cots, k)
    sums = hu.term_sums(img, pup, *cots, k)
    bounds = hu.f32_bound(img, pup, k)
    f32 = outputs(*([v.float() for v in g] for g in (img, pup, cots)), k)
    worst, rms = hu.error_ratios(f32, ref, *sums, *bounds)
    assert worst <= 1.0 and rms <= 0.5, (worst, rms)
    for wrong in ([torch.zeros_like(r) for r in ref],
                  outputs(img, pup, cots, k * (1 + 1e-3))):
        assert hu.error_ratios(wrong, ref, *sums, *bounds)[1] > 2.0


@pytest.mark.parametrize("sms", [132, 114, 1])
def test_split_of_fills_the_card_and_covers_the_range(sms):
    target = hu.BLOCKS_PER_SM * sms
    for n_res, n_str in ((16384, 12644), (1, 12644), (12644, 16384),
                         (16384, 65536), (4099, 8191), (1, 1), (300, 0)):
        nsplit, chunk = hu.split_of(n_res, n_str, target)
        assert chunk % hu.TILE == 0 and 1 <= nsplit <= 65535
        assert nsplit * chunk >= n_str and (nsplit - 1) * chunk < max(n_str, 1)
        blocks = -(-n_res // hu.BLOCK)
        if blocks < target and n_str >= 1 << 14:
            assert blocks * nsplit >= target // 2
    if sms == 132:  # the H100 SXM: the PSF path's field and normalization
        assert hu.split_of(16384, 12644, target) == (17, 768)
        assert hu.split_of(1, 12644, target) == (50, 256)


# ---------------------------------------------------------------------------
# The PSF
# ---------------------------------------------------------------------------


def test_huygens_psf_matches_golden_and_jax(goldens, monkeypatch):
    g = goldens("wave_cooke")
    hu.reset_launch_counts()
    h = THuygensPSF(TCooke(), (0.0, 0.0), 0.55, num_rays=32, image_size=32)
    assert sum(hu.LAUNCHES.values()) == 0
    psf = h.psf.numpy()
    np.testing.assert_allclose(psf, g["huygens_onaxis"], rtol=1e-4,
                               atol=1e-5)
    monkeypatch.setenv("OPTILAND_TPU_NATIVE", "0")
    ref = JHuygensPSF(JCooke(), (0.0, 0.0), 0.55, num_rays=32, image_size=32)
    peak = float(np.abs(np.asarray(ref.psf)).max())
    np.testing.assert_allclose(psf, np.asarray(ref.psf), rtol=0,
                               atol=1e-9 * peak)
    assert h.strehl_ratio() == pytest.approx(ref.strehl_ratio(), rel=1e-9)
    assert float(h.pixel_pitch) == pytest.approx(float(ref.pixel_pitch),
                                                 rel=1e-12)


@pytest.mark.parametrize("opts", [{"oversample": 2.0},
                                  {"pixel_pitch": 1.5e-3},
                                  {"strategy": "centroid"}])
def test_huygens_psf_options_match_jax(monkeypatch, opts):
    monkeypatch.setenv("OPTILAND_TPU_NATIVE", "0")
    got, pitch, norm = t_psf(TCooke().system, 0.0, 0.7, 0.55, num_rays=12,
                             image_size=9, **opts)
    ref, rpitch, rnorm = j_psf(JCooke().system, 0.0, 0.7, 0.55, num_rays=12,
                               image_size=9, **opts)
    peak = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-9 * peak)
    assert float(norm) == pytest.approx(float(rnorm), rel=1e-9)
    assert float(pitch) == pytest.approx(float(rpitch), rel=1e-12)


def test_vectorial_and_polarized_raise():
    # the vectorial PSF needs the exit fields of a polarized system
    lens = TCooke()
    with pytest.raises(ValueError, match="E_exits"):
        t_psf(lens.system, 0.0, 0.0, 0.55, num_rays=8, image_size=4,
              vectorial=True)
    import torch_pol_systems as tps
    from optiland_torch.psf import VectorialFFTPSF, VectorialHuygensPSF

    pol = tps.pol_doublet("torch", "H", epd=4.0)
    assert isinstance(THuygensPSF(pol, (0.0, 0.0), 0.55, num_rays=8,
                                  image_size=4), VectorialHuygensPSF)
    assert type(THuygensPSF(TCooke(), (0.0, 0.0), 0.55, num_rays=8,
                            image_size=4)) is THuygensPSF
    with pytest.raises(NotImplementedError, match="FFT PSF"):
        VectorialFFTPSF(pol, (0.0, 0.0))


def test_vectorial_psf_matches_jax(monkeypatch):
    """examples/08's coated doublet at EPD 4 (without its image solve):
    the vectorial PSF against JAX's (its jnp path, jitted) to 1e-9 of the
    peak."""
    import torch_pol_systems as tps

    monkeypatch.setenv("OPTILAND_TPU_NATIVE", "0")
    to = tps.pol_doublet("torch", "H", epd=4.0)
    jo = tps.pol_doublet("jax", "H", epd=4.0)
    h = THuygensPSF(to, (0.0, 0.0), 0.55, num_rays=32, image_size=32)
    ref = jax.jit(lambda s: j_psf(
        s, 0.0, 0.0, 0.55, num_rays=32, image_size=32,
        pol_state=jo.polarization_state, vectorial=True)[0])(jo.system)
    peak = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(h.psf.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-9 * peak)
    assert 0 < h.strehl_ratio() < 1


# ---------------------------------------------------------------------------
# The whole slice: the PSF's gradient with respect to every stack leaf
# ---------------------------------------------------------------------------

FIELD = (0.0, 0.7)
PIXEL = (4, 4)


@pytest.fixture(scope="module")
def jax_psf_grads(tmp_path_factory):
    """jax.value_and_grad of the JAX PSF's pixel over every stack leaf
    (once per session, ``torch_shared.shared``)."""
    return shared(tmp_path_factory, "huygens_psf_grads", _jax_psf_grads)


def _jax_psf_grads():
    system = JCooke().system

    def pixel(stack):
        psf, _, _ = j_psf(system.replace(stack=stack), *FIELD, 0.55,
                          num_rays=16, image_size=8)
        return psf[PIXEL]

    # one jitted computation: dispatched one operation at a time, the JAX
    # PSF's gradient takes twice as long
    val, g = jax.jit(jax.value_and_grad(pixel))(system.stack)
    return float(val), {k: np.asarray(getattr(g, k)) for k in STACK_FIELDS}


def test_psf_gradient_matches_jax(jax_psf_grads):
    system = TCooke().system
    leaves = {k: v.detach().clone().requires_grad_(v.numel() > 0)
              for k, v in system.stack.leaves().items()}
    s2 = system.replace(stack=system.stack.replace(**leaves))
    psf, _, _ = t_psf(s2, *FIELD, 0.55, num_rays=16, image_size=8)
    psf[PIXEL].backward()
    ref_val, ref = jax_psf_grads
    assert float(psf[PIXEL].detach()) == pytest.approx(ref_val, rel=1e-9)
    # JAX's NaN entries are the known one (abcd_prefix's object row,
    # ROADMAP Queue 3), which is not pinned as correct here
    nan = {k: np.argwhere(~np.isfinite(v)).tolist() for k, v in ref.items()
           if not np.isfinite(v).all()}
    assert nan == {"radius": [[0]], "mat_coeffs": [[0, 0], [7, 0]]}
    scale = max(float(np.abs(v[np.isfinite(v)]).max(initial=0))
                for v in ref.values())
    for k in STACK_FIELDS:
        got = (np.zeros(ref[k].shape) if leaves[k].grad is None
               else leaves[k].grad.numpy())
        fin = np.isfinite(ref[k])
        np.testing.assert_allclose(got[fin], ref[k][fin], rtol=1e-7,
                                   atol=1e-10 * scale, err_msg=k)
