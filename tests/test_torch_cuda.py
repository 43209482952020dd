"""optiland_torch's CUDA kernels against their plain PyTorch versions.

The tests marked ``cuda`` need a CUDA card and nvcc (the kernels build at
first use) and skip without one; run them on a card with

    python3 -m pytest tests/test_torch_cuda.py -m cuda -o addopts="" -p no:randomly

This file imports nothing of optiland_tpu, so it runs where only the port's
dependencies are installed. Tolerances: Philox uniforms identical, disk
samples within 1e-6 (f32) / 1e-14 (f64) absolute (cos/sin rounding); the
f64 merit to rtol 1e-12 and its gradient to rtol 1e-9 with atol 1e-12 x the
largest entry (sums of 5e4 per-ray terms in another order). The trace
kernels (K1, K4, K5a, K5b): f64 per-ray outputs and input cotangents to
rtol 1e-10 with atol 1e-12 x each array's largest entry (fused
multiply-adds on the card), summed gradients as the merit's; f32 against
the f64 plain version to 2e-4 x max(1, each array's largest entry) (the
image-plane x and y of a focused bundle are ~0.02 mm, while f32 rounds the
~50 mm path to ~1e-5 mm), and to 1e-3 in the L2 norm of the gradients; a
ray whose radius falls within rounding of a clip edge may be clipped in one
and not the other, so at most 1 in 1e4 intensities may differ. The Huygens
kernels (K10, K11a, K11b): f64 fields to 1e-9 of the largest |field| and
gradients to 1e-8 of each array's largest entry; f32 within the phase
rounding bound derived in its test.
"""

import dataclasses
import math

import pytest
import torch

from optiland_torch import config
from optiland_torch.analysis import spot
from optiland_torch.core import raygen
from optiland_torch.core import trace as trace_core
from optiland_torch.ops import _cuda
from optiland_torch.ops import fast_trace as ftr
from optiland_torch.ops import fused_trace as ft
from optiland_torch.ops import huygens as hu
from optiland_torch.optic import Optic
from optiland_torch.samples import CookeTriplet

H = (0.0, 0.7)
WL = 0.55


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    config.set_device("cuda")
    config.set_precision("float64")
    yield torch.device("cuda")
    config.set_device("cpu")


def _mirror_system():
    """A concave conic mirror (the reflect branch of both kernels)."""
    lens = Optic()
    lens.surfaces.add(index=0, radius=float("inf"), thickness=float("inf"))
    lens.surfaces.add(index=1, radius=-200.0, thickness=-100.0,
                      material="mirror", is_stop=True, conic=-0.5)
    lens.surfaces.add(index=2)
    lens.set_aperture(aperture_type="EPD", value=20)
    lens.fields.set_type(field_type="angle")
    lens.fields.add(y=0)
    lens.fields.add(y=1)
    lens.wavelengths.add(value=0.55, is_primary=True)
    return lens.system


def _vignetted_system():
    """The Cooke triplet with a 2 mm semi-aperture at the stop (the clip)."""
    lens = CookeTriplet()
    lens.surfaces.surfaces[4].aperture = 4.0
    lens._invalidate()
    return lens.system


def _setup(kind="cooke"):
    system = {"cooke": lambda: CookeTriplet().system,
              "mirror": _mirror_system,
              "vignetted": _vignetted_system}[kind]()
    with torch.no_grad():
        params = ft.build_param_table(system, WL).contiguous()
        aim = ft.aim_vector(system, *H).contiguous()
    return system, params, aim, ft._spec_of(system)


def test_cpu_work_never_builds_or_loads_the_library():
    config.set_device("cpu")
    config.set_precision("float64")
    before = _cuda._LIB
    lens = CookeTriplet()
    system = lens.system
    loss = ft.spot_rms_fast_field(system, *H, WL, num_rays=512, seed=1)
    assert torch.isfinite(loss)
    res = lens.trace(Hy=0.7, num_rays=4, record=False)
    Px = torch.linspace(-0.5, 0.5, 9, dtype=torch.float64)
    fast = ftr.trace_fast_field(system, *H, Px, Px, WL)
    assert torch.isfinite(res.x).all() and torch.isfinite(fast.x).all()
    assert _cuda._LIB is before
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, tol", [(torch.float32, 1e-6),
                                        (torch.float64, 1e-14)])
def test_prng_disk_matches_plain(cuda_device, dtype, tol):
    k = ft.prng_disk(2**40 + 3, 70001, 555, dtype, cuda_device, with_u=True)
    p = ft.prng_disk_plain(2**40 + 3, 70001, 555, dtype, cuda_device,
                           with_u=True)
    assert torch.equal(k[2], p[2]) and torch.equal(k[3], p[3])
    assert float((k[0] - p[0]).abs().max()) <= tol
    assert float((k[1] - p[1]).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("prng", [False, True])
@pytest.mark.parametrize("kind", ["cooke", "mirror"])
def test_merit_kernels_match_plain(cuda_device, kind, prng):
    _, params, aim, spec = _setup(kind)
    R = 50001
    Px = Py = None
    if not prng:
        Px, Py = ft.prng_disk_plain(8, R, 0, torch.float64, cuda_device)
    rows = ft.merit_fwd(params, aim, spec, R, seed=4, Px=Px, Py=Py)
    rows_p = ft.merit_fwd_plain(params, aim, spec, R, seed=4, Px=Px, Py=Py)
    assert rows.shape == rows_p.shape
    loss, xbar, ybar = ft._chan_combine(rows, R)
    assert float(loss) == pytest.approx(
        float(ft._chan_combine(rows_p, R)[0]), rel=1e-12)
    stats = torch.stack([xbar, ybar, 1.0 / R + 0 * xbar, 0 * xbar])
    k = ft.merit_bwd(params, aim, stats, spec, 1, R, seed=4, Px=Px, Py=Py)
    p = ft.merit_bwd_plain(params, aim, stats, spec, 1, R, seed=4, Px=Px,
                           Py=Py)
    torch.testing.assert_close(k, p, rtol=1e-9,
                               atol=1e-12 * float(p.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("block", [32, 64, 96])
def test_merit_bwd_block_sizes_agree(cuda_device, block):
    _, params, aim, spec = _setup()
    R = 30001
    rows = ft.merit_fwd(params, aim, spec, R, seed=6)
    _, xbar, ybar = ft._chan_combine(rows, R)
    stats = torch.stack([xbar, ybar, 1.0 / R + 0 * xbar, 0 * xbar])
    ref = ft.merit_bwd(params, aim, stats, spec, 1, R, seed=6)
    got = ft.merit_bwd(params, aim, stats, spec, 1, R, seed=6, block=block)
    torch.testing.assert_close(got, ref, rtol=1e-9,
                               atol=1e-12 * float(ref.abs().max()))


@pytest.mark.cuda
def test_entry_point_launches_both_kernels(cuda_device):
    system = CookeTriplet().system
    leaves = {k: v.clone().requires_grad_() for k, v in
              system.stack.leaves().items() if v.numel()}
    s2 = system.replace(stack=system.stack.replace(**leaves))
    ft.reset_launch_counts()
    loss = ft.spot_rms_fast_field(s2, *H, WL, num_rays=100000, seed=2)
    loss.backward()
    torch.cuda.synchronize()
    assert ft.LAUNCHES == {"prng_disk": 0, "merit_fwd": 1, "merit_bwd": 1}
    assert torch.isfinite(leaves["radius"].grad[1:-1]).all()


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(cuda_device):
    _, params, aim, spec = _setup()
    bad = ((0, 2) + spec[0][2:],) + spec[1:]
    with pytest.raises(NotImplementedError):
        ft.merit_fwd(params, aim, bad, 100, seed=1)
    with pytest.raises(ValueError, match="float64 on cuda"):
        ft.merit_fwd(params, aim.cpu(), spec, 100, seed=1)
    with pytest.raises(TypeError):
        ft.prng_disk(1, 10, 0, torch.float16, cuda_device)


# ---------------------------------------------------------------------------
# The trace kernels K1, K4, K5a, K5b
# ---------------------------------------------------------------------------


def _bundle(system, Px, Py, seed):
    """Launch arrays of a paraxially aimed bundle, with random intensities
    and path lengths so that every input reaches the trace, and random
    output cotangents."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    R = Px.shape[0]
    dt, dev = Px.dtype, Px.device
    with torch.no_grad():
        rays = raygen.generate_rays(system, *H, Px, Py, WL)
        ins = [getattr(rays, k).to(dt).contiguous() for k in ftr.RAY_FIELDS]
    ins[6] = (0.5 + 0.5 * torch.rand(R, generator=g, dtype=dt)).to(dev)
    ins[7] = torch.rand(R, generator=g, dtype=dt).to(dev)
    cots = [torch.randn(R, generator=g, dtype=dt).to(dev) for _ in range(8)]
    return ins, cots


def _close(got, ref, rtol, what):
    for k, (a, b) in enumerate(zip(got, ref)):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=rtol, atol=1e-12 * scale,
                                   msg=f"{what} array {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cooke", "mirror", "vignetted"])
def test_trace_kernels_match_plain_f64(cuda_device, kind):
    system, params, aim, _ = _setup(kind)
    spec = ftr.fast_spec(system)
    R, nc = 50001, system.stack.coeffs.shape[1]
    Px, Py = ft.prng_disk_plain(9, R, 0, torch.float64, cuda_device)
    ins, cots = _bundle(system, Px, Py, 1)
    # K5a, K5b
    _close(ftr.trace_fwd(params, spec, ins),
           ftr.trace_fast_plain(params, spec, ins), 1e-10, "trace_fwd")
    din, flat = ftr.trace_bwd(params, spec, nc, ins, cots)
    din_p, flat_p = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots)
    _close(din, din_p, 1e-10, "trace_bwd input cotangent")
    torch.testing.assert_close(flat, flat_p, rtol=1e-9,
                               atol=1e-12 * float(flat_p.abs().max()))
    # K1, K4
    out = ftr.trace_field_fwd(params, aim, spec, Px, Py)
    _close(out, ftr.trace_fast_field_plain(params, aim, spec, Px, Py), 1e-10,
           "trace_field_fwd")
    if kind == "vignetted":
        assert 0 < int((out[6] == 0).sum()) < R
    flat = ftr.trace_field_bwd(params, aim, spec, nc, Px, Py, cots)
    flat_p = ftr.trace_fast_field_bwd_plain(params, aim, spec, nc, Px, Py,
                                            cots)
    torch.testing.assert_close(flat, flat_p, rtol=1e-9,
                               atol=1e-12 * float(flat_p.abs().max()))


def _near(a, b, what):
    """f32 kernel output ``a`` against the f64 plain ``b``; a few
    intensities may differ where a ray sits on a clip edge."""
    for k, (u, v) in enumerate(zip(a, b)):
        d = (u.double() - v).abs()
        bad = d > 2e-4 * max(1.0, float(v.abs().max()))
        limit = 1e-4 * v.shape[0] if k == 6 else 0
        assert int(bad.sum()) <= limit, (what, k, float(d.max()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cooke", "vignetted"])
def test_trace_kernels_f32_match_f64(cuda_device, kind):
    system, params, aim, _ = _setup(kind)
    spec = ftr.fast_spec(system)
    R, nc = 50001, system.stack.coeffs.shape[1]
    Px, Py = ft.prng_disk_plain(9, R, 0, torch.float64, cuda_device)
    ins, cots = _bundle(system, Px, Py, 2)
    p32, a32 = params.float(), aim.float()
    ins32, cots32 = [t.float() for t in ins], [t.float() for t in cots]
    _near(ftr.trace_fwd(p32, spec, ins32),
          ftr.trace_fast_plain(params, spec, ins), "trace_fwd")
    _near(ftr.trace_field_fwd(p32, a32, spec, Px.float(), Py.float()),
          ftr.trace_fast_field_plain(params, aim, spec, Px, Py),
          "trace_field_fwd")

    def l2(a, b):
        return float(torch.linalg.vector_norm(a.double() - b)
                     / torch.linalg.vector_norm(b))

    din, flat = ftr.trace_bwd(p32, spec, nc, ins32, cots32)
    din_p, flat_p = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots)
    assert l2(flat, flat_p) <= 1e-3
    _near(din[:6], din_p[:6], "trace_bwd input cotangent")
    flat = ftr.trace_field_bwd(p32, a32, spec, nc, Px.float(), Py.float(),
                               cots32)
    flat_p = ftr.trace_fast_field_bwd_plain(params, aim, spec, nc, Px, Py,
                                            cots)
    assert l2(flat, flat_p) <= 1e-3


def _leaf_system(system):
    leaves = {k: v.clone().requires_grad_() for k, v in
              system.stack.leaves().items() if v.numel()}
    return system.replace(stack=system.stack.replace(**leaves)), leaves


@pytest.mark.cuda
def test_trace_entry_points_launch_their_kernels(cuda_device):
    system = CookeTriplet().system
    R = 4097
    Px, Py = ft.prng_disk(3, R, 0, torch.float64, cuda_device)
    s2, leaves = _leaf_system(system)
    ftr.reset_launch_counts()
    rays = raygen.generate_rays(s2, *H, Px, Py, WL)
    out = ftr.trace_fast(s2, rays, WL)
    (out.x.square().mean() + out.opd.mean() + out.i.mean()).backward()
    torch.cuda.synchronize()
    assert ftr.LAUNCHES == {"trace_fwd": 1, "trace_bwd": 1,
                            "trace_field_fwd": 0, "trace_field_bwd": 0}
    assert torch.isfinite(leaves["radius"].grad[1:-1]).all()
    s2, leaves = _leaf_system(system)
    ftr.reset_launch_counts()
    out = ftr.trace_fast_field(s2, *H, Px, Py, WL)
    (out.y.square().mean() + out.opd.mean()).backward()
    torch.cuda.synchronize()
    assert ftr.LAUNCHES == {"trace_fwd": 0, "trace_bwd": 0,
                            "trace_field_fwd": 1, "trace_field_bwd": 1}
    assert torch.isfinite(leaves["radius"].grad[1:-1]).all()
    # the reference trace dispatches to K5a without a history, never with
    ftr.reset_launch_counts()
    rays = raygen.generate_rays(system, *H, Px, Py, WL)
    fast, hist = trace_core.trace(system, rays, record=False, wavelength=WL)
    assert hist is None and ftr.LAUNCHES["trace_fwd"] == 1
    ref, hist = trace_core.trace(system, rays, record=True, wavelength=WL)
    assert hist is not None and ftr.LAUNCHES["trace_fwd"] == 1
    for k in ("x", "y", "L", "M", "opd", "i"):
        torch.testing.assert_close(getattr(fast, k), getattr(ref, k),
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.cuda
def test_trace_wrappers_raise_instead_of_falling_back(cuda_device):
    system, params, aim, _ = _setup()
    spec = ftr.fast_spec(system)
    Px, Py = ft.prng_disk(3, 100, 0, torch.float64, cuda_device)
    ins, cots = _bundle(system, Px, Py, 3)
    with pytest.raises(TypeError, match="float32 or float64"):
        ftr.trace_fwd(params.half(), spec, [t.half() for t in ins])
    with pytest.raises(ValueError, match="float64 on cuda"):
        ftr.trace_fwd(params, spec, [ins[0].cpu()] + ins[1:])
    with pytest.raises(ValueError, match="float64 on cuda"):
        ftr.trace_field_fwd(params, aim, spec, Px.float(), Py.float())
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.stack([cots[0], cots[0]], dim=1)[:, 0]
        ftr.trace_bwd(params, spec, 1, ins, [strided] + cots[1:])
    bad = ((0, 2) + spec[0][2:],) + spec[1:]
    with pytest.raises(NotImplementedError):
        ftr.trace_field_bwd(params, aim, bad, 1, Px, Py, cots)
    tilted = system.replace(stack=system.stack.replace(
        rx=system.stack.rx + torch.tensor([0, 0, 0.01, 0, 0, 0, 0, 0.0],
                                          device=cuda_device)))
    rays = raygen.generate_rays(tilted, *H, Px, Py, WL)
    with pytest.raises(NotImplementedError, match="later slice"):
        ftr.trace_fast(tilted, rays, WL)
    with pytest.raises(NotImplementedError, match="later slice"):
        ftr.trace_fast_field(tilted, *H, Px, Py, WL)


@pytest.mark.cuda
def test_trace_raises_where_the_kernels_do_not_cover_yet(cuda_device):
    # the JAX package's kernels take tilts (K6, a later slice here): without
    # a history a tilted system raises on the card instead of running the
    # plain engine there; with a history the plain engine traces it
    system = CookeTriplet().system
    rx = torch.zeros(system.cfg.num_surfaces, dtype=torch.float64,
                     device=cuda_device)
    rx[2] = 0.01
    tilted = system.replace(
        stack=system.stack.replace(rx=system.stack.rx + rx),
        cfg=dataclasses.replace(system.cfg, has_tilts=True))
    Px, Py = ft.prng_disk(3, 1000, 0, torch.float64, cuda_device)
    rays = raygen.generate_rays(tilted, *H, Px, Py, WL)
    ftr.reset_launch_counts()
    with pytest.raises(NotImplementedError, match="K6"):
        trace_core.trace(tilted, rays, record=False, wavelength=WL)
    with pytest.raises(NotImplementedError, match="K6"):
        spot.rms_spot_size(tilted, *H, Px, Py, WL)
    final, hist = trace_core.trace(tilted, rays, record=True, wavelength=WL)
    assert hist is not None and torch.isfinite(final.x).all()
    assert sum(ftr.LAUNCHES.values()) == 0


# ---------------------------------------------------------------------------
# The Huygens kernels K10, K11a, K11b
# ---------------------------------------------------------------------------


def _huygens_case(P, Q, seed, device, dtype=torch.float64):
    """Image points near the focus of a 52 mm reference sphere, pupil points
    on it with normals towards the image, random amplitudes and OPD, random
    field cotangents (the phase k R ~ 6e5 rad of the PSF path)."""
    g = torch.Generator(device="cpu").manual_seed(seed)

    def u(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g, dtype=torch.float64)

    Rp, wl = 52.45, 0.55e-3
    k = 2 * math.pi / wl
    img = [u(P, -0.02, 0.02), u(P, -0.02, 0.02), u(P, -1e-3, 1e-3)]
    r, th = 5.0 * u(Q, 0, 1).sqrt(), u(Q, 0, 2 * math.pi)
    px, py = r * th.cos(), r * th.sin()
    pz = -(Rp**2 - px**2 - py**2).sqrt()
    amp, opd = u(Q, 0.5, 1.0), 1e-4 * torch.randn(Q, generator=g,
                                                 dtype=torch.float64)
    pup = list(hu.pupil_arrays(px, py, pz, amp, opd, k, -Rp))
    cots = [torch.randn(P, generator=g, dtype=torch.float64)
            for _ in range(2)]
    to = [[t.to(device=device, dtype=dtype).contiguous() for t in group]
          for group in (img, pup, cots)]
    return (*to, k)


def _per_array(got, ref, rtol, what):
    for j, (a, b) in enumerate(zip(got, ref)):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=rtol, atol=rtol * scale,
                                   msg=f"{what} array {j}")


@pytest.mark.cuda
@pytest.mark.parametrize("P, Q", [(1031, 2053), (1, 4099), (257, 1)])
def test_huygens_kernels_match_plain_f64(cuda_device, P, Q):
    img, pup, (g_re, g_im), k = _huygens_case(P, Q, 3, cuda_device)
    re, im = hu.huygens_fwd(img, pup, k)
    re_p, im_p = hu.huygens_fwd_plain(img, pup, k)
    scale = float(torch.hypot(re_p, im_p).max())
    torch.testing.assert_close(re, re_p, rtol=0, atol=1e-9 * scale)
    torch.testing.assert_close(im, im_p, rtol=0, atol=1e-9 * scale)
    dimg = hu.huygens_bwd_img(img, pup, g_re, g_im, k)
    dpup = hu.huygens_bwd_pup(img, pup, g_re, g_im, k)
    _per_array(dimg, hu.huygens_bwd_img_plain(img, pup, g_re, g_im, k),
               1e-8, "huygens_bwd_img")
    _per_array(dpup, hu.huygens_bwd_pup_plain(img, pup, g_re, g_im, k),
               1e-8, "huygens_bwd_pup")


@pytest.mark.cuda
def test_huygens_kernels_f32_within_the_phase_rounding(cuda_device):
    """f32 kernels against the f64 plain version of the same (f32-rounded)
    inputs: each term's phase k R carries up to ~3 k R 2^-24 of rounding
    (R, the product with 2/lambda) and its other factors a few 2^-24:
    ``hu.error_ratios`` holds every entry to (6 k R_max + 16) 2^-24 times
    its sum of term scales, and the RMS error to the RMS of the terms'
    rounding."""
    img, pup, cots, k = _huygens_case(2053, 4099, 4, cuda_device,
                                      torch.float32)
    img64, pup64, cots64 = ([t.double() for t in grp]
                            for grp in (img, pup, cots))
    got = (hu.huygens_fwd(img, pup, k) + hu.huygens_bwd_img(img, pup, *cots, k)
           + hu.huygens_bwd_pup(img, pup, *cots, k))
    ref = (hu.huygens_fwd_plain(img64, pup64, k)
           + hu.huygens_bwd_img_plain(img64, pup64, *cots64, k)
           + hu.huygens_bwd_pup_plain(img64, pup64, *cots64, k))
    worst, rms = hu.error_ratios(got, ref,
                                 *hu.term_sums(img64, pup64, *cots64, k),
                                 *hu.f32_bound(img64, pup64, k))
    assert worst <= 1.0 and rms <= 1.0, (worst, rms)


@pytest.mark.cuda
def test_huygens_psf_launches_its_kernels(cuda_device):
    from optiland_torch.psf import HuygensPSF, huygens_psf

    hu.reset_launch_counts()
    ftr.reset_launch_counts()
    h = HuygensPSF(CookeTriplet(), (0.0, 0.7), 0.55, num_rays=32,
                   image_size=16)
    torch.cuda.synchronize()
    assert 0.0 < h.strehl_ratio() <= 1.2
    # field and normalization sums; chief ray, pupil, image grid and
    # working F-number traces at (0, 0.7), chief ray and pupil on axis
    assert hu.LAUNCHES == {"huygens_fwd": 2, "huygens_bwd_img": 0,
                           "huygens_bwd_pup": 0}
    assert ftr.LAUNCHES == {"trace_fwd": 6, "trace_bwd": 0,
                            "trace_field_fwd": 0, "trace_field_bwd": 0}
    system = CookeTriplet().system
    s2, leaves = _leaf_system(system)
    hu.reset_launch_counts()
    ftr.reset_launch_counts()
    psf, _, _ = huygens_psf(s2, *H, WL, num_rays=32, image_size=16)
    psf[8, 8].backward()
    torch.cuda.synchronize()
    assert hu.LAUNCHES == {"huygens_fwd": 2, "huygens_bwd_img": 2,
                           "huygens_bwd_pup": 2}
    assert ftr.LAUNCHES == {"trace_fwd": 6, "trace_bwd": 6,
                            "trace_field_fwd": 0, "trace_field_bwd": 0}
    assert torch.isfinite(leaves["radius"].grad[1:-1]).all()
    # the same PSF on the CPU (plain sum and plain trace)
    config.set_device("cpu")
    ref, _, _ = huygens_psf(CookeTriplet().system, *H, WL, num_rays=32,
                            image_size=16)
    torch.testing.assert_close(psf.detach().cpu(), ref, rtol=0,
                               atol=1e-9 * float(ref.max()))


@pytest.mark.cuda
def test_huygens_wrappers_raise_instead_of_falling_back(cuda_device):
    img, pup, cots, k = _huygens_case(10, 20, 5, cuda_device)
    with pytest.raises(TypeError, match="float32 or float64"):
        hu.huygens_fwd([t.half() for t in img], [t.half() for t in pup], k)
    with pytest.raises(ValueError, match="float64 on cuda"):
        hu.huygens_fwd(img[:2] + [img[2].float()], pup, k)
    with pytest.raises(ValueError, match="contiguous"):
        strided = torch.stack([img[0], img[0]], dim=1)[:, 0]
        hu.huygens_fwd([strided] + img[1:], pup, k)
    with pytest.raises(ValueError, match="one length"):
        hu.huygens_bwd_pup(img, pup, cots[0][:5], cots[1], k)
