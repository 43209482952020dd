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
rounding bound derived in its test. The polarized kernels (K8, K9), both
modes, every coat kind: as the trace kernels, p's entries against the
largest entry (some vanish exactly). The polychromatic mode of K5a/K5b and
the tilted systems of every trace kernel (K1-K5, K8, K9): as the trace
kernels, the coefficient gradients with the other summed gradients. The
sag and deep builds (radial aspheres, annular apertures, more than 16
surfaces): as the trace kernels; their f32 kernels against the f32 plain
versions (the f32 Newton iteration converges to ~1e-7 relative), to 2e-4
of each array's scale and 1e-3 in the gradients' L2 norm. The free build
(the Cartesian freeforms): as the trace kernels, every gradient column,
P_G1, P_G2 and each coefficient column included. The grating build
(K6c): as the trace kernels, the grating surface's P_G1 and P_G2 columns
among the summed gradients. The nurbs build (K6d): as the trace kernels,
each of the net's columns among the summed gradients; its f32 kernels
against the f64 plain versions to 2e-4 of each array's scale (at most 1 in
1e4 entries off, a clip edge) and 1e-3 in the gradients' L2 norm.
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
from optiland_torch.ops import launch, step
from optiland_torch.optic import Optic
from optiland_torch.polarization import create_polarization
from optiland_torch.samples import (
    AsphericSinglet, CookeTriplet, freeform, grating, nurbs, perturbed,
    registry,
)

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


def _only(launches, **counts):
    """The launch counts ``launches`` must equal: ``counts``, 0 elsewhere
    (every kernel, its TILT instantiation ("_tilt") included)."""
    return {**dict.fromkeys(launches, 0), **counts}


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


def test_build_keeps_the_library_under_its_hash(tmp_path, monkeypatch):
    """The build links the library to the name of its sources' and flags'
    hash and finds it there the next time, so a later process loads it and
    runs no nvcc (here a stand-in nvcc that writes each -o file)."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n  if [ "$1" = -o ]; '
                    'then shift; echo stub > "$1"; fi\n  shift\ndone\n')
    fake.chmod(0o755)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_cuda, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(_cuda, "BUILD_SECONDS", None)
    monkeypatch.setattr(_cuda, "BUILD_LOG", "")
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(fake))
    first = _cuda._build()
    name = first.rsplit("/", 1)[-1]
    assert name.startswith("liboptiland_torch_") and name.endswith(".so")
    assert sorted(p.name for p in build_dir.iterdir()) == [name]
    assert _cuda.BUILD_SECONDS > 0
    runs = []
    monkeypatch.setattr(_cuda, "_nvcc", lambda: runs.append(1) or str(fake))
    assert _cuda._build() == first
    assert _cuda.BUILD_SECONDS == 0.0 and not runs


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
    assert ft.LAUNCHES == _only(ft.LAUNCHES, merit_fwd=1, merit_bwd=1)
    assert torch.isfinite(leaves["radius"].grad[1:-1]).all()


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back(cuda_device):
    _, params, aim, spec = _setup()
    bad = ((0, 11) + spec[0][2:],) + spec[1:]  # grid sag: a later slice
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


def _close(got, ref, rtol, what, metre=False, positions=True):
    """Array by array, to ``rtol`` with atol 1e-12 x the array's largest
    entry; a system at the metre scale (``metre``) has its positions and
    OPD (arrays 0-2 and 7 of a trace's 8; with ``positions``) to 2e-8 mm
    absolute and its other arrays to atol 1e-9 x their largest entry, the
    rounding of metre-long paths."""
    for k, (a, b) in enumerate(zip(got, ref)):
        scale = float(b.abs().max())
        pos = positions and k in (0, 1, 2, 7)
        atol = (2e-8 if pos else 1e-9 * scale) if metre else 1e-12 * scale
        d = float((a - b).abs().max())
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                   msg=f"{what} array {k}: max |d| {d:.3e}, "
                                   f"max |ref| {scale:.3e}")


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


def _near(a, b, what, metre=False):
    """f32 kernel output ``a`` against the f64 plain ``b``; a few
    intensities may differ where a ray sits on a clip edge. At the metre
    scale (``metre``) the positions share the scale of the largest."""
    pos = max(float(b[k].abs().max()) for k in range(3))
    for k, (u, v) in enumerate(zip(a, b)):
        d = (u.double() - v).abs()
        top = max(1.0, float(v.abs().max()), pos if metre and k < 3 else 0)
        bad = d > 2e-4 * top
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
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd=1, trace_bwd=1)
    assert torch.isfinite(leaves["radius"].grad[1:-1]).all()
    s2, leaves = _leaf_system(system)
    ftr.reset_launch_counts()
    out = ftr.trace_fast_field(s2, *H, Px, Py, WL)
    (out.y.square().mean() + out.opd.mean()).backward()
    torch.cuda.synchronize()
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_field_fwd=1,
                                 trace_field_bwd=1)
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
    bad = ((0, 11) + spec[0][2:],) + spec[1:]  # grid sag: a later slice
    with pytest.raises(NotImplementedError):
        ftr.trace_field_bwd(params, aim, bad, 1, Px, Py, cots)
    # a tilted system runs the kernels and agrees with their plain versions
    tilted = system.replace(stack=system.stack.replace(
        rx=system.stack.rx + torch.tensor([0, 0, 0.01, 0, 0, 0, 0, 0.0],
                                          device=cuda_device)))
    rays = raygen.generate_rays(tilted, *H, Px, Py, WL)
    ftr.reset_launch_counts()
    fast = ftr.trace_fast(tilted, rays, WL)
    field = ftr.trace_fast_field(tilted, *H, Px, Py, WL)
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_tilt=1,
                                 trace_field_fwd_tilt=1)
    spec = ftr.fast_spec(tilted, field=True)
    assert spec[3][2]
    with torch.no_grad():
        p_t = ft.build_param_table(tilted, WL)
        a_t = ft.aim_vector(tilted, *H)
    ins_t = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
    _close([getattr(fast, k) for k in ftr.RAY_FIELDS],
           ftr.trace_fast_plain(p_t, spec, ins_t), 1e-10, "tilted trace_fast")
    _close([getattr(field, k) for k in ftr.RAY_FIELDS],
           ftr.trace_fast_field_plain(p_t, a_t, spec, Px, Py), 1e-10,
           "tilted trace_fast_field")


def _plates(n):
    """2 n + 2 surfaces: object, n thin plates (2 n surfaces), image."""
    lens = Optic()
    lens.surfaces.add(index=0, radius=float("inf"), thickness=float("inf"))
    for k in range(n):
        lens.surfaces.add(radius=float("inf"), thickness=1.0,
                          material="N-BK7", is_stop=k == 0)
        lens.surfaces.add(radius=-200.0 * (k + 1), thickness=2.0)
    lens.surfaces.add()
    lens.set_aperture(aperture_type="EPD", value=10)
    lens.fields.set_type(field_type="angle")
    lens.fields.add(y=0)
    lens.fields.add(y=1)
    lens.wavelengths.add(value=0.55, is_primary=True)
    return lens.system


@pytest.mark.cuda
def test_trace_raises_where_the_kernels_do_not_cover_yet(cuda_device):
    # 18 surfaces run on the deep build of the kernels and match the plain
    # engine; past the kernels' MAX_SURF (64) a system raises on the card
    # without a history instead of running the plain engine there, and with
    # a history the plain engine traces it. A tilted system runs the kernels.
    from optiland_torch.ops.launch import MAX_SURF

    system = _plates(8)
    assert system.cfg.num_surfaces == 18
    Px, Py = ft.prng_disk(3, 1000, 0, torch.float64, cuda_device)
    rays = raygen.generate_rays(system, *H, Px, Py, WL)
    ftr.reset_launch_counts()
    fast, hist = trace_core.trace(system, rays, record=False, wavelength=WL)
    assert hist is None
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_deep=1)
    ref, _ = trace_core.trace(system, rays, record=True, wavelength=WL)
    for k in ("x", "y", "L", "M", "opd", "i"):
        torch.testing.assert_close(getattr(fast, k), getattr(ref, k),
                                   rtol=1e-9, atol=1e-9)
    assert torch.isfinite(spot.rms_spot_size(system, *H, Px, Py, WL))
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_deep=2)
    too_deep = _plates(MAX_SURF // 2)
    assert too_deep.cfg.num_surfaces == MAX_SURF + 2
    rays = raygen.generate_rays(too_deep, *H, Px, Py, WL)
    ftr.reset_launch_counts()
    with pytest.raises(NotImplementedError, match=f"at most {MAX_SURF}"):
        trace_core.trace(too_deep, rays, record=False, wavelength=WL)
    with pytest.raises(NotImplementedError, match=f"at most {MAX_SURF}"):
        spot.rms_spot_size(too_deep, *H, Px, Py, WL)
    final, hist = trace_core.trace(too_deep, rays, record=True, wavelength=WL)
    assert hist is not None and torch.isfinite(final.x).all()
    assert sum(ftr.LAUNCHES.values()) == 0
    # a coefficient table wider than NC_MAX = 36 columns raises on the card
    wide = freeform.freeform_singlet(
        "polynomial", coefficients=[[1e-9] * 7] * 7).system
    assert wide.stack.coeffs.shape[1] == 49
    rays = raygen.generate_rays(wide, *H, Px, Py, WL)
    with pytest.raises(NotImplementedError, match="NC_MAX = 36"):
        trace_core.trace(wide, rays, record=False, wavelength=WL)
    assert sum(ftr.LAUNCHES.values()) == 0
    tilted = perturbed.toleranced_cooke().system
    rays = raygen.generate_rays(tilted, *H, Px, Py, WL)
    fast, _ = trace_core.trace(tilted, rays, record=False, wavelength=WL)
    ref, _ = trace_core.trace(tilted, rays, record=True, wavelength=WL)
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_tilt=1)
    for k in ("x", "y", "L", "M", "opd", "i"):
        torch.testing.assert_close(getattr(fast, k), getattr(ref, k),
                                   rtol=1e-9, atol=1e-9)
    v = spot.rms_spot_size(tilted, *H, Px, Py, WL)
    assert torch.isfinite(v)
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_tilt=2)


# ---------------------------------------------------------------------------
# K6a (annular apertures), K6b (EVEN/ODD_ASPHERE) and the deep build
# ---------------------------------------------------------------------------

# system -> (the build its full traces launch, its field (Hx, Hy))
K6_SYSTEMS = {
    "asphere": ("_sag", (0.0, 0.0)),
    "tilted_asphere": ("_sag", (0.0, 0.0)),
    "odd_asphere": ("_sag", (0.0, 0.0)),
    "hubble": ("_sag", (0.0, 1.0)),
    "objective26": ("_deep", (0.0, 0.7)),
}


def _k6_system(kind):
    return {
        "asphere": lambda: AsphericSinglet().system,
        "tilted_asphere": lambda: perturbed.tilted_asphere().system,
        "odd_asphere": lambda: perturbed.odd_asphere().system,
        "hubble": lambda: registry.build_sample("HubbleTelescope").system,
        "objective26": lambda: registry.build_sample(
            "ObjectiveUS008879901").system,
    }[kind]()


def _k6_inputs(system, field, R, seed, dtype=torch.float64, pupil=None):
    wl = float(system.wavelengths[system.cfg.primary_index])
    with torch.no_grad():
        params = ft.build_param_table(system, wl).contiguous()
        aim = ft.aim_vector(system, *field).contiguous()
    coeffs = system.stack.coeffs.contiguous()
    if pupil is None:
        Px, Py = ft.prng_disk_plain(seed, R, 0, torch.float64, params.device)
        Px, Py = Px * 0.98, Py * 0.98
    else:
        Px, Py = (t.to(params.device) for t in pupil)
    g = torch.Generator(device="cpu").manual_seed(seed)
    with torch.no_grad():
        rays = raygen.generate_rays(system, *field, Px, Py, wl)
        ins = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
    ins[6] = (0.5 + 0.5 * torch.rand(R, generator=g, dtype=ins[0].dtype)
              ).to(ins[0].device)
    cots = [torch.randn(R, generator=g, dtype=ins[0].dtype).to(ins[0].device)
            for _ in range(8)]
    cast = (lambda t: t.to(dtype).contiguous())
    return (wl, cast(params), cast(aim), cast(coeffs), cast(Px), cast(Py),
            [cast(t) for t in ins], [cast(t) for t in cots])


def _pol_out_close(got, ref, what):
    """pol_fwd's outputs: the 8 ray arrays as ``_close``; p's entries (the
    full mode) against the largest of them, as some vanish exactly."""
    _close(got[:8], ref[:8], 1e-10, what)
    p_scale = max([float(v.abs().max()) for v in ref[8:]] + [0.0])
    for k, (a, b) in enumerate(zip(got[8:], ref[8:])):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12 * p_scale,
                                   msg=f"{what} p entry {k}")


def _flat_close(a, b, what, metre=False):
    """Summed gradients to rtol 1e-9 with atol 1e-12 x the largest entry;
    at the metre scale (``metre``) atol 1e-8 x the largest entry, the
    rounding of metre-long paths."""
    d, top = float((a - b).abs().max()), float(b.abs().max())
    torch.testing.assert_close(a, b, rtol=1e-9,
                               atol=(1e-8 if metre else 1e-12) * top,
                               msg=f"{what}: max |d| {d:.3e} of {top:.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(K6_SYSTEMS))
def test_k6_kernels_match_plain_f64(cuda_device, kind):
    system = _k6_system(kind)
    suffix, field = K6_SYSTEMS[kind]
    R = 20001
    wl, params, aim, coeffs, Px, Py, ins, cots = _k6_inputs(system, field,
                                                             R, 5)
    nc = coeffs.shape[1]
    spec = ftr.fast_spec(system, field=True)
    ftr.reset_launch_counts()
    ft.reset_launch_counts()
    # K5a, K5b
    metre = kind == "hubble"
    _close(ftr.trace_fwd(params, spec, ins, coeffs),
           ftr.trace_fast_plain(params, spec, ins, coeffs), 1e-10,
           f"{kind} trace_fwd", metre)
    din, flat = ftr.trace_bwd(params, spec, nc, ins, cots, coeffs)
    din_p, flat_p = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots,
                                             coeffs)
    _close(din, din_p, 1e-10, f"{kind} trace_bwd input cotangent", metre,
           positions=False)
    _flat_close(flat, flat_p, f"{kind} trace_bwd", metre)
    S = len(spec[0])
    dco = flat_p[S * 15:].reshape(S, nc)
    if "asphere" in kind:
        assert float(dco[1].abs().min()) > 0
    else:
        assert float(dco.abs().max()) == 0
    # K1, K4
    out = ftr.trace_field_fwd(params, aim, spec, Px, Py, coeffs)
    _close(out, ftr.trace_fast_field_plain(params, aim, spec, Px, Py, coeffs),
           1e-10, f"{kind} trace_field_fwd", metre)
    if kind == "hubble":  # the obscuration clips rays
        assert 0 < int((out[6] == 0).sum()) < R
    _flat_close(ftr.trace_field_bwd(params, aim, spec, nc, Px, Py, cots,
                                    coeffs),
                ftr.trace_fast_field_bwd_plain(params, aim, spec, nc, Px, Py,
                                               cots, coeffs),
                f"{kind} trace_field_bwd", metre)
    # K2, K3
    mspec = ft._spec_of(system)
    rows = ft.merit_fwd(params, aim, mspec, R, Px=Px, Py=Py, coeffs=coeffs)
    rows_p = ft.merit_fwd_plain(params, aim, mspec, R, Px=Px, Py=Py,
                                coeffs=coeffs)
    loss, xbar, ybar = ft._chan_combine(rows, R)
    assert float(loss) == pytest.approx(
        float(ft._chan_combine(rows_p, R)[0]), rel=1e-12)
    stats = torch.stack([xbar, ybar, 1.0 / R + 0 * xbar, 0 * xbar])
    _flat_close(ft.merit_bwd(params, aim, stats, mspec, nc, R, Px=Px, Py=Py,
                             coeffs=coeffs),
                ft.merit_bwd_plain(params, aim, stats, mspec, nc, R, Px=Px,
                                   Py=Py, coeffs=coeffs),
                f"{kind} merit_bwd", metre)
    names = ("trace_fwd", "trace_bwd", "trace_field_fwd", "trace_field_bwd")
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES,
                                 **{n + suffix: 1 for n in names})
    msuf = "_deep" if suffix == "_deep" else (
        "_sag" if "asphere" in kind else "")
    assert ft.LAUNCHES == _only(ft.LAUNCHES, **{"merit_fwd" + msuf: 1,
                                                "merit_bwd" + msuf: 1})


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tilted_asphere", "hubble", "objective26"])
def test_k6_kernels_f32_match_plain_f32(cuda_device, kind):
    system = _k6_system(kind)
    _, field = K6_SYSTEMS[kind]
    R = 20001
    wl, params, aim, coeffs, Px, Py, ins, cots = _k6_inputs(
        system, field, R, 6, torch.float32)
    nc = coeffs.shape[1]
    spec = ftr.fast_spec(system, field=True)

    def l2(a, b):
        return float(torch.linalg.vector_norm(a.double() - b.double())
                     / torch.linalg.vector_norm(b.double()))

    for a, b in ((ftr.trace_fwd(params, spec, ins, coeffs),
                  ftr.trace_fast_plain(params, spec, ins, coeffs)),
                 (ftr.trace_field_fwd(params, aim, spec, Px, Py, coeffs),
                  ftr.trace_fast_field_plain(params, aim, spec, Px, Py,
                                             coeffs))):
        _near([u.double() for u in a], [v.double() for v in b], kind,
              kind == "hubble")
    din, flat = ftr.trace_bwd(params, spec, nc, ins, cots, coeffs)
    din_p, flat_p = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots,
                                             coeffs)
    assert l2(flat, flat_p) <= 1e-3
    assert l2(ftr.trace_field_bwd(params, aim, spec, nc, Px, Py, cots,
                                  coeffs),
              ftr.trace_fast_field_bwd_plain(params, aim, spec, nc, Px, Py,
                                             cots, coeffs)) <= 1e-3


@pytest.mark.cuda
def test_k6_poly_and_pol_kernels_match_plain(cuda_device):
    from optiland_torch.ops import pol_trace as pt

    # the poly mode of K5a/K5b on the tilted asphere
    system = perturbed.tilted_asphere().system
    R = 20001
    wl, params, _, coeffs, _, _, ins, cots = _k6_inputs(system, (0.0, 0.0),
                                                        R, 7)
    nc = coeffs.shape[1]
    spec = ftr.poly_spec(system)
    pm = ftr.build_poly_table(system).contiguous()
    mats = system.stack.mat_coeffs.contiguous()
    w = torch.tensor([0.48, 0.55, 0.65], dtype=torch.float64,
                     device=cuda_device).repeat(R // 3 + 1)[:R].contiguous()
    rays9 = ins + [w]
    ftr.reset_launch_counts()
    _close(ftr.trace_fwd_poly(pm, mats, spec, rays9, coeffs),
           ftr.trace_fwd_poly_plain(pm, mats, spec, rays9, coeffs), 1e-10,
           "trace_fwd_poly")
    din, flat = ftr.trace_bwd_poly(pm, mats, spec, nc, rays9, cots, coeffs)
    din_p, flat_p = ftr.trace_bwd_poly_plain(pm, mats, spec, nc, rays9, cots,
                                             coeffs)
    _close(din, din_p, 1e-10, "trace_bwd_poly input cotangent")
    _flat_close(flat, flat_p, "trace_bwd_poly")
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_poly_sag=1,
                                 trace_bwd_poly_sag=1)
    # K8, K9: the coated asphere, H, both modes
    system = perturbed.coated_asphere("H").system
    wl, params, _, coeffs, _, _, ins, cots = _k6_inputs(system, (0.0, 0.0),
                                                        R, 8)
    spec = pt.pol_spec(system, wl)
    coat = pt.build_coat_table(system, wl, torch.float64, cuda_device)
    g = torch.Generator(device="cpu").manual_seed(9)
    cots26 = [torch.randn(R, generator=g, dtype=torch.float64).to(
        cuda_device) for _ in range(pt.N_POL)]
    pt.reset_launch_counts()
    for intensity, states in (
            (False, None), (True, pt.pol_states(create_polarization("H")))):
        c = cots26[:8] if intensity else cots26
        _pol_out_close(
            pt.pol_fwd(params, coat, spec, ins, states, intensity, coeffs),
            pt.pol_fwd_plain(params, coat, spec, ins, states, intensity,
                             coeffs), f"pol_fwd {intensity}")
        din, flat = pt.pol_bwd(params, coat, spec, nc, ins, c, states,
                               intensity, coeffs)
        din_p, flat_p = pt.pol_bwd(params.cpu(), coat.cpu(), spec, nc,
                                   [t.cpu() for t in ins],
                                   [t.cpu() for t in c], states, intensity,
                                   coeffs.cpu())
        _close([t.cpu() for t in din], din_p, 1e-10, "pol_bwd input cot")
        _flat_close(flat.cpu(), flat_p, f"pol_bwd {intensity}")
    assert pt.LAUNCHES == _only(pt.LAUNCHES, pol_fwd_sag=1, pol_bwd_sag=1,
                                pol_fwd_intensity_sag=1,
                                pol_bwd_intensity_sag=1)


@pytest.mark.cuda
def test_deep_poly_and_pol_kernels_match_plain(cuda_device):
    """The deep builds of the poly mode (K5a/K5b) and of the polarized
    kernels (K8/K9, both modes) on 18 surfaces: eight thin plates, Fresnel
    coated and polarized for K8/K9."""
    from optiland_torch.ops import pol_trace as pt

    system = _plates(8)
    R = 20001
    _, _, _, coeffs, _, _, ins, cots = _k6_inputs(system, H, R, 10)
    nc = coeffs.shape[1]
    spec = ftr.poly_spec(system)
    pm = ftr.build_poly_table(system).contiguous()
    mats = system.stack.mat_coeffs.contiguous()
    w = torch.tensor([0.48, 0.55, 0.65], dtype=torch.float64,
                     device=cuda_device).repeat(R // 3 + 1)[:R].contiguous()
    rays9 = ins + [w]
    ftr.reset_launch_counts()
    _close(ftr.trace_fwd_poly(pm, mats, spec, rays9, coeffs),
           ftr.trace_fwd_poly_plain(pm, mats, spec, rays9, coeffs), 1e-10,
           "deep trace_fwd_poly")
    din, flat = ftr.trace_bwd_poly(pm, mats, spec, nc, rays9, cots, coeffs)
    din_p, flat_p = ftr.trace_bwd_poly_plain(pm, mats, spec, nc, rays9, cots,
                                             coeffs)
    _close(din, din_p, 1e-10, "deep trace_bwd_poly input cotangent")
    _flat_close(flat, flat_p, "deep trace_bwd_poly")
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_poly_deep=1,
                                 trace_bwd_poly_deep=1)
    lens = Optic()
    lens.surfaces.add(index=0, radius=float("inf"), thickness=float("inf"))
    for k in range(8):
        lens.surfaces.add(radius=float("inf"), thickness=1.0,
                          material="N-BK7", is_stop=k == 0, coating="fresnel")
        lens.surfaces.add(radius=-200.0 * (k + 1), thickness=2.0,
                          coating="fresnel")
    lens.surfaces.add()
    lens.set_aperture(aperture_type="EPD", value=10)
    lens.fields.add(y=0)
    lens.wavelengths.add(value=0.55, is_primary=True)
    lens.set_polarization("H")
    system = lens.system
    spec = pt.pol_spec(system, WL)
    params = ft.build_param_table(system, WL).contiguous()
    coat = pt.build_coat_table(system, WL, torch.float64, cuda_device)
    g = torch.Generator(device="cpu").manual_seed(11)
    cots26 = [torch.randn(R, generator=g, dtype=torch.float64).to(
        cuda_device) for _ in range(pt.N_POL)]
    pt.reset_launch_counts()
    for intensity, states in (
            (False, None), (True, pt.pol_states(create_polarization("H")))):
        c = cots26[:8] if intensity else cots26
        _pol_out_close(
            pt.pol_fwd(params, coat, spec, ins, states, intensity, coeffs),
            pt.pol_fwd_plain(params, coat, spec, ins, states, intensity,
                             coeffs), f"deep pol_fwd {intensity}")
        din, flat = pt.pol_bwd(params, coat, spec, nc, ins, c, states,
                               intensity, coeffs)
        din_p, flat_p = pt.pol_bwd_plain(params, coat, spec, ins, c, states,
                                         intensity, coeffs, nc,
                                         with_coeffs=True)
        _close(din, din_p, 1e-10, "deep pol_bwd input cotangent")
        _flat_close(flat, flat_p, f"deep pol_bwd {intensity}")
    assert pt.LAUNCHES == _only(pt.LAUNCHES, pol_fwd_deep=1, pol_bwd_deep=1,
                                pol_fwd_intensity_deep=1,
                                pol_bwd_intensity_deep=1)


@pytest.mark.cuda
def test_asphere_path_launches_sag_builds(cuda_device):
    """The entry points on the tilted asphere run the sag builds and none
    of the stock ones, with every stack leaf's gradient finite, the
    coefficients' nonzero."""
    system = perturbed.tilted_asphere().system
    Px, Py = ft.prng_disk(3, 4097, 0, torch.float64, cuda_device)
    ft.reset_launch_counts()
    ftr.reset_launch_counts()
    s2, leaves = _leaf_system(system)
    ft.spot_rms_fast_field(s2, 0.0, 0.0, 0.587, num_rays=4097,
                           seed=2).backward()
    assert float(leaves["coeffs"].grad[1].abs().min()) > 0
    s2, leaves = _leaf_system(system)
    out = ftr.trace_fast_field(s2, 0.0, 0.0, Px, Py, 0.587)
    (out.y.square().mean() + out.opd.mean()).backward()
    assert float(leaves["coeffs"].grad[1].abs().min()) > 0
    s2, leaves = _leaf_system(system)
    spot.rms_spot_size(s2, 0.0, 0.0, Px, Py, 0.587).backward()
    assert float(leaves["coeffs"].grad[1].abs().min()) > 0
    torch.cuda.synchronize()
    assert ft.LAUNCHES == _only(ft.LAUNCHES, prng_disk=0, merit_fwd_sag=1,
                                merit_bwd_sag=1)
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_field_fwd_sag=1,
                                 trace_field_bwd_sag=1, trace_fwd_sag=1,
                                 trace_bwd_sag=1)


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
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd=6)
    system = CookeTriplet().system
    s2, leaves = _leaf_system(system)
    hu.reset_launch_counts()
    ftr.reset_launch_counts()
    psf, _, _ = huygens_psf(s2, *H, WL, num_rays=32, image_size=16)
    psf[8, 8].backward()
    torch.cuda.synchronize()
    assert hu.LAUNCHES == {"huygens_fwd": 2, "huygens_bwd_img": 2,
                           "huygens_bwd_pup": 2}
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd=6, trace_bwd=6)
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


# ---------------------------------------------------------------------------
# The polarized kernels K8, K9
# ---------------------------------------------------------------------------


def _pol_case(kind, state, R, seed, device):
    """A polarized system of one coat kind, its tables, a launch bundle with
    random intensities and path lengths, and random output cotangents of
    both modes (numpy seed)."""
    import numpy as np

    import torch_pol_systems as tps
    from optiland_torch.ops import pol_trace as pt
    from optiland_torch.polarization import create_polarization

    system = tps.build(kind, "torch").system
    spec = pt.pol_spec(system, WL)
    assert spec is not None, kind
    rng = np.random.default_rng(seed)
    Px, Py = (torch.tensor(v, device=device) for v in tps.pupil(R, seed))
    with torch.no_grad():
        rays = raygen.generate_rays(system, 0.0, 0.0 if kind == "mirror"
                                    else 0.5, Px, Py, WL)
        ins = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
        params = ft.build_param_table(system, WL).contiguous()
    ins[6] = torch.tensor(0.5 + 0.5 * rng.uniform(size=R), device=device)
    ins[7] = torch.tensor(rng.uniform(size=R), device=device)
    cots = [torch.tensor(rng.normal(size=R), device=device)
            for _ in range(pt.N_POL)]
    coat = pt.build_coat_table(system, WL, torch.float64, device)
    states = pt.pol_states(None if state == "unpolarized"
                           else create_polarization(state))
    return system, spec, params, coat, ins, cots, states


@pytest.mark.cuda
@pytest.mark.parametrize("state", ["H", "unpolarized"])
@pytest.mark.parametrize("kind", ["fresnel", "none", "simple", "polarizer",
                                  "retarder", "tmm", "mirror"])
def test_pol_kernels_match_plain_f64(cuda_device, kind, state):
    from optiland_torch.ops import pol_trace as pt

    system, spec, params, coat, ins, cots, states = _pol_case(
        kind, state, 20001, 7, cuda_device)
    nc = system.stack.coeffs.shape[1]
    for intensity in (False, True):
        c = cots[:8] if intensity else cots
        got = pt.pol_fwd(params, coat, spec, ins, states, intensity)
        ref = pt.pol_fwd_plain(params, coat, spec, ins, states, intensity)
        _close(got[:8], ref[:8], 1e-10, f"pol_fwd {kind} {intensity}")
        # p's entries against the largest: some vanish exactly, and their
        # rounding noise has no scale of its own
        p_scale = max([float(v.abs().max()) for v in ref[8:]] + [0.0])
        for k, (a, b) in enumerate(zip(got[8:], ref[8:])):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12 * p_scale,
                                       msg=f"pol_fwd {kind} p entry {k}")
        din, flat = pt.pol_bwd(params, coat, spec, nc, ins, c, states,
                               intensity)
        din_p, flat_p = pt.pol_bwd(params.cpu(), coat.cpu(), spec, nc,
                                   [t.cpu() for t in ins],
                                   [t.cpu() for t in c], states, intensity)
        _close([t.cpu() for t in din], din_p, 1e-10,
               f"pol_bwd {kind} {intensity} input cotangent")
        torch.testing.assert_close(flat.cpu(), flat_p, rtol=1e-9,
                                   atol=1e-12 * float(flat_p.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fresnel", "tmm", "polarizer"])
def test_pol_kernels_f32_match_f64(cuda_device, kind):
    from optiland_torch.ops import pol_trace as pt

    system, spec, params, coat, ins, cots, states = _pol_case(
        kind, "H", 20001, 8, cuda_device)
    nc = system.stack.coeffs.shape[1]
    p32, c32 = params.float(), coat.float()
    ins32 = [t.float() for t in ins]

    def l2(a, b):
        return float(torch.linalg.vector_norm(a.double() - b)
                     / torch.linalg.vector_norm(b))

    for intensity in (False, True):
        c = cots[:8] if intensity else cots
        _near(pt.pol_fwd(p32, c32, spec, ins32, states, intensity),
              pt.pol_fwd_plain(params, coat, spec, ins, states, intensity),
              f"pol_fwd f32 {intensity}")
        din, flat = pt.pol_bwd(p32, c32, spec, nc, ins32,
                               [t.float() for t in c], states, intensity)
        din_p, flat_p = pt.pol_bwd(params, coat, spec, nc, ins, c, states,
                                   intensity)
        assert l2(flat, flat_p) <= 1e-3
        _near(din[:6], din_p[:6], f"pol_bwd f32 {intensity}")


@pytest.mark.cuda
def test_pol_trace_dispatch(cuda_device):
    import torch_pol_systems as tps
    from optiland_torch.ops import pol_trace as pt

    Px, Py = (torch.tensor(v, device=cuda_device) for v in tps.pupil(999, 4))
    # a pol_supported system runs K8 (and K9 under autograd)
    system = tps.build("fresnel", "torch").system
    s2, leaves = _leaf_system(system)
    pt.reset_launch_counts()
    ftr.reset_launch_counts()
    rays = raygen.generate_rays(s2, *H, Px, Py, WL)
    out, hist = trace_core.trace(s2, rays, record=False, wavelength=WL)
    p = hist["p"]
    (out.y.square().mean() + (p.real.square() + p.imag.square()).mean()
     ).backward()
    torch.cuda.synchronize()
    assert pt.LAUNCHES == _only(pt.LAUNCHES, pol_fwd=1, pol_bwd=1)
    assert sum(ftr.LAUNCHES.values()) == 0
    assert torch.isfinite(leaves["radius"].grad[1:-1]).all()
    # the same rays through the plain engine (with a history)
    rays = raygen.generate_rays(system, *H, Px, Py, WL)
    _, href = trace_core.trace(system, rays, record=True, wavelength=WL)
    torch.testing.assert_close(p.detach(), href["p"], rtol=1e-9, atol=1e-12)
    # a tilted one runs the polarized kernel too, and agrees with the plain
    # engine
    rx = torch.zeros(system.cfg.num_surfaces, dtype=torch.float64,
                     device=cuda_device)
    rx[1] = 0.01
    tilted = system.replace(
        stack=system.stack.replace(rx=system.stack.rx + rx),
        cfg=dataclasses.replace(system.cfg, has_tilts=True))
    trays = raygen.generate_rays(tilted, *H, Px, Py, WL)
    pt.reset_launch_counts()
    out_t, hist_t = trace_core.trace(tilted, trays, record=False,
                                     wavelength=WL)
    _, href_t = trace_core.trace(tilted, trays, record=True, wavelength=WL)
    assert pt.LAUNCHES == _only(pt.LAUNCHES, pol_fwd_tilt=1)
    torch.testing.assert_close(hist_t["p"], href_t["p"], rtol=1e-9,
                               atol=1e-12)
    # what the JAX package's kernels would not take either runs the plain
    # engine: an absorbing thin-film stack, an unpolarized coated system
    pt.reset_launch_counts()
    absorbing = tps.pol_doublet("torch", coat=tps.tmm_coating(
        "torch", absorbing=True)).system
    assert not pt.kernel_eligible(absorbing, WL)
    rays = raygen.generate_rays(absorbing, *H, Px, Py, WL)
    out, hist = trace_core.trace(absorbing, rays, record=False, wavelength=WL)
    assert torch.isfinite(hist["p"]).all()
    from optiland_torch.coatings import SimpleCoating

    plain = tps.pol_doublet("torch", pol=None, coat=SimpleCoating(0.9, 0.05))
    rays = raygen.generate_rays(plain.system, *H, Px, Py, WL)
    out, hist = trace_core.trace(plain.system, rays, record=False,
                                 wavelength=WL)
    assert hist is None and torch.isfinite(out.i).all()
    assert sum(pt.LAUNCHES.values()) == 0 and sum(ftr.LAUNCHES.values()) == 0


@pytest.mark.cuda
def test_pol_intensity_entry_and_vectorial_psf_launches(cuda_device):
    import torch_pol_systems as tps
    from optiland_torch.ops import pol_trace as pt
    from optiland_torch.polarization import (
        create_polarization, polarized_intensity,
    )
    from optiland_torch.psf import HuygensPSF, VectorialHuygensPSF

    system = tps.build("fresnel", "torch").system
    state = create_polarization("H")
    Px, Py = (torch.tensor(v, device=cuda_device) for v in tps.pupil(3001, 5))
    s2, leaves = _leaf_system(system)
    pt.reset_launch_counts()
    rays = raygen.generate_rays(s2, *H, Px, Py, WL)
    out = pt.trace_fast_pol_intensity(s2, rays, WL, state=state)
    (out.x * out.i).square().mean().backward()
    torch.cuda.synchronize()
    assert pt.LAUNCHES == _only(pt.LAUNCHES, pol_fwd_intensity=1,
                                pol_bwd_intensity=1)
    with torch.no_grad():
        full, p = pt.trace_fast_pol(system, rays, WL)
        i_ref = polarized_intensity(p, state, rays.L, rays.M, rays.N, rays.i)
    torch.testing.assert_close(out.i.detach(), i_ref, rtol=1e-10, atol=1e-13)
    hu.reset_launch_counts()
    pt.reset_launch_counts()
    psf = HuygensPSF(tps.pol_doublet("torch", epd=4.0), (0.0, 0.0), WL,
                     num_rays=32, image_size=16)
    torch.cuda.synchronize()
    assert isinstance(psf, VectorialHuygensPSF)
    # 3 components x (field sum, normalization); 4 traces (chief ray,
    # pupil, image grid, working F-number)
    assert hu.LAUNCHES == {"huygens_fwd": 6, "huygens_bwd_img": 0,
                           "huygens_bwd_pup": 0}
    assert pt.LAUNCHES == _only(pt.LAUNCHES, pol_fwd=4)
    assert 0 < psf.strehl_ratio() <= 1.2


# ---------------------------------------------------------------------------
# The polychromatic mode of K5a/K5b and the tilt branch of every kernel
# ---------------------------------------------------------------------------


def _poly_system(kind, device):
    system = CookeTriplet().system
    if kind == "zoo":
        system = perturbed.zoo_system(system)
    elif kind == "tilted":
        system = perturbed.toleranced_cooke().system
    return system


def _poly_inputs(system, R, seed, device):
    Px, Py = ft.prng_disk_plain(seed, R, 0, torch.float64, device)
    ins, cots = _bundle(system, Px, Py, seed)
    w = torch.tensor((0.48, 0.55, 0.65), dtype=torch.float64,
                     device=device).repeat(-(-R // 3))[:R]
    with torch.no_grad():
        params = ftr.build_poly_table(system).contiguous()
    mats = system.stack.mat_coeffs.detach().contiguous()
    return params, mats, ins + [w], cots


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cooke", "zoo", "tilted"])
def test_poly_kernels_match_plain_f64(cuda_device, kind):
    system = _poly_system(kind, cuda_device)
    spec = ftr.poly_spec(system)
    R, nc = 50001, system.stack.coeffs.shape[1]
    params, mats, ins, cots = _poly_inputs(system, R, 4, cuda_device)
    _close(ftr.trace_fwd_poly(params, mats, spec, ins),
           ftr.trace_fwd_poly_plain(params, mats, spec, ins), 1e-10,
           "trace_fwd_poly")
    din, flat = ftr.trace_bwd_poly(params, mats, spec, nc, ins, cots)
    din_p, flat_p = ftr.trace_bwd_poly_plain(params, mats, spec, nc, ins,
                                             cots)
    _close(din, din_p, 1e-10, "trace_bwd_poly input cotangent")
    fin = torch.isfinite(flat_p)
    assert torch.equal(fin, torch.isfinite(flat))
    torch.testing.assert_close(flat[fin], flat_p[fin], rtol=1e-9,
                               atol=1e-12 * float(flat_p[fin].abs().max()))
    # every coefficient column of every refracting surface's row
    dm = flat_p[-mats.numel():].reshape(mats.shape)
    assert (dm[1] != 0).sum() > 1


@pytest.mark.cuda
def test_poly_kernels_f32_match_f64(cuda_device):
    system = _poly_system("cooke", cuda_device)
    spec = ftr.poly_spec(system)
    R, nc = 50001, system.stack.coeffs.shape[1]
    params, mats, ins, cots = _poly_inputs(system, R, 5, cuda_device)
    ins32, cots32 = [t.float() for t in ins], [t.float() for t in cots]
    _near(ftr.trace_fwd_poly(params.float(), mats.float(), spec, ins32),
          ftr.trace_fwd_poly_plain(params, mats, spec, ins),
          "trace_fwd_poly")
    din, flat = ftr.trace_bwd_poly(params.float(), mats.float(), spec, nc,
                                   ins32, cots32)
    din_p, flat_p = ftr.trace_bwd_poly_plain(params, mats, spec, nc, ins,
                                             cots)
    _near(din[:6], din_p[:6], "trace_bwd_poly input cotangent")
    fin = torch.isfinite(flat_p)
    assert float(torch.linalg.vector_norm(flat[fin].double() - flat_p[fin])
                 / torch.linalg.vector_norm(flat_p[fin])) <= 1e-3


@pytest.mark.cuda
def test_poly_entry_point_launches_its_kernels(cuda_device):
    system = CookeTriplet().system
    R = 3000
    Px, Py = ft.prng_disk(6, R, 0, torch.float64, cuda_device)
    w = torch.tensor((0.48, 0.55, 0.65), dtype=torch.float64,
                     device=cuda_device).repeat(R // 3)
    s2, leaves = _leaf_system(system)
    ftr.reset_launch_counts()
    rays = raygen.generate_rays(s2, *H, Px, Py, w)
    out = ftr.trace_fast_poly(s2, rays)
    ((out.x - out.x.mean()) ** 2 + (out.y - out.y.mean()) ** 2).mean(
        ).backward()
    torch.cuda.synchronize()
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_poly=1,
                                 trace_bwd_poly=1)
    assert torch.equal(out.w, w)
    # the lens media's rows (the object and image rows reach the paraxial
    # aim, where the reference's own gradient is not finite)
    g = leaves["mat_coeffs"].grad[1:-1]
    assert torch.isfinite(g).all() and (g != 0).any()
    assert torch.isfinite(leaves["radius"].grad[1:-1]).all()


@pytest.mark.cuda
def test_tilted_kernels_match_plain_f64(cuda_device):
    """K1-K5 on the toleranced Cooke triplet, K8/K9 (both modes) on the
    tilted singlet, against their plain versions."""
    from optiland_torch.ops import pol_trace as pt
    from optiland_torch.polarization import create_polarization

    system = perturbed.toleranced_cooke().system
    spec = ftr.fast_spec(system, field=True)
    assert spec[3] == (False,) + (True,) * 6 + (False,)
    R, nc = 50001, system.stack.coeffs.shape[1]
    with torch.no_grad():
        params = ft.build_param_table(system, WL).contiguous()
        aim = ft.aim_vector(system, *H).contiguous()
    Px, Py = ft.prng_disk_plain(9, R, 0, torch.float64, cuda_device)
    ins, cots = _bundle(system, Px, Py, 7)
    _close(ftr.trace_fwd(params, spec, ins),
           ftr.trace_fast_plain(params, spec, ins), 1e-10, "trace_fwd")
    din, flat = ftr.trace_bwd(params, spec, nc, ins, cots)
    din_p, flat_p = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots)
    _close(din, din_p, 1e-10, "trace_bwd input cotangent")
    torch.testing.assert_close(flat, flat_p, rtol=1e-9,
                               atol=1e-12 * float(flat_p.abs().max()))
    _close(ftr.trace_field_fwd(params, aim, spec, Px, Py),
           ftr.trace_fast_field_plain(params, aim, spec, Px, Py), 1e-10,
           "trace_field_fwd")
    flat = ftr.trace_field_bwd(params, aim, spec, nc, Px, Py, cots)
    flat_p = ftr.trace_fast_field_bwd_plain(params, aim, spec, nc, Px, Py,
                                            cots)
    torch.testing.assert_close(flat, flat_p, rtol=1e-9,
                               atol=1e-12 * float(flat_p.abs().max()))
    mspec = ft._spec_of(system)
    rows = ft.merit_fwd(params, aim, mspec, R, Px=Px, Py=Py)
    rows_p = ft.merit_fwd_plain(params, aim, mspec, R, Px=Px, Py=Py)
    loss, xb, yb = ft._chan_combine(rows, R)
    assert float(loss) == pytest.approx(float(ft._chan_combine(rows_p, R)[0]),
                                        rel=1e-12)
    stats = torch.stack([xb, yb, torch.tensor(1.0 / R, device=cuda_device,
                                              dtype=torch.float64),
                         torch.zeros((), device=cuda_device,
                                     dtype=torch.float64)])
    flat = ft.merit_bwd(params, aim, stats, mspec, nc, R, Px=Px, Py=Py)
    flat_p = ft.merit_bwd_plain(params, aim, stats, mspec, nc, R, Px=Px,
                                Py=Py)
    torch.testing.assert_close(flat, flat_p, rtol=1e-9,
                               atol=1e-12 * float(flat_p.abs().max()))
    # the polarized kernels on the tilted singlet
    singlet = perturbed.tilted_singlet().system
    pspec = pt.pol_spec(singlet, WL)
    assert pspec[5][1]
    with torch.no_grad():
        pp = ft.build_param_table(singlet, WL).contiguous()
    coat = pt.build_coat_table(singlet, WL, torch.float64, cuda_device)
    ins, _ = _bundle(singlet, Px, Py, 8)
    g = torch.Generator().manual_seed(8)
    cots = [torch.randn(R, generator=g, dtype=torch.float64).to(cuda_device)
            for _ in range(pt.N_POL)]
    states = pt.pol_states(create_polarization("H"))
    S, nc = len(pspec[0]), singlet.stack.coeffs.shape[1]
    for intensity in (False, True):
        c = cots[:8] if intensity else cots
        st = states if intensity else None
        _close(pt.pol_fwd(pp, coat, pspec, ins, st, intensity),
               pt.pol_fwd_plain(pp, coat, pspec, ins, st, intensity), 1e-10,
               f"pol_fwd intensity={intensity}")
        din, flat = pt.pol_bwd(pp, coat, pspec, nc, ins, c, st, intensity)
        din_p, flat_p = pt.pol_bwd_plain(pp, coat, pspec, ins, c, st,
                                         intensity)
        flat_p = torch.cat([flat_p[: S * ft.NUM_P], pp.new_zeros(S * nc),
                            flat_p[S * ft.NUM_P:]])
        _close(din, din_p, 1e-10, f"pol_bwd din intensity={intensity}")
        torch.testing.assert_close(flat, flat_p, rtol=1e-9,
                                   atol=1e-12 * float(flat_p.abs().max()))


# ---------------------------------------------------------------------------
# K6b, the Cartesian freeforms: the free build
# ---------------------------------------------------------------------------

FREEFORMS = {
    "polynomial": {}, "chebyshev": {}, "toroidal": {}, "biconic": {},
    "polynomial_tilted": {"tilted": True},
    "polynomial_5x5": {"coefficients": freeform.CMAT5},
}


def _free_system(kind):
    return freeform.freeform_singlet(kind.split("_")[0],
                                     **FREEFORMS[kind]).system


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(FREEFORMS))
def test_free_kernels_match_plain_f64(cuda_device, kind):
    system = _free_system(kind)
    R = 20001
    wl, params, aim, coeffs, Px, Py, ins, cots = _k6_inputs(
        system, freeform.H, R, 7)
    nc = coeffs.shape[1]
    spec = ftr.fast_spec(system, field=True)
    S = len(spec[0])
    ftr.reset_launch_counts()
    ft.reset_launch_counts()
    _close(ftr.trace_fwd(params, spec, ins, coeffs),
           ftr.trace_fast_plain(params, spec, ins, coeffs), 1e-10,
           f"{kind} trace_fwd")
    din, flat = ftr.trace_bwd(params, spec, nc, ins, cots, coeffs)
    din_p, flat_p = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots,
                                             coeffs)
    _close(din, din_p, 1e-10, f"{kind} trace_bwd input cotangent",
           positions=False)
    _flat_close(flat, flat_p, f"{kind} trace_bwd")
    # the P_G1 and P_G2 columns (zero for POLYNOMIAL_XY) and the
    # coefficient columns (zero for BICONIC)
    dp = flat_p[:S * 15].reshape(S, 15)
    dco = flat_p[S * 15:].reshape(S, nc)
    assert (float(dp[1, 11:13].abs().min()) > 0) == (
        not kind.startswith("polynomial"))
    assert (float(dco[1].abs().max()) > 0) == (kind != "biconic")
    out = ftr.trace_field_fwd(params, aim, spec, Px, Py, coeffs)
    _close(out, ftr.trace_fast_field_plain(params, aim, spec, Px, Py, coeffs),
           1e-10, f"{kind} trace_field_fwd")
    _flat_close(ftr.trace_field_bwd(params, aim, spec, nc, Px, Py, cots,
                                    coeffs),
                ftr.trace_fast_field_bwd_plain(params, aim, spec, nc, Px, Py,
                                               cots, coeffs),
                f"{kind} trace_field_bwd")
    mspec = ft._spec_of(system)
    rows = ft.merit_fwd(params, aim, mspec, R, Px=Px, Py=Py, coeffs=coeffs)
    rows_p = ft.merit_fwd_plain(params, aim, mspec, R, Px=Px, Py=Py,
                                coeffs=coeffs)
    loss, xbar, ybar = ft._chan_combine(rows, R)
    assert float(loss) == pytest.approx(
        float(ft._chan_combine(rows_p, R)[0]), rel=1e-12)
    stats = torch.stack([xbar, ybar, 1.0 / R + 0 * xbar, 0 * xbar])
    _flat_close(ft.merit_bwd(params, aim, stats, mspec, nc, R, Px=Px, Py=Py,
                             coeffs=coeffs),
                ft.merit_bwd_plain(params, aim, stats, mspec, nc, R, Px=Px,
                                   Py=Py, coeffs=coeffs),
                f"{kind} merit_bwd")
    names = ("trace_fwd", "trace_bwd", "trace_field_fwd", "trace_field_bwd")
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES,
                                 **{n + "_free": 1 for n in names})
    assert ft.LAUNCHES == _only(ft.LAUNCHES, merit_fwd_free=1,
                                merit_bwd_free=1)


@pytest.mark.cuda
def test_free_poly_and_pol_kernels_match_plain(cuda_device):
    """The free build's poly mode on the Chebyshev singlet and K8/K9 (both
    modes) on the Fresnel-coated XY singlet."""
    system = _free_system("chebyshev")
    R = 20001
    wl, _, _, coeffs, _, _, ins, cots = _k6_inputs(system, freeform.H, R, 8)
    nc = coeffs.shape[1]
    spec = ftr.poly_spec(system)
    params = ftr.build_poly_table(system).contiguous()
    mats = system.stack.mat_coeffs.contiguous()
    w = torch.tensor([0.48, 0.55, 0.65], dtype=torch.float64,
                     device=cuda_device)[torch.arange(R, device=cuda_device)
                                         % 3]
    ins9 = ins + [w]
    ftr.reset_launch_counts()
    _close(ftr.trace_fwd_poly(params, mats, spec, ins9, coeffs),
           ftr.trace_fwd_poly_plain(params, mats, spec, ins9, coeffs), 1e-10,
           "chebyshev trace_fwd_poly")
    din, flat = ftr.trace_bwd_poly(params, mats, spec, nc, ins9, cots, coeffs)
    din_p, flat_p = ftr.trace_bwd_poly_plain(params, mats, spec, nc, ins9,
                                             cots, coeffs)
    _close(din, din_p, 1e-10, "chebyshev trace_bwd_poly input cotangent",
           positions=False)
    _flat_close(flat, flat_p, "chebyshev trace_bwd_poly")
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_poly_free=1,
                                 trace_bwd_poly_free=1)
    from optiland_torch.ops import pol_trace as pt

    csys = freeform.coated_freeform("polynomial", "H").system
    wl, params, _, coeffs, _, _, ins, _ = _k6_inputs(csys, freeform.H, R, 9)
    pspec = pt.pol_spec(csys, wl)
    coat = pt.build_coat_table(csys, wl, torch.float64, cuda_device)
    g = torch.Generator(device="cpu").manual_seed(9)
    cots = [torch.randn(R, generator=g, dtype=torch.float64).to(cuda_device)
            for _ in range(pt.N_POL)]
    pt.reset_launch_counts()
    for states, intensity in ((None, False),
                              (pt.pol_states(create_polarization("H")),
                               True)):
        c = cots[:8] if intensity else cots
        _pol_out_close(pt.pol_fwd(params, coat, pspec, ins, states,
                                  intensity, coeffs),
                       pt.pol_fwd_plain(params, coat, pspec, ins, states,
                                        intensity, coeffs), "coated XY")
        din, flat = pt.pol_bwd(params, coat, pspec, nc, ins, c, states,
                               intensity, coeffs)
        din_p, flat_p = pt.pol_bwd_plain(params, coat, pspec, ins, c, states,
                                         intensity, coeffs, nc,
                                         with_coeffs=True)
        _close(din, din_p, 1e-10, "coated XY pol_bwd input cotangent",
               positions=False)
        _flat_close(flat, flat_p, "coated XY pol_bwd")
    assert pt.LAUNCHES == _only(pt.LAUNCHES, pol_fwd_free=1, pol_bwd_free=1,
                                pol_fwd_intensity_free=1,
                                pol_bwd_intensity_free=1)


@pytest.mark.cuda
def test_free_entry_points_launch_the_free_build(cuda_device):
    """spot_rms_fast_field, trace_fast_field and Optic.trace of the XY
    singlet run the free build, with the gradient of every leaf finite and
    matching the plain versions on the CPU."""
    lens = freeform.freeform_singlet("polynomial")
    system = lens.system
    ftr.reset_launch_counts()
    ft.reset_launch_counts()
    Px, Py = ft.prng_disk(5, 4001, 0, torch.float64, cuda_device)
    loss = ft.spot_rms_fast_field(system, *freeform.H, WL, Px=Px, Py=Py)
    f = ftr.trace_fast_field(system, *freeform.H, Px, Py, WL)
    res = lens.trace(Hx=0.3, Hy=0.7, num_rays=8, record=False)
    assert torch.isfinite(loss) and torch.isfinite(f.x).all()
    assert torch.isfinite(res.x).all()
    assert ft.LAUNCHES == _only(ft.LAUNCHES, prng_disk=1, merit_fwd_free=1)
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_field_fwd_free=1,
                                 trace_fwd_free=1)
    config.set_device("cpu")
    ref = freeform.freeform_singlet("polynomial").system
    loss_p = ft.spot_rms_fast_field(ref, *freeform.H, WL, Px=Px.cpu(),
                                    Py=Py.cpu())
    assert float(loss) == pytest.approx(float(loss_p), rel=1e-12)


@pytest.mark.cuda
def test_deep_build_takes_the_freeforms(cuda_device):
    """Past 16 surfaces a system with a freeform runs the deep_free build,
    the deep build with the Cartesian families: nine plates, the first
    surface an XY table and the second a toroid, against the plain
    versions."""
    lens = Optic()
    lens.surfaces.add(index=0, radius=float("inf"), thickness=float("inf"))
    lens.surfaces.add(surface_type="polynomial", radius=50.0, conic=-0.5,
                      coefficients=freeform.CMAT, thickness=1.0,
                      material="N-BK7", is_stop=True)
    lens.surfaces.add(surface_type="toroidal", radius_x=-300.0,
                      radius_y=-200.0, conic=-0.5,
                      toroidal_coeffs_poly_y=(1e-6,), thickness=2.0)
    for k in range(1, 9):
        lens.surfaces.add(radius=float("inf"), thickness=1.0,
                          material="N-BK7")
        lens.surfaces.add(radius=-200.0 * (k + 1), thickness=2.0)
    lens.surfaces.add()
    lens.set_aperture(aperture_type="EPD", value=10)
    lens.fields.set_type(field_type="angle")
    lens.fields.add(y=0)
    lens.fields.add(y=1)
    lens.wavelengths.add(value=0.55, is_primary=True)
    system = lens.system
    assert system.cfg.num_surfaces == 20
    R = 8001
    wl, params, aim, coeffs, Px, Py, ins, cots = _k6_inputs(system, H, R, 11)
    nc = coeffs.shape[1]
    spec = ftr.fast_spec(system, field=True)
    ftr.reset_launch_counts()
    _close(ftr.trace_fwd(params, spec, ins, coeffs),
           ftr.trace_fast_plain(params, spec, ins, coeffs), 1e-10,
           "deep freeform trace_fwd")
    din, flat = ftr.trace_bwd(params, spec, nc, ins, cots, coeffs)
    din_p, flat_p = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots,
                                             coeffs)
    _close(din, din_p, 1e-10, "deep freeform trace_bwd input cotangent",
           positions=False)
    _flat_close(flat, flat_p, "deep freeform trace_bwd")
    dp = flat_p[:20 * 15].reshape(20, 15)
    assert float(dp[2, 11:13].abs().min()) > 0  # the toroid's p1, p2
    mspec = ft._spec_of(system)
    rows = ft.merit_fwd(params, aim, mspec, R, Px=Px, Py=Py, coeffs=coeffs)
    loss, xbar, ybar = ft._chan_combine(rows, R)
    stats = torch.stack([xbar, ybar, 1.0 / R + 0 * xbar, 0 * xbar])
    _flat_close(ft.merit_bwd(params, aim, stats, mspec, nc, R, Px=Px, Py=Py,
                             coeffs=coeffs),
                ft.merit_bwd_plain(params, aim, stats, mspec, nc, R, Px=Px,
                                   Py=Py, coeffs=coeffs),
                "deep freeform merit_bwd")
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_deep_free=1,
                                 trace_bwd_deep_free=1)


# ---------------------------------------------------------------------------
# K6b, the aux-bearing families (ZERNIKE_SAG, FORBES_QBFS, FORBES_Q2D): the
# aux build, with the laid-out rows and the layout table
# ---------------------------------------------------------------------------

AUX_SYSTEMS = {
    "zernike": {}, "forbes_qbfs": {}, "forbes_q2d": {},
    "zernike_tilted": {"tilted": True},
    "zernike_36": {"coefficients": freeform.ZC36},
}


def _aux_system(kind):
    fam = "zernike" if kind.startswith("zernike") else kind
    return freeform.freeform_singlet(fam, **AUX_SYSTEMS[kind]).system


def _aux_tables(system, dtype=torch.float64):
    from optiland_torch.ops import launch

    with torch.no_grad():
        return launch.kernel_tables(system, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(AUX_SYSTEMS))
def test_aux_kernels_match_plain_f64(cuda_device, kind):
    system = _aux_system(kind)
    R = 20001
    wl, params, aim, _, Px, Py, ins, cots = _k6_inputs(
        system, freeform.H, R, 7)
    coeffs, lay = _aux_tables(system)
    nc = coeffs.shape[1]
    if kind == "zernike_36":
        assert nc == 36  # NC_MAX
    spec = ftr.fast_spec(system, field=True)
    S = len(spec[0])
    ftr.reset_launch_counts()
    ft.reset_launch_counts()
    _close(ftr.trace_fwd(params, spec, ins, coeffs, lay),
           ftr.trace_fast_plain(params, spec, ins, coeffs, lay), 1e-10,
           f"{kind} trace_fwd")
    din, flat = ftr.trace_bwd(params, spec, nc, ins, cots, coeffs, lay)
    din_p, flat_p = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots,
                                             coeffs, lay)
    _close(din, din_p, 1e-10, f"{kind} trace_bwd input cotangent",
           positions=False)
    _flat_close(flat, flat_p, f"{kind} trace_bwd")
    # the P_G1 column (norm radius) and the slot columns; no P_G2
    dp = flat_p[:S * 15].reshape(S, 15)
    assert float(dp[1, 11].abs()) > 0 and float(dp[1, 12]) == 0
    assert float(flat_p[S * 15:].reshape(S, nc)[1].abs().max()) > 0
    out = ftr.trace_field_fwd(params, aim, spec, Px, Py, coeffs, lay)
    _close(out, ftr.trace_fast_field_plain(params, aim, spec, Px, Py, coeffs,
                                           lay), 1e-10,
           f"{kind} trace_field_fwd")
    _flat_close(ftr.trace_field_bwd(params, aim, spec, nc, Px, Py, cots,
                                    coeffs, lay),
                ftr.trace_fast_field_bwd_plain(params, aim, spec, nc, Px, Py,
                                               cots, coeffs, lay),
                f"{kind} trace_field_bwd")
    mspec = ft._spec_of(system)
    rows = ft.merit_fwd(params, aim, mspec, R, Px=Px, Py=Py, coeffs=coeffs,
                        lay=lay)
    rows_p = ft.merit_fwd_plain(params, aim, mspec, R, Px=Px, Py=Py,
                                coeffs=coeffs, lay=lay)
    loss, xbar, ybar = ft._chan_combine(rows, R)
    assert float(loss) == pytest.approx(
        float(ft._chan_combine(rows_p, R)[0]), rel=1e-12)
    stats = torch.stack([xbar, ybar, 1.0 / R + 0 * xbar, 0 * xbar])
    _flat_close(ft.merit_bwd(params, aim, stats, mspec, nc, R, Px=Px, Py=Py,
                             coeffs=coeffs, lay=lay),
                ft.merit_bwd_plain(params, aim, stats, mspec, nc, R, Px=Px,
                                   Py=Py, coeffs=coeffs, lay=lay),
                f"{kind} merit_bwd")
    names = ("trace_fwd", "trace_bwd", "trace_field_fwd", "trace_field_bwd")
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES,
                                 **{n + "_aux": 1 for n in names})
    assert ft.LAUNCHES == _only(ft.LAUNCHES, merit_fwd_aux=1,
                                merit_bwd_aux=1)


@pytest.mark.cuda
def test_aux_poly_and_pol_kernels_match_plain(cuda_device):
    """The aux build's poly mode on the Q2d singlet and K8/K9 (both modes)
    on each family's Fresnel-coated singlet."""
    system = _aux_system("forbes_q2d")
    R = 20001
    wl, _, _, _, _, _, ins, cots = _k6_inputs(system, freeform.H, R, 8)
    coeffs, lay = _aux_tables(system)
    nc = coeffs.shape[1]
    spec = ftr.poly_spec(system)
    params = ftr.build_poly_table(system).contiguous()
    mats = system.stack.mat_coeffs.contiguous()
    w = torch.tensor([0.48, 0.55, 0.65], dtype=torch.float64,
                     device=cuda_device)[torch.arange(R, device=cuda_device)
                                         % 3]
    ins9 = ins + [w]
    ftr.reset_launch_counts()
    _close(ftr.trace_fwd_poly(params, mats, spec, ins9, coeffs, lay),
           ftr.trace_fwd_poly_plain(params, mats, spec, ins9, coeffs, lay),
           1e-10, "q2d trace_fwd_poly")
    din, flat = ftr.trace_bwd_poly(params, mats, spec, nc, ins9, cots,
                                   coeffs, lay)
    din_p, flat_p = ftr.trace_bwd_poly_plain(params, mats, spec, nc, ins9,
                                             cots, coeffs, lay)
    _close(din, din_p, 1e-10, "q2d trace_bwd_poly input cotangent",
           positions=False)
    _flat_close(flat, flat_p, "q2d trace_bwd_poly")
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_poly_aux=1,
                                 trace_bwd_poly_aux=1)
    from optiland_torch.ops import pol_trace as pt

    for fam in freeform.AUX_FAMILIES:
        csys = freeform.coated_freeform(fam, "H").system
        wl, params, _, _, _, _, ins, _ = _k6_inputs(csys, freeform.H, R, 9)
        coeffs, lay = _aux_tables(csys)
        nc = coeffs.shape[1]
        pspec = pt.pol_spec(csys, wl)
        coat = pt.build_coat_table(csys, wl, torch.float64, cuda_device)
        g = torch.Generator(device="cpu").manual_seed(9)
        cots = [torch.randn(R, generator=g, dtype=torch.float64).to(
            cuda_device) for _ in range(pt.N_POL)]
        pt.reset_launch_counts()
        for states, intensity in ((None, False),
                                  (pt.pol_states(create_polarization("H")),
                                   True)):
            c = cots[:8] if intensity else cots
            _pol_out_close(pt.pol_fwd(params, coat, pspec, ins, states,
                                      intensity, coeffs, lay),
                           pt.pol_fwd_plain(params, coat, pspec, ins, states,
                                            intensity, coeffs, lay),
                           f"coated {fam}")
            din, flat = pt.pol_bwd(params, coat, pspec, nc, ins, c, states,
                                   intensity, coeffs, lay)
            din_p, flat_p = pt.pol_bwd_plain(params, coat, pspec, ins, c,
                                             states, intensity, coeffs, nc,
                                             with_coeffs=True, lay=lay)
            _close(din, din_p, 1e-10, f"coated {fam} pol_bwd input cotangent",
                   positions=False)
            _flat_close(flat, flat_p, f"coated {fam} pol_bwd")
        assert pt.LAUNCHES == _only(pt.LAUNCHES, pol_fwd_aux=1, pol_bwd_aux=1,
                                    pol_fwd_intensity_aux=1,
                                    pol_bwd_intensity_aux=1)


@pytest.mark.cuda
def test_aux_entry_points_launch_the_aux_build(cuda_device):
    """spot_rms_fast_field, trace_fast_field and Optic.trace of the Qbfs
    singlet run the aux build and match the plain versions on the CPU; a
    wrapper given no layout table for an aux-bearing spec raises."""
    lens = freeform.freeform_singlet("forbes_qbfs")
    system = lens.system
    ftr.reset_launch_counts()
    ft.reset_launch_counts()
    Px, Py = ft.prng_disk(5, 4001, 0, torch.float64, cuda_device)
    loss = ft.spot_rms_fast_field(system, *freeform.H, WL, Px=Px, Py=Py)
    f = ftr.trace_fast_field(system, *freeform.H, Px, Py, WL)
    res = lens.trace(Hx=0.3, Hy=0.7, num_rays=8, record=False)
    assert torch.isfinite(loss) and torch.isfinite(f.x).all()
    assert torch.isfinite(res.x).all()
    assert ft.LAUNCHES == _only(ft.LAUNCHES, prng_disk=1, merit_fwd_aux=1)
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_field_fwd_aux=1,
                                 trace_fwd_aux=1)
    coeffs, _ = _aux_tables(system)
    spec = ftr.fast_spec(system, field=True)
    params = ft.build_param_table(system, WL)
    aim = ft.aim_vector(system, *freeform.H)
    with pytest.raises(ValueError, match="layout table"):
        ftr.trace_field_fwd(params, aim, spec, Px, Py, coeffs)
    config.set_device("cpu")
    ref = freeform.freeform_singlet("forbes_qbfs").system
    loss_p = ft.spot_rms_fast_field(ref, *freeform.H, WL, Px=Px.cpu(),
                                    Py=Py.cpu())
    assert float(loss) == pytest.approx(float(loss_p), rel=1e-12)


@pytest.mark.cuda
def test_deep_build_takes_the_aux_families(cuda_device):
    """Past 16 surfaces a system with an aux-bearing surface runs the
    deep_aux build, against the plain versions."""
    system = freeform.deep_aux().system
    assert system.cfg.num_surfaces == 20
    R = 8001
    wl, params, aim, _, Px, Py, ins, cots = _k6_inputs(system, H, R, 11)
    coeffs, lay = _aux_tables(system)
    nc = coeffs.shape[1]
    spec = ftr.fast_spec(system, field=True)
    ftr.reset_launch_counts()
    _close(ftr.trace_fwd(params, spec, ins, coeffs, lay),
           ftr.trace_fast_plain(params, spec, ins, coeffs, lay), 1e-10,
           "deep aux trace_fwd")
    din, flat = ftr.trace_bwd(params, spec, nc, ins, cots, coeffs, lay)
    din_p, flat_p = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots,
                                             coeffs, lay)
    _close(din, din_p, 1e-10, "deep aux trace_bwd input cotangent",
           positions=False)
    _flat_close(flat, flat_p, "deep aux trace_bwd")
    mspec = ft._spec_of(system)
    rows = ft.merit_fwd(params, aim, mspec, R, Px=Px, Py=Py, coeffs=coeffs,
                        lay=lay)
    loss, xbar, ybar = ft._chan_combine(rows, R)
    stats = torch.stack([xbar, ybar, 1.0 / R + 0 * xbar, 0 * xbar])
    _flat_close(ft.merit_bwd(params, aim, stats, mspec, nc, R, Px=Px, Py=Py,
                             coeffs=coeffs, lay=lay),
                ft.merit_bwd_plain(params, aim, stats, mspec, nc, R, Px=Px,
                                   Py=Py, coeffs=coeffs, lay=lay),
                "deep aux merit_bwd")
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_deep_aux=1,
                                 trace_bwd_deep_aux=1)


# ---------------------------------------------------------------------------
# K6c: gratings in the monochromatic kernels (the grat build)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kind", grating.NAMES)
def test_grat_kernels_match_plain_f64(cuda_device, kind):
    system = grating.BUILDERS[kind]().system
    R = 20001
    wl, params, aim, coeffs, Px, Py, ins, cots = _k6_inputs(
        system, freeform.H, R, 7)
    nc = coeffs.shape[1]
    spec = ftr.fast_spec(system, field=True)
    S = len(spec[0])
    g = spec[4].index(True)  # the grating surface
    ftr.reset_launch_counts()
    ft.reset_launch_counts()
    _close(ftr.trace_fwd(params, spec, ins, coeffs),
           ftr.trace_fast_plain(params, spec, ins, coeffs), 1e-10,
           f"{kind} trace_fwd")
    din, flat = ftr.trace_bwd(params, spec, nc, ins, cots, coeffs)
    din_p, flat_p = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots,
                                             coeffs)
    _close(din, din_p, 1e-10, f"{kind} trace_bwd input cotangent",
           positions=False)
    _flat_close(flat, flat_p, f"{kind} trace_bwd")
    # the grating's P_G1 (period) and P_G2 (groove angle) columns
    assert float(flat_p[:S * 15].reshape(S, 15)[g, 11:13].abs().min()) > 0
    out = ftr.trace_field_fwd(params, aim, spec, Px, Py, coeffs)
    _close(out, ftr.trace_fast_field_plain(params, aim, spec, Px, Py, coeffs),
           1e-10, f"{kind} trace_field_fwd")
    _flat_close(ftr.trace_field_bwd(params, aim, spec, nc, Px, Py, cots,
                                    coeffs),
                ftr.trace_fast_field_bwd_plain(params, aim, spec, nc, Px, Py,
                                               cots, coeffs),
                f"{kind} trace_field_bwd")
    mspec = ft._spec_of(system)
    rows = ft.merit_fwd(params, aim, mspec, R, Px=Px, Py=Py, coeffs=coeffs)
    rows_p = ft.merit_fwd_plain(params, aim, mspec, R, Px=Px, Py=Py,
                                coeffs=coeffs)
    loss, xbar, ybar = ft._chan_combine(rows, R)
    assert float(loss) == pytest.approx(
        float(ft._chan_combine(rows_p, R)[0]), rel=1e-12)
    stats = torch.stack([xbar, ybar, 1.0 / R + 0 * xbar, 0 * xbar])
    mflat_p = ft.merit_bwd_plain(params, aim, stats, mspec, nc, R, Px=Px,
                                 Py=Py, coeffs=coeffs)
    _flat_close(ft.merit_bwd(params, aim, stats, mspec, nc, R, Px=Px, Py=Py,
                             coeffs=coeffs), mflat_p, f"{kind} merit_bwd")
    assert float(mflat_p[:S * 15].reshape(S, 15)[g, 11:13].abs().min()) > 0
    names = ("trace_fwd", "trace_bwd", "trace_field_fwd", "trace_field_bwd")
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES,
                                 **{n + "_grat": 1 for n in names})
    assert ft.LAUNCHES == _only(ft.LAUNCHES, merit_fwd_grat=1,
                                merit_bwd_grat=1)


@pytest.mark.cuda
def test_grat_entry_points_launch_the_grat_build(cuda_device):
    """spot_rms_fast_field, trace_fast_field and Optic.trace of the curved
    grating run the grat build and nothing else, and match the plain
    versions on the CPU; the grating's period and groove angle get a
    finite, nonzero gradient."""
    lens = grating.curved_grating()
    system = lens.system
    ftr.reset_launch_counts()
    ft.reset_launch_counts()
    Px, Py = ft.prng_disk(5, 4001, 0, torch.float64, cuda_device)
    st = system.stack
    p1 = st.geo_p1.clone().requires_grad_()
    p2 = st.geo_p2.clone().requires_grad_()
    s2 = system.replace(stack=st.replace(geo_p1=p1, geo_p2=p2))
    loss = ft.spot_rms_fast_field(s2, *freeform.H, WL, Px=Px, Py=Py)
    loss.backward()
    f = ftr.trace_fast_field(system, *freeform.H, Px, Py, WL)
    res = lens.trace(Hx=0.3, Hy=0.7, num_rays=8, record=False)
    assert torch.isfinite(loss) and torch.isfinite(f.x).all()
    assert torch.isfinite(res.x).all()
    for v in (p1.grad[1], p2.grad[1]):
        assert bool(torch.isfinite(v)) and float(v) != 0
    assert ft.LAUNCHES == _only(ft.LAUNCHES, prng_disk=1, merit_fwd_grat=1,
                                merit_bwd_grat=1)
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_field_fwd_grat=1,
                                 trace_fwd_grat=1)
    config.set_device("cpu")
    ref = grating.curved_grating().system
    loss_p = ft.spot_rms_fast_field(ref, *freeform.H, WL, Px=Px.cpu(),
                                    Py=Py.cpu())
    assert float(loss) == pytest.approx(float(loss_p), rel=1e-12)


def _grating_beside_asphere():
    """plane_grating with its first lens surface an even asphere."""
    lens = grating.plane_grating()
    s1 = lens.surfaces.surfaces[1]
    s1.surface_type, s1.coefficients = "even_asphere", (1e-5, -2e-8)
    lens._invalidate()
    return lens


@pytest.mark.cuda
def test_grat_refusals_and_plain_paths_on_the_card(cuda_device):
    """On a CUDA bundle a grating beside an asphere raises naming the
    combination, from every entry point, and launches nothing; the poly
    and polarized grating traces, which the JAX package's kernels do not
    take either, run the plain engine on the card and match it on the
    CPU."""
    lens = _grating_beside_asphere()
    system = lens.system
    Px, Py = ft.prng_disk_plain(5, 501, 0, torch.float64, cuda_device)
    rays = raygen.generate_rays(system, *freeform.H, Px, Py, WL)
    ftr.reset_launch_counts()
    ft.reset_launch_counts()
    for call in (lambda: ftr.trace_fast(system, rays, WL),
                 lambda: trace_core.trace(system, rays, record=False,
                                          wavelength=WL),
                 lambda: ftr.trace_fast_field(system, *freeform.H, Px, Py,
                                              WL),
                 lambda: ft.spot_rms_fast_field(system, *freeform.H, WL,
                                                Px=Px, Py=Py)):
        with pytest.raises(NotImplementedError,
                           match="grating beside EVEN_ASPHERE"):
            call()
    assert not any(ftr.LAUNCHES.values()) and not any(ft.LAUNCHES.values())
    # a wavelength per ray, and a polarized coated grating
    lens = grating.plane_grating()
    w = torch.tensor([0.48, 0.55, 0.65], dtype=torch.float64,
                     device=cuda_device)[torch.arange(501) % 3]
    poly_rays = raygen.generate_rays(lens.system, *freeform.H, Px, Py,
                                     WL).replace(w=w)
    out_poly, _ = trace_core.trace(lens.system, poly_rays, record=False)
    coated = grating.coated_grating("H")
    out_pol = coated.trace(Hx=0.3, Hy=0.7, num_rays=6, record=False)
    assert not any(ftr.LAUNCHES.values())
    config.set_device("cpu")
    ref_poly, _ = trace_core.trace(
        grating.plane_grating().system,
        poly_rays.replace(**{k: getattr(poly_rays, k).cpu() for k in
                             ("x", "y", "z", "L", "M", "N", "i", "w",
                              "opd")}), record=False)
    ref_pol = grating.coated_grating("H").trace(Hx=0.3, Hy=0.7, num_rays=6,
                                                record=False)
    for got, ref in ((out_poly, ref_poly), (out_pol.rays, ref_pol.rays)):
        for k in ftr.RAY_FIELDS:
            a, b = getattr(got, k).cpu(), getattr(ref, k)
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, b, rtol=1e-12,
                                       atol=1e-12 * float(b.abs().max()),
                                       msg=f"plain engine on the card: {k}")


# ---------------------------------------------------------------------------
# K6d: NURBS surfaces in every trace kernel (the nurbs build)
# ---------------------------------------------------------------------------

NURBS_SYSTEMS = {"rational": nurbs.rational_nurbs,
                 "fitted": nurbs.fitted_nurbs,
                 "bspline": nurbs.bspline_nurbs,
                 "bspline4": lambda: nurbs.bspline_nurbs(nn=4),
                 "tilted": nurbs.tilted_nurbs}


def _nurbs_check(system, R, seed, what, dtype=torch.float64, rtol=1e-10,
                 field=freeform.H, pupil=None, iters=10, xy=None):
    """Every monochromatic kernel of the nurbs build on ``system`` against
    its plain version (f64, or ``dtype`` against the f64 plain version
    with ``rtol`` then ``_f32_close``), at ``field`` from R pupil samples
    drawn from ``seed`` or (``pupil``) given, with ``iters`` stopped Newton
    steps, the generic kernels' rays starting at ``xy`` where it is given;
    returns the plain trace_bwd's flat gradient."""
    wl, params, aim, _, Px, Py, ins, cots = _k6_inputs(system, field, R,
                                                       seed, pupil=pupil)
    if xy is not None:
        ins[0], ins[1] = (t.to(ins[0]).contiguous() for t in xy)
    coeffs, lay = _aux_tables(system)
    nc = coeffs.shape[1]
    spec = ftr.fast_spec(system, field=True, newton_iters=iters)
    cast = (lambda t: t.to(dtype).contiguous())
    c32, l32 = _aux_tables(system, dtype)
    args = [cast(t) for t in (params, aim, Px, Py)]
    ins_d, cots_d = [cast(t) for t in ins], [cast(t) for t in cots]

    def close(got, ref, name, **kw):
        if dtype == torch.float64:
            _close(got, ref, rtol, f"{what} {name}", **kw)
        else:
            _f32_close(got, ref, f"{what} {name}")

    def flat_close(got, ref, name):
        if dtype == torch.float64:
            _flat_close(got, ref, f"{what} {name}")
        else:
            _f32_grad_close(got, ref, f"{what} {name}")

    close(ftr.trace_fwd(args[0], spec, ins_d, c32, l32),
          ftr.trace_fast_plain(params, spec, ins, coeffs, lay), "trace_fwd")
    din, flat = ftr.trace_bwd(args[0], spec, nc, ins_d, cots_d, c32, l32)
    din_p, flat_p = ftr.trace_fast_bwd_plain(params, spec, nc, ins, cots,
                                             coeffs, lay)
    close(din, din_p, "trace_bwd input cotangent", positions=False)
    flat_close(flat, flat_p, "trace_bwd")
    close(ftr.trace_field_fwd(args[0], args[1], spec, args[2], args[3], c32,
                              l32),
          ftr.trace_fast_field_plain(params, aim, spec, Px, Py, coeffs, lay),
          "trace_field_fwd")
    flat_close(ftr.trace_field_bwd(args[0], args[1], spec, nc, args[2],
                                   args[3], cots_d, c32, l32),
               ftr.trace_fast_field_bwd_plain(params, aim, spec, nc, Px, Py,
                                              cots, coeffs, lay),
               "trace_field_bwd")
    mspec = ft._spec_of(system, iters)
    rows = ft.merit_fwd(args[0], args[1], mspec, R, Px=args[2], Py=args[3],
                        coeffs=c32, lay=l32)
    rows_p = ft.merit_fwd_plain(params, aim, mspec, R, Px=Px, Py=Py,
                                coeffs=coeffs, lay=lay)
    loss, xbar, ybar = ft._chan_combine(rows, R)
    assert float(loss) == pytest.approx(
        float(ft._chan_combine(rows_p, R)[0]),
        rel=1e-12 if dtype == torch.float64 else 1e-3)
    stats = torch.stack([xbar, ybar, 1.0 / R + 0 * xbar, 0 * xbar])
    flat_close(ft.merit_bwd(args[0], args[1], stats, mspec, nc, R,
                            Px=args[2], Py=args[3], coeffs=c32, lay=l32),
               ft.merit_bwd_plain(params, aim, stats.to(torch.float64),
                                  mspec, nc, R, Px=Px, Py=Py, coeffs=coeffs,
                                  lay=lay), "merit_bwd")
    return flat_p


def _f32_close(got, ref, what):
    """f32 against the f64 plain version: 2e-4 x max(1, the array's largest
    entry), at most 1 in 1e4 entries off (a clip edge)."""
    for k, (a, b) in enumerate(zip(got, ref)):
        tol = 2e-4 * max(1.0, float(b.abs().max()))
        bad = ((a.double() - b).abs() > tol) & torch.isfinite(b)
        assert int(bad.sum()) <= max(1, b.numel() // 10000), (
            f"{what} array {k}: {int(bad.sum())} entries off by more than "
            f"{tol:.2e}")


def _f32_grad_close(got, ref, what):
    """f32 summed gradients to 1e-3 of the f64 plain version's L2 norm."""
    d = float((got.double() - ref).norm())
    assert d <= 1e-3 * float(ref.norm()), f"{what}: |d| {d:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(NURBS_SYSTEMS))
def test_nurbs_kernels_match_plain_f64(cuda_device, kind):
    """K1-K5 mono and K2/K3 in the nurbs build on each NURBS lens, per ray
    and per gradient column (the net's 4 nu nv columns among them)."""
    system = NURBS_SYSTEMS[kind]().system
    ftr.reset_launch_counts()
    ft.reset_launch_counts()
    flat_p = _nurbs_check(system, 20001, 7, kind)
    S, nc = system.cfg.num_surfaces, system.stack.coeffs.shape[1]
    net = flat_p[S * 15:S * 15 + S * nc].reshape(S, nc)[1]
    n = system.cfg.geom_aux[1][1] * system.cfg.geom_aux[1][2]
    assert float(net[:4 * n].abs().max()) > 0 and torch.isfinite(net).all()
    names = ("trace_fwd", "trace_bwd", "trace_field_fwd", "trace_field_bwd")
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES,
                                 **{n + "_nurbs": 1 for n in names})
    assert ft.LAUNCHES == _only(ft.LAUNCHES, merit_fwd_nurbs=1,
                                merit_bwd_nurbs=1)


@pytest.mark.cuda
def test_nurbs_kernels_f32_match_f64(cuda_device):
    """The f32 nurbs build against the f64 plain versions: per-ray arrays
    to 2e-4 of their scale, gradients to 1e-3 in the L2 norm."""
    _nurbs_check(nurbs.rational_nurbs().system, 20001, 8, "f32 rational",
                 dtype=torch.float32)


@pytest.mark.cuda
def test_nurbs_poly_and_pol_kernels_match_plain(cuda_device):
    """The nurbs build's poly mode on the rational lens and K8/K9 (both
    modes) on its Fresnel-coated variant."""
    system = nurbs.rational_nurbs().system
    R = 20001
    wl, _, _, _, _, _, ins, cots = _k6_inputs(system, freeform.H, R, 8)
    coeffs, lay = _aux_tables(system)
    nc = coeffs.shape[1]
    spec = ftr.poly_spec(system)
    params = ftr.build_poly_table(system).contiguous()
    mats = system.stack.mat_coeffs.contiguous()
    w = torch.tensor([0.48, 0.55, 0.65], dtype=torch.float64,
                     device=cuda_device)[torch.arange(R, device=cuda_device)
                                         % 3]
    ins9 = ins + [w]
    ftr.reset_launch_counts()
    _close(ftr.trace_fwd_poly(params, mats, spec, ins9, coeffs, lay),
           ftr.trace_fwd_poly_plain(params, mats, spec, ins9, coeffs, lay),
           1e-10, "nurbs trace_fwd_poly")
    din, flat = ftr.trace_bwd_poly(params, mats, spec, nc, ins9, cots,
                                   coeffs, lay)
    din_p, flat_p = ftr.trace_bwd_poly_plain(params, mats, spec, nc, ins9,
                                             cots, coeffs, lay)
    _close(din, din_p, 1e-10, "nurbs trace_bwd_poly input cotangent",
           positions=False)
    _flat_close(flat, flat_p, "nurbs trace_bwd_poly")
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_fwd_poly_nurbs=1,
                                 trace_bwd_poly_nurbs=1)
    from optiland_torch.ops import pol_trace as pt

    csys = nurbs.coated_nurbs("H").system
    wl, params, _, _, _, _, ins, _ = _k6_inputs(csys, freeform.H, R, 9)
    coeffs, lay = _aux_tables(csys)
    pspec = pt.pol_spec(csys, wl)
    coat = pt.build_coat_table(csys, wl, torch.float64, cuda_device)
    g = torch.Generator(device="cpu").manual_seed(9)
    cots = [torch.randn(R, generator=g, dtype=torch.float64).to(
        cuda_device) for _ in range(pt.N_POL)]
    pt.reset_launch_counts()
    for states, intensity in ((None, False),
                              (pt.pol_states(create_polarization("H")),
                               True)):
        c = cots[:8] if intensity else cots
        _pol_out_close(pt.pol_fwd(params, coat, pspec, ins, states,
                                  intensity, coeffs, lay),
                       pt.pol_fwd_plain(params, coat, pspec, ins, states,
                                        intensity, coeffs, lay),
                       "coated nurbs")
        din, flat = pt.pol_bwd(params, coat, pspec, nc, ins, c, states,
                               intensity, coeffs, lay)
        din_p, flat_p = pt.pol_bwd_plain(params, coat, pspec, ins, c,
                                         states, intensity, coeffs, nc,
                                         with_coeffs=True, lay=lay)
        _close(din, din_p, 1e-10, "coated nurbs pol_bwd input cotangent",
               positions=False)
        _flat_close(flat, flat_p, "coated nurbs pol_bwd")
    assert pt.LAUNCHES == _only(pt.LAUNCHES, pol_fwd_nurbs=1,
                                pol_bwd_nurbs=1, pol_fwd_intensity_nurbs=1,
                                pol_bwd_intensity_nurbs=1)


@pytest.mark.cuda
def test_nurbs_entry_points_and_refusals(cuda_device):
    """spot_rms_fast_field (value and the net's gradient), trace_fast_field
    and Optic.trace of the fitted lens run the nurbs build and match the
    plain versions on the CPU; a NURBS surface beside an asphere raises
    naming the combination, from every entry point, and launches
    nothing."""
    lens = nurbs.fitted_nurbs()
    system = lens.system
    ftr.reset_launch_counts()
    ft.reset_launch_counts()
    Px, Py = ft.prng_disk(5, 4001, 0, torch.float64, cuda_device)
    cf = system.stack.coeffs.clone().requires_grad_()
    s2 = system.replace(stack=system.stack.replace(coeffs=cf))
    loss = ft.spot_rms_fast_field(s2, *freeform.H, WL, Px=Px, Py=Py)
    loss.backward()
    f = ftr.trace_fast_field(system, *freeform.H, Px, Py, WL)
    res = lens.trace(Hx=0.3, Hy=0.7, num_rays=8, record=False)
    assert torch.isfinite(loss) and torch.isfinite(f.x).all()
    assert torch.isfinite(res.x).all() and torch.isfinite(cf.grad).all()
    assert float(cf.grad[1].abs().max()) > 0
    assert ft.LAUNCHES == _only(ft.LAUNCHES, prng_disk=1,
                                merit_fwd_nurbs=1, merit_bwd_nurbs=1)
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_field_fwd_nurbs=1,
                                 trace_fwd_nurbs=1)
    bad = nurbs.fitted_nurbs()
    s3 = bad.surfaces.surfaces[2]
    s3.surface_type, s3.coefficients = "even_asphere", (1e-5, -2e-8)
    bad._invalidate()
    bsys = bad.system
    rays = raygen.generate_rays(bsys, *freeform.H, Px, Py, WL)
    ftr.reset_launch_counts()
    ft.reset_launch_counts()
    for call in (lambda: ftr.trace_fast(bsys, rays, WL),
                 lambda: trace_core.trace(bsys, rays, record=False,
                                          wavelength=WL),
                 lambda: ftr.trace_fast_field(bsys, *freeform.H, Px, Py, WL),
                 lambda: ft.spot_rms_fast_field(bsys, *freeform.H, WL,
                                                Px=Px, Py=Py)):
        with pytest.raises(NotImplementedError,
                           match="NURBS surface beside EVEN_ASPHERE"):
            call()
    assert not any(ftr.LAUNCHES.values()) and not any(ft.LAUNCHES.values())
    config.set_device("cpu")
    ref = nurbs.fitted_nurbs().system
    cf_p = ref.stack.coeffs.clone().requires_grad_()
    loss_p = ft.spot_rms_fast_field(
        ref.replace(stack=ref.stack.replace(coeffs=cf_p)), *freeform.H, WL,
        Px=Px.cpu(), Py=Py.cpu())
    loss_p.backward()
    assert float(loss) == pytest.approx(float(loss_p), rel=1e-12)
    torch.testing.assert_close(cf.grad.cpu(), cf_p.grad, rtol=1e-9,
                               atol=1e-12 * float(cf_p.grad.abs().max()))


@pytest.mark.cuda
def test_nurbs_kernels_at_the_net_edges(cuda_device):
    """On axis, pupil samples that meet the rational net at its corners
    (x, y = +-7 mm: the stopped and corrected u and v exactly 0 or 1, the
    last knot's span, the clip's derivative 1/2) and others inside and
    past its edges (u or v clipped, the clip's derivative 0): each
    monochromatic kernel of the nurbs build against its plain version in
    f64, per gradient column. No sample lands within rounding of an edge
    without landing on it, where the clip's derivative would follow the
    rounding (1, 1/2 or 0) and two correct versions could differ."""
    system = nurbs.rational_nurbs().system
    v = torch.tensor((-1.5, -1.0, -0.3, 0.0, 0.3, 1.0, 1.5),
                     dtype=torch.float64)
    c = torch.tensor((-1.4, 1.4), dtype=torch.float64)
    grid = [t.reshape(-1) for t in torch.meshgrid(v, v, indexing="ij")]
    corners = [t.reshape(-1) for t in torch.meshgrid(c, c, indexing="ij")]
    Px, Py = (torch.cat([a, b]).repeat(60) for a, b in zip(grid, corners))
    with torch.no_grad():
        rays = raygen.generate_rays(system, 0.0, 0.0, Px, Py, WL)
        params = ft.build_param_table(system, WL)
        coeffs, _ = _aux_tables(system)
        fw = step.nurbs_forward(coeffs[1].cpu(), system.cfg.geom_aux[1],
                                rays.x.cpu(), rays.y.cpu(),
                                (rays.z - params[1, 2]).cpu(), rays.L.cpu(),
                                rays.M.cpu(), rays.N.cpu(), 10)
    # the corrected points on the edges, and none within rounding of one
    dist = torch.stack([fw.U, fw.V, fw.U - 1, fw.V - 1]).abs()
    assert bool(((fw.us == 0) | (fw.us == 1)).any())
    assert int((dist == 0).any(0).sum()) == 4 * 60
    assert not bool(((dist > 0) & (dist < 1e-9)).any())
    _nurbs_check(system, Px.shape[0], 11, "edges", field=(0.0, 0.0),
                 pupil=(Px, Py))


@pytest.mark.cuda
def test_nurbs_kernels_on_a_nonuniform_net(cuda_device):
    """The non-uniform net (degree 2 x 3, an interior u knot repeated,
    rational): each monochromatic kernel of the nurbs build against its
    plain version in f64, per ray and per gradient column, on rays in and
    past the net; then with no Newton step, so that the stopped point is
    the guess: on rays that start on the dyadic grid of the interior knots
    the stopped u and v are exactly those knots (the span search at a knot
    and at the repeated knot, the empty intervals' zero reciprocals), on
    rays past the net exactly 0 or 1 (the last knot's span), checked on
    the plain side. As in the edge test, no corrected point lands within
    rounding of the box's edge, where the clip's derivative would follow
    the rounding."""
    system = nurbs.nonuniform_nurbs().system
    _nurbs_check(system, 20001, 12, "nonuniform")
    _nurbs_check(system, 20001, 12, "nonuniform f32", dtype=torch.float32)
    _, _, _, _, uk, vk = system.cfg.geom_aux[1][1:]
    ku = torch.tensor([k for k in sorted(set(uk)) if 0 < k < 1],
                      dtype=torch.float64)
    kv = torch.tensor([k for k in sorted(set(vk)) if 0 < k < 1],
                      dtype=torch.float64)
    gx, gy = (t.reshape(-1) for t in torch.meshgrid(14 * ku - 7, 14 * kv - 7,
                                                    indexing="ij"))
    # then past the net (stopped at 0 or 1), and one knot with a point past
    # the net in the other direction
    n_grid = gx.shape[0]
    gx = torch.cat([gx, torch.tensor([-9.0, 9.0, -9.0, 9.0, -3.5, 1.75])])
    gy = torch.cat([gy, torch.tensor([-9.0, 9.0, 9.0, -9.0, 9.0, -9.0])])
    xy = (gx.repeat(40), gy.repeat(40))
    R = xy[0].shape[0]
    _, params, _, _, _, _, ins, _ = _k6_inputs(system, (0.0, 0.0), R, 13)
    with torch.no_grad():
        fw = step.nurbs_forward(system.stack.coeffs[1].cpu(),
                                system.cfg.geom_aux[1], xy[0], xy[1],
                                (ins[2] - params[1, 2]).cpu(), ins[3].cpu(),
                                ins[4].cpu(), ins[5].cpu(), 0)
    on_u = (fw.us[:, None] == ku).any(1)
    on_v = (fw.vs[:, None] == kv).any(1)
    grid = (torch.arange(R) % gx.shape[0]) < n_grid
    assert bool((on_u & on_v)[grid].all())
    edge = (fw.us == 0) | (fw.us == 1) | (fw.vs == 0) | (fw.vs == 1)
    assert bool(edge[~grid].all())
    assert bool((fw.us == 0.25).any()) and bool((fw.vs == 1.0).any())
    dist = torch.stack([fw.U, fw.V, fw.U - 1, fw.V - 1]).abs()
    assert not bool(((dist > 0) & (dist < 1e-9)).any())
    _nurbs_check(system, R, 13, "nonuniform at the knots", field=(0.0, 0.0),
                 iters=0, xy=xy)


@pytest.mark.cuda
def test_nurbs_kernels_at_the_build_bounds(cuda_device):
    """A net at each of the nurbs build's bounds (degree NU_PMAX = 7 on
    NU_KMAX = 24 knots, 256 = NC_NURBS columns): each monochromatic
    kernel against its plain version in f64, per ray and per gradient
    column, and in f32 against the f64 plain versions."""
    system = nurbs.bound_nurbs().system
    _, nu, nv, p, q, uk, vk = system.cfg.geom_aux[1]
    assert (p, len(uk), 4 * nu * nv) == (launch.NU_PMAX, launch.NU_KMAX,
                                         launch.NC_NURBS)
    _nurbs_check(system, 20001, 14, "bound", field=(0.0, 0.0))
    _nurbs_check(system, 20001, 14, "bound f32", dtype=torch.float32,
                 field=(0.0, 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nurbs_backwards_repeat_their_bits(cuda_device, dtype):
    """Two launches of each backward of the nurbs build (merit, field,
    generic and poly; K9 in both modes on the coated variant) on the
    fitted and coated rational lenses give the same bits: a launch shape
    fixed for the card and shape, fixed summation orders, no float
    atomics."""
    from optiland_torch.ops import pol_trace as pt

    R = 200001
    system = nurbs.fitted_nurbs().system
    wl, params, aim, _, Px, Py, ins, cots = _k6_inputs(system, freeform.H, R,
                                                       13, dtype)
    coeffs, lay = _aux_tables(system, dtype)
    nc = coeffs.shape[1]
    spec = ftr.fast_spec(system, field=True)
    mspec = ft._spec_of(system)
    stats = torch.tensor([0.1, -0.2, 1.0 / R, 0.0], dtype=dtype,
                         device=cuda_device)
    w = torch.tensor([0.48, 0.55, 0.65], dtype=dtype,
                     device=cuda_device)[torch.arange(R, device=cuda_device)
                                         % 3]
    pq = ftr.build_poly_table(system).to(dtype).contiguous()
    mq = system.stack.mat_coeffs.to(dtype).contiguous()
    csys = nurbs.coated_nurbs("H").system
    _, pc, _, _, _, _, ins_c, _ = _k6_inputs(csys, freeform.H, R, 14, dtype)
    cc, lc = _aux_tables(csys, dtype)
    pspec = pt.pol_spec(csys, wl)
    coat = pt.build_coat_table(csys, wl, dtype, cuda_device)
    states = pt.pol_states(create_polarization("H"))
    g = torch.Generator(device="cpu").manual_seed(15)
    pcots = [torch.randn(R, generator=g, dtype=dtype).to(cuda_device)
             for _ in range(pt.N_POL)]
    calls = {
        "merit_bwd": lambda: [ft.merit_bwd(params, aim, stats, mspec, nc, R,
                                           Px=Px, Py=Py, coeffs=coeffs,
                                           lay=lay)],
        "trace_field_bwd": lambda: [ftr.trace_field_bwd(
            params, aim, spec, nc, Px, Py, cots, coeffs, lay)],
        "trace_bwd": lambda: ftr.trace_bwd(params, spec, nc, ins, cots,
                                           coeffs, lay),
        "trace_bwd_poly": lambda: ftr.trace_bwd_poly(
            pq, mq, ftr.poly_spec(system), nc, ins + [w], cots, coeffs,
            lay),
        "pol_bwd": lambda: pt.pol_bwd(pc, coat, pspec, cc.shape[1], ins_c,
                                      pcots, None, False, cc, lc),
        "pol_bwd_intensity": lambda: pt.pol_bwd(
            pc, coat, pspec, cc.shape[1], ins_c, pcots[:8], states, True,
            cc, lc),
    }

    def flat(out):
        return torch.cat([torch.stack(list(o)).reshape(-1)
                          if isinstance(o, (tuple, list)) else o.reshape(-1)
                          for o in out])

    ftr.reset_launch_counts()
    ft.reset_launch_counts()
    pt.reset_launch_counts()
    for name, call in calls.items():
        a, b = flat(call()), flat(call())
        assert torch.isfinite(a).all(), name
        assert torch.equal(a, b), (
            f"{name}: two launches differ in {int((a != b).sum())} entries")
    assert ft.LAUNCHES == _only(ft.LAUNCHES, merit_bwd_nurbs=2)
    assert ftr.LAUNCHES == _only(ftr.LAUNCHES, trace_field_bwd_nurbs=2,
                                 trace_bwd_nurbs=2, trace_bwd_poly_nurbs=2)
    assert pt.LAUNCHES == _only(pt.LAUNCHES, pol_bwd_nurbs=2,
                                pol_bwd_intensity_nurbs=2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_newton_backwards_repeat_their_bits(cuda_device, dtype):
    """Two launches of each backward of the Newton builds (merit, field,
    generic and, in the sag, free and aux builds, poly), which keep each
    Newton surface's stopped iterate from their forward sweep, give the
    same bits on the tilted asphere (sag), ObjectiveUS008879901 (deep),
    the XY singlet (free) and the Q2d singlet (aux): a launch shape fixed
    for the card and shape, fixed summation orders, no float atomics."""
    R = 100001
    cases = (("_sag", perturbed.tilted_asphere().system, (0.0, 0.0), True),
             ("_deep", registry.build_sample(
                 "ObjectiveUS008879901").system, (0.0, 0.7), False),
             ("_free", freeform.freeform_singlet("polynomial").system,
              freeform.H, True),
             ("_aux", freeform.freeform_singlet("forbes_q2d").system,
              freeform.H, True))
    w = torch.tensor([0.48, 0.55, 0.65], dtype=dtype,
                     device=cuda_device)[torch.arange(R, device=cuda_device)
                                         % 3]

    def flat(out):
        return torch.cat([torch.stack(list(o)).reshape(-1)
                          if isinstance(o, (tuple, list)) else o.reshape(-1)
                          for o in out])

    for k, (suf, system, field, poly) in enumerate(cases):
        _, params, aim, _, Px, Py, ins, cots = _k6_inputs(
            system, field, R, 21 + k, dtype)
        coeffs, lay = _aux_tables(system, dtype)
        nc = coeffs.shape[1]
        spec = ftr.fast_spec(system, field=True)
        mspec = ft._spec_of(system)
        assert launch.launch_key("", ftr._build(spec)) == suf
        stats = torch.tensor([0.1, -0.2, 1.0 / R, 0.0], dtype=dtype,
                             device=cuda_device)
        calls = {
            "merit_bwd": lambda: [ft.merit_bwd(
                params, aim, stats, mspec, nc, R, Px=Px, Py=Py,
                coeffs=coeffs, lay=lay)],
            "trace_field_bwd": lambda: [ftr.trace_field_bwd(
                params, aim, spec, nc, Px, Py, cots, coeffs, lay)],
            "trace_bwd": lambda: ftr.trace_bwd(params, spec, nc, ins, cots,
                                               coeffs, lay),
        }
        if poly:
            pq = ftr.build_poly_table(system).to(dtype).contiguous()
            mq = system.stack.mat_coeffs.to(dtype).contiguous()
            calls["trace_bwd_poly"] = lambda: ftr.trace_bwd_poly(
                pq, mq, ftr.poly_spec(system), nc, ins + [w], cots, coeffs,
                lay)
        ftr.reset_launch_counts()
        ft.reset_launch_counts()
        for name, call in calls.items():
            a, b = flat(call()), flat(call())
            assert torch.isfinite(a).any(), (suf, name)
            assert torch.equal(a, b), (
                f"{name}{suf}: two launches differ in {int((a != b).sum())} "
                "entries")
        assert ft.LAUNCHES == _only(ft.LAUNCHES, **{"merit_bwd" + suf: 2})
        assert ftr.LAUNCHES == _only(ftr.LAUNCHES, **{
            n + suf: 2 for n in calls if n != "merit_bwd"})


# ---------------------------------------------------------------------------
# The per-thread-sum backwards: the stock and tilt builds of merit_bwd and
# trace_bwd (every mode), whose shape follows from their shared memory
# (launch.bwd_shape, launch.bwd_grid)
# ---------------------------------------------------------------------------


def _pt_calls(kind, dtype, R, device):
    """Each per-thread-sum backward on the Cooke triplet (the stock build)
    or the toleranced triplet (tilt): name -> fn(block) giving its per-ray
    input cotangents (an empty tuple for the field and merit modes) and
    its summed gradient."""
    system = _poly_system(kind, device)
    params, mats, ins, cots = _poly_inputs(system, R, 7, device)
    params, mats = params.to(dtype), mats.to(dtype)
    ins, cots = [t.to(dtype) for t in ins], [t.to(dtype) for t in cots]
    with torch.no_grad():
        pk = ft.build_param_table(system, WL).to(dtype).contiguous()
        aim = ft.aim_vector(system, *H).to(dtype).contiguous()
    spec, mspec = ftr.fast_spec(system), ft._spec_of(system)
    pspec = ftr.poly_spec(system)
    assert {ft._build(mspec), ftr._build(spec), ftr._build(pspec)} == {
        launch.TILT if kind == "tilted" else launch.STOCK}
    Px, Py = ft.prng_disk_plain(3, R, 0, dtype, device)
    rows = ft.merit_fwd(pk, aim, mspec, R, seed=5)
    _, xb, yb = ft._chan_combine(rows, R)
    stats = torch.stack([xb, yb, 1.0 / R + 0 * xb, 0 * xb])
    return {
        "merit_bwd": lambda b: ((), ft.merit_bwd(pk, aim, stats, mspec, 1,
                                                 R, seed=5, block=b)),
        "trace_bwd": lambda b: ftr.trace_bwd(pk, spec, 1, ins[:8], cots,
                                             block=b),
        "trace_field_bwd": lambda b: ((), ftr.trace_field_bwd(
            pk, aim, spec, 1, Px, Py, cots, block=b)),
        "trace_bwd_poly": lambda b: ftr.trace_bwd_poly(
            params, mats, pspec, 1, ins, cots, block=b),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cooke", "tilted"])
def test_per_thread_backwards_repeat_bit_for_bit(cuda_device, kind):
    for name, call in _pt_calls(kind, torch.float32, 200001,
                                cuda_device).items():
        (din, grad), (din2, grad2) = call(128), call(128)
        assert torch.equal(grad, grad2), name
        assert all(torch.equal(a, b) for a, b in zip(din, din2)), name


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cooke", "tilted"])
def test_per_thread_backwards_agree_across_blocks(cuda_device, kind):
    calls = _pt_calls(kind, torch.float32, 100001, cuda_device)
    refs = {name: call(128) for name, call in calls.items()}
    for block in (32, 64):
        for name, call in calls.items():
            (din, grad), (din_r, grad_r) = call(block), refs[name]
            # the per-ray input cotangents do not depend on the block
            assert all(torch.equal(a, b) for a, b in zip(din, din_r)), name
            # the summed gradients only in their order of summation
            got, ref = grad.double(), grad_r.double()
            fin = torch.isfinite(ref)
            assert torch.equal(fin, torch.isfinite(got)), (name, block)
            err = float(torch.linalg.vector_norm(got[fin] - ref[fin])
                        / torch.linalg.vector_norm(ref[fin]))
            assert err <= 1e-3, (name, block, err)


@pytest.mark.cuda
def test_widest_stock_system_launches_and_matches_plain(cuda_device):
    # 16 surfaces in f64, poly mode, nm = 20: 151 columns per thread and
    # 320 per warp
    system = _plates(7)
    spec = ftr.poly_spec(system)
    assert len(spec[0]) == 16 and ftr._build(spec) == launch.STOCK
    R, nc = 20001, system.stack.coeffs.shape[1]
    params, mats, ins, cots = _poly_inputs(system, R, 8, cuda_device)
    assert mats.shape == (16, 20)
    assert launch.bwd_grid("trace_bwd", "poly", 16, 20, torch.float64,
                           launch.STOCK, R, cuda_device)[0] == 128
    din, flat = ftr.trace_bwd_poly(params, mats, spec, nc, ins, cots)
    din_p, flat_p = ftr.trace_bwd_poly_plain(params, mats, spec, nc, ins,
                                             cots)
    _close(din, din_p, 1e-10, "trace_bwd_poly input cotangent")
    fin = torch.isfinite(flat_p)
    assert torch.equal(fin, torch.isfinite(flat))
    torch.testing.assert_close(flat[fin], flat_p[fin], rtol=1e-9,
                               atol=1e-12 * float(flat_p[fin].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("case,build", [
    ("bench_axis", "stock"), ("tilted_singlet", "tilt"),
    ("coated_asphere", "sag"), ("plates", "deep"), ("coated_xy", "free"),
    ("coated_q2d", "aux"), ("coated_nurbs", "nurbs")])
def test_pol_bwd_builds_match_both_plain_forms(cuda_device, case, build):
    """pol_bwd of every build (f64, 5003 rays: not a multiple of the block)
    against pol_bwd_plain, the full mode and the intensity mode of one and
    of two states, the latter against the matrix form and the vector form
    (``fields``) both, as the trace kernels' tolerances; it launches the
    one wave of ``pol_grid`` on its build, and two launches give the same
    bits (the fixed-order reduce)."""
    from optiland_torch.ops import pol_trace as pt
    from optiland_torch.samples import polarized

    lens = {"bench_axis": lambda: polarized.bench_polarized(
                "polarized_axis"),
            "tilted_singlet": perturbed.tilted_singlet,
            "coated_asphere": lambda: perturbed.coated_asphere("H"),
            "plates": polarized.coated_plates,
            "coated_xy": lambda: freeform.coated_freeform("polynomial", "H"),
            "coated_q2d": lambda: freeform.coated_freeform("forbes_q2d",
                                                           "H"),
            "coated_nurbs": lambda: nurbs.coated_nurbs("H")}[case]()
    system = lens.system
    R = 5003
    wl, params, _, _, _, _, ins, _ = _k6_inputs(system, freeform.H, R, 15)
    coeffs, lay = _aux_tables(system)
    nc = coeffs.shape[1]
    spec = pt.pol_spec(system, wl)
    assert launch.BUILD_SUFFIX[pt._build(spec)] == (
        "" if build == "stock" else "_" + build)
    coat = pt.build_coat_table(system, wl, torch.float64, cuda_device)
    g = torch.Generator(device="cpu").manual_seed(15)
    cots = [torch.randn(R, generator=g, dtype=torch.float64).to(
        cuda_device) for _ in range(pt.N_POL)]
    block, nb, _ = pt.pol_grid(spec, nc, coat.shape[1], R, True,
                               torch.float64, cuda_device, lay)
    assert block == launch.BWD_BLOCK and 1 <= nb <= -(-R // block)
    for states, intensity in (
            (None, False), (pt.pol_states(create_polarization("H")), True),
            (pt.pol_states(None), True)):
        c = cots[:8] if intensity else cots
        din, flat = pt.pol_bwd(params, coat, spec, nc, ins, c, states,
                               intensity, coeffs, lay)
        din2, flat2 = pt.pol_bwd(params, coat, spec, nc, ins, c, states,
                                 intensity, coeffs, lay)
        assert torch.equal(flat, flat2) and all(
            torch.equal(a, b) for a, b in zip(din, din2))
        for fields in (False, True) if intensity else (False,):
            din_p, flat_p = pt.pol_bwd_plain(
                params, coat, spec, ins, c, states, intensity, coeffs, nc,
                with_coeffs=True, lay=lay, fields=fields)
            what = f"{case} pol_bwd intensity={intensity} fields={fields}"
            _close(din, din_p, 1e-10, what, positions=False)
            _flat_close(flat, flat_p, what)
