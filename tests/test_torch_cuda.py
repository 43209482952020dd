"""optiland_torch's CUDA kernels against their plain PyTorch versions.

The tests marked ``cuda`` need a CUDA card and nvcc (the kernels build at
first use) and skip without one; run them on a card with

    python3 -m pytest tests/test_torch_cuda.py -m cuda -o addopts="" -p no:randomly

This file imports nothing of optiland_tpu, so it runs where only the port's
dependencies are installed. Tolerances: Philox uniforms identical, disk
samples within 1e-6 (f32) / 1e-14 (f64) absolute (cos/sin rounding); the
f64 merit to rtol 1e-12 and its gradient to rtol 1e-9 with atol 1e-12 x the
largest entry (sums of 5e4 per-ray terms in another order).
"""

import pytest
import torch

from optiland_torch import config
from optiland_torch.ops import _cuda
from optiland_torch.ops import fused_trace as ft
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


def _setup(kind="cooke"):
    system = CookeTriplet().system if kind == "cooke" else _mirror_system()
    with torch.no_grad():
        params = ft.build_param_table(system, WL).contiguous()
        aim = ft.aim_vector(system, *H).contiguous()
    return system, params, aim, ft._spec_of(system)


def test_cpu_work_never_builds_or_loads_the_library():
    config.set_device("cpu")
    config.set_precision("float64")
    before = _cuda._LIB
    system = CookeTriplet().system
    loss = ft.spot_rms_fast_field(system, *H, WL, num_rays=512, seed=1)
    assert torch.isfinite(loss)
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
