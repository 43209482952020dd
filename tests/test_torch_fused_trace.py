"""optiland_torch's fused RMS-spot merit against the JAX package, on the CPU
in float64, and its CUDA kernels against their plain versions on a card.

On the CPU every op wrapper runs its kernel's plain PyTorch version, so these
tests hold the plain versions (the per-ray trace, the hand-derived adjoint,
the Philox sampler) and the op layer around them to the JAX package's
``spot_rms_fast_field`` at 256 explicit pupil samples. The JAX reference runs
in interpret mode, as the JAX package's own tests run it, once per module.
The CUDA kernels are held against these plain versions on a card by
``tests/test_torch_cuda.py``.

Tolerances: the loss to rtol 1e-10 and every stack-leaf gradient to rtol 1e-8
with atol 1e-13 wherever JAX is finite (the tilt rz derivative is rounding
noise of ~1e-18 about an exact zero; the JAX gradient is NaN in the object
row's radius and in the object/image rows' index coefficient, the reference's
own behaviour, which the comparison leaves out). The hand adjoint matches
torch.autograd to rtol 1e-10 with atol 1e-15 (sums of 256 terms in another
order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch import config
from optiland_torch.core.system import (
    STACK_FIELDS, SYSTEM_FIELDS, system_from_numpy,
)
from optiland_torch.ops import fused_trace as ft
from optiland_torch.optic import Optic
from optiland_torch.samples import CookeTriplet as TorchCooke
from optiland_tpu.ops import pallas_trace as jpt
from optiland_tpu.samples import CookeTriplet as JaxCooke
from tests.torch_shared import run_compiled_once, shared

H = (0.0, 0.7)
WL = 0.55
N_RAYS = 256


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield
    config.set_device("cpu")
    config.set_precision("float64")


def pupil(n=N_RAYS, seed=3):
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n))
    th = rng.uniform(0, 2 * np.pi, size=n)
    return r * np.cos(th), r * np.sin(th)


def carried_system(jsys):
    arrays = {k: np.asarray(getattr(jsys.stack, k)) for k in STACK_FIELDS}
    arrays.update({k: np.asarray(getattr(jsys, k)) for k in SYSTEM_FIELDS})
    cfg = {f.name: getattr(jsys.cfg, f.name)
           for f in dataclasses.fields(jsys.cfg)}
    return system_from_numpy(arrays, cfg)


def with_leaves(system):
    leaves = {k: v.detach().clone().requires_grad_(v.numel() > 0)
              for k, v in system.stack.leaves().items()}
    return system.replace(stack=system.stack.replace(**leaves)), leaves


@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """jax.value_and_grad of the JAX package's spot_rms_fast_field over
    every stack leaf (interpret mode on the CPU, f64), computed once per
    session (``torch_shared.shared``), and the JAX system."""
    jsys = JaxCooke().system

    def compute():
        Px, Py = pupil()

        def merit(stack):
            return jpt.spot_rms_fast_field(
                jsys.replace(stack=stack), *H, WL, Px=jnp.asarray(Px),
                Py=jnp.asarray(Py),
            )

        loss, grads = run_compiled_once(jax.value_and_grad(merit),
                                        jsys.stack)
        return {
            "Px": Px, "Py": Py, "loss": float(loss),
            "grads": {k: np.asarray(getattr(grads, k)) for k in STACK_FIELDS},
        }

    return {**shared(tmp_path_factory, "fused_cooke_merit", compute),
            "system": jsys}


@pytest.fixture(scope="module")
def port_results(jax_reference):
    """The port's value and stack-leaf gradients for the same samples, for a
    system built by the port's Optic and one carried across from JAX."""
    config.set_device("cpu")
    config.set_precision("float64")
    out = {}
    for build in ("optic", "carried"):
        system = (TorchCooke().system if build == "optic"
                  else carried_system(jax_reference["system"]))
        s2, leaves = with_leaves(system)
        loss = ft.spot_rms_fast_field(
            s2, *H, WL, Px=torch.tensor(jax_reference["Px"]),
            Py=torch.tensor(jax_reference["Py"]),
        )
        loss.backward()
        out[build] = {
            "loss": float(loss.detach()),
            "grads": {k: (np.zeros(tuple(v.shape)) if v.grad is None
                          else v.grad.numpy()) for k, v in leaves.items()},
        }
    return out


# ---------------------------------------------------------------------------
# The slice as a whole against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("build", ["optic", "carried"])
def test_merit_matches_jax(jax_reference, port_results, build):
    got = port_results[build]["loss"]
    assert got == pytest.approx(jax_reference["loss"], rel=1e-10, abs=0)


@pytest.mark.parametrize("leaf", STACK_FIELDS)
@pytest.mark.parametrize("build", ["optic", "carried"])
def test_gradient_matches_jax(jax_reference, port_results, build, leaf):
    ref = jax_reference["grads"][leaf]
    got = port_results[build]["grads"][leaf]
    assert got.shape == ref.shape
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-8, atol=1e-13)


def test_reference_nan_entries_are_the_known_ones(jax_reference):
    """The JAX gradient is NaN in radius[0] and mat_coeffs[0|7, 0] (the
    object-row ABCD step multiplies a zero cotangent by t = -inf). These
    are the only entries the parity tests leave out; what the port gives
    there is not pinned (a fix would make it finite)."""
    ref = jax_reference["grads"]
    bad = {k: np.argwhere(~np.isfinite(v)).tolist() for k, v in ref.items()
           if not np.isfinite(v).all()}
    assert bad == {"radius": [[0]], "mat_coeffs": [[0, 0], [7, 0]]}


# ---------------------------------------------------------------------------
# Launch side: param table and aim vector
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_system():
    return JaxCooke().system


def test_param_table_matches_jax(jax_system):
    a = np.asarray(jpt.build_param_table(jax_system, WL))
    b = ft.build_param_table(TorchCooke().system, WL).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=0)


@pytest.mark.parametrize("field", [(0.0, 0.0), (0.0, 0.7), (0.3, -1.0)])
def test_aim_vector_matches_jax(jax_system, field):
    a = np.asarray(jpt.aim_vector(jax_system, *field))
    b = ft.aim_vector(TorchCooke().system, *field).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-15)


def test_chan_combine_matches_jax():
    rng = np.random.default_rng(5)
    rows = np.column_stack([rng.normal(size=(7, 4)), rng.integers(1, 300, 7)])
    R = int(rows[:, 4].sum())
    a = jpt._chan_combine(jnp.asarray(rows), R)
    b = ft._chan_combine(torch.tensor(rows), R)
    for u, v in zip(b, a):
        assert float(u) == pytest.approx(float(v), rel=1e-14)


def test_spec_and_support():
    system = TorchCooke().system
    assert ft._spec_of(system) == ((0, 1, 1, 1, 1, 1, 1, 0), (False,) * 8,
                                   (False,) * 8, (False,) * 8, 10)
    assert ft._tilt_mask(system) == [False] * 8
    assert ft.fused_supported(system)
    # tilted surfaces are flagged and covered (a nonzero or non-finite angle)
    tilted = system.replace(stack=system.stack.replace(
        rx=system.stack.rx + torch.tensor([0, 0, 0.01, 0, 0, 0, 0, 0.0])))
    assert ft._tilt_mask(tilted) == [False, False, True] + [False] * 5
    assert ft._spec_of(tilted)[2] == (False, False, True) + (False,) * 5
    assert ft.fused_supported(tilted)
    nan_tilt = system.replace(stack=system.stack.replace(
        rz=system.stack.rz + torch.tensor([0, float("nan")] + [0.0] * 6)))
    assert ft._spec_of(nan_tilt)[2] == (False, True) + (False,) * 6
    assert ft.fused_supported(nan_tilt)
    assert torch.isfinite(ft.spot_rms_fast_field(tilted, *H, WL,
                                                 num_rays=64))
    # a finite object is no angle field: the merit kernels do not take it
    finite = system.replace(cfg=dataclasses.replace(system.cfg,
                                                    obj_infinite=False))
    assert not ft.fused_supported(finite)
    with pytest.raises(NotImplementedError, match="later slice"):
        ft.spot_rms_fast_field(finite, *H, WL, num_rays=64)
    for tile in (48, 16, 256):
        with pytest.raises(ValueError, match="bwd_tile"):
            ft.spot_rms_fast_field(system, *H, WL, num_rays=64, bwd_tile=tile)
    with pytest.raises(ValueError, match="num_rays"):
        ft.spot_rms_fast_field(system, *H, WL)


# ---------------------------------------------------------------------------
# prng_disk: Philox4x32-10 and the sample contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ones, expect", [
    (False, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    (True, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(ones, expect):
    w = 0xFFFFFFFF if ones else 0
    out = ft.philox4x32_10((w, w, w, w), (w, w))
    assert tuple(int(v) for v in out) == expect


def test_prng_samples_do_not_depend_on_offset_or_tile():
    full = ft.prng_disk_plain(42, 10000, 0, torch.float64, "cpu")
    tail = ft.prng_disk_plain(42, 3000, 7000, torch.float64, "cpu")
    assert torch.equal(full[0][7000:], tail[0])
    assert torch.equal(full[1][7000:], tail[1])
    a = ft.prng_pupil_samples(42, 5000, tile=64)
    b = ft.prng_pupil_samples(42, 5000, tile=512)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    shard = ft.prng_pupil_samples(42, ft.SUB_RAYS, sub_offset=2)
    whole = ft.prng_pupil_samples(42, 3 * ft.SUB_RAYS)
    assert torch.equal(shard[0], whole[0][2 * ft.SUB_RAYS :])
    other = ft.prng_disk_plain(43, 10000, 0, torch.float64, "cpu")
    assert not torch.equal(other[0], full[0])


def test_prng_samples_are_uniform_on_the_disk():
    px, py, u1, u2 = ft.prng_disk_plain(7, 200000, 0, torch.float64, "cpu",
                                        with_u=True)
    r2 = px**2 + py**2
    assert float(r2.max()) < 1.0
    # u = k 2^-24 exactly
    assert torch.equal(u1 * 2**24, torch.round(u1 * 2**24))
    # uniform on the disk: E[r^2] = 1/2, E[x] = E[y] = 0; 5-sigma bounds
    assert abs(float(r2.mean()) - 0.5) < 5 * (1 / 12) ** 0.5 / 200000**0.5
    assert abs(float(px.mean())) < 5 * 0.5 / 200000**0.5
    assert abs(float(py.mean())) < 5 * 0.5 / 200000**0.5
    # one quadrant holds a quarter of the samples
    q = float(((px > 0) & (py > 0)).double().mean())
    assert abs(q - 0.25) < 5 * (0.25 * 0.75 / 200000) ** 0.5


def test_prng_mode_equals_explicit_mode():
    """The PRNG-mode loss and gradients equal the explicit mode fed the
    prng_pupil_samples of the same seed (the forward/backward sample
    contract)."""
    system = TorchCooke().system
    sa, la = with_leaves(system)
    l_prng = ft.spot_rms_fast_field(sa, *H, WL, num_rays=1000, seed=11)
    l_prng.backward()
    Px, Py = ft.prng_pupil_samples(11, 1000)
    sb, lb = with_leaves(system)
    l_expl = ft.spot_rms_fast_field(sb, *H, WL, Px=Px, Py=Py)
    l_expl.backward()
    assert float(l_prng) == float(l_expl)
    for k, v in la.items():
        if v.grad is not None:
            assert torch.equal(torch.nan_to_num(v.grad),
                               torch.nan_to_num(lb[k].grad)), k


# ---------------------------------------------------------------------------
# Plain versions: trace, per-block rows, hand adjoint
# ---------------------------------------------------------------------------


def _tables(system, field=H):
    with torch.no_grad():
        return ft.build_param_table(system, WL), ft.aim_vector(system, *field)


def test_merit_rows_give_the_direct_spot_and_ignore_the_block():
    system = TorchCooke().system
    params, aim = _tables(system)
    spec = ft._spec_of(system)
    Px, Py = (torch.tensor(a) for a in pupil(1000))
    x, y = ft.trace_xy_plain(params, aim, spec, Px, Py)
    direct = float(((x - x.mean()) ** 2 + (y - y.mean()) ** 2).mean())
    for block in (32, 256, 1000, 4096):
        rows = ft.merit_fwd_plain(params, aim, spec, 1000, Px=Px, Py=Py,
                                  block=block)
        assert rows.shape == (-(-1000 // block), 5)
        assert float(rows[:, 4].sum()) == 1000
        loss = float(ft._chan_combine(rows, 1000)[0])
        assert loss == pytest.approx(direct, rel=1e-12)


def _mirror_system():
    """A concave mirror focusing an on-axis bundle (exercises the reflect
    branch of the trace and of its adjoint)."""
    lens = Optic()
    lens.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
    lens.surfaces.add(index=1, radius=-200.0, thickness=-100.0,
                      material="mirror", is_stop=True, conic=-0.5)
    lens.surfaces.add(index=2)
    lens.set_aperture(aperture_type="EPD", value=20)
    lens.fields.set_type(field_type="angle")
    lens.fields.add(y=0)
    lens.fields.add(y=1)
    lens.wavelengths.add(value=0.55, is_primary=True)
    return lens.system


@pytest.mark.parametrize("case", ["cooke_0.7", "cooke_x_field", "mirror"])
def test_hand_adjoint_matches_autograd(case):
    system = _mirror_system() if case == "mirror" else TorchCooke().system
    field = (0.3, -1.0) if case == "cooke_x_field" else H
    params, aim = _tables(system, field)
    spec = ft._spec_of(system)
    S = len(spec[0])
    Px, Py = ft.prng_disk_plain(5, N_RAYS, 0, torch.float64, "cpu")
    rows = ft.merit_fwd(params, aim, spec, N_RAYS, Px=Px, Py=Py)
    _, xbar, ybar = ft._chan_combine(rows, N_RAYS)
    stats = torch.stack([xbar, ybar, torch.tensor(0.75 / N_RAYS),
                         torch.tensor(0.0)])
    hand = ft.merit_bwd(params, aim, stats, spec, 1, N_RAYS, Px=Px, Py=Py)

    p = params.clone().requires_grad_()
    a = aim.clone().requires_grad_()
    x, y = ft.trace_xy_plain(p, a, spec, Px, Py)
    merit = stats[2] * ((x - xbar) ** 2 + (y - ybar) ** 2).sum()
    gp, ga = torch.autograd.grad(merit, [p, a])
    ref = torch.cat([gp.reshape(-1), torch.zeros(S), ga])
    assert hand.shape == ref.shape
    np.testing.assert_allclose(hand.numpy(), ref.numpy(), rtol=1e-10,
                               atol=1e-15)
    # the columns the merit does not reach stay exactly zero
    dp = hand[: S * ft.NUM_P].reshape(S, ft.NUM_P)
    other = [c for c in range(ft.NUM_P) if c not in ft.GRAD_COLS]
    assert torch.count_nonzero(dp[:, other]) == 0


def test_mirror_merit_is_differentiable_end_to_end():
    system = _mirror_system()
    s2, leaves = with_leaves(system)
    loss = ft.spot_rms_fast_field(s2, 0.0, 1.0, WL, num_rays=512, seed=3)
    loss.backward()
    assert float(loss) > 0
    assert torch.isfinite(leaves["radius"].grad[1])
    assert float(leaves["conic"].grad[1]) != 0.0


def test_cpu_wrappers_run_the_plain_versions():
    ft.reset_launch_counts()
    system = TorchCooke().system
    params, aim = _tables(system)
    spec = ft._spec_of(system)
    rows = ft.merit_fwd(params, aim, spec, 300, seed=1)
    assert torch.equal(rows, ft.merit_fwd_plain(params, aim, spec, 300,
                                                seed=1))
    px, py = ft.prng_disk(1, 300, 0, torch.float64, "cpu")
    assert torch.equal(px, ft.prng_disk_plain(1, 300, 0, torch.float64,
                                              "cpu")[0])
    assert ft.LAUNCHES == {"prng_disk": 0, **{
        n + suf: 0 for n in ("merit_fwd", "merit_bwd")
        for suf in ("", "_tilt", "_sag", "_free", "_deep", "_deep_free",
                    "_aux", "_deep_aux", "_nurbs", "_grat")}}
    with pytest.raises(TypeError, match="float32 or float64"):
        ft.prng_disk(1, 10, 0, torch.float16, "cpu")
