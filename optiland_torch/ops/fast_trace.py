"""Generic and field ray traces: Hopper kernels, their plain PyTorch versions,
and the op layer around them.

Counterpart of the ``trace_fast`` / ``trace_fast_field`` half of
``optiland_tpu/ops/pallas_trace.py``. Four CUDA kernels written for sm_90a
(``csrc/fast_trace.cu``) do the work on a CUDA device:

  * ``trace_fwd`` (ports ``_make_fwd_kernel``, monochromatic mode, K5a):
    trace 8 per-ray arrays (x, y, z, L, M, N, i, opd) through the surface
    chain and write the 8 final arrays;
  * ``trace_bwd`` (ports ``_make_bwd_kernel``, K5b): retrace and run the
    hand-derived adjoint seeded with the 8 output cotangents; writes the 8
    per-ray input cotangents and one partial row per block of the summed
    parameter gradients, which a second launch sums in a fixed order;
  * ``trace_fwd_poly`` and ``trace_bwd_poly`` (the polychromatic mode of
    K5a and K5b): the same with a 9th per-ray array, the wavelength; each
    surface's index comes per ray from its dispersion formula and its
    (S, nm) coefficient rows, and the adjoint also sums the gradient of
    every coefficient;
  * ``trace_field_fwd`` (ports ``_make_fwd_kernel_field``, K1): as
    ``trace_fwd``, with each ray launched in-kernel from its pupil sample
    (Px, Py) and the 8-scalar aim vector (intensity 1, OPD 0);
  * ``trace_field_bwd`` (ports ``_make_bwd_kernel_field``, K4): the adjoint
    of K1, which writes only the summed parameter and aim gradients.

Beside each kernel sits its plain PyTorch version (``*_plain``), which the
wrapper runs when, and only when, its tensors lie on the CPU, and a launch
count in ``LAUNCHES``. On a CUDA tensor a wrapper launches its kernel or
raises; nothing falls back.

The step is the full form of ``ops/step.py``: absorption, OPD and the
circular clip are traced, a tilted surface's rotations (the spec's tilt
flags), the annular clip of a RadialAperture with r_min > 0 (the spec's
``inner`` flags) and the Newton intersection of the radial aspheres and
the Cartesian freeforms, which read the (S, nc) coefficient table (and
the freeforms the P_G1 and P_G2 columns; the aux-bearing ones their
laid-out rows and the layout table, ``launch.kernel_tables``); the
backwards give their
gradients. A grating surface (K6c, the spec's grating flags) diffracts in
the monochromatic kernels' grating build, with P_MLAM the order times the
wavelength, and the backwards give its P_G1 and P_G2 gradients; the
polychromatic kernels take no grating, as in the JAX package. A NURBS
surface (K6d) intersects by the two-plane (u, v) solve on its net (its
coefficient row, with the knot table as ``lay``) in every kernel's nurbs
build, and the backwards give its net's gradient. As in
the JAX package's kernels, the
Beer-Lambert factor is applied only where the medium before the surface
absorbs, read from the k tables' values; when the k tables are
differentiated (they require grad, the counterpart of JAX tracers), every
surface applies it, so the gradient of every k table is formed as the JAX
package forms it. The polychromatic mode applies no absorption, whatever
the flags, as the JAX package's poly body does not.
"""

from __future__ import annotations

import torch

from optiland_torch.core.rays import RealRays
from optiland_torch.core.system import positions, scalar_like
from optiland_torch.materials import dispersion
from optiland_torch.ops.fused_trace import (
    _aperture_columns, _coeffs_or_zeros, aim_vector, build_param_table,
    coef_row,
)
from optiland_torch.ops.launch import (
    BWD_BLOCK, BWD_MAX_BLOCKS, GRAT, N_AIM, TRACE_BUILDS, build_of,
    check_cuda_inputs, covered, device_of, device_table, entry_name, flags,
    grating_flags, inner_flags, kernel_tables, launch_from_pupil, launch_key,
    lay_row, sag_columns, sag_surfaces, unsupported, with_builds,
)
from optiland_torch.ops.step import (
    FULL_GRAD_COLS, NUM_P, P_NPOST, split_cols, step_adjoint_plain,
    step_plain,
)

# Launch counts of the six kernels per build (``launch.launch_key``; the
# grating build of the four monochromatic ones only); each wrapper adds one
# where it launches its kernel and nowhere else (a backward counts its
# partial-row launch together with the fixed-order reduction launch that
# follows it).
LAUNCHES = {
    **with_builds(("trace_fwd", "trace_bwd", "trace_field_fwd",
                   "trace_field_bwd"), TRACE_BUILDS + (GRAT,)),
    **with_builds(("trace_fwd_poly", "trace_bwd_poly")),
}

# Formula codes the polychromatic kernels evaluate (all but TABULATED_N),
# and the widest coefficient row they take (csrc/step.cuh: MAX_NM)
POLY_FORMULAS = frozenset(range(dispersion.NUM_FORMULAS)) - {
    dispersion.TABULATED_N}
MAX_NM = dispersion.MAX_COEFFS

RAY_FIELDS = ("x", "y", "z", "L", "M", "N", "i", "opd")


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Structure: masks, spec, support
# ---------------------------------------------------------------------------


def _masks(system):
    """(tilted, absorbs) per surface from one read of the values: a surface
    is tilted where a tilt angle is nonzero or not finite, and absorbs where
    the medium before it (material_post of s - 1) has a nonzero k entry.
    All surfaces absorb when the k tables are being differentiated, none
    when the system has no absorbing material (``_absorption_mask`` of the
    JAX package).

    Like ``_absorption_mask``, which reads the k values on every call, the
    absorb flags are read on every call, not cached per system: they share
    the tilt check's host read, which the tilt values (optimization
    variables) need on every call anyway, so they add no sync, and a cache
    would have to notice a k table replaced or changed in place."""
    st, cfg = system.stack, system.cfg
    S = cfg.num_surfaces
    tilt = (torch.stack([st.rx, st.ry, st.rz]).detach() != 0).any(dim=0)
    kt = st.ktab
    traced = kt.requires_grad and torch.is_grad_enabled()
    if cfg.has_absorption and not traced and kt.shape[1] > 0:
        mat = (kt[..., 1].detach() != 0).any(dim=1)
    else:
        mat = torch.full_like(tilt, bool(cfg.has_absorption))
    vals = torch.cat([tilt, mat]).tolist()  # the one host read
    tilted, mat = vals[:S], vals[S:]
    absorbs = (False,) + tuple(bool(m) for m in mat[: S - 1])
    return tilted, absorbs


def fast_spec(system, field=False, newton_iters=10):
    """The kernels' static spec (geometry codes, reflective flags, absorb
    flags, tilt flags, grating flags, annular flags, Newton iterations)
    when they cover this system, else None; the first five rows go to the
    kernels as flags. ``field`` asks for the field kernels, which also need
    an infinite-conjugate angle field. Coverage is that of the merit
    kernels: PLANE, STANDARD, the Newton families (EVEN_ASPHERE,
    ODD_ASPHERE, POLYNOMIAL_XY, CHEBYSHEV, TOROIDAL, BICONIC, ZERNIKE_SAG,
    FORBES_QBFS, FORBES_Q2D) and NURBS surfaces, tilted or not,
    RadialAperture objects and no others, no interactions but gratings on
    PLANE and STANDARD surfaces, no BSDFs (grid sag comes in a later
    slice), and no coatings or polarization (the polarized kernels of
    ``ops/pol_trace.py`` take those)."""
    cfg = system.cfg
    if not covered(cfg, field):
        return None
    tilted, absorbs = _masks(system)
    return (tuple(cfg.geom_codes), tuple(cfg.reflective), absorbs,
            tuple(bool(t) for t in tilted), grating_flags(cfg),
            inner_flags(cfg), int(newton_iters))


def _grat(spec):
    """The grating flags of a fast or poly spec (third from its end)."""
    return spec[-3]


def _build(spec):
    """The build a fast or poly spec launches."""
    return build_of(spec[0], spec[3], spec[-2], _grat(spec))


def fast_supported(system, field=False) -> bool:
    """True when ``trace_fast`` (or, with ``field``, ``trace_fast_field``)
    covers this system (counterpart of ``pallas_supported`` and
    ``pallas_field_supported``, limited to what the port's kernels cover)."""
    return fast_spec(system, field) is not None


def poly_spec(system, newton_iters=10):
    """The polychromatic kernels' spec: ``fast_spec``'s first four flag
    rows, the per-surface dispersion formula codes (the poly entries of the
    JAX package's ``_spec_of``; a fifth flag row), then the grating flags
    (all False), the annular flags and the Newton iterations, or None when
    the kernels do not cover the structure, it has a grating (the JAX
    package's poly kernels take none either) or a material is tabulated
    (TABULATED_N has no formula to evaluate per ray). The absorb flags are
    kept and ignored: the
    polychromatic trace applies no absorption. Nothing here reads
    ``cfg.has_absorption``: as the JAX package's ``trace_fast_poly``, the
    kernels trace an absorbing system without its absorption (see
    ``poly_supported``)."""
    spec = fast_spec(system, newton_iters=newton_iters)
    formulas = tuple(int(f) for f in system.cfg.mat_formulas)
    if (spec is None or any(_grat(spec))
            or any(f not in POLY_FORMULAS for f in formulas)):
        return None
    return spec[:4] + (formulas,) + spec[4:]


def poly_supported(system) -> bool:
    """Counterpart of ``pallas_supported(system, poly=True)``: the
    structure that ``poly_spec`` covers, and no absorbing material, which
    the polychromatic trace would ignore. The Cooke triplet carries k data,
    so this is False for it, as in the JAX package."""
    return poly_spec(system) is not None and not system.cfg.has_absorption


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _n_of(spec, mats, s, w):
    """Per-ray index after surface s of a polychromatic trace."""
    return dispersion.n_formula_scalar_terms(spec[4][s], mats[s].unbind(), w)


def _chain_plain(params, spec, st, keep=False, mats=None, w=None,
                 coeffs=None, lay=None):
    """Final state of the full chain; with ``keep`` also the per-surface
    input states and n_pre that the adjoint replays. With the per-ray
    wavelengths ``w`` (and the coefficient rows ``mats``) the chain is
    polychromatic: every index comes from its formula and nothing
    absorbs. ``coeffs`` is the geometry coefficient table, ``lay`` the
    layout table of its aux-bearing rows (``launch.kernel_tables``)."""
    codes, refl, absorbs = spec[:3]
    grat, inner, niters = spec[-3:]
    poly = w is not None
    n_pre = _n_of(spec, mats, 0, w) if poly else params[0, P_NPOST]
    states = []
    for s in range(1, len(codes)):
        if keep:
            states.append((st, n_pre))
        n_post = _n_of(spec, mats, s, w) if poly and not refl[s] else None
        st, n_pre = step_plain(codes[s], refl[s], params[s], n_pre, st,
                               absorbs[s] and not poly, n_post=n_post,
                               c=coef_row(coeffs, s), newton_iters=niters,
                               inner=inner[s], lay=lay_row(lay, codes[s], s),
                               grating=grat[s])
    return (st, states) if keep else st


def _field_launch(aim, Px, Py):
    return launch_from_pupil(aim, Px, Py) + (torch.ones_like(Px),
                                              torch.zeros_like(Px))


def trace_fast_plain(params, spec, rays, coeffs=None, lay=None):
    """Plain version of the trace_fwd kernel: the 8 final arrays of the 8
    launch arrays ``rays``."""
    return _chain_plain(params, spec, tuple(rays), coeffs=coeffs, lay=lay)


def trace_fast_field_plain(params, aim, spec, Px, Py, coeffs=None, lay=None):
    """Plain version of the trace_field_fwd kernel."""
    return _chain_plain(params, spec, _field_launch(aim, Px, Py),
                        coeffs=coeffs, lay=lay)


def _sweep_plain(params, spec, st0, cots, mats=None, w=None, coeffs=None,
                 nc=1, lay=None):
    """The hand-derived reverse sweep from the 8 output cotangents: returns
    the 8 per-ray cotangents of the launch state, the (S, NUM_P) param
    table gradient and the (S, nc) gradient of the coefficient table
    ``coeffs`` (nonzero in the rows of the Newton families), and for a
    polychromatic chain (``w`` given) also the gradient of the coefficient
    rows ``mats``, which takes the index cotangents (in the monochromatic
    chain the P_NPOST column's)."""
    codes, refl, absorbs, tilted = spec[:4]
    grat, inner, niters = spec[-3:]
    S = len(codes)
    poly = w is not None
    with torch.no_grad():
        _, states = _chain_plain(params, spec, st0, keep=True, mats=mats,
                                 w=w, coeffs=coeffs, lay=lay)
        g = tuple(cots[:6]) + (torch.zeros_like(st0[0]),) + tuple(cots[6:])
        dparams = params.new_zeros((S, NUM_P))
        dcoeffs = params.new_zeros((S, nc))
        dmats = mats.new_zeros(mats.shape) if poly else None

        def index_grad(s, g_n):
            # dmats[s, j] = sum over rays of g_n dn/dc_j
            _, dn = dispersion.n_formula_scalar_grad(
                spec[4][s], mats[s].unbind(), w)
            for j, d in enumerate(dn):
                if d is not None:
                    dmats[s, j] = (g_n * d).sum()

        for s in range(S - 1, 0, -1):
            st, n_pre = states[s - 1]
            n_post = _n_of(spec, mats, s, w) if poly and not refl[s] else None
            g_in, g_npre, cols = step_adjoint_plain(
                codes[s], refl[s], params[s], n_pre, st, g,
                absorbs[s] and not poly, tilted=tilted[s], n_post=n_post,
                c=coef_row(coeffs, s), newton_iters=niters, inner=inner[s],
                lay=lay_row(lay, codes[s], s), grating=grat[s],
            )
            pairs, coef = split_cols(codes[s], cols, FULL_GRAD_COLS, nc,
                                     grat[s])
            for j, v in enumerate(coef):
                dcoeffs[s, j] = v.sum()
            for col, v in pairs:
                if poly and col == P_NPOST:
                    if not refl[s]:
                        index_grad(s, v)
                else:
                    dparams[s, col] = v.sum()
            g = g_in[:6] + (g_npre,) + g_in[6:]
        # n_pre of surface 1 is the object row's n_post (its formula's)
        if poly:
            index_grad(0, g[6])
        else:
            dparams[0, P_NPOST] = g[6].sum()
    return (g[:6] + g[7:], dparams, dcoeffs) + ((dmats,) if poly else ())


def trace_fast_bwd_plain(params, spec, nc, rays, cots, coeffs=None,
                         lay=None):
    """Plain version of the trace_bwd kernel: (the 8 per-ray input
    cotangents, the flat gradient in the layout (S * NUM_P params, S * nc
    coeffs))."""
    din, dparams, dcoeffs = _sweep_plain(params, spec, tuple(rays), cots,
                                         coeffs=coeffs, nc=nc, lay=lay)
    return din, torch.cat([dparams.reshape(-1), dcoeffs.reshape(-1)])


def trace_fast_field_bwd_plain(params, aim, spec, nc, Px, Py, cots,
                               coeffs=None, lay=None):
    """Plain version of the trace_field_bwd kernel: the flat gradient in the
    layout (S * NUM_P params, S * nc coeffs, N_AIM aim). The pupil samples
    get no cotangent."""
    din, dparams, dcoeffs = _sweep_plain(
        params, spec, _field_launch(aim, Px, Py), cots, coeffs=coeffs, nc=nc,
        lay=lay)
    gx, gy, gz, gL, gM, gN = din[:6]
    with torch.no_grad():
        daim = torch.stack([
            gx.sum(), gy.sum(), gz.sum(), gL.sum(), gM.sum(), gN.sum(),
            (gx * Px).sum(), (gy * Py).sum(),
        ])
    return torch.cat([dparams.reshape(-1), dcoeffs.reshape(-1), daim])


def trace_fwd_poly_plain(params, mats, spec, rays, coeffs=None, lay=None):
    """Plain version of the trace_fwd_poly kernel: the 8 final arrays of
    the 9 launch arrays ``rays`` (the 8, then the wavelengths in um)."""
    rays = tuple(rays)
    return _chain_plain(params, spec, rays[:8], mats=mats, w=rays[8],
                        coeffs=coeffs, lay=lay)


def trace_bwd_poly_plain(params, mats, spec, nc, rays, cots, coeffs=None,
                         lay=None):
    """Plain version of the trace_bwd_poly kernel: (the 8 per-ray input
    cotangents, the flat gradient in the layout (S * NUM_P params, S * nc
    coeffs, S * nm coefficient rows)). The wavelengths get no cotangent."""
    rays = tuple(rays)
    din, dparams, dcoeffs, dmats = _sweep_plain(
        params, spec, rays[:8], cots, mats=mats, w=rays[8], coeffs=coeffs,
        nc=nc, lay=lay)
    return din, torch.cat([dparams.reshape(-1), dcoeffs.reshape(-1),
                           dmats.reshape(-1)])


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _empty8(like):
    return [torch.empty_like(like) for _ in range(8)]


def _bwd_blocks(R):
    return max(1, min(-(-R // BWD_BLOCK), BWD_MAX_BLOCKS))


def _launch(name, params, spec, coeffs, lay, before, rest):
    """Launch kernel ``name`` with (params, ``before``, flags, S, build,
    the coefficient and layout tables, nc, newton_iters, ``rest``)."""
    from optiland_torch.ops import _cuda

    build = _build(spec)
    table = device_table(coeffs, lay)  # held until the launch is queued
    with torch.cuda.device(params.device):
        rc = _cuda.call(
            entry_name(name, build), params.dtype, params.data_ptr(), *before,
            # the flag rows: all but the annular flags and newton_iters
            # (the grating row last, which only the grating build reads)
            flags(spec[:-2], params.device).data_ptr(), len(spec[0]), build,
            table.data_ptr(), coeffs.shape[1], spec[-1], *rest,
            _cuda.stream(),
        )
    _cuda.check(rc, name)
    LAUNCHES[launch_key(name, build)] += 1


def _partial(params, spec, nc, n_extra, R):
    """A backward's per-block partial rows, their count, and the count of
    surfaces with a block: FULL_GRAD_COLS per surface, the block of each
    Newton-family surface or, in the grating build, grating
    (``launch.block_width``), then ``n_extra``."""
    S, build = len(spec[0]), _build(spec)
    nsag = len(sag_surfaces(spec[0], build, _grat(spec)))
    ncomp = (S * len(FULL_GRAD_COLS)
             + sag_columns(spec[0], nc, build, _grat(spec)) + n_extra)
    nb = _bwd_blocks(R)
    return params.new_empty((nb, ncomp)), nb, nsag


def trace_fwd(params, spec, rays, coeffs=None, lay=None):
    """The 8 final arrays of the 8 launch arrays ``rays``: the trace_fwd
    kernel on a CUDA device, its plain version on the CPU. ``coeffs`` is
    the (S, nc) coefficient table (None: zeros), ``lay`` the layout table
    of its aux-bearing rows (``launch.kernel_tables``)."""
    if device_of(params.device, "trace_fwd") == "cpu":
        return trace_fast_plain(params, spec, rays, coeffs, lay)
    from optiland_torch.ops import _cuda

    rays = tuple(rays)
    coeffs = _coeffs_or_zeros(coeffs, params)
    check_cuda_inputs(params, spec, rays, coeffs=coeffs, lay=lay)
    out = _empty8(rays[0])
    _launch("trace_fwd", params, spec, coeffs, lay, (),
            (_cuda.pointers(rays), rays[0].shape[0], _cuda.pointers(out)))
    return tuple(out)


def trace_bwd(params, spec, nc, rays, cots, coeffs=None, lay=None):
    """(8 per-ray input cotangents, flat (S * NUM_P + S * nc) gradient) for
    the 8 output cotangents ``cots``: the trace_bwd kernel and its
    fixed-order reduction on a CUDA device, the plain version on the CPU."""
    if device_of(params.device, "trace_bwd") == "cpu":
        return trace_fast_bwd_plain(params, spec, nc, rays, cots, coeffs, lay)
    from optiland_torch.ops import _cuda

    rays, cots = tuple(rays), tuple(cots)
    coeffs = _coeffs_or_zeros(coeffs, params)
    check_cuda_inputs(params, spec, rays + cots, coeffs=coeffs, lay=lay)
    _check_nc(coeffs, nc)
    S, R = len(spec[0]), rays[0].shape[0]
    partial, nb, nsag = _partial(params, spec, nc, 0, R)
    din = _empty8(rays[0])
    out = params.new_zeros(S * (NUM_P + nc))
    _launch("trace_bwd", params, spec, coeffs, lay, (),
            (nsag, _cuda.pointers(rays), _cuda.pointers(cots), R,
             _cuda.pointers(din), partial.data_ptr(), nb, out.data_ptr()))
    return tuple(din), out


def trace_field_fwd(params, aim, spec, Px, Py, coeffs=None, lay=None):
    """The 8 final arrays of the rays launched from the pupil samples: the
    trace_field_fwd kernel on a CUDA device, its plain version on the
    CPU."""
    if device_of(params.device, "trace_field_fwd") == "cpu":
        return trace_fast_field_plain(params, aim, spec, Px, Py, coeffs, lay)
    from optiland_torch.ops import _cuda

    coeffs = _coeffs_or_zeros(coeffs, params)
    check_cuda_inputs(params, spec, (Px, Py), aim, coeffs, lay)
    out = _empty8(Px)
    _launch("trace_field_fwd", params, spec, coeffs, lay, (aim.data_ptr(),),
            (Px.data_ptr(), Py.data_ptr(), Px.shape[0], _cuda.pointers(out)))
    return tuple(out)


def trace_field_bwd(params, aim, spec, nc, Px, Py, cots, coeffs=None,
                    lay=None):
    """Flat (S * NUM_P + S * nc + N_AIM) gradient for the 8 output
    cotangents ``cots``: the trace_field_bwd kernel and its fixed-order
    reduction on a CUDA device, the plain version on the CPU."""
    if device_of(params.device, "trace_field_bwd") == "cpu":
        return trace_fast_field_bwd_plain(params, aim, spec, nc, Px, Py, cots,
                                          coeffs, lay)
    from optiland_torch.ops import _cuda

    cots = tuple(cots)
    coeffs = _coeffs_or_zeros(coeffs, params)
    check_cuda_inputs(params, spec, (Px, Py) + cots, aim, coeffs, lay)
    _check_nc(coeffs, nc)
    S, R = len(spec[0]), Px.shape[0]
    partial, nb, nsag = _partial(params, spec, nc, N_AIM, R)
    out = params.new_zeros(S * (NUM_P + nc) + N_AIM)
    _launch("trace_field_bwd", params, spec, coeffs, lay, (aim.data_ptr(),),
            (nsag, Px.data_ptr(), Py.data_ptr(), _cuda.pointers(cots), R,
             partial.data_ptr(), nb, out.data_ptr()))
    return out


def _check_nc(coeffs, nc):
    if coeffs.shape[1] != nc:
        raise ValueError(f"nc ({nc}) must be the coefficient table's width "
                         f"({coeffs.shape[1]})")


def _check_poly(params, mats, spec, arrays, coeffs, lay):
    check_cuda_inputs(params, spec, arrays, coeffs=coeffs, lay=lay)
    if len(spec) != 8 or any(f not in POLY_FORMULAS for f in spec[4]):
        raise ValueError("the polychromatic kernels take a spec with a "
                         "formula code (not TABULATED_N) per surface")
    if any(_grat(spec)):
        raise NotImplementedError("the polychromatic kernels take no "
                                  "grating, as the JAX package's do not")
    if (mats.device != params.device or mats.dtype != params.dtype
            or not mats.is_contiguous() or mats.dim() != 2
            or mats.shape[0] != len(spec[0])
            or not 1 <= mats.shape[1] <= MAX_NM):
        raise ValueError(f"the coefficient rows must be a contiguous (S, nm) "
                         f"{params.dtype} tensor on {params.device} with "
                         f"1 <= nm <= {MAX_NM}")


def trace_fwd_poly(params, mats, spec, rays, coeffs=None, lay=None):
    """The 8 final arrays of the 9 launch arrays ``rays`` (the last the
    per-ray wavelengths): the trace_fwd_poly kernel on a CUDA device, its
    plain version on the CPU."""
    if device_of(params.device, "trace_fwd_poly") == "cpu":
        return trace_fwd_poly_plain(params, mats, spec, rays, coeffs, lay)
    from optiland_torch.ops import _cuda

    rays = tuple(rays)
    coeffs = _coeffs_or_zeros(coeffs, params)
    _check_poly(params, mats, spec, rays, coeffs, lay)
    out = _empty8(rays[0])
    _launch("trace_fwd_poly", params, spec, coeffs, lay, (mats.data_ptr(),),
            (mats.shape[1], _cuda.pointers(rays), rays[0].shape[0],
             _cuda.pointers(out)))
    return tuple(out)


def trace_bwd_poly(params, mats, spec, nc, rays, cots, coeffs=None,
                   lay=None):
    """(8 per-ray input cotangents, flat (S * NUM_P + S * nc + S * nm)
    gradient) for the 8 output cotangents ``cots`` of a polychromatic
    trace: the trace_bwd_poly kernel and its fixed-order reduction on a
    CUDA device, the plain version on the CPU."""
    if device_of(params.device, "trace_bwd_poly") == "cpu":
        return trace_bwd_poly_plain(params, mats, spec, nc, rays, cots,
                                    coeffs, lay)
    from optiland_torch.ops import _cuda

    rays, cots = tuple(rays), tuple(cots)
    coeffs = _coeffs_or_zeros(coeffs, params)
    _check_poly(params, mats, spec, rays + cots, coeffs, lay)
    _check_nc(coeffs, nc)
    S, R, nm = len(spec[0]), rays[0].shape[0], mats.shape[1]
    partial, nb, nsag = _partial(params, spec, nc, S * nm, R)
    din = _empty8(rays[0])
    out = params.new_zeros(S * (NUM_P + nc + nm))
    _launch("trace_bwd_poly", params, spec, coeffs, lay, (mats.data_ptr(),),
            (nsag, nm, _cuda.pointers(rays), _cuda.pointers(cots), R,
             _cuda.pointers(din), partial.data_ptr(), nb, out.data_ptr()))
    return tuple(din), out


# ---------------------------------------------------------------------------
# autograd Functions and public entries
# ---------------------------------------------------------------------------


def _split(flat, S, nc):
    dparams = flat[: S * NUM_P].reshape(S, NUM_P)
    dcoeffs = flat[S * NUM_P : S * (NUM_P + nc)].reshape(S, nc)
    return dparams, dcoeffs, flat[S * (NUM_P + nc) :]


class _TraceFast(torch.autograd.Function):
    """8 launch arrays -> 8 final arrays; backward = trace_bwd."""

    @staticmethod
    def forward(ctx, params, coeffs, lay, spec, *rays):
        out = trace_fwd(params, spec, rays, coeffs, lay)
        ctx.save_for_backward(params, coeffs, *rays)
        ctx.spec, ctx.nc, ctx.lay = spec, coeffs.shape[1], lay
        return out

    @staticmethod
    def backward(ctx, *g):
        params, coeffs, *rays = ctx.saved_tensors
        cots = [c.contiguous() for c in g]
        din, flat = trace_bwd(params, ctx.spec, ctx.nc, rays, cots, coeffs,
                              ctx.lay)
        dparams, dcoeffs, _ = _split(flat, len(ctx.spec[0]), ctx.nc)
        return (dparams, dcoeffs, None, None) + tuple(din)


class _TraceFastField(torch.autograd.Function):
    """Pupil samples -> 8 final arrays; backward = trace_field_bwd (the
    samples get no gradient, as in the JAX package)."""

    @staticmethod
    def forward(ctx, params, coeffs, lay, aim, Px, Py, spec):
        out = trace_field_fwd(params, aim, spec, Px, Py, coeffs, lay)
        ctx.save_for_backward(params, coeffs, aim, Px, Py)
        ctx.spec, ctx.nc, ctx.lay = spec, coeffs.shape[1], lay
        return out

    @staticmethod
    def backward(ctx, *g):
        params, coeffs, aim, Px, Py = ctx.saved_tensors
        cots = [c.contiguous() for c in g]
        flat = trace_field_bwd(params, aim, ctx.spec, ctx.nc, Px, Py, cots,
                               coeffs, ctx.lay)
        dparams, dcoeffs, daim = _split(flat, len(ctx.spec[0]), ctx.nc)
        return dparams, dcoeffs, None, daim, None, None, None


def trace_fast(system, rays, wavelength, newton_iters: int = 10):
    """Fused trace of a ray bundle, monochromatic: the final state only.

    Equivalent to ``core.trace.trace(..., record=False)`` for systems that
    ``fast_supported`` covers (the Newton families by ``newton_iters`` Newton
    steps, the plain engine's by 16); its gradient runs the hand-derived
    adjoint. The bundle's dtype and device decide where it runs: the
    kernels on a CUDA device, their plain versions on the CPU."""
    spec = fast_spec(system, newton_iters=newton_iters)
    if spec is None:
        raise unsupported("trace_fast")
    dt = rays.x.dtype
    params = build_param_table(system, wavelength).to(dt)
    ray_in = [getattr(rays, k).to(dt).contiguous() for k in RAY_FIELDS]
    x, y, z, L, M, N, i, opd = _TraceFast.apply(
        params, *kernel_tables(system, dt), spec, *ray_in
    )
    return RealRays(x=x, y=y, z=z, L=L, M=M, N=N, i=i, w=rays.w, opd=opd)


def trace_fast_field(system, Hx, Hy, Px, Py, wavelength,
                     newton_iters: int = 10):
    """Fused generate+trace for one (Hx, Hy) field of an infinite-conjugate
    angle-field system: equivalent to ``generate_rays`` followed by
    ``trace_fast``, with each ray launched from its pupil sample and the
    8-scalar aim vector. The dtype is Px's when it is a tensor, else the
    stack's; the device is the stack's."""
    spec = fast_spec(system, field=True, newton_iters=newton_iters)
    if spec is None:
        raise unsupported("trace_fast_field")
    params = build_param_table(system, wavelength)
    aim = aim_vector(system, Hx, Hy)
    dt = Px.dtype if torch.is_tensor(Px) else params.dtype
    params, aim = params.to(dt), aim.to(dt)
    Px = torch.as_tensor(Px, dtype=dt, device=params.device).contiguous()
    Py = torch.as_tensor(Py, dtype=dt, device=params.device).contiguous()
    x, y, z, L, M, N, i, opd = _TraceFastField.apply(
        params, *kernel_tables(system, dt), aim, Px, Py, spec
    )
    w = torch.zeros_like(x) + scalar_like(wavelength, x)
    return RealRays(x=x, y=y, z=z, L=L, M=M, N=N, i=i, w=w, opd=opd)


class _TraceFastPoly(torch.autograd.Function):
    """9 launch arrays (the 8 and the wavelengths) -> 8 final arrays;
    backward = trace_bwd_poly (the wavelengths get a zero cotangent, as in
    the JAX package, which treats them as sampling data)."""

    @staticmethod
    def forward(ctx, params, coeffs, lay, mats, spec, *rays):
        out = trace_fwd_poly(params, mats, spec, rays, coeffs, lay)
        ctx.save_for_backward(params, coeffs, mats, *rays)
        ctx.spec, ctx.nc, ctx.lay = spec, coeffs.shape[1], lay
        return out

    @staticmethod
    def backward(ctx, *g):
        params, coeffs, mats, *rays = ctx.saved_tensors
        cots = [c.contiguous() for c in g]
        din, flat = trace_bwd_poly(params, mats, ctx.spec, ctx.nc, rays, cots,
                                   coeffs, ctx.lay)
        S = len(ctx.spec[0])
        dparams, dcoeffs, dmats = _split(flat, S, ctx.nc)
        return ((dparams, dcoeffs, None, dmats.reshape(S, -1), None)
                + tuple(din) + (torch.zeros_like(rays[8]),))


def build_poly_table(system):
    """The (S, NUM_P) param table of a polychromatic trace
    (``_poly_param_table`` of the JAX package): the index and absorption
    columns are unused, as the indices come per ray from the formulas."""
    stack = system.stack
    zero = torch.zeros_like(stack.radius)
    ap_max, ap_min = _aperture_columns(system)
    return torch.stack(
        [
            stack.radius, stack.conic, positions(stack) + stack.dz, zero,
            ap_max, zero, stack.dx, stack.dy, stack.rx, stack.ry, stack.rz,
            stack.geo_p1, stack.geo_p2, ap_min, zero,
        ],
        dim=1,
    )


def trace_fast_poly(system, rays, newton_iters: int = 10):
    """Fused trace with a wavelength per ray (``rays.w``, um): the final
    state only, differentiable with respect to every stack leaf, the
    dispersion coefficients ``mat_coeffs`` included.

    Each surface's index is evaluated per ray from its dispersion formula
    and coefficient row, in one launch for any mix of wavelengths. As in
    the JAX package, the trace applies no absorption (whatever the
    system's k data) and passes no cotangent to the wavelengths. The
    bundle's dtype and device decide where it runs: the kernels
    (trace_fwd_poly, trace_bwd_poly) on a CUDA device, their plain versions
    on the CPU. ``newton_iters`` is the Newton families' step count."""
    spec = poly_spec(system, newton_iters)
    if spec is None:
        raise unsupported("trace_fast_poly (no tabulated material, no grating)")
    dt = rays.x.dtype
    params = build_poly_table(system).to(dt)
    mats = system.stack.mat_coeffs.to(dt)
    if mats.shape[1] == 0:
        mats = mats.new_zeros((mats.shape[0], 1))
    ray_in = [getattr(rays, k).to(dt).contiguous()
              for k in RAY_FIELDS + ("w",)]
    x, y, z, L, M, N, i, opd = _TraceFastPoly.apply(
        params, *kernel_tables(system, dt), mats.contiguous(), spec, *ray_in
    )
    return RealRays(x=x, y=y, z=z, L=L, M=M, N=N, i=i, w=rays.w, opd=opd)
