"""Fused RMS-spot merit: Hopper kernels, their plain PyTorch versions, and
the op layer around them.

Counterpart of the merit part of ``optiland_tpu/ops/pallas_trace.py``. The
optimizer step of the JAX package is ``spot_rms_fast_field``: the RMS spot
size of one angle field and its gradient with respect to every surface
parameter, carried by two Pallas kernels. Here three CUDA kernels written
for sm_90a (``csrc/fused_trace.cu``) do that work on a CUDA device:

  * ``merit_fwd`` (ports ``_make_merit_fwd_kernel``): draw or read the pupil
    samples, launch each ray from the 8-scalar aim vector, trace the
    surface chain, and write one locally centred Chan row per block;
  * ``merit_bwd`` (ports ``_make_merit_bwd_kernel``): redraw and retrace
    the same samples and run the hand-derived adjoint of the chain, seeded
    with dL/dx = 2 (x - xbar) g / R; one partial row per block, then a
    second launch sums the rows in a fixed order (no float atomics);
  * ``prng_disk`` (ports ``prng_pupil_samples``): write the unit-disk
    samples that the two merit kernels draw in-kernel.

Beside each kernel sits its plain PyTorch version (``*_plain``), which the
wrapper runs when — and only when — its tensors lie on the CPU, and a
launch count in ``LAUNCHES``. On a CUDA tensor a wrapper launches its
kernel or raises; nothing falls back.

The pupil PRNG is Philox4x32-10 keyed by the seed, with the counter set to
the global ray index plus an offset, so the samples do not depend on the
block shape of either kernel: the backward pass retraces exactly the
forward pass's rays, which the exactness of the seeded gradient needs
(sum(x - xbar) = 0 over the same sample set). The JAX package's TPU PRNG
bits cannot be reproduced, so comparisons with it use explicit samples.

The merit reads only the final x and y of each ray, so intensity, OPD,
absorption and the aperture clips are not traced: as in the JAX package,
every in-range ray counts in the statistics whatever its intensity. A
surface of a Newton family (EVEN_ASPHERE, ODD_ASPHERE, POLYNOMIAL_XY,
CHEBYSHEV, TOROIDAL, BICONIC, ZERNIKE_SAG, FORBES_QBFS, FORBES_Q2D; the
last three laid out, with the layout table ``lay``) reads its row of the
coefficient table (the
Cartesian ones also P_G1 and P_G2), and the backward gives their
gradients. A grating surface (K6c) diffracts in the merit kernels' grating
build, and the backward gives its P_G1 and P_G2 gradients. A NURBS surface
(K6d) solves for its parameters on its net (its coefficient row, with the
knot table ``lay``, ``launch.kernel_tables``) in the nurbs build, and the
backward gives its net's gradient.
"""

from __future__ import annotations

import numpy as np
import torch

from optiland_torch import config
from optiland_torch.core import paraxial, raygen
from optiland_torch.core.system import (
    k_all, n_all, positions, scalar_like, static_tensor,
)
from optiland_torch.ops.launch import (
    BWD_BLOCK, FWD_BLOCK, GRAT, N_AIM, TRACE_BUILDS, build_of, bwd_grid,
    check_cuda_inputs, check_dtype, covered, device_of, device_table,
    entry_name, flags, grating_flags, kernel_tables, knot_rows, launch_from_pupil, launch_key, lay_row,
    sag_columns, sag_surfaces, unsupported, with_builds,
)
from optiland_torch.ops.step import (
    GRAD_COLS, NUM_P, P_NPOST, split_cols, step_adjoint_plain, step_plain,
)
from optiland_torch.physical_apertures import radial_only

# Unit of ``sub_offset``: the JAX package's PRNG sub-block (32 x 128 rays),
# so a shard's offset means the same rays in both packages.
SUB_RAYS = 4096

# Launch counts of the three kernels, the merit kernels per build
# (``launch.launch_key``: "", "_tilt", "_sag", "_free", "_deep",
# "_deep_free", "_aux", "_deep_aux", "_grat"); each wrapper adds one where
# it launches its kernel and nowhere else (merit_bwd counts its partial-row
# launch together with the fixed-order reduction launch that follows it).
LAUNCHES = {"prng_disk": 0,
            **with_builds(("merit_fwd", "merit_bwd"), TRACE_BUILDS + (GRAT,))}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Structure: spec, support, masks
# ---------------------------------------------------------------------------


def _tilt_mask(system):
    """Per-surface flags: True where a tilt angle is nonzero or not finite.
    It reads the tilt values, so on a card it waits for them once."""
    st = system.stack
    r = torch.stack([st.rx, st.ry, st.rz]).detach()
    return (r != 0).any(dim=0).tolist()


def _spec_of(system, newton_iters=10):
    """The static kernel spec: (geometry codes, reflective flags, tilt
    flags, grating flags, Newton iterations), the part of the JAX package's
    spec that the merit kernels read; the four flag rows go to the kernels
    (the grating row only the grating build reads). Its other entries
    (geometry extras, absorption, annular apertures, polychromatic
    formulas) the merit does not read, or describe families that
    ``fused_supported`` refuses until a later slice ports them."""
    cfg = system.cfg
    return (tuple(cfg.geom_codes), tuple(cfg.reflective),
            tuple(bool(t) for t in _tilt_mask(system)), grating_flags(cfg),
            int(newton_iters))


def _build(spec):
    return build_of(spec[0], spec[2], (), spec[3])


def fused_supported(system) -> bool:
    """True when the fused merit kernels cover this system: what
    ``launch.covered`` lists, tilted surfaces, the radial aspheres, the
    Cartesian freeforms (the aux-bearing ZERNIKE_SAG and Forbes families
    among them), NURBS surfaces, gratings and RadialAperture objects
    included. Grid sag comes in a later slice."""
    return covered(system.cfg)


# ---------------------------------------------------------------------------
# Plain differentiable launch side: param table and aim vector
# ---------------------------------------------------------------------------


def _aperture_columns(system):
    """(ap_max, ap_min) per surface: a RadialAperture's r_max and r_min
    override the stack's circular semi-aperture and 0 (the JAX package's
    ``_aperture_columns``); any other aperture object raises."""
    stack, cfg = system.stack, system.cfg
    ap_max, ap_min = stack.ap_max, torch.zeros_like(stack.ap_max)
    aps = cfg.apertures
    if aps is None or all(a is None for a in aps):
        return ap_max, ap_min
    if not radial_only(aps):
        raise NotImplementedError("physical aperture objects other than "
                                  "RadialAperture are ported in a later "
                                  "slice")
    dt, dev = ap_max.dtype, ap_max.device
    mask = static_tensor(tuple(a is not None for a in aps), torch.bool, dev)
    rmax = static_tensor(tuple(float(a.r_max) if a is not None else 0.0
                               for a in aps), dt, dev)
    rmin = static_tensor(tuple(float(a.r_min) if a is not None else 0.0
                               for a in aps), dt, dev)
    return torch.where(mask, rmax, ap_max), torch.where(mask, rmin, ap_min)


def build_param_table(system, wavelength):
    """The (S, NUM_P) scalar table for a monochromatic trace (plain torch,
    differentiable with respect to every stack leaf)."""
    stack, cfg = system.stack, system.cfg
    S = cfg.num_surfaces
    inter = cfg.interactions or (None,) * S
    if not all(i is None or g for i, g in zip(inter, grating_flags(cfg))):
        raise NotImplementedError(
            "surface interactions other than gratings (thin lenses, phase) "
            "are ported in a later slice"
        )
    wl = scalar_like(wavelength, stack.radius)
    n = n_all(stack, cfg, wl)
    pos = positions(stack)
    # k of the medium before each surface (material_post of s - 1), folded
    # with 1/wavelength; row 0 never applies absorption
    k_pre = torch.cat([wl.new_zeros(1), k_all(stack, wl)[: S - 1] / wl])
    ap_max, ap_min = _aperture_columns(system)
    # m times the wavelength on a grating's row, as a constant (the JAX
    # package forms it from float(wavelength))
    orders = static_tensor(tuple(float(i[1]) if g else 0.0 for i, g in
                                 zip(inter, grating_flags(cfg))),
                           stack.radius.dtype, stack.radius.device)
    mlam = orders * wl.detach()
    # reflective surfaces keep the incident medium
    n_eff = torch.where(static_tensor(cfg.reflective, torch.bool, n.device),
                        torch.roll(n, 1), n)
    return torch.stack(
        [
            stack.radius, stack.conic, pos + stack.dz, n_eff, ap_max,
            k_pre, stack.dx, stack.dy, stack.rx, stack.ry, stack.rz,
            stack.geo_p1, stack.geo_p2, ap_min, mlam,
        ],
        dim=1,
    )


def aim_vector(system, Hx, Hy):
    """Differentiable 8-scalar launch descriptor for one (Hx, Hy) field of an
    infinite-conjugate angle-field system."""
    Hx = scalar_like(Hx, system.stack.radius)
    Hy = scalar_like(Hy, system.stack.radius)
    vxf, vyf = raygen.get_vig_factor(system, Hx, Hy)
    vx, vy = 1.0 - vxf, 1.0 - vyf
    epl, epd = paraxial.pupil_scalars(system)
    fx, fy = system.field_x, system.field_y
    max_field = torch.max(torch.sqrt(fx**2 + fy**2))
    pos = positions(system.stack)
    offset = epd - torch.min(pos[1:-1])
    x00 = -torch.tan(torch.deg2rad(max_field * Hx)) * (offset + epl)
    y00 = -torch.tan(torch.deg2rad(max_field * Hy)) * (offset + epl)
    z0 = pos[1] - offset
    dz = epl - z0
    mag = torch.sqrt(x00**2 + y00**2 + dz**2)
    bad = mag < 1e-9
    mag = torch.where(bad, 1.0, mag)
    L = torch.where(bad, 0.0, -x00 / mag)
    M = torch.where(bad, 0.0, -y00 / mag)
    N = torch.where(bad, 1.0, dz / mag)
    return torch.stack([x00, y00, z0, L, M, N, epd / 2 * vx, epd / 2 * vy])


def _chan_combine(s, R):
    """Chan merge of per-block (mean_x, mean_y, M2x, M2y, n) rows into
    (loss, xbar, ybar), normalizing by the full ray count ``R``."""
    mx, my, m2x, m2y, n = (s[:, k] for k in range(5))
    xbar = torch.sum(n * mx) / R
    ybar = torch.sum(n * my) / R
    m2 = (
        torch.sum(m2x) + torch.sum(n * (mx - xbar) ** 2)
        + torch.sum(m2y) + torch.sum(n * (my - ybar) ** 2)
    )
    return m2 / R, xbar, ybar


# ---------------------------------------------------------------------------
# prng_disk: the pupil samples (ports prng_pupil_samples, K7)
# ---------------------------------------------------------------------------

_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_MASK32 = 0xFFFFFFFF


def _mulhilo32(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for a constant a and int64 tensor b of
    32-bit values. The 64-bit product overflows int64, so it is formed from
    16-bit limbs."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    ll = a_lo * b_lo
    mid = a_lo * b_hi + a_hi * b_lo  # < 2^33
    lo = ll + ((mid & 0xFFFF) << 16)
    hi = a_hi * b_hi + (mid >> 16) + (lo >> 32)
    return hi & _MASK32, lo & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding 32-bit words.

    ``counter`` is a 4-tuple of tensors (or ints), ``key`` a 2-tuple of
    ints; returns the 4 output words as int64 tensors."""
    dev = next((c.device for c in counter if torch.is_tensor(c)), None)
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64, device=dev)
                      for c in counter)
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = int(key[0]) & _MASK32, int(key[1]) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W0) & _MASK32
        k1 = (k1 + _PHILOX_W1) & _MASK32
    return c0, c1, c2, c3


def _seed_key(seed):
    seed = int(seed)
    if seed < 0:
        seed &= (1 << 64) - 1
    return seed & _MASK32, (seed >> 32) & _MASK32


def prng_disk_plain(seed, num_rays, offset=0, dtype=torch.float64,
                    device="cpu", with_u=False):
    """Plain version of the prng_disk kernel: unit-disk samples of rays
    offset .. offset + num_rays - 1, r = sqrt(u1), theta = 2 pi u2 with
    u = (bits >> 8) 2^-24 from Philox words 0 and 1."""
    idx = torch.arange(int(num_rays), dtype=torch.int64, device=device)
    idx = idx + int(offset)
    w0, w1, _, _ = philox4x32_10((idx & _MASK32, idx >> 32, 0, 0),
                                 _seed_key(seed))
    scale = 2.0 ** -24
    u1 = (w0 >> 8).to(dtype) * scale
    u2 = (w1 >> 8).to(dtype) * scale
    r = torch.sqrt(u1)
    th = u2 * torch.tensor(2.0 * np.pi, dtype=dtype, device=device)
    px, py = r * torch.cos(th), r * torch.sin(th)
    return (px, py, u1, u2) if with_u else (px, py)


def prng_disk(seed, num_rays, offset=0, dtype=torch.float64, device="cuda",
              with_u=False):
    """Unit-disk pupil samples of rays offset .. offset + num_rays - 1.

    On a CUDA device the prng_disk kernel writes them; on the CPU the plain
    version does. With ``with_u`` the raw uniforms (u1, u2) come too."""
    device = torch.device(device)
    check_dtype(dtype)
    if device_of(device, "prng_disk") == "cpu":
        return prng_disk_plain(seed, num_rays, offset, dtype, device, with_u)
    from optiland_torch.ops import _cuda

    R = int(num_rays)
    outs = [torch.empty(R, dtype=dtype, device=device)
            for _ in range(4 if with_u else 2)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    with torch.cuda.device(device):
        rc = _cuda.call(
            "prng_disk", dtype, int(seed) & ((1 << 64) - 1), int(offset), R,
            *ptrs, _cuda.stream(),
        )
    _cuda.check(rc, "prng_disk")
    LAUNCHES["prng_disk"] += 1
    return tuple(outs)


def prng_pupil_samples(seed, num_rays, tile=None, sub_offset=0, *,
                       dtype=None, device=None):
    """The unit-disk pupil samples that the PRNG-mode merit kernels draw.

    Feeding them back through the explicit-Px/Py path reproduces the
    PRNG-mode loss and gradients, which pins the forward/backward
    sample-regeneration contract. ``sub_offset`` counts SUB_RAYS-ray
    sub-blocks, as in the JAX package. ``dtype`` and ``device`` default to
    the configured ones. ``tile`` is accepted only for the JAX package's
    signature: the samples do not depend on any block shape, so nothing
    reads it."""
    dtype = dtype or config.dtype()
    device = device if device is not None else config.device()
    return prng_disk(seed, num_rays, int(sub_offset) * SUB_RAYS, dtype,
                     device)


# ---------------------------------------------------------------------------
# merit_fwd: trace + per-block Chan rows (ports K2)
# ---------------------------------------------------------------------------


def coef_row(coeffs, s):
    """Row s of the coefficient table, or None without one."""
    return None if coeffs is None else coeffs[s]


def trace_xy_plain(params, aim, spec, Px, Py, keep=False, coeffs=None,
                   lay=None):
    """Final (x, y) of every ray; with ``keep`` also, per surface, the
    input state (x, y, z, L, M, N), n_pre and a Newton family's stopped
    iterate (None for the others) that the adjoint replays. ``coeffs``
    is the (S, nc) coefficient table the Newton families read, ``lay``
    the layout table of its aux-bearing rows (``launch.kernel_tables``)."""
    codes, refl, _, grat, niters = spec
    st = launch_from_pupil(aim, Px, Py)
    n_pre = params[0, P_NPOST]
    states = []
    for s in range(1, len(codes)):
        st_in, n_in = st, n_pre
        st, n_pre, ext = step_plain(codes[s], refl[s], params[s], n_pre, st,
                                    extras=True, c=coef_row(coeffs, s),
                                    newton_iters=niters,
                                    lay=lay_row(lay, codes[s], s),
                                    grating=grat[s])
        if keep:
            states.append((st_in, n_in, ext[7]))
    return (st[0], st[1], states) if keep else (st[0], st[1])


def _pupil(R, seed, offset, Px, Py, dtype, device):
    if Px is None:
        return prng_disk_plain(seed, R, offset, dtype, device)
    return Px, Py


def merit_fwd_plain(params, aim, spec, R, seed=0, offset=0, Px=None, Py=None,
                    block=FWD_BLOCK, coeffs=None, lay=None):
    """Plain version of the merit_fwd kernel: (blocks, 5) rows of
    (mean_x, mean_y, M2x, M2y, n) about each block's own centroid."""
    Px, Py = _pupil(R, seed, offset, Px, Py, params.dtype, params.device)
    x, y = trace_xy_plain(params, aim, spec, Px, Py, coeffs=coeffs, lay=lay)
    nb = -(-R // block)
    pad = nb * block - R
    valid = torch.arange(nb * block, device=x.device) < R
    x = torch.nn.functional.pad(x, (0, pad)).reshape(nb, block)
    y = torch.nn.functional.pad(y, (0, pad)).reshape(nb, block)
    valid = valid.reshape(nb, block)
    n = valid.sum(dim=1).to(x.dtype)
    ntc = torch.clamp(n, min=1.0)
    mx = torch.where(valid, x, 0.0).sum(dim=1) / ntc
    my = torch.where(valid, y, 0.0).sum(dim=1) / ntc
    m2x = torch.where(valid, (x - mx[:, None]) ** 2, 0.0).sum(dim=1)
    m2y = torch.where(valid, (y - my[:, None]) ** 2, 0.0).sum(dim=1)
    return torch.stack([mx, my, m2x, m2y, n], dim=1)


def _coeffs_or_zeros(coeffs, params):
    """The kernels' coefficient table: ``coeffs``, or one zero column."""
    if coeffs is None:
        return params.new_zeros((params.shape[0], 1))
    return coeffs


def merit_fwd(params, aim, spec, R, seed=0, offset=0, Px=None, Py=None,
              coeffs=None, lay=None):
    """(blocks, 5) per-block Chan rows of the traced spot. PRNG mode when
    ``Px`` is None. CUDA kernel on a CUDA device, plain version on the
    CPU. ``coeffs`` is the (S, nc) coefficient table (None: zeros), ``lay``
    the layout table of its aux-bearing rows."""
    if device_of(params.device, "merit_fwd") == "cpu":
        return merit_fwd_plain(params, aim, spec, R, seed, offset, Px, Py,
                               coeffs=coeffs, lay=lay)
    from optiland_torch.ops import _cuda

    coeffs = _coeffs_or_zeros(coeffs, params)
    check_cuda_inputs(params, spec, (Px, Py), aim, coeffs, lay)
    nb = -(-R // FWD_BLOCK)
    rows = torch.empty((nb, 5), dtype=params.dtype, device=params.device)
    prng = Px is None
    build = _build(spec)
    table = device_table(coeffs, lay)  # held until the launch is queued
    with torch.cuda.device(params.device):
        rc = _cuda.call(
            entry_name("merit_fwd", build), params.dtype, params.data_ptr(), aim.data_ptr(),
            flags(spec[:-1], params.device).data_ptr(), len(spec[0]), build,
            table.data_ptr(), coeffs.shape[1], knot_rows(lay), spec[-1],
            None if prng else Px.data_ptr(), None if prng else Py.data_ptr(),
            int(R), int(seed) & ((1 << 64) - 1), int(offset), int(prng),
            rows.data_ptr(), _cuda.stream(),
        )
    _cuda.check(rc, "merit_fwd")
    LAUNCHES[launch_key("merit_fwd", build)] += 1
    return rows


# ---------------------------------------------------------------------------
# merit_bwd: hand-derived adjoint of the traced merit (ports K3)
# ---------------------------------------------------------------------------


def merit_bwd_plain(params, aim, stats, spec, nc, R, seed=0, offset=0,
                    Px=None, Py=None, coeffs=None, lay=None):
    """Plain version of the merit_bwd kernel: the hand-derived reverse sweep
    in torch tensor ops, one tensor per ray quantity. Returns the flat
    gradient in the layout (S * NUM_P params, S * nc coeffs, N_AIM aim)."""
    S = len(spec[0])
    codes, refl, tilted, grat, niters = spec
    Px, Py = _pupil(R, seed, offset, Px, Py, params.dtype, params.device)
    dcoeffs = torch.zeros((S, nc), dtype=params.dtype, device=params.device)
    with torch.no_grad():
        x, y, states = trace_xy_plain(params, aim, spec, Px, Py, keep=True,
                                      coeffs=coeffs, lay=lay)
        xbar, ybar, scale = stats[0], stats[1], stats[2]
        zero = torch.zeros_like(x)
        g = (2 * scale * (x - xbar), 2 * scale * (y - ybar),
             zero, zero, zero, zero, zero)
        dparams = torch.zeros((S, NUM_P), dtype=params.dtype,
                              device=params.device)
        for s in range(S - 1, 0, -1):
            st, n_pre, t_s = states[s - 1]
            g_in, g_npre, g6 = step_adjoint_plain(
                codes[s], refl[s], params[s], n_pre, st, g, tilted=tilted[s],
                c=coef_row(coeffs, s), newton_iters=niters,
                lay=lay_row(lay, codes[s], s), grating=grat[s], t_s=t_s,
            )
            pairs, coef = split_cols(codes[s], g6, GRAD_COLS, nc, grat[s])
            for col, v in pairs:
                dparams[s, col] = v.sum()
            for j, v in enumerate(coef):
                dcoeffs[s, j] = v.sum()
            g = g_in + (g_npre,)
        gx, gy, gz, gL, gM, gN, g_n0 = g
        dparams[0, P_NPOST] = g_n0.sum()
        daim = torch.stack([
            gx.sum(), gy.sum(), gz.sum(), gL.sum(), gM.sum(), gN.sum(),
            (gx * Px).sum(), (gy * Py).sum(),
        ])
    return torch.cat([dparams.reshape(-1), dcoeffs.reshape(-1), daim])


def _bwd_block(tile):
    """The backward kernel's block size in rays for ``tile`` (None gives
    BWD_BLOCK): a multiple of 32 from 32 to BWD_BLOCK."""
    block = BWD_BLOCK if tile is None else int(tile)
    if block % 32 or not 32 <= block <= BWD_BLOCK:
        raise ValueError(f"the backward block (bwd_tile) must be a multiple "
                         f"of 32 from 32 to {BWD_BLOCK} rays, got {tile}")
    return block


def merit_bwd(params, aim, stats, spec, nc, R, seed=0, offset=0, Px=None,
              Py=None, block=None, coeffs=None, lay=None):
    """Flat merit gradient (S * NUM_P + S * nc + N_AIM) for the seed
    ``stats`` = [xbar, ybar, g / R, 0]. CUDA kernels on a CUDA device (one
    partial row per block of at most ``block`` rays, then a fixed-order sum
    of the rows; ``launch.bwd_grid`` gives the shape), plain version on the
    CPU, where there are no blocks. ``coeffs`` is the (S, nc) coefficient
    table (None: zeros); the rows sum nc coefficient columns for each
    Newton-family surface only."""
    block = _bwd_block(block)
    if device_of(params.device, "merit_bwd") == "cpu":
        return merit_bwd_plain(params, aim, stats, spec, nc, R, seed, offset,
                               Px, Py, coeffs=coeffs, lay=lay)
    from optiland_torch.ops import _cuda

    coeffs = _coeffs_or_zeros(coeffs, params)
    check_cuda_inputs(params, spec, (Px, Py), aim, coeffs, lay)
    if coeffs.shape[1] != nc:
        raise ValueError("nc must be the coefficient table's width")
    S, build = len(spec[0]), _build(spec)
    stats = stats.to(dtype=params.dtype).contiguous()
    ncomp = (S * len(GRAD_COLS) + sag_columns(spec[0], nc, build, spec[3])
             + N_AIM)
    nsag = len(sag_surfaces(spec[0], build, spec[3]))
    block, nb, _ = bwd_grid("merit_bwd", "merit", S, 0, params.dtype, build,
                            int(R), params.device, block, nc, ncomp,
                            knot_rows(lay), nsag)
    partial = torch.empty((nb, ncomp), dtype=params.dtype, device=params.device)
    out = torch.zeros(S * (NUM_P + nc) + N_AIM, dtype=params.dtype,
                      device=params.device)
    prng = Px is None
    table = device_table(coeffs, lay)  # held until the launch is queued
    with torch.cuda.device(params.device):
        rc = _cuda.call(
            entry_name("merit_bwd", build), params.dtype, params.data_ptr(), aim.data_ptr(),
            stats.data_ptr(), flags(spec[:-1], params.device).data_ptr(), S,
            build, table.data_ptr(), nc, knot_rows(lay), spec[-1], nsag,
            None if prng else Px.data_ptr(), None if prng else Py.data_ptr(),
            int(R), int(seed) & ((1 << 64) - 1), int(offset), int(prng),
            partial.data_ptr(), nb, int(block), out.data_ptr(), _cuda.stream(),
        )
    _cuda.check(rc, "merit_bwd")
    LAUNCHES[launch_key("merit_bwd", build)] += 1
    return out


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


class _SpotMerit(torch.autograd.Function):
    """Loss = merit_fwd's rows merged by _chan_combine; backward =
    merit_bwd seeded from the centroid (x̄, ȳ are constants of the seed,
    which is exact because sum(x - x̄) = 0 over the same samples)."""

    @staticmethod
    def forward(ctx, params, coeffs, aim, problem):
        spec, R, seed, offset, Px, Py, _, lay = problem
        rows = merit_fwd(params, aim, spec, R, seed, offset, Px, Py,
                         coeffs=coeffs, lay=lay)
        loss, xbar, ybar = _chan_combine(rows, R)
        ctx.save_for_backward(params, coeffs, aim, xbar, ybar)
        ctx.problem = problem
        return loss

    @staticmethod
    def backward(ctx, gl):
        params, coeffs, aim, xbar, ybar = ctx.saved_tensors
        spec, R, seed, offset, Px, Py, block, lay = ctx.problem
        S, nc = len(spec[0]), coeffs.shape[1]
        stats = torch.stack([xbar, ybar, gl / R, 0.0 * xbar]).to(params.dtype)
        flat = merit_bwd(params, aim, stats, spec, nc, R, seed, offset, Px, Py,
                         block, coeffs=coeffs, lay=lay)
        dparams = flat[: S * NUM_P].reshape(S, NUM_P)
        dcoeffs = flat[S * NUM_P : S * (NUM_P + nc)].reshape(S, nc)
        daim = flat[S * (NUM_P + nc) :]
        return dparams, dcoeffs, daim, None


def spot_rms_fast_field(system, Hx, Hy, wavelength, num_rays=None, seed=0,
                        Px=None, Py=None, newton_iters: int = 10,
                        bwd_tile: int | None = None):
    """Fused RMS-spot merit (mean squared distance to the centroid) for one
    infinite-conjugate angle field, differentiable with respect to every
    stack leaf.

    Equivalent to tracing ``num_rays`` uniform-disk pupil samples and
    computing ``mean((x - mean(x))**2 + (y - mean(y))**2)``. With explicit
    ``Px/Py`` the samples are read instead of drawn by the Philox PRNG. The
    dtype and device follow the system's stack: the merit kernels run on a
    CUDA device and their plain versions on the CPU. ``bwd_tile`` is the
    largest block the backward kernel may take, in rays (a multiple of 32
    up to BWD_BLOCK, which is the default; ``launch.bwd_shape`` may take
    a smaller one where the block's shared memory needs it); the samples
    and the result do not depend on it beyond rounding. ``newton_iters`` is the Newton step
    count of the Newton families' intersection (the closed-form ones do not
    read it).
    """
    if not fused_supported(system):
        raise unsupported("spot_rms_fast_field (an infinite-conjugate angle "
                          "field)")
    block = _bwd_block(bwd_tile)
    spec = _spec_of(system, newton_iters)
    params = build_param_table(system, wavelength)
    aim = aim_vector(system, Hx, Hy)
    dt, dev = params.dtype, params.device
    if Px is None:
        if num_rays is None:
            raise ValueError("num_rays is required in PRNG mode")
        R = int(num_rays)
    else:
        Px = torch.as_tensor(Px, dtype=dt, device=dev).contiguous()
        Py = torch.as_tensor(Py, dtype=dt, device=dev).contiguous()
        R = int(Px.shape[0])
    coeffs, lay = kernel_tables(system, dt)
    problem = (spec, R, int(seed), 0, Px, Py, block, lay)
    return _SpotMerit.apply(params, coeffs, aim, problem)
