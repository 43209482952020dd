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
absorption and the aperture clip are not traced: as in the JAX package,
every in-range ray counts in the statistics whatever its intensity.
"""

from __future__ import annotations

import numpy as np
import torch

from optiland_torch import config
from optiland_torch.core import geometry as geom
from optiland_torch.core import paraxial, raygen
from optiland_torch.core.system import (
    k_all, n_all, positions, scalar_like, static_tensor,
)

# param table columns (the JAX package's layout)
(
    P_RADIUS, P_CONIC, P_POS, P_NPOST, P_APMAX, P_KPRE,
    P_DX, P_DY, P_RX, P_RY, P_RZ, P_G1, P_G2, P_APMIN,
    P_MLAM,  # m * wavelength for grating surfaces (0 elsewhere)
) = range(15)
NUM_P = 15

N_AIM = 8
A_X0, A_Y0, A_Z0, A_L, A_M, A_N, A_SX, A_SY = range(N_AIM)

# Columns of the param table that the merit's gradient reaches, in the
# order the backward kernel accumulates them per surface. The tilt columns
# carry the derivative at zero tilt (the kernels trace untilted systems).
GRAD_COLS = (P_RADIUS, P_CONIC, P_POS, P_NPOST, P_DX, P_DY, P_RX, P_RY, P_RZ)

# Unit of ``sub_offset``: the JAX package's PRNG sub-block (32 x 128 rays),
# so a shard's offset means the same rays in both packages.
SUB_RAYS = 4096

# Launch shapes of the kernels (csrc/fused_trace.cu holds the same values).
FWD_BLOCK = 256  # rays per block, one Chan row each
BWD_BLOCK = 128
BWD_MAX_BLOCKS = 1056  # fixed grid of the backward's grid-stride loop
MAX_SURF = 16  # bound of the backward's per-ray surface-state array

# Launch counts of the three kernels; each wrapper adds one where it
# launches its kernel and nowhere else (merit_bwd counts its partial-row
# launch together with the fixed-order reduction launch that follows it).
LAUNCHES = {"prng_disk": 0, "merit_fwd": 0, "merit_bwd": 0}


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


def _spec_of(system):
    """The static kernel spec: (geometry codes, reflective flags), the part
    of the JAX package's spec that the merit kernels read. Its other
    entries (tilts, geometry extras, absorption, annular apertures,
    gratings, polychromatic formulas) describe families that
    ``fused_supported`` refuses until a later slice ports them."""
    cfg = system.cfg
    return tuple(cfg.geom_codes), tuple(cfg.reflective)


def fused_supported(system) -> bool:
    """True when the fused merit kernels cover this system: PLANE and
    STANDARD surfaces, no tilts, no aperture objects, interactions,
    coatings, BSDFs or polarization, an infinite-conjugate angle field, and
    at most MAX_SURF surfaces. The other families (tilts, Newton-sag
    geometries, gratings, annular apertures, NURBS) are kernel K6, ported in
    a later slice."""
    cfg = system.cfg

    def all_none(vals):
        return vals is None or all(v is None for v in vals)

    return (
        all(c in geom.SUPPORTED_CODES for c in cfg.geom_codes)
        and not any(_tilt_mask(system))
        and all_none(cfg.apertures)
        and all_none(cfg.interactions)
        and all_none(cfg.coatings)
        and all_none(cfg.bsdfs)
        and all_none(cfg.geom_aux)
        and not cfg.polarized
        and cfg.field_type == "angle"
        and bool(cfg.obj_infinite)
        and not cfg.obj_telecentric
        and cfg.num_surfaces <= MAX_SURF
    )


# ---------------------------------------------------------------------------
# Plain differentiable launch side: param table and aim vector
# ---------------------------------------------------------------------------


def _aperture_columns(system):
    """(ap_max, ap_min) per surface. Aperture objects (which override the
    stack's circular semi-aperture in the JAX package) come in a later
    slice."""
    stack, cfg = system.stack, system.cfg
    if cfg.apertures is not None and any(a is not None for a in cfg.apertures):
        raise NotImplementedError(
            "physical aperture objects are ported in a later slice"
        )
    return stack.ap_max, torch.zeros_like(stack.ap_max)


def build_param_table(system, wavelength):
    """The (S, NUM_P) scalar table for a monochromatic trace (plain torch,
    differentiable with respect to every stack leaf)."""
    stack, cfg = system.stack, system.cfg
    S = cfg.num_surfaces
    if cfg.interactions is not None and any(
        i is not None for i in cfg.interactions
    ):
        raise NotImplementedError(
            "surface interactions (gratings, thin lenses, phase) are ported "
            "in a later slice"
        )
    wl = scalar_like(wavelength, stack.radius)
    n = n_all(stack, cfg, wl)
    pos = positions(stack)
    # k of the medium before each surface (material_post of s - 1), folded
    # with 1/wavelength; row 0 never applies absorption
    k_pre = torch.cat([wl.new_zeros(1), k_all(stack, wl)[: S - 1] / wl])
    ap_max, ap_min = _aperture_columns(system)
    mlam = torch.zeros_like(stack.radius)
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


def _launch_from_pupil(aim, Px, Py):
    x = Px * aim[A_SX] + aim[A_X0]
    y = Py * aim[A_SY] + aim[A_Y0]
    z = torch.zeros_like(Px) + aim[A_Z0]
    L = torch.zeros_like(Px) + aim[A_L]
    M = torch.zeros_like(Px) + aim[A_M]
    N = torch.zeros_like(Px) + aim[A_N]
    return x, y, z, L, M, N


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


def _check_dtype(dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the fused kernels take float32 or float64, not {dtype}")


def prng_disk(seed, num_rays, offset=0, dtype=torch.float64, device="cuda",
              with_u=False):
    """Unit-disk pupil samples of rays offset .. offset + num_rays - 1.

    On a CUDA device the prng_disk kernel writes them; on the CPU the plain
    version does. With ``with_u`` the raw uniforms (u1, u2) come too."""
    device = torch.device(device)
    _check_dtype(dtype)
    if device.type == "cpu":
        return prng_disk_plain(seed, num_rays, offset, dtype, device, with_u)
    if device.type != "cuda":
        raise ValueError(f"prng_disk runs on 'cuda' or 'cpu', not {device}")
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


def _rotate_x(y, z, M, N, rx):
    c, s = torch.cos(rx), torch.sin(rx)
    return y * c - z * s, y * s + z * c, M * c - N * s, M * s + N * c


def _rotate_y(x, z, L, N, ry):
    c, s = torch.cos(ry), torch.sin(ry)
    return x * c + z * s, -x * s + z * c, L * c + N * s, -L * s + N * c


def _rotate_z(x, y, L, M, rz):
    c, s = torch.cos(rz), torch.sin(rz)
    return x * c - y * s, x * s + y * c, L * c - M * s, L * s + M * c


def _rot_local(x, y, z, L, M, N, rx, ry, rz):
    """Localize rotation R_x(-rx) R_y(-ry) R_z(-rz) of positions and
    directions (the JAX package's order)."""
    x, y, L, M = _rotate_z(x, y, L, M, -rz)
    x, z, L, N = _rotate_y(x, z, L, N, -ry)
    y, z, M, N = _rotate_x(y, z, M, N, -rx)
    return x, y, z, L, M, N


def _rot_global(x, y, z, L, M, N, rx, ry, rz):
    y, z, M, N = _rotate_x(y, z, M, N, rx)
    x, z, L, N = _rotate_y(x, z, L, N, ry)
    x, y, L, M = _rotate_z(x, y, L, M, rz)
    return x, y, z, L, M, N


def _step_plain(code, refl, p, n_pre, st):
    """One surface step on per-ray tensors (the PLANE/STANDARD branch of the
    JAX package's ``_step_tile`` without intensity, OPD and clip).

    The tilt rotations run as in the JAX package under ``jax.grad``, where
    traced tilts keep the rotation code: at the zero tilts that the kernels
    take they are exact identities, and autograd through them gives the
    tilt derivatives that the hand adjoint reproduces."""
    x, y, z, L, M, N = st
    radius, conic, pos = p[P_RADIUS], p[P_CONIC], p[P_POS]
    rot = (p[P_RX], p[P_RY], p[P_RZ])
    x = x - p[P_DX]
    y = y - p[P_DY]
    zl = z - pos
    x, y, zl, L, M, N = _rot_local(x, y, zl, L, M, N, *rot)
    t = geom.distance_static(code, radius, conic, x, y, zl, L, M, N)
    x = x + t * L
    y = y + t * M
    zl = zl + t * N
    nx, ny, nz = geom.surface_normal_static(code, radius, conic, None, x, y)
    dot = L * nx + M * ny + N * nz
    sgn = torch.sign(dot)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn
    adot = torch.abs(dot)
    if refl:
        L = L - 2 * adot * nx
        M = M - 2 * adot * ny
        N = N - 2 * adot * nz
        n_next = n_pre
    else:
        n_post = p[P_NPOST]
        u = n_pre / n_post
        root = torch.sqrt(1 - u * u * (1 - adot * adot))
        L = u * L + nx * (root - u * adot)
        M = u * M + ny * (root - u * adot)
        N = u * N + nz * (root - u * adot)
        n_next = n_post
    x, y, zl, L, M, N = _rot_global(x, y, zl, L, M, N, *rot)
    x = x + p[P_DX]
    y = y + p[P_DY]
    return (x, y, zl + pos, L, M, N), n_next


def trace_xy_plain(params, aim, spec, Px, Py, keep=False):
    """Final (x, y) of every ray; with ``keep`` also the per-surface input
    states (x, y, z, L, M, N, n_pre) that the adjoint replays."""
    codes, refl = spec[0], spec[1]
    st = _launch_from_pupil(aim, Px, Py)
    n_pre = params[0, P_NPOST]
    states = []
    for s in range(1, len(codes)):
        if keep:
            states.append((st, n_pre))
        st, n_pre = _step_plain(codes[s], refl[s], params[s], n_pre, st)
    return (st[0], st[1], states) if keep else (st[0], st[1])


def _pupil(R, seed, offset, Px, Py, dtype, device):
    if Px is None:
        return prng_disk_plain(seed, R, offset, dtype, device)
    return Px, Py


def merit_fwd_plain(params, aim, spec, R, seed=0, offset=0, Px=None, Py=None,
                    block=FWD_BLOCK):
    """Plain version of the merit_fwd kernel: (blocks, 5) rows of
    (mean_x, mean_y, M2x, M2y, n) about each block's own centroid."""
    Px, Py = _pupil(R, seed, offset, Px, Py, params.dtype, params.device)
    x, y = trace_xy_plain(params, aim, spec, Px, Py)
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


def _flags(spec, device):
    """(2S,) int32 device tensor: geometry codes, then reflective flags."""
    return static_tensor(spec[0] + tuple(int(r) for r in spec[1]),
                         torch.int32, device)


def _check_cuda_inputs(params, aim, spec, Px, Py):
    S = len(spec[0])
    _check_dtype(params.dtype)
    if S > MAX_SURF:
        raise ValueError(f"the merit kernels take at most {MAX_SURF} surfaces, "
                         f"got {S}")
    if any(c not in geom.SUPPORTED_CODES for c in spec[0]):
        raise NotImplementedError(
            f"geometry codes {spec[0]}: the kernels cover PLANE and STANDARD"
        )
    for name, t in (("params", params), ("aim", aim), ("Px", Px), ("Py", Py)):
        if t is None:
            continue
        if t.device != params.device or t.dtype != params.dtype:
            raise ValueError(f"{name} must be {params.dtype} on {params.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(params.shape) != (S, NUM_P) or tuple(aim.shape) != (N_AIM,):
        raise ValueError("params must be (S, NUM_P) and aim (N_AIM,)")


def merit_fwd(params, aim, spec, R, seed=0, offset=0, Px=None, Py=None):
    """(blocks, 5) per-block Chan rows of the traced spot. PRNG mode when
    ``Px`` is None. CUDA kernel on a CUDA device, plain version on the
    CPU."""
    if params.device.type == "cpu":
        return merit_fwd_plain(params, aim, spec, R, seed, offset, Px, Py)
    if params.device.type != "cuda":
        raise ValueError(f"merit_fwd runs on 'cuda' or 'cpu', not {params.device}")
    from optiland_torch.ops import _cuda

    _check_cuda_inputs(params, aim, spec, Px, Py)
    nb = -(-R // FWD_BLOCK)
    rows = torch.empty((nb, 5), dtype=params.dtype, device=params.device)
    prng = Px is None
    with torch.cuda.device(params.device):
        rc = _cuda.call(
            "merit_fwd", params.dtype, params.data_ptr(), aim.data_ptr(),
            _flags(spec, params.device).data_ptr(), len(spec[0]),
            None if prng else Px.data_ptr(), None if prng else Py.data_ptr(),
            int(R), int(seed) & ((1 << 64) - 1), int(offset), int(prng),
            rows.data_ptr(), _cuda.stream(),
        )
    _cuda.check(rc, "merit_fwd")
    LAUNCHES["merit_fwd"] += 1
    return rows


# ---------------------------------------------------------------------------
# merit_bwd: hand-derived adjoint of the traced merit (ports K3)
# ---------------------------------------------------------------------------


def _step_adjoint_plain(code, refl, p, n_pre, st, g):
    """Reverse sweep through one surface step.

    ``st`` is the step's input state (x, y, z, L, M, N), ``g`` the
    cotangents of its outputs (x, y, z, L, M, N, n_next). Returns the
    cotangents of the inputs, of n_pre, and of the nine param columns
    GRAD_COLS = (radius, conic, pos, n_post, dx, dy, rx, ry, rz), all per
    ray; the tilt cotangents are those at zero tilt, where each rotation
    contributes its generator. The CUDA kernel's reverse step is a
    line-by-line transcription of this one."""
    x, y, z, L, M, N = st
    gx, gy, gz, gL_o, gM_o, gN_o, g_nn = g
    R, k, pos = p[P_RADIUS], p[P_CONIC], p[P_POS]
    dx, dy, npost = p[P_DX], p[P_DY], p[P_NPOST]
    std = code == geom.STANDARD

    # ---- recompute the forward intermediates ----
    xl = x - dx
    yl = y - dy
    zl = z - pos
    if std:
        cu = 1.0 / R
        A = k * N**2 + L**2 + M**2 + N**2
        a = cu * A
        Bq = k * N * zl + L * xl + M * yl + N * zl
        b = 2 * (cu * Bq - N)
        Cq = k * zl**2 + xl**2 + yl**2 + zl**2
        c = cu * Cq - 2 * zl
        d = b**2 - 4 * a * c
        sqrt_d = torch.sqrt(torch.clamp(d, min=0.0))
        sqrt_d = torch.where(d < 0, float("nan"), sqrt_d)
        sg = torch.where(b >= 0, 1.0, -1.0).to(b.dtype)
        q = -0.5 * (b + sg * sqrt_d)
        a0 = a == 0
        q0 = q == 0
        t1 = torch.where(a0, float("inf"), q / torch.where(a0, 1.0, a))
        t2 = torch.where(q0, 0.0, c / torch.where(q0, 1.0, q))
        use1 = torch.abs(zl + t1 * N) <= torch.abs(zl + t2 * N)
        t = torch.where(use1, t1, t2)
    else:
        big = torch.abs(N) > 1e-14
        Ns = torch.where(big, N, 1e-14)
        t = -zl / Ns
    x1 = xl + t * L
    y1 = yl + t * M
    if std:
        r2 = x1**2 + y1**2
        qn = 1 - (1 + k) * cu**2 * r2
        rq = torch.rsqrt(qn)
        invd = cu * rq
        fx = x1 * invd
        fy = y1 * invd
        im = torch.rsqrt(fx**2 + fy**2 + 1)
        nx, ny, nz = fx * im, fy * im, -im
    else:
        nx, ny, nz = geom._normal_plane(x1)
    dot = L * nx + M * ny + N * nz
    sgn = torch.sign(dot)
    nxs, nys, nzs = nx * sgn, ny * sgn, nz * sgn
    adot = torch.abs(dot)

    # ---- globalize: x = x1 + dx, y = y1 + dy, z = z1 + pos ----
    g_dx = gx
    g_dy = gy
    g_pos = gz
    g_x1, g_y1, g_z1 = gx, gy, gz

    z1 = zl + t * N

    # ---- interact ----
    if refl:
        Lo = L - 2 * adot * nxs
        Mo = M - 2 * adot * nys
        No = N - 2 * adot * nzs
        gL, gM, gN = gL_o, gM_o, gN_o
        g_nxs = -2 * adot * gL_o
        g_nys = -2 * adot * gM_o
        g_nzs = -2 * adot * gN_o
        g_adot = -2 * (nxs * gL_o + nys * gM_o + nzs * gN_o)
        g_npre = g_nn
        g_npost = torch.zeros_like(gx)
    else:
        u = n_pre / npost
        root = torch.sqrt(1 - u * u * (1 - adot * adot))
        w = root - u * adot
        Lo = u * L + nxs * w
        Mo = u * M + nys * w
        No = u * N + nzs * w
        gL, gM, gN = u * gL_o, u * gM_o, u * gN_o
        g_nxs = w * gL_o
        g_nys = w * gM_o
        g_nzs = w * gN_o
        g_w = nxs * gL_o + nys * gM_o + nzs * gN_o
        g_u = L * gL_o + M * gM_o + N * gN_o - adot * g_w
        g_adot = -u * g_w
        g_u = g_u - g_w * u * (1 - adot * adot) / root
        g_adot = g_adot + g_w * u * u * adot / root
        g_npre = g_u / npost
        g_npost = g_nn - g_u * u / npost
    # adot = L nxs + M nys + N nzs (the sign folded into the normal)
    gL = gL + nxs * g_adot
    gM = gM + nys * g_adot
    gN = gN + nzs * g_adot
    g_nxs = g_nxs + L * g_adot
    g_nys = g_nys + M * g_adot
    g_nzs = g_nzs + N * g_adot

    g_k = torch.zeros_like(gx)
    g_cu = torch.zeros_like(gx)
    # ---- normal (STANDARD; the plane normal is constant) ----
    if std:
        g_nx, g_ny, g_nz = sgn * g_nxs, sgn * g_nys, sgn * g_nzs
        g_fx = g_nx * im
        g_fy = g_ny * im
        g_im = g_nx * fx + g_ny * fy - g_nz
        g_mg = -0.5 * g_im * im * im * im
        g_fx = g_fx + 2 * fx * g_mg
        g_fy = g_fy + 2 * fy * g_mg
        g_x1 = g_x1 + g_fx * invd
        g_y1 = g_y1 + g_fy * invd
        g_invd = g_fx * x1 + g_fy * y1
        g_cu = g_cu + g_invd * rq
        g_qn = -0.5 * g_invd * cu * rq * rq * rq
        g_k = g_k - g_qn * cu**2 * r2
        g_cu = g_cu - g_qn * (1 + k) * 2 * cu * r2
        g_r2 = -g_qn * (1 + k) * cu**2
        g_x1 = g_x1 + 2 * x1 * g_r2
        g_y1 = g_y1 + 2 * y1 * g_r2

    # ---- propagate: x1 = xl + t L, y1 = yl + t M, z1 = zl + t N ----
    g_xl, g_yl, g_zl = g_x1, g_y1, g_z1
    g_t = g_x1 * L + g_y1 * M + g_z1 * N
    gL = gL + g_x1 * t
    gM = gM + g_y1 * t
    gN = gN + g_z1 * t

    # ---- intersect ----
    if std:
        # t = q/a (root 1, a != 0) or c/q (root 2, q != 0); 0 otherwise
        ok1 = use1 & ~a0
        ok2 = ~use1 & ~q0
        a_s = torch.where(a0, 1.0, a)
        q_s = torch.where(q0, 1.0, q)
        g_q = torch.where(ok1, g_t / a_s, torch.where(ok2, -g_t * t2 / q_s, 0.0))
        g_a = torch.where(ok1, -g_t * t1 / a_s, 0.0)
        g_c = torch.where(ok2, g_t / q_s, 0.0)
        g_b = -0.5 * g_q
        g_sd = -0.5 * sg * g_q
        g_d = g_sd * 0.5 / sqrt_d
        g_b = g_b + 2 * b * g_d
        g_a = g_a - 4 * c * g_d
        g_c = g_c - 4 * a * g_d
        # a = cu A
        g_cu = g_cu + g_a * A
        g_A = g_a * cu
        g_k = g_k + g_A * N**2
        gL = gL + 2 * L * g_A
        gM = gM + 2 * M * g_A
        gN = gN + 2 * N * (k + 1) * g_A
        # b = 2 (cu B - N)
        g_cu = g_cu + 2 * g_b * Bq
        g_B = 2 * g_b * cu
        gN = gN - 2 * g_b
        g_k = g_k + g_B * N * zl
        gN = gN + g_B * (k * zl + zl)
        g_zl = g_zl + g_B * (k * N + N)
        gL = gL + g_B * xl
        g_xl = g_xl + g_B * L
        gM = gM + g_B * yl
        g_yl = g_yl + g_B * M
        # c = cu C - 2 zl
        g_cu = g_cu + g_c * Cq
        g_C = g_c * cu
        g_zl = g_zl - 2 * g_c
        g_k = g_k + g_C * zl**2
        g_xl = g_xl + 2 * xl * g_C
        g_yl = g_yl + 2 * yl * g_C
        g_zl = g_zl + 2 * zl * (k + 1) * g_C
        g_R = -g_cu * cu**2
    else:
        g_zl = g_zl - g_t / Ns
        gN = gN + torch.where(big, g_t * zl / (Ns * Ns), 0.0)
        g_R = torch.zeros_like(gx)

    # ---- tilts at zero: localize rotates by -angle, globalize by +angle;
    # each rotation's derivative is its generator acting on the state ----
    g_rx = (g_yl * zl - g_zl * yl + gM * N - gN * M
            - gy * z1 + gz * y1 - gM_o * No + gN_o * Mo)
    g_ry = (-g_xl * zl + g_zl * xl - gL * N + gN * L
            + gx * z1 - gz * x1 + gL_o * No - gN_o * Lo)
    g_rz = (g_xl * yl - g_yl * xl + gL * M - gM * L
            - gx * y1 + gy * x1 - gL_o * Mo + gM_o * Lo)

    # ---- localize: xl = x - dx, yl = y - dy, zl = z - pos ----
    g_dx = g_dx - g_xl
    g_dy = g_dy - g_yl
    g_pos = g_pos - g_zl
    g_in = (g_xl, g_yl, g_zl, gL, gM, gN)
    return g_in, g_npre, (g_R, g_k, g_pos, g_npost, g_dx, g_dy, g_rx, g_ry,
                          g_rz)


def merit_bwd_plain(params, aim, stats, spec, nc, R, seed=0, offset=0,
                    Px=None, Py=None):
    """Plain version of the merit_bwd kernel: the hand-derived reverse sweep
    in torch tensor ops, one tensor per ray quantity. Returns the flat
    gradient in the layout (S * NUM_P params, S * nc coeffs, N_AIM aim)."""
    S = len(spec[0])
    codes, refl = spec[0], spec[1]
    Px, Py = _pupil(R, seed, offset, Px, Py, params.dtype, params.device)
    with torch.no_grad():
        x, y, states = trace_xy_plain(params, aim, spec, Px, Py, keep=True)
        xbar, ybar, scale = stats[0], stats[1], stats[2]
        zero = torch.zeros_like(x)
        g = (2 * scale * (x - xbar), 2 * scale * (y - ybar),
             zero, zero, zero, zero, zero)
        dparams = torch.zeros((S, NUM_P), dtype=params.dtype,
                              device=params.device)
        for s in range(S - 1, 0, -1):
            st, n_pre = states[s - 1]
            g_in, g_npre, g6 = _step_adjoint_plain(
                codes[s], refl[s], params[s], n_pre, st, g
            )
            for col, v in zip(GRAD_COLS, g6):
                dparams[s, col] = v.sum()
            g = g_in + (g_npre,)
        gx, gy, gz, gL, gM, gN, g_n0 = g
        dparams[0, P_NPOST] = g_n0.sum()
        daim = torch.stack([
            gx.sum(), gy.sum(), gz.sum(), gL.sum(), gM.sum(), gN.sum(),
            (gx * Px).sum(), (gy * Py).sum(),
        ])
        dcoeffs = torch.zeros((S, nc), dtype=params.dtype, device=params.device)
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
              Py=None, block=None):
    """Flat merit gradient (S * NUM_P + S * nc + N_AIM) for the seed
    ``stats`` = [xbar, ybar, g / R, 0]. CUDA kernels on a CUDA device (one
    partial row per block of ``block`` rays, then a fixed-order sum of the
    rows), plain version on the CPU, where there are no blocks."""
    block = _bwd_block(block)
    if params.device.type == "cpu":
        return merit_bwd_plain(params, aim, stats, spec, nc, R, seed, offset,
                               Px, Py)
    if params.device.type != "cuda":
        raise ValueError(f"merit_bwd runs on 'cuda' or 'cpu', not {params.device}")
    from optiland_torch.ops import _cuda

    _check_cuda_inputs(params, aim, spec, Px, Py)
    S = len(spec[0])
    stats = stats.to(dtype=params.dtype).contiguous()
    ncomp = S * len(GRAD_COLS) + N_AIM
    # the grid keeps BWD_MAX_BLOCKS x BWD_BLOCK threads whatever the block
    nb = min(-(-R // block), BWD_MAX_BLOCKS * (BWD_BLOCK // block))
    partial = torch.empty((nb, ncomp), dtype=params.dtype, device=params.device)
    out = torch.zeros(S * (NUM_P + nc) + N_AIM, dtype=params.dtype,
                      device=params.device)
    prng = Px is None
    with torch.cuda.device(params.device):
        rc = _cuda.call(
            "merit_bwd", params.dtype, params.data_ptr(), aim.data_ptr(),
            stats.data_ptr(), _flags(spec, params.device).data_ptr(), S, nc,
            None if prng else Px.data_ptr(), None if prng else Py.data_ptr(),
            int(R), int(seed) & ((1 << 64) - 1), int(offset), int(prng),
            partial.data_ptr(), nb, int(block), out.data_ptr(), _cuda.stream(),
        )
    _cuda.check(rc, "merit_bwd")
    LAUNCHES["merit_bwd"] += 1
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
        spec, R, seed, offset, Px, Py, _ = problem
        rows = merit_fwd(params, aim, spec, R, seed, offset, Px, Py)
        loss, xbar, ybar = _chan_combine(rows, R)
        ctx.save_for_backward(params, aim, xbar, ybar)
        ctx.problem = problem
        ctx.nc = coeffs.shape[1]
        return loss

    @staticmethod
    def backward(ctx, gl):
        params, aim, xbar, ybar = ctx.saved_tensors
        spec, R, seed, offset, Px, Py, block = ctx.problem
        S, nc = len(spec[0]), ctx.nc
        stats = torch.stack([xbar, ybar, gl / R, 0.0 * xbar]).to(params.dtype)
        flat = merit_bwd(params, aim, stats, spec, nc, R, seed, offset, Px, Py,
                         block)
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
    backward kernel's block size in rays (a multiple of 32 up to
    BWD_BLOCK, which is the default); the samples and the result do not
    depend on it beyond rounding. ``newton_iters`` is accepted only for
    the JAX package's signature: PLANE and STANDARD surfaces intersect in
    closed form, so nothing reads it.
    """
    if not fused_supported(system):
        raise NotImplementedError(
            "spot_rms_fast_field covers PLANE/STANDARD infinite-conjugate "
            "angle-field systems without tilts, aperture objects, "
            "interactions, coatings or polarization; the other families "
            "(kernel K6) come in a later slice"
        )
    block = _bwd_block(bwd_tile)
    spec = _spec_of(system)
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
    coeffs = system.stack.coeffs
    if coeffs.shape[1] == 0:
        coeffs = coeffs.new_zeros((coeffs.shape[0], 1))
    problem = (spec, R, int(seed), 0, Px, Py, block)
    return _SpotMerit.apply(params, coeffs, aim, problem)
