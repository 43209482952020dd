"""Huygens-Fresnel direct summation: three Hopper kernels, their plain
PyTorch versions, and the autograd Function around them.

Counterpart of ``optiland_tpu/ops/pallas_huygens.py``. The coherent field at
P image points is a sum over Q exit-pupil points,

    field_p = sum_q (pre_q + i pim_q) e^{i k R_pq} / R_pq
              * (1 + n_q . (i_p - p_q) / R_pq) / 2,

with R_pq the distance from pupil point q to image point p, n_q the pupil
normal and (pre, pim) the complex amplitude. Three CUDA kernels written for
sm_90a (``csrc/huygens.cu``) compute it and its adjoint:

  * ``huygens_fwd`` (ports ``_kernel`` / ``_pallas_field``, K10): the field,
    as two real arrays (re, im);
  * ``huygens_bwd_img`` (ports ``_bwd_img_kernel``, K11a): the gradients of
    the three image coordinates for a field cotangent (g_re, g_im);
  * ``huygens_bwd_pup`` (ports ``_bwd_pup_kernel``, K11b): the gradients of
    the eight per-pupil arrays (px, py, pz, nx, ny, nz, pre, pim).

Beside each kernel sits its plain version (``*_plain``), which the wrapper
runs when, and only when, its tensors lie on the CPU, and a launch count in
``LAUNCHES``. On a CUDA tensor a wrapper launches its kernel or raises.

The Function takes the eight derived pupil arrays; the chain from them back
to (px, py, pz, amplitude, OPD, reference radius) stays in torch outside it
(``pupil_arrays``), so autograd forms what the JAX package's ``_bwd`` forms
by hand, the gradient of the reference radius included. Its outputs are the
two real arrays, so no complex-cotangent convention enters: PyTorch passes
(dL/dRe, dL/dIm) as they are.
"""

from __future__ import annotations

import math

import torch

from optiland_torch.ops.launch import check_dtype, device_of

# Launch counts of the three kernels; each wrapper adds one where it
# launches its kernel and nowhere else (a launch of the fixed-order split
# reduction that may follow counts with it).
LAUNCHES = {"huygens_fwd": 0, "huygens_bwd_img": 0, "huygens_bwd_pup": 0}

# Launch shapes (csrc/huygens.cu holds the same values).
BLOCK = 256  # threads per block, one resident point each
TILE = 256  # streamed points per shared-memory stage
# Blocks per SM that a launch aims for when it splits the streamed range.
BLOCKS_PER_SM = 8
# Pairs per chunk of the plain versions, which form (rows, Q) intermediates.
PLAIN_PAIRS = 1 << 22


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pupil_arrays(px, py, pz, amp, opd_mm, k, Rp):
    """The eight per-pupil arrays of the sum: positions, unit normals of the
    reference sphere of radius ``Rp`` and the complex amplitude of
    ``amp`` e^{-i k opd} (``amp`` real, or complex: a component of the exit
    E-field of the vectorial PSF)."""
    ph = -k * opd_mm
    c, s = torch.cos(ph), torch.sin(ph)
    if torch.is_complex(amp):
        a, b = amp.real, amp.imag
        pre, pim = a * c - b * s, a * s + b * c
    else:
        pre, pim = amp * c, amp * s
    return px, py, pz, px / Rp, py / Rp, pz / Rp, pre, pim


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _rows(Q, chunk):
    return chunk if chunk is not None else max(1, PLAIN_PAIRS // max(Q, 1))


def _pairs(img, pup, k):
    """Per-pair quantities of image points ``img`` (3 arrays of (p,))
    against pupil points ``pup`` (8 arrays of (Q,)), each (p, Q)."""
    ix, iy, iz = (a[:, None] for a in img)
    px, py, pz, nx, ny, nz, pre, pim = (a[None, :] for a in pup)
    dx, dy, dz = ix - px, iy - py, iz - pz
    R = torch.sqrt(dx * dx + dy * dy + dz * dz)
    inv_r = 1.0 / R
    th = k * R
    c, s = torch.cos(th), torch.sin(th)
    dot = dx * nx + dy * ny + dz * nz
    obl = 0.5 * (1.0 + dot * inv_r)
    return dict(dx=dx, dy=dy, dz=dz, nx=nx, ny=ny, nz=nz, pre=pre, pim=pim,
                inv_r=inv_r, c=c, s=s, dot=dot, obl=obl,
                ac=pre * c - pim * s, bc=pre * s + pim * c)


def _pair_grads(t, g_re, g_im, k):
    """The hand-derived adjoint of one pair's term for the field cotangent
    (g_re, g_im) of its image point (each (p, 1)): the cotangent of the
    displacement (image minus pupil) and of the pupil arrays nx, ny, nz,
    pre, pim."""
    inv_r, obl, c, s = t["inv_r"], t["obl"], t["c"], t["s"]
    pre, pim, ac, bc = t["pre"], t["pim"], t["ac"], t["bc"]
    ga, gb = g_re * obl, g_im * obl
    gc = (ga * pre + gb * pim) * inv_r
    gs = (gb * pre - ga * pim) * inv_r
    g_obl = (g_re * ac + g_im * bc) * inv_r
    g_dot = 0.5 * g_obl * inv_r
    g_inv_r = ga * ac + gb * bc + 0.5 * g_obl * t["dot"]
    g_d = (k * (gs * c - gc * s) - g_inv_r * inv_r * inv_r) * inv_r
    disp = tuple(g_d * t[d] + g_dot * t[n]
                 for d, n in (("dx", "nx"), ("dy", "ny"), ("dz", "nz")))
    normals = tuple(g_dot * t[d] for d in ("dx", "dy", "dz"))
    amp = (obl * (g_re * c + g_im * s) * inv_r,
           obl * (g_im * c - g_re * s) * inv_r)
    return disp, normals, amp


def huygens_fwd_plain(img, pup, k, chunk=None):
    """Plain version of the huygens_fwd kernel: (re, im) of the field at
    the image points, over chunks of ``chunk`` image points. Differentiable
    by autograd."""
    P, Q = img[0].shape[0], pup[0].shape[0]
    rows = _rows(Q, chunk)
    re, im = [img[0].new_zeros(0)], [img[0].new_zeros(0)]
    for a in range(0, P, rows):
        t = _pairs([v[a:a + rows] for v in img], pup, k)
        re.append((t["ac"] * t["inv_r"] * t["obl"]).sum(dim=1))
        im.append((t["bc"] * t["inv_r"] * t["obl"]).sum(dim=1))
    return torch.cat(re), torch.cat(im)


def huygens_bwd_img_plain(img, pup, g_re, g_im, k, chunk=None):
    """Plain version of the huygens_bwd_img kernel: the gradients of the
    three image coordinates for the field cotangent (g_re, g_im)."""
    P, Q = img[0].shape[0], pup[0].shape[0]
    rows = _rows(Q, chunk)
    out = [[img[0].new_zeros(0)] for _ in range(3)]
    with torch.no_grad():
        for a in range(0, P, rows):
            t = _pairs([v[a:a + rows] for v in img], pup, k)
            disp, _, _ = _pair_grads(t, g_re[a:a + rows, None],
                                     g_im[a:a + rows, None], k)
            for o, d in zip(out, disp):
                o.append(d.sum(dim=1))
    return tuple(torch.cat(o) for o in out)


def huygens_bwd_pup_plain(img, pup, g_re, g_im, k, chunk=None):
    """Plain version of the huygens_bwd_pup kernel: the gradients of the
    eight pupil arrays (px, py, pz, nx, ny, nz, pre, pim) for the field
    cotangent (g_re, g_im)."""
    P, Q = img[0].shape[0], pup[0].shape[0]
    rows = _rows(Q, chunk)
    out = [pup[0].new_zeros(Q) for _ in range(8)]
    with torch.no_grad():
        for a in range(0, P, rows):
            t = _pairs([v[a:a + rows] for v in img], pup, k)
            disp, normals, amp = _pair_grads(t, g_re[a:a + rows, None],
                                             g_im[a:a + rows, None], k)
            # the pupil position enters the displacement with a minus sign
            for j, term in enumerate(tuple(-d for d in disp) + normals + amp):
                out[j] += term.sum(dim=0)
    return tuple(out)


def term_sums(img, pup, g_re, g_im, k, chunk=None):
    """For each entry of the 13 outputs of the three kernels ((re, im), the
    3 image and the 8 pupil gradients, in that order), the sums over its
    pairs of |term| + |term'| and of term^2 + term'^2, where term' is the
    pair's term with its phase k R advanced by a quarter turn. Every term
    is A cos(k R) + B sin(k R), so term' is its derivative in the phase,
    and a rounding error d of the phase moves the term by d term': these
    are the scales of the rounding error of the sums, which the checks of
    the kernels hold them to."""
    P, Q = img[0].shape[0], pup[0].shape[0]
    rows = _rows(Q, chunk)
    s1 = [img[0].new_zeros(P) for _ in range(5)] + [
        pup[0].new_zeros(Q) for _ in range(8)]
    s2 = [t.clone() for t in s1]
    with torch.no_grad():
        for a in range(0, P, rows):
            sl = slice(a, a + rows)
            t = _pairs([v[sl] for v in img], pup, k)
            # c' = cos(k R + pi/2) = -s, s' = c
            quarter = dict(t, c=-t["s"], s=t["c"], ac=-t["bc"], bc=t["ac"])
            for u in (t, quarter):
                disp, normals, amp = _pair_grads(u, g_re[sl, None],
                                                 g_im[sl, None], k)
                field = (u["ac"] * u["inv_r"] * u["obl"],
                         u["bc"] * u["inv_r"] * u["obl"])
                for j, term in enumerate(field + disp):
                    s1[j][sl] += term.abs().sum(dim=1)
                    s2[j][sl] += (term * term).sum(dim=1)
                for j, term in enumerate(disp + normals + amp):
                    s1[5 + j] += term.abs().sum(dim=0)
                    s2[5 + j] += (term * term).sum(dim=0)
    return s1, s2


def f32_bound(img, pup, k):
    """(b, k R_max 2^-24) for float32 sums over these points, R_max the
    largest distance between them: b bounds the error of one f32 term over
    its scale |term| + |term'| (``term_sums``). The phase k R carries up to
    ~3 k R 2^-24 of rounding (R, then the product with 2 / lambda), the
    other factors a few 2^-24 together."""
    d = [max(float(a.max() - b.min()), float(b.max() - a.min()))
         for a, b in zip(img, pup[:3])]
    kr = k * math.sqrt(sum(v * v for v in d)) * 2.0**-24
    return 6 * kr + 16 * 2.0**-24, kr


def error_ratios(got, ref, s1, s2, b, kr):
    """(worst, rms) over the outputs ``got`` against ``ref`` with the
    ``term_sums`` (s1, s2) of ``ref``'s inputs: the worst |got - ref| over
    b s1 at any entry, and the RMS error over the entries against
    b RMS sqrt(s2) + kr RMS |ref| (the terms' own roundings add up as the
    root of their squares, a phase error common to all terms, that of
    2 / lambda, in proportion to the sum). A zero output or a wrong phase
    misses the second by several times."""
    def rms(t):
        return float(t.square().mean().sqrt())

    worst, rms_r = 0.0, 0.0
    for a, r, u, v in zip(got, ref, s1, s2):
        err = a.double() - r.double()
        worst = max(worst, float((err.abs() / (b * u.double())
                                  .clamp_min(1e-300)).max()))
        rms_r = max(rms_r, rms(err) / max(
            b * float(v.double().mean().sqrt()) + kr * rms(r.double()),
            1e-300))
    return worst, rms_r


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def split_of(n_resident, n_streamed, target_blocks):
    """(nsplit, chunk) of a launch: one thread per resident point, the
    streamed range cut into ``nsplit`` pieces of ``chunk`` points (a
    multiple of TILE) so that about ``target_blocks`` blocks fill the card.
    With more than one piece, a second launch sums the pieces in a fixed
    order."""
    blocks = max(1, -(-n_resident // BLOCK))
    tiles = max(1, -(-n_streamed // TILE))
    nsplit = max(1, min(-(-target_blocks // blocks), tiles))
    chunk = -(-tiles // nsplit) * TILE
    return max(1, -(-n_streamed // chunk)), chunk


def _check_cuda(arrays):
    like = arrays[0]
    check_dtype(like.dtype)
    for t in arrays:
        if t.device != like.device or t.dtype != like.dtype:
            raise ValueError(f"the Huygens arrays must be {like.dtype} on "
                             f"{like.device}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError("the Huygens arrays must be flat and contiguous")


def _launch(name, img, pup, cots, k, nout, n_resident, n_streamed):
    from optiland_torch.ops import _cuda

    img, pup, cots = tuple(img), tuple(pup), tuple(cots)
    if len(img) != 3 or len(pup) != 8:
        raise ValueError("the kernels take 3 image and 8 pupil arrays")
    _check_cuda(img + pup + cots)
    P, Q = img[0].shape[0], pup[0].shape[0]
    if any(a.shape[0] != P for a in img + cots) or any(
            a.shape[0] != Q for a in pup):
        raise ValueError("the image arrays and cotangents must share one "
                         "length, the pupil arrays another")
    sms = torch.cuda.get_device_properties(img[0].device).multi_processor_count
    nsplit, chunk = split_of(n_resident, n_streamed, BLOCKS_PER_SM * sms)
    like = img[0]
    out = like.new_empty((nout, n_resident))
    partial = out if nsplit == 1 else like.new_empty((nsplit, nout,
                                                      n_resident))
    with torch.cuda.device(like.device):
        rc = _cuda.call(
            name, like.dtype, _cuda.pointers(img), _cuda.pointers(pup),
            _cuda.pointers(cots) if cots else None, P, Q, k / math.pi, k,
            chunk, nsplit, partial.data_ptr(), out.data_ptr(), _cuda.stream(),
        )
    _cuda.check(rc, name)
    LAUNCHES[name] += 1
    return out.unbind(0)


def huygens_fwd(img, pup, k):
    """(re, im) of the field at the image points: the huygens_fwd kernel on
    a CUDA device, its plain version on the CPU."""
    if device_of(img[0].device, "huygens_fwd") == "cpu":
        return huygens_fwd_plain(img, pup, k)
    P, Q = img[0].shape[0], pup[0].shape[0]
    return _launch("huygens_fwd", img, pup, (), k, 2, P, Q)


def huygens_bwd_img(img, pup, g_re, g_im, k):
    """Gradients of the three image coordinates: the huygens_bwd_img kernel
    on a CUDA device, its plain version on the CPU."""
    if device_of(img[0].device, "huygens_bwd_img") == "cpu":
        return huygens_bwd_img_plain(img, pup, g_re, g_im, k)
    P, Q = img[0].shape[0], pup[0].shape[0]
    return _launch("huygens_bwd_img", img, pup, (g_re, g_im), k, 3, P, Q)


def huygens_bwd_pup(img, pup, g_re, g_im, k):
    """Gradients of the eight pupil arrays: the huygens_bwd_pup kernel on a
    CUDA device, its plain version on the CPU."""
    if device_of(img[0].device, "huygens_bwd_pup") == "cpu":
        return huygens_bwd_pup_plain(img, pup, g_re, g_im, k)
    P, Q = img[0].shape[0], pup[0].shape[0]
    return _launch("huygens_bwd_pup", img, pup, (g_re, g_im), k, 8, Q, P)


# ---------------------------------------------------------------------------
# autograd Function and entry
# ---------------------------------------------------------------------------


class _HuygensField(torch.autograd.Function):
    """(3 image arrays, 8 pupil arrays, k) -> (re, im); the backward runs
    huygens_bwd_img where an image array needs a gradient and
    huygens_bwd_pup where a pupil array does."""

    @staticmethod
    def forward(ctx, ix, iy, iz, px, py, pz, nx, ny, nz, pre, pim, k):
        img, pup = (ix, iy, iz), (px, py, pz, nx, ny, nz, pre, pim)
        ctx.save_for_backward(*img, *pup)
        ctx.k = k
        return huygens_fwd(img, pup, k)

    @staticmethod
    def backward(ctx, g_re, g_im):
        arrays = ctx.saved_tensors
        img, pup = arrays[:3], arrays[3:]
        g_re, g_im = g_re.contiguous(), g_im.contiguous()
        need = ctx.needs_input_grad
        dimg, dpup = (None,) * 3, (None,) * 8
        if any(need[:3]):
            dimg = huygens_bwd_img(img, pup, g_re, g_im, ctx.k)
        if any(need[3:11]):
            dpup = huygens_bwd_pup(img, pup, g_re, g_im, ctx.k)
        return (*dimg, *dpup, None)


def huygens_field_fast(image_x, image_y, image_z, pupil_x, pupil_y, pupil_z,
                       pupil_amp, pupil_opd_mm, wavelength_mm, Rp):
    """Complex field at flat image points (P,) from flat pupil arrays (Q,):
    the counterpart of ``huygens_field_pallas``. The kernels run on a CUDA
    device (K10 forward, K11a/K11b backward), their plain versions with the
    hand adjoints on the CPU. ``wavelength_mm`` is a number."""
    k = 2.0 * math.pi / float(wavelength_mm)
    pup = pupil_arrays(pupil_x, pupil_y, pupil_z, pupil_amp, pupil_opd_mm, k,
                       Rp)
    arrays = [a.contiguous() for a in (image_x, image_y, image_z, *pup)]
    re, im = _HuygensField.apply(*arrays, k)
    return torch.complex(re, im)
