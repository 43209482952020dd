"""Polarized ray trace: two Hopper kernels, their plain PyTorch versions, and
the op layer around them.

Counterpart of ``optiland_tpu/ops/pallas_pol.py``. The trace carries each
ray's state and its 3x3 complex polarization matrix p through the surface
chain; at every surface p <- O_out J O_in p, where (s, p0, p1) is the local
basis bridging the pre- and post-interaction directions k0 and k1, O_in has
the rows (s, p0, k0), O_out the columns (s, p1, k1), and J is the coating's
Jones matrix in the (s, p, k) frame:

    J = [[j00, j01, 0], [j10, j11, 0], [0, 0, j22]].

The coatings the kernels cover, per surface (a static kind):

  * none: J = 1 (a pure basis rotation);
  * simple: the intensity factor (T, or R on a mirror), J = 1;
  * fresnel: the bare-interface amplitude coefficients, with the complex
    root of n^2 - sin^2 as a real pair, so total internal reflection keeps
    its phase;
  * polarizer, retarder: the 2x2 block of the global axis projected on the
    (s, p) frame;
  * tmm: a dielectric thin-film stack by the real-index transfer matrix,
    for stacks without absorption and without evanescent layers
    (``_tmm_eligible``, judged at the trace wavelength).

Two CUDA kernels written for sm_90a (``csrc/pol_trace.cu``) do the work on a
CUDA device, each in two modes:

  * ``pol_fwd`` (ports ``_make_fwd_kernel_pol`` / ``_pallas_fwd_pol``, K8):
    8 launch arrays in; 26 out (the 8 ray arrays, then the 9 real and the 9
    imaginary parts of p, row-major), or in the intensity mode 8, with the
    intensity replaced by the polarized exit intensity of the launch
    intensity and directions;
  * ``pol_bwd`` (ports ``_make_bwd_kernel_pol`` / ``_pallas_bwd_pol``, K9):
    the hand-derived adjoint for the output cotangents: the 8 per-ray input
    cotangents, and one partial row per block of the summed parameter and
    coat-table gradients, which a second launch sums in a fixed order.

Beside them sit their plain versions, ``pol_fwd_plain`` and
``pol_bwd_plain``, in the kernels' real-pair arithmetic; a wrapper runs the
plain version when, and only when, its tensors lie on the CPU, and counts
its launches in ``LAUNCHES``. ``pol_bwd_plain`` is the adjoint by hand: the
CUDA kernel transcribes it.

The step is ``ops/step.py``'s full form with its extras, every family of
``launch.covered`` (a NURBS surface in the kernels' nurbs build, its net's
knot table as ``lay``) but gratings, which the JAX package's polarized
kernels take neither.

The kernel interface stays real; ``trace_fast_pol`` assembles the complex
p = re + i im in torch, outside the autograd Function, so torch's complex
autograd applies its own convention to it. As in the JAX package, the coat
table is built from the coatings' constants, so its gradient reaches no
stack leaf.
"""

from __future__ import annotations

import functools
import math

import torch

from optiland_torch.coatings import (
    FresnelCoating,
    PolarizerCoating,
    RetarderCoating,
    SimpleCoating,
    ThinFilmCoating,
)
from optiland_torch.core.rays import RealRays
from optiland_torch.core.system import static_tensor
from optiland_torch.ops.fast_trace import (
    RAY_FIELDS, _bwd_blocks, _check_nc, _masks, _split,
)
from optiland_torch.ops.fused_trace import (
    _coeffs_or_zeros, build_param_table, coef_row,
)
from optiland_torch.ops.launch import (
    build_of, check_cuda_inputs, covered, device_of, device_table,
    entry_name, flags, inner_flags, kernel_tables, launch_key, lay_row,
    sag_columns, sag_surfaces, unsupported, with_builds,
)
from optiland_torch.ops.step import (
    FULL_GRAD_COLS, NUM_P, P_NPOST, split_cols, step_adjoint_plain,
    step_plain,
)
from optiland_torch.polarization import basis_states

# Launch counts of the kernels, per mode and build (``launch.launch_key``);
# each wrapper adds one where it launches its kernel and nowhere else (a
# backward counts its partial-row launch together with the fixed-order
# reduction launch that follows it).
LAUNCHES = with_builds(("pol_fwd", "pol_bwd", "pol_fwd_intensity",
                        "pol_bwd_intensity"))

# Per-surface coat kinds (the kernels' fourth flag row; csrc/pol_trace.cu
# holds the same values)
NONE, SIMPLE, FRESNEL, POLARIZER, RETARDER, TMM = range(6)
_KIND_CODES = {"none": NONE, "simple": SIMPLE, "fresnel": FRESNEL,
               "polarizer": POLARIZER, "retarder": RETARDER}
# Coat-table columns: fresnel (n1, n2, 0, 0), simple (T, R, 0, 0),
# polarizer (ax, ay, az, 0), retarder (d, ax, ay, az); a tmm stack of L
# layers widens the table to 2 + 2L columns:
# (n0, ns, n_1, 2 pi d_1 / lambda, ..., n_L, 2 pi d_L / lambda)
N_COAT = 4
MAX_LAYERS = 15  # layers of a tmm stack the kernels take (shared-memory rows)
N_POL = 26  # outputs of the full mode


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Structure: coat kinds, support, coat table, polarization states
# ---------------------------------------------------------------------------


def _n_of(material, wl):
    return float(material.n(wl))


def _tmm_eligible(stack, wavelength) -> bool:
    """True when the stack's TMM reduces to the kernels' real-index form at
    ``wavelength``: every medium free of absorption, and min(n_layer,
    n_substrate) >= n_incident (no evanescent wave in any layer at a real
    incidence). Judged at the trace wavelength: a dispersive stack that
    absorbs there runs the plain engine."""
    media = ([stack.incident_material, stack.substrate_material]
             + [layer.material for layer in stack.layers])
    if any(abs(float(m.k(wavelength))) > 1e-12 for m in media):
        return False
    ns = [_n_of(m, wavelength) for m in media]
    return all(n >= ns[0] * 1.0001 for n in ns[1:])


@functools.lru_cache(maxsize=256)
def _kinds_of(coatings, S, wavelength):
    kinds = []
    for c in coatings or (None,) * S:
        if c is None:
            kinds.append("none")
        elif type(c) is SimpleCoating:
            kinds.append("simple")
        elif type(c) is FresnelCoating:
            kinds.append("fresnel")
        elif type(c) is PolarizerCoating:
            kinds.append("polarizer")
        elif type(c) is RetarderCoating:
            kinds.append("retarder")
        elif type(c) is ThinFilmCoating and _tmm_eligible(c.stack, wavelength):
            kinds.append(("tmm", len(c.stack.layers)))
        else:
            kinds.append("unsupported")
    return tuple(kinds)


def _coat_kinds(system, wavelength):
    """Per-surface coat kinds at the trace wavelength: "none", "simple",
    "fresnel", "polarizer", "retarder", ("tmm", layers) or "unsupported"
    (a coating the JAX package's kernels do not take either)."""
    cfg = system.cfg
    return _kinds_of(cfg.coatings, cfg.num_surfaces, float(wavelength))


def _ncoat_of(kinds):
    """Coat-table width of a kinds tuple."""
    return max([N_COAT] + [2 + 2 * k[1] for k in kinds
                           if isinstance(k, tuple)])


def kernel_eligible(system, wavelength) -> bool:
    """True when the JAX package's polarized kernels would take this
    system's coatings at ``wavelength`` (no "unsupported" kind)."""
    return "unsupported" not in _coat_kinds(system, wavelength)


def pol_spec(system, wavelength, newton_iters=10):
    """The kernels' static spec (geometry codes, reflective flags, absorb
    flags, coat kinds, tmm layer counts, tilt flags: the kernels' six flag
    rows; then annular flags and Newton iterations) when they cover this
    system at ``wavelength``, else None: the structure of
    ``fast_trace.fast_spec`` with coatings and polarization, coatings that
    are kernel-eligible and tmm stacks of at most MAX_LAYERS layers."""
    cfg = system.cfg
    if not covered(cfg, field=False, coated=True):
        return None
    kinds = _coat_kinds(system, wavelength)
    if "unsupported" in kinds or any(
            isinstance(k, tuple) and k[1] > MAX_LAYERS for k in kinds):
        return None
    tilted, absorbs = _masks(system)
    codes = tuple(TMM if isinstance(k, tuple) else _KIND_CODES[k]
                  for k in kinds)
    layers = tuple(k[1] if isinstance(k, tuple) else 0 for k in kinds)
    return (tuple(cfg.geom_codes), tuple(cfg.reflective), absorbs, codes,
            layers, tuple(bool(t) for t in tilted), inner_flags(cfg),
            int(newton_iters))


def pol_supported(system, wavelength) -> bool:
    """True when ``trace_fast_pol`` covers this system at ``wavelength``
    (counterpart of ``pallas_pol_supported``, limited to what the port's
    kernels cover)."""
    return pol_spec(system, wavelength) is not None


@functools.lru_cache(maxsize=256)
def _coat_rows(coatings, S, wavelength):
    kinds = _kinds_of(coatings, S, wavelength)
    ncoat = _ncoat_of(kinds)
    rows = []
    for c, kind in zip(coatings or (None,) * S, kinds):
        if kind == "fresnel":
            row = [_n_of(c.material_pre, wavelength),
                   _n_of(c.material_post, wavelength)]
        elif kind == "simple":
            row = [float(c.transmittance), float(c.reflectance)]
        elif kind == "polarizer":
            row = [float(v) for v in c._jones.axis]
        elif kind == "retarder":
            row = [float(c._jones.retardance)] + [float(v)
                                                  for v in c._jones.axis]
        elif isinstance(kind, tuple):
            st = c.stack
            row = [_n_of(st.incident_material, wavelength),
                   _n_of(st.substrate_material, wavelength)]
            for layer in st.layers:
                # 2 pi / lambda folded into the thickness column
                row += [_n_of(layer.material, wavelength),
                        2.0 * math.pi * float(layer.thickness_um)
                        / wavelength]
        else:
            row = []
        rows.append(row + [0.0] * (ncoat - len(row)))
    return ncoat, tuple(v for r in rows for v in r)


def build_coat_table(system, wavelength, dtype, device):
    """(S, ncoat) coat table (column layouts: see N_COAT), copied to the
    device once per system, wavelength, dtype and device."""
    S = system.cfg.num_surfaces
    ncoat, vals = _coat_rows(system.cfg.coatings, S, float(wavelength))
    return static_tensor(vals, dtype, device).reshape(S, ncoat)


def pol_states(state):
    """The kernels' polarization states: for each incoherent state (one
    when ``state`` is polarized, two orthogonal linear ones otherwise) the
    launch field's (s, p) coefficients (Ex cos phx, Ex sin phx, Ey cos phy,
    Ey sin phy)."""
    return tuple((st.Ex * math.cos(st.phase_x), st.Ex * math.sin(st.phase_x),
                  st.Ey * math.cos(st.phase_y), st.Ey * math.sin(st.phase_y))
                 for st in basis_states(state))


# ---------------------------------------------------------------------------
# Real-pair algebra of the plain versions (the kernels' arithmetic)
# ---------------------------------------------------------------------------


def _cmul(a, b):
    return a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0]


def _cjmul(a, b):
    """conj(a) b."""
    return a[0] * b[0] + a[1] * b[1], a[0] * b[1] - a[1] * b[0]


def _cdiv(a, b):
    den = b[0] * b[0] + b[1] * b[1]
    return (a[0] * b[0] + a[1] * b[1]) / den, (a[1] * b[0] - a[0] * b[1]) / den


def _cadd(a, b):
    return a[0] + b[0], a[1] + b[1]


def _csub(a, b):
    return a[0] - b[0], a[1] - b[1]


def _div_adjoint(g, a, b, q):
    """Cotangents of a and b for q = a / b and the cotangent g of q (pairs):
    g / conj(b) and -g conj(q) / conj(b)."""
    bc = (b[0], -b[1])
    ga = _cdiv(g, bc)
    gb = _cdiv(_cmul(g, (q[0], -q[1])), bc)
    return ga, (-gb[0], -gb[1])


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _vadd(a, b):
    return tuple(u + v for u, v in zip(a, b))


def _vscale(a, c):
    return tuple(u * c for u in a)


def _mm(A, B):
    """Batched 3x3 products of (R, 3, 3) tensors, as elementwise sums."""
    return (A.unsqueeze(-1) * B.unsqueeze(-3)).sum(-2)


def _mat(rows):
    """(R, 3, 3) from three row vectors of three (R,) tensors."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _rows(A):
    return tuple(tuple(A[:, i, j] for j in range(3)) for i in range(3))


# ---------------------------------------------------------------------------
# Basis, Jones matrices, p update, exit intensity: forward and adjoint
# ---------------------------------------------------------------------------


def _basis(k0, k1):
    """(s, p0, p1) bridging k0 and k1 (3-tuples of (R,) tensors), and what
    the adjoint needs: the raw s before its normalization, its norm, the
    fallback flags and the fallback p."""
    s = _cross(k0, k1)
    deg = torch.sqrt(_dot(s, s)) < 1e-12
    zero = torch.zeros_like(k0[0])
    pf1 = (zero, k0[2], -k0[1])  # k0 x xhat
    use2 = torch.sqrt(pf1[1] * pf1[1] + pf1[2] * pf1[2]) < 1e-12
    pf2 = (-k0[2], zero, k0[0])  # k0 x yhat
    pfb = tuple(torch.where(use2, b, a) for a, b in zip(pf1, pf2))
    sfb = _cross(pfb, k0)
    s_raw = tuple(torch.where(deg, b, a) for a, b in zip(s, sfb))
    mag = torch.sqrt(_dot(s_raw, s_raw))
    s = tuple(c / mag for c in s_raw)
    return (s, _cross(k0, s), _cross(k1, s)), (mag, deg, use2, pfb)


def _basis_adjoint(k0, k1, basis, aux, g_s, g_p0, g_p1):
    """Cotangents of k0 and k1 from those of (s, p0, p1)."""
    s, _, _ = basis
    mag, deg, use2, pfb = aux
    # p0 = k0 x s, p1 = k1 x s
    g_k0 = _cross(s, g_p0)
    g_k1 = _cross(s, g_p1)
    g_s = _vadd(_vadd(g_s, _cross(g_p0, k0)), _cross(g_p1, k1))
    # s = s_raw / |s_raw|
    sg = _dot(s, g_s)
    g_raw = tuple((g - c * sg) / mag for g, c in zip(g_s, s))
    # s_raw = k0 x k1, or pfb x k0 on the fallback, pfb = k0 x e
    gk0_n = _cross(k1, g_raw)
    gk1_n = _cross(g_raw, k0)
    g_pfb = _cross(k0, g_raw)
    gk0_f = _cross(g_raw, pfb)
    e_y = use2  # e = yhat where k0 x xhat vanishes, else xhat
    # k0 x e: for e = xhat (0, k0z, -k0y); for e = yhat (-k0z, 0, k0x)
    gk0_f = (gk0_f[0] + torch.where(e_y, g_pfb[2], 0.0),
             gk0_f[1] + torch.where(e_y, 0.0, -g_pfb[2]),
             gk0_f[2] + torch.where(e_y, -g_pfb[0], g_pfb[1]))
    g_k0 = _vadd(g_k0, tuple(torch.where(deg, f, n)
                             for n, f in zip(gk0_n, gk0_f)))
    g_k1 = _vadd(g_k1, tuple(torch.where(deg, 0.0, v) for v in gk1_n))
    return g_k0, g_k1


def _fresnel(n1, n2, adot, refl):
    """Fresnel Jones entries (j00, j11, j22) as pairs, and the forward
    values the adjoint needs."""
    n = n2 / n1
    nn = n * n
    arg = nn - 1.0 + adot * adot  # n^2 - sin^2(aoi)
    pos = arg >= 0
    # double-where: sqrt's cotangent must not meet the masked branch
    rr = torch.where(pos, torch.sqrt(torch.where(pos, arg, 1.0)), 0.0)
    ri = torch.where(pos, 0.0, torch.sqrt(torch.where(pos, 1.0, -arg)))
    root = (rr, ri)
    c = adot
    if refl:
        A, B = (c - rr, -ri), (c + rr, ri)
        C, D = (nn * c - rr, -ri), (nn * c + rr, ri)
        js, pp = _cdiv(A, B), _cdiv(C, D)
        j = (js, (-pp[0], -pp[1]), (-1.0, 0.0))
        aux = (n, nn, pos, root, A, B, C, D, js, pp)
    else:
        B, D = (c + rr, ri), (nn * c + rr, ri)
        js = _cdiv((2 * c, 0.0 * c), B)
        jp = _cdiv((2 * n * c, 0.0 * c), D)
        j = (js, jp, (1.0, 0.0))
        aux = (n, nn, pos, root, None, B, None, D, js, jp)
    return j, aux


def _fresnel_adjoint(n1, n2, adot, refl, aux, g_js, g_jp):
    """(g_n1, g_n2, g_adot) from the cotangents of j00 and j11."""
    n, nn, pos, root, A, B, C, D, js, jq = aux
    c = adot
    if refl:
        gA, gB = _div_adjoint(g_js, A, B, js)
        gC, gD = _div_adjoint((-g_jp[0], -g_jp[1]), C, D, jq)
        g_c = gA[0] + gB[0] + nn * (gC[0] + gD[0])
        g_nn = c * (gC[0] + gD[0])
        g_root = _cadd(_csub(gB, gA), _csub(gD, gC))
    else:
        gnum, gB = _div_adjoint(g_js, (2 * c, 0.0 * c), B, js)
        gnum2, gD = _div_adjoint(g_jp, (2 * n * c, 0.0 * c), D, jq)
        g_c = 2 * gnum[0] + gB[0] + 2 * n * gnum2[0] + nn * gD[0]
        g_n = 2 * c * gnum2[0]
        g_nn = c * gD[0]
        g_root = _cadd(gB, gD)
    g_arg = torch.where(pos, g_root[0] * 0.5 / torch.where(pos, root[0], 1.0),
                        -g_root[1] * 0.5 / torch.where(pos, 1.0, root[1]))
    g_nn = g_nn + g_arg
    g_adot = g_c + 2 * adot * g_arg
    g_n = 2 * n * g_nn + (0.0 if refl else g_n)
    return -g_n * n2 / (n1 * n1), g_n / n1, g_adot


def _cos_in(n, u2):
    """cos of the angle in a medium of index n: sqrt(max(n^2 - u2, tiny))
    / n, and its square root's argument."""
    arg = n * n - u2
    sq = torch.sqrt(torch.clamp(arg, min=1e-30))
    return sq / n, (arg, sq)


def _cos_in_adjoint(n, u2, aux, g_cos):
    """(g_n, g_u2) of cos = sqrt(max(n^2 - u2, tiny)) / n."""
    arg, sq = aux
    g_n = -g_cos * sq / (n * n)
    g_arg = torch.where(arg >= 1e-30, g_cos / n * 0.5 / sq, 0.0)
    return g_n + 2 * n * g_arg, -g_arg


def _layer_step(acc, c, sn, e):
    Ar, Bi, Ci, Dr = acc
    return (Ar * c - Bi * e * sn, Ar * sn / e + Bi * c, Ci * c + Dr * e * sn,
            -Ci * sn / e + Dr * c)


def _tmm(cr, nl, adot, refl):
    """Thin-film Jones entries (j00, j11, j22) from the coat row ``cr``
    (n0, ns, n_l, phase thickness_l ...) of ``nl`` layers, by the
    real-index transfer matrix; and the forward values of the adjoint."""
    n0, ns = cr[0], cr[1]
    u2 = (n0 * n0) * (1.0 - adot * adot)  # (n0 sin theta0)^2
    cos0 = adot
    coss, aux_s = _cos_in(ns, u2)
    layers = []
    for l in range(nl):
        nlay, dl = cr[2 + 2 * l], cr[3 + 2 * l]
        cosl, aux_l = _cos_in(nlay, u2)
        delta = nlay * dl * cosl
        layers.append((nlay, dl, cosl, aux_l, torch.cos(delta),
                       torch.sin(delta)))
    outs, pols = [], []
    for pol in ("s", "p"):
        if pol == "s":
            eta0, etas = n0 * cos0, ns * coss
        else:
            eta0, etas = n0 / cos0, ns / coss
        acc = (1.0, 0.0, 0.0, 1.0)
        for nlay, _, cosl, _, c, sn in layers:
            e = nlay * cosl if pol == "s" else nlay / cosl
            acc = _layer_step(acc, c, sn, e)
        Ar, Bi, Ci, Dr = acc
        den = (eta0 * Ar + etas * Dr, eta0 * etas * Bi + Ci)
        if refl:
            num = (eta0 * Ar - etas * Dr, eta0 * etas * Bi - Ci)
            out = _cdiv(num, den)
        else:
            mag = den[0] * den[0] + den[1] * den[1]
            out = (2 * eta0 * den[0] / mag, 2 * eta0 * den[1] / mag)
            num = mag
        outs.append(out)
        pols.append((eta0, etas, acc, den, num, out))
    js, jp = outs
    if refl:
        j = (js, (-jp[0], -jp[1]), (-1.0, 0.0))
    else:
        j = (js, jp, (1.0, 0.0))
    return j, (u2, coss, aux_s, layers, pols)


def _tmm_adjoint(cr, nl, adot, refl, aux, g_js, g_jp):
    """(cotangents of the coat row's 2 + 2 nl columns, g_adot). The layer
    products are undone in reverse with each layer's inverse matrix (every
    layer matrix has determinant 1)."""
    u2, coss, aux_s, layers, pols = aux
    n0, ns = cr[0], cr[1]
    cos0 = adot
    zero = torch.zeros_like(adot)
    g_u2, g_n0, g_ns, g_cos0, g_coss = zero, zero, zero, zero, zero
    g_nl = [zero] * nl
    g_dl = [zero] * nl
    g_cosl = [zero] * nl
    g_c = [zero] * nl
    g_sn = [zero] * nl
    g_outs = (g_js, g_jp if not refl else (-g_jp[0], -g_jp[1]))
    for pi, pol in enumerate(("s", "p")):
        eta0, etas, acc, den, num, out = pols[pi]
        g_out = g_outs[pi]
        Ar, Bi, Ci, Dr = acc
        if refl:
            g_num, g_den = _div_adjoint(g_out, num, den, out)
            g_eta0 = g_num[0] * Ar + g_num[1] * etas * Bi
            g_etas = -g_num[0] * Dr + g_num[1] * eta0 * Bi
            gA = g_num[0] * eta0
            gD = -g_num[0] * etas
            gB = g_num[1] * eta0 * etas
            gC = -g_num[1]
        else:
            mag = num
            g_eta0 = (g_out[0] * 2 * den[0] + g_out[1] * 2 * den[1]) / mag
            g_mag = -(g_out[0] * out[0] + g_out[1] * out[1]) / mag
            g_den = (g_out[0] * 2 * eta0 / mag + 2 * den[0] * g_mag,
                     g_out[1] * 2 * eta0 / mag + 2 * den[1] * g_mag)
            g_etas = zero
            gA, gB, gC, gD = zero, zero, zero, zero
        g_eta0 = g_eta0 + g_den[0] * Ar + g_den[1] * etas * Bi
        g_etas = g_etas + g_den[0] * Dr + g_den[1] * eta0 * Bi
        gA = gA + g_den[0] * eta0
        gD = gD + g_den[0] * etas
        gB = gB + g_den[1] * eta0 * etas
        gC = gC + g_den[1]
        for l in range(nl - 1, -1, -1):
            nlay, dl, cosl, _, c, sn = layers[l]
            e = nlay * cosl if pol == "s" else nlay / cosl
            # the accumulators before this layer: the inverse layer matrix
            Ar, Bi, Ci, Dr = _layer_step((Ar, Bi, Ci, Dr), c, -sn, e)
            g_c[l] = g_c[l] + gA * Ar + gB * Bi + gC * Ci + gD * Dr
            g_sn[l] = (g_sn[l] - gA * Bi * e + gB * Ar / e + gC * Dr * e
                       - gD * Ci / e)
            g_e = (-gA * Bi * sn - gB * Ar * sn / (e * e) + gC * Dr * sn
                   + gD * Ci * sn / (e * e))
            gA, gB, gC, gD = (gA * c + gB * sn / e, -gA * e * sn + gB * c,
                              gC * c - gD * sn / e, gC * e * sn + gD * c)
            if pol == "s":
                g_nl[l] = g_nl[l] + g_e * cosl
                g_cosl[l] = g_cosl[l] + g_e * nlay
            else:
                g_nl[l] = g_nl[l] + g_e / cosl
                g_cosl[l] = g_cosl[l] - g_e * nlay / (cosl * cosl)
        if pol == "s":
            g_n0 = g_n0 + g_eta0 * cos0
            g_cos0 = g_cos0 + g_eta0 * n0
            g_ns = g_ns + g_etas * coss
            g_coss = g_coss + g_etas * ns
        else:
            g_n0 = g_n0 + g_eta0 / cos0
            g_cos0 = g_cos0 - g_eta0 * n0 / (cos0 * cos0)
            g_ns = g_ns + g_etas / coss
            g_coss = g_coss - g_etas * ns / (coss * coss)
    g_cols = [None] * (2 + 2 * nl)
    for l in range(nl):
        nlay, dl, cosl, aux_l, c, sn = layers[l]
        g_delta = -g_c[l] * sn + g_sn[l] * c
        g_nl[l] = g_nl[l] + g_delta * dl * cosl
        g_cosl[l] = g_cosl[l] + g_delta * nlay * dl
        gn, gu = _cos_in_adjoint(nlay, u2, aux_l, g_cosl[l])
        g_cols[2 + 2 * l] = g_nl[l] + gn
        g_cols[3 + 2 * l] = g_delta * nlay * cosl
        g_u2 = g_u2 + gu
    gn, gu = _cos_in_adjoint(ns, u2, aux_s, g_coss)
    g_ns = g_ns + gn
    g_u2 = g_u2 + gu
    g_cols[0] = g_n0 + 2 * n0 * (1.0 - adot * adot) * g_u2
    g_cols[1] = g_ns
    g_adot = g_cos0 - 2 * adot * (n0 * n0) * g_u2
    return g_cols, g_adot


def _axis_jones(kind, cr, basis):
    """The polarizer's or retarder's 2x2 block (j00, j01, j10, j11) as
    pairs, and the forward values of the adjoint."""
    s, p0, p1 = basis
    if kind == POLARIZER:
        a = (cr[0], cr[1], cr[2])
        ts, tpi, tpo = _dot(a, s), _dot(a, p0), _dot(a, p1)
        ni = torch.sqrt(ts * ts + tpi * tpi)
        no = torch.sqrt(ts * ts + tpo * tpo)
        ni1 = torch.where(ni == 0, 1.0, ni)
        no1 = torch.where(no == 0, 1.0, no)
        usi, upi, uso, upo = ts / ni1, tpi / ni1, ts / no1, tpo / no1
        z = 0.0 * ts
        j = ((uso * usi, z), (uso * upi, z), (upo * usi, z), (upo * upi, z))
        return j, (a, ts, tpi, tpo, ni, no, usi, upi, uso, upo)
    d, a = cr[0], (cr[1], cr[2], cr[3])
    ts, tp = _dot(a, s), _dot(a, p0)
    nrm = torch.sqrt(ts * ts + tp * tp)
    nrm1 = torch.where(nrm == 0, 1.0, nrm)
    us, up = ts / nrm1, tp / nrm1
    cd2, sd2 = torch.cos(d / 2), torch.sin(d / 2)
    S2, D2 = us * us + up * up, up * up - us * us
    j00 = (cd2 * S2, sd2 * D2)
    j0x = (0.0 * us, -2 * sd2 * us * up)
    j11 = (cd2 * S2, -sd2 * D2)
    return (j00, j0x, j0x, j11), (a, ts, tp, nrm, us, up, cd2, sd2, S2, D2)


def _unit_adjoint(t1, t2, nrm, u1, u2_, g1, g2):
    """Cotangents of (t1, t2) for u = t / |t|, |t| = ``nrm`` (a zero norm
    is taken as the constant 1)."""
    nz = nrm != 0
    n1 = torch.where(nz, nrm, 1.0)
    g_n = torch.where(nz, -(g1 * u1 + g2 * u2_) / n1, 0.0)
    return g1 / n1 + g_n * t1 / n1, g2 / n1 + g_n * t2 / n1


def _axis_adjoint(kind, basis, aux, gJ):
    """(coat-column cotangents, g_s, g_p0, g_p1) from the cotangents of the
    block's four entries."""
    s, p0, p1 = basis
    (g00, g01, g10, g11) = gJ
    if kind == POLARIZER:
        a, ts, tpi, tpo, ni, no, usi, upi, uso, upo = aux
        g_uso = g00[0] * usi + g01[0] * upi
        g_upo = g10[0] * usi + g11[0] * upi
        g_usi = g00[0] * uso + g10[0] * upo
        g_upi = g01[0] * uso + g11[0] * upo
        g_ts1, g_tpi = _unit_adjoint(ts, tpi, ni, usi, upi, g_usi, g_upi)
        g_ts2, g_tpo = _unit_adjoint(ts, tpo, no, uso, upo, g_uso, g_upo)
        g_ts = g_ts1 + g_ts2
        g_a = _vadd(_vadd(_vscale(s, g_ts), _vscale(p0, g_tpi)),
                    _vscale(p1, g_tpo))
        return (list(g_a), _vscale(a, g_ts), _vscale(a, g_tpi),
                _vscale(a, g_tpo))
    a, ts, tp, nrm, us, up, cd2, sd2, S2, D2 = aux
    g_cd2 = (g00[0] + g11[0]) * S2
    g_S2 = (g00[0] + g11[0]) * cd2
    g_D2 = (g00[1] - g11[1]) * sd2
    g_x = g01[1] + g10[1]
    g_sd2 = (g00[1] - g11[1]) * D2 - 2 * g_x * us * up
    g_usup = -2 * sd2 * g_x
    g_us = 2 * us * (g_S2 - g_D2) + g_usup * up
    g_up = 2 * up * (g_S2 + g_D2) + g_usup * us
    g_d = 0.5 * (-g_cd2 * sd2 + g_sd2 * cd2)
    g_ts, g_tp = _unit_adjoint(ts, tp, nrm, us, up, g_us, g_up)
    g_a = _vadd(_vscale(s, g_ts), _vscale(p0, g_tp))
    zero = torch.zeros_like(ts)
    return ([g_d] + list(g_a), _vscale(a, g_ts), _vscale(a, g_tp),
            (zero, zero, zero))


def _columns(j, like):
    """J's entries (pairs of numbers or (R,) tensors) as (R, 1) columns, to
    broadcast against the rows of q."""
    return tuple(tuple(torch.as_tensor(v, dtype=like.dtype,
                                       device=like.device)[..., None]
                       for v in e) for e in j)


def _update(p, basis, k0, k1, j):
    """p <- O_out J O_in p with J's entries ``j`` = (j00, j01, j10, j11,
    j22) as pairs; returns the new p and the forward values of the
    adjoint."""
    s, p0, p1 = basis
    Bin = _mat((s, p0, k0))
    Bout = _mat((s, p1, k1))
    q = (_mm(Bin, p[0]), _mm(Bin, p[1]))
    qr = tuple((q[0][:, b], q[1][:, b]) for b in range(3))
    j00, j01, j10, j11, j22 = _columns(j, q[0])
    r0 = _cadd(_cmul(j00, qr[0]), _cmul(j01, qr[1]))
    r1 = _cadd(_cmul(j10, qr[0]), _cmul(j11, qr[1]))
    r2 = _cmul(j22, qr[2])
    r = (torch.stack([r0[0], r1[0], r2[0]], dim=1),
         torch.stack([r0[1], r1[1], r2[1]], dim=1))
    BoutT = Bout.transpose(-1, -2)
    return (_mm(BoutT, r[0]), _mm(BoutT, r[1])), (Bin, Bout, q, r, j)


def _update_adjoint(p, aux, G):
    """(g_p, gJ entries as pairs, g_Bin, g_Bout) from G, the cotangent of
    the new p."""
    Bin, Bout, q, r, j = aux
    j00, j01, j10, j11, j22 = _columns(j, q[0])
    g_r = (_mm(Bout, G[0]), _mm(Bout, G[1]))
    g_Bout = (_mm(r[0], G[0].transpose(-1, -2))
              + _mm(r[1], G[1].transpose(-1, -2)))
    gr = tuple((g_r[0][:, a], g_r[1][:, a]) for a in range(3))
    qr = tuple((q[0][:, b], q[1][:, b]) for b in range(3))
    gq0 = _cadd(_cjmul(j00, gr[0]), _cjmul(j10, gr[1]))
    gq1 = _cadd(_cjmul(j01, gr[0]), _cjmul(j11, gr[1]))
    gq2 = _cjmul(j22, gr[2])

    def corr(a, b):  # sum_l a[l] conj(b[l])
        v = _cjmul(b, a)
        return v[0].sum(-1), v[1].sum(-1)

    gJ = (corr(gr[0], qr[0]), corr(gr[0], qr[1]), corr(gr[1], qr[0]),
          corr(gr[1], qr[1]), corr(gr[2], qr[2]))
    g_q = (torch.stack([gq0[0], gq1[0], gq2[0]], dim=1),
           torch.stack([gq0[1], gq1[1], gq2[1]], dim=1))
    BinT = Bin.transpose(-1, -2)
    g_p = (_mm(BinT, g_q[0]), _mm(BinT, g_q[1]))
    g_Bin = (_mm(g_q[0], p[0].transpose(-1, -2))
             + _mm(g_q[1], p[1].transpose(-1, -2)))
    return g_p, gJ, _rows(g_Bin), _rows(g_Bout)


def _launch_basis(L, M, N):
    """The launch-space (s, p) of ``get_3d_electric_field``: p = k x xhat
    normalized (kept where it vanishes), s = p x k."""
    zero = torch.zeros_like(L)
    pr = (zero, N, -M)
    nrm = torch.sqrt(pr[0] * pr[0] + pr[1] * pr[1] + pr[2] * pr[2])
    pl = tuple(c / torch.where(nrm == 0, 1.0, nrm) for c in pr)
    return _cross(pl, (L, M, N)), pl, nrm


def _exit_intensity(p, L, M, N, i0, states):
    """sum over the states of |p E0|^2, times i0 / the number of states,
    and the forward values of the adjoint."""
    sl, pl, nrm = _launch_basis(L, M, N)
    total = torch.zeros_like(i0)
    fields = []
    for ex_re, ex_im, ey_re, ey_im in states:
        e_re = torch.stack([ex_re * a + ey_re * b for a, b in zip(sl, pl)], 1)
        e_im = torch.stack([ex_im * a + ey_im * b for a, b in zip(sl, pl)], 1)
        E_re = (p[0] * e_re[:, None, :] - p[1] * e_im[:, None, :]).sum(-1)
        E_im = (p[0] * e_im[:, None, :] + p[1] * e_re[:, None, :]).sum(-1)
        total = total + (E_re * E_re + E_im * E_im).sum(-1)
        fields.append((e_re, e_im, E_re, E_im))
    return total * i0 / len(states), (total, sl, pl, nrm, fields)


def _exit_intensity_adjoint(p, L, M, N, i0, states, aux, g_out):
    """(G, the cotangent of p; g_L, g_M, g_N; g_i0)."""
    total, sl, pl, nrm, fields = aux
    n = len(states)
    g_tot = g_out * i0 / n
    g_i0 = g_out * total / n
    G_re, G_im = torch.zeros_like(p[0]), torch.zeros_like(p[1])
    g_sl = [torch.zeros_like(L) for _ in range(3)]
    g_pl = [torch.zeros_like(L) for _ in range(3)]
    for (ex_re, ex_im, ey_re, ey_im), (e_re, e_im, E_re, E_im) in zip(
            states, fields):
        gE_re, gE_im = 2 * g_tot[:, None] * E_re, 2 * g_tot[:, None] * E_im
        # E = p e: g_p = g_E conj(e)^T, g_e = p^H g_E
        G_re = G_re + gE_re[:, :, None] * e_re[:, None, :] \
            + gE_im[:, :, None] * e_im[:, None, :]
        G_im = G_im + gE_im[:, :, None] * e_re[:, None, :] \
            - gE_re[:, :, None] * e_im[:, None, :]
        ge_re = (p[0] * gE_re[:, :, None] + p[1] * gE_im[:, :, None]).sum(1)
        ge_im = (p[0] * gE_im[:, :, None] - p[1] * gE_re[:, :, None]).sum(1)
        for c in range(3):
            g_sl[c] = g_sl[c] + ex_re * ge_re[:, c] + ex_im * ge_im[:, c]
            g_pl[c] = g_pl[c] + ey_re * ge_re[:, c] + ey_im * ge_im[:, c]
    k = (L, M, N)
    # s = pl x k
    g_k = _cross(g_sl, pl)
    g_pl = _vadd(g_pl, _cross(k, g_sl))
    # pl = (0, N, -M) / |(0, N, -M)| (a zero norm taken as 1)
    nz = nrm != 0
    proj = _dot(pl, g_pl)
    g_pr = tuple(torch.where(nz, (g - c * proj) / torch.where(nz, nrm, 1.0),
                             g) for g, c in zip(g_pl, pl))
    return ((G_re, G_im), g_k[0], g_k[1] - g_pr[2], g_k[2] + g_pr[1], g_i0)


# ---------------------------------------------------------------------------
# The chain: plain forward, hand adjoint
# ---------------------------------------------------------------------------


def _identity_p(like):
    R = like.shape[0]
    eye = torch.eye(3, dtype=like.dtype, device=like.device).expand(R, 3, 3)
    return eye, torch.zeros_like(eye)


def _chain(params, coat, spec, st, keep=False, coeffs=None, lay=None):
    """The polarized chain: final state, final p (re, im), and with
    ``keep`` per surface what the adjoint replays."""
    codes, refl, absorbs, kinds, layers = spec[:5]
    inner, niters = spec[-2], spec[-1]
    n_pre = params[0, P_NPOST]
    p = _identity_p(st[0])
    saved = []
    for s in range(1, len(codes)):
        st_in = st
        st, n_next, ext = step_plain(codes[s], refl[s], params[s], n_pre, st,
                                     absorbs[s], extras=True,
                                     c=coef_row(coeffs, s),
                                     newton_iters=niters, inner=inner[s],
                                     lay=lay_row(lay, codes[s], s))
        k0, k1, adot = ext[:3], ext[3:6], ext[6]
        i_step = st[6]
        if kinds[s] == SIMPLE:
            st = st[:6] + (st[6] * coat[s, 1 if refl[s] else 0], st[7])
        basis, baux = _basis(k0, k1)
        one, zero = (1.0, 0.0), (0.0, 0.0)
        jaux = None
        if kinds[s] == FRESNEL:
            (j00, j11, j22), jaux = _fresnel(coat[s, 0], coat[s, 1], adot,
                                             refl[s])
            j = (j00, zero, zero, j11, j22)
        elif kinds[s] == TMM:
            (j00, j11, j22), jaux = _tmm(coat[s], layers[s], adot, refl[s])
            j = (j00, zero, zero, j11, j22)
        elif kinds[s] in (POLARIZER, RETARDER):
            blk, jaux = _axis_jones(kinds[s], coat[s], basis)
            j = blk + (one,)
        else:
            j = (one, zero, zero, one, one)
        p_in = p
        p, uaux = _update(p, basis, k0, k1, j)
        if keep:
            saved.append(dict(st=st_in, n_pre=n_pre, k0=k0, k1=k1, adot=adot,
                              i_step=i_step, p=p_in, basis=basis, baux=baux,
                              jaux=jaux, uaux=uaux))
        n_pre = n_next
    return st, p, saved


def pol_fwd_plain(params, coat, spec, rays, states=None, intensity=False,
                  coeffs=None, lay=None):
    """Plain version of the pol_fwd kernel: 26 arrays (the 8 ray arrays,
    then p's 9 real and 9 imaginary parts, row-major) of the 8 launch
    arrays ``rays``; with ``intensity``, the 8 ray arrays with the
    intensity replaced by the exit intensity of the polarization ``states``
    (``pol_states``) from the launch intensity and directions."""
    rays = tuple(rays)
    st, p, _ = _chain(params, coat, spec, rays, coeffs=coeffs, lay=lay)
    if intensity:
        i_pol, _ = _exit_intensity(p, rays[3], rays[4], rays[5], rays[6],
                                   states)
        return st[:6] + (i_pol, st[7])
    return (st + tuple(p[0].reshape(-1, 9).unbind(1))
            + tuple(p[1].reshape(-1, 9).unbind(1)))


def pol_bwd_plain(params, coat, spec, rays, cots, states=None,
                  intensity=False, coeffs=None, nc=1, with_coeffs=False,
                  lay=None):
    """Plain version of the pol_bwd kernel, the adjoint by hand: for the
    output cotangents ``cots`` (26, or 8 in the intensity mode), the 8
    per-ray input cotangents and the flat gradient in the layout (S * NUM_P
    params, S * ncoat coat table), which the wrapper widens with the
    (S, nc) block of the coefficient table ``coeffs``; with
    ``with_coeffs`` that block comes back too."""
    codes, refl, absorbs, kinds, layers, tilted, inner, niters = spec
    S, ncoat = len(codes), coat.shape[1]
    if coeffs is not None:
        nc = coeffs.shape[1]
    rays, cots = tuple(rays), tuple(cots)
    with torch.no_grad():
        st, p, saved = _chain(params, coat, spec, rays, keep=True,
                              coeffs=coeffs, lay=lay)
        zero = torch.zeros_like(rays[0])
        g_launch = [zero] * 8
        if intensity:
            _, iaux = _exit_intensity(p, rays[3], rays[4], rays[5], rays[6],
                                      states)
            G, gL, gM, gN, gi = _exit_intensity_adjoint(
                p, rays[3], rays[4], rays[5], rays[6], states, iaux, cots[6])
            g_launch[3:7] = [gL, gM, gN, gi]
            # the chain's own intensity reaches no output
            g = list(cots[:6]) + [zero, zero, cots[7]]
        else:
            G = (torch.stack(cots[8:17], 1).reshape(-1, 3, 3),
                 torch.stack(cots[17:26], 1).reshape(-1, 3, 3))
            g = list(cots[:6]) + [zero] + list(cots[6:8])
        # g: cotangents of (x, y, z, L, M, N, n, i, opd) after surface s
        dparams = params.new_zeros((S, NUM_P))
        dcoat = coat.new_zeros((S, ncoat))
        dcoeffs = params.new_zeros((S, nc))
        for s in range(S - 1, 0, -1):
            sv = saved[s - 1]
            k0, k1, adot, basis = sv["k0"], sv["k1"], sv["adot"], sv["basis"]
            G, gJ, gBin, gBout = _update_adjoint(sv["p"], sv["uaux"], G)
            g_s = _vadd(gBin[0], gBout[0])
            g_p0, g_p1 = gBin[1], gBout[1]
            g_k0, g_k1 = gBin[2], gBout[2]
            g_adot = zero
            if kinds[s] == FRESNEL:
                gn1, gn2, g_adot = _fresnel_adjoint(
                    coat[s, 0], coat[s, 1], adot, refl[s], sv["jaux"], gJ[0],
                    gJ[3])
                dcoat[s, 0] = gn1.sum()
                dcoat[s, 1] = gn2.sum()
            elif kinds[s] == TMM:
                cols, g_adot = _tmm_adjoint(coat[s], layers[s], adot, refl[s],
                                            sv["jaux"], gJ[0], gJ[3])
                for c, v in enumerate(cols):
                    dcoat[s, c] = v.sum()
            elif kinds[s] in (POLARIZER, RETARDER):
                cols, gs2, gp02, gp12 = _axis_adjoint(kinds[s], basis,
                                                      sv["jaux"], gJ[:4])
                for c, v in enumerate(cols):
                    dcoat[s, c] = v.sum()
                g_s, g_p0, g_p1 = (_vadd(g_s, gs2), _vadd(g_p0, gp02),
                                   _vadd(g_p1, gp12))
            gk0b, gk1b = _basis_adjoint(k0, k1, basis, sv["baux"], g_s, g_p0,
                                        g_p1)
            g_k0, g_k1 = _vadd(g_k0, gk0b), _vadd(g_k1, gk1b)
            if kinds[s] == SIMPLE:
                col = 1 if refl[s] else 0
                dcoat[s, col] = (g[7] * sv["i_step"]).sum()
                g[7] = g[7] * coat[s, col]
            g_in, g_npre, cols = step_adjoint_plain(
                codes[s], refl[s], params[s], sv["n_pre"], sv["st"],
                tuple(g), absorbs[s], g_ext=g_k0 + g_k1 + (g_adot,),
                tilted=tilted[s], c=coef_row(coeffs, s), newton_iters=niters,
                inner=inner[s], lay=lay_row(lay, codes[s], s))
            pairs, coef = split_cols(codes[s], cols, FULL_GRAD_COLS, nc)
            for col, v in pairs:
                dparams[s, col] = v.sum()
            for j, v in enumerate(coef):
                dcoeffs[s, j] = v.sum()
            g = list(g_in[:6]) + [g_npre] + list(g_in[6:])
        # n_pre of surface 1 is the object row's n_post
        dparams[0, P_NPOST] = g[6].sum()
        din = [a + b for a, b in zip(g[:6] + g[7:], g_launch)]
    block = (dcoeffs.reshape(-1),) if with_coeffs else ()
    return tuple(din), torch.cat((dparams.reshape(-1),) + block
                                 + (dcoat.reshape(-1),))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_pol(params, coat, spec, arrays, n_arrays, coeffs, lay):
    check_cuda_inputs(params, spec, arrays, coeffs=coeffs, lay=lay)
    S = len(spec[0])
    if len(arrays) != n_arrays:
        raise ValueError(f"expected {n_arrays} per-ray arrays, got "
                         f"{len(arrays)}")
    if (coat.device != params.device or coat.dtype != params.dtype
            or not coat.is_contiguous() or coat.dim() != 2
            or coat.shape[0] != S):
        raise ValueError(f"the coat table must be a contiguous (S, ncoat) "
                         f"{params.dtype} tensor on {params.device}")
    if coat.shape[1] > 2 + 2 * MAX_LAYERS or any(
            l > MAX_LAYERS or 2 + 2 * l > coat.shape[1] for l in spec[4]):
        raise ValueError(f"the kernels take tmm stacks of at most "
                         f"{MAX_LAYERS} layers within the coat table")


def _state_args(states):
    """The C entries' polarization arguments: 8 doubles (two states' 4
    coefficients, the second zero for one state) and the state count."""
    vals = [float(v) for st in states or () for v in st] + [0.0] * 8
    return vals[:8] + [len(states or ())]


def _build(spec):
    return build_of(spec[0], spec[5], spec[-2])


def pol_fwd(params, coat, spec, rays, states=None, intensity=False,
            coeffs=None, lay=None):
    """The 26 (or, with ``intensity``, 8) output arrays of the 8 launch
    arrays ``rays``: the pol_fwd kernel on a CUDA device, its plain version
    on the CPU. ``coeffs`` is the (S, nc) coefficient table (None:
    zeros), ``lay`` the layout table of its aux-bearing rows."""
    name = "pol_fwd_intensity" if intensity else "pol_fwd"
    if device_of(params.device, name) == "cpu":
        return pol_fwd_plain(params, coat, spec, rays, states, intensity,
                             coeffs, lay)
    from optiland_torch.ops import _cuda

    rays = tuple(rays)
    coeffs = _coeffs_or_zeros(coeffs, params)
    _check_pol(params, coat, spec, rays, 8, coeffs, lay)
    out = [torch.empty_like(rays[0]) for _ in range(8 if intensity else N_POL)]
    build = _build(spec)
    table = device_table(coeffs, lay)  # held until the launch is queued
    with torch.cuda.device(params.device):
        rc = _cuda.call(
            entry_name("pol_fwd", build), params.dtype, params.data_ptr(), coat.data_ptr(),
            flags(spec[:-2], params.device).data_ptr(), len(spec[0]), build,
            table.data_ptr(), coeffs.shape[1], spec[-1], coat.shape[1],
            _cuda.pointers(rays), rays[0].shape[0], _cuda.pointers(out),
            int(intensity), *_state_args(states), _cuda.stream(),
        )
    _cuda.check(rc, name)
    LAUNCHES[launch_key(name, build)] += 1
    return tuple(out)


def pol_bwd(params, coat, spec, nc, rays, cots, states=None, intensity=False,
            coeffs=None, lay=None):
    """(8 per-ray input cotangents, flat (S * NUM_P + S * nc + S * ncoat)
    gradient) for the output cotangents ``cots``: the pol_bwd kernel and
    its fixed-order reduction on a CUDA device, the plain version on the
    CPU."""
    name = "pol_bwd_intensity" if intensity else "pol_bwd"
    S, ncoat = len(spec[0]), coat.shape[1]
    if device_of(params.device, name) == "cpu":
        return pol_bwd_plain(params, coat, spec, rays, cots, states,
                             intensity, coeffs, nc, with_coeffs=True,
                             lay=lay)
    from optiland_torch.ops import _cuda

    rays, cots = tuple(rays), tuple(cots)
    coeffs = _coeffs_or_zeros(coeffs, params)
    _check_pol(params, coat, spec, rays + cots,
               8 + (8 if intensity else N_POL), coeffs, lay)
    _check_nc(coeffs, nc)
    R = rays[0].shape[0]
    nb = _bwd_blocks(R)
    din = [torch.empty_like(rays[0]) for _ in range(8)]
    partial = params.new_empty(
        (nb, S * (len(FULL_GRAD_COLS) + ncoat)
         + sag_columns(spec[0], nc, _build(spec))))
    out = params.new_zeros(S * (NUM_P + nc + ncoat))
    build = _build(spec)
    table = device_table(coeffs, lay)  # held until the launch is queued
    with torch.cuda.device(params.device):
        rc = _cuda.call(
            entry_name("pol_bwd", build), params.dtype, params.data_ptr(), coat.data_ptr(),
            flags(spec[:-2], params.device).data_ptr(), S, build,
            table.data_ptr(), nc, spec[-1], len(sag_surfaces(spec[0], build)),
            ncoat, _cuda.pointers(rays),
            _cuda.pointers(cots), R, _cuda.pointers(din), partial.data_ptr(),
            nb, out.data_ptr(), int(intensity), *_state_args(states),
            _cuda.stream(),
        )
    _cuda.check(rc, name)
    LAUNCHES[launch_key(name, build)] += 1
    return tuple(din), out


# ---------------------------------------------------------------------------
# autograd Function and public entries
# ---------------------------------------------------------------------------


class _TracePol(torch.autograd.Function):
    """8 launch arrays -> 26 (or 8) arrays; backward = pol_bwd."""

    @staticmethod
    def forward(ctx, params, coeffs, lay, coat, spec, states, intensity,
                *rays):
        out = pol_fwd(params, coat, spec, rays, states, intensity, coeffs,
                      lay)
        ctx.save_for_backward(params, coeffs, coat, *rays)
        ctx.spec, ctx.nc, ctx.lay = spec, coeffs.shape[1], lay
        ctx.states, ctx.intensity = states, intensity
        return out

    @staticmethod
    def backward(ctx, *g):
        params, coeffs, coat, *rays = ctx.saved_tensors
        cots = [c.contiguous() for c in g]
        din, flat = pol_bwd(params, coat, ctx.spec, ctx.nc, rays, cots,
                            ctx.states, ctx.intensity, coeffs, ctx.lay)
        S = len(ctx.spec[0])
        dparams, dcoeffs, dcoat = _split(flat, S, ctx.nc)
        return (dparams, dcoeffs, None, dcoat.reshape(S, -1), None, None,
                None) + tuple(din)


def _pol_inputs(system, rays, wavelength, what):
    spec = pol_spec(system, wavelength)
    if spec is None:
        if not kernel_eligible(system, wavelength):
            raise ValueError(
                f"{what}: a coating is not kernel-eligible at this trace "
                "wavelength (e.g. a thin-film stack that absorbs there); "
                "core.trace.trace runs the plain engine for it"
            )
        raise unsupported(what)
    dt = rays.x.dtype
    params = build_param_table(system, wavelength).to(dt)
    coat = build_coat_table(system, wavelength, dt, params.device)
    ray_in = [getattr(rays, k).to(dt).contiguous() for k in RAY_FIELDS]
    return spec, params, kernel_tables(system, dt), coat, ray_in


def trace_fast_pol(system, rays, wavelength):
    """Fused polarized trace, monochromatic: ``(RealRays, p)`` with ``p``
    the complex (R, 3, 3) polarization matrices.

    Equivalent to ``core.trace.trace`` on a polarized system (final ray
    state and the accumulated polarization matrices) for systems that
    ``pol_supported`` covers at ``wavelength``; its gradient runs the hand
    adjoint. The final polarized intensity is ``polarized_intensity(p,
    state, rays.L, rays.M, rays.N, rays.i)``, as ``Optic.trace`` forms it.
    The bundle's dtype and device decide where it runs: the kernels on a
    CUDA device, their plain versions on the CPU."""
    spec, params, tables, coat, ray_in = _pol_inputs(
        system, rays, wavelength, "trace_fast_pol")
    out = _TracePol.apply(params, *tables, coat, spec, None, False, *ray_in)
    x, y, z, L, M, N, i, opd = out[:8]
    R = x.shape[0]
    p = torch.complex(torch.stack(out[8:17], 1),
                      torch.stack(out[17:26], 1)).reshape(R, 3, 3)
    final = RealRays(x=x, y=y, z=z, L=L, M=M, N=N, i=i, w=rays.w, opd=opd)
    return final, p


def trace_fast_pol_intensity(system, rays, wavelength, state=None):
    """Fused polarized trace with the exit intensity formed in the kernel:
    equivalent to ``trace_fast_pol`` followed by ``polarized_intensity(p,
    state, rays.L, rays.M, rays.N, rays.i)``, but p never leaves the
    kernel: the 8 ray arrays come back with ``i`` already polarized.
    ``state`` None is unpolarized light."""
    spec, params, tables, coat, ray_in = _pol_inputs(
        system, rays, wavelength, "trace_fast_pol_intensity")
    x, y, z, L, M, N, i, opd = _TracePol.apply(
        params, *tables, coat, spec, pol_states(state), True, *ray_in)
    return RealRays(x=x, y=y, z=z, L=L, M=M, N=N, i=i, w=rays.w, opd=opd)
