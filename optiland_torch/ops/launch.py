"""Launch side shared by the kernel op modules (``ops/fused_trace.py``,
``ops/fast_trace.py`` and ``ops/pol_trace.py``): the kernels' launch
shapes, the structure their step covers, the build each spec launches,
the launch of a ray from its pupil sample and the aim vector, the
per-surface flag table, and the checks a wrapper runs before it launches
a kernel on a CUDA device.

Every trace kernel is compiled in nine builds (``csrc/step.cuh``), and the
monochromatic ones (merit_fwd/merit_bwd, trace_fwd/trace_bwd,
trace_field_fwd/trace_field_bwd) in a tenth, each an OR of flag bits, and
a launch takes the least one that covers its spec (``build_of``):

  * stock: PLANE and STANDARD surfaces, untilted, at most STOCK_SURF;
  * tilt (BIT_TILT): also the tilt rotations;
  * sag (BIT_SAG): also the radial Newton-from-sag families (EVEN_ASPHERE,
    ODD_ASPHERE), whose coefficient rows the kernels read, and in the full
    traces the annular clip on P_APMIN (a RadialAperture with r_min > 0);
  * free (BIT_CART): also the Cartesian families (POLYNOMIAL_XY,
    CHEBYSHEV, TOROIDAL, BICONIC), whose backwards also sum the P_G1 and
    P_G2 columns;
  * aux (BIT_AUX): free with the aux-bearing Cartesian families too
    (ZERNIKE_SAG, FORBES_QBFS, FORBES_Q2D);
  * deep, deep_free and deep_aux (BIT_DEEP): sag, free and aux for up to
    MAX_SURF surfaces;
  * nurbs (BIT_NURBS, with the tilts; K6d): NURBS surfaces, solved by the
    two-plane (u, v) Newton of ``core/nurbs.py`` on their control net
    (``kernel_tables``), beside PLANE and STANDARD ones;
  * grat (BIT_GRAT, with the tilts): grating diffraction (K6c) on PLANE
    and STANDARD surfaces beside PLANE and STANDARD ones, in the
    monochromatic kernels only (the JAX package's poly and polarized
    kernels take no grating either); its backwards sum the P_G1 and P_G2
    columns of each grating surface.

The nurbs and grat builds take at most STOCK_SURF surfaces and no annular
clip, and neither takes the other's branch or a Newton family: a NURBS
surface or a grating beside a Newton family, a grating, an annular clip or
past STOCK_SURF surfaces is a combination no build covers yet, and
``build_of`` raises for it, naming it (ROADMAP Queue 2). The nurbs build
also bounds the net (NC_NURBS, NU_PMAX, NU_KMAX; ``kernel_tables`` raises
past them on a CUDA device), where the JAX package's kernels have no bound.

Each branch is a flag of its own, so a system runs code that carries no
branch it does not use (the free builds compile to the code they had
before the aux-bearing families). A kernel counts its launches under
``launch_key(name, build)``: the name, then the build's suffix
(``BUILD_SUFFIX``: "_tilt", "_sag", "_free", "_aux", "_deep",
"_deep_free", "_deep_aux", "_nurbs" or "_grat"; none for the stock
build).

An aux-bearing surface reads its coefficient row laid out
(``geom.aux_layout``) and the layout table that says how, a NURBS surface
its row (the control points, then the weights) and the knot table that
gives its structure (nu, nv, p, q and the knots): ``kernel_tables`` forms
them for a system, in one buffer, an aux-bearing row by a differentiable
linear map of the surface's own coefficients (so autograd takes the
kernels' coefficient gradient back through it), the layout or knot table
once per structure."""

from __future__ import annotations

import functools

import torch

from optiland_torch.core import geometry as geom
from optiland_torch.core.system import carried_aux, is_grating, static_tensor
from optiland_torch.ops.step import CART_COLS, FULL_GRAD_COLS, GRAD_COLS, NUM_P
from optiland_torch.physical_apertures import radial_only

# The 8-scalar aim vector of an infinite-conjugate angle field: launch point,
# direction cosines and the pupil's semi-axes
N_AIM = 8
A_X0, A_Y0, A_Z0, A_L, A_M, A_N, A_SX, A_SY = range(N_AIM)

# Launch shapes of the kernels (csrc/step.cuh holds the same values).
FWD_BLOCK = 256  # rays per forward block
BWD_BLOCK = 128
# fixed grid of the backwards' grid-stride loop, but in the stock, tilt,
# Newton and nurbs builds of merit_bwd and trace_bwd (bwd_grid)
BWD_MAX_BLOCKS = 1056
# shared memory a block may hold on sm_90 (227 KB), and what the stock,
# tilt and nurbs builds of merit_bwd and trace_bwd leave of it to their
# static tables (at most 7.1 KB: the f64 poly trace_bwd's, 16 surfaces)
SMEM_MAX = 232_448
SMEM_STATIC = 8_192
STOCK_SURF = 16  # surfaces of the stock, tilt, sag, nurbs and grat builds
MAX_SURF = 64  # surfaces of the deep build: the kernels' bound
NC_MAX = 36  # coefficient columns the kernels take (a 6 x 6 table)
# The nurbs build's bound on a net: its row of 4 nu nv columns (every net of
# up to 8 x 8 control points), its degrees, its knots in each direction
# (nu + p + 1), and the width of its knot table row (nu, nv, p, q, then the
# u and v knots, each padded to NU_KMAX); the knot table's rows after the
# surfaces' hold its tail (``_knot_tail``).
NC_NURBS = 256
NU_PMAX = 7
NU_KMAX = 24
NU_KT = 4 + 2 * NU_KMAX

# the builds (csrc/step.cuh: B_STOCK .. B_DEEP_AUX): each an OR of the
# flag bits of the branches it compiles in and of its reach
BIT_TILT, BIT_SAG, BIT_CART, BIT_AUX, BIT_DEEP, BIT_GRAT, BIT_NURBS = (
    1, 2, 4, 8, 16, 32, 64)
STOCK = 0
TILT = BIT_TILT
SAG = TILT | BIT_SAG
FREE = SAG | BIT_CART
DEEP = SAG | BIT_DEEP
DEEP_FREE = FREE | BIT_DEEP
AUX = FREE | BIT_AUX
DEEP_AUX = DEEP_FREE | BIT_AUX
GRAT = TILT | BIT_GRAT
NURBS = TILT | BIT_NURBS
# the launch-key suffix of each build
BUILD_SUFFIX = {STOCK: "", TILT: "_tilt", SAG: "_sag", FREE: "_free",
                DEEP: "_deep", DEEP_FREE: "_deep_free", AUX: "_aux",
                DEEP_AUX: "_deep_aux", NURBS: "_nurbs", GRAT: "_grat"}
# the builds of every trace kernel; GRAT is the monochromatic kernels' own
TRACE_BUILDS = tuple(b for b in BUILD_SUFFIX if b != GRAT)


def inner_flags(cfg):
    """Per surface: True where a RadialAperture has r_min > 0 (the JAX
    package's ``inner`` spec entry)."""
    return tuple(a is not None and float(getattr(a, "r_min", 0.0)) > 0.0
                 for a in (cfg.apertures or (None,) * cfg.num_surfaces))


def grating_flags(cfg):
    """Per surface: True where the interaction is a grating (the JAX
    package's ``grat`` spec entry)."""
    return tuple(is_grating(i)
                 for i in (cfg.interactions or (None,) * cfg.num_surfaces))


def covered(cfg, field=True, coated=False) -> bool:
    """True when the kernels' step covers this structure: PLANE, STANDARD,
    the Newton families (the radial aspheres and the Cartesian
    freeforms) and NURBS surfaces, tilted or not, RadialAperture
    objects and no others, no interactions but gratings on PLANE and
    STANDARD surfaces, no BSDFs, at most MAX_SURF surfaces, and (with
    ``field``) an infinite-conjugate angle field, which the aim vector
    describes. The unpolarized kernels take no coatings and no
    polarization; ``coated`` asks for the polarized kernels, which take
    both (their coat kinds are checked by ``ops/pol_trace.py``) and no
    grating. Which gratings and NURBS surfaces the grat and nurbs builds
    take is ``build_of``'s check."""

    def all_none(vals):
        return vals is None or all(v is None for v in vals)

    aux = cfg.geom_aux or (None,) * cfg.num_surfaces
    grat = grating_flags(cfg)
    return (
        all(c in geom.SUPPORTED_CODES for c in cfg.geom_codes)
        and all(carried_aux(c, a) for c, a in zip(cfg.geom_codes, aux))
        and radial_only(cfg.apertures)
        and all(i is None or g for i, g in zip(
            cfg.interactions or (None,) * cfg.num_surfaces, grat))
        and all(c in (geom.PLANE, geom.STANDARD)
                for c, g in zip(cfg.geom_codes, grat) if g)
        and not (coated and any(grat))
        and (coated or all_none(cfg.coatings))
        and all_none(cfg.bsdfs)
        and (coated or not cfg.polarized)
        and cfg.num_surfaces <= MAX_SURF
        and (not field or (cfg.field_type == "angle"
                           and bool(cfg.obj_infinite)
                           and not cfg.obj_telecentric))
    )


# The geometry families the kernels cover, as the errors name them
CODE_NAMES = {geom.PLANE: "PLANE", geom.STANDARD: "STANDARD",
              geom.EVEN_ASPHERE: "EVEN_ASPHERE",
              geom.ODD_ASPHERE: "ODD_ASPHERE",
              geom.POLYNOMIAL_XY: "POLYNOMIAL_XY",
              geom.CHEBYSHEV: "CHEBYSHEV", geom.TOROIDAL: "TOROIDAL",
              geom.BICONIC: "BICONIC", geom.ZERNIKE_SAG: "ZERNIKE_SAG",
              geom.FORBES_QBFS: "FORBES_QBFS",
              geom.FORBES_Q2D: "FORBES_Q2D", geom.NURBS: "NURBS"}
FAMILY_NAMES = (", ".join(list(CODE_NAMES.values())[:-1]) + " and "
                + list(CODE_NAMES.values())[-1])


def unsupported(what):
    """The error for a system that the kernels do not cover yet."""
    return NotImplementedError(
        f"{what} covers {FAMILY_NAMES} systems of at most {MAX_SURF} "
        "surfaces (tilted or not) with no aperture objects but "
        "RadialAperture and no interactions but gratings on PLANE and "
        "STANDARD surfaces (the unpolarized monochromatic kernels only); "
        "grid sag comes in a later slice (ROADMAP Queue 2)"
    )


def net_of(row):
    """A NURBS net's structure ``("nurbs", nu, nv, p, q, u_knots,
    v_knots)`` from its row of the knot table (the v knots from the row's
    middle: column 4 + NU_KMAX in a table of NU_KT columns)."""
    vals = row.tolist()
    nu, nv, p, q = (int(v) for v in vals[:4])
    kmax = (len(vals) - 4) // 2
    uk = tuple(vals[4:4 + nu + p + 1])
    vk = tuple(vals[4 + kmax:4 + kmax + nv + q + 1])
    return ("nurbs", nu, nv, p, q, uk, vk)


def lay_row(lay, code, s):
    """The slots of surface s's layout in the layout table ``lay`` for an
    aux-bearing ``code`` (which needs one), the net's structure from the
    knot table for a NURBS surface, else None."""
    if code == geom.NURBS:
        if lay is None or lay.dim() != 2:
            raise ValueError("a NURBS surface needs the knot table of its "
                             "net (kernel_tables)")
        return net_of(lay[s])
    if code not in geom.AUX_CODES:
        return None
    if lay is None:
        raise ValueError("an aux-bearing surface needs the layout table of "
                         "its laid-out row (kernel_tables)")
    return geom.slots_of(lay[s].tolist())


def device_table(coeffs, lay):
    """The buffer a kernel reads at its coefficient table's pointer: the
    (S, nc) table, then the layout table's rows where there is one (the
    aux builds read them from there). The tables of ``kernel_tables`` lie
    so in one buffer already; others are copied into one."""
    if lay is None or lay.data_ptr() == (
            coeffs.data_ptr() + coeffs.numel() * coeffs.element_size()):
        return coeffs
    return torch.cat([coeffs.reshape(-1), lay.reshape(-1)])


@functools.lru_cache(maxsize=64)
def _layout_table(codes, aux, nc, W, dtype, device):
    """The (S, W, LAY_COLS) layout table of a structure's aux-bearing rows
    (every other row zero)."""
    vals = [v for s, c in enumerate(codes)
            for row in geom.layout_rows(
                geom.aux_layout(c, aux[s], nc)[0]
                if c in geom.AUX_CODES else (), W)
            for v in row]
    return torch.tensor(vals, dtype=dtype, device=device).reshape(
        len(codes), W, geom.LAY_COLS)


def _nurbs_bound(aux):
    """What of a NURBS net exceeds the nurbs build's bound, or None."""
    _, nu, nv, p, q, uk, vk = aux
    over = []
    if 4 * nu * nv > NC_NURBS:
        over.append(f"4 nu nv = {4 * nu * nv} columns (NC_NURBS = "
                    f"{NC_NURBS})")
    if max(p, q) > NU_PMAX:
        over.append(f"degree {max(p, q)} (NU_PMAX = {NU_PMAX})")
    if max(len(uk), len(vk)) > NU_KMAX:
        over.append(f"{max(len(uk), len(vk))} knots (NU_KMAX = {NU_KMAX})")
    if any(b < a for k in (uk, vk) for a, b in zip(k, k[1:])):
        over.append("knots that decrease (the kernels search the span)")
    return ", ".join(over) or None


def _recips(knots, n, p):
    """A knot row's reciprocal knot differences for the basis of degree p
    of n control points (nk = n + p + 1 knots): for k = 1..p, the nk
    values 1 / (U[i + k] - U[i]), i = 0..nk - 1, 0 where the interval is
    empty or i + k passes the last knot (csrc/nurbs_step.cuh: nu_basis)."""
    nk = n + p + 1
    out = []
    for k in range(1, p + 1):
        for i in range(nk):
            d = knots[i + k] - knots[i] if i + k < min(nk, len(knots)) else 0
            out.append(1.0 / d if d != 0 else 0.0)
    return out


def _knot_tail(codes, aux, width):
    """The knot table's tail, rows of ``width`` after the S surfaces' rows
    (csrc/nurbs_step.cuh: nu_tail): its row count E and the count ns of
    NURBS surfaces, then for each surface the offset in the tail of its
    reciprocal knot differences, then for each surface the slot of its
    homogeneous net among the ns (both 0 without a net), then each NURBS
    surface's reciprocals (``_recips``: u, then v), zero-padded to E
    rows."""
    S = len(codes)
    offsets, slots, vals = [], [], []
    for c, a in zip(codes, aux):
        if c == geom.NURBS:
            _, nu, nv, p, q, uk, vk = a
            offsets.append(2 + 2 * S + len(vals))
            slots.append(sum(k == geom.NURBS for k in codes[:len(slots)]))
            vals += _recips(uk, nu, p) + _recips(vk, nv, q)
        else:
            offsets.append(0)
            slots.append(0)
    n = 2 + 2 * S + len(vals)
    E = -(-n // width)
    tail = [float(v) for v in [E, codes.count(geom.NURBS)] + offsets + slots]
    tail += vals + [0.0] * (E * width - n)
    return [tail[r * width:(r + 1) * width] for r in range(E)]


@functools.lru_cache(maxsize=64)
def _knot_table(codes, aux, dtype, device):
    """The (S + E, NU_KT) knot table of a structure's NURBS surfaces: row s
    (zero for a surface without a net) holds nu, nv, p, q, then the u
    knots from column 4 and the v knots from column 4 + NU_KMAX,
    zero-padded; the E rows after them its tail (``_knot_tail``). Wider
    where a net has more knots (which the kernels do not take:
    ``check_cuda_inputs``)."""
    kmax = max([NU_KMAX] + [len(k) for c, a in zip(codes, aux)
                            if c == geom.NURBS for k in a[5:]])
    rows = []
    for c, a in zip(codes, aux):
        row = [0.0] * (4 + 2 * kmax)
        if c == geom.NURBS:
            _, nu, nv, p, q, uk, vk = a
            row[:4] = (nu, nv, p, q)
            row[4:4 + len(uk)] = uk
            row[4 + kmax:4 + kmax + len(vk)] = vk
        rows.append(row)
    rows += _knot_tail(codes, aux, 4 + 2 * kmax)
    return torch.tensor(rows, dtype=dtype, device=device)


def knot_rows(lay):
    """The rows of a knot table (the surfaces' and its tail's): what the
    nurbs build's launches size their shared memory by; 0 without one
    (None, or an aux-bearing surface's layout table)."""
    return 0 if lay is None or lay.dim() != 2 else int(lay.shape[0])


def kernel_tables(system, dtype):
    """(coeffs, lay): the (S, W) coefficient table the kernels read and
    the (S, W, LAY_COLS) layout table of its aux-bearing rows, or with a
    NURBS surface the (S + E, NU_KT) knot table of its nets (None without
    either), the two back to back in one buffer (``device_table``). A
    NURBS row is the stack's own (the control points, then the weights);
    a NURBS surface beside an aux-bearing one raises NotImplementedError,
    and on a CUDA device a net past the nurbs build's bound does.
    An aux-bearing row is its surface's coefficients laid out
    (``geom.aux_row``, differentiable), every other row the stack's own,
    zero-padded to W: the padded width nc, or the widest layout where a
    Q2d one is wider. Raises NotImplementedError past NC_MAX columns, and
    where a wider layout would change the table side of a POLYNOMIAL_XY or
    CHEBYSHEV surface (read from W)."""
    cfg = system.cfg
    coeffs = system.stack.coeffs.to(dtype)
    S, nc = coeffs.shape
    aux = tuple(cfg.geom_aux or (None,) * S)
    lays = {s: geom.aux_layout(c, aux[s], nc)
            for s, c in enumerate(cfg.geom_codes) if c in geom.AUX_CODES}
    if geom.NURBS in cfg.geom_codes:
        if lays:
            raise NotImplementedError(
                "a NURBS surface beside an aux-bearing one (ZERNIKE_SAG, "
                "FORBES_QBFS, FORBES_Q2D): the kernels' tables carry a "
                "layout or a knot table, not both (ROADMAP Queue 2)")
        if coeffs.device.type == "cuda":
            for s, c in enumerate(cfg.geom_codes):
                over = c == geom.NURBS and _nurbs_bound(aux[s])
                if over:
                    raise NotImplementedError(
                        f"the kernels' nurbs build takes nets of at most "
                        f"NC_NURBS = {NC_NURBS} columns, degree NU_PMAX = "
                        f"{NU_PMAX} and NU_KMAX = {NU_KMAX} knots each way; "
                        f"surface {s} has {over}")
        kn = _knot_table(tuple(cfg.geom_codes), aux, dtype, coeffs.device)
        buf = torch.cat([coeffs.reshape(-1), kn.reshape(-1)])
        return buf[:S * nc].view(S, nc), buf[S * nc:].view(kn.shape)
    if not lays:
        if nc == 0:
            coeffs = coeffs.new_zeros((S, 1))
        return coeffs.contiguous(), None
    W = max([nc, 1] + [len(slots) for slots, _ in lays.values()])
    if W > NC_MAX:
        raise NotImplementedError(
            f"the kernels take at most NC_MAX = {NC_MAX} coefficient "
            f"columns; an aux-bearing surface's layout needs {W}")
    if W > nc and any(c in (geom.POLYNOMIAL_XY, geom.CHEBYSHEV)
                      for c in cfg.geom_codes):
        raise NotImplementedError(
            f"a Q2d layout of {W} slots beside a POLYNOMIAL_XY or CHEBYSHEV "
            f"table of width {nc}: the kernels read both from one width")
    rows = []
    for s in range(S):
        row = coeffs[s]
        if s in lays:
            row = row.new_tensor(lays[s][1]) @ row
        rows.append(torch.nn.functional.pad(row, (0, W - row.shape[0])))
    lay = _layout_table(tuple(cfg.geom_codes), aux, nc, W, dtype,
                        coeffs.device)
    buf = torch.cat(rows + [lay.reshape(-1)])
    return buf[:S * W].view(S, W), buf[S * W:].view(S, W, geom.LAY_COLS)


def sag_surfaces(codes, build=STOCK, grat=()):
    """The surfaces that own a block of a backward's partial rows, in
    order (the k-th of them the k-th block): those of a Newton family, in
    the grating build the gratings (``grat``, their flags), in the nurbs
    build the NURBS surfaces."""
    if build & BIT_GRAT:
        return tuple(s for s, g in enumerate(grat) if g)
    if build & BIT_NURBS:
        return tuple(s for s, c in enumerate(codes) if c == geom.NURBS)
    return tuple(s for s, c in enumerate(codes) if c in geom.NEWTON_CODES)


def block_width(nc, build):
    """Columns of a surface's block in a backward's partial rows: a Newton
    or NURBS surface's nc coefficient columns, then in the builds with the
    Cartesian branch its P_G1 and P_G2 columns; a grating's P_G1 and P_G2
    columns in the grating build."""
    if build & BIT_GRAT:
        return len(CART_COLS)
    return nc + 2 if build & BIT_CART else nc


def sag_columns(codes, nc, build, grat=()):
    """Columns of all the blocks of a backward's partial rows."""
    return len(sag_surfaces(codes, build, grat)) * block_width(nc, build)


def build_of(codes, tilted, inner=(), grat=()):
    """The build a spec launches: the least one that compiles in each
    branch it takes (TILT a tilted surface, SAG a radial asphere or an
    annular clip (``inner``), FREE a Cartesian surface, AUX an aux-bearing
    one, NURBS a NURBS surface, GRAT a grating (``grat``, its flags)) and,
    past STOCK_SURF surfaces, the deep reach. Raises NotImplementedError
    for a NURBS surface or a grating beside a branch that the nurbs or
    grating build does not compile in."""
    if geom.NURBS in codes:
        beside = sorted({CODE_NAMES[c] for c in codes
                         if c in geom.NEWTON_CODES})
        if any(grat):
            beside.append("a grating")
        if any(inner):
            beside.append("an annular clip (a RadialAperture with r_min > 0)")
        if len(codes) > STOCK_SURF:
            beside.append(f"{len(codes)} surfaces (more than STOCK_SURF = "
                          f"{STOCK_SURF})")
        if beside:
            raise NotImplementedError(
                "the kernels' nurbs build takes NURBS surfaces beside PLANE "
                f"and STANDARD surfaces only, at most STOCK_SURF = "
                f"{STOCK_SURF} surfaces, no grating and no annular clip; this "
                f"system has a NURBS surface beside {', '.join(beside)} "
                "(ROADMAP Queue 2)")
        return NURBS
    if any(grat):
        beside = sorted({CODE_NAMES[c] for c in codes
                         if c in geom.NEWTON_CODES})
        if any(inner):
            beside.append("an annular clip (a RadialAperture with r_min > 0)")
        if len(codes) > STOCK_SURF:
            beside.append(f"{len(codes)} surfaces (more than STOCK_SURF = "
                          f"{STOCK_SURF})")
        if beside:
            raise NotImplementedError(
                "the kernels' grating build takes gratings beside PLANE and "
                f"STANDARD surfaces only, at most STOCK_SURF = {STOCK_SURF} "
                "surfaces and no annular clip; this system has a grating "
                f"beside {', '.join(beside)} (ROADMAP Queue 2)")
        return GRAT
    build = TILT if any(tilted) else STOCK
    if any(c in geom.RADIAL_CODES for c in codes) or any(inner):
        build |= SAG
    if any(c in geom.CART_CODES for c in codes):
        build |= FREE
    if any(c in geom.AUX_CODES for c in codes):
        build |= AUX
    if len(codes) > STOCK_SURF:
        build |= DEEP
    return build


# The stock and tilt builds of merit_bwd and trace_bwd sum per thread
# (csrc/fused_trace.cuh, csrc/fast_trace.cuh: Build::PT): each thread keeps
# its rays' sums of the slots of surfaces 1 .. S-1, of the object row's
# n_post slot and of the aim entries in dynamic shared memory, and each
# warp a row of the dispersion coefficient columns (poly), so their block
# follows from the bytes (bwd_shape) and their grid from the kernel's
# occupancy (bwd_grid). Per mode: the slots per surface (GRAD_COLS,
# FULL_GRAD_COLS), whether the aim entries follow, and whether the
# dispersion coefficients do.
BWD_MODES = {"merit": (len(GRAD_COLS), True, False),
             "field": (len(FULL_GRAD_COLS), True, False),
             "generic": (len(FULL_GRAD_COLS), False, False),
             "poly": (len(FULL_GRAD_COLS), False, True)}


def per_thread(build):
    """True for the builds whose backwards sum per thread: stock and
    tilt."""
    return build in (STOCK, TILT)


# The nurbs build's backwards (csrc/nurbs_step.cuh) keep each NURBS
# surface's stopped (u, v) from their forward sweep, and each warp stages
# its rays' records (the spans, basis values and net cotangents at both
# points) in shared memory, where each lane sums the net columns it owns,
# beside their per-warp rows and the nets' tables: the block follows from
# those bytes (nurbs_bwd_bytes) and the grid from the kernel's occupancy
# (bwd_grid). NU_PT: a record's values per point.
NU_PT = 12 + 4 * (NU_PMAX + 1)


def _vec4(n):
    """n values rounded up to whole 4-vectors (csrc/nurbs_step.cuh:
    nu_net_stride)."""
    return (n + 3) // 4 * 4


def nurbs_bytes(ns, nc, kt, dtype):
    """Dynamic shared memory of the nurbs build's tables (csrc/
    nurbs_step.cuh: nurbs_bytes): the kt rows of the knot table with its
    tail (``knot_rows``), then the homogeneous nets of ns surfaces of nc
    net columns, each rounded up to 4-vectors (a forward, whose launch
    does not count the NURBS surfaces, takes room for S)."""
    return (kt * NU_KT + ns * _vec4(nc)) * (torch.finfo(dtype).bits // 8)


def nurbs_bwd_bytes(block, ncomp, ns, nc, kt, dtype):
    """Dynamic shared memory of a nurbs-build backward of ``block`` threads
    (csrc/nurbs_step.cuh: nurbs_bwd_bytes): the per-warp rows of ncomp
    columns (rounded up to 4-vectors), the tables of its ns NURBS surfaces
    (``nurbs_bytes``), and each lane's staged record (2 NU_PT values and 4
    int spans)."""
    size = torch.finfo(dtype).bits // 8
    return (_vec4(block // 32 * ncomp) * size + nurbs_bytes(ns, nc, kt, dtype)
            + block * (2 * NU_PT * size + 16))


def bwd_shape(S, nm, mode, dtype, block=BWD_BLOCK):
    """(block, dynamic shared bytes) of a per-thread-sum backward of S
    surfaces in ``mode`` ("merit", "field", "generic" or "poly", with nm
    dispersion coefficients per surface) and ``dtype``: the largest
    multiple of 32 up to ``block`` whose threads' columns and warps'
    dispersion rows fit in SMEM_MAX less SMEM_STATIC. Raises ValueError for a ``block`` that
    is not a multiple of 32 from 32 to BWD_BLOCK, NotImplementedError
    where 32 threads do not fit."""
    block = int(block)
    if block % 32 or not 32 <= block <= BWD_BLOCK:
        raise ValueError(f"the backward block must be a multiple of 32 from "
                         f"32 to {BWD_BLOCK} threads, got {block}")
    slots, aim, poly = BWD_MODES[mode]
    size = torch.finfo(dtype).bits // 8
    # each thread's columns, and each warp's row of dispersion columns
    per = ((S - 1) * slots + 1 + (N_AIM if aim else 0)) * size
    per_warp = (S * nm if poly else 0) * size
    room = SMEM_MAX - SMEM_STATIC

    def nbytes(b):
        return b * per + b // 32 * per_warp

    while block > 32 and nbytes(block) > room:
        block -= 32
    if nbytes(block) > room:
        raise NotImplementedError(
            f"a {mode} backward of {S} surfaces needs {nbytes(32)} bytes of "
            f"shared memory at 32 threads, more than the {room} bytes a "
            "block has for them")
    return block, nbytes(block)


@functools.lru_cache(maxsize=None)
def _resident(name, dtype, build, mode, block, dyn, device):
    """Resident blocks per SM of backward ``name`` (a per-thread-sum,
    Newton or nurbs build; pol_bwd in any, ``mode`` "full" or
    "intensity") at ``block`` threads and ``dyn`` bytes, from the
    occupancy calculator, and the card's SM count."""
    import ctypes

    from optiland_torch.ops import _cuda

    n = ctypes.c_int(0)
    args = (build, block, dyn, ctypes.byref(n))
    if name == "pol_bwd":
        args = (("full", "intensity").index(mode),) + args
    elif name != "merit_bwd":
        args = (("generic", "field", "poly").index(mode),) + args
    with torch.cuda.device(device):
        _cuda.check(_cuda.call(entry_name(name + "_occupancy", build), dtype,
                               *args), name)
    if n.value < 1:
        raise RuntimeError(f"{name} fits no block of {block} threads and "
                           f"{dyn} bytes of shared memory on an SM")
    return n.value, torch.cuda.get_device_properties(device).multi_processor_count


def nurbs_shape(ns, nc, kt, ncomp, dtype, block=BWD_BLOCK):
    """(block, dynamic shared bytes) of a nurbs-build backward (ns NURBS
    surfaces of nc net columns, a knot table of kt rows, ncomp columns of
    its partial rows): the largest multiple of 32 up to ``block`` whose
    bytes (``nurbs_bwd_bytes``) fit in SMEM_MAX less SMEM_STATIC. Raises
    NotImplementedError where 32 threads do not fit."""
    room = SMEM_MAX - SMEM_STATIC
    while block > 32 and nurbs_bwd_bytes(block, ncomp, ns, nc, kt,
                                         dtype) > room:
        block -= 32
    need = nurbs_bwd_bytes(block, ncomp, ns, nc, kt, dtype)
    if need > room:
        raise NotImplementedError(
            f"a nurbs-build backward of {ns} NURBS surfaces ({nc} net "
            f"columns, {ncomp} partial columns) needs {need} bytes of shared "
            f"memory at 32 threads, more than the {room} bytes a block has "
            "for them")
    return block, need


def newton_bwd_bytes(block, ncomp, build, dtype):
    """Dynamic shared memory of a Newton build's backward of ``block``
    threads (csrc/step.cuh: Build::DYN, dyn_bytes): its per-warp rows of
    ncomp columns where they are dynamic (the Cartesian and deep builds),
    none in the sag build, whose rows are static."""
    if not build & (BIT_CART | BIT_DEEP):
        return 0
    return block // 32 * ncomp * (torch.finfo(dtype).bits // 8)


def pol_bwd_bytes(block, ncomp, build, dtype, nc=0, kt=0, ns=0):
    """Dynamic shared memory of pol_bwd of ``block`` threads (csrc/
    pol_trace.cuh: bwd_launch): in the nurbs build ``nurbs_bwd_bytes``, in
    the Newton builds the per-warp rows of ncomp columns, none in the stock
    and tilt builds, whose rows are static."""
    if build == NURBS:
        return nurbs_bwd_bytes(block, ncomp, ns, nc, kt, dtype)
    if build & BIT_SAG:
        return block // 32 * ncomp * (torch.finfo(dtype).bits // 8)
    return 0


def bwd_grid(name, mode, S, nm, dtype, build, R, device, block=BWD_BLOCK,
             nc=0, ncomp=0, kt=0, ns=0):
    """(block, blocks, dynamic bytes) of backward ``name`` (merit_bwd or
    trace_bwd, ``mode`` as bwd_shape's; pol_bwd, ``mode`` "full" or
    "intensity") launched for R rays on ``device``: pol_bwd in every build
    ``block`` with ``pol_bwd_bytes``; in the per-thread-sum builds the
    block of ``bwd_shape``, in the nurbs build that of ``nurbs_shape`` (ns
    NURBS surfaces of nc net columns, a knot table of kt rows:
    ``knot_rows``, ncomp columns of the partial rows; ValueError without
    them), in the Newton builds (sag, free, aux
    and the deep ones) ``block`` with the bytes of its per-warp rows
    (``newton_bwd_bytes``), each with one wave of blocks (the resident
    blocks per SM times the SMs, no more than the rays need), fixed for a
    card, build, dtype and shape, so that two launches give the same
    bits; in the grating build ``block`` and the grid of BWD_MAX_BLOCKS x
    BWD_BLOCK threads, whose per-warp rows size their shared memory
    themselves."""
    if build == NURBS and (kt <= S or ns < 1):
        raise ValueError("a nurbs-build backward's shape needs its NURBS "
                         "surfaces and its knot table's rows (knot_rows)")
    if name == "pol_bwd":
        dyn = pol_bwd_bytes(block, ncomp, build, dtype, nc, kt, ns)
    elif build == NURBS:
        block, dyn = nurbs_shape(ns, nc, kt, ncomp, dtype, block)
    elif build & BIT_SAG:
        dyn = newton_bwd_bytes(block, ncomp, build, dtype)
    elif not per_thread(build):
        nb = min(-(-R // block), BWD_MAX_BLOCKS * (BWD_BLOCK // block))
        return block, max(1, nb), 0
    else:
        block, dyn = bwd_shape(S, nm, mode, dtype, block)
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    per_sm, sms = _resident(name, dtype, build, mode, block, dyn, index)
    return block, max(1, min(-(-R // block), per_sm * sms)), dyn


def launch_from_pupil(aim, Px, Py):
    """(x, y, z, L, M, N) of the rays launched from pupil samples (Px, Py)
    by the aim vector."""
    x = Px * aim[A_SX] + aim[A_X0]
    y = Py * aim[A_SY] + aim[A_Y0]
    z = torch.zeros_like(Px) + aim[A_Z0]
    L = torch.zeros_like(Px) + aim[A_L]
    M = torch.zeros_like(Px) + aim[A_M]
    N = torch.zeros_like(Px) + aim[A_N]
    return x, y, z, L, M, N


def check_dtype(dtype):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernels take float32 or float64, not {dtype}")


def flags(rows, device):
    """int32 device tensor of a spec's per-surface flag rows, one after the
    other: geometry codes, reflective flags (and any further flags)."""
    return static_tensor(tuple(int(v) for part in rows for v in part),
                         torch.int32, device)


def with_builds(names, builds=TRACE_BUILDS):
    """Launch-count keys for kernels ``names``: each kernel in each of
    ``builds`` (``launch_key``), each a separately compiled kernel."""
    return {launch_key(n, b): 0 for n in names for b in builds}


def entry_name(name, build):
    """The C entry of kernel ``name`` for ``build``: the nurbs build's
    kernels are compiled in sources of their own (``csrc/nurbs_*.cu``),
    whose entries carry "_nurbs" after the name."""
    return name + "_nurbs" if build == NURBS else name


def launch_key(name, build):
    """The launch-count key of kernel ``name`` launched in ``build``."""
    return name + BUILD_SUFFIX[build]


def device_of(device, name):
    """'cuda' or 'cpu': where the wrapper ``name`` runs for ``device``."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on 'cuda' or 'cpu', not {device}")
    return device.type


def check_cuda_inputs(params, spec, arrays=(), aim=None, coeffs=None,
                      lay=None):
    """Raise unless the kernels can take these inputs: a float32 or float64
    (S, NUM_P) param table, one spec entry per surface of a covered
    geometry (and a nonnegative Newton iteration count, the spec's last
    entry), the aim vector and flat per-ray arrays (None entries skipped)
    of the table's dtype and device, contiguous, the (S, nc)
    coefficient table, 1 <= nc <= NC_MAX (NC_NURBS with a NURBS surface),
    with an aux-bearing surface the (S, nc, LAY_COLS) layout table ``lay``
    and with a NURBS surface the (S + E, NU_KT) knot table with its tail
    (``kernel_tables``: E >= 1)."""
    S = len(spec[0])
    check_dtype(params.dtype)
    if S > MAX_SURF:
        raise NotImplementedError(f"the kernels take at most {MAX_SURF} "
                                  f"surfaces, got {S}")
    if any(len(part) != S for part in spec[:-1]) or not (
            isinstance(spec[-1], int) and spec[-1] >= 0):
        raise ValueError("the spec must hold one entry per surface in each "
                         "of its parts, then the Newton iteration count")
    if any(c not in geom.SUPPORTED_CODES for c in spec[0]):
        raise NotImplementedError(
            f"geometry codes {spec[0]}: the kernels cover {FAMILY_NAMES} "
            "(the other families: ROADMAP Queue 2)"
        )
    if coeffs is None:
        return
    if (coeffs.device != params.device or coeffs.dtype != params.dtype
            or not coeffs.is_contiguous() or coeffs.dim() != 2
            or coeffs.shape[0] != S or coeffs.shape[1] < 1):
        raise ValueError(f"the coefficient table must be a contiguous "
                         f"(S, nc) {params.dtype} tensor on {params.device}, "
                         "nc >= 1")
    nurbs = geom.NURBS in spec[0]
    if coeffs.shape[1] > (NC_NURBS if nurbs else NC_MAX):
        raise NotImplementedError(
            f"the kernels take at most NC_MAX = {NC_MAX} coefficient "
            f"columns (NC_NURBS = {NC_NURBS} in the nurbs build), got "
            f"{coeffs.shape[1]}")
    if nurbs and (lay is None or lay.device != params.device
                  or lay.dtype != params.dtype or not lay.is_contiguous()
                  or lay.dim() != 2 or lay.shape[0] <= S
                  or lay.shape[1] != NU_KT):
        raise ValueError(f"a NURBS surface needs the contiguous (S + E, "
                         f"{NU_KT}) {params.dtype} knot table with its tail "
                         f"on {params.device} (kernel_tables)")
    if any(c in geom.AUX_CODES for c in spec[0]) and (
            lay is None or lay.device != params.device
            or lay.dtype != params.dtype or not lay.is_contiguous()
            or tuple(lay.shape) != (S, coeffs.shape[1], geom.LAY_COLS)):
        raise ValueError(f"an aux-bearing surface needs the contiguous (S, "
                         f"nc, {geom.LAY_COLS}) {params.dtype} layout table "
                         f"on {params.device} (kernel_tables)")
    arrays = [a for a in arrays if a is not None]
    named = [("params", params), ("aim", aim)] + [
        (f"ray array {k}", a) for k, a in enumerate(arrays)
    ]
    for name, t in named:
        if t is None:
            continue
        if t.device != params.device or t.dtype != params.dtype:
            raise ValueError(f"{name} must be {params.dtype} on {params.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if arrays and any(tuple(a.shape) != (arrays[0].shape[0],) for a in arrays):
        raise ValueError("the ray arrays must be flat and of one length")
    if tuple(params.shape) != (S, NUM_P) or (
        aim is not None and tuple(aim.shape) != (N_AIM,)
    ):
        raise ValueError("params must be (S, NUM_P) and aim (N_AIM,)")
