"""Launch side shared by the kernel op modules (``ops/fused_trace.py``,
``ops/fast_trace.py`` and ``ops/pol_trace.py``): the kernels' launch
shapes, the structure their step covers, the build each spec launches,
the launch of a ray from its pupil sample and the aim vector, the
per-surface flag table, and the checks a wrapper runs before it launches
a kernel on a CUDA device.

Every trace kernel is compiled in eight builds (``csrc/step.cuh``), each an
OR of flag bits, and a launch takes the least one that covers its spec
(``build_of``):

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
    MAX_SURF surfaces.

Each branch is a flag of its own, so a system runs code that carries no
branch it does not use (the free builds compile to the code they had
before the aux-bearing families). A kernel counts its launches under
``launch_key(name, build)``: the name, then the build's suffix
(``BUILD_SUFFIX``: "_tilt", "_sag", "_free", "_aux", "_deep",
"_deep_free" or "_deep_aux"; none for the stock build).

An aux-bearing surface reads its coefficient row laid out
(``geom.aux_layout``) and the layout table that says how: ``kernel_tables``
forms both for a system, in one buffer, the row by a differentiable linear
map of the surface's own coefficients (so autograd takes the kernels'
coefficient gradient back through it), the table once per structure."""

from __future__ import annotations

import functools

import torch

from optiland_torch.core import geometry as geom
from optiland_torch.core.system import carried_aux, static_tensor
from optiland_torch.ops.step import NUM_P
from optiland_torch.physical_apertures import radial_only

# The 8-scalar aim vector of an infinite-conjugate angle field: launch point,
# direction cosines and the pupil's semi-axes
N_AIM = 8
A_X0, A_Y0, A_Z0, A_L, A_M, A_N, A_SX, A_SY = range(N_AIM)

# Launch shapes of the kernels (csrc/step.cuh holds the same values).
FWD_BLOCK = 256  # rays per forward block
BWD_BLOCK = 128
BWD_MAX_BLOCKS = 1056  # fixed grid of the backwards' grid-stride loop
STOCK_SURF = 16  # surfaces of the stock, tilt and sag builds
MAX_SURF = 64  # surfaces of the deep build: the kernels' bound
NC_MAX = 36  # coefficient columns the kernels take (a 6 x 6 table)

# the builds (csrc/step.cuh: B_STOCK .. B_DEEP_AUX): each an OR of the
# flag bits of the branches it compiles in and of its reach
BIT_TILT, BIT_SAG, BIT_CART, BIT_AUX, BIT_DEEP = 1, 2, 4, 8, 16
STOCK = 0
TILT = BIT_TILT
SAG = TILT | BIT_SAG
FREE = SAG | BIT_CART
DEEP = SAG | BIT_DEEP
DEEP_FREE = FREE | BIT_DEEP
AUX = FREE | BIT_AUX
DEEP_AUX = DEEP_FREE | BIT_AUX
# the launch-key suffix of each build
BUILD_SUFFIX = {STOCK: "", TILT: "_tilt", SAG: "_sag", FREE: "_free",
                DEEP: "_deep", DEEP_FREE: "_deep_free", AUX: "_aux",
                DEEP_AUX: "_deep_aux"}


def inner_flags(cfg):
    """Per surface: True where a RadialAperture has r_min > 0 (the JAX
    package's ``inner`` spec entry)."""
    return tuple(a is not None and float(getattr(a, "r_min", 0.0)) > 0.0
                 for a in (cfg.apertures or (None,) * cfg.num_surfaces))


def covered(cfg, field=True, coated=False) -> bool:
    """True when the kernels' step covers this structure: PLANE, STANDARD
    and the Newton families (the radial aspheres and the Cartesian
    freeforms) surfaces, tilted or not, RadialAperture
    objects and no others, no interactions or BSDFs, at most MAX_SURF
    surfaces, and (with ``field``) an infinite-conjugate angle field, which
    the aim vector describes. The unpolarized kernels take no coatings and
    no polarization; ``coated`` asks for the polarized kernels, which take
    both (their coat kinds are checked by ``ops/pol_trace.py``)."""

    def all_none(vals):
        return vals is None or all(v is None for v in vals)

    aux = cfg.geom_aux or (None,) * cfg.num_surfaces
    return (
        all(c in geom.SUPPORTED_CODES for c in cfg.geom_codes)
        and all(carried_aux(c, a) for c, a in zip(cfg.geom_codes, aux))
        and radial_only(cfg.apertures)
        and all_none(cfg.interactions)
        and (coated or all_none(cfg.coatings))
        and all_none(cfg.bsdfs)
        and (coated or not cfg.polarized)
        and cfg.num_surfaces <= MAX_SURF
        and (not field or (cfg.field_type == "angle"
                           and bool(cfg.obj_infinite)
                           and not cfg.obj_telecentric))
    )


# The geometry families the kernels cover, as the errors name them
FAMILY_NAMES = ("PLANE, STANDARD, EVEN_ASPHERE, ODD_ASPHERE, POLYNOMIAL_XY, "
                "CHEBYSHEV, TOROIDAL, BICONIC, ZERNIKE_SAG, FORBES_QBFS and "
                "FORBES_Q2D")


def unsupported(what):
    """The error for a system that the kernels do not cover yet."""
    return NotImplementedError(
        f"{what} covers {FAMILY_NAMES} systems of at most {MAX_SURF} "
        "surfaces (tilted or not) with no aperture objects but "
        "RadialAperture and no interactions; the other families of kernel "
        "K6 (grating, NURBS, grid sag) come in a later slice (ROADMAP "
        "Queue 2)"
    )


def lay_row(lay, code, s):
    """The slots of surface s's layout in the layout table ``lay`` for an
    aux-bearing ``code`` (which needs one), else None."""
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


def kernel_tables(system, dtype):
    """(coeffs, lay): the (S, W) coefficient table the kernels read and
    the (S, W, LAY_COLS) layout table of its aux-bearing rows (None
    without one), the two back to back in one buffer (``device_table``).
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


def sag_surfaces(codes):
    """The surfaces of a Newton family, in order: the k-th of them owns the
    k-th block of coefficient columns of a backward's partial rows."""
    return tuple(s for s, c in enumerate(codes) if c in geom.NEWTON_CODES)


def block_width(nc, build):
    """Columns of a Newton surface's block in a backward's partial rows:
    its nc coefficient columns, then in the builds with the Cartesian
    branch its P_G1 and P_G2 columns."""
    return nc + 2 if build & BIT_CART else nc


def sag_columns(codes, nc, build):
    """Columns of all the Newton surfaces' blocks of a backward's partial
    rows."""
    return len(sag_surfaces(codes)) * block_width(nc, build)


def build_of(codes, tilted, inner=()):
    """The build a spec launches: the least one that compiles in each
    branch it takes (TILT a tilted surface, SAG a radial asphere or an
    annular clip (``inner``), FREE a Cartesian surface, AUX an aux-bearing
    one) and, past STOCK_SURF surfaces, the deep reach."""
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


def with_builds(names):
    """Launch-count keys for kernels ``names``: each kernel in each build
    (``launch_key``), each a separately compiled kernel."""
    return {n + suf: 0 for n in names for suf in BUILD_SUFFIX.values()}


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
    coefficient table, 1 <= nc <= NC_MAX, and with an aux-bearing surface
    the (S, nc, LAY_COLS) layout table ``lay``."""
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
    if coeffs.shape[1] > NC_MAX:
        raise NotImplementedError(
            f"the kernels take at most NC_MAX = {NC_MAX} coefficient "
            f"columns, got {coeffs.shape[1]}")
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
