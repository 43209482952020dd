"""Launch side shared by the kernel op modules (``ops/fused_trace.py``,
``ops/fast_trace.py`` and ``ops/pol_trace.py``): the kernels' launch
shapes, the structure their step covers, the build each spec launches,
the launch of a ray from its pupil sample and the aim vector, the
per-surface flag table, and the checks a wrapper runs before it launches
a kernel on a CUDA device.

Every trace kernel is compiled in six builds (``csrc/step.cuh``), and a
launch takes the least one that covers its spec (``build_of``):

  * stock: PLANE and STANDARD surfaces, untilted, at most STOCK_SURF;
  * tilt: also the tilt rotations;
  * sag: also the radial Newton-from-sag families (EVEN_ASPHERE,
    ODD_ASPHERE), whose coefficient rows the kernels read, and in the full
    traces the annular clip on P_APMIN (a RadialAperture with r_min > 0);
  * free: also the Cartesian families (POLYNOMIAL_XY, CHEBYSHEV, TOROIDAL,
    BICONIC), whose backwards also sum the P_G1 and P_G2 columns;
  * deep: tilt and sag, for up to MAX_SURF surfaces;
  * deep_free: deep with the Cartesian families.

The Cartesian branch is a flag of its own beside the surface reach, so a
deep system without a freeform runs the deep code, which carries none of
it. A kernel counts its launches under ``launch_key(name, build)``: the
name, then "_tilt", "_sag", "_free", "_deep" or "_deep_free" for the five
other builds."""

from __future__ import annotations

import torch

from optiland_torch.core import geometry as geom
from optiland_torch.core.system import static_tensor
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

# the builds (csrc/step.cuh: B_STOCK .. B_DEEP_FREE) and their launch-key
# suffixes
STOCK, TILT, SAG, FREE, DEEP, DEEP_FREE = range(6)
BUILD_SUFFIX = ("", "_tilt", "_sag", "_free", "_deep", "_deep_free")
CART_BUILDS = (FREE, DEEP_FREE)  # the builds with the Cartesian branch


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

    return (
        all(c in geom.SUPPORTED_CODES for c in cfg.geom_codes)
        and radial_only(cfg.apertures)
        and all_none(cfg.interactions)
        and (coated or all_none(cfg.coatings))
        and all_none(cfg.bsdfs)
        and all_none(cfg.geom_aux)
        and (coated or not cfg.polarized)
        and cfg.num_surfaces <= MAX_SURF
        and (not field or (cfg.field_type == "angle"
                           and bool(cfg.obj_infinite)
                           and not cfg.obj_telecentric))
    )


def unsupported(what):
    """The error for a system that the kernels do not cover yet."""
    return NotImplementedError(
        f"{what} covers PLANE, STANDARD, EVEN_ASPHERE, ODD_ASPHERE, "
        "POLYNOMIAL_XY, CHEBYSHEV, TOROIDAL and BICONIC systems of at most "
        f"{MAX_SURF} surfaces (tilted or not) with no aperture objects but "
        "RadialAperture and no interactions; the other families of kernel "
        "K6 come in a later slice (ROADMAP Queue 2)"
    )


def sag_surfaces(codes):
    """The surfaces of a Newton family, in order: the k-th of them owns the
    k-th block of coefficient columns of a backward's partial rows."""
    return tuple(s for s, c in enumerate(codes) if c in geom.NEWTON_CODES)


def block_width(nc, build):
    """Columns of a Newton surface's block in a backward's partial rows:
    its nc coefficient columns, then in the free and deep_free builds its
    P_G1 and P_G2 columns."""
    return nc + 2 if build in CART_BUILDS else nc


def sag_columns(codes, nc, build):
    """Columns of all the Newton surfaces' blocks of a backward's partial
    rows."""
    return len(sag_surfaces(codes)) * block_width(nc, build)


def build_of(codes, tilted, inner=()):
    """The build a spec launches: past STOCK_SURF surfaces DEEP_FREE with
    a Cartesian surface, else DEEP; else FREE with a Cartesian surface,
    else SAG with a radial asphere or an annular clip (``inner``), else
    TILT with a tilted surface, else STOCK."""
    cart = any(c in geom.CART_CODES for c in codes)
    if len(codes) > STOCK_SURF:
        return DEEP_FREE if cart else DEEP
    if cart:
        return FREE
    if any(c in geom.RADIAL_CODES for c in codes) or any(inner):
        return SAG
    return TILT if any(tilted) else STOCK


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
    return {n + suf: 0 for n in names for suf in BUILD_SUFFIX}


def launch_key(name, build):
    """The launch-count key of kernel ``name`` launched in ``build``."""
    return name + BUILD_SUFFIX[build]


def device_of(device, name):
    """'cuda' or 'cpu': where the wrapper ``name`` runs for ``device``."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on 'cuda' or 'cpu', not {device}")
    return device.type


def check_cuda_inputs(params, spec, arrays=(), aim=None, coeffs=None):
    """Raise unless the kernels can take these inputs: a float32 or float64
    (S, NUM_P) param table, one spec entry per surface of a covered
    geometry (and a nonnegative Newton iteration count, the spec's last
    entry), the aim vector and flat per-ray arrays (None entries skipped)
    of the table's dtype and device, contiguous, and the (S, nc)
    coefficient table, 1 <= nc <= NC_MAX."""
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
            f"geometry codes {spec[0]}: the kernels cover PLANE, STANDARD, "
            "EVEN_ASPHERE, ODD_ASPHERE, POLYNOMIAL_XY, CHEBYSHEV, TOROIDAL "
            "and BICONIC (the other families: ROADMAP Queue 2)"
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
