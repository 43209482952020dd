"""Launch side shared by the kernel op modules (``ops/fused_trace.py``,
``ops/fast_trace.py`` and ``ops/pol_trace.py``): the kernels' launch
shapes, the structure their step covers, the launch of a ray from its
pupil sample and the aim vector, the per-surface flag table, and the
checks a wrapper runs before it launches a kernel on a CUDA device."""

from __future__ import annotations

import torch

from optiland_torch.core import geometry as geom
from optiland_torch.core.system import static_tensor
from optiland_torch.ops.step import NUM_P

# The 8-scalar aim vector of an infinite-conjugate angle field: launch point,
# direction cosines and the pupil's semi-axes
N_AIM = 8
A_X0, A_Y0, A_Z0, A_L, A_M, A_N, A_SX, A_SY = range(N_AIM)

# Launch shapes of the kernels (csrc/step.cuh holds the same values).
FWD_BLOCK = 256  # rays per forward block
BWD_BLOCK = 128
BWD_MAX_BLOCKS = 1056  # fixed grid of the backwards' grid-stride loop
MAX_SURF = 16  # bound of the backwards' per-ray surface-state arrays


def covered(cfg, field=True, coated=False) -> bool:
    """True when the kernels' step covers this structure: PLANE and
    STANDARD surfaces, tilted or not, no aperture objects, interactions or
    BSDFs, at most MAX_SURF surfaces, and (with ``field``) an
    infinite-conjugate angle field, which the aim vector describes. The
    unpolarized kernels take no coatings and no polarization; ``coated``
    asks for the polarized kernels, which take both (their coat kinds are
    checked by ``ops/pol_trace.py``)."""

    def all_none(vals):
        return vals is None or all(v is None for v in vals)

    return (
        all(c in geom.SUPPORTED_CODES for c in cfg.geom_codes)
        and all_none(cfg.apertures)
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
        f"{what} covers PLANE/STANDARD systems of at most {MAX_SURF} surfaces "
        "(tilted or not) without aperture objects or interactions; the "
        "other families of kernel K6 come in a later slice"
    )


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


def flags(spec, device):
    """int32 device tensor of the spec's per-surface entries, one after the
    other: geometry codes, reflective flags (and any further flags)."""
    return static_tensor(tuple(int(v) for part in spec for v in part),
                         torch.int32, device)


def with_tilt(names):
    """Launch-count keys for kernels ``names``: each kernel and its TILT
    instantiation (``name + "_tilt"``), a separately compiled kernel
    launched for a spec with a tilted surface."""
    return {k: 0 for n in names for k in (n, n + "_tilt")}


def launch_key(name, tilt):
    """The launch-count key of kernel ``name`` launched with ``tilt``."""
    return name + "_tilt" if tilt else name


def device_of(device, name):
    """'cuda' or 'cpu': where the wrapper ``name`` runs for ``device``."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on 'cuda' or 'cpu', not {device}")
    return device.type


def check_cuda_inputs(params, spec, arrays=(), aim=None):
    """Raise unless the kernels can take these inputs: a float32 or float64
    (S, NUM_P) param table, one spec entry per surface of a covered
    geometry, and the aim vector and flat per-ray arrays (None entries
    skipped) of the table's dtype and device, contiguous."""
    S = len(spec[0])
    check_dtype(params.dtype)
    if S > MAX_SURF:
        raise ValueError(f"the kernels take at most {MAX_SURF} surfaces, "
                         f"got {S}")
    if any(len(part) != S for part in spec):
        raise ValueError("the spec must hold one entry per surface in each "
                         "of its parts")
    if any(c not in geom.SUPPORTED_CODES for c in spec[0]):
        raise NotImplementedError(
            f"geometry codes {spec[0]}: the kernels cover PLANE and STANDARD"
        )
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
