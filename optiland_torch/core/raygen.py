"""Ray generation: field vignetting factors.

Counterpart of ``optiland_tpu/core/raygen.py``. This slice needs only
``get_vig_factor``, which the fused merit's aim vector reads;
``generate_rays`` and the field types come with the reference trace in the
next slice.
"""

from __future__ import annotations

import torch

from optiland_torch.core.system import System, scalar_like


def get_vig_factor(system: System, Hx, Hy):
    """Nearest-neighbor interpolation of per-field vignetting factors."""
    fx, fy = system.field_x, system.field_y
    Hx = scalar_like(Hx, fx)
    Hy = scalar_like(Hy, fx)
    max_field = torch.max(torch.sqrt(fx**2 + fy**2))
    scale = torch.where(max_field == 0, 1.0, max_field)
    nx = fx / scale
    ny = fy / scale
    d2 = (Hx[..., None] - nx) ** 2 + (Hy[..., None] - ny) ** 2
    idx = torch.argmin(d2, dim=-1)
    # take, not vig_x[idx]: indexing with a 0-d tensor reads it on the host
    return torch.take(system.vig_x, idx), torch.take(system.vig_y, idx)
