"""Ray generation: field vignetting, ray origins and paraxial ray aiming.

Counterpart of ``optiland_tpu/core/raygen.py``: ``get_vig_factor``,
``get_ray_origins`` for the ``angle`` field type at infinite and finite
conjugates, ``aim_rays_paraxial`` and ``generate_rays``. Pupil locations
come from the differentiable paraxial engine, so gradients flow from spot
positions back to lens parameters through the aiming itself. The
object-height and image-height field types and apodization come in a later
slice and raise.
"""

from __future__ import annotations

import torch

from optiland_torch.core import paraxial
from optiland_torch.core.rays import RealRays
from optiland_torch.core.system import System, positions, scalar_like


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


def get_ray_origins(system: System, Hx, Hy, Px, Py, vx, vy, epl=None,
                    epd=None):
    """Ray origin positions for the configured field definition."""
    ft = system.cfg.field_type
    fx, fy = system.field_x, system.field_y
    max_field = torch.max(torch.sqrt(fx**2 + fy**2))
    field_x = max_field * Hx
    field_y = max_field * Hy
    pos = positions(system.stack)

    if ft == "angle":
        if epl is None:
            epl, epd = paraxial.pupil_scalars(system)
        if system.cfg.obj_infinite:
            offset = epd - torch.min(pos[1:-1])
            x = -torch.tan(torch.deg2rad(field_x)) * (offset + epl)
            y = -torch.tan(torch.deg2rad(field_y)) * (offset + epl)
            z = pos[1] - offset
            x0 = Px * epd / 2 * vx + x
            y0 = Py * epd / 2 * vy + y
            z0 = torch.zeros_like(Px) + z
        else:
            shape = torch.broadcast_shapes(Px.shape, field_x.shape)
            z0 = pos[0].expand(Px.shape)
            x0 = (-torch.tan(torch.deg2rad(field_x)) * (epl - pos[0])
                  ).expand(shape)
            y0 = (-torch.tan(torch.deg2rad(field_y)) * (epl - pos[0])
                  ).expand(shape)
        return x0, y0, z0

    raise NotImplementedError(
        f"field type {ft!r}: the object-height and image-height field types "
        "are ported in a later slice (ROADMAP Queue 1 item 4)"
    )


def aim_rays_paraxial(system: System, Hx, Hy, Px, Py):
    """Paraxial ray aiming at the entrance pupil."""
    like = system.stack.radius
    Hx, Hy, Px, Py = (torch.atleast_1d(scalar_like(v, like))
                      for v in (Hx, Hy, Px, Py))

    vxf, vyf = get_vig_factor(system, Hx, Hy)
    vx = 1 - vxf
    vy = 1 - vyf

    epl, epd = paraxial.pupil_scalars(system)
    x0, y0, z0 = get_ray_origins(system, Hx, Hy, Px, Py, vx, vy, epl=epl,
                                 epd=epd)

    if system.cfg.obj_telecentric:
        sin = system.aperture_value
        z = torch.sqrt(1 - sin**2) / sin + z0
        z1 = z
        x1 = Px * vx + x0
        y1 = Py * vy + y0
    else:
        x1 = Px * epd * vx / 2
        y1 = Py * epd * vy / 2
        z1 = torch.zeros_like(Px) + epl

    mag = torch.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2 + (z1 - z0) ** 2)
    is_zero = mag < 1e-9
    mag = torch.where(is_zero, 1.0, mag)
    L = torch.where(is_zero, 0.0, (x1 - x0) / mag)
    M = torch.where(is_zero, 0.0, (y1 - y0) / mag)
    N = torch.where(is_zero, 1.0, (z1 - z0) / mag)
    return x0, y0, z0, L, M, N


def generate_rays(system: System, Hx, Hy, Px, Py, wavelength,
                  apodization=None) -> RealRays:
    """Launch bundle for tracing: paraxially aimed rays of unit intensity
    at ``wavelength`` (um). Field and pupil coordinates broadcast against
    each other; they may be numbers, arrays or tensors."""
    if apodization is not None:
        raise NotImplementedError(
            "apodization is ported in a later slice (ROADMAP Queue 1 item 4)"
        )
    x0, y0, z0, L, M, N = aim_rays_paraxial(system, Hx, Hy, Px, Py)
    Px = torch.atleast_1d(scalar_like(Px, system.stack.radius))
    intensity = torch.ones_like(Px)
    wl = torch.ones_like(x0) * scalar_like(wavelength, x0)
    return RealRays.create(x0, y0, z0, L, M, N, intensity, wl)
