"""Paraxial engine: the generic y/u trace, ABCD prefix products and the
entrance-pupil scalars.

Counterpart of ``optiland_tpu/core/paraxial.py`` for the launch side of the
fused merit: ``_paraxial_arrays``, ``trace_generic``, ``abcd_prefix``,
``pupil_scalars``, ``f2`` and the pupil functions ``EPL``, ``XPL`` and
``EPD``. The JAX package forms the prefix products with
``jax.lax.associative_scan``; here a sequential product of 2x2 matrices does
the same, and autograd runs through it. The remaining cardinal points come
with the rest of the paraxial module in a later slice.
"""

from __future__ import annotations

import torch

from optiland_torch.core import geometry as geom
from optiland_torch.core.system import (
    System, n_all, n_of, positions, scalar_like, static_tensor,
)


def _paraxial_arrays(system: System, wavelength=None):
    """Radii, indices, positions, reflect flags for the paraxial trace."""
    stack, cfg = system.stack, system.cfg
    w = system.primary_wavelength if wavelength is None else wavelength
    R = stack.radius
    # toroidal surfaces: the meridional radius sits in geo_p1
    if any(c == geom.TOROIDAL for c in cfg.geom_codes):
        tor = static_tensor([c == geom.TOROIDAL for c in cfg.geom_codes],
                            torch.bool, R.device)
        R = torch.where(tor, stack.geo_p1, R)
    n = n_all(stack, cfg, w)
    pos = positions(stack)
    refl = list(cfg.reflective)
    return R, n, pos, refl


def trace_generic(system: System, y, u, z, wavelength=None,
                  reverse: bool = False, skip: int = 0):
    """Trace a generic paraxial ray; returns per-surface (heights, slopes).

    The object surface contributes its row without propagation; reverse
    flips the system (R -> -flip(R), n -> flip(roll(n,1)),
    pos -> pos[-1] - flip(pos)).
    """
    R, n, pos, refl = _paraxial_arrays(system, wavelength)
    cfg = system.cfg
    S = cfg.num_surfaces
    is_object = [i == 0 for i in range(S)]
    inter = list(cfg.interactions) if cfg.interactions is not None else [None] * S
    f_thin = system.stack.geo_p1

    if reverse:
        R = -torch.flip(R, (0,))
        n = torch.flip(torch.roll(n, 1), (0,))
        pos = pos[-1] - torch.flip(pos, (0,))
        refl = refl[::-1]
        is_object = is_object[::-1]
        inter = inter[::-1]
        f_thin = torch.flip(f_thin, (0,))

    power = torch.diff(n, prepend=n[:1]) / R

    def vec(v):
        return torch.atleast_1d(scalar_like(v, R))

    y_, u_, z_ = torch.broadcast_tensors(vec(y), vec(u), vec(z))

    heights, slopes = [], []
    for k in range(skip, S):
        if is_object[k]:
            heights.append(y_)
            slopes.append(u_)
            continue
        t = pos[k] - z_
        z_ = torch.broadcast_to(pos[k], z_.shape)
        y_ = y_ + t * u_
        is_thin = inter[k] is not None and inter[k][0] == "thin_lens"
        if refl[k]:
            if is_thin:
                f = -f_thin[k] if reverse else f_thin[k]
                u_ = -u_ - y_ / f
            else:
                u_ = -u_ - 2 * y_ / R[k]
        else:
            if is_thin:
                u_ = (n[k - 1] * u_ - y_ / f_thin[k]) / n[k]
            else:
                u_ = (n[k - 1] * u_ - y_ * power[k]) / n[k]
        heights.append(y_)
        slopes.append(u_)

    return torch.stack(heights), torch.stack(slopes)


def abcd_prefix(system: System, wavelength=None):
    """Prefix products of per-surface ray-transfer (ABCD) matrices.

    Returns P of shape (S, 2, 2): P[k] maps (y, u) at the surface-1 vertex
    plane (object space) to (y, u) just after surface k. P[0] = identity.
    """
    cfg = system.cfg
    S = cfg.num_surfaces
    R, n, pos, _ = _paraxial_arrays(system, wavelength)
    dev = R.device
    refl = static_tensor(cfg.reflective, torch.bool, dev)
    inter = cfg.interactions if cfg.interactions is not None else (None,) * S
    thin = static_tensor([i is not None and i[0] == "thin_lens" for i in inter],
                         torch.bool, dev)
    f_thin = system.stack.geo_p1

    n_prev = torch.roll(n, 1)
    power = (n - n_prev) / R

    # refract: [[1, 0], [-power/n, n_prev/n]]; reflect: [[1, 0], [-2/R, -1]]
    c_refr = torch.where(thin, -1.0 / (f_thin * n), -power / n)
    d_refr = n_prev / n
    c_refl = torch.where(thin, -1.0 / f_thin, -2.0 / R)
    d_refl = -torch.ones_like(R)
    C = torch.where(refl, c_refl, c_refr)
    D = torch.where(refl, d_refl, d_refr)

    # Translation from the previous surface (surface 1: zero)
    t = pos - torch.roll(pos, 1)
    t = torch.cat([t[:1], t.new_zeros((1,)), t[2:]])

    ones = torch.ones_like(R)
    # step = refraction @ translation = [[1, t], [C, C t + D]]
    step = torch.stack(
        [torch.stack([ones, t], dim=-1), torch.stack([C, C * t + D], dim=-1)],
        dim=-2,
    )  # (S, 2, 2)
    eye = torch.eye(2, dtype=R.dtype, device=dev).expand(S, 2, 2)
    # object surface (row 0) contributes nothing
    is_obj = (torch.arange(S, device=dev) == 0)[:, None, None]
    step = torch.where(is_obj, eye, step)

    prods = [step[0]]
    for k in range(1, S):
        prods.append(step[k] @ prods[-1])
    return torch.stack(prods)


def pupil_scalars(system: System):
    """(EPL, EPD) from the ABCD prefix products."""
    cfg = system.cfg
    stack = system.stack
    stop_index = cfg.stop_index
    pos = positions(stack)
    P = abcd_prefix(system)

    # the entrance pupil is the object-space image of the stop: rays through
    # the stop center satisfy A y1 + B u1 = 0 with y1 = -u1 z_EP
    if stop_index == 1:
        epl = pos[1]
    else:
        epl = P[stop_index, 0, 1] / P[stop_index, 0, 0]

    ap = cfg.aperture_type
    v = system.aperture_value
    if ap == "EPD":
        epd = v
    elif ap == "imageFNO":
        f2v = -1.0 / P[-1, 1, 0]
        epd = f2v / v
    elif ap == "objectNA":
        n0 = n_of(cfg.mat_formulas[0], stack.mat_coeffs[0], stack.ntab[0],
                  system.primary_wavelength)
        u0 = torch.arcsin(v / n0)
        epd = 2 * (epl - pos[0]) * torch.tan(u0)
    elif ap == "float_by_stop_size":
        if cfg.obj_infinite:
            epd = v / P[stop_index, 0, 0]
        else:
            obj_z = pos[0]
            y_stop = (P[stop_index, 0, 0] * (-0.1 * obj_z)
                      + P[stop_index, 0, 1] * 0.1)
            u0 = 0.1 * v / y_stop
            epd = u0 * (epl - obj_z)
    else:
        raise ValueError(f"Unknown aperture type: {ap}")

    return epl, epd


def f2(system: System):
    """Back (effective) focal length."""
    pos = positions(system.stack)
    y, u = trace_generic(system, 1.0, 0.0, pos[1] - 1)
    return (-y[0] / u[-1])[0]


def EPL(system: System):
    """Entrance pupil location relative to surface 1."""
    stop_index = system.cfg.stop_index
    pos = positions(system.stack)
    if stop_index == 1:
        return pos[1]
    z0 = pos[-1] - pos[stop_index]
    skip = system.cfg.num_surfaces - stop_index
    y, u = trace_generic(system, 0.0, 0.1, z0, reverse=True, skip=skip)
    return (y[-1] / u[-1])[0]


def XPL(system: System):
    """Exit pupil location relative to the image surface."""
    stop_index = system.cfg.stop_index
    pos = positions(system.stack)
    y, u = trace_generic(system, 0.0, 0.1, pos[stop_index],
                         skip=stop_index + 1)
    return (-y[-1] / u[-1])[0]


def EPD(system: System):
    """Entrance pupil diameter, dispatched on the system aperture type."""
    ap = system.cfg.aperture_type
    v = system.aperture_value
    if ap == "EPD":
        return v
    if ap == "imageFNO":
        return f2(system) / v
    pos = positions(system.stack)
    if ap == "objectNA":
        stack, cfg = system.stack, system.cfg
        n0 = n_of(cfg.mat_formulas[0], stack.mat_coeffs[0], stack.ntab[0],
                  system.primary_wavelength)
        u0 = torch.arcsin(v / n0)
        return 2 * (EPL(system) - pos[0]) * torch.tan(u0)
    if ap == "float_by_stop_size":
        stop_index = system.cfg.stop_index
        if system.cfg.obj_infinite:
            y, _ = trace_generic(system, 1.0, 0.0, -1.0)
            return (v / y[stop_index])[0]
        obj_z = pos[0]
        epl = EPL(system)
        y, _ = trace_generic(system, 0.0, 0.1, obj_z)
        u0 = 0.1 * v / y[stop_index]
        return (u0 * (epl - obj_z))[0]
    raise ValueError(f"Unknown aperture type: {ap}")
