"""Real-ray trace engine: an unrolled loop over the surfaces in PyTorch.

Counterpart of ``optiland_tpu/core/trace.py`` (the unrolled engine; its
XLA path). Each surface step localizes the bundle, intersects and
propagates it, attenuates it in the medium before the surface
(Beer-Lambert), accumulates the optical path, clips it on the surface's
circular semi-aperture, refracts or reflects it, and globalizes it again.
Vignetted and TIR rays are masked by intensity, never removed. Gradients
come from autograd.

Coatings scale the intensity after the interaction. A polarized system
also carries each ray's 3x3 complex polarization matrix p through the
trace (``polarization.update_p`` with each coating's Jones matrix) and
returns it in the history under "p".

``trace`` sends a bundle on a CUDA device to the fused kernels when no
history is asked for and the wavelength is a concrete number, as the JAX
package sends it to its Pallas kernels on the TPU: a polarized system to
``ops/pol_trace.trace_fast_pol``, an unpolarized uncoated one to
``ops/fast_trace.trace_fast``. A system the JAX package's kernels would
take but the port's do not cover yet (a coefficient table wider than the
kernels' NC_MAX, or more than their MAX_SURF surfaces) raises there
instead of running this engine on the card; tilted surfaces, the Newton
families and annular apertures run on the kernels, as in the JAX package.
A polarized or coated
system that the JAX package's kernels would not take either (a coating
that is not kernel-eligible at the trace wavelength, an unpolarized system
with coatings) runs this engine, as the JAX package runs its XLA path.
The port covers PLANE, STANDARD, the radial aspheres (EVEN_ASPHERE,
ODD_ASPHERE) and the Cartesian freeforms (POLYNOMIAL_XY, CHEBYSHEV,
TOROIDAL, BICONIC, and ZERNIKE_SAG, FORBES_QBFS, FORBES_Q2D with their
``geom_aux`` extras) surfaces (the Newton families by Newton's method,
``geometry.NEWTON_ITERS`` steps, as the JAX package's XLA path),
``RadialAperture`` objects, whose clip replaces the circular one, and
grating interactions ``("grating", m)`` on PLANE and STANDARD substrates:
vector diffraction of order m (``kernels.grating_diffract``), evanescent
orders masked to zero intensity, for a wavelength per ray too and under
polarization. A mono grating system runs on the kernels' grating build;
a polychromatic or polarized one runs this engine, as in the JAX package,
whose poly and polarized kernels take no interaction either. The other
aperture objects, the thin lens and phase interactions and BSDFs come in
later slices and raise, and the scan engine (``trace_scan``) waits for
ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import numpy as np
import torch

from optiland_torch.core import geometry as geom
from optiland_torch.core.rays import RealRays
from optiland_torch.core.system import (
    System, is_grating, k_of, n_of, positions,
)
from optiland_torch.ops import kernels
from optiland_torch.physical_apertures import radial_only
from optiland_torch.polarization import complex_dtype, update_p

HISTORY_FIELDS = ("x", "y", "z", "L", "M", "N", "intensity", "opd")


def _check_structure(cfg):
    """Raise for the per-surface objects that later slices port: every
    aperture object but a ``RadialAperture`` (exactly that type), every
    interaction but a grating (thin lens, phase), and every BSDF."""
    if not radial_only(cfg.apertures):
        raise NotImplementedError(
            "physical aperture objects other than RadialAperture are ported "
            "in a later slice")
    if cfg.interactions is not None and not all(
            i is None or is_grating(i) for i in cfg.interactions):
        raise NotImplementedError(
            "surface interactions other than gratings (thin lens, phase) "
            "are ported in a later slice")
    if cfg.bsdfs is not None and any(b is not None for b in cfg.bsdfs):
        raise NotImplementedError("BSDF scattering is ported in a later "
                                  "slice")


def _surface_step(stack, cfg, s, pos_s, state):
    """Trace the ray bundle through surface ``s`` (static index)."""
    x, y, z, L, M, N, inten, opd, w, n_pre, p = state
    radius = stack.radius[s]
    conic = stack.conic[s]
    coeffs = stack.coeffs[s]
    code = cfg.geom_codes[s]

    # Localize (dz is the flattened z-decenter on top of the vertex)
    x = x - stack.dx[s]
    y = y - stack.dy[s]
    z = z - (pos_s + stack.dz[s])
    if cfg.has_tilts:
        x, y, L, M = kernels.rotate_z(x, y, L, M, -stack.rz[s])
        x, z, L, N = kernels.rotate_y(x, z, L, N, -stack.ry[s])
        y, z, M, N = kernels.rotate_x(y, z, M, N, -stack.rx[s])

    # Intersect + propagate
    p1, p2 = stack.geo_p1[s], stack.geo_p2[s]
    aux = cfg.geom_aux[s] if cfg.geom_aux is not None else None
    t = geom.distance_static(code, radius, conic, x, y, z, L, M, N,
                             coeffs=coeffs, p1=p1, p2=p2, aux=aux)
    x = x + t * L
    y = y + t * M
    z = z + t * N

    # Absorption in the pre-surface medium (Beer-Lambert; t mm, w um)
    if cfg.has_absorption:
        k_pre = k_of(stack.ktab[s - 1], w)
        inten = inten * torch.exp(-4 * np.pi * k_pre / w * t * 1e3)

    # OPD accumulation
    opd = opd + torch.abs(t * n_pre)

    # Physical aperture clip (local frame): the aperture object's, else
    # the circular semi-aperture
    ap_obj = cfg.apertures[s] if cfg.apertures is not None else None
    if ap_obj is not None:
        inten = ap_obj.clip(inten, x, y)
    else:
        ap = stack.ap_max[s]
        inten = torch.where(x**2 + y**2 > ap**2, 0.0, inten)

    # Normal + interaction
    nx, ny, nz = geom.surface_normal_static(code, radius, conic, coeffs, x, y,
                                            p1, p2, aux=aux)
    L0, M0, N0 = L, M, N  # pre-interaction directions
    inter = cfg.interactions[s] if cfg.interactions is not None else None
    if inter is not None:
        # grating diffraction of order m: period p1 (um), groove angle p2;
        # the groove frame reads the raw normal, the diffraction the one
        # aligned against the rays
        refl = bool(cfg.reflective[s])
        n_post = n_pre if refl else n_of(cfg.mat_formulas[s],
                                         stack.mat_coeffs[s], stack.ntab[s], w)
        f = kernels.grating_vector(code, radius, conic, p2, x, y, nx, ny, nz)
        nax, nay, naz, adot = kernels.align_normal(L, M, N, nx, ny, nz)
        L, M, N, ok = kernels.grating_diffract(
            L, M, N, nax, nay, naz, adot, f, p1, inter[1] * w, n_pre, n_post,
            refl)
        inten = torch.where(ok, inten, 0.0)  # evanescent orders
        n_next = n_post
    elif cfg.reflective[s]:
        L, M, N = kernels.reflect(L, M, N, nx, ny, nz)
        n_next = n_pre
    else:
        n_post = n_of(cfg.mat_formulas[s], stack.mat_coeffs[s],
                      stack.ntab[s], w)
        L, M, N = kernels.refract(L, M, N, nx, ny, nz, n_pre, n_post)
        n_next = n_post

    # Coating: intensity factor, then the Jones update of p
    coat = cfg.coatings[s] if cfg.coatings is not None else None
    if coat is not None:
        inten = inten * coat.intensity_factor(bool(cfg.reflective[s]))
    if p is not None:
        jones = coat.jones() if coat is not None else None
        jm = None
        if jones is not None:
            aoi = coat.compute_aoi(L0, M0, N0, nx, ny, nz)
            jm = jones.calculate_matrix(L0, M0, N0, L, M, N, w,
                                        reflect=bool(cfg.reflective[s]),
                                        aoi=aoi)
        p = update_p(p, L0, M0, N0, L, M, N, jm)

    # Globalize
    if cfg.has_tilts:
        y, z, M, N = kernels.rotate_x(y, z, M, N, stack.rx[s])
        x, z, L, N = kernels.rotate_y(x, z, L, N, stack.ry[s])
        x, y, L, M = kernels.rotate_z(x, y, L, M, stack.rz[s])
    x = x + stack.dx[s]
    y = y + stack.dy[s]
    z = z + pos_s + stack.dz[s]

    return (x, y, z, L, M, N, inten, opd, w, n_next, p)


def trace(system: System, rays: RealRays, record: bool = True, key=None,
          wavelength=None):
    """Trace a ray bundle through every surface of the system.

    Args:
        system: the compiled system.
        rays: launch bundle (global coordinates, object space).
        record: if True, also return the per-surface history stacked with
            the launch state as row 0.
        key: accepted for the JAX package's signature; it seeds BSDF
            scattering, which a later slice ports.
        wavelength: optional concrete scalar (Python/NumPy number). When it
            is given, the bundle lies on a CUDA device and ``record`` is
            False, the trace runs on the fused kernels
            (``ops/pol_trace.trace_fast_pol`` for a polarized system whose
            coatings are kernel-eligible at this wavelength,
            ``ops/fast_trace.trace_fast`` for an uncoated unpolarized one),
            with the same semantics, tilted surfaces included. For a
            system they do not cover yet (past their MAX_SURF surfaces or
            NC_MAX coefficient columns) it raises NotImplementedError,
            as the JAX package's kernels cover those: it never runs the
            plain engine on the card in their place. With ``record``, on
            the CPU, or for a system the JAX package's kernels would not
            take either, this engine traces the bundle.

    Returns:
        (final_rays, history): history is a dict of (S, R) tensors (x, y, z,
        L, M, N, intensity, opd), or None when record is False. For a
        polarized system it also holds the final (R, 3, 3) complex
        polarization matrices under "p", and the final rays carry the
        launch directions as L0, M0, N0.
    """
    stack, cfg = system.stack, system.cfg
    _check_structure(cfg)
    coated = cfg.coatings is not None and any(
        c is not None for c in cfg.coatings)
    if (
        not record
        and key is None
        and isinstance(wavelength, (int, float, np.floating))
        and rays.x.device.type == "cuda"
    ):
        from optiland_torch.ops import fast_trace, pol_trace
        from optiland_torch.ops.launch import grating_flags

        wl = float(wavelength)
        # the polarized kernels take no grating, as the JAX package's
        if (cfg.polarized and not any(grating_flags(cfg))
                and pol_trace.kernel_eligible(system, wl)):
            out, p = pol_trace.trace_fast_pol(system, rays, wl)
            return out.replace(L0=rays.L, M0=rays.M, N0=rays.N), {"p": p}
        if not cfg.polarized and not coated:
            return fast_trace.trace_fast(system, rays, wl), None

    n0 = n_of(cfg.mat_formulas[0], stack.mat_coeffs[0], stack.ntab[0], rays.w)
    p = None
    if cfg.polarized:
        R = rays.x.shape[0]
        p = torch.eye(3, dtype=complex_dtype(rays.x.dtype),
                      device=rays.x.device).expand(R, 3, 3)
    state = (rays.x, rays.y, rays.z, rays.L, rays.M, rays.N, rays.i,
             rays.opd, rays.w, n0, p)
    pos = positions(stack)

    recs = []
    for s in range(1, cfg.num_surfaces):
        state = _surface_step(stack, cfg, s, pos[s], state)
        if record:
            recs.append(state[:8])

    x, y, z, L, M, N, inten, opd, w, _, p = state
    out = RealRays(x=x, y=y, z=z, L=L, M=M, N=N, i=inten, w=w, opd=opd)
    if cfg.polarized:
        out = out.replace(L0=rays.L, M0=rays.M, N0=rays.N)

    history = None
    if record:
        launch = (rays.x, rays.y, rays.z, rays.L, rays.M, rays.N, rays.i,
                  rays.opd)
        history = {
            name: torch.stack(
                torch.broadcast_tensors(launch[k], *[r[k] for r in recs]),
                dim=0,
            )
            for k, name in enumerate(HISTORY_FIELDS)
        }
        if cfg.polarized:
            history["p"] = p
    elif cfg.polarized:
        history = {"p": p}
    return out, history
