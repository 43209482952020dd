"""Huygens-Fresnel direct-summation PSF.

Counterpart of ``optiland_tpu/psf/huygens_fresnel.py``: the coherent
superposition of spherical wavelets from the exit-pupil samples at every
point of an image grid. ``huygens_psf_from_data`` forms the sum through
``ops/huygens.py``, whose wrappers decide by device: on a CUDA device the
kernels (K10 forward, K11a/K11b backward) and never the plain sum, on the
CPU their plain versions with the hand adjoints. ``huygens_field`` is the
plain pairwise sum over chunks of image points, differentiated by
autograd: the oracle of the tests. On a card the wavefront and image-grid
traces run on the trace kernels (K5a/K5b; K8/K9 for a polarized system).
The vectorial PSF of a polarized system (``vectorial_huygens_psf_from_data``)
sums |field|^2 over the Cartesian components of the exit E-field of each
incoherent polarization state, each field through the same kernels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from optiland_torch.core import raygen
from optiland_torch.core import trace as trace_core
from optiland_torch.core.distributions import create_distribution
from optiland_torch.core.system import System, n_all, positions
from optiland_torch.ops.huygens import (
    huygens_field_fast, huygens_fwd_plain, pupil_arrays,
)
from optiland_torch.psf.fft import pupil_grid_coords
from optiland_torch.wavefront import compute_wavefront_data


def huygens_field(
    image_x, image_y, image_z,
    pupil_x, pupil_y, pupil_z,
    pupil_amp, pupil_opd_mm,
    wavelength_mm, Rp,
    chunk: int = 4096,
):
    """Coherent field at flat image points from the pupil wavelet sum, over
    chunks of ``chunk`` image points, in plain torch (autograd gives its
    gradient). Image arrays are flat (P,), pupil arrays flat (Q,); returns
    complex (P,)."""
    k = 2.0 * math.pi / float(wavelength_mm)
    pup = pupil_arrays(pupil_x, pupil_y, pupil_z, pupil_amp, pupil_opd_mm, k,
                       Rp)
    re, im = huygens_fwd_plain((image_x, image_y, image_z), pup, k,
                               chunk=chunk)
    return torch.complex(re, im)


def huygens_psf_from_data(data, image_x, image_y, image_z, wavelength_um):
    """|field|^2 over an image grid given WavefrontData: the kernels for
    tensors on a CUDA device, their plain versions for tensors on the CPU.
    Unlike the JAX package's it takes no ``chunk``: the kernels and the
    plain versions pick their own."""
    wl_mm = wavelength_um * 1e-3
    amp = torch.sqrt(torch.clamp(data.intensity, min=0.0))
    opd_mm = data.opd * wl_mm
    shape = image_x.shape
    args = (image_x.reshape(-1), image_y.reshape(-1), image_z.reshape(-1),
            data.pupil_x, data.pupil_y, data.pupil_z, amp, opd_mm, wl_mm,
            data.radius)
    return torch.abs(huygens_field_fast(*args).reshape(shape)) ** 2


def vectorial_huygens_psf_from_data(data, image_x, image_y, image_z,
                                    wavelength_um):
    """Incoherent sum of |field|^2 over the Cartesian components of the exit
    E-field of each incoherent polarization state (``data.E_exits``), the
    rays of zero intensity masked; each field sum goes through the kernels
    on a CUDA device, their plain versions on the CPU."""
    wl_mm = wavelength_um * 1e-3
    opd_mm = data.opd * wl_mm
    is_valid = data.intensity > 0
    shape = image_x.shape
    img = (image_x.reshape(-1), image_y.reshape(-1), image_z.reshape(-1))
    psf = torch.zeros(shape, dtype=image_x.dtype, device=image_x.device)
    for E in data.E_exits:
        for comp in range(3):
            amp = torch.where(is_valid, E[:, comp], torch.zeros_like(E[:, 0]))
            f = huygens_field_fast(*img, data.pupil_x, data.pupil_y,
                                   data.pupil_z, amp, opd_mm, wl_mm,
                                   data.radius)
            psf = psf + torch.abs(f.reshape(shape)) ** 2
    return psf


def _image_grid(system, Hx, Hy, wavelength, image_size, oversample=None,
                pixel_pitch=None):
    """Image-plane sample grid centered on the beam centroid.

    The half-extent comes from (in priority order) an explicit pixel pitch,
    the oversampled optical cutoff, or the geometric/Airy footprint.
    Returns (gx, gy, gz, pixel_pitch_mm).
    """
    like = system.stack.radius
    dist = create_distribution("hexapolar")
    dist.generate_points(6)
    Px, Py = (torch.as_tensor(np.asarray(v, float), dtype=like.dtype,
                              device=like.device) for v in (dist.x, dist.y))
    rays = raygen.generate_rays(system, Hx, Hy, Px, Py, wavelength)
    final, _ = trace_core.trace(system, rays, record=False,
                                wavelength=wavelength)
    valid = final.i > 0
    w = torch.where(valid, 1.0, 0.0)
    tw = torch.clamp(torch.sum(w), min=1.0)
    cx = torch.sum(final.x * w) / tw
    cy = torch.sum(final.y * w) / tw

    if pixel_pitch is not None:
        extent = 0.5 * image_size * pixel_pitch
    elif oversample is not None:
        fno = working_FNO(system, Hx, Hy, wavelength)
        f_cutoff = 1.0 / (fno * wavelength * 1e-3)
        pixel_pitch = 1.0 / (2 * oversample * f_cutoff)
        extent = 0.5 * image_size * pixel_pitch
    else:
        extent_geom = torch.max(torch.where(
            valid, torch.hypot(final.x - cx, final.y - cy), 0.0))
        fno = working_FNO(system, Hx, Hy, wavelength)
        extent_ideal = 5.0 * fno * 1.22 * wavelength * 1e-3
        extent = torch.maximum(extent_geom, extent_ideal)
        pixel_pitch = 2 * extent / image_size

    lin = torch.linspace(-1.0, 1.0, image_size, dtype=like.dtype,
                         device=like.device)
    ones = torch.ones(image_size, dtype=like.dtype, device=like.device)
    gx = cx + extent * lin[None, :] * ones[:, None]
    gy = cy + extent * lin[:, None] * ones[None, :]
    gz = positions(system.stack)[-1] + torch.zeros_like(gx)
    return gx, gy, gz, pixel_pitch


def huygens_psf(
    system: System,
    Hx,
    Hy,
    wavelength,
    num_rays: int = 128,
    image_size: int = 128,
    strategy: str = "chief_ray",
    oversample=None,
    pixel_pitch=None,
    normalization=None,
    pol_state=None,
    vectorial: bool = False,
):
    """Functional Huygens PSF on an auto-sized image grid.

    Returns (psf, pixel_pitch_mm, normalization), normalized so that a
    diffraction-limited system peaks at 100. Differentiable with respect to
    every leaf of the system. ``wavelength`` is a number (um).
    ``vectorial=True`` sums the three Cartesian exit-field components per
    incoherent polarization state of ``pol_state`` (a polarized system);
    its normalization keeps the actual exit-field amplitudes.
    """
    xg, yg, mask = pupil_grid_coords(num_rays)
    data = compute_wavefront_data(system, Hx, Hy, wavelength, xg[mask],
                                  yg[mask], strategy=strategy,
                                  pol_state=pol_state)
    if vectorial and data.E_exits is None:
        raise ValueError(
            "E_exits must be populated in WavefrontData for the vectorial "
            "Huygens PSF. Enable polarization on the optic."
        )
    psf_of = vectorial_huygens_psf_from_data if vectorial else (
        huygens_psf_from_data)
    gx, gy, gz, pixel_pitch = _image_grid(
        system, Hx, Hy, wavelength, image_size,
        oversample=oversample, pixel_pitch=pixel_pitch,
    )
    psf = psf_of(data, gx, gy, gz, wavelength)

    if normalization is None:
        # on-axis zero-OPD pupil, one image point on axis: of unit intensity
        # (scalar) or with the actual exit fields (vectorial)
        if (Hx, Hy) != (0.0, 0.0):
            data0 = compute_wavefront_data(system, 0.0, 0.0, wavelength,
                                           xg[mask], yg[mask],
                                           strategy=strategy,
                                           pol_state=pol_state)
        else:
            data0 = data
        ideal = data0.replace(opd=torch.zeros_like(data0.opd))
        if not vectorial:
            ideal = ideal.replace(intensity=torch.ones_like(data0.intensity))
        zero = torch.zeros((1, 1), dtype=gx.dtype, device=gx.device)
        z_img = positions(system.stack)[-1] + zero
        normalization = psf_of(ideal, zero, zero, z_img, wavelength)[0, 0]
    return psf / normalization * 100.0, pixel_pitch, normalization


def working_FNO(system: System, Hx, Hy, wavelength):
    """Working F-number from the marginal and chief ray angles."""
    like = system.stack.radius
    Px = torch.tensor([0.0, 0.0, 0.0, 1.0, -1.0], dtype=like.dtype,
                      device=like.device)
    Py = torch.tensor([0.0, 1.0, -1.0, 0.0, 0.0], dtype=like.dtype,
                      device=like.device)
    rays = raygen.generate_rays(system, Hx, Hy, Px, Py, wavelength)
    final, _ = trace_core.trace(system, rays, record=False,
                                wavelength=wavelength)
    n = n_all(system.stack, system.cfg, wavelength)[-1]
    dot = (final.L[0] * final.L[1:] + final.M[0] * final.M[1:]
           + final.N[0] * final.N[1:])
    ang = torch.arccos(torch.clamp(dot, -1.0, 1.0))
    na2 = (n * torch.sin(ang)) ** 2
    fno = 1.0 / (2.0 * torch.sqrt(torch.mean(na2)))
    return torch.clamp(fno, max=10000.0)


class ScalarHuygensPSF:
    """Huygens PSF analysis of one field and wavelength."""

    _vectorial = False

    def __init__(
        self,
        optic,
        field,
        wavelength="primary",
        num_rays: int = 128,
        image_size: int = 128,
        strategy: str = "chief_ray",
        oversample=None,
        pixel_pitch=None,
        normalization=None,
        **kwargs,
    ):
        if wavelength == "primary":
            wavelength = optic.primary_wavelength
        self.optic = optic
        self.field = field
        self.wavelength = wavelength
        self.image_size = image_size
        self.psf, self.pixel_pitch, self.normalization = huygens_psf(
            optic.system, field[0], field[1], wavelength,
            num_rays=num_rays, image_size=image_size, strategy=strategy,
            oversample=oversample, pixel_pitch=pixel_pitch,
            normalization=normalization,
            pol_state=optic.polarization_state,
            vectorial=self._vectorial,
        )

    def strehl_ratio(self) -> float:
        c = self.image_size // 2
        return float(self.psf[c, c] / 100)


class HuygensPSF(ScalarHuygensPSF):
    """Huygens PSF factory: vectorial when the optic carries a polarization
    state, scalar otherwise."""

    def __new__(cls, optic, *args, **kwargs):
        if cls is HuygensPSF and optic.polarization_state is not None:
            from optiland_torch.psf.vectorial import VectorialHuygensPSF

            return VectorialHuygensPSF(optic, *args, **kwargs)
        return super().__new__(cls)
