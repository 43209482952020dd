"""Thin-film layers and the coherent transfer-matrix method (TMM).

Counterpart of ``optiland_tpu/thin_film/stack.py``, in complex torch
tensors (Abeles characteristic matrices, Macleod's admittance conventions).
Layer thicknesses may be tensors, so a coating merit differentiates with
autograd.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from optiland_torch.materials import BaseMaterial, IdealMaterial, resolve_material

_SQRT_EPS_MU = 0.002654418729832701370374020517935  # sqrt(eps0/mu0), siemens


def _as_tensor(v):
    if torch.is_tensor(v):
        return v
    return torch.as_tensor(np.asarray(v, dtype=np.float64))


def _complex_index(material: BaseMaterial, wavelength_um):
    n = torch.atleast_1d(material.n(wavelength_um))
    k = torch.atleast_1d(material.k(wavelength_um))
    return torch.complex(n, k.to(n.dtype))


def _snell_cos(n0, theta0, n):
    """Transmitted-angle cosine with forward-branch selection (Macleod
    ch. 2.6)."""
    nr, k = n.real, n.imag
    return torch.sqrt(
        nr**2 - k**2 - (n0 * torch.sin(theta0)) ** 2 - 2j * nr * k
    ) / n


def _admittance(n, cos_t, pol: str):
    """Optical admittance for s or p polarization."""
    eta_s = _SQRT_EPS_MU * n * cos_t
    if pol == "s":
        return eta_s
    if pol == "p":
        return _SQRT_EPS_MU**2 * (n.real - 1j * n.imag) ** 2 / eta_s
    raise ValueError("Invalid polarization state")


class Layer:
    """One homogeneous thin-film layer."""

    def __init__(self, material, thickness_um):
        self.material = resolve_material(material)
        self.thickness_um = thickness_um

    def n_complex(self, wavelength_um):
        return _complex_index(self.material, wavelength_um)

    def phase_thickness(self, wavelength_um, cos_theta_l, n_complex_l):
        """delta = 2 pi / lambda * n * d * cos(theta_l)."""
        k0 = 2 * math.pi / _as_tensor(wavelength_um)
        return k0 * n_complex_l * self.thickness_um * cos_theta_l

    def __repr__(self):
        return f"Layer({self.material!r}, d={self.thickness_um} um)"


def tmm_coherent(layers_n, layers_d, n0, ns, wavelength_um, theta0_rad,
                 pol: str):
    """Coherent TMM for a stack of per-layer complex indices and
    thicknesses.

    Args:
        layers_n: list of per-layer complex index tensors (broadcast over
            wavelength/angle grids).
        layers_d: list of per-layer thicknesses in um (numbers or tensors).
        n0, ns: incident/substrate complex indices.
        wavelength_um, theta0_rad: wavelength/angle tensors (broadcastable).
        pol: "s" or "p".

    Returns:
        (r, t, R, T, A)
    """
    theta0_rad = _as_tensor(theta0_rad)
    cos0 = _snell_cos(n0, theta0_rad, n0)
    coss = _snell_cos(n0, theta0_rad, ns)
    eta0 = _admittance(n0, cos0, pol)
    etas = _admittance(ns, coss, pol)

    A = torch.ones_like(eta0)
    B = torch.zeros_like(eta0)
    C = torch.zeros_like(eta0)
    D = torch.ones_like(eta0)

    k0 = 2 * math.pi / _as_tensor(wavelength_um)
    for n_l, d_l in zip(layers_n, layers_d):
        cos_l = _snell_cos(n0, theta0_rad, n_l)
        eta_l = _admittance(n_l, cos_l, pol)
        delta = k0 * n_l * d_l * cos_l
        c = torch.cos(delta)
        s = torch.sin(delta)
        mA, mB, mC, mD = c, 1j * (s / eta_l), 1j * (eta_l * s), c
        A, B, C, D = (
            A * mA + B * mC,
            A * mB + B * mD,
            C * mA + D * mC,
            C * mB + D * mD,
        )

    denom = eta0 * (A + etas * B) + C + etas * D
    denom = torch.where(denom.abs() == 0, torch.full_like(denom, 1e-30),
                        denom)
    r = (eta0 * A + eta0 * etas * B - C - etas * D) / denom
    t = torch.conj_physical((2 * eta0) / denom)
    R = (r * torch.conj(r)).real
    T = (t * torch.conj(t)).real * etas.real / eta0.real
    return r, t, R, T, 1 - R - T


class ThinFilmStack:
    """A coating stack: incident medium, layers, substrate."""

    def __init__(self, incident_material=None, substrate_material=None,
                 reference_wl_um: float | None = None,
                 reference_AOI_deg: float | None = None):
        self.incident_material = resolve_material(
            incident_material if incident_material is not None
            else IdealMaterial(1.0)
        )
        self.substrate_material = resolve_material(
            substrate_material if substrate_material is not None
            else IdealMaterial(1.52)
        )
        self.reference_wl_um = reference_wl_um
        self.reference_AOI_deg = reference_AOI_deg
        self.layers: list[Layer] = []

    # ---------------- construction ----------------

    def add_layer(self, material, thickness_um):
        self.layers.append(Layer(material, thickness_um))
        return self

    def add_layer_nm(self, material, thickness_nm):
        return self.add_layer(material, thickness_nm * 1e-3)

    def add_layer_qwot(self, material, qwot_thickness: float = 1.0,
                       wavelength_um: float | None = None,
                       angle_deg: float | None = None,
                       name: str | None = None):
        """Quarter-wave optical thickness layer at the reference
        wavelength."""
        if wavelength_um is None:
            if self.reference_wl_um is None:
                raise ValueError(
                    "reference_wl_um must be set for adding QWOT layer"
                )
            wavelength_um = self.reference_wl_um
        if angle_deg is None:
            angle_deg = self.reference_AOI_deg or 0.0
        mat = resolve_material(material)
        n = float(torch.atleast_1d(mat.n(wavelength_um))[0])
        th_rad = np.deg2rad(angle_deg)
        thickness_um = qwot_thickness * wavelength_um / (4 * n * np.cos(th_rad))
        return self.add_layer(mat, thickness_um)

    def insert_layer(self, index, material, thickness_um):
        self.layers.insert(index, Layer(material, thickness_um))
        return self

    def remove_layer(self, index: int) -> Layer:
        return self.layers.pop(index)

    def split_layer(self, layer_index: int, position_fraction: float):
        """Split one layer into two at a fractional depth."""
        layer = self.layers[layer_index]
        d1 = layer.thickness_um * position_fraction
        d2 = layer.thickness_um - d1
        self.layers[layer_index] = Layer(layer.material, d1)
        self.layers.insert(layer_index + 1, Layer(layer.material, d2))
        return self

    def copy(self):
        new = ThinFilmStack(self.incident_material, self.substrate_material,
                            self.reference_wl_um, self.reference_AOI_deg)
        new.layers = [Layer(l.material, l.thickness_um) for l in self.layers]
        return new

    deep_copy = copy

    def __len__(self):
        return len(self.layers)

    def __repr__(self):
        return f"ThinFilmStack({len(self.layers)} layers)"

    # ---------------- computation ----------------

    def thicknesses(self):
        return torch.as_tensor([float(l.thickness_um) for l in self.layers],
                               dtype=torch.float64)

    def compute_rtRTA(self, wavelength_um, aoi_rad=0.0, pol="s",
                      thicknesses=None):
        """(r, t, R, T, A) over broadcastable wavelength/angle grids;
        ``thicknesses`` optionally overrides the stored layer thicknesses
        (a differentiable vector in an optimization)."""
        wavelength_um = _as_tensor(wavelength_um)
        aoi_rad = _as_tensor(aoi_rad)
        n0 = _complex_index(self.incident_material, wavelength_um)
        ns = _complex_index(self.substrate_material, wavelength_um)
        layers_n = [l.n_complex(wavelength_um) for l in self.layers]
        if thicknesses is None:
            layers_d = [l.thickness_um for l in self.layers]
        else:
            layers_d = [thicknesses[i] for i in range(len(self.layers))]
        if pol in ("s", "p"):
            return tmm_coherent(layers_n, layers_d, n0, ns, wavelength_um,
                                aoi_rad, pol)
        if pol == "u":  # unpolarized: average s and p
            s = tmm_coherent(layers_n, layers_d, n0, ns, wavelength_um,
                             aoi_rad, "s")
            p = tmm_coherent(layers_n, layers_d, n0, ns, wavelength_um,
                             aoi_rad, "p")
            return tuple((a + b) / 2 for a, b in zip(s, p))
        raise ValueError(f"Invalid polarization {pol!r}")

    def reflectance(self, wavelength_um, aoi_rad=0.0, pol="s", **kw):
        return self.compute_rtRTA(wavelength_um, aoi_rad, pol, **kw)[2]

    def transmittance(self, wavelength_um, aoi_rad=0.0, pol="s", **kw):
        return self.compute_rtRTA(wavelength_um, aoi_rad, pol, **kw)[3]

    def absorptance(self, wavelength_um, aoi_rad=0.0, pol="s", **kw):
        return self.compute_rtRTA(wavelength_um, aoi_rad, pol, **kw)[4]

    def RTA(self, wavelength_um, aoi_rad=0.0, pol="s", **kw):
        _, _, R, T, A = self.compute_rtRTA(wavelength_um, aoi_rad, pol, **kw)
        return R, T, A

    # nm / degree conveniences

    def reflectance_nm_deg(self, wavelength_nm, aoi_deg=0.0, pol="s"):
        return self.reflectance(_as_tensor(wavelength_nm) * 1e-3,
                                torch.deg2rad(_as_tensor(aoi_deg)), pol)

    def transmittance_nm_deg(self, wavelength_nm, aoi_deg=0.0, pol="s"):
        return self.transmittance(_as_tensor(wavelength_nm) * 1e-3,
                                  torch.deg2rad(_as_tensor(aoi_deg)), pol)

    def absorptance_nm_deg(self, wavelength_nm, aoi_deg=0.0, pol="s"):
        return self.absorptance(_as_tensor(wavelength_nm) * 1e-3,
                                torch.deg2rad(_as_tensor(aoi_deg)), pol)

    def RTA_nm_deg(self, wavelength_nm, aoi_deg=0.0, pol="s"):
        return self.RTA(_as_tensor(wavelength_nm) * 1e-3,
                        torch.deg2rad(_as_tensor(aoi_deg)), pol)
