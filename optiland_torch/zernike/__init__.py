"""Zernike polynomials: standard (OSA/ANSI), fringe and Noll schemes.

Counterpart of ``optiland_tpu/zernike/__init__.py``, with the same
formulation (Niu & Tian (2022), J. Opt. 24 123001): the radial
polynomials' coefficients are static Python floats per (n, m), and the
evaluation is a torch expression, differentiable in the coefficients and
the coordinates. The Zernike-sag geometry (``core/geometry.py``) reads the
schemes' term orders and normalizations from here.
"""

from __future__ import annotations

from math import factorial

import numpy as np
import torch

from optiland_torch import config


def _radial_coeff_table(n: int, m: int):
    """Powers and coefficients of the radial polynomial R_n^|m|(r)."""
    m = abs(m)
    s_max = (n - m) // 2 + 1
    powers, coeffs = [], []
    for k in range(s_max):
        c = (-1) ** k * factorial(n - k) / (
            factorial(k) * factorial((n + m) // 2 - k)
            * factorial((n - m) // 2 - k)
        )
        powers.append(n - 2 * k)
        coeffs.append(c)
    return powers, coeffs


def _float(r):
    r = torch.as_tensor(r)
    return r if r.is_floating_point() else r.to(config.dtype())


def radial_term(n: int, m: int, r):
    """R_n^|m|(r) evaluated with static coefficients."""
    r = _float(r)
    powers, coeffs = _radial_coeff_table(n, m)
    val = torch.zeros_like(r)
    for p, c in zip(powers, coeffs):
        val = val + c * r**p
    return val


def radial_derivative(n: int, m: int, r):
    """dR_n^|m|/dr with static coefficients."""
    r = _float(r)
    powers, coeffs = _radial_coeff_table(n, m)
    val = torch.zeros_like(r)
    for p, c in zip(powers, coeffs):
        if p > 0:
            val = val + c * p * r ** (p - 1)
    return val


def azimuthal_term(m: int, phi):
    """cos(m phi) for m >= 0, sin(|m| phi) for m < 0."""
    phi = _float(phi)
    if m >= 0:
        return torch.cos(m * phi)
    return torch.sin(abs(m) * phi)


class BaseZernike:
    """Zernike polynomial set over unit-disk coordinates (r, phi)."""

    _indices_cache: dict[str, list] = {}

    def __init__(self, coeffs=None, num_terms: int = 36):
        if coeffs is None:
            coeffs = torch.zeros(num_terms, dtype=config.dtype(),
                                 device=config.device())
        self.coeffs = torch.atleast_1d(_float(coeffs))
        self.indices = self._generate_indices(self.coeffs.shape[0])

    # -- scheme-specific -------------------------------------------------
    @staticmethod
    def _index_to_number(n: int, m: int):
        raise NotImplementedError

    @staticmethod
    def _norm_constant(n: int, m: int) -> float:
        raise NotImplementedError

    # --------------------------------------------------------------------
    @classmethod
    def _generate_indices(cls, n_indices: int):
        """(n, m) pairs sorted by the scheme's coefficient numbering."""
        cache = cls._indices_cache.setdefault(cls.__name__, [])
        if len(cache) >= n_indices:
            return cache[:n_indices]

        numbers_present = ([cls._index_to_number(0, 0) != 0]
                           + [False] * n_indices)
        number, indices = [], []
        n, m = 0, 0
        m = -n
        while not all(numbers_present):
            num = cls._index_to_number(n, m)
            if num is not None:
                number.append(num)
                indices.append((n, m))
                if num <= n_indices:
                    numbers_present[num] = True
            if m == n:
                n += 1
                m = -n
            else:
                m += 1
        indices_sorted = [e for _, e in sorted(zip(number, indices))][
            :n_indices]
        cls._indices_cache[cls.__name__] = indices_sorted
        return indices_sorted

    def get_term(self, coeff, n: int, m: int, r, phi):
        return (coeff * self._norm_constant(n, m) * radial_term(n, m, r)
                * azimuthal_term(m, phi))

    def terms(self, r=0, phi=0):
        return [self.get_term(c, n, m, r, phi)
                for c, (n, m) in zip(self.coeffs, self.indices)]

    def poly(self, r=0, phi=0):
        """Sum of all terms at (r, phi)."""
        r, phi = _float(r), _float(phi)
        total = torch.zeros_like(r + phi)
        for t in self.terms(r, phi):
            total = total + t
        return total

    def get_derivative(self, n: int, m: int, r, phi):
        """(dZ/dr, dZ/dphi) of one (unnormalized-coefficient) term."""
        r, phi = _float(r), _float(phi)
        rt = radial_term(n, abs(m), r)
        rd = radial_derivative(n, abs(m), r)
        if m == 0:
            return rd, torch.zeros_like(r)
        if m > 0:
            return rd * torch.cos(m * phi), -m * rt * torch.sin(m * phi)
        return (rd * torch.sin(abs(m) * phi),
                abs(m) * rt * torch.cos(abs(m) * phi))

    def derivatives_cartesian(self, x, y):
        """(dZ/dx, dZ/dy) of the full polynomial at Cartesian points."""
        x, y = _float(x), _float(y)
        r = torch.sqrt(x**2 + y**2)
        r_safe = torch.where(r == 0, 1e-14, r)
        phi = torch.atan2(y, x)
        dzdx = torch.zeros_like(r)
        dzdy = torch.zeros_like(r)
        for c, (n, m) in zip(self.coeffs, self.indices):
            nc = self._norm_constant(n, m)
            ddr, ddphi = self.get_derivative(n, m, r, phi)
            dzdx = dzdx + c * nc * (ddr * x / r_safe - ddphi * y / r_safe**2)
            dzdy = dzdy + c * nc * (ddr * y / r_safe + ddphi * x / r_safe**2)
        return dzdx, dzdy


class ZernikeStandard(BaseZernike):
    """OSA/ANSI standard indexing."""

    @staticmethod
    def _index_to_number(n: int, m: int):
        if (n - m) % 2 == 0:
            return (n * (n + 2) + m) // 2
        return None

    @staticmethod
    def _norm_constant(n: int, m: int) -> float:
        denominator = 2 if m == 0 else 1
        return float(np.sqrt((2 * n + 2) / denominator))


class ZernikeFringe(BaseZernike):
    """Fringe / University of Arizona indexing."""

    @staticmethod
    def _index_to_number(n: int, m: int):
        if (n - m) % 2 == 0:
            return int((1 + (n + abs(m)) / 2) ** 2 - 2 * abs(m)
                       + (1 - np.sign(m)) / 2)
        return None

    @staticmethod
    def _norm_constant(n: int, m: int) -> float:
        return 1.0


class ZernikeNoll(BaseZernike):
    """Noll sequential indexing."""

    @staticmethod
    def _index_to_number(n: int, m: int):
        if (n - m) % 2 == 0:
            mod = n % 4
            if (m > 0 and mod <= 1) or (m < 0 and mod >= 2):
                c = 0
            elif (m >= 0 and mod >= 2) or (m <= 0 and mod <= 1):
                c = 1
            return int(n * (n + 1) / 2 + abs(m) + c)
        return None

    @staticmethod
    def _norm_constant(n: int, m: int) -> float:
        denominator = 2 if m == 0 else 1
        return float(np.sqrt((2 * n + 2) / denominator))


ZERNIKE_CLASSES = {
    "standard": ZernikeStandard,
    "fringe": ZernikeFringe,
    "noll": ZernikeNoll,
}


class ZernikeFit:
    """Least-squares Zernike fit to scattered data (``torch.linalg.lstsq``
    on the design matrix of unit-coefficient terms)."""

    def __init__(self, x, y, z, zernike_type: str = "fringe",
                 num_terms: int = 36):
        x, y, z = (_float(v).reshape(-1) for v in (x, y, z))
        if x.shape != y.shape or x.shape != z.shape:
            raise ValueError("`x`, `y`, and `z` must have the same size.")
        self.x, self.y, self.z = x, y, z
        self.type = zernike_type
        self.num_terms = num_terms
        self.radius = torch.sqrt(x**2 + y**2)
        self.phi = torch.atan2(y, x)

        cls = ZERNIKE_CLASSES[zernike_type]
        basis = cls(coeffs=torch.ones(num_terms, dtype=x.dtype))
        cols = [basis.get_term(1.0, n, m, self.radius, self.phi)
                for (n, m) in basis.indices]
        self.A = torch.stack(cols, dim=1)
        self.coeffs = torch.linalg.lstsq(self.A, z[:, None]).solution[:, 0]
        self.zernike = cls(coeffs=self.coeffs)

    def predict(self, r, phi):
        return self.zernike.poly(r, phi)

    @property
    def residual(self):
        return self.z - self.A @ self.coeffs

    def rms_error(self):
        return torch.sqrt(torch.mean(self.residual**2))
