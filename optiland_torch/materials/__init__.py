"""Material models for optiland_torch.

Counterpart of ``optiland_tpu/materials/__init__.py``. A material is a
lightweight descriptor that compiles down to numeric dispersion payloads (a
formula code plus a padded coefficient vector, and optional tabulated n/k
arrays) held as numpy arrays until ``Optic`` builds the system tensors.

Ported here: ``BaseMaterial``, ``IdealMaterial``, ``Material`` (catalog by
name), ``resolve_material`` and ``AIR``. The Abbe-number and YAML-file
materials wait for a later slice.
"""

from __future__ import annotations

import numpy as np

from optiland_torch.materials import dispersion
from optiland_torch.materials.catalog import get_catalog
from optiland_torch.materials.dispersion import CONST_N, pad_coefficients

_EMPTY_TABLE = np.zeros((0, 2))


class BaseMaterial:
    """Base class for material descriptors.

    Attributes:
        formula_code: dispersion formula code (see materials.dispersion).
        coefficients: raw (unpadded) coefficient array.
        n_table: (T, 2) tabulated wavelength/index data (may be empty).
        k_table: (T, 2) tabulated wavelength/extinction data (may be empty).
    """

    formula_code: int = CONST_N
    coefficients: np.ndarray = np.zeros(1)
    n_table: np.ndarray = _EMPTY_TABLE
    k_table: np.ndarray = _EMPTY_TABLE

    @property
    def padded_coefficients(self) -> np.ndarray:
        return pad_coefficients(np.asarray(self.coefficients, dtype=float))

    @property
    def has_absorption(self) -> bool:
        return self.k_table.shape[0] > 0 and bool(np.any(self.k_table[:, 1] > 0))


class IdealMaterial(BaseMaterial):
    """Material with constant refractive index and extinction coefficient."""

    def __init__(self, n: float, k: float = 0.0):
        self.index = float(n)
        self.absorb_coef = float(k)
        self.formula_code = CONST_N
        self.coefficients = np.array([float(n)])
        self.n_table = _EMPTY_TABLE
        if k != 0.0:
            # Constant k encoded as a flat two-point table.
            self.k_table = np.array([[0.1, float(k)], [20.0, float(k)]])
        else:
            self.k_table = _EMPTY_TABLE


AIR = IdealMaterial(1.0)


class Material(BaseMaterial):
    """Material resolved by name from the refractiveindex.info catalog."""

    def __init__(
        self,
        name: str,
        reference: str | None = None,
        robust_search: bool = True,
        min_wavelength: float | None = None,
        max_wavelength: float | None = None,
    ):
        self.name = name
        self.reference = reference
        payload = get_catalog().find(
            name, reference, min_wavelength=min_wavelength,
            max_wavelength=max_wavelength, robust=robust_search,
        )
        self.formula_code = payload["formula_code"]
        self.coefficients = np.asarray(payload["coefficients"], dtype=float)
        self.n_table = np.asarray(payload["n_table"], dtype=float)
        self.k_table = np.asarray(payload["k_table"], dtype=float)
        if self.formula_code < 0:
            raise ValueError(f"Material {name} has no refractive index data.")


def resolve_material(spec) -> BaseMaterial:
    """Resolve the user-facing material spec used by ``surfaces.add``.

    Accepts: BaseMaterial instance, "air", a material name string, a
    (name, reference) tuple, or a numeric index.
    """
    if isinstance(spec, BaseMaterial):
        return spec
    if spec is None:
        return AIR
    if isinstance(spec, (int, float)):
        return IdealMaterial(float(spec))
    if isinstance(spec, tuple):
        return Material(spec[0], spec[1])
    if isinstance(spec, str):
        if spec.lower() == "air":
            return AIR
        return Material(spec)
    raise ValueError(f"Cannot resolve material spec: {spec!r}")


__all__ = [
    "AIR",
    "BaseMaterial",
    "IdealMaterial",
    "Material",
    "dispersion",
    "get_catalog",
    "resolve_material",
]
