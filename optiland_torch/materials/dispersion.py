"""Dispersion formula evaluation as plain torch functions.

Counterpart of ``optiland_tpu/materials/dispersion.py``: the nine
refractiveindex.info formulas plus constant, tabulated and Buchdahl index
models, each a function of a fixed-width, zero-padded coefficient vector
and a wavelength tensor, so that zero-padded entries contribute exactly
zero. Formula codes are static Python ints, resolved when the expression
is built.

The per-term scalar form (``n_formula_scalar_terms``) that the JAX
package's polychromatic kernels use waits for the polychromatic kernel.
"""

from __future__ import annotations

import numpy as np
import torch

# Width of the padded coefficient vector (the JAX package's MAX_COEFFS).
MAX_COEFFS = 20

# Formula codes (stable; shared with the JAX package's serialized systems)
CONST_N = 0  # coeffs[0] = constant n
FORMULA_1 = 1
FORMULA_2 = 2
FORMULA_3 = 3
FORMULA_4 = 4
FORMULA_5 = 5
FORMULA_6 = 6
FORMULA_7 = 7
FORMULA_8 = 8
FORMULA_9 = 9
TABULATED_N = 10  # interpolated from a wavelength/index table
BUCHDAHL = 11  # coeffs = [n_ref, v1, v2, v3, wave_ref, alpha]

NUM_FORMULAS = 12


def pad_coefficients(coeffs) -> np.ndarray:
    """Zero-pad a coefficient list to the fixed MAX_COEFFS width."""
    coeffs = np.asarray(coeffs, dtype=float).ravel()
    if coeffs.size > MAX_COEFFS:
        raise ValueError(f"Too many coefficients ({coeffs.size} > {MAX_COEFFS})")
    out = np.zeros((MAX_COEFFS,))
    out[: coeffs.size] = coeffs
    return out


def _pairs(c):
    """Split padded coefficients into (c0, B, C) with B/C the odd/even tail."""
    B, C = c[1::2], c[2::2]
    m = min(B.shape[0], C.shape[0])
    return c[0], B[:m], C[:m]


def _const_n(c, w):
    return c[0] * torch.ones_like(w)


def _formula_1(c, w):
    """Sellmeier: n^2 = 1 + c0 + sum B_k w^2 / (w^2 - C_k^2)."""
    c0, B, C = _pairs(c)
    w2 = w[..., None] ** 2
    n2 = 1 + c0 + torch.sum(B * w2 / (w2 - C**2), dim=-1)
    return torch.sqrt(n2)


def _formula_2(c, w):
    """Sellmeier-2: n^2 = 1 + c0 + sum B_k w^2 / (w^2 - C_k)."""
    c0, B, C = _pairs(c)
    w2 = w[..., None] ** 2
    n2 = 1 + c0 + torch.sum(B * w2 / (w2 - C), dim=-1)
    return torch.sqrt(n2)


def _poly_sum(c, w):
    """c0 + sum B_k w^{C_k} with zero-padded terms contributing zero."""
    c0, B, C = _pairs(c)
    return c0 + torch.sum(B * w[..., None] ** C, dim=-1)


def _formula_3(c, w):
    """Polynomial: n^2 = c0 + sum B_k w^{C_k}."""
    return torch.sqrt(_poly_sum(c, w))


def _formula_4(c, w):
    """RefractiveIndex.INFO formula."""
    wb = w[..., None]
    w2 = w**2
    n2 = (
        c[0]
        + c[1] * w ** c[2] / (w2 - c[3] ** c[4])
        + c[5] * w ** c[6] / (w2 - c[7] ** c[8])
    )
    B, C = c[9::2], c[10::2]
    m = min(B.shape[0], C.shape[0])
    n2 = n2 + torch.sum(B[:m] * wb ** C[:m], dim=-1)
    return torch.sqrt(n2)


def _formula_5(c, w):
    """Cauchy: n = c0 + sum B_k w^{C_k}."""
    return _poly_sum(c, w)


def _formula_6(c, w):
    """Gases: n = 1 + c0 + sum B_k / (C_k - w^-2)."""
    c0, B, C = _pairs(c)
    winv2 = w[..., None] ** -2
    return 1 + c0 + torch.sum(B / (C - winv2), dim=-1)


def _formula_7(c, w):
    """Herzberger: n = c0 + c1/(w^2-0.028) + c2/(w^2-0.028)^2 + sum c_k w^{2(k-2)}."""
    w2 = w**2
    inv = 1.0 / (w2 - 0.028)
    n = c[0] + c[1] * inv + c[2] * inv**2
    tail = c[3:]
    k = torch.arange(3, 3 + tail.shape[0], device=c.device)
    exps = (2 * (k - 2)).to(c.dtype)
    return n + torch.sum(tail * w[..., None] ** exps, dim=-1)


def _formula_8(c, w):
    """Retro: b = c0 + c1 w^2/(w^2-c2) + c3 w^2; n = sqrt((1+2b)/(1-b))."""
    w2 = w**2
    b = c[0] + c[1] * w2 / (w2 - c[2]) + c[3] * w2
    return torch.sqrt((1 + 2 * b) / (1 - b))


def _formula_9(c, w):
    """Exotic: n^2 = c0 + c1/(w^2-c2) + c3 (w-c4)/((w-c4)^2 + c5)."""
    w2 = w**2
    n2 = c[0] + c[1] / (w2 - c[2]) + c[3] * (w - c[4]) / ((w - c[4]) ** 2 + c[5])
    return torch.sqrt(n2)


def _buchdahl(c, w):
    """Buchdahl 3-term model about the reference wavelength."""
    n_ref, v1, v2, v3, wave_ref, alpha = c[0], c[1], c[2], c[3], c[4], c[5]
    d = w - wave_ref
    om = d / (1 + alpha * d)
    return n_ref + v1 * om + v2 * om**2 + v3 * om**3


def _tabulated(c, w):
    # TABULATED_N has no closed form: core.system.n_of interpolates the table
    return torch.full_like(w, float("nan"))


_BRANCHES = [
    _const_n,
    _formula_1,
    _formula_2,
    _formula_3,
    _formula_4,
    _formula_5,
    _formula_6,
    _formula_7,
    _formula_8,
    _formula_9,
    _tabulated,
    _buchdahl,
]


def n_formula_static(code: int, coeffs: torch.Tensor, w) -> torch.Tensor:
    """Refractive index for a *static* formula code; ``w`` in micrometers."""
    w = torch.as_tensor(w, dtype=coeffs.dtype, device=coeffs.device)
    return _BRANCHES[code](coeffs, w)


def n_formula_scalar_terms(code: int, cv, w):
    raise NotImplementedError(
        "n_formula_scalar_terms backs the polychromatic kernel; it is ported "
        "with that kernel in a later slice"
    )
