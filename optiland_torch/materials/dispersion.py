"""Dispersion formula evaluation as plain torch functions.

Counterpart of ``optiland_tpu/materials/dispersion.py``: the nine
refractiveindex.info formulas plus constant, tabulated and Buchdahl index
models, each a function of a fixed-width, zero-padded coefficient vector
and a wavelength tensor, so that zero-padded entries contribute exactly
zero. Formula codes are static Python ints, resolved when the expression
is built.

The per-term scalar form (``n_formula_scalar_terms``) is what the
polychromatic trace kernels evaluate per ray and surface; beside it,
``n_formula_scalar_grad`` is its derivative with respect to every
coefficient, derived by hand, which their adjoint needs.
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
    """Kernel form of :func:`n_formula_static` (``n_formula_scalar_terms`` of
    the JAX package): ``cv`` is a sequence of scalar coefficients (0-d
    tensors or numbers) and every per-term sum runs as a Python loop over
    them, as the CUDA kernels' loops do. Zero-padded trailing coefficients
    contribute exactly zero terms. TABULATED_N has no such form."""
    cv = list(cv)

    def pairs():
        B, C = cv[1::2], cv[2::2]
        m = min(len(B), len(C))
        return cv[0], B[:m], C[:m]

    w2 = w * w
    if code == CONST_N:
        return cv[0] * torch.ones_like(w)
    if code == FORMULA_1:  # Sellmeier
        c0, B, C = pairs()
        n2 = 1 + c0 * torch.ones_like(w)
        for b, c in zip(B, C):
            n2 = n2 + b * w2 / (w2 - c * c)
        return torch.sqrt(n2)
    if code == FORMULA_2:  # Sellmeier-2
        c0, B, C = pairs()
        n2 = 1 + c0 * torch.ones_like(w)
        for b, c in zip(B, C):
            n2 = n2 + b * w2 / (w2 - c)
        return torch.sqrt(n2)
    if code in (FORMULA_3, FORMULA_5):  # polynomial (sqrt) / Cauchy (plain)
        c0, B, C = pairs()
        acc = c0 * torch.ones_like(w)
        for b, c in zip(B, C):
            acc = acc + b * w**c
        return torch.sqrt(acc) if code == FORMULA_3 else acc
    if code == FORMULA_4:  # RefractiveIndex.INFO formula 4
        n2 = (
            cv[0]
            + cv[1] * w ** cv[2] / (w2 - cv[3] ** cv[4])
            + cv[5] * w ** cv[6] / (w2 - cv[7] ** cv[8])
        )
        B, C = cv[9::2], cv[10::2]
        for b, c in zip(B, C):
            n2 = n2 + b * w**c
        return torch.sqrt(n2)
    if code == FORMULA_6:  # gases
        c0, B, C = pairs()
        winv2 = 1.0 / w2
        n = 1 + c0 * torch.ones_like(w)
        for b, c in zip(B, C):
            n = n + b / (c - winv2)
        return n
    if code == FORMULA_7:  # Herzberger
        inv = 1.0 / (w2 - 0.028)
        n = cv[0] + cv[1] * inv + cv[2] * inv**2
        for k, c in enumerate(cv[3:], start=3):
            n = n + c * w ** (2 * (k - 2))
        return n
    if code == FORMULA_8:  # retro
        b = cv[0] + cv[1] * w2 / (w2 - cv[2]) + cv[3] * w2
        return torch.sqrt((1 + 2 * b) / (1 - b))
    if code == FORMULA_9:  # exotic
        n2 = (
            cv[0] + cv[1] / (w2 - cv[2])
            + cv[3] * (w - cv[4]) / ((w - cv[4]) ** 2 + cv[5])
        )
        return torch.sqrt(n2)
    if code == BUCHDAHL:
        n_ref, v1, v2, v3, wave_ref, alpha = cv[:6]
        d = w - wave_ref
        om = d / (1 + alpha * d)
        return n_ref + v1 * om + v2 * om**2 + v3 * om**3
    raise NotImplementedError(f"formula code {code} has no scalar-term form")


def _dpow_dbase(x, y):
    """d(x**y)/dx as JAX forms it for a float exponent: y x**(y - 1), NaN
    at x = y = 0."""
    return y * x ** (y - 1)


def _dpow_dexp(x, y):
    """d(x**y)/dy by the JAX package's rule: 0 where x == 0."""
    x = torch.as_tensor(x)
    return torch.log(torch.where(x == 0, 1.0, x)) * x**y


def n_formula_scalar_grad(code: int, cv, w):
    """(n, dn): the index of :func:`n_formula_scalar_terms` and its
    derivative with respect to each coefficient of ``cv``, derived by hand
    per formula; ``dn[j]`` is a tensor of ``w``'s shape, or None where the
    derivative is identically zero (a coefficient the formula does not
    read). The derivative with respect to the wavelength is not formed:
    the traces pass no wavelength cotangent."""
    cv = list(cv)
    nm = len(cv)
    dn = [None] * nm
    one = torch.ones_like(w)
    n = n_formula_scalar_terms(code, cv, w)
    w2 = w * w
    npair = min(len(cv[1::2]), len(cv[2::2]))
    if code in (CONST_N, FORMULA_5, FORMULA_6, FORMULA_7, BUCHDAHL):
        sq = one  # the formula gives n itself
    else:
        sq = 0.5 / n  # dn/d(n^2), or dn/d(acc), for the square-root forms
    if code == CONST_N:
        dn[0] = one
    elif code in (FORMULA_1, FORMULA_2):
        dn[0] = sq
        for k in range(npair):
            b, c = cv[1 + 2 * k], cv[2 + 2 * k]
            den = w2 - c * c if code == FORMULA_1 else w2 - c
            dn[1 + 2 * k] = sq * w2 / den
            dc = 2 * c if code == FORMULA_1 else 1.0
            dn[2 + 2 * k] = sq * b * w2 * dc / (den * den)
    elif code in (FORMULA_3, FORMULA_5):
        dn[0] = sq
        for k in range(npair):
            b, c = cv[1 + 2 * k], cv[2 + 2 * k]
            dn[1 + 2 * k] = sq * w**c
            dn[2 + 2 * k] = sq * b * _dpow_dexp(w, c)
    elif code == FORMULA_4:
        dn[0] = sq
        # the two terms cv[a] w^cv[a+1] / (w^2 - cv[a+2]^cv[a+3])
        for a in (1, 5):
            ca, ce, cb, cx = cv[a], cv[a + 1], cv[a + 2], cv[a + 3]
            den = w2 - cb**cx
            num = w**ce
            dn[a] = sq * num / den
            dn[a + 1] = sq * ca * _dpow_dexp(w, ce) / den
            r = sq * ca * num / (den * den)
            dn[a + 2] = r * _dpow_dbase(cb, cx)
            dn[a + 3] = r * _dpow_dexp(cb, cx)
        for k in range(min(len(cv[9::2]), len(cv[10::2]))):
            b, c = cv[9 + 2 * k], cv[10 + 2 * k]
            dn[9 + 2 * k] = sq * w**c
            dn[10 + 2 * k] = sq * b * _dpow_dexp(w, c)
    elif code == FORMULA_6:
        winv2 = 1.0 / w2
        dn[0] = one
        for k in range(npair):
            b, c = cv[1 + 2 * k], cv[2 + 2 * k]
            den = c - winv2
            dn[1 + 2 * k] = 1.0 / den
            dn[2 + 2 * k] = -b / (den * den)
    elif code == FORMULA_7:
        inv = 1.0 / (w2 - 0.028)
        dn[0], dn[1], dn[2] = one, inv, inv**2
        for k in range(3, nm):
            dn[k] = w ** (2 * (k - 2))
    elif code == FORMULA_8:
        den = w2 - cv[2]
        b = cv[0] + cv[1] * w2 / den + cv[3] * w2
        db = sq * 3.0 / ((1 - b) * (1 - b))  # dn/db
        dn[0] = db
        dn[1] = db * w2 / den
        dn[2] = db * cv[1] * w2 / (den * den)
        dn[3] = db * w2
    elif code == FORMULA_9:
        den = w2 - cv[2]
        e = w - cv[4]
        q = e * e + cv[5]
        dn[0] = sq
        dn[1] = sq / den
        dn[2] = sq * cv[1] / (den * den)
        dn[3] = sq * e / q
        dn[4] = -sq * cv[3] * (q - 2 * e * e) / (q * q)
        dn[5] = -sq * cv[3] * e / (q * q)
    elif code == BUCHDAHL:
        _, v1, v2, v3, _, alpha = cv[:6]
        d = w - cv[4]
        f = 1 + alpha * d
        om = d / f
        dn_dom = v1 + 2 * v2 * om + 3 * v3 * om**2
        dn[0], dn[1], dn[2], dn[3] = one, om, om**2, om**3
        dn[4] = -dn_dom / (f * f)
        dn[5] = -dn_dom * d * d / (f * f)
    else:
        raise NotImplementedError(
            f"formula code {code} has no scalar-term form")
    return n, [None if v is None else v * one for v in dn]
