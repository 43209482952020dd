"""Forbes Q polynomial machinery (Qbfs / Q2d).

Counterpart of ``optiland_tpu/core/forbes.py``. The Qbfs -> Pn and
Q2d -> Pnm basis changes are linear in the coefficients, so they are
static numpy matrices (per term count and azimuthal order), and the
Clenshaw recurrences run over torch values, so the sags stay
differentiable in the coefficients. ``core/geometry.py`` reads the same
matrices and recurrence constants to lay a Forbes surface out for the
kernels (``geometry.aux_layout``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from scipy import special

# ---------------------------------------------------------------------------
# Qbfs (slope-orthogonal radial) basis
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _g_qbfs(n: int) -> float:
    if n == 0:
        return -0.5
    return -(1 + _g_qbfs(n - 1) * _h_qbfs(n - 1)) / _f_qbfs(n)


@functools.lru_cache(maxsize=None)
def _h_qbfs(n: int) -> float:
    return -(n + 2) * (n + 1) / (2 * _f_qbfs(n))


@functools.lru_cache(maxsize=None)
def _f_qbfs(n: int) -> float:
    if n == 0:
        return 2.0
    if n == 1:
        return math.sqrt(19.0) / 2
    term1 = float(n * (n + 1) + 3)
    term2 = _g_qbfs(n - 1) ** 2
    term3 = _h_qbfs(n - 2) ** 2
    return math.sqrt(term1 - term2 - term3)


@functools.lru_cache(maxsize=None)
def qbfs_basis_matrix(n_terms: int) -> np.ndarray:
    """(n, n) matrix T with bs = T @ cs (the Qbfs -> Pn change,
    linearized)."""
    m = n_terms - 1
    T = np.zeros((n_terms, n_terms))
    for col in range(n_terms):
        cs = np.zeros(n_terms)
        cs[col] = 1.0
        bs = np.zeros(n_terms)
        bs[m] = cs[m] / _f_qbfs(m)
        if m > 0:
            bs[m - 1] = (cs[m - 1] - _g_qbfs(m - 1) * bs[m]) / _f_qbfs(m - 1)
        for i in range(m - 2, -1, -1):
            bs[i] = (cs[i] - _g_qbfs(i) * bs[i + 1]
                     - _h_qbfs(i) * bs[i + 2]) / _f_qbfs(i)
        T[:, col] = bs
    return T


def clenshaw_qbfs(cs, usq):
    """Sum of a Qbfs series at u^2 by the Pn Clenshaw recurrence; ``cs``
    is a sequence of scalars (tensors or numbers)."""
    n = len(cs)
    if n == 0:
        return torch.zeros_like(usq)
    T = qbfs_basis_matrix(n)
    bs = [sum(T[i, j] * cs[j] for j in range(n) if T[i, j] != 0.0)
          for i in range(n)]
    m = n - 1
    prefix = 2 - 4 * usq
    b_curr = bs[m] + torch.zeros_like(usq)
    b_next = torch.zeros_like(usq)
    for k in range(m - 1, -1, -1):
        b_new = bs[k] + prefix * b_curr - b_next
        b_next, b_curr = b_curr, b_new
    return 2 * (b_curr + b_next) if m > 0 else 2 * b_curr


# ---------------------------------------------------------------------------
# Q2d (freeform) basis
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _gamma(n: int, m: int) -> float:
    if n == 1 and m == 2:
        return 3 / 8
    if n == 1 and m > 2:
        mm1 = m - 1
        return ((2 * mm1 + 1) / (2 * (mm1 - 1))) * _gamma(1, mm1)
    nm1 = n - 1
    num = (nm1 + 1) * (2 * m + 2 * nm1 - 1)
    den = (m + nm1 - 2) * (2 * nm1 + 1)
    return (num / den) * _gamma(nm1, m)


@functools.lru_cache(maxsize=None)
def _g_q2d_raw(n: int, m: int) -> float:
    if n == 0:
        num = float(special.factorial2(2 * m - 1))
        den = 2 ** (m + 1) * float(special.factorial(m - 1))
        return num / den
    if n > 0 and m == 1:
        t1 = -(2 * n**2 - 1) * (n**2 - 1) / (8 * (4 * n**2 - 1))
        return t1 - (1 / 24 if n == 1 else 0.0)
    nt1 = 2 * n * (m + n - 1) - m
    nt2 = (n + 1) * (2 * m + 2 * n - 1)
    den = (m + 2 * n - 2) * (m + 2 * n - 1) * (m + 2 * n) * (2 * n + 1)
    return (-(nt1 * nt2) / den) * _gamma(n, m)


@functools.lru_cache(maxsize=None)
def _f_q2d_raw(n: int, m: int) -> float:
    if n == 0 and m == 1:
        return 0.25
    if n == 0:
        num = m**2 * float(special.factorial2(2 * m - 3))
        den = 2 ** (m + 1) * float(special.factorial(m - 1))
        return num / den
    if n > 0 and m == 1:
        t1 = (4 * (n - 1) ** 2 * n**2 + 1) / (8 * (2 * n - 1) ** 2)
        return t1 + (11 / 32 if n == 1 else 0.0)
    chi = m + n - 2
    nt1 = 2 * n * chi * (3 - 5 * m + 4 * n * chi)
    nt2 = m**2 * (3 - m + 4 * n * chi)
    den = ((m + 2 * n - 3) * (m + 2 * n - 2) * (m + 2 * n - 1)
           * (2 * n - 1))
    return ((nt1 + nt2) / den) * _gamma(n, m)


@functools.lru_cache(maxsize=None)
def _g_q2d(n: int, m: int) -> float:
    return _g_q2d_raw(n, m) / _f_q2d(n, m)


@functools.lru_cache(maxsize=None)
def _f_q2d(n: int, m: int) -> float:
    if n == 0:
        return _f_q2d_raw(0, m) ** 0.5
    return (_f_q2d_raw(n, m) - _g_q2d(n - 1, m) ** 2) ** 0.5


@functools.lru_cache(maxsize=None)
def q2d_basis_matrix(n_terms: int, m: int) -> np.ndarray:
    """(n, n) matrix with ds = T @ cns (the Q2d -> Pnm change of
    azimuthal order m, linearized)."""
    m = abs(m)
    n_max = n_terms - 1
    T = np.zeros((n_terms, n_terms))
    for col in range(n_terms):
        cns = np.zeros(n_terms)
        cns[col] = 1.0
        ds = np.zeros(n_terms)
        ds[n_max] = cns[n_max] / _f_q2d(n_max, m)
        for n in range(n_max - 1, -1, -1):
            ds[n] = (cns[n] - _g_q2d(n, m) * ds[n + 1]) / _f_q2d(n, m)
        T[:, col] = ds
    return T


_ABC_Q2D_SPECIAL = {
    (1, 0): (2, -1, 0),
    (1, 1): (-4 / 3, -8 / 3, -11 / 3),
    (1, 2): (9 / 5, -24 / 5, 0),
    (2, 0): (3, -2, 0),
    (3, 0): (5, -4, 0),
}


@functools.lru_cache(maxsize=None)
def _abc_q2d(n: int, m: int):
    d = (4 * n**2 - 1) * (m + n - 2) * (m + 2 * n - 3)
    if d == 0:
        d = 1e-99
    term1 = (2 * n - 1) * (m + 2 * n - 2)
    term2 = 4 * n * (m + n - 2) + (m - 3) * (2 * m - 1)
    a = (term1 * term2) / d
    b = (-2 * (2 * n - 1) * (m + 2 * n - 3) * (m + 2 * n - 2)
         * (m + 2 * n - 1)) / d
    c = (n * (2 * n - 3) * (m + 2 * n - 1) * (2 * m + 2 * n - 3)) / d
    return a, b, c


def abc_q2d_clenshaw(n: int, m: int):
    """The Clenshaw constants (a, b, c) of radial order n and azimuthal
    order m (the special low orders, then the closed form)."""
    return _ABC_Q2D_SPECIAL.get((m, n), _abc_q2d(n, m))


def clenshaw_q2d(cns, m: int, usq):
    """Clenshaw alphas of a Q2d order-m radial series: alpha0 and alpha3
    (for the m = 1 correction)."""
    n = len(cns)
    if n == 0:
        z = torch.zeros_like(usq)
        return z, z
    T = q2d_basis_matrix(n, m)
    ds = [sum(T[i, j] * cns[j] for j in range(n) if T[i, j] != 0.0)
          for i in range(n)]
    n_max = n - 1
    alphas = [torch.zeros_like(usq) for _ in range(n_max + 1)]
    alphas[n_max] = ds[n_max] + torch.zeros_like(usq)
    if n_max > 0:
        a, b, _ = abc_q2d_clenshaw(n_max - 1, m)
        alphas[n_max - 1] = ds[n_max - 1] + (a + b * usq) * alphas[n_max]
    for k in range(n_max - 2, -1, -1):
        a, b, _ = abc_q2d_clenshaw(k, m)
        _, _, c = abc_q2d_clenshaw(k + 1, m)
        alphas[k] = (ds[k] + (a + b * usq) * alphas[k + 1]
                     - c * alphas[k + 2])
    a3 = alphas[3] if n_max >= 3 else torch.zeros_like(usq)
    return alphas[0], a3


def q2d_series_sum(cns, m: int, usq):
    """S_m(u^2) = 0.5 alpha0 (- 2/5 alpha3 for m = 1 past three terms)."""
    n = len(cns)
    if n == 0:
        return torch.zeros_like(usq)
    a0, a3 = clenshaw_q2d(cns, m, usq)
    s = 0.5 * a0
    if m == 1 and n - 1 > 2:
        s = s - 2 / 5 * a3
    return s


def q2d_partition(nms):
    """Static layout: split (n, m_signed) index pairs into the m = 0, cos
    and sin groups of dense radial slots.

    Returns (cm0_slots, a_slots, b_slots): cm0_slots maps radial order n ->
    input index (or None); a_slots/b_slots are dicts m -> list (by n) of
    input indices (or None).
    """
    cm0: dict[int, int] = {}
    ac: dict[int, dict[int, int]] = {}
    bc: dict[int, dict[int, int]] = {}
    for idx, (n, m) in enumerate(nms):
        if m == 0:
            cm0[n] = idx
        elif m > 0:
            ac.setdefault(m, {})[n] = idx
        else:
            bc.setdefault(-m, {})[n] = idx
    max_n0 = max(cm0) if cm0 else -1
    cm0_slots = [cm0.get(n) for n in range(max_n0 + 1)]
    max_m = max([0, *ac.keys(), *bc.keys()])
    a_slots = {}
    b_slots = {}
    for m in range(1, max_m + 1):
        if m in ac:
            a_slots[m] = [ac[m].get(n) for n in range(max(ac[m]) + 1)]
        if m in bc:
            b_slots[m] = [bc[m].get(n) for n in range(max(bc[m]) + 1)]
    return cm0_slots, a_slots, b_slots
