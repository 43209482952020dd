"""Polarization: states, local s/p bases, Jones calculus.

Counterpart of ``optiland_tpu/polarization.py``, in complex torch tensors.
A polarized trace carries a per-ray 3x3 complex polarization matrix ``p``;
each surface updates it with p <- O_out J O_in p, where (s, p0, p1) is the
local basis bridging the pre- and post-interaction directions k0 and k1
and J the coating's Jones matrix in the (s, p, k) frame.
"""

from __future__ import annotations

import numpy as np
import torch


class PolarizationState:
    """Jones-vector polarization state."""

    def __init__(self, is_polarized: bool = False, Ex=None, Ey=None,
                 phase_x=None, phase_y=None):
        if is_polarized:
            if None in [Ex, Ey, phase_x, phase_y]:
                raise ValueError(
                    "All parameters must be provided for a polarized state."
                )
        elif not all(v is None for v in [Ex, Ey, phase_x, phase_y]):
            raise ValueError(
                "Ex, Ey, phase_x, and phase_y must be None for a "
                "non-polarized state."
            )
        self.is_polarized = is_polarized
        if is_polarized:
            mag = float(np.sqrt(Ex**2 + Ey**2))
            self.Ex = Ex / mag
            self.Ey = Ey / mag
            self.phase_x = phase_x
            self.phase_y = phase_y
        else:
            self.Ex = self.Ey = self.phase_x = self.phase_y = None

    def __str__(self):
        if self.is_polarized:
            return (
                f"Polarized Light: Ex: {self.Ex}, Ey: {self.Ey}, "
                f"Phase x: {self.phase_x}, Phase y: {self.phase_y}"
            )
        return "Unpolarized Light"

    __repr__ = __str__


def create_polarization(pol_type: str) -> PolarizationState:
    """Named polarization states: "unpolarized", "H", "V", "L+45",
    "L-45", "RCP", "LCP"."""
    if pol_type == "unpolarized":
        return PolarizationState(is_polarized=False)
    table = {
        "H": (1.0, 0.0, 0.0, 0.0),
        "V": (0.0, 1.0, 0.0, 0.0),
        "L+45": (np.sqrt(2) / 2, np.sqrt(2) / 2, 0.0, 0.0),
        "L-45": (np.sqrt(2) / 2, -np.sqrt(2) / 2, 0.0, 0.0),
        "RCP": (np.sqrt(2) / 2, np.sqrt(2) / 2, 0.0, -np.pi / 2),
        "LCP": (np.sqrt(2) / 2, np.sqrt(2) / 2, 0.0, np.pi / 2),
    }
    if pol_type not in table:
        raise ValueError(f"Invalid polarization type {pol_type!r}")
    Ex, Ey, px, py = table[pol_type]
    return PolarizationState(True, Ex, Ey, px, py)


def basis_states(state):
    """The incoherent states a trace sums: [state] when it is polarized,
    else the two orthogonal linear states."""
    if state is not None and state.is_polarized:
        return [state]
    return [PolarizationState(True, 1.0, 0.0, 0.0, 0.0),
            PolarizationState(True, 0.0, 1.0, 0.0, 0.0)]


def complex_dtype(real_dtype):
    """The complex dtype paired with a real working dtype: complex64 for
    float32, complex128 for float64."""
    return torch.complex64 if real_dtype == torch.float32 else torch.complex128


def _cross(a, b):
    return torch.stack(
        [
            a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
        ],
        dim=1,
    )


def _unit(k, i):
    e = torch.zeros_like(k)
    e[:, i] = 1.0
    return e


def local_basis(k0, k1):
    """Local s/p basis bridging pre/post directions, with the fallback of
    degenerate (parallel) directions: s from p_fb x k0, p_fb = k0 x xhat,
    or k0 x yhat where k0 is along x.

    Args:
        k0, k1: (R, 3) pre- and post-interaction unit directions.

    Returns:
        (s, p0, p1, o_in, o_out): basis vectors and rotation matrices; o_in
        rows are (s, p0, k0), o_out columns are (s, p1, k1).
    """
    s = _cross(k0, k1)
    degenerate = torch.linalg.norm(s, dim=1) < 1e-12
    p_fb = _cross(k0, _unit(k0, 0))
    p_fb = torch.where((torch.linalg.norm(p_fb, dim=1) < 1e-12)[:, None],
                       _cross(k0, _unit(k0, 1)), p_fb)
    s_fb = _cross(p_fb, k0)
    s = torch.where(degenerate[:, None], s_fb, s)
    s = s / torch.linalg.norm(s, dim=1)[:, None]
    p0 = _cross(k0, s)
    p1 = _cross(k1, s)
    o_in = torch.stack((s, p0, k0), dim=1)
    o_out = torch.stack((s, p1, k1), dim=2)
    return s, p0, p1, o_in, o_out


def update_p(p, L0, M0, N0, L, M, N, jones=None):
    """p <- O_out J O_in p; ``jones`` None is the identity."""
    k0 = torch.stack([L0, M0, N0], dim=1)
    k1 = torch.stack([L, M, N], dim=1)
    _, _, _, o_in, o_out = local_basis(k0, k1)
    if jones is None:
        surf = torch.einsum("nij,njk->nik", o_out, o_in).to(p.dtype)
    else:
        surf = torch.einsum("nij,njk,nkl->nil", o_out.to(jones.dtype), jones,
                            o_in.to(jones.dtype)).to(p.dtype)
    return torch.einsum("nij,njk->nik", surf, p)


def get_3d_electric_field(state: PolarizationState, L0, M0, N0):
    """Launch-space 3D E-field (R, 3) complex of a polarization state."""
    k = torch.stack([L0, M0, N0], dim=1)
    p = _cross(k, _unit(k, 0))
    norms = torch.linalg.norm(p, dim=1)
    p = p / torch.where(norms == 0, 1.0, norms)[:, None]
    s = _cross(p, k)
    cd = complex_dtype(k.dtype)
    ex = complex(np.exp(1j * state.phase_x)) * state.Ex
    ey = complex(np.exp(1j * state.phase_y)) * state.Ey
    return s.to(cd) * ex + p.to(cd) * ey


def _fields(p, state, L0, M0, N0):
    return [torch.einsum("nij,nj->ni", p,
                         get_3d_electric_field(st, L0, M0, N0).to(p.dtype))
            for st in basis_states(state)]


def polarized_intensity(p, state, L0, M0, N0, i0):
    """Final intensity from the accumulated polarization matrices: the mean
    over the incoherent states of |p E0|^2, times the launch intensity."""
    fields = _fields(p, state, L0, M0, N0)
    intensity = torch.zeros_like(i0)
    for E1 in fields:
        intensity = intensity + torch.sum(E1.real**2 + E1.imag**2, dim=1)
    return intensity * i0 / len(fields)


def exit_fields(p, state, L0, M0, N0, i0):
    """Exit 3D electric field(s) from the accumulated polarization
    matrices: a list of (R, 3) complex tensors, one field for polarized
    light, two orthogonal incoherent fields (each scaled by 1/sqrt(2)) for
    unpolarized light."""
    fields = _fields(p, state, L0, M0, N0)
    scale = torch.sqrt(i0 / len(fields))[:, None]
    return [E1 * scale for E1 in fields]


# ---------------------------------------------------------------------------
# Jones matrices: (ray arrays, reflect, aoi) -> (R, 3, 3) complex
# ---------------------------------------------------------------------------


def _jones3(R, dtype, device, j00, j01=0.0, j10=0.0, j11=None, j22=1.0):
    """(R, 3, 3) complex matrix [[j00, j01, 0], [j10, j11, 0], [0, 0, j22]]
    from per-ray entries or numbers (j11 defaults to j00)."""
    cd = complex_dtype(dtype)

    def col(v):
        v = torch.as_tensor(v, device=device)
        return (v.to(cd) if v.is_complex() else v.to(dtype).to(cd)).expand(R)

    zero = torch.zeros(R, dtype=cd, device=device)
    j11 = j00 if j11 is None else j11
    rows = [[col(j00), col(j01), zero], [col(j10), col(j11), zero],
            [zero, zero, col(j22)]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


class BaseJones:
    """Base Jones model: the identity."""

    def calculate_matrix(self, L0, M0, N0, L, M, N, w, reflect=False,
                         aoi=None):
        return _jones3(L0.shape[0], L0.dtype, L0.device, 1.0)


class JonesFresnel(BaseJones):
    """Fresnel amplitude coefficients at a bare interface."""

    def __init__(self, material_pre, material_post):
        self.material_pre = material_pre
        self.material_post = material_post

    def calculate_matrix(self, L0, M0, N0, L, M, N, w, reflect=False,
                         aoi=None):
        cd = complex_dtype(L0.dtype)
        n1 = self.material_pre.n(w).to(L0.dtype)
        n2 = self.material_post.n(w).to(L0.dtype)
        cos_i = torch.cos(aoi)
        n = n2 / n1
        root = torch.sqrt((n**2 - torch.sin(aoi) ** 2).to(cd))
        R = L0.shape[0]
        if reflect:
            s = (cos_i - root) / (cos_i + root)
            p = (n**2 * cos_i - root) / (n**2 * cos_i + root)
            return _jones3(R, L0.dtype, L0.device, s, j11=-p, j22=-1.0)
        s = 2 * cos_i / (cos_i + root)
        p = 2 * n * cos_i / (n**2 * cos_i + root)
        return _jones3(R, L0.dtype, L0.device, s, j11=p)


class JonesLinearPolarizer(BaseJones):
    """Linear polarizer with a global-frame transmission axis."""

    def __init__(self, axis):
        axis = np.asarray(axis, float)
        self.axis = axis / np.linalg.norm(axis)

    def calculate_matrix(self, L0, M0, N0, L, M, N, w, reflect=False,
                         aoi=None):
        k0 = torch.stack([L0, M0, N0], dim=1)
        k1 = torch.stack([L, M, N], dim=1)
        s, p0, p1, _, _ = local_basis(k0, k1)
        axis = torch.as_tensor(self.axis, dtype=k0.dtype, device=k0.device)
        ts = torch.sum(axis * s, dim=1)
        tp_in = torch.sum(axis * p0, dim=1)
        tp_out = torch.sum(axis * p1, dim=1)
        norm_in = torch.sqrt(ts**2 + tp_in**2)
        norm_in = torch.where(norm_in == 0, 1.0, norm_in)
        norm_out = torch.sqrt(ts**2 + tp_out**2)
        norm_out = torch.where(norm_out == 0, 1.0, norm_out)
        us_in, up_in = ts / norm_in, tp_in / norm_in
        us_out, up_out = ts / norm_out, tp_out / norm_out
        return _jones3(L0.shape[0], L0.dtype, L0.device, us_out * us_in,
                       us_out * up_in, up_out * us_in, up_out * up_in)


class JonesPolarizerH(JonesLinearPolarizer):
    def __init__(self):
        super().__init__([1, 0, 0])


class JonesPolarizerV(JonesLinearPolarizer):
    def __init__(self):
        super().__init__([0, 1, 0])


class JonesPolarizerL45(JonesLinearPolarizer):
    def __init__(self):
        v = 1 / np.sqrt(2)
        super().__init__([v, v, 0])


class JonesPolarizerL135(JonesLinearPolarizer):
    def __init__(self):
        v = 1 / np.sqrt(2)
        super().__init__([-v, v, 0])


class ConstantJones(BaseJones):
    """Constant 2x2 Jones block in the local frame."""

    def __init__(self, j00, j01, j10, j11):
        self.j = (j00, j01, j10, j11)

    def calculate_matrix(self, L0, M0, N0, L, M, N, w, reflect=False,
                         aoi=None):
        j = [complex(v) for v in self.j]
        return _jones3(L0.shape[0], L0.dtype, L0.device, j[0], j[1], j[2],
                       j[3])


class JonesPolarizerRCP(ConstantJones):
    def __init__(self):
        super().__init__(0.5, 0.5j, -0.5j, 0.5)


class JonesPolarizerLCP(ConstantJones):
    def __init__(self):
        super().__init__(0.5, -0.5j, 0.5j, 0.5)


def _axis_from(axis, theta):
    if axis is not None and np.size(np.asarray(axis)) == 1:
        theta = float(np.asarray(axis))
        axis = None
    if axis is not None:
        axis = np.asarray(axis, float)
        return axis / np.linalg.norm(axis)
    if theta is not None:
        return np.array([np.cos(theta), np.sin(theta), 0.0])
    return np.array([1.0, 0.0, 0.0])


def _in_plane_axis(axis, L0, M0, N0, L, M, N):
    k0 = torch.stack([L0, M0, N0], dim=1)
    k1 = torch.stack([L, M, N], dim=1)
    s, p0, _, _, _ = local_basis(k0, k1)
    axis_b = torch.as_tensor(axis, dtype=k0.dtype, device=k0.device)
    ts = torch.sum(axis_b * s, dim=1)
    tp = torch.sum(axis_b * p0, dim=1)
    norm = torch.sqrt(ts**2 + tp**2)
    norm = torch.where(norm == 0, 1.0, norm)
    return ts / norm, tp / norm


class JonesLinearDiattenuator(BaseJones):
    """Partial linear polarizer."""

    def __init__(self, t_min, t_max, axis=None, *, theta=None):
        self.t_min = t_min
        self.t_max = t_max
        self.axis = _axis_from(axis, theta)

    def calculate_matrix(self, L0, M0, N0, L, M, N, w, reflect=False,
                         aoi=None):
        us, up = _in_plane_axis(self.axis, L0, M0, N0, L, M, N)
        j00 = self.t_max * us**2 + self.t_min * up**2
        j0x = (self.t_max - self.t_min) * us * up
        j11 = self.t_max * up**2 + self.t_min * us**2
        return _jones3(L0.shape[0], L0.dtype, L0.device, j00, j0x, j0x, j11)


class JonesLinearRetarder(BaseJones):
    """Linear retarder of given retardance."""

    def __init__(self, retardance, axis=None, *, theta=None):
        self.retardance = retardance
        self.axis = _axis_from(axis, theta)

    def calculate_matrix(self, L0, M0, N0, L, M, N, w, reflect=False,
                         aoi=None):
        d = self.retardance
        us, up = _in_plane_axis(self.axis, L0, M0, N0, L, M, N)
        em, ep = complex(np.exp(-1j * d / 2)), complex(np.exp(1j * d / 2))
        j00 = em * us**2 + ep * up**2
        j0x = complex(-2j * np.sin(d / 2)) * us * up
        j11 = ep * us**2 + em * up**2
        return _jones3(L0.shape[0], L0.dtype, L0.device, j00, j0x, j0x, j11)


class JonesQuarterWaveRetarder(JonesLinearRetarder):
    def __init__(self, axis=None, *, theta=None):
        super().__init__(np.pi / 2, axis=axis, theta=theta)


class JonesHalfWaveRetarder(JonesLinearRetarder):
    def __init__(self, axis=None, *, theta=None):
        super().__init__(np.pi, axis=axis, theta=theta)


class JonesThinFilm(BaseJones):
    """Jones model from a thin-film stack's complex r/t coefficients."""

    def __init__(self, stack):
        self.stack = stack

    def calculate_matrix(self, L0, M0, N0, L, M, N, w, reflect=False,
                         aoi=None):
        rs, ts, _, _, _ = self.stack.compute_rtRTA(w, aoi, "s")
        rp, tp, _, _, _ = self.stack.compute_rtRTA(w, aoi, "p")
        R = L0.shape[0]
        if reflect:
            return _jones3(R, L0.dtype, L0.device, rs.reshape(-1),
                           j11=-rp.reshape(-1), j22=-1.0)
        return _jones3(R, L0.dtype, L0.device, ts.reshape(-1),
                       j11=tp.reshape(-1))


__all__ = [
    "BaseJones",
    "ConstantJones",
    "JonesFresnel",
    "JonesHalfWaveRetarder",
    "JonesLinearDiattenuator",
    "JonesLinearPolarizer",
    "JonesLinearRetarder",
    "JonesPolarizerH",
    "JonesPolarizerL135",
    "JonesPolarizerL45",
    "JonesPolarizerLCP",
    "JonesPolarizerRCP",
    "JonesPolarizerV",
    "JonesQuarterWaveRetarder",
    "JonesThinFilm",
    "PolarizationState",
    "basis_states",
    "complex_dtype",
    "create_polarization",
    "exit_fields",
    "get_3d_electric_field",
    "local_basis",
    "polarized_intensity",
    "update_p",
]
