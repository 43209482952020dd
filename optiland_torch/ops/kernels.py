"""Pure elementwise ray kernels: rotation, refraction, reflection, normalize.

Counterpart of ``optiland_tpu/ops/kernels.py``: the vector-physics building
blocks of the per-surface trace step as pure functions over per-ray tensors
(vector Snell refraction with incident-aligned normals, mirror reflection,
Euler-angle bundle rotations). Vignetted rays are masked by intensity by
the callers and never removed, so shapes stay fixed.
"""

from __future__ import annotations

import torch


def rotate_x(y, z, M, N, rx):
    """Rotate positions/directions about the x-axis by angle rx."""
    c, s = torch.cos(rx), torch.sin(rx)
    return y * c - z * s, y * s + z * c, M * c - N * s, M * s + N * c


def rotate_y(x, z, L, N, ry):
    """Rotate positions/directions about the y-axis by angle ry."""
    c, s = torch.cos(ry), torch.sin(ry)
    return x * c + z * s, -x * s + z * c, L * c + N * s, -L * s + N * c


def rotate_z(x, y, L, M, rz):
    """Rotate positions/directions about the z-axis by angle rz."""
    c, s = torch.cos(rz), torch.sin(rz)
    return x * c - y * s, x * s + y * c, L * c - M * s, L * s + M * c


def align_normal(L, M, N, nx, ny, nz):
    """Flip surface normals to point against the incident rays.

    Returns the aligned (nx, ny, nz) and |cos| of the incidence angle.
    """
    dot = L * nx + M * ny + N * nz
    sgn = torch.sign(dot)
    return nx * sgn, ny * sgn, nz * sgn, torch.abs(dot)


def refract(L, M, N, nx, ny, nz, n1, n2):
    """Vector Snell refraction.

    Total internal reflection gives NaN directions, as in the JAX package;
    callers mask intensity.
    """
    u = n1 / n2
    nx, ny, nz, dot = align_normal(L, M, N, nx, ny, nz)
    root = torch.sqrt(1 - u**2 * (1 - dot**2))
    tx = u * L + nx * root - u * nx * dot
    ty = u * M + ny * root - u * ny * dot
    tz = u * N + nz * root - u * nz * dot
    return tx, ty, tz


def reflect(L, M, N, nx, ny, nz):
    """Mirror reflection about the (incident-aligned) surface normal."""
    nx, ny, nz, dot = align_normal(L, M, N, nx, ny, nz)
    return L - 2 * dot * nx, M - 2 * dot * ny, N - 2 * dot * nz


def normalize(L, M, N):
    """Normalize direction cosines."""
    mag = torch.sqrt(L**2 + M**2 + N**2)
    return L / mag, M / mag, N / mag
