"""Pupil sampling distributions.

Counterpart of ``optiland_tpu/core/distributions.py`` (numpy only; the port
keeps its own copy): normalized pupil coordinates (Px, Py) for ray
launching. Point generation happens on the host; the arrays feed the
trace.
"""

from __future__ import annotations

import numpy as np


class BaseDistribution:
    """Base class; subclasses fill self.x / self.y in generate_points."""

    def __init__(self):
        self.x = None
        self.y = None

    @property
    def dx(self):
        return self.x

    @property
    def dy(self):
        return self.y

    def generate_points(self, num_points: int):
        raise NotImplementedError


class LineXDistribution(BaseDistribution):
    """Evenly spaced points along the x-axis."""

    def __init__(self, positive_only: bool = False):
        super().__init__()
        self.positive_only = positive_only

    def generate_points(self, num_points: int):
        lo = 0.0 if self.positive_only else -1.0
        self.x = np.linspace(lo, 1.0, num_points)
        self.y = np.zeros(num_points)
        return self


class LineYDistribution(BaseDistribution):
    """Evenly spaced points along the y-axis."""

    def __init__(self, positive_only: bool = False):
        super().__init__()
        self.positive_only = positive_only

    def generate_points(self, num_points: int):
        lo = 0.0 if self.positive_only else -1.0
        self.x = np.zeros(num_points)
        self.y = np.linspace(lo, 1.0, num_points)
        return self


class RandomDistribution(BaseDistribution):
    """Uniform random points in the unit disk."""

    def __init__(self, seed=None):
        super().__init__()
        self.rng = np.random.default_rng(seed)

    def generate_points(self, num_points: int):
        r = self.rng.uniform(size=num_points)
        theta = self.rng.uniform(0, 2 * np.pi, size=num_points)
        self.x = np.sqrt(r) * np.cos(theta)
        self.y = np.sqrt(r) * np.sin(theta)
        return self


class UniformDistribution(BaseDistribution):
    """Square grid clipped to the unit disk."""

    def generate_points(self, num_points: int):
        x = np.linspace(-1.0, 1.0, num_points)
        x, y = np.meshgrid(x, x)
        r2 = x**2 + y**2
        mask = r2 <= 1
        self.x = x[mask].ravel()
        self.y = y[mask].ravel()
        return self


class HexagonalDistribution(BaseDistribution):
    """Hexapolar ring pattern: the origin, then ring i (1-based) of 6 i
    points at radius i / num_rings. The rings are joined once at the end,
    so a pattern of millions of points takes one copy."""

    def generate_points(self, num_rings: int = 6):
        xs, ys = [np.zeros(1)], [np.zeros(1)]
        r = np.linspace(0, 1, num_rings + 1)
        for i in range(num_rings):
            num_theta = 6 * (i + 1)
            theta = np.linspace(0, 2 * np.pi, num_theta + 1)[:-1]
            xs.append(r[i + 1] * np.cos(theta))
            ys.append(r[i + 1] * np.sin(theta))
        self.x = np.concatenate(xs)
        self.y = np.concatenate(ys)
        return self


class CrossDistribution(BaseDistribution):
    """Cross-shaped pattern along both axes."""

    def generate_points(self, num_points: int):
        y_line_x = np.zeros(num_points)
        y_line_y = np.linspace(-1.0, 1.0, num_points)
        x_line_x = np.linspace(-1.0, 1.0, num_points)
        x_line_y = np.zeros(num_points)
        if num_points % 2 == 1:
            # drop the duplicated origin from the x-line
            mid = num_points // 2
            x_line_x = np.concatenate((x_line_x[:mid], x_line_x[mid + 1 :]))
            x_line_y = np.concatenate((x_line_y[:mid], x_line_y[mid + 1 :]))
        self.x = np.concatenate((y_line_x, x_line_x))
        self.y = np.concatenate((y_line_y, x_line_y))
        return self


class RingDistribution(BaseDistribution):
    """Points along the unit-radius ring."""

    def generate_points(self, num_points: int):
        theta = np.linspace(0, 2 * np.pi, num_points + 1)[:-1]
        self.x = np.cos(theta)
        self.y = np.sin(theta)
        return self


class SobolDistribution(BaseDistribution):
    """Low-discrepancy Sobol points in the unit disk."""

    def __init__(self, seed=None):
        super().__init__()
        self.seed = seed

    def generate_points(self, num_points: int):
        from scipy.stats import qmc

        sampler = qmc.Sobol(d=2, scramble=True, seed=self.seed)
        pts = sampler.random(num_points)
        r = np.sqrt(pts[:, 0])
        theta = 2 * np.pi * pts[:, 1]
        self.x = r * np.cos(theta)
        self.y = r * np.sin(theta)
        return self


class GaussianQuadrature(BaseDistribution):
    """Gauss-Legendre radial nodes x equally spaced spokes for pupil
    integration (G. W. Forbes, "Optical system assessment for design",
    JOSA A 5, 1943 (1988))."""

    def generate_points(self, num_rings: int, num_spokes: int | None = None):
        if num_rings < 1 or (num_spokes is not None and num_spokes < 1):
            raise ValueError("The number of rings or spokes has to be >= 1")
        k = 4 * num_rings + 3 if num_spokes is None else num_spokes - 1
        theta_i = 2 * np.pi / (k + 1) * np.arange(1, k + 2)
        xi, wi = np.polynomial.legendre.leggauss(num_rings)
        ri = np.sqrt(0.5 + 0.5 * xi)
        wi = 0.5 * wi / (k + 1)
        self.weights = np.tile(wi, k + 1)
        rr, tt = np.meshgrid(ri, theta_i)
        self.x = (rr * np.cos(tt)).ravel()
        self.y = (rr * np.sin(tt)).ravel()
        return self


_DISTRIBUTIONS = {
    "line_x": LineXDistribution,
    "line_y": LineYDistribution,
    "positive_line_x": lambda: LineXDistribution(positive_only=True),
    "positive_line_y": lambda: LineYDistribution(positive_only=True),
    "random": RandomDistribution,
    "uniform": UniformDistribution,
    "hexapolar": HexagonalDistribution,
    "cross": CrossDistribution,
    "ring": RingDistribution,
    "sobol": SobolDistribution,
    "gaussian_quad": GaussianQuadrature,
}


def create_distribution(distribution_type: str) -> BaseDistribution:
    """The distribution registered under ``distribution_type``."""
    if distribution_type not in _DISTRIBUTIONS:
        raise ValueError(f"Invalid distribution type: {distribution_type}")
    return _DISTRIBUTIONS[distribution_type]()
