"""Physical surface apertures: vignetting masks over local coordinates.

Counterpart of ``optiland_tpu/physical_apertures.py``: ``BaseAperture``
(the subclass registry, ``clip``, ``to_dict``/``from_dict``) and
``RadialAperture``, the annulus r_min <= r <= r_max that the plain engine
clips with and the trace kernels take as their ``ap_max``/``ap_min``
columns (a telescope's central obscuration). An aperture multiplies the
ray intensity by its mask and never removes a ray.

The other shapes (offset, elliptical, rectangular, polygon and file
apertures, and the boolean compositions) are ported in a later slice
(ROADMAP Queue 1 item 3); building one raises.
"""

from __future__ import annotations

import torch


class BaseAperture:
    _registry: dict[str, type] = {}

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        BaseAperture._registry[cls.__name__] = cls

    def contains(self, x, y):
        raise NotImplementedError

    def clip(self, intensity, x, y):
        """Zero intensity outside the aperture."""
        return torch.where(self.contains(x, y), intensity, 0.0)

    def to_dict(self):
        return {"type": type(self).__name__}

    @classmethod
    def from_dict(cls, data: dict) -> "BaseAperture":
        """Rebuild an aperture from its dict form (``to_dict``) through the
        subclass registry."""
        target = BaseAperture._registry.get(data["type"])
        if target is None:
            raise _later(data["type"])
        return target(**{k: v for k, v in data.items() if k != "type"})


class RadialAperture(BaseAperture):
    """Annular r_min <= r <= r_max aperture."""

    def __init__(self, r_max: float, r_min: float = 0.0):
        self.r_max = r_max
        self.r_min = r_min

    def contains(self, x, y):
        r2 = x**2 + y**2
        return (r2 <= self.r_max**2) & (r2 >= self.r_min**2)

    @property
    def extent(self):
        return (-self.r_max, self.r_max, -self.r_max, self.r_max)

    def scale(self, factor):
        self.r_max *= factor
        self.r_min *= factor

    def to_dict(self):
        return {**super().to_dict(), "r_max": self.r_max, "r_min": self.r_min}


def radial_only(apertures) -> bool:
    """True when every entry of a per-surface aperture tuple is None or a
    ``RadialAperture`` (exactly that type, as the JAX package's kernels
    check it)."""
    return apertures is None or all(
        a is None or type(a) is RadialAperture for a in apertures)


def _later(name):
    return NotImplementedError(
        f"{name} is ported with the other aperture shapes in a later slice "
        "(ROADMAP Queue 1 item 3); RadialAperture is ported"
    )


def _unported(name):
    def __init__(self, *args, **kwargs):
        raise _later(name)

    return type(name, (BaseAperture,), {"__init__": __init__,
                                        "__doc__": f"{name}: not ported yet."})


OffsetRadialAperture = _unported("OffsetRadialAperture")
EllipticalAperture = _unported("EllipticalAperture")
RectangularAperture = _unported("RectangularAperture")
PolygonAperture = _unported("PolygonAperture")
FileAperture = _unported("FileAperture")
UnionAperture = _unported("UnionAperture")
IntersectionAperture = _unported("IntersectionAperture")
DifferenceAperture = _unported("DifferenceAperture")
