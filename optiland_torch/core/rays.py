"""Ray bundles as dataclasses of tensors.

Counterpart of ``optiland_tpu/core/rays.py``: structure-of-arrays bundles,
one flat tensor per component.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class RealRays:
    """A bundle of real rays in 3D space (SoA layout).

    Attributes:
        x, y, z: positions.
        L, M, N: direction cosines (normalized).
        i: intensity.
        w: wavelength in micrometers.
        opd: accumulated optical path length.
        L0, M0, N0: pre-interaction direction cosines of the most recent
            surface interaction (None before the first interaction).
    """

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    L: torch.Tensor
    M: torch.Tensor
    N: torch.Tensor
    i: torch.Tensor
    w: torch.Tensor
    opd: torch.Tensor
    L0: Optional[torch.Tensor] = None
    M0: Optional[torch.Tensor] = None
    N0: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, x, y, z, L, M, N, intensity, wavelength):
        """Build a bundle from broadcastable components (first tensor's
        dtype and device)."""
        ref = next((a for a in (x, y, z, L, M, N) if torch.is_tensor(a)), None)
        kw = {} if ref is None else {"dtype": ref.dtype, "device": ref.device}
        parts = [torch.atleast_1d(torch.as_tensor(a, **kw))
                 for a in (x, y, z, L, M, N, intensity, wavelength)]
        x, y, z, L, M, N, intensity, wavelength = torch.broadcast_tensors(*parts)
        return cls(x=x, y=y, z=z, L=L, M=M, N=N, i=intensity, w=wavelength,
                   opd=torch.zeros_like(x))

    @property
    def num_rays(self) -> int:
        return self.x.shape[0]
