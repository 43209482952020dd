"""optiland_torch: the PyTorch and CUDA port of optiland_tpu.

The package mirrors ``optiland_tpu``'s module layout so that every ported
module has an obvious counterpart. It imports torch and numpy only; the
CUDA kernels under ``csrc/`` are built on first use on a CUDA device.
"""

from optiland_torch import config
from optiland_torch.config import set_device, set_precision

__all__ = ["config", "set_device", "set_precision"]
