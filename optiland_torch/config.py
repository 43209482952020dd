"""Global numeric configuration for optiland_torch: working dtype and device.

Counterpart of ``optiland_tpu/config.py``. The working dtype defaults to
float64, as in the JAX package, so parity runs need no set-up; the fast
path on the card runs float32 after ``set_precision("float32")``.

The device defaults to ``"cuda"``: every entry point runs on the card
unless the caller asks for the CPU with ``set_device("cpu")``. Nothing here
falls back to the CPU when no card is present — :func:`device` raises.
"""

from __future__ import annotations

import torch

_PRECISIONS = {
    "float32": torch.float32,
    "float64": torch.float64,
}

_working_dtype = torch.float64
_device = "cuda"


def set_precision(precision: str) -> None:
    """Set the working floating-point precision ("float32" or "float64")."""
    global _working_dtype
    if precision not in _PRECISIONS:
        raise ValueError(
            f"Unknown precision {precision!r}; expected one of {list(_PRECISIONS)}"
        )
    _working_dtype = _PRECISIONS[precision]


def get_precision() -> str:
    """Return the current working precision as a string."""
    return "float64" if _working_dtype == torch.float64 else "float32"


def dtype() -> torch.dtype:
    """Return the current working dtype."""
    return _working_dtype


def set_device(dev: str) -> None:
    """Set the device that systems are built on ("cuda", "cuda:N" or "cpu")."""
    global _device
    kind = torch.device(dev).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"Unknown device {dev!r}; expected 'cuda' or 'cpu'")
    _device = str(dev)


def get_device() -> str:
    """Return the configured device string (unchecked)."""
    return _device


def device() -> torch.device:
    """The configured device, checked: raises when it is CUDA and no card
    is present."""
    dev = torch.device(_device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "optiland_torch is configured for a CUDA device but "
            "torch.cuda.is_available() is False; to run on the CPU, call "
            "optiland_torch.config.set_device('cpu') first."
        )
    return dev
