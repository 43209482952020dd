"""Analysis: functional spot metrics (``spot``). The other analyses of the
JAX package (SpotDiagram, aberrations, wavefront, PSF, MTF, ...) are ported
in later slices."""

from optiland_torch.analysis.spot import SpotData, rms_spot_size, spot_coordinates

__all__ = ["SpotData", "rms_spot_size", "spot_coordinates"]
