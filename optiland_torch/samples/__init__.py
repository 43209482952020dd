"""Sample optical systems. This slice carries the Cooke triplet; the other
hand-written and registry systems follow in later slices."""

from optiland_torch.samples.objectives import CookeTriplet

__all__ = ["CookeTriplet"]
