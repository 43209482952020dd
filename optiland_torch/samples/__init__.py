"""Sample optical systems: the Cooke triplet, and the polarized systems of
``samples.polarized`` (examples/08's coated singlet, its coat-kind variants
and bench.py's polarized classes), and the tilted and re-dispersed variants
of ``samples.perturbed`` (the toleranced Cooke triplet, the tilted singlet,
the Cooke triplet with every other formula code, the tilted asphere), the
aspheric singlet, the freeform singlets of ``samples.freeform``, and the
systems of the JAX package's ``samples.json`` that the port can build
(``samples.registry``). The other hand-written systems follow in later
slices."""

from optiland_torch.samples.objectives import AsphericSinglet, CookeTriplet

__all__ = ["AsphericSinglet", "CookeTriplet"]
