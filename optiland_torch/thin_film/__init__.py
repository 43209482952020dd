"""Thin-film coatings: transfer-matrix method stacks.

Counterpart of ``optiland_tpu/thin_film``: ``Layer``, ``ThinFilmStack`` and
``tmm_coherent``, which the thin-film coating evaluates. The spectral
analysis, optimization and tolerancing modules wait for a later slice.
"""

from optiland_torch.thin_film.stack import Layer, ThinFilmStack, tmm_coherent

__all__ = ["Layer", "ThinFilmStack", "tmm_coherent"]
