from optiland_torch.optic.optic import Optic

__all__ = ["Optic"]
