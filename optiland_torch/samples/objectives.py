"""Sample objective lens systems.

Counterpart of ``optiland_tpu/samples/objectives.py``: the same published
prescriptions, built with the port's ``Optic``. This slice carries the Cooke
triplet, the system of the main path.
"""

from __future__ import annotations

import numpy as np

from optiland_torch.optic import Optic


class CookeTriplet(Optic):
    """Cooke triplet, f/5, 20-deg half field."""

    def __init__(self):
        super().__init__()
        self.surfaces.add(index=0, radius=np.inf, thickness=np.inf)
        self.surfaces.add(index=1, radius=22.01359, thickness=3.25896, material="SK16")
        self.surfaces.add(index=2, radius=-435.76044, thickness=6.00755)
        self.surfaces.add(
            index=3, radius=-22.21328, thickness=0.99997, material=("F2", "schott")
        )
        self.surfaces.add(index=4, radius=20.29192, thickness=4.75041, is_stop=True)
        self.surfaces.add(index=5, radius=79.68360, thickness=2.95208, material="SK16")
        self.surfaces.add(index=6, radius=-18.39533, thickness=42.20778)
        self.surfaces.add(index=7)

        self.set_aperture(aperture_type="EPD", value=10)
        self.fields.set_type(field_type="angle")
        self.fields.add(y=0)
        self.fields.add(y=14)
        self.fields.add(y=20)

        self.wavelengths.add(value=0.48)
        self.wavelengths.add(value=0.55, is_primary=True)
        self.wavelengths.add(value=0.65)
