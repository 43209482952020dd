"""``Optic.image_solve`` (``solves.QuickFocusSolve``) against the JAX
package's on examples/08's coated doublet at EPD 4 in H polarization (built
from each package's classes), on the CPU in float64: the solved thickness
before the image plane to rtol 1e-12 (both trace the same 5-ring hexapolar
fan through the same prescription; the focus is a mean of closed-form
per-ray distances)."""

import pytest

import torch_pol_systems as tps
from optiland_torch import config
from optiland_torch.samples import polarized


@pytest.fixture(autouse=True)
def _cpu_f64():
    config.set_device("cpu")
    config.set_precision("float64")
    yield


def test_image_solve_matches_jax():
    to = polarized.coated_doublet("H", epd=4.0)
    jo = polarized.coated_doublet("H", epd=4.0, classes=tps.classes("jax"))
    before = to.surfaces.surfaces[-2].thickness
    assert before == jo.surfaces.surfaces[-2].thickness
    to.image_solve()
    jo.image_solve()
    got = to.surfaces.surfaces[-2].thickness
    assert got == pytest.approx(jo.surfaces.surfaces[-2].thickness,
                                rel=1e-12)
    # the doublet at EPD 4 sat out of focus, and the rebuilt system has
    # the new thickness
    assert abs(got - before) > 1e-3
    assert float(to.system.stack.thickness[-2]) == pytest.approx(got,
                                                                 rel=1e-15)
