"""optiland_torch's elementwise ray kernels (``ops/kernels.py``) against the
JAX package's (``optiland_tpu/ops/kernels.py``), on the CPU in float64.

The same random rays, normals, angles and indices (numpy, one seed) go
through both; the formulas are the same, so the tolerance is rounding only
(rtol 1e-13). A few rays are set up for total internal reflection, where
both give NaN directions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optiland_torch.ops import kernels as tk
from optiland_tpu.ops import kernels as jk

R = 64


def _inputs():
    rng = np.random.default_rng(11)
    pos = rng.normal(size=(3, R))
    d = rng.normal(size=(3, R))
    d[2] = np.abs(d[2]) + 0.5
    d /= np.linalg.norm(d, axis=0)
    n = rng.normal(size=(3, R))
    n /= np.linalg.norm(n, axis=0)
    n1 = rng.uniform(1.0, 1.8, size=R)
    n2 = rng.uniform(1.0, 1.8, size=R)
    n1[:4], n2[:4] = 1.9, 1.0  # steep and dense-to-thin: some TIR
    return {"pos": pos, "dir": d, "normal": n, "n1": n1, "n2": n2,
            "angle": rng.uniform(-0.5, 0.5, size=R),
            "raw": rng.normal(size=(3, R))}


CALLS = {
    "rotate_x": lambda m, a: m.rotate_x(a["pos"][1], a["pos"][2], a["dir"][1],
                                        a["dir"][2], a["angle"]),
    "rotate_y": lambda m, a: m.rotate_y(a["pos"][0], a["pos"][2], a["dir"][0],
                                        a["dir"][2], a["angle"]),
    "rotate_z": lambda m, a: m.rotate_z(a["pos"][0], a["pos"][1], a["dir"][0],
                                        a["dir"][1], a["angle"]),
    "align_normal": lambda m, a: m.align_normal(*a["dir"], *a["normal"]),
    "refract": lambda m, a: m.refract(*a["dir"], *a["normal"], a["n1"],
                                      a["n2"]),
    "reflect": lambda m, a: m.reflect(*a["dir"], *a["normal"]),
    "normalize": lambda m, a: m.normalize(*a["raw"]),
}


def _as(convert, tree):
    return {k: (convert(v) if v.ndim == 1 else [convert(r) for r in v])
            for k, v in tree.items()}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_kernel_matches_jax(name):
    a = _inputs()
    got = CALLS[name](tk, _as(torch.from_numpy, a))
    ref = CALLS[name](jk, _as(jnp.asarray, a))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-13,
                                   atol=1e-15)
    if name == "refract":
        assert np.isnan(got[0].numpy()).any()  # the TIR rays stay NaN
