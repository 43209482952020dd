"""The polarized test systems of the port's tests, built with either
package's Optic: ``build(kind, "torch")`` or ``build(kind, "jax")``. The
systems are the JAX suite's own (``tests/test_pallas_pol.py``: the coated
doublet, the two-mirror system, the thin-film coated doublet), each with one
coating kind on its surfaces, defined once in ``optiland_torch.samples.
polarized`` and built here from either package's classes. Nothing of the
JAX package is imported for "torch", so the CUDA tests can use this module
where only the port is installed.
"""

import dataclasses
import importlib

import numpy as np

from optiland_torch.samples import polarized

KINDS = polarized.KINDS


def classes(package):
    """The port's classes (None: the samples' default) or the JAX
    package's, for the samples' builders."""
    if package == "torch":
        return None
    return (importlib.import_module("optiland_tpu.optic").Optic,
            importlib.import_module("optiland_tpu.coatings"),
            importlib.import_module("optiland_tpu.materials").IdealMaterial,
            importlib.import_module("optiland_tpu.thin_film").ThinFilmStack)


def tmm_coating(package, n_layers=2, substrate=1.52, absorbing=False):
    """``samples.polarized.ar_coating`` in ``package``."""
    return polarized.ar_coating(n_layers, substrate, absorbing,
                                classes=classes(package))


def pol_doublet(package, pol="H", coat="fresnel", coat2=None, epd=20.0):
    """``samples.polarized.coated_doublet`` in ``package``."""
    return polarized.coated_doublet(pol, coat, coat2, epd,
                                    classes=classes(package))


def build(kind, package, pol="H"):
    """The optic of one coat kind (``KINDS``) in ``package``."""
    return polarized.polarized_system(kind, pol, classes=classes(package))


def pupil(n, seed, r_max=0.95):
    """``n`` pupil points (Px, Py) uniform on a disk of radius ``r_max``,
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    r = np.sqrt(rng.uniform(size=n)) * r_max
    th = rng.uniform(0, 2 * np.pi, n)
    return r * np.cos(th), r * np.sin(th)


def jax_coating_record(c):
    """A JAX package coating as the port's record, with numpy."""
    def mat(m):
        return (int(m.formula_code),
                tuple(float(v) for v in np.ravel(m.coefficients)),
                tuple(tuple(float(v) for v in r)
                      for r in np.asarray(m.n_table, float).reshape(-1, 2)),
                tuple(tuple(float(v) for v in r)
                      for r in np.asarray(m.k_table, float).reshape(-1, 2)))

    if c is None:
        return None
    name = type(c).__name__
    if name == "SimpleCoating":
        return ("simple", float(c.transmittance), float(c.reflectance))
    if name == "FresnelCoating":
        return ("fresnel", mat(c.material_pre), mat(c.material_post))
    if name == "PolarizerCoating":
        return ("polarizer", tuple(float(v) for v in c._jones.axis))
    if name == "RetarderCoating":
        return ("retarder", float(c._jones.retardance),
                tuple(float(v) for v in c._jones.axis))
    st = c.stack
    return ("thin_film", mat(st.incident_material),
            mat(st.substrate_material),
            tuple((mat(l.material), float(l.thickness_um))
                  for l in st.layers))


def carried(jsys):
    """The JAX system through system_from_numpy, coatings and apertures as
    records."""
    from optiland_torch.core.system import (
        STACK_FIELDS, SYSTEM_FIELDS, system_from_numpy,
    )

    arrays = {k: np.asarray(getattr(jsys.stack, k)) for k in STACK_FIELDS}
    arrays.update({k: np.asarray(getattr(jsys, k)) for k in SYSTEM_FIELDS})
    cfg = {f.name: getattr(jsys.cfg, f.name)
           for f in dataclasses.fields(jsys.cfg)}
    cfg["coatings"] = tuple(jax_coating_record(c) for c in cfg["coatings"])
    if cfg["apertures"] is not None:
        cfg["apertures"] = tuple(None if a is None else a.to_dict()
                                 for a in cfg["apertures"])
    return system_from_numpy(arrays, cfg)
