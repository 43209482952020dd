"""Glass catalog loading and by-name material resolution.

Counterpart of ``optiland_tpu/materials/catalog.py``. The port reads the JAX
package's catalog files in place, by path (``catalog_arrays.npz`` and
``catalog_index.json`` under ``optiland_tpu/database/``); it imports nothing
of that package.

Name resolution mirrors the JAX package: case-insensitive substring
pre-filter on category/name/file-stem, optional reference filter, optional
wavelength-range filter, then ranking by the minimum Levenshtein distance of
the query against the three name columns, with catalog order breaking ties.
"""

from __future__ import annotations

import json
import os
from functools import lru_cache

import numpy as np

DB_DIR = os.path.normpath(
    os.path.join(os.path.dirname(__file__), "..", "..", "optiland_tpu", "database")
)


class Catalog:
    """In-memory columnar view of the glass catalog."""

    def __init__(self, arrays, index):
        self.arrays = arrays
        self.index = index  # list of dicts (string metadata)
        self._lc_category = [m["category_name"].lower() for m in index]
        self._lc_category_full = [m["category_name_full"].lower() for m in index]
        self._lc_reference = [str(m["reference"]).lower() for m in index]
        self._lc_name = [str(m["name"]).lower() for m in index]
        self._lc_filename = [m["filename"].lower() for m in index]
        self._lc_stem = [str(m["filename_no_ext"]).lower() for m in index]

    def __len__(self):
        return len(self.index)

    def payload(self, i: int) -> dict:
        """Return the numeric dispersion payload for catalog row ``i``."""
        a = self.arrays
        co, no, ko, to = (
            a["coeffs_off"], a["ntab_off"], a["ktab_off"], a["therm_off"],
        )
        return {
            "formula_code": int(a["formula_code"][i]),
            "coefficients": np.asarray(a["coeffs"][co[i] : co[i + 1]]),
            "n_table": np.asarray(a["ntab"][no[i] : no[i + 1]]),
            "k_table": np.asarray(a["ktab"][ko[i] : ko[i + 1]]),
            "therm_coeffs": np.asarray(a["therm"][to[i] : to[i + 1]]),
            "t0": float(a["t0"][i]),
            "nd": float(a["nd"][i]),
            "vd": float(a["vd"][i]),
            "min_wavelength": float(a["min_wavelength"][i]),
            "max_wavelength": float(a["max_wavelength"][i]),
            **self.index[i],
        }

    def find(
        self,
        name: str,
        reference: str | None = None,
        min_wavelength: float | None = None,
        max_wavelength: float | None = None,
        robust: bool = True,
    ) -> dict:
        """Resolve a material by name; returns its payload dict.

        Raises ValueError when no match exists, or when ``robust`` is False
        and multiple equally-good matches exist.
        """
        q = name.lower()
        cands = [
            i for i in range(len(self.index))
            if q in self._lc_category[i] or q in self._lc_name[i]
            or q in self._lc_stem[i]
        ]
        if reference:
            r = reference.lower()
            cands = [
                i for i in cands
                if r in self._lc_category[i] or r in self._lc_category_full[i]
                or r in self._lc_reference[i] or r in self._lc_name[i]
                or r in self._lc_filename[i]
            ]
        a = self.arrays
        for wl in (min_wavelength, max_wavelength):
            if wl is not None:
                cands = [
                    i for i in cands
                    if a["min_wavelength"][i] <= wl <= a["max_wavelength"][i]
                ]
        if not cands:
            raise ValueError(
                f"No matches found for material {name}"
                + (f" with reference {reference}" if reference else "")
            )

        scores = [
            min(
                _levenshtein(q, self._lc_category[i]),
                _levenshtein(q, self._lc_name[i]),
                _levenshtein(q, self._lc_stem[i]),
            )
            for i in cands
        ]
        order = sorted(range(len(cands)), key=lambda j: scores[j])
        best = order[0]
        if scores[best] > 0 and not robust:
            raise ValueError(f"No exact match found for material {name}")
        if not robust and len(order) > 1 and scores[order[1]] == scores[best]:
            raise ValueError(f"Multiple matches found for material {name}")
        return self.payload(cands[best])


def _levenshtein(s1: str, s2: str) -> int:
    """Edit distance between two strings (iterative two-row algorithm)."""
    if len(s1) < len(s2):
        s1, s2 = s2, s1
    prev = list(range(len(s2) + 1))
    for i, c1 in enumerate(s1, 1):
        cur = [i]
        for j, c2 in enumerate(s2, 1):
            cur.append(min(prev[j] + 1, cur[-1] + 1, prev[j - 1] + (c1 != c2)))
        prev = cur
    return prev[-1]


@lru_cache(maxsize=1)
def get_catalog() -> Catalog:
    """Load (and cache) the glass catalog from the JAX package's data files."""
    arrays = dict(np.load(os.path.join(DB_DIR, "catalog_arrays.npz")))
    with open(os.path.join(DB_DIR, "catalog_index.json")) as f:
        index = json.load(f)
    return Catalog(arrays, index)
