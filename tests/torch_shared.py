"""A reference result computed once per test session and read by every
pytest-xdist worker that needs it.

The port's parity tests compare against JAX references that take tens of
seconds to compile (interpret-mode Pallas kernels, ``jax.grad`` of whole
traces). A module-scoped fixture runs again on every worker that gets one
of the module's tests, and ``--dist load`` spreads a module's tests over
several workers. ``shared`` computes the reference on the first worker to
ask for it and stores it, as numpy (``to_numpy``), in the session's
temporary directory, which the workers share; a worker that asks while it
is being computed waits on a file lock instead of compiling it again. The
values are the same whichever worker computes them.
"""

import dataclasses
import fcntl
import os
import pickle
import re
from types import SimpleNamespace

import numpy as np


def to_numpy(value):
    """``value`` with every array as a numpy array and every result object
    (a dataclass, or an object's attributes) as a SimpleNamespace of its
    fields, so that it pickles."""
    if value is None or isinstance(value, (bool, int, float, str,
                                           np.ndarray, np.generic)):
        return value
    if isinstance(value, dict):
        return {k: to_numpy(v) for k, v in value.items()}
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(to_numpy(v) for v in value))
    if isinstance(value, (list, tuple)):
        return type(value)(to_numpy(v) for v in value)
    if hasattr(value, "__array__") and hasattr(value, "shape"):
        return np.asarray(value)
    if dataclasses.is_dataclass(value):
        return SimpleNamespace(**{f.name: to_numpy(getattr(value, f.name))
                                  for f in dataclasses.fields(value)})
    return SimpleNamespace(**{k: to_numpy(v) for k, v in vars(value).items()
                              if not k.startswith("_")})


def shared(tmp_path_factory, name, compute):
    """compute() (converted by ``to_numpy``) once per session: stored under
    ``name`` in the directory the session's workers share, and read from
    there by every later call."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the workers' basetemps share their parent
    path = root / f"torch_ref_{name}.pkl"
    with open(root / f"torch_ref_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            value = to_numpy(compute())
            tmp = path.with_name(path.name + f".{os.getpid()}")
            with open(tmp, "wb") as f:
                pickle.dump(value, f)
            os.replace(tmp, path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


class SharedRefs:
    """A mapping from a key to ``compute(key)``, each value computed when a
    test first reads it and shared across the workers as ``shared`` shares
    one: a module's references split by the tests that read them, so that
    a worker computes only those of its own tests."""

    def __init__(self, tmp_path_factory, name, compute):
        self._factory, self._name, self._compute = (tmp_path_factory, name,
                                                    compute)
        self._values = {}

    def __getitem__(self, key):
        if key not in self._values:
            tag = re.sub(r"[^A-Za-z0-9.-]+", "_", str(key))
            self._values[key] = shared(self._factory, f"{self._name}_{tag}",
                                       lambda: self._compute(key))
        return self._values[key]


def value_and_jacfwd(fn, x):
    """(fn(x), jax.jacfwd(fn)(x)) as numpy arrays, from one jitted
    computation: a JAX reference of many small operations runs several
    times faster compiled once than dispatched one operation at a time."""
    import jax
    import jax.numpy as jnp

    val, jac = jax.jit(lambda a: (fn(a), jax.jacfwd(fn)(a)))(jnp.asarray(x))
    return np.asarray(val), np.asarray(jac)


# XLA:CPU options for a reference that is compiled and run once, and whose
# compile dominates (the interpret-mode Pallas kernels): LLVM's
# optimizations off
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def run_compiled_once(fn, *args):
    """fn(*args) from one jitted computation compiled with FAST_COMPILE."""
    import jax

    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)
