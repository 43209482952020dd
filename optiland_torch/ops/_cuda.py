"""Build and load the port's CUDA kernels.

``optiland_torch/csrc/*.cu`` are compiled at first use with ``nvcc`` for
sm_90a, one ``nvcc`` per source, all started together, and linked into one
shared library with a plain C interface, which is loaded with ctypes. The
library goes to ``optiland_torch/_build/`` (listed in .gitignore), named by
a hash of every source the build reads (``*.cu`` and the ``*.cuh`` headers
they include) and of the flags, so a changed source or header is rebuilt
and an unchanged one is not. Nothing here runs at import time, and nothing
needs nvcc or a card until a kernel is launched.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
BUILD_SECONDS = None  # wall seconds of the nvcc run (0.0 when cached)
BUILD_LOG = ""  # nvcc's output (ptxas register and spill counts) and the
# wall seconds of each source's nvcc

_VP, _I, _I64, _U64, _D = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                           ctypes.c_ulonglong, ctypes.c_double)
_PP = ctypes.POINTER(ctypes.c_void_p)  # host array of device pointers
_ARGTYPES = {
    # seed, offset, R, px, py, u1, u2, stream
    "prng_disk": [_U64, _I64, _I64, _VP, _VP, _VP, _VP, _VP],
    # params, aim, flags, S, build, coeffs, nc, niters, px, py, R, seed,
    # offset, prng, rows, stream
    "merit_fwd": [_VP, _VP, _VP, _I, _I, _VP, _I, _I, _VP, _VP, _I64, _U64,
                  _I64, _I, _VP, _VP],
    # params, aim, stats, flags, S, build, coeffs, nc, niters, nsag, px, py,
    # R, seed, offset, prng, partial, nblocks, block, out, stream
    "merit_bwd": [_VP, _VP, _VP, _VP, _I, _I, _VP, _I, _I, _I, _VP, _VP,
                  _I64, _U64, _I64, _I, _VP, _I, _I, _VP, _VP],
    # params, flags, S, build, coeffs, nc, niters, in[8], R, out[8], stream
    "trace_fwd": [_VP, _VP, _I, _I, _VP, _I, _I, _PP, _I64, _PP, _VP],
    # params, aim, flags, S, build, coeffs, nc, niters, px, py, R, out[8],
    # stream
    "trace_field_fwd": [_VP, _VP, _VP, _I, _I, _VP, _I, _I, _VP, _VP, _I64,
                        _PP, _VP],
    # params, flags, S, build, coeffs, nc, niters, nsag, in[8], cot[8], R,
    # din[8], partial, nblocks, out, stream
    "trace_bwd": [_VP, _VP, _I, _I, _VP, _I, _I, _I, _PP, _PP, _I64, _PP,
                  _VP, _I, _VP, _VP],
    # params, aim, flags, S, build, coeffs, nc, niters, nsag, px, py,
    # cot[8], R, partial, nblocks, out, stream
    "trace_field_bwd": [_VP, _VP, _VP, _I, _I, _VP, _I, _I, _I, _VP, _VP,
                        _PP, _I64, _VP, _I, _VP, _VP],
    # params, mats, flags, S, build, coeffs, nc, niters, nm, in[9], R,
    # out[8], stream
    "trace_fwd_poly": [_VP, _VP, _VP, _I, _I, _VP, _I, _I, _I, _PP, _I64,
                       _PP, _VP],
    # params, mats, flags, S, build, coeffs, nc, niters, nsag, nm, in[9],
    # cot[8], R, din[8], partial, nblocks, out, stream
    "trace_bwd_poly": [_VP, _VP, _VP, _I, _I, _VP, _I, _I, _I, _I, _PP, _PP,
                       _I64, _PP, _VP, _I, _VP, _VP],
    # img[3], pup[8], cot[2] (null for the forward), P, Q, 2/lambda, k,
    # chunk, nsplit, partial, out, stream
    **{name: [_PP, _PP, _PP, _I64, _I64, _D, _D, _I64, _I, _VP, _VP, _VP]
       for name in ("huygens_fwd", "huygens_bwd_img", "huygens_bwd_pup")},
    # params, coat, flags, S, build, coeffs, nc, niters, ncoat, in[8], R,
    # out[26 or 8], intensity, 8 state coefficients, nstates, stream
    "pol_fwd": [_VP, _VP, _VP, _I, _I, _VP, _I, _I, _I, _PP, _I64, _PP, _I]
    + [_D] * 8 + [_I, _VP],
    # params, coat, flags, S, build, coeffs, nc, niters, nsag, ncoat, in[8],
    # cot[26 or 8], R, din[8], partial, nblocks, out, intensity, 8 state
    # coefficients, nstates, stream
    "pol_bwd": [_VP, _VP, _VP, _I, _I, _VP, _I, _I, _I, _I, _PP, _PP, _I64,
                _PP, _VP, _I, _VP, _I] + [_D] * 8 + [_I, _VP],
}
# the nurbs build's entries (csrc/nurbs_*.cu: launch.entry_name) take the
# arguments of the other builds'
_ARGTYPES.update({f"{name}_nurbs": _ARGTYPES[name] for name in (
    "merit_fwd", "merit_bwd", "trace_fwd", "trace_field_fwd", "trace_bwd",
    "trace_field_bwd", "trace_fwd_poly", "trace_bwd_poly", "pol_fwd",
    "pol_bwd")})
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or (
        "/usr/local/cuda"
    )
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc was not found (PATH, CUDA_HOME, /usr/local/cuda); it is "
            "needed to build optiland_torch's CUDA kernels"
        )
    return path


def _build() -> str:
    global BUILD_SECONDS, BUILD_LOG
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"liboptiland_torch_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        BUILD_SECONDS = 0.0
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    outs = [f"{obj}.log" for obj in objs]
    t0 = time.perf_counter()
    procs = []
    for src, obj, out in zip(sources, objs, outs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
        with open(out, "w") as f:
            procs.append((cmd, subprocess.Popen(cmd, stdout=f,
                                                stderr=subprocess.STDOUT)))
    # each source's wall seconds, from the common start
    secs = [None] * len(procs)
    while any(v is None for v in secs):
        for k, (_, proc) in enumerate(procs):
            if secs[k] is None and proc.poll() is not None:
                secs[k] = time.perf_counter() - t0
        time.sleep(0.05)
    logs, failed = [], []
    for (cmd, proc), out, src, sec in zip(procs, outs, sources, secs):
        with open(out) as f:
            logs.append(f.read())
        os.remove(out)
        logs.append(f"nvcc {os.path.basename(src)}: {sec:.1f} s\n")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    BUILD_LOG = "".join(logs)
    if not failed:
        cmd = [nvcc, "-shared", "-o", f"{tmp}.so", *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_LOG += proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
    BUILD_SECONDS = time.perf_counter() - t0
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("\n".join(failed) + "\n" + BUILD_LOG)
    os.replace(f"{tmp}.so", out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(_build())
        for name, argtypes in _ARGTYPES.items():
            for suf in _SUFFIX.values():
                fn = getattr(lib, f"otc_{name}_{suf}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        lib.otc_error_string.argtypes = [ctypes.c_int]
        lib.otc_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def call(name: str, dtype: torch.dtype, *args) -> int:
    """Launch entry ``otc_<name>_<f32|f64>``; returns its CUDA error code."""
    return getattr(library(), f"otc_{name}_{_SUFFIX[dtype]}")(*args)


def pointers(tensors) -> ctypes.Array:
    """Host array of the tensors' device pointers, for a ``void* const*``
    argument."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def stream() -> int:
    """PyTorch's current CUDA stream, as the pointer the C entries take."""
    return torch.cuda.current_stream().cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().otc_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")
