// Generic and field ray-trace kernels for Hopper (sm_90a): the fused trace of
// a ray bundle and its hand-derived adjoint, in two launch modes. Plain C
// interface, loaded with ctypes by optiland_torch/ops/_cuda.py; the plain
// PyTorch version of every kernel is in optiland_torch/ops/fast_trace.py,
// and the device step (step.cuh, FULL form) transcribes ops/step.py.
//
// What each kernel replaces (optiland_tpu/ops/pallas_trace.py):
//   trace_field_fwd <- _make_fwd_kernel_field / _pallas_fwd_field (K1)
//   trace_field_bwd <- _make_bwd_kernel_field / _pallas_bwd_field (K4)
//   trace_fwd       <- _make_fwd_kernel / _pallas_fwd, mono mode (K5a)
//   trace_bwd       <- _make_bwd_kernel / _pallas_bwd, mono mode (K5b)
//   trace_fwd_poly  <- _make_fwd_kernel / _pallas_fwd, poly mode (K5a)
//   trace_bwd_poly  <- _make_bwd_kernel / _pallas_bwd, poly mode (K5b)
// The poly mode (template flag POLY) reads a 9th per-ray array, the
// wavelength, and the (S, nm) dispersion coefficients, evaluates each
// surface's index per ray from its formula (step.cuh: n_formula), and its
// adjoint also sums the coefficients' gradient (dn_dcoef). The mono mode
// also has the grating build (K6c; step.cuh: B_GRAT), which reads a fifth
// flag row, the grating flags, and sums each grating surface's P_G1 and
// P_G2 columns; the poly mode takes no grating, as the JAX package's.
//
// What bounds them on this card. Each ray-surface step is ~120 operations
// forward and ~300 in the adjoint; a ray moves 40 bytes (field forward: Px,
// Py in, 8 arrays out) to 96 bytes (generic backward: 8 arrays and 8
// cotangents in, 8 input cotangents out) in float32. For the 7 surfaces of
// the Cooke triplet the forward kernels sit near the line between the two
// bounds and the adjoints are bound by operations. So, as for the merit:
// one thread per ray with its whole state in registers, coalesced
// structure-of-arrays loads and stores, the param table, the tilts' cosines
// and sines, the coefficient rows (poly) and the per-surface flags
// (geometry code, reflect, absorb, tilted, formula) in shared memory,
// uniform across the block so the per-surface branches do not diverge. A
// formula is ~10 (Sellmeier) to ~60 (a pow per term) operations per ray
// and surface, and its coefficient gradients as many per coefficient; an
// asphere is newton_iters + 1 sag evaluations forward (~25 + 4 nc
// operations each) and two more with second derivatives in the adjoint; a
// Cartesian freeform the same count of evaluations of ~35 + 13 nc (XY) to
// 22 nc (Chebyshev) operations, and its nc + 2 gradient columns. The
// adjoints keep each ray's per-surface input state in a local array bounded
// by the build's capacity (16 surfaces, 64 in the deep build),
// sum each surface's gradient columns with warp shuffles into per-warp
// shared rows over a grid-stride loop, write one partial row per block, and
// a second launch sums the rows in a fixed order: no float atomics.
//
// Every extern "C" entry launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include "fast_trace.cuh"

// ---------------------------------------------------------------------------
// C interface. Bundles of 8 per-ray arrays come as host arrays of 8 device
// pointers (x, y, z, L, M, N, i, opd); the polychromatic launch bundles have
// a 9th, the wavelengths (um), and their (S, nm) coefficient rows.
// ---------------------------------------------------------------------------

OTC_TRACE(f32, float, , false)
OTC_TRACE(f64, double, , false)
