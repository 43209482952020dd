// Polarized ray-trace kernels for Hopper (sm_90a): the fused trace of a ray
// bundle with its 3x3 complex polarization matrix p, and its hand-derived
// adjoint, each in two modes (the full 26 outputs, or the 8 ray arrays with
// the exit intensity formed in-kernel). Plain C interface, loaded with
// ctypes by optiland_torch/ops/_cuda.py; the plain PyTorch version of both
// kernels is in optiland_torch/ops/pol_trace.py (pol_fwd_plain and the hand
// adjoint pol_bwd_plain, which this file transcribes), and the device step
// (step.cuh, FULL form, with its extras) transcribes ops/step.py.
//
// What each kernel replaces (optiland_tpu/ops/pallas_pol.py):
//   pol_fwd <- _make_fwd_kernel_pol / _pallas_fwd_pol (K8)
//   pol_bwd <- _make_bwd_kernel_pol / _pallas_bwd_pol (K9), whose in-kernel
//              jax.vjp is here an adjoint written by hand
//
// What bounds them on this card. Per ray-surface step the forward adds to
// the ~130 operations of the surface step ~60 for the local basis, ~200
// for the p update (three 3x3 products of real pairs, two of them with a
// real matrix) and 20-100 for the coating's Jones matrix; a ray moves 64
// bytes in and 208 (full) or 64 (intensity) out in float32. The adjoint
// does about three times the work. Both are bound by operations. So, as
// the other trace kernels: one thread per ray with its state and p in
// registers, coalesced structure-of-arrays loads and stores, the param
// table, the tilts' cosines and sines, the coat table and the per-surface
// flags (geometry code, reflect, absorb, coat kind, thin-film layers,
// tilted) in shared memory, uniform across the block so the per-surface
// branches (coat kind included) do not diverge. The p update of a tilted
// surface takes the local-frame directions (the step's extras, as the JAX
// package's kernels do).
// The adjoint (pol_trace.cuh: pol_bwd_kernel) keeps per ray and surface,
// in a local array bounded by the build's capacity (16 surfaces, 64 in the
// deep build), the input state, adot, what its step's reverse would
// compute again (the stock and tilt builds: step_fwd_pt_ext's roots; the
// Newton builds: step_fwd's KEEP record; nurbs: the stopped (u, v)), the
// intensity before the coating and the polarization before the surface:
// p's 18 reals, or in the intensity mode each launch state's field p E0
// (6 reals), the only part of p the exit intensity reads (but the nurbs
// build, which keeps p and Fresnel's divides: its f32 check sits near a
// nearly degenerate basis). Its reverse forms each surface's basis and
// Jones matrix once (a Fresnel surface's coefficients with one reciprocal
// per denominator), updates p (or the fields) column by column, and hands
// the kept step's reverse the cotangents of its extras
// (step_adjoint_pt_ext, step_adjoint_kept_ext). Each warp sums a surface's
// gradient slots and coat columns by a butterfly of shuffles into its
// shared row; the launch takes one wave of blocks (ops/launch.py:
// bwd_grid), each writes one partial row, and a second launch
// (grad_reduce_kernel, its coat columns after the parameter slots) sums
// the rows in a fixed order: no float atomics.
//
// Every extern "C" entry launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include "pol_trace.cuh"

// ---------------------------------------------------------------------------
// C interface. Bundles of per-ray arrays come as host arrays of device
// pointers: 8 launch arrays (x, y, z, L, M, N, i, opd); 26 outputs or
// cotangents (the 8, then p's 9 real and 9 imaginary parts), 8 in the
// intensity mode. The states are 8 doubles (two states' ex_re, ex_im,
// ey_re, ey_im) and their count (1 or 2; 0 in the full mode).
// ---------------------------------------------------------------------------

OTC_POL(f32, float, , false)
OTC_POL(f64, double, , false)
