// Fused RMS-spot merit kernels for Hopper (sm_90a): forward, hand-derived
// backward, and the pupil PRNG. Plain C interface, loaded with ctypes by
// optiland_torch/ops/_cuda.py; the plain PyTorch version of every kernel is
// in optiland_torch/ops/fused_trace.py, and the device code here is a
// line-by-line transcription of it.
//
// What each kernel replaces (optiland_tpu/ops/pallas_trace.py):
//   merit_fwd  <- _make_merit_fwd_kernel / _pallas_merit_fwd (K2)
//   merit_bwd  <- _make_merit_bwd_kernel / _pallas_merit_bwd (K3)
//   prng_disk  <- prng_pupil_samples (K7)
//
// What bounds them on this card: arithmetic. In PRNG mode a ray costs no
// device-memory traffic at all (the samples are drawn in-kernel and only a
// 5-value row per block, or a partial-gradient row per block, leaves), and
// each ray-surface step is ~100 flops forward plus ~250 in the adjoint,
// with two rsqrt, one sqrt and several divides. So the kernels are built
// around keeping everything in registers: one thread per ray, the (S, 15)
// parameter table, the tilts' cosines and sines, the aim vector and the
// geometry/reflect/tilt flags in shared memory (uniform across the block, so
// the per-surface branches do not diverge), block reductions with warp
// shuffles, and no float atomics. A tilted surface adds its two rotations
// to the step (~50 operations forward, ~150 in the adjoint); an asphere
// its newton_iters + 1 sag evaluations forward (~25 + 4 nc operations
// each) and two more with their derivatives in the adjoint, and its nc
// coefficient columns to the gradient rows; a Cartesian freeform as many
// evaluations of its table (~35 + 13 to 22 operations per coefficient) and
// its nc + 2 columns (the coefficients, P_G1, P_G2); a grating (K6c, the
// grating build, which reads a fourth flag row, F_GRAT) its groove vector
// (~60 operations on a conic substrate: a square root, a tan and two cross
// products) and its diffraction in place of the refraction, and its P_G1
// and P_G2 columns.
// The backward keeps each ray's per-surface input state in a local array
// bounded by the build's surface capacity (Build<B>::CAP) for its reverse
// sweep instead of re-tracing.
//
// Every extern "C" entry launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include "fused_trace.cuh"

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------

#define OTC_PRNG(SUF, T)                                                     \
  extern "C" int otc_prng_disk_##SUF(uint64_t seed, int64_t offset,          \
                                     int64_t R, T* px, T* py, T* u1, T* u2,  \
                                     void* stream) {                         \
    return prng_disk_launch<T>(seed, offset, R, px, py, u1, u2,              \
                               (cudaStream_t)stream);                        \
  }
OTC_PRNG(f32, float)
OTC_PRNG(f64, double)
OTC_FWD(f32, float, , false)
OTC_FWD(f64, double, , false)
OTC_BWD(f32, float, , false)
OTC_BWD(f64, double, , false)

extern "C" const char* otc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
