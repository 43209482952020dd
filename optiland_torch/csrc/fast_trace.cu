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
//
// What bounds them on this card. Each ray-surface step is ~120 operations
// forward and ~300 in the adjoint; a ray moves 40 bytes (field forward: Px,
// Py in, 8 arrays out) to 96 bytes (generic backward: 8 arrays and 8
// cotangents in, 8 input cotangents out) in float32. For the 7 surfaces of
// the Cooke triplet the forward kernels sit near the line between the two
// bounds and the adjoints are bound by operations. So, as for the merit:
// one thread per ray with its whole state in registers, coalesced
// structure-of-arrays loads and stores, the param table and the per-surface
// flags (geometry code, reflect, absorb) in shared memory, uniform across
// the block so the per-surface branches do not diverge. The adjoints keep
// each ray's per-surface input state in a local array bounded by MAX_SURF,
// sum each surface's gradient columns with warp shuffles into per-warp
// shared rows over a grid-stride loop, write one partial row per block, and
// a second launch sums the rows in a fixed order: no float atomics.
//
// Every extern "C" entry launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include "step.cuh"

namespace {

// The 8 per-ray arrays of a bundle (x, y, z, L, M, N, i, opd), by value.
template <typename P>
struct Rays8 {
  P p[8];
};

// Launch state of ray i: from the pupil samples and the aim vector (FIELD,
// intensity 1 and OPD 0, as ops/launch.py::launch_from_pupil), or read from
// the bundle.
template <typename T, bool FIELD>
__device__ __forceinline__ void launch_state(int64_t i, const T* sa,
                                             const T* px, const T* py,
                                             const Rays8<const T*>& in, T* v,
                                             T& Px, T& Py) {
  if constexpr (FIELD) {
    Px = px[i];
    Py = py[i];
    v[0] = Px * sa[A_SX] + sa[A_X0];
    v[1] = Py * sa[A_SY] + sa[A_Y0];
    v[2] = sa[A_Z0];
    v[3] = sa[A_L];
    v[4] = sa[A_M];
    v[5] = sa[A_N];
    v[6] = T(1);
    v[7] = T(0);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = in.p[k][i];
  }
}

// Forward: trace each ray through surfaces 1 .. S-1 and write its 8 arrays.
template <typename T, bool FIELD>
__global__ void __launch_bounds__(FWD_BLOCK)
trace_fwd_kernel(const T* __restrict__ params, const T* __restrict__ aim,
                 const int* __restrict__ flags, int S, const T* px,
                 const T* py, Rays8<const T*> in, int64_t R,
                 Rays8<T*> out) {
  __shared__ T sp[MAX_SURF * NUM_P];
  __shared__ T sa[N_AIM];
  __shared__ int sf[3 * MAX_SURF];
  load_tables<T, 3, FIELD>(params, aim, flags, S, sp, sa, sf);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  T v[8], Px, Py;
  launch_state<T, FIELD>(i, sa, px, py, in, v, Px, Py);
  T n = sp[P_NPOST];
  for (int s = 1; s < S; ++s)
    n = step_fwd<T, true>(sf[s], sf[S + s], sf[2 * S + s], sp + s * NUM_P, n,
                          v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]);
#pragma unroll
  for (int k = 0; k < 8; ++k) out.p[k][i] = v[k];
}

// Backward: retrace each ray keeping its per-surface input state, then run
// the reverse sweep seeded with its 8 output cotangents. One partial row per
// block over a grid-stride loop of ray chunks, compact layout [s * N_GF + j]
// for surface s and slot j, then (FIELD) N_AIM aim entries; the generic mode
// also writes the 8 per-ray input cotangents.
template <typename T, bool FIELD>
__global__ void __launch_bounds__(BWD_BLOCK)
trace_bwd_kernel(const T* __restrict__ params, const T* __restrict__ aim,
                 const int* __restrict__ flags, int S, const T* px,
                 const T* py, Rays8<const T*> in, Rays8<const T*> cot,
                 int64_t R, Rays8<T*> din, T* __restrict__ partial) {
  constexpr int NW_MAX = BWD_BLOCK / 32;
  constexpr int NCOMP_MAX = MAX_SURF * N_GF + N_AIM;
  __shared__ T sp[MAX_SURF * NUM_P];
  __shared__ T sa[N_AIM];
  __shared__ int sf[3 * MAX_SURF];
  __shared__ T acc[NW_MAX][NCOMP_MAX];
  __shared__ T npre[MAX_SURF];  // n_pre of surface s (uniform across rays)
  load_tables<T, 3, FIELD>(params, aim, flags, S, sp, sa, sf);
  const int ncomp = S * N_GF + (FIELD ? N_AIM : 0);
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < NW_MAX * NCOMP_MAX; j += blockDim.x)
    (&acc[0][0])[j] = T(0);
  if (threadIdx.x == 0) fill_npre(sp, sf, S, npre);
  __syncthreads();

  T st[MAX_SURF][7];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < R;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool valid = i < R;
    T Px = T(0), Py = T(0);
    // cotangents of (x, y, z, L, M, N, n, i, opd)
    T g[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
    if (valid) {
      T v[8];
      launch_state<T, FIELD>(i, sa, px, py, in, v, Px, Py);
      for (int s = 1; s < S; ++s) {
#pragma unroll
        for (int k = 0; k < 7; ++k) st[s][k] = v[k];
        step_fwd<T, true>(sf[s], sf[S + s], sf[2 * S + s], sp + s * NUM_P,
                          npre[s], v[0], v[1], v[2], v[3], v[4], v[5], v[6],
                          v[7]);
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) g[k] = cot.p[k][i];
      g[7] = cot.p[6][i];
      g[8] = cot.p[7][i];
    }
    for (int s = S - 1; s >= 1; --s) {
      T gc[N_GF] = {};
      if (valid)
        step_adjoint<T, true>(sf[s], sf[S + s], sf[2 * S + s], sp + s * NUM_P,
                              npre[s], st[s][0], st[s][1], st[s][2], st[s][3],
                              st[s][4], st[s][5], st[s][6], g, gc);
#pragma unroll
      for (int j = 0; j < N_GF; ++j) {
        const T v = warp_sum(gc[j]);
        if (lane == 0) acc[warp][s * N_GF + j] += v;
      }
    }
    // n_pre of surface 1 is the object row's n_post
    {
      const T v = warp_sum(g[6]);
      if (lane == 0) acc[warp][0 * N_GF + 3] += v;
    }
    if constexpr (FIELD) {
      const T ga[N_AIM] = {g[0], g[1], g[2], g[3], g[4], g[5], g[0] * Px,
                           g[1] * Py};
#pragma unroll
      for (int j = 0; j < N_AIM; ++j) {
        const T v = warp_sum(ga[j]);
        if (lane == 0) acc[warp][S * N_GF + j] += v;
      }
    } else if (valid) {
#pragma unroll
      for (int k = 0; k < 6; ++k) din.p[k][i] = g[k];
      din.p[6][i] = g[7];
      din.p[7][i] = g[8];
    }
  }
  __syncthreads();
  store_partial_row<T, NCOMP_MAX>(acc, nw, ncomp, partial);
}

template <typename P>
Rays8<P> rays8(void* const* ptrs) {
  Rays8<P> r;
  for (int k = 0; k < 8; ++k) r.p[k] = ptrs == nullptr ? nullptr : (P)ptrs[k];
  return r;
}

template <typename T, bool FIELD>
int fwd_launch(const T* params, const T* aim, const int* flags, int S,
               const T* px, const T* py, void* const* in, int64_t R,
               void* const* out, cudaStream_t stream) {
  if (S > MAX_SURF || S < 2) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (R + FWD_BLOCK - 1) / FWD_BLOCK;
  if (blocks > 0)
    trace_fwd_kernel<T, FIELD><<<(unsigned)blocks, FWD_BLOCK, 0, stream>>>(
        params, aim, flags, S, px, py, rays8<const T*>(in), R,
        rays8<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T, bool FIELD>
int bwd_launch(const T* params, const T* aim, const int* flags, int S, int nc,
               const T* px, const T* py, void* const* in, void* const* cot,
               int64_t R, void* const* din, T* partial, int nblocks, T* out,
               cudaStream_t stream) {
  if (S > MAX_SURF || S < 2 || nblocks < 1) return (int)cudaErrorInvalidValue;
  trace_bwd_kernel<T, FIELD><<<nblocks, BWD_BLOCK, 0, stream>>>(
      params, aim, flags, S, px, py, rays8<const T*>(in),
      rays8<const T*>(cot), R, rays8<T*>(din), partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int n_aim = FIELD ? N_AIM : 0;
  grad_reduce_kernel<T, N_GF><<<S * N_GF + n_aim, RED_BLOCK, 0, stream>>>(
      partial, nblocks, S, nc, n_aim, out);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. Bundles of 8 per-ray arrays come as host arrays of 8 device
// pointers (x, y, z, L, M, N, i, opd).
// ---------------------------------------------------------------------------

#define OTC_TRACE(SUF, T)                                                    \
  extern "C" int otc_trace_fwd_##SUF(const T* params, const int* flags,      \
                                     int S, void* const* in, int64_t R,      \
                                     void* const* out, void* stream) {       \
    return fwd_launch<T, false>(params, nullptr, flags, S, nullptr, nullptr, \
                                in, R, out, (cudaStream_t)stream);           \
  }                                                                          \
  extern "C" int otc_trace_field_fwd_##SUF(                                  \
      const T* params, const T* aim, const int* flags, int S, const T* px,   \
      const T* py, int64_t R, void* const* out, void* stream) {              \
    return fwd_launch<T, true>(params, aim, flags, S, px, py, nullptr, R,    \
                               out, (cudaStream_t)stream);                   \
  }                                                                          \
  extern "C" int otc_trace_bwd_##SUF(                                        \
      const T* params, const int* flags, int S, int nc, void* const* in,     \
      void* const* cot, int64_t R, void* const* din, T* partial,             \
      int nblocks, T* out, void* stream) {                                   \
    return bwd_launch<T, false>(params, nullptr, flags, S, nc, nullptr,      \
                                nullptr, in, cot, R, din, partial, nblocks,  \
                                out, (cudaStream_t)stream);                  \
  }                                                                          \
  extern "C" int otc_trace_field_bwd_##SUF(                                  \
      const T* params, const T* aim, const int* flags, int S, int nc,        \
      const T* px, const T* py, void* const* cot, int64_t R, T* partial,     \
      int nblocks, T* out, void* stream) {                                   \
    return bwd_launch<T, true>(params, aim, flags, S, nc, px, py, nullptr,   \
                               cot, R, nullptr, partial, nblocks, out,       \
                               (cudaStream_t)stream);                        \
  }

OTC_TRACE(f32, float)
OTC_TRACE(f64, double)
