// Huygens-Fresnel direct-summation kernels for Hopper (sm_90a): the coherent
// field of Q exit-pupil wavelets at P image points and its hand-derived
// adjoint, in three kernels. Plain C interface, loaded with ctypes by
// optiland_torch/ops/_cuda.py; the plain PyTorch version of every kernel is
// in optiland_torch/ops/huygens.py (huygens_*_plain, _pairs, _pair_grads),
// whose arithmetic this file transcribes.
//
// What each kernel replaces (optiland_tpu/ops/pallas_huygens.py):
//   huygens_fwd     <- _kernel / _pallas_field (K10)
//   huygens_bwd_img <- _bwd_img_kernel / _pallas_field_bwd (K11a)
//   huygens_bwd_pup <- _bwd_pup_kernel / _pallas_field_bwd (K11b)
//
// What bounds them on this card. A pair (image point, pupil point) costs
// ~33 operations forward (a square root, a divide and a sincospi among
// them) and ~70-90 in the adjoints, while the bytes are O(P + Q): every
// kernel is bound by operations. So, as on the TPU, each pairwise term is
// formed in registers and never stored: one thread per resident point
// (image points in K10/K11a, pupil points in K11b) keeps its coordinates
// and its sums in registers, and the other side streams through shared
// memory in stages of TILE points, which every thread of the block reads
// at the same address (a broadcast). The sums run in a fixed order, so the
// result does not change from run to run. To fill the card when the
// resident side is small (P = 1 in the PSF's normalization, 16,384 image
// points against 132 SMs), the streamed range is cut into nsplit pieces of
// `chunk` points (grid dimension y); each piece writes its own partial row
// and a second launch sums the rows in a fixed order: no float atomics.
//
// The phase. k R reaches ~6e5 rad on the PSF path (R ~ 52 mm at 0.55 um):
// __sinf/__cosf are wrong there, and sincosf/sincos fall to their slow
// range reduction (with local memory) above ~1e5 rad. The kernels form
// sincospi(R * (2 / lambda)), whose reduction is exact; in float32 the phase
// of one term still carries ~k R 2^-24 ~ 0.04 rad of rounding from R
// itself, as on the TPU.
//
// Every extern "C" entry launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HB = 256;    // threads per block (ops/huygens.py BLOCK)
constexpr int TILE = 256;  // streamed points per stage (ops/huygens.py TILE)

enum Mode { FWD = 0, BWD_IMG = 1, BWD_PUP = 2 };

template <typename P>
struct Ptrs8 {
  P p[8];
};

template <typename P>
Ptrs8<P> ptrs8(void* const* ptrs, int n) {
  Ptrs8<P> r;
  for (int a = 0; a < 8; ++a)
    r.p[a] = (ptrs == nullptr || a >= n) ? nullptr : (P)ptrs[a];
  return r;
}

__device__ __forceinline__ void sin_cos_pi(float x, float* s, float* c) {
  sincospif(x, s, c);
}
__device__ __forceinline__ void sin_cos_pi(double x, double* s, double* c) {
  sincospi(x, s, c);
}

// One pair's term from the displacement (image minus pupil), the pupil
// normal and amplitude: ops/huygens.py::_pairs. The term is
// (ac + i bc) inv_r obl.
template <typename T>
struct Pair {
  T inv_r, c, s, dot, obl, ac, bc;
};

template <typename T>
__device__ __forceinline__ Pair<T> pair_term(T dx, T dy, T dz, T nx, T ny,
                                             T nz, T pre, T pim, T tl) {
  Pair<T> t;
  const T r = sqrt(dx * dx + dy * dy + dz * dz);
  t.inv_r = T(1) / r;
  sin_cos_pi(r * tl, &t.s, &t.c);  // phase k r = pi r (2 / lambda)
  t.dot = dx * nx + dy * ny + dz * nz;
  t.obl = T(0.5) * (T(1) + t.dot * t.inv_r);
  t.ac = pre * t.c - pim * t.s;
  t.bc = pre * t.s + pim * t.c;
  return t;
}

// The adjoint of one pair's term for the field cotangent (gr, gi) of its
// image point: ops/huygens.py::_pair_grads. Returns the cotangent of the
// displacement (ex, ey, ez) and the scalar g_dot (the normal's cotangent is
// g_dot times the displacement); with AMP also those of pre and pim.
template <typename T, bool AMP>
__device__ __forceinline__ void pair_adjoint(const Pair<T>& t, T dx, T dy,
                                             T dz, T nx, T ny, T nz, T pre,
                                             T pim, T gr, T gi, T k, T& ex,
                                             T& ey, T& ez, T& g_dot, T& gpre,
                                             T& gpim) {
  const T ga = gr * t.obl, gb = gi * t.obl;
  const T gc = (ga * pre + gb * pim) * t.inv_r;
  const T gs = (gb * pre - ga * pim) * t.inv_r;
  const T g_obl = (gr * t.ac + gi * t.bc) * t.inv_r;
  g_dot = T(0.5) * g_obl * t.inv_r;
  const T g_inv_r = ga * t.ac + gb * t.bc + T(0.5) * g_obl * t.dot;
  const T g_d =
      (k * (gs * t.c - gc * t.s) - g_inv_r * t.inv_r * t.inv_r) * t.inv_r;
  ex = g_d * dx + g_dot * nx;
  ey = g_d * dy + g_dot * ny;
  ez = g_d * dz + g_dot * nz;
  if constexpr (AMP) {
    gpre = t.obl * (gr * t.c + gi * t.s) * t.inv_r;
    gpim = t.obl * (gi * t.c - gr * t.s) * t.inv_r;
  }
}

// K10 (FWD) and K11a (BWD_IMG): one thread per image point, the pupil's 8
// arrays streamed through shared memory over this block's piece
// [blockIdx.y * chunk, +chunk) of the pupil. Writes the piece's row
// out[blockIdx.y][j][i] of (re, im) or (d ix, d iy, d iz).
template <typename T, int MODE>
__global__ void __launch_bounds__(HB)
huygens_img_kernel(Ptrs8<const T*> img, Ptrs8<const T*> pup,
                   Ptrs8<const T*> cot, int64_t P, int64_t Q, T tl, T k,
                   int64_t chunk, T* __restrict__ out) {
  __shared__ T sp[8][TILE];
  const int64_t i = (int64_t)blockIdx.x * HB + threadIdx.x;
  const bool valid = i < P;
  T x = T(0), y = T(0), z = T(0), gr = T(0), gi = T(0);
  if (valid) {
    x = img.p[0][i];
    y = img.p[1][i];
    z = img.p[2][i];
    if constexpr (MODE == BWD_IMG) {
      gr = cot.p[0][i];
      gi = cot.p[1][i];
    }
  }
  const int64_t q0 = (int64_t)blockIdx.y * chunk;
  const int64_t q1 = q0 + chunk < Q ? q0 + chunk : Q;
  T acc[3] = {T(0), T(0), T(0)};
  for (int64_t base = q0; base < q1; base += TILE) {
    const int n = (int)(q1 - base < TILE ? q1 - base : TILE);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += HB) {
#pragma unroll
      for (int a = 0; a < 8; ++a) sp[a][j] = pup.p[a][base + j];
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < n; ++j) {
      const T dx = x - sp[0][j], dy = y - sp[1][j], dz = z - sp[2][j];
      const Pair<T> t = pair_term(dx, dy, dz, sp[3][j], sp[4][j], sp[5][j],
                                  sp[6][j], sp[7][j], tl);
      if constexpr (MODE == FWD) {
        acc[0] += t.ac * t.inv_r * t.obl;
        acc[1] += t.bc * t.inv_r * t.obl;
      } else {
        T ex, ey, ez, g_dot, unused0, unused1;
        pair_adjoint<T, false>(t, dx, dy, dz, sp[3][j], sp[4][j], sp[5][j],
                               sp[6][j], sp[7][j], gr, gi, k, ex, ey, ez,
                               g_dot, unused0, unused1);
        acc[0] += ex;
        acc[1] += ey;
        acc[2] += ez;
      }
    }
  }
  if (valid) {
    constexpr int NOUT = MODE == FWD ? 2 : 3;
    T* row = out + (int64_t)blockIdx.y * NOUT * P;
#pragma unroll
    for (int a = 0; a < NOUT; ++a) row[(int64_t)a * P + i] = acc[a];
  }
}

// K11b: one thread per pupil point, the image points and their cotangents
// (ix, iy, iz, g_re, g_im) streamed through shared memory over this block's
// piece of the image. Writes the piece's row out[blockIdx.y][j][q] of the 8
// pupil gradients (px, py, pz, nx, ny, nz, pre, pim).
template <typename T>
__global__ void __launch_bounds__(HB)
huygens_pup_kernel(Ptrs8<const T*> img, Ptrs8<const T*> pup,
                   Ptrs8<const T*> cot, int64_t P, int64_t Q, T tl, T k,
                   int64_t chunk, T* __restrict__ out) {
  __shared__ T si[5][TILE];
  const int64_t q = (int64_t)blockIdx.x * HB + threadIdx.x;
  const bool valid = q < Q;
  T v[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) v[a] = valid ? pup.p[a][q] : T(0);
  const int64_t p0 = (int64_t)blockIdx.y * chunk;
  const int64_t p1 = p0 + chunk < P ? p0 + chunk : P;
  T g[8] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  for (int64_t base = p0; base < p1; base += TILE) {
    const int n = (int)(p1 - base < TILE ? p1 - base : TILE);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += HB) {
#pragma unroll
      for (int a = 0; a < 3; ++a) si[a][j] = img.p[a][base + j];
      si[3][j] = cot.p[0][base + j];
      si[4][j] = cot.p[1][base + j];
    }
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < n; ++j) {
      const T dx = si[0][j] - v[0], dy = si[1][j] - v[1], dz = si[2][j] - v[2];
      const Pair<T> t =
          pair_term(dx, dy, dz, v[3], v[4], v[5], v[6], v[7], tl);
      T ex, ey, ez, g_dot, gpre, gpim;
      pair_adjoint<T, true>(t, dx, dy, dz, v[3], v[4], v[5], v[6], v[7],
                            si[3][j], si[4][j], k, ex, ey, ez, g_dot, gpre,
                            gpim);
      // the pupil position enters the displacement with a minus sign
      g[0] -= ex;
      g[1] -= ey;
      g[2] -= ez;
      g[3] += g_dot * dx;
      g[4] += g_dot * dy;
      g[5] += g_dot * dz;
      g[6] += gpre;
      g[7] += gpim;
    }
  }
  if (valid) {
    T* row = out + (int64_t)blockIdx.y * 8 * Q;
#pragma unroll
    for (int a = 0; a < 8; ++a) row[(int64_t)a * Q + q] = g[a];
  }
}

// out[i] = sum over s of partial[s][i], s in order: the fixed-order sum of
// the pieces' rows.
template <typename T>
__global__ void __launch_bounds__(HB)
split_sum_kernel(const T* __restrict__ partial, int nsplit, int64_t n,
                 T* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * HB + threadIdx.x;
  if (i >= n) return;
  T acc = partial[i];
  for (int s = 1; s < nsplit; ++s) acc += partial[(int64_t)s * n + i];
  out[i] = acc;
}

template <typename T, int MODE>
int huygens_launch(void* const* img, void* const* pup, void* const* cot,
                   int64_t P, int64_t Q, double tl, double k, int64_t chunk,
                   int nsplit, T* partial, T* out, cudaStream_t stream) {
  constexpr int NOUT = MODE == FWD ? 2 : MODE == BWD_IMG ? 3 : 8;
  const int64_t n_res = MODE == BWD_PUP ? Q : P;
  const int64_t n_str = MODE == BWD_PUP ? P : Q;
  if (P < 0 || Q < 0 || chunk < 1 || nsplit < 1 || nsplit > 65535 ||
      (int64_t)nsplit * chunk < n_str || (MODE != FWD && cot == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n_res == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n_res + HB - 1) / HB), (unsigned)nsplit);
  const Ptrs8<const T*> im = ptrs8<const T*>(img, 3);
  const Ptrs8<const T*> pu = ptrs8<const T*>(pup, 8);
  const Ptrs8<const T*> co = ptrs8<const T*>(cot, 2);
  if constexpr (MODE == BWD_PUP)
    huygens_pup_kernel<T><<<grid, HB, 0, stream>>>(im, pu, co, P, Q, (T)tl,
                                                   (T)k, chunk, partial);
  else
    huygens_img_kernel<T, MODE><<<grid, HB, 0, stream>>>(
        im, pu, co, P, Q, (T)tl, (T)k, chunk, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  const int64_t n = NOUT * n_res;
  split_sum_kernel<T><<<(unsigned)((n + HB - 1) / HB), HB, 0, stream>>>(
      partial, nsplit, n, out);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. img: host array of 3 device pointers (ix, iy, iz); pup: 8
// (px, py, pz, nx, ny, nz, pre, pim); cot: 2 (g_re, g_im), null for the
// forward. tl = 2 / lambda and k = 2 pi / lambda (1/mm). The streamed range
// is cut into nsplit pieces of chunk points; with nsplit == 1 the kernel
// writes `out` directly (partial == out), else it writes partial
// [nsplit][nout][n] and a second launch sums it into out [nout][n].
// ---------------------------------------------------------------------------

#define OTC_HUYGENS(NAME, MODE, SUF, T)                                      \
  extern "C" int otc_##NAME##_##SUF(                                         \
      void* const* img, void* const* pup, void* const* cot, int64_t P,       \
      int64_t Q, double tl, double k, int64_t chunk, int nsplit, T* partial, \
      T* out, void* stream) {                                                \
    return huygens_launch<T, MODE>(img, pup, cot, P, Q, tl, k, chunk,        \
                                   nsplit, partial, out,                     \
                                   (cudaStream_t)stream);                    \
  }

OTC_HUYGENS(huygens_fwd, FWD, f32, float)
OTC_HUYGENS(huygens_fwd, FWD, f64, double)
OTC_HUYGENS(huygens_bwd_img, BWD_IMG, f32, float)
OTC_HUYGENS(huygens_bwd_img, BWD_IMG, f64, double)
OTC_HUYGENS(huygens_bwd_pup, BWD_PUP, f32, float)
OTC_HUYGENS(huygens_bwd_pup, BWD_PUP, f64, double)
