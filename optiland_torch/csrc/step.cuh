// Device code shared by the port's trace kernels (sm_90a): the PLANE and
// STANDARD branches of _step_tile (optiland_tpu/ops/pallas_trace.py),
// forward and hand-derived adjoint, and what the kernels around the step
// share: the shared-memory table loader, the per-warp gradient rows of the
// backwards, and their fixed-order reduction kernel. The step is a
// line-by-line transcription of optiland_torch/ops/step.py (step_plain,
// step_adjoint_plain); change them together.
//
// The FULL flag instantiates the step in two forms:
//   FULL = false  geometry only (x, y, z, L, M, N): the fused merit's step
//                 (fused_trace.cu). The FULL code is compiled out, so the
//                 merit kernels compile to the code they had before it.
//   FULL = true   also the intensity (Beer-Lambert absorption where the
//                 surface's flag is set, the circular clip on P_APMAX) and
//                 the optical path, as the generic and field traces return
//                 them (fast_trace.cu, pol_trace.cu).
//
// The polarized traces (pol_trace.cu) also read the step's "extras": the
// pre- and post-interaction directions, which for the untilted systems the
// kernels take are the step's input and output directions, and adot, which
// step_fwd writes to ``adot_out``; step_adjoint takes their cotangents in
// ``gext``. Both pointers are null in the other kernels, whose code then
// compiles as before.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_P = 15;
constexpr int P_RADIUS = 0, P_CONIC = 1, P_POS = 2, P_NPOST = 3;
constexpr int P_APMAX = 4, P_KPRE = 5;
constexpr int P_DX = 6, P_DY = 7, P_RX = 8, P_RY = 9, P_RZ = 10;
constexpr int N_AIM = 8;
constexpr int A_X0 = 0, A_Y0 = 1, A_Z0 = 2, A_L = 3, A_M = 4, A_N = 5;
constexpr int A_SX = 6, A_SY = 7;
constexpr int PLANE = 0, STANDARD = 1;
// Beer-Lambert factor exp(ABS * k_pre * t * 1e3), k_pre = k / wavelength
constexpr double ABS = -12.566370614359172;  // -4 pi

// launch shapes (optiland_torch/ops/launch.py holds the same values)
constexpr int MAX_SURF = 16;
constexpr int FWD_BLOCK = 256;
constexpr int BWD_BLOCK = 128;
constexpr int RED_BLOCK = 256;

// Per-surface gradient slots of the backwards and the param-table column of
// each: radius, conic, pos, n_post, dx, dy, and the tilts rx, ry, rz (their
// derivative at zero tilt: the kernels trace untilted systems) in both
// forms, then k_pre in the FULL form (ops/step.py: GRAD_COLS,
// FULL_GRAD_COLS).
constexpr int N_G = 9;
constexpr int N_GF = 10;
__constant__ int kGradCol[N_GF] = {P_RADIUS, P_CONIC, P_POS, P_NPOST, P_DX,
                                   P_DY,     P_RX,    P_RY,  P_RZ,    P_KPRE};

__device__ __forceinline__ float sqrt_(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_(double v) { return sqrt(v); }
__device__ __forceinline__ float rsqrt_(float v) { return rsqrtf(v); }
__device__ __forceinline__ double rsqrt_(double v) { return rsqrt(v); }
__device__ __forceinline__ float abs_(float v) { return fabsf(v); }
__device__ __forceinline__ double abs_(double v) { return fabs(v); }
__device__ __forceinline__ float cos_(float v) { return cosf(v); }
__device__ __forceinline__ double cos_(double v) { return cos(v); }
__device__ __forceinline__ float sin_(float v) { return sinf(v); }
__device__ __forceinline__ double sin_(double v) { return sin(v); }
__device__ __forceinline__ float exp_(float v) { return expf(v); }
__device__ __forceinline__ double exp_(double v) { return exp(v); }
template <typename T> __device__ __forceinline__ T nan_();
template <> __device__ __forceinline__ float nan_<float>() { return __int_as_float(0x7fc00000); }
template <> __device__ __forceinline__ double nan_<double>() { return __longlong_as_double(0x7ff8000000000000ULL); }
template <typename T> __device__ __forceinline__ T inf_();
template <> __device__ __forceinline__ float inf_<float>() { return __int_as_float(0x7f800000); }
template <> __device__ __forceinline__ double inf_<double>() { return __longlong_as_double(0x7ff0000000000000ULL); }
template <typename T> __device__ __forceinline__ T sign_(T v) {
  return T((v > T(0)) - (v < T(0)));
}

// ---------------------------------------------------------------------------
// Surface step (PLANE and STANDARD branches of _step_tile)
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T dist_standard(T R, T k, T x, T y, T z, T L, T M,
                                           T N) {
  const T cu = T(1) / R;
  const T a = cu * (k * (N * N) + L * L + M * M + N * N);
  const T b = T(2) * (cu * (k * N * z + L * x + M * y + N * z) - N);
  const T c = cu * (k * (z * z) + x * x + y * y + z * z) - T(2) * z;
  const T d = b * b - T(4) * a * c;
  const T sd = d < T(0) ? nan_<T>() : sqrt_(d);
  const T s = b >= T(0) ? T(1) : T(-1);
  const T q = T(-0.5) * (b + s * sd);
  const T t1 = a == T(0) ? inf_<T>() : q / a;
  const T t2 = q == T(0) ? T(0) : c / q;
  return abs_(z + t1 * N) <= abs_(z + t2 * N) ? t1 : t2;
}

template <typename T>
__device__ __forceinline__ T dist_plane(T z, T N) {
  const T Ns = abs_(N) > T(1e-14) ? N : T(1e-14);
  return -z / Ns;
}

// One forward surface step; returns n of the medium after the surface.
// ``inten`` and ``opd`` are read and written only in the FULL form;
// ``adot_out``, when not null, receives |cos| of the angle of incidence.
template <typename T, bool FULL>
__device__ __forceinline__ T step_fwd(int code, int refl, int absorbs,
                                      const T* p, T n_pre, T& x, T& y, T& z,
                                      T& L, T& M, T& N, T& inten, T& opd,
                                      T* adot_out = nullptr) {
  const T R = p[P_RADIUS], k = p[P_CONIC], pos = p[P_POS];
  const T xl = x - p[P_DX], yl = y - p[P_DY], zl = z - pos;
  const T t = code == STANDARD ? dist_standard(R, k, xl, yl, zl, L, M, N)
                               : dist_plane(zl, N);
  const T x1 = xl + t * L, y1 = yl + t * M, z1 = zl + t * N;
  if constexpr (FULL) {
    if (absorbs) inten = inten * exp_(T(ABS) * p[P_KPRE] * t * T(1e3));
    opd = opd + abs_(t * n_pre);
    const T ap = p[P_APMAX];
    if (x1 * x1 + y1 * y1 > ap * ap) inten = T(0);
  }
  T nx = T(0), ny = T(0), nz = T(-1);
  if (code == STANDARD) {
    const T cu = T(1) / R;
    const T r2 = x1 * x1 + y1 * y1;
    const T invd = cu * rsqrt_(T(1) - (T(1) + k) * (cu * cu) * r2);
    const T fx = x1 * invd, fy = y1 * invd;
    const T im = rsqrt_(fx * fx + fy * fy + T(1));
    nx = fx * im;
    ny = fy * im;
    nz = -im;
  }
  const T dot = L * nx + M * ny + N * nz;
  const T sg = sign_(dot);
  nx *= sg;
  ny *= sg;
  nz *= sg;
  const T adot = abs_(dot);
  if (adot_out) *adot_out = adot;
  T n_next;
  if (refl) {
    L = L - T(2) * adot * nx;
    M = M - T(2) * adot * ny;
    N = N - T(2) * adot * nz;
    n_next = n_pre;
  } else {
    const T npost = p[P_NPOST];
    const T u = n_pre / npost;
    const T w = sqrt_(T(1) - u * u * (T(1) - adot * adot)) - u * adot;
    L = u * L + nx * w;
    M = u * M + ny * w;
    N = u * N + nz * w;
    n_next = npost;
  }
  x = x1 + p[P_DX];
  y = y1 + p[P_DY];
  z = z1 + pos;
  return n_next;
}

// Reverse sweep through one surface step (transcribes
// step.step_adjoint_plain). In: the step's input state (and, FULL, its input
// intensity i_in), the cotangents g of its outputs (x, y, z, L, M, N,
// n_next, and FULL: i, opd) and, when ``gext`` is not null, those of its
// extras (L0, M0, N0, L1, M1, N1, adot). Out: g becomes the cotangents of
// the inputs (x, y, z, L, M, N, n_pre, and FULL: i, opd), gc the cotangents
// of (radius, conic, pos, n_post, dx, dy, rx, ry, rz, and FULL: k_pre).
template <typename T, bool FULL>
__device__ __forceinline__ void step_adjoint(int code, int refl, int absorbs,
                                             const T* p, T n_pre, T x, T y,
                                             T z, T L, T M, T N, T i_in, T* g,
                                             T* gc,
                                             const T* gext = nullptr) {
  const T R = p[P_RADIUS], k = p[P_CONIC], pos = p[P_POS];
  const T dx = p[P_DX], dy = p[P_DY], npost = p[P_NPOST];
  const bool std_ = code == STANDARD;
  const T gx = g[0], gy = g[1], gz = g[2], gLo = g[3], gMo = g[4], gNo = g[5];
  const T g_nn = g[6];
  // cotangents of the local post-interaction directions: the output's (at
  // zero tilt) and the extras' L1, M1, N1
  const T gLi = gext ? gLo + gext[3] : gLo;
  const T gMi = gext ? gMo + gext[4] : gMo;
  const T gNi = gext ? gNo + gext[5] : gNo;

  // ---- recompute the forward intermediates ----
  const T xl = x - dx, yl = y - dy, zl = z - pos;
  T cu = T(0), A = T(0), a = T(0), Bq = T(0), b = T(0), Cq = T(0), c = T(0);
  T sd = T(0), sg = T(0), q = T(0), t1 = T(0), t2 = T(0), t, Ns = T(1);
  bool use1 = false, a0 = false, q0 = false, big = false;
  if (std_) {
    cu = T(1) / R;
    A = k * (N * N) + L * L + M * M + N * N;
    a = cu * A;
    Bq = k * N * zl + L * xl + M * yl + N * zl;
    b = T(2) * (cu * Bq - N);
    Cq = k * (zl * zl) + xl * xl + yl * yl + zl * zl;
    c = cu * Cq - T(2) * zl;
    const T d = b * b - T(4) * a * c;
    sd = d < T(0) ? nan_<T>() : sqrt_(d);
    sg = b >= T(0) ? T(1) : T(-1);
    q = T(-0.5) * (b + sg * sd);
    a0 = a == T(0);
    q0 = q == T(0);
    t1 = a0 ? inf_<T>() : q / a;
    t2 = q0 ? T(0) : c / q;
    use1 = abs_(zl + t1 * N) <= abs_(zl + t2 * N);
    t = use1 ? t1 : t2;
  } else {
    big = abs_(N) > T(1e-14);
    Ns = big ? N : T(1e-14);
    t = -zl / Ns;
  }
  const T x1 = xl + t * L, y1 = yl + t * M, z1 = zl + t * N;
  T r2 = T(0), rq = T(0), invd = T(0), fx = T(0), fy = T(0), im = T(1);
  T nx = T(0), ny = T(0), nz = T(-1);
  if (std_) {
    r2 = x1 * x1 + y1 * y1;
    rq = rsqrt_(T(1) - (T(1) + k) * (cu * cu) * r2);
    invd = cu * rq;
    fx = x1 * invd;
    fy = y1 * invd;
    im = rsqrt_(fx * fx + fy * fy + T(1));
    nx = fx * im;
    ny = fy * im;
    nz = -im;
  }
  const T dot = L * nx + M * ny + N * nz;
  const T sgn = sign_(dot);
  const T nxs = nx * sgn, nys = ny * sgn, nzs = nz * sgn;
  const T adot = abs_(dot);

  // ---- globalize ----
  T g_dx = gx, g_dy = gy, g_pos = gz;
  T g_x1 = gx, g_y1 = gy, g_z1 = gz;

  // ---- interact ----
  T gL, gM, gN, g_nxs, g_nys, g_nzs, g_adot, g_npre, g_npost, Lo, Mo, No;
  if (refl) {
    Lo = L - T(2) * adot * nxs;
    Mo = M - T(2) * adot * nys;
    No = N - T(2) * adot * nzs;
    gL = gLi;
    gM = gMi;
    gN = gNi;
    g_nxs = T(-2) * adot * gLi;
    g_nys = T(-2) * adot * gMi;
    g_nzs = T(-2) * adot * gNi;
    g_adot = T(-2) * (nxs * gLi + nys * gMi + nzs * gNi);
    g_npre = g_nn;
    g_npost = T(0);
  } else {
    const T u = n_pre / npost;
    const T root = sqrt_(T(1) - u * u * (T(1) - adot * adot));
    const T w = root - u * adot;
    Lo = u * L + nxs * w;
    Mo = u * M + nys * w;
    No = u * N + nzs * w;
    gL = u * gLi;
    gM = u * gMi;
    gN = u * gNi;
    g_nxs = w * gLi;
    g_nys = w * gMi;
    g_nzs = w * gNi;
    const T g_w = nxs * gLi + nys * gMi + nzs * gNi;
    T g_u = L * gLi + M * gMi + N * gNi - adot * g_w;
    g_adot = -u * g_w;
    g_u = g_u - g_w * u * (T(1) - adot * adot) / root;
    g_adot = g_adot + g_w * u * u * adot / root;
    g_npre = g_u / npost;
    g_npost = g_nn - g_u * u / npost;
  }
  if (gext) {
    // the extras' local pre-interaction directions and adot
    gL += gext[0];
    gM += gext[1];
    gN += gext[2];
    g_adot += gext[6];
  }
  gL += nxs * g_adot;
  gM += nys * g_adot;
  gN += nzs * g_adot;
  g_nxs += L * g_adot;
  g_nys += M * g_adot;
  g_nzs += N * g_adot;

  T g_k = T(0), g_cu = T(0);
  // ---- normal ----
  if (std_) {
    const T g_nx = sgn * g_nxs, g_ny = sgn * g_nys, g_nz = sgn * g_nzs;
    T g_fx = g_nx * im;
    T g_fy = g_ny * im;
    const T g_im = g_nx * fx + g_ny * fy - g_nz;
    const T g_mg = T(-0.5) * g_im * im * im * im;
    g_fx += T(2) * fx * g_mg;
    g_fy += T(2) * fy * g_mg;
    g_x1 += g_fx * invd;
    g_y1 += g_fy * invd;
    const T g_invd = g_fx * x1 + g_fy * y1;
    g_cu += g_invd * rq;
    const T g_qn = T(-0.5) * g_invd * cu * rq * rq * rq;
    g_k -= g_qn * (cu * cu) * r2;
    g_cu -= g_qn * (T(1) + k) * T(2) * cu * r2;
    const T g_r2 = -g_qn * (T(1) + k) * (cu * cu);
    g_x1 += T(2) * x1 * g_r2;
    g_y1 += T(2) * y1 * g_r2;
  }

  // ---- propagate ----
  T g_xl = g_x1, g_yl = g_y1, g_zl = g_z1;
  T g_t = g_x1 * L + g_y1 * M + g_z1 * N;
  gL += g_x1 * t;
  gM += g_y1 * t;
  gN += g_z1 * t;

  // ---- clip, absorption, OPD (FULL) ----
  T g_i = T(0), g_kpre = T(0);
  if constexpr (FULL) {
    const T ap = p[P_APMAX];
    g_i = x1 * x1 + y1 * y1 > ap * ap ? T(0) : g[7];
    if (absorbs) {
      const T kpre = p[P_KPRE];
      const T e = exp_(T(ABS) * kpre * t * T(1e3));
      const T g_a = g_i * i_in * e;
      g_t += g_a * (T(ABS) * kpre * T(1e3));
      g_kpre = g_a * (T(ABS) * t * T(1e3));
      g_i = g_i * e;
    }
    const T s_tn = sign_(t * n_pre);
    g_t += g[8] * s_tn * n_pre;
    g_npre += g[8] * s_tn * t;
  }

  // ---- intersect ----
  T g_R;
  if (std_) {
    const bool ok1 = use1 && !a0;
    const bool ok2 = !use1 && !q0;
    const T g_q = ok1 ? g_t / a : (ok2 ? -g_t * t2 / q : T(0));
    T g_a = ok1 ? -g_t * t1 / a : T(0);
    T g_c = ok2 ? g_t / q : T(0);
    T g_b = T(-0.5) * g_q;
    const T g_sd = T(-0.5) * sg * g_q;
    const T g_d = g_sd * T(0.5) / sd;
    g_b += T(2) * b * g_d;
    g_a -= T(4) * c * g_d;
    g_c -= T(4) * a * g_d;
    // a = cu A
    g_cu += g_a * A;
    const T g_A = g_a * cu;
    g_k += g_A * (N * N);
    gL += T(2) * L * g_A;
    gM += T(2) * M * g_A;
    gN += T(2) * N * (k + T(1)) * g_A;
    // b = 2 (cu B - N)
    g_cu += T(2) * g_b * Bq;
    const T g_B = T(2) * g_b * cu;
    gN -= T(2) * g_b;
    g_k += g_B * N * zl;
    gN += g_B * (k * zl + zl);
    g_zl += g_B * (k * N + N);
    gL += g_B * xl;
    g_xl += g_B * L;
    gM += g_B * yl;
    g_yl += g_B * M;
    // c = cu C - 2 zl
    g_cu += g_c * Cq;
    const T g_C = g_c * cu;
    g_zl -= T(2) * g_c;
    g_k += g_C * (zl * zl);
    g_xl += T(2) * xl * g_C;
    g_yl += T(2) * yl * g_C;
    g_zl += T(2) * zl * (k + T(1)) * g_C;
    g_R = -g_cu * (cu * cu);
  } else {
    g_zl -= g_t / Ns;
    if (big) gN += g_t * zl / (Ns * Ns);
    g_R = T(0);
  }

  // ---- tilts at zero: each rotation's generator acting on the state ----
  const T g_rx = g_yl * zl - g_zl * yl + gM * N - gN * M - gy * z1 + gz * y1
                 - gMo * No + gNo * Mo;
  const T g_ry = -g_xl * zl + g_zl * xl - gL * N + gN * L + gx * z1 - gz * x1
                 + gLo * No - gNo * Lo;
  const T g_rz = g_xl * yl - g_yl * xl + gL * M - gM * L - gx * y1 + gy * x1
                 - gLo * Mo + gMo * Lo;

  // ---- localize ----
  g_dx -= g_xl;
  g_dy -= g_yl;
  g_pos -= g_zl;
  g[0] = g_xl;
  g[1] = g_yl;
  g[2] = g_zl;
  g[3] = gL;
  g[4] = gM;
  g[5] = gN;
  g[6] = g_npre;
  gc[0] = g_R;
  gc[1] = g_k;
  gc[2] = g_pos;
  gc[3] = g_npost;
  gc[4] = g_dx;
  gc[5] = g_dy;
  gc[6] = g_rx;
  gc[7] = g_ry;
  gc[8] = g_rz;
  if constexpr (FULL) {
    g[7] = g_i;  // g[8], the opd cotangent, passes through unchanged
    gc[9] = g_kpre;
  }
}

// ---------------------------------------------------------------------------
// Reductions
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;  // full sum in lane 0
}

// Sum of (a, b) over the block, in a fixed order; every thread gets both.
template <typename T>
__device__ __forceinline__ void block_sum2(T& a, T& b, T (*red)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  a = warp_sum(a);
  b = warp_sum(b);
  if (lane == 0) {
    red[0][warp] = a;
    red[1][warp] = b;
  }
  __syncthreads();
  if (warp == 0) {
    T va = lane < nw ? red[0][lane] : T(0);
    T vb = lane < nw ? red[1][lane] : T(0);
    va = warp_sum(va);
    vb = warp_sum(vb);
    if (lane == 0) {
      red[0][0] = va;
      red[1][0] = vb;
    }
  }
  __syncthreads();
  a = red[0][0];
  b = red[1][0];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Around the step
// ---------------------------------------------------------------------------

// Copy the (S, NUM_P) param table, the aim vector (AIM) and NF rows of S
// per-surface flags into shared memory.
template <typename T, int NF, bool AIM>
__device__ __forceinline__ void load_tables(const T* params, const T* aim,
                                            const int* flags, int S, T* sp,
                                            T* sa, int* sf) {
  for (int i = threadIdx.x; i < S * NUM_P; i += blockDim.x) sp[i] = params[i];
  if constexpr (AIM)
    for (int i = threadIdx.x; i < N_AIM; i += blockDim.x) sa[i] = aim[i];
  for (int i = threadIdx.x; i < NF * S; i += blockDim.x) sf[i] = flags[i];
  __syncthreads();
}

// n of the medium before each surface s >= 1, uniform across the rays: a
// reflective surface keeps the incident medium (flag row 1 of sf).
template <typename T>
__device__ __forceinline__ void fill_npre(const T* sp, const int* sf, int S,
                                          T* npre) {
  npre[1] = sp[P_NPOST];
  for (int s = 1; s + 1 < S; ++s)
    npre[s + 1] = sf[S + s] ? npre[s] : sp[s * NUM_P + P_NPOST];
}

// The block's partial row of the summed gradients: the sum of the nw
// per-warp rows of acc, in warp order.
template <typename T, int NCOMP_MAX>
__device__ __forceinline__ void store_partial_row(T (*acc)[NCOMP_MAX],
                                                  int nw, int ncomp,
                                                  T* partial) {
  for (int j = threadIdx.x; j < ncomp; j += blockDim.x) {
    T v = T(0);
    for (int w = 0; w < nw; ++w) v += acc[w][j];
    partial[(int64_t)blockIdx.x * ncomp + j] = v;
  }
}

// Fixed-order sum of a backward's partial rows (compact layout: NG slots per
// surface, then n_aim aim entries), one block per compact column. The sum is
// scattered into the (S*NUM_P + S*nc [+ N_AIM]) layout, whose other entries
// the caller has zeroed.
template <typename T, int NG>
__global__ void __launch_bounds__(RED_BLOCK)
grad_reduce_kernel(const T* __restrict__ partial, int nblocks, int S, int nc,
                   int n_aim, T* __restrict__ out) {
  __shared__ T red[2][32];
  const int ncomp = S * NG + n_aim;
  const int col = blockIdx.x;
  T v = T(0), unused = T(0);
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
    v += partial[(int64_t)b * ncomp + col];
  block_sum2(v, unused, red);
  if (threadIdx.x == 0) {
    int dst;
    if (col < S * NG)
      dst = (col / NG) * NUM_P + kGradCol[col % NG];
    else
      dst = S * (NUM_P + nc) + (col - S * NG);
    out[dst] = v;
  }
}

}  // namespace
