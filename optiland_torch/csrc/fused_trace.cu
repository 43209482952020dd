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
// parameter table, the aim vector and the geometry/reflect flags in shared
// memory (uniform across the block, so the per-surface branch does not
// diverge), block reductions with warp shuffles, and no float atomics.
// The backward keeps each ray's per-surface input state in a local array
// bounded by MAX_SURF for its reverse sweep instead of re-tracing.
//
// Every extern "C" entry launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NUM_P = 15;
constexpr int P_RADIUS = 0, P_CONIC = 1, P_POS = 2, P_NPOST = 3;
constexpr int P_DX = 6, P_DY = 7, P_RX = 8, P_RY = 9, P_RZ = 10;
constexpr int N_AIM = 8;
constexpr int A_X0 = 0, A_Y0 = 1, A_Z0 = 2, A_L = 3, A_M = 4, A_N = 5;
constexpr int A_SX = 6, A_SY = 7;
constexpr int PLANE = 0, STANDARD = 1;
// per-surface gradient slots: radius, conic, pos, n_post, dx, dy, and the
// tilts rx, ry, rz (their derivative at zero tilt: the kernels trace
// untilted systems)
constexpr int N_G = 9;
__constant__ int kGradCol[N_G] = {P_RADIUS, P_CONIC, P_POS, P_NPOST, P_DX,
                                  P_DY, P_RX, P_RY, P_RZ};

// launch shapes (optiland_torch/ops/fused_trace.py holds the same values)
constexpr int MAX_SURF = 16;
constexpr int FWD_BLOCK = 256;
constexpr int BWD_BLOCK = 128;
constexpr int RED_BLOCK = 256;

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
// Philox4x32-10 (Salmon et al., SC'11): counter (ray index, 0, 0), key = seed
// ---------------------------------------------------------------------------

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
}

// unit-disk sample of global ray index g: r = sqrt(u1), th = 2 pi u2,
// u = (bits >> 8) 2^-24 (the JAX package's _bits_to_unit and _prng_disk)
template <typename T>
__device__ __forceinline__ void disk_sample(uint64_t seed, int64_t g, T& px,
                                            T& py, T& u1, T& u2) {
  uint32_t c[4] = {(uint32_t)(uint64_t)g, (uint32_t)((uint64_t)g >> 32), 0u, 0u};
  philox4x32_10(c, (uint32_t)seed, (uint32_t)(seed >> 32));
  const T scale = T(5.9604644775390625e-08);  // 2^-24
  u1 = T(c[0] >> 8) * scale;
  u2 = T(c[1] >> 8) * scale;
  const T r = sqrt_(u1);
  const T th = u2 * T(6.283185307179586);
  px = r * cos_(th);
  py = r * sin_(th);
}

// ---------------------------------------------------------------------------
// Surface chain (PLANE and STANDARD branches of _step_tile)
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
template <typename T>
__device__ __forceinline__ T step_fwd(int code, int refl, const T* p, T n_pre,
                                      T& x, T& y, T& z, T& L, T& M, T& N) {
  const T R = p[P_RADIUS], k = p[P_CONIC], pos = p[P_POS];
  const T xl = x - p[P_DX], yl = y - p[P_DY], zl = z - pos;
  const T t = code == STANDARD ? dist_standard(R, k, xl, yl, zl, L, M, N)
                               : dist_plane(zl, N);
  const T x1 = xl + t * L, y1 = yl + t * M, z1 = zl + t * N;
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
// fused_trace._step_adjoint_plain). In: the step's input state and the
// cotangents g[0..6] of its outputs (x, y, z, L, M, N, n_next). Out: g
// becomes the cotangents of the inputs (x, y, z, L, M, N, n_pre), g6 the
// cotangents of (radius, conic, pos, n_post, dx, dy, rx, ry, rz).
template <typename T>
__device__ __forceinline__ void step_adjoint(int code, int refl, const T* p,
                                             T n_pre, T x, T y, T z, T L, T M,
                                             T N, T g[7], T g6[N_G]) {
  const T R = p[P_RADIUS], k = p[P_CONIC], pos = p[P_POS];
  const T dx = p[P_DX], dy = p[P_DY], npost = p[P_NPOST];
  const bool std_ = code == STANDARD;
  const T gx = g[0], gy = g[1], gz = g[2], gLo = g[3], gMo = g[4], gNo = g[5];
  const T g_nn = g[6];

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
    gL = gLo;
    gM = gMo;
    gN = gNo;
    g_nxs = T(-2) * adot * gLo;
    g_nys = T(-2) * adot * gMo;
    g_nzs = T(-2) * adot * gNo;
    g_adot = T(-2) * (nxs * gLo + nys * gMo + nzs * gNo);
    g_npre = g_nn;
    g_npost = T(0);
  } else {
    const T u = n_pre / npost;
    const T root = sqrt_(T(1) - u * u * (T(1) - adot * adot));
    const T w = root - u * adot;
    Lo = u * L + nxs * w;
    Mo = u * M + nys * w;
    No = u * N + nzs * w;
    gL = u * gLo;
    gM = u * gMo;
    gN = u * gNo;
    g_nxs = w * gLo;
    g_nys = w * gMo;
    g_nzs = w * gNo;
    const T g_w = nxs * gLo + nys * gMo + nzs * gNo;
    T g_u = L * gLo + M * gMo + N * gNo - adot * g_w;
    g_adot = -u * g_w;
    g_u = g_u - g_w * u * (T(1) - adot * adot) / root;
    g_adot = g_adot + g_w * u * u * adot / root;
    g_npre = g_u / npost;
    g_npost = g_nn - g_u * u / npost;
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
  const T g_t = g_x1 * L + g_y1 * M + g_z1 * N;
  gL += g_x1 * t;
  gM += g_y1 * t;
  gN += g_z1 * t;

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
  g6[0] = g_R;
  g6[1] = g_k;
  g6[2] = g_pos;
  g6[3] = g_npost;
  g6[4] = g_dx;
  g6[5] = g_dy;
  g6[6] = g_rx;
  g6[7] = g_ry;
  g6[8] = g_rz;
}

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

template <typename T>
__device__ __forceinline__ void load_tables(const T* params, const T* aim,
                                            const int* flags, int S, T* sp,
                                            T* sa, int* sf) {
  for (int i = threadIdx.x; i < S * NUM_P; i += blockDim.x) sp[i] = params[i];
  for (int i = threadIdx.x; i < N_AIM; i += blockDim.x) sa[i] = aim[i];
  for (int i = threadIdx.x; i < 2 * S; i += blockDim.x) sf[i] = flags[i];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256)
prng_disk_kernel(uint64_t seed, int64_t offset, int64_t R, T* px, T* py,
                 T* u1, T* u2) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  T a, b, v1, v2;
  disk_sample<T>(seed, i + offset, a, b, v1, v2);
  px[i] = a;
  py[i] = b;
  if (u1 != nullptr) {
    u1[i] = v1;
    u2[i] = v2;
  }
}

template <typename T>
__global__ void __launch_bounds__(FWD_BLOCK)
merit_fwd_kernel(const T* __restrict__ params, const T* __restrict__ aim,
                 const int* __restrict__ flags, int S,
                 const T* __restrict__ px, const T* __restrict__ py,
                 int64_t R, uint64_t seed, int64_t offset, int prng,
                 T* __restrict__ rows) {
  __shared__ T sp[MAX_SURF * NUM_P];
  __shared__ T sa[N_AIM];
  __shared__ int sf[2 * MAX_SURF];
  __shared__ T red[2][32];
  load_tables(params, aim, flags, S, sp, sa, sf);

  const int64_t base = (int64_t)blockIdx.x * blockDim.x;
  const int64_t i = base + threadIdx.x;
  const bool valid = i < R;
  T x = T(0), y = T(0);
  if (valid) {
    T Px, Py;
    if (prng) {
      T v1, v2;
      disk_sample<T>(seed, i + offset, Px, Py, v1, v2);
    } else {
      Px = px[i];
      Py = py[i];
    }
    x = Px * sa[A_SX] + sa[A_X0];
    y = Py * sa[A_SY] + sa[A_Y0];
    T z = sa[A_Z0], L = sa[A_L], M = sa[A_M], N = sa[A_N];
    T n = sp[P_NPOST];
    for (int s = 1; s < S; ++s)
      n = step_fwd(sf[s], sf[S + s], sp + s * NUM_P, n, x, y, z, L, M, N);
  }
  const int64_t rem = R - base;
  const T cnt = T(rem < (int64_t)blockDim.x ? rem : (int64_t)blockDim.x);
  T sx = valid ? x : T(0), sy = valid ? y : T(0);
  block_sum2(sx, sy, red);
  const T mx = sx / cnt, my = sy / cnt;
  T qx = valid ? (x - mx) * (x - mx) : T(0);
  T qy = valid ? (y - my) * (y - my) : T(0);
  block_sum2(qx, qy, red);
  if (threadIdx.x == 0) {
    T* row = rows + (int64_t)blockIdx.x * 5;
    row[0] = mx;
    row[1] = my;
    row[2] = qx;
    row[3] = qy;
    row[4] = cnt;
  }
}

// One partial gradient row per block over a grid-stride loop of ray chunks.
// Compact row layout: [s * N_G + j] for surface s and slot j, then N_AIM
// aim entries. The block holds 32 to BWD_BLOCK threads, a multiple of 32.
template <typename T>
__global__ void __launch_bounds__(BWD_BLOCK)
merit_bwd_kernel(const T* __restrict__ params, const T* __restrict__ aim,
                 const T* __restrict__ stats, const int* __restrict__ flags,
                 int S, const T* __restrict__ px, const T* __restrict__ py,
                 int64_t R, uint64_t seed, int64_t offset, int prng,
                 T* __restrict__ partial) {
  constexpr int NW_MAX = BWD_BLOCK / 32;
  constexpr int NCOMP_MAX = MAX_SURF * N_G + N_AIM;
  __shared__ T sp[MAX_SURF * NUM_P];
  __shared__ T sa[N_AIM];
  __shared__ int sf[2 * MAX_SURF];
  __shared__ T acc[NW_MAX][NCOMP_MAX];
  __shared__ T npre[MAX_SURF];  // n_pre of surface s (uniform across rays)
  load_tables(params, aim, flags, S, sp, sa, sf);
  const int ncomp = S * N_G + N_AIM;
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < NW_MAX * NCOMP_MAX; j += blockDim.x)
    (&acc[0][0])[j] = T(0);
  if (threadIdx.x == 0) {
    npre[1] = sp[P_NPOST];
    for (int s = 1; s + 1 < S; ++s)
      npre[s + 1] = sf[S + s] ? npre[s] : sp[s * NUM_P + P_NPOST];
  }
  __syncthreads();
  const T xbar = stats[0], ybar = stats[1], scale = stats[2];

  T st[MAX_SURF][6];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < R;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool valid = i < R;
    T Px = T(0), Py = T(0);
    T g[7] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
    if (valid) {
      if (prng) {
        T v1, v2;
        disk_sample<T>(seed, i + offset, Px, Py, v1, v2);
      } else {
        Px = px[i];
        Py = py[i];
      }
      T x = Px * sa[A_SX] + sa[A_X0];
      T y = Py * sa[A_SY] + sa[A_Y0];
      T z = sa[A_Z0], L = sa[A_L], M = sa[A_M], N = sa[A_N];
      for (int s = 1; s < S; ++s) {
        st[s][0] = x;
        st[s][1] = y;
        st[s][2] = z;
        st[s][3] = L;
        st[s][4] = M;
        st[s][5] = N;
        step_fwd(sf[s], sf[S + s], sp + s * NUM_P, npre[s], x, y, z, L, M, N);
      }
      g[0] = T(2) * scale * (x - xbar);
      g[1] = T(2) * scale * (y - ybar);
    }
    for (int s = S - 1; s >= 1; --s) {
      T g6[N_G] = {};
      if (valid)
        step_adjoint(sf[s], sf[S + s], sp + s * NUM_P, npre[s], st[s][0],
                     st[s][1], st[s][2], st[s][3], st[s][4], st[s][5], g, g6);
#pragma unroll
      for (int j = 0; j < N_G; ++j) {
        const T v = warp_sum(g6[j]);
        if (lane == 0) acc[warp][s * N_G + j] += v;
      }
    }
    // n_pre of surface 1 is the object row's n_post
    {
      const T v = warp_sum(g[6]);
      if (lane == 0) acc[warp][0 * N_G + 3] += v;
    }
    const T ga[N_AIM] = {g[0], g[1], g[2], g[3], g[4], g[5], g[0] * Px,
                         g[1] * Py};
#pragma unroll
    for (int j = 0; j < N_AIM; ++j) {
      const T v = warp_sum(ga[j]);
      if (lane == 0) acc[warp][S * N_G + j] += v;
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < ncomp; j += blockDim.x) {
    T v = T(0);
    for (int w = 0; w < nw; ++w) v += acc[w][j];
    partial[(int64_t)blockIdx.x * ncomp + j] = v;
  }
}

// Fixed-order sum of the partial rows, one block per compact column; the
// result is scattered into the full (S*NUM_P + S*nc + N_AIM) layout.
template <typename T>
__global__ void __launch_bounds__(RED_BLOCK)
merit_bwd_reduce_kernel(const T* __restrict__ partial, int nblocks, int S,
                        int nc, T* __restrict__ out) {
  __shared__ T red[2][32];
  const int ncomp = S * N_G + N_AIM;
  const int col = blockIdx.x;
  T v = T(0), unused = T(0);
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
    v += partial[(int64_t)b * ncomp + col];
  block_sum2(v, unused, red);
  if (threadIdx.x == 0) {
    int dst;
    if (col < S * N_G)
      dst = (col / N_G) * NUM_P + kGradCol[col % N_G];
    else
      dst = S * (NUM_P + nc) + (col - S * N_G);
    out[dst] = v;
  }
}

template <typename T>
int prng_disk_launch(uint64_t seed, int64_t offset, int64_t R, T* px, T* py,
                     T* u1, T* u2, cudaStream_t stream) {
  const int64_t blocks = (R + 255) / 256;
  if (blocks > 0)
    prng_disk_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(seed, offset, R,
                                                              px, py, u1, u2);
  return (int)cudaGetLastError();
}

template <typename T>
int merit_fwd_launch(const T* params, const T* aim, const int* flags, int S,
                     const T* px, const T* py, int64_t R, uint64_t seed,
                     int64_t offset, int prng, T* rows, cudaStream_t stream) {
  if (S > MAX_SURF || S < 2) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (R + FWD_BLOCK - 1) / FWD_BLOCK;
  if (blocks > 0)
    merit_fwd_kernel<T><<<(unsigned)blocks, FWD_BLOCK, 0, stream>>>(
        params, aim, flags, S, px, py, R, seed, offset, prng, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int merit_bwd_launch(const T* params, const T* aim, const T* stats,
                     const int* flags, int S, int nc, const T* px,
                     const T* py, int64_t R, uint64_t seed, int64_t offset,
                     int prng, T* partial, int nblocks, int block, T* out,
                     cudaStream_t stream) {
  if (S > MAX_SURF || S < 2 || nblocks < 1 || block < 32 ||
      block > BWD_BLOCK || block % 32)
    return (int)cudaErrorInvalidValue;
  merit_bwd_kernel<T><<<nblocks, block, 0, stream>>>(
      params, aim, stats, flags, S, px, py, R, seed, offset, prng, partial);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merit_bwd_reduce_kernel<T><<<S * N_G + N_AIM, RED_BLOCK, 0, stream>>>(
      partial, nblocks, S, nc, out);
  return (int)cudaGetLastError();
}

}  // namespace

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
#define OTC_FWD(SUF, T)                                                      \
  extern "C" int otc_merit_fwd_##SUF(const T* params, const T* aim,          \
                                     const int* flags, int S, const T* px,   \
                                     const T* py, int64_t R, uint64_t seed,  \
                                     int64_t offset, int prng, T* rows,      \
                                     void* stream) {                         \
    return merit_fwd_launch<T>(params, aim, flags, S, px, py, R, seed,       \
                               offset, prng, rows, (cudaStream_t)stream);    \
  }
#define OTC_BWD(SUF, T)                                                      \
  extern "C" int otc_merit_bwd_##SUF(                                        \
      const T* params, const T* aim, const T* stats, const int* flags,       \
      int S, int nc, const T* px, const T* py, int64_t R, uint64_t seed,     \
      int64_t offset, int prng, T* partial, int nblocks, int block, T* out,  \
      void* stream) {                                                        \
    return merit_bwd_launch<T>(params, aim, stats, flags, S, nc, px, py, R,  \
                               seed, offset, prng, partial, nblocks, block,  \
                               out, (cudaStream_t)stream);                   \
  }

OTC_PRNG(f32, float)
OTC_PRNG(f64, double)
OTC_FWD(f32, float)
OTC_FWD(f64, double)
OTC_BWD(f32, float)
OTC_BWD(f64, double)

extern "C" const char* otc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
