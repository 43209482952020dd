// The fused merit kernels' templates (fused_trace.cu) and their launchers,
// in every build: fused_trace.cu instantiates the stock to deep_aux builds
// and the grat build, nurbs_merit.cu the nurbs build (launchers with NU),
// each with its own C entries. See fused_trace.cu for what the kernels do
// and what bounds them.

#pragma once

#include "step.cuh"

namespace {

// the grating build's flag row after code, reflect, tilted
constexpr int F_GRAT = 3;

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

template <typename T, int B>
__global__ void __launch_bounds__(FWD_BLOCK)
merit_fwd_kernel(const T* __restrict__ params, const T* __restrict__ aim,
                 const int* __restrict__ flags, int S,
                 const T* __restrict__ cf, int nc, int niters,
                 const T* __restrict__ px, const T* __restrict__ py,
                 int64_t R, uint64_t seed, int64_t offset, int prng,
                 T* __restrict__ rows) {
  using Bd = Build<B>;
  constexpr int CAP = Bd::CAP;
  constexpr int NF = Bd::GRAT ? 4 : 3;
  __shared__ T sp[CAP * NUM_P];
  __shared__ T sr[CAP * N_ROT];
  __shared__ T sa[N_AIM];
  __shared__ T scf[Bd::SAG ? CAP * NC_MAX : 1];
  __shared__ int sf[NF * CAP];  // code, reflect, tilted (GRAT: grating)
  __shared__ T red[2][32];
  load_coefs<T, Bd::SAG>(cf, S, nc, scf);
  // the nets and knot rows of the NURBS surfaces (NURBS)
  if constexpr (Bd::NURBS) nurbs_tables(cf, S, nc, dyn_base<T>());
  // the layout rows of the aux-bearing surfaces follow the table (AUX)
  const T* lay = Bd::AUX ? cf + (int64_t)S * nc : nullptr;
  load_tables<T, NF, true>(params, aim, flags, S, sp, sa, sf, sr);

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
    T unused_i = T(0), unused_opd = T(0);  // the merit step traces geometry
    T n = sp[P_NPOST];
    for (int s = 1; s < S; ++s)
      if constexpr (Bd::GRAT)
        n = step_fwd_grat<T, false>(sf[s], sf[S + s], 0, sf[2 * S + s],
                                    sp + s * NUM_P, sr + s * N_ROT, n,
                                    sp[s * NUM_P + P_NPOST], x, y, z, L, M,
                                    N, unused_i, unused_opd,
                                    sf[F_GRAT * S + s]);
      else if constexpr (Bd::NURBS)
        n = step_fwd_nurbs<T, false>(
            sf[s], sf[S + s], 0, sf[2 * S + s], sp + s * NUM_P,
            sr + s * N_ROT, dyn_base<T>() + s * nc,
            dyn_base<T>() + S * nc + s * NU_KT, niters, n,
            sp[s * NUM_P + P_NPOST], x, y, z, L, M, N, unused_i, unused_opd);
      else
      n = step_fwd<T, false, Bd::TILT, Bd::SAG, Bd::FREE, Bd::DEEP, Bd::AUX>(
          sf[s], sf[S + s], 0, sf[2 * S + s], sp + s * NUM_P, sr + s * N_ROT,
          scf + s * nc, lay_of(lay, s, nc), nc, niters, n,
          sp[s * NUM_P + P_NPOST], x, y, z, L,
          M, N, unused_i, unused_opd);
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
// Compact row layout: [s * N_G + j] for surface s and slot j, then nc
// coefficient columns for each of the nsag Newton surfaces (SAG), then N_AIM
// aim entries. The block holds 32 to BWD_BLOCK threads, a multiple of 32.
// The free and deep builds keep their per-warp rows in dynamic shared memory.
template <typename T, int B>
__global__ void __launch_bounds__(BWD_BLOCK)
merit_bwd_kernel(const T* __restrict__ params, const T* __restrict__ aim,
                 const T* __restrict__ stats, const int* __restrict__ flags,
                 int S, const T* __restrict__ cf, int nc, int niters, int nsag,
                 const T* __restrict__ px, const T* __restrict__ py,
                 int64_t R, uint64_t seed, int64_t offset, int prng,
                 T* __restrict__ partial) {
  using Bd = Build<B>;
  constexpr int CAP = Bd::CAP;
  constexpr int NF = Bd::GRAT ? 4 : 3;
  constexpr int NW_MAX = BWD_BLOCK / 32;
  constexpr int NCOMP_MAX = CAP * N_G + (Bd::SAG ? CAP * NC_MAX : 0) +
                            (Bd::GRAT ? CAP * N_GRAT_COLS : 0) + N_AIM;
  __shared__ T sp[CAP * NUM_P];
  __shared__ T sr[CAP * N_ROT];
  __shared__ T sa[N_AIM];
  __shared__ T scf[Bd::SAG ? CAP * NC_MAX : 1];
  __shared__ int sf[NF * CAP];  // code, reflect, tilted (GRAT: grating)
  __shared__ int ssag[Bd::SAG || Bd::GRAT || Bd::NURBS ? CAP : 1];
  // the per-warp rows in dynamic shared memory
  constexpr bool DYN = Bd::DYN;
  __shared__ T acc_s[DYN ? 1 : NW_MAX * NCOMP_MAX];
  __shared__ T npre[CAP];  // n_pre of surface s (uniform across rays)
  load_coefs<T, Bd::SAG>(cf, S, nc, scf);
  // the layout rows of the aux-bearing surfaces follow the table (AUX)
  const T* lay = Bd::AUX ? cf + (int64_t)S * nc : nullptr;
  load_tables<T, NF, true>(params, aim, flags, S, sp, sa, sf, sr);
  const int nsagc = Bd::SAG ? nsag * Bd::block(nc)
                             : (Bd::GRAT ? nsag * N_GRAT_COLS
                                         : (Bd::NURBS ? nsag * nc : 0));
  const int ncomp = S * N_G + nsagc + N_AIM;
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* acc = acc_rows<T, DYN>(acc_s);
  const int astride = DYN ? ncomp : NCOMP_MAX;
  const int nacc = DYN ? nw * ncomp : NW_MAX * NCOMP_MAX;
  for (int j = threadIdx.x; j < nacc; j += blockDim.x) acc[j] = T(0);
  // the nets and knot rows of the NURBS surfaces after the rows (NURBS)
  if constexpr (Bd::NURBS) nurbs_tables(cf, S, nc, acc + nacc);
  if (threadIdx.x == 0) {
    fill_npre(sp, sf, S, npre);
    if constexpr (Bd::SAG) fill_sag<Bd::AUX>(sf, S, ssag);
    if constexpr (Bd::GRAT) fill_grat(sf + F_GRAT * S, S, ssag);
    if constexpr (Bd::NURBS) fill_nurbs(sf, S, ssag);
  }
  __syncthreads();
  T* row = acc + warp * astride;
  const T xbar = stats[0], ybar = stats[1], scale = stats[2];

  T st[CAP][6];
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
      T unused_i = T(0), unused_opd = T(0);  // the merit step traces geometry
      for (int s = 1; s < S; ++s) {
        st[s][0] = x;
        st[s][1] = y;
        st[s][2] = z;
        st[s][3] = L;
        st[s][4] = M;
        st[s][5] = N;
        if constexpr (Bd::GRAT)
          step_fwd_grat<T, false>(sf[s], sf[S + s], 0, sf[2 * S + s],
                                  sp + s * NUM_P, sr + s * N_ROT, npre[s],
                                  sp[s * NUM_P + P_NPOST], x, y, z, L, M, N,
                                  unused_i, unused_opd, sf[F_GRAT * S + s]);
        else if constexpr (Bd::NURBS)
          step_fwd_nurbs<T, false>(
              sf[s], sf[S + s], 0, sf[2 * S + s], sp + s * NUM_P,
              sr + s * N_ROT, acc + nacc + s * nc,
              acc + nacc + S * nc + s * NU_KT, niters, npre[s],
              sp[s * NUM_P + P_NPOST], x, y, z, L, M, N, unused_i,
              unused_opd);
        else
        step_fwd<T, false, Bd::TILT, Bd::SAG, Bd::FREE, Bd::DEEP, Bd::AUX>(
            sf[s], sf[S + s], 0, sf[2 * S + s], sp + s * NUM_P,
            sr + s * N_ROT, scf + s * nc, lay_of(lay, s, nc), nc, niters,
            npre[s],
            sp[s * NUM_P + P_NPOST], x, y, z, L, M, N, unused_i, unused_opd);
      }
      g[0] = T(2) * scale * (x - xbar);
      g[1] = T(2) * scale * (y - ybar);
    }
    for (int s = S - 1; s >= 1; --s) {
      T g6[N_G] = {};
      T gs[Bd::NURBS ? N_GS_NU : (Bd::FREE ? N_GS_CART : N_GS_RAD)] = {};
      if constexpr (Bd::GRAT) {
        if (valid)
          step_adjoint_grat<T, false>(
              sf[s], sf[S + s], 0, sf[2 * S + s], sp + s * NUM_P,
              sr + s * N_ROT, npre[s], sp[s * NUM_P + P_NPOST], st[s][0],
              st[s][1], st[s][2], st[s][3], st[s][4], st[s][5], T(0), g, g6,
              gs, sf[F_GRAT * S + s]);
      } else if constexpr (Bd::NURBS) {
        if (valid)
          step_adjoint_nurbs<T, false>(
              sf[s], sf[S + s], 0, sf[2 * S + s], sp + s * NUM_P,
              sr + s * N_ROT, acc + nacc + s * nc,
              acc + nacc + S * nc + s * NU_KT, niters, npre[s],
              sp[s * NUM_P + P_NPOST], st[s][0], st[s][1], st[s][2],
              st[s][3], st[s][4], st[s][5], T(0), g, g6, gs);
      } else {
      if (valid)
        step_adjoint<T, false, Bd::TILT, Bd::SAG, Bd::FREE, Bd::DEEP, Bd::AUX>(
            sf[s], sf[S + s], 0, sf[2 * S + s], sp + s * NUM_P,
            sr + s * N_ROT, scf + s * nc, lay_of(lay, s, nc), nc, niters,
            npre[s],
            sp[s * NUM_P + P_NPOST], st[s][0], st[s][1], st[s][2], st[s][3],
            st[s][4], st[s][5], T(0), g, g6, gs);
      }
#pragma unroll
      for (int j = 0; j < N_G; ++j) {
        const T v = warp_sum(g6[j]);
        if (lane == 0) row[s * N_G + j] += v;
      }
      if constexpr (Bd::SAG) {
        const int cb = S * N_G + ssag[s] * Bd::block(nc);
        if (Bd::FREE && is_cart_of<Bd::AUX>(sf[s]))
          add_cart_cols_at<T, Bd::DEEP, Bd::AUX>(
              sf[s], gs, lay_of(lay, s, nc), nc, sp[s * NUM_P + P_G1],
              sp[s * NUM_P + P_G2], lane, row, cb);
        else if (is_newton_of<Bd::AUX>(sf[s]))
          add_coef_cols(gs, nc, lane, row, cb);
      }
      if constexpr (Bd::GRAT)
        if (sf[F_GRAT * S + s])
          add_grat_cols(gs, lane, row, S * N_G + ssag[s] * N_GRAT_COLS);
      if constexpr (Bd::NURBS)
        if (sf[s] == NURBS)
          add_nurbs_cols(gs, acc + nacc + s * nc,
                         acc + nacc + S * nc + s * NU_KT, lane, row,
                         S * N_G + ssag[s] * nc);
    }
    // n_pre of surface 1 is the object row's n_post
    {
      const T v = warp_sum(g[6]);
      if (lane == 0) row[0 * N_G + 3] += v;
    }
    const T ga[N_AIM] = {g[0], g[1], g[2], g[3], g[4], g[5], g[0] * Px,
                         g[1] * Py};
#pragma unroll
    for (int j = 0; j < N_AIM; ++j) {
      const T v = warp_sum(ga[j]);
      if (lane == 0) row[S * N_G + nsagc + j] += v;
    }
  }
  __syncthreads();
  store_partial_row(acc, astride, nw, ncomp, partial);
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

// NU: the nurbs build's launchers (nurbs_merit.cu), which take it alone.
template <typename T, bool NU = false>
int merit_fwd_launch(const T* params, const T* aim, const int* flags, int S,
                     int build, const T* cf, int nc, int niters, const T* px,
                     const T* py, int64_t R, uint64_t seed, int64_t offset,
                     int prng, T* rows, cudaStream_t stream) {
  const auto body = [&](auto b) {
    constexpr int B = decltype(b)::value;
    if (!shape_ok<B>(S, nc, niters)) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (R + FWD_BLOCK - 1) / FWD_BLOCK;
    const auto kernel = merit_fwd_kernel<T, B>;
    const size_t dyn = Build<B>::NURBS ? nurbs_bytes<T>(S, nc) : 0;
    if (int e2 = set_dyn_smem<Build<B>::NURBS>(kernel, dyn)) return e2;
    if (blocks > 0)
      kernel<<<(unsigned)blocks, FWD_BLOCK, dyn, stream>>>(
          params, aim, flags, S, cf, nc, niters, px, py, R, seed, offset,
          prng, rows);
    return (int)cudaGetLastError();
  };
  if constexpr (NU)
    return dispatch_in<B_NURBS>(build, body);
  else
    return dispatch_build<true>(build, body);
}

template <typename T, bool NU = false>
int merit_bwd_launch(const T* params, const T* aim, const T* stats,
                     const int* flags, int S, int build, const T* cf, int nc,
                     int niters, int nsag, const T* px, const T* py, int64_t R,
                     uint64_t seed, int64_t offset, int prng, T* partial,
                     int nblocks, int block, T* out, cudaStream_t stream) {
  if (nblocks < 1 || block < 32 || block > BWD_BLOCK || block % 32 ||
      nsag < 0 || nsag > S)
    return (int)cudaErrorInvalidValue;
  const int ncb = block_cols(build, nc);
  const int nsagc =
      build & (BIT_SAG | BIT_GRAT | BIT_NURBS) ? nsag * ncb : 0;
  const auto body = [&](auto b) {
    constexpr int B = decltype(b)::value;
    if (!shape_ok<B>(S, nc, niters)) return (int)cudaErrorInvalidValue;
    const auto kernel = merit_bwd_kernel<T, B>;
    const size_t dyn =
        dyn_bytes<T, Build<B>::DYN>(block / 32, S * N_G + nsagc + N_AIM) +
        (Build<B>::NURBS ? nurbs_bytes<T>(S, nc) : 0);
    if (int e2 = set_dyn_smem<Build<B>::DYN>(kernel, dyn)) return e2;
    kernel<<<nblocks, block, dyn, stream>>>(params, aim, stats, flags, S, cf,
                                            nc, niters, nsag, px, py, R, seed,
                                            offset, prng, partial);
    return (int)cudaGetLastError();
  };
  int e;
  if constexpr (NU)
    e = dispatch_in<B_NURBS>(build, body);
  else
    e = dispatch_build<true>(build, body);
  if (e != 0) return e;
  if constexpr (NU) {
    return reduce_launch<T, N_G, false, true>(partial, nblocks, S, nc, ncb,
                                              nsagc, flags, N_AIM, out,
                                              stream);
  } else {
    if (build & BIT_GRAT)
      return reduce_launch<T, N_G, true>(partial, nblocks, S, nc, ncb, nsagc,
                                         flags + F_GRAT * S, N_AIM, out,
                                         stream);
    return reduce_launch<T, N_G>(partial, nblocks, S, nc, ncb, nsagc, flags,
                                 N_AIM, out, stream);
  }
}

}  // namespace

// The merit C entries of a build set: otc_merit_<fwd|bwd>NAME_<SUF>
// (NAME empty, or _nurbs for the nurbs build with NU).
#define OTC_FWD(SUF, T, NAME, NU)                                            \
  extern "C" int otc_merit_fwd##NAME##_##SUF(                                \
      const T* params, const T* aim, const int* flags, int S, int build,     \
      const T* cf, int nc, int niters, const T* px, const T* py, int64_t R,  \
      uint64_t seed, int64_t offset, int prng, T* rows, void* stream) {      \
    return merit_fwd_launch<T, NU>(params, aim, flags, S, build, cf, nc,     \
                                   niters,                                   \
                               px, py, R, seed, offset, prng, rows,          \
                               (cudaStream_t)stream);                        \
  }
#define OTC_BWD(SUF, T, NAME, NU)                                            \
  extern "C" int otc_merit_bwd##NAME##_##SUF(                                \
      const T* params, const T* aim, const T* stats, const int* flags,       \
      int S, int build, const T* cf, int nc, int niters, int nsag,           \
      const T* px, const T* py, int64_t R, uint64_t seed, int64_t offset,    \
      int prng, T* partial, int nblocks, int block, T* out, void* stream) {  \
    return merit_bwd_launch<T, NU>(params, aim, stats, flags, S, build, cf,  \
                                   nc,                                       \
                               niters, nsag, px, py, R, seed, offset, prng,  \
                               partial, nblocks, block, out,                 \
                               (cudaStream_t)stream);                        \
  }
