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
// adjoint also sums the coefficients' gradient (dn_dcoef).
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

// The flag rows of the spec (ops/fast_trace.py: fast_spec, poly_spec):
// code, reflect, absorb, tilted, and in the polychromatic mode the
// dispersion formula code.
constexpr int F_ABS = 2, F_TILT = 3, F_FORMULA = 4;

// Copy the polychromatic mode's (S, nm) coefficient rows into shared memory
// (load_tables, which follows, synchronises).
template <typename T, bool POLY>
__device__ __forceinline__ void load_mats(const T* mats, int S, int nm,
                                          T* sm) {
  if constexpr (POLY)
    for (int i = threadIdx.x; i < S * nm; i += blockDim.x) sm[i] = mats[i];
}

// Forward: trace each ray through surfaces 1 .. S-1 and write its 8 arrays.
// POLY: each index is its surface's formula at the ray's wavelength ``wl``,
// and nothing absorbs (the JAX package's poly body). B is the build.
template <typename T, bool FIELD, bool POLY, int B>
__global__ void __launch_bounds__(FWD_BLOCK)
trace_fwd_kernel(const T* __restrict__ params, const T* __restrict__ aim,
                 const T* __restrict__ mats, const int* __restrict__ flags,
                 int S, int nm, const T* __restrict__ cf, int nc, int niters,
                 const T* px, const T* py, Rays8<const T*> in, const T* wl,
                 int64_t R, Rays8<T*> out) {
  using Bd = Build<B>;
  constexpr int CAP = Bd::CAP;
  constexpr int NF = POLY ? 5 : 4;
  __shared__ T sp[CAP * NUM_P];
  __shared__ T sr[CAP * N_ROT];
  __shared__ T sa[N_AIM];
  __shared__ T sm[POLY ? CAP * MAX_NM : 1];
  __shared__ T scf[Bd::SAG ? CAP * NC_MAX : 1];
  __shared__ int sf[NF * CAP];
  load_mats<T, POLY>(mats, S, nm, sm);
  load_coefs<T, Bd::SAG>(cf, S, nc, scf);
  // the layout rows of the aux-bearing surfaces follow the table (AUX)
  const T* lay = Bd::AUX ? cf + (int64_t)S * nc : nullptr;
  load_tables<T, NF, FIELD>(params, aim, flags, S, sp, sa, sf, sr);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  T v[8], Px, Py;
  launch_state<T, FIELD>(i, sa, px, py, in, v, Px, Py);
  T w = T(0), n = sp[P_NPOST];
  if constexpr (POLY) {
    w = wl[i];
    n = n_formula(sf[F_FORMULA * S], sm, nm, w);
  }
  for (int s = 1; s < S; ++s) {
    const int refl = sf[S + s];
    T npost = sp[s * NUM_P + P_NPOST];
    if constexpr (POLY)
      npost = refl ? n : n_formula(sf[F_FORMULA * S + s], sm + s * nm, nm, w);
    n = step_fwd<T, true, Bd::TILT, Bd::SAG, Bd::FREE, Bd::DEEP, Bd::AUX>(
        sf[s], refl, POLY ? 0 : sf[F_ABS * S + s], sf[F_TILT * S + s],
        sp + s * NUM_P, sr + s * N_ROT, scf + s * nc, lay_of(lay, s, nc), nc,
        niters, n, npost,
        v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7]);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) out.p[k][i] = v[k];
}

// Backward: retrace each ray keeping its per-surface input state, then run
// the reverse sweep seeded with its 8 output cotangents. One partial row per
// block over a grid-stride loop of ray chunks, compact layout [s * N_GF + j]
// for surface s and slot j, then (SAG) nc coefficient columns for each of
// the nsag Newton surfaces, then (FIELD) N_AIM aim entries or (POLY) S * nm
// dispersion coefficient entries [.. + s * nm + j]; the generic mode also
// writes the 8 per-ray input cotangents. The free and deep builds keep their
// per-warp rows in dynamic shared memory.
//
// POLY keeps each ray's index before surface s in the slot of its surface
// state that holds the input intensity in the monochromatic mode (the
// polychromatic trace does not absorb, so the adjoint never reads that
// intensity): the local array does not grow. The index after a refractive
// surface is the next surface's n_pre, or the chain's last index. The index
// cotangent of surface s goes to its coefficients through dn_dcoef, one
// warp sum per coefficient the formula reads.
template <typename T, bool FIELD, bool POLY, int B>
__global__ void __launch_bounds__(BWD_BLOCK)
trace_bwd_kernel(const T* __restrict__ params, const T* __restrict__ aim,
                 const T* __restrict__ mats, const int* __restrict__ flags,
                 int S, int nm, const T* __restrict__ cf, int nc, int niters,
                 int nsag, const T* px, const T* py, Rays8<const T*> in,
                 const T* wl, Rays8<const T*> cot, int64_t R, Rays8<T*> din,
                 T* __restrict__ partial) {
  using Bd = Build<B>;
  constexpr int CAP = Bd::CAP;
  constexpr int NF = POLY ? 5 : 4;
  constexpr int NW_MAX = BWD_BLOCK / 32;
  constexpr int NCOMP_MAX = CAP * N_GF + (Bd::SAG ? CAP * NC_MAX : 0) +
                            (POLY ? CAP * MAX_NM : N_AIM);
  __shared__ T sp[CAP * NUM_P];
  __shared__ T sr[CAP * N_ROT];
  __shared__ T sa[N_AIM];
  __shared__ T sm[POLY ? CAP * MAX_NM : 1];
  __shared__ T scf[Bd::SAG ? CAP * NC_MAX : 1];
  __shared__ int sf[NF * CAP];
  __shared__ int ssag[Bd::SAG ? CAP : 1];
  // the per-warp rows in dynamic shared memory
  constexpr bool DYN = Bd::DYN;
  __shared__ T acc_s[DYN ? 1 : NW_MAX * NCOMP_MAX];
  __shared__ T npre[CAP];  // mono: n_pre of surface s (uniform)
  load_mats<T, POLY>(mats, S, nm, sm);
  load_coefs<T, Bd::SAG>(cf, S, nc, scf);
  // the layout rows of the aux-bearing surfaces follow the table (AUX)
  const T* lay = Bd::AUX ? cf + (int64_t)S * nc : nullptr;
  load_tables<T, NF, FIELD>(params, aim, flags, S, sp, sa, sf, sr);
  const int nsagc = Bd::SAG ? nsag * Bd::block(nc) : 0;
  const int ncomp =
      S * N_GF + nsagc + (FIELD ? N_AIM : 0) + (POLY ? S * nm : 0);
  const int nw = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* acc = acc_rows<T, DYN>(acc_s);
  const int astride = DYN ? ncomp : NCOMP_MAX;
  const int nacc = DYN ? nw * ncomp : NW_MAX * NCOMP_MAX;
  for (int j = threadIdx.x; j < nacc; j += blockDim.x) acc[j] = T(0);
  if (threadIdx.x == 0) {
    fill_npre(sp, sf, S, npre);
    if constexpr (Bd::SAG) fill_sag<Bd::AUX>(sf, S, ssag);
  }
  __syncthreads();
  T* row = acc + warp * astride;
  const int xbase = S * N_GF + nsagc;  // the aim or dispersion columns

  // the input state (x, y, z, L, M, N) of surface s, then its input
  // intensity (mono) or its n_pre (POLY)
  T st[CAP][7];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < R;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool valid = i < R;
    T Px = T(0), Py = T(0), w = T(1), n_last = T(1);
    // cotangents of (x, y, z, L, M, N, n, i, opd)
    T g[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
    if (valid) {
      T v[8];
      launch_state<T, FIELD>(i, sa, px, py, in, v, Px, Py);
      T n = T(0);
      if constexpr (POLY) {
        w = wl[i];
        n = n_formula(sf[F_FORMULA * S], sm, nm, w);
      }
      for (int s = 1; s < S; ++s) {
        const int refl = sf[S + s];
#pragma unroll
        for (int k = 0; k < 6; ++k) st[s][k] = v[k];
        st[s][6] = POLY ? n : v[6];
        T npost = sp[s * NUM_P + P_NPOST];
        if constexpr (POLY)
          npost =
              refl ? n : n_formula(sf[F_FORMULA * S + s], sm + s * nm, nm, w);
        n = step_fwd<T, true, Bd::TILT, Bd::SAG, Bd::FREE, Bd::DEEP, Bd::AUX>(
            sf[s], refl, POLY ? 0 : sf[F_ABS * S + s], sf[F_TILT * S + s],
            sp + s * NUM_P, sr + s * N_ROT, scf + s * nc, lay_of(lay, s, nc),
            nc, niters,
            POLY ? n : npre[s], npost, v[0], v[1], v[2], v[3], v[4], v[5],
            v[6], v[7]);
      }
      n_last = n;
#pragma unroll
      for (int k = 0; k < 6; ++k) g[k] = cot.p[k][i];
      g[7] = cot.p[6][i];
      g[8] = cot.p[7][i];
    }
    for (int s = S - 1; s >= 1; --s) {
      const int refl = sf[S + s];
      T gc[N_GF] = {};
      T gs[Bd::FREE ? N_GS_CART : N_GS_RAD] = {};
      T n_pre = npre[s], npost = sp[s * NUM_P + P_NPOST];
      if constexpr (POLY) {
        n_pre = valid ? st[s][6] : T(1);
        npost = refl ? n_pre : (s + 1 < S && valid ? st[s + 1][6] : n_last);
      }
      if (valid)
        step_adjoint<T, true, Bd::TILT, Bd::SAG, Bd::FREE, Bd::DEEP, Bd::AUX>(
            sf[s], refl, POLY ? 0 : sf[F_ABS * S + s], sf[F_TILT * S + s],
            sp + s * NUM_P, sr + s * N_ROT, scf + s * nc, lay_of(lay, s, nc),
            nc, niters, n_pre,
            npost, st[s][0], st[s][1], st[s][2], st[s][3], st[s][4],
            st[s][5], POLY ? T(0) : st[s][6], g, gc, gs);
      T g_np = T(0);  // POLY: the cotangent of npost, for the coefficients
      if constexpr (POLY) {
        g_np = gc[3];
        gc[3] = T(0);
      }
#pragma unroll
      for (int j = 0; j < N_GF; ++j) {
        const T v = warp_sum(gc[j]);
        if (lane == 0) row[s * N_GF + j] += v;
      }
      if constexpr (Bd::SAG) {
        const int cb = S * N_GF + ssag[s] * Bd::block(nc);
        if (Bd::FREE && is_cart_of<Bd::AUX>(sf[s]))
          add_cart_cols_at<T, Bd::DEEP, Bd::AUX>(
              sf[s], gs, lay_of(lay, s, nc), nc, sp[s * NUM_P + P_G1],
              sp[s * NUM_P + P_G2], lane, row, cb);
        else if (is_newton_of<Bd::AUX>(sf[s]))
          add_coef_cols(gs, nc, lane, row, cb);
      }
      if constexpr (POLY) {
        if (!refl) {
          const int fc = sf[F_FORMULA * S + s];
          for (int j = 0; j < nm; ++j) {
            if (!dn_used(fc, nm, j)) continue;
            T v = valid ? g_np * dn_dcoef(fc, sm + s * nm, nm, w, npost, j)
                        : T(0);
            v = warp_sum(v);
            if (lane == 0) row[xbase + s * nm + j] += v;
          }
        }
      }
    }
    // n_pre of surface 1 is the object row's n_post (POLY: its formula's)
    if constexpr (POLY) {
      const int fc = sf[F_FORMULA * S];
      const T n0 = valid ? st[1][6] : T(1);
      for (int j = 0; j < nm; ++j) {
        if (!dn_used(fc, nm, j)) continue;
        T v = valid ? g[6] * dn_dcoef(fc, sm, nm, w, n0, j) : T(0);
        v = warp_sum(v);
        if (lane == 0) row[xbase + j] += v;
      }
    } else {
      const T v = warp_sum(g[6]);
      if (lane == 0) row[0 * N_GF + 3] += v;
    }
    if constexpr (FIELD) {
      const T ga[N_AIM] = {g[0], g[1], g[2], g[3], g[4], g[5], g[0] * Px,
                           g[1] * Py};
#pragma unroll
      for (int j = 0; j < N_AIM; ++j) {
        const T v = warp_sum(ga[j]);
        if (lane == 0) row[xbase + j] += v;
      }
    } else if (valid) {
#pragma unroll
      for (int k = 0; k < 6; ++k) din.p[k][i] = g[k];
      din.p[6][i] = g[7];
      din.p[7][i] = g[8];
    }
  }
  __syncthreads();
  store_partial_row(acc, astride, nw, ncomp, partial);
}

template <typename P>
Rays8<P> rays8(void* const* ptrs) {
  Rays8<P> r;
  for (int k = 0; k < 8; ++k) r.p[k] = ptrs == nullptr ? nullptr : (P)ptrs[k];
  return r;
}

// ``build``: the instantiation the spec needs (ops/launch.py: build_of).
template <typename T, bool FIELD, bool POLY>
int fwd_launch(const T* params, const T* aim, const T* mats, const int* flags,
               int S, int build, const T* cf, int nc, int niters, int nm,
               const T* px, const T* py, void* const* in, int64_t R,
               void* const* out, cudaStream_t stream) {
  if (POLY && (nm < 1 || nm > MAX_NM)) return (int)cudaErrorInvalidValue;
  return dispatch_build(build, [&](auto b) {
    constexpr int B = decltype(b)::value;
    if (!shape_ok<B>(S, nc, niters)) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (R + FWD_BLOCK - 1) / FWD_BLOCK;
    if (blocks > 0)
      trace_fwd_kernel<T, FIELD, POLY, B>
          <<<(unsigned)blocks, FWD_BLOCK, 0, stream>>>(
              params, aim, mats, flags, S, nm, cf, nc, niters, px, py,
              rays8<const T*>(in), POLY ? (const T*)in[8] : nullptr, R,
              rays8<T*>(out));
    return (int)cudaGetLastError();
  });
}

template <typename T, bool FIELD, bool POLY>
int bwd_launch(const T* params, const T* aim, const T* mats, const int* flags,
               int S, int build, const T* cf, int nc, int niters, int nsag,
               int nm, const T* px, const T* py, void* const* in,
               void* const* cot, int64_t R, void* const* din, T* partial,
               int nblocks, T* out, cudaStream_t stream) {
  if (nblocks < 1 || (POLY && (nm < 1 || nm > MAX_NM)) || nsag < 0 ||
      nsag > S)
    return (int)cudaErrorInvalidValue;
  const int ncb = block_cols(build, nc);
  const int nsagc = build & BIT_SAG ? nsag * ncb : 0;
  const int n_extra = FIELD ? N_AIM : (POLY ? S * nm : 0);
  const int e = dispatch_build(build, [&](auto b) {
    constexpr int B = decltype(b)::value;
    if (!shape_ok<B>(S, nc, niters)) return (int)cudaErrorInvalidValue;
    const auto kernel = trace_bwd_kernel<T, FIELD, POLY, B>;
    const size_t dyn =
        dyn_bytes<T, Build<B>::DYN>(BWD_BLOCK / 32,
                                    S * N_GF + nsagc + n_extra);
    if (int e2 = set_dyn_smem<Build<B>::DYN>(kernel, dyn)) return e2;
    kernel<<<nblocks, BWD_BLOCK, dyn, stream>>>(
        params, aim, mats, flags, S, nm, cf, nc, niters, nsag, px, py,
        rays8<const T*>(in), POLY ? (const T*)in[8] : nullptr,
        rays8<const T*>(cot), R, rays8<T*>(din), partial);
    return (int)cudaGetLastError();
  });
  if (e != 0) return e;
  return reduce_launch<T, N_GF>(partial, nblocks, S, nc, ncb, nsagc, flags,
                                n_extra, out, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface. Bundles of 8 per-ray arrays come as host arrays of 8 device
// pointers (x, y, z, L, M, N, i, opd); the polychromatic launch bundles have
// a 9th, the wavelengths (um), and their (S, nm) coefficient rows.
// ---------------------------------------------------------------------------

#define OTC_TRACE(SUF, T)                                                    \
  extern "C" int otc_trace_fwd_##SUF(                                        \
      const T* params, const int* flags, int S, int build, const T* cf,      \
      int nc, int niters, void* const* in, int64_t R, void* const* out,      \
      void* stream) {                                                        \
    return fwd_launch<T, false, false>(params, nullptr, nullptr, flags, S,   \
                                       build, cf, nc, niters, 0, nullptr,    \
                                       nullptr, in, R, out,                  \
                                       (cudaStream_t)stream);                \
  }                                                                          \
  extern "C" int otc_trace_field_fwd_##SUF(                                  \
      const T* params, const T* aim, const int* flags, int S, int build,     \
      const T* cf, int nc, int niters, const T* px, const T* py, int64_t R,  \
      void* const* out, void* stream) {                                      \
    return fwd_launch<T, true, false>(params, aim, nullptr, flags, S, build, \
                                      cf, nc, niters, 0, px, py, nullptr, R, \
                                      out, (cudaStream_t)stream);            \
  }                                                                          \
  extern "C" int otc_trace_fwd_poly_##SUF(                                   \
      const T* params, const T* mats, const int* flags, int S, int build,    \
      const T* cf, int nc, int niters, int nm, void* const* in, int64_t R,   \
      void* const* out, void* stream) {                                      \
    return fwd_launch<T, false, true>(params, nullptr, mats, flags, S,       \
                                      build, cf, nc, niters, nm, nullptr,    \
                                      nullptr, in, R, out,                   \
                                      (cudaStream_t)stream);                 \
  }                                                                          \
  extern "C" int otc_trace_bwd_##SUF(                                        \
      const T* params, const int* flags, int S, int build, const T* cf,      \
      int nc, int niters, int nsag, void* const* in, void* const* cot,       \
      int64_t R, void* const* din, T* partial, int nblocks, T* out,          \
      void* stream) {                                                        \
    return bwd_launch<T, false, false>(                                      \
        params, nullptr, nullptr, flags, S, build, cf, nc, niters, nsag, 0,  \
        nullptr, nullptr, in, cot, R, din, partial, nblocks, out,            \
        (cudaStream_t)stream);                                               \
  }                                                                          \
  extern "C" int otc_trace_field_bwd_##SUF(                                  \
      const T* params, const T* aim, const int* flags, int S, int build,     \
      const T* cf, int nc, int niters, int nsag, const T* px, const T* py,   \
      void* const* cot, int64_t R, T* partial, int nblocks, T* out,          \
      void* stream) {                                                        \
    return bwd_launch<T, true, false>(                                       \
        params, aim, nullptr, flags, S, build, cf, nc, niters, nsag, 0, px,  \
        py, nullptr, cot, R, nullptr, partial, nblocks, out,                 \
        (cudaStream_t)stream);                                               \
  }                                                                          \
  extern "C" int otc_trace_bwd_poly_##SUF(                                   \
      const T* params, const T* mats, const int* flags, int S, int build,    \
      const T* cf, int nc, int niters, int nsag, int nm, void* const* in,    \
      void* const* cot, int64_t R, void* const* din, T* partial,             \
      int nblocks, T* out, void* stream) {                                   \
    return bwd_launch<T, false, true>(                                       \
        params, nullptr, mats, flags, S, build, cf, nc, niters, nsag, nm,    \
        nullptr, nullptr, in, cot, R, din, partial, nblocks, out,            \
        (cudaStream_t)stream);                                               \
  }

OTC_TRACE(f32, float)
OTC_TRACE(f64, double)
