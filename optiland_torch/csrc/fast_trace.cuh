// The generic and field ray-trace kernels' templates (fast_trace.cu) and
// their launchers, in every build: fast_trace.cu instantiates the stock to
// deep_aux builds and the grat build, nurbs_trace.cu the nurbs build
// (launchers with NU), each with its own C entries. See fast_trace.cu for
// what the kernels do and what bounds them.

#pragma once

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
// dispersion formula code, in the grating build the grating flag.
constexpr int F_ABS = 2, F_TILT = 3, F_FORMULA = 4, F_GRAT = 4;

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
__global__ void __launch_bounds__(FWD_BLOCK, fwd_min_blocks<B>(sizeof(T)))
trace_fwd_kernel(const T* __restrict__ params, const T* __restrict__ aim,
                 const T* __restrict__ mats, const int* __restrict__ flags,
                 int S, int nm, const T* __restrict__ cf, int nc, int niters,
                 const T* px, const T* py, Rays8<const T*> in, const T* wl,
                 int64_t R, Rays8<T*> out) {
  using Bd = Build<B>;
  constexpr int CAP = Bd::CAP;
  constexpr bool GR = Bd::GRAT && !POLY;
  constexpr int NF = POLY || GR ? 5 : 4;
  __shared__ T sp[CAP * NUM_P];
  __shared__ T sr[CAP * N_ROT];
  __shared__ T sa[N_AIM];
  __shared__ T sm[POLY ? CAP * MAX_NM : 1];
  __shared__ T scf[Bd::SAG ? CAP * NC_MAX : 1];
  __shared__ int sf[NF * CAP];
  load_mats<T, POLY>(mats, S, nm, sm);
  load_coefs<T, Bd::SAG>(cf, S, nc, scf);
  // the homogeneous nets and knot rows of the NURBS surfaces (NURBS)
  if constexpr (Bd::NURBS) nurbs_tables(cf, S, nc, dyn_base<T>());
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
    if constexpr (GR)
      n = step_fwd_grat<T, true>(sf[s], refl, sf[F_ABS * S + s],
                                 sf[F_TILT * S + s], sp + s * NUM_P,
                                 sr + s * N_ROT, n, npost, v[0], v[1], v[2],
                                 v[3], v[4], v[5], v[6], v[7],
                                 sf[F_GRAT * S + s]);
    else if constexpr (Bd::NURBS)
      n = step_fwd_nurbs<T, true>(
          sf[s], refl, POLY ? 0 : sf[F_ABS * S + s], sf[F_TILT * S + s],
          sp + s * NUM_P, sr + s * N_ROT, NuTab<T>{dyn_base<T>(), cf, S, nc},
          s, niters, n, npost, v[0], v[1], v[2], v[3], v[4], v[5], v[6],
          v[7]);
    else
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
// the nsag Newton surfaces (GRAT: P_G1 and P_G2 for each of the nsag
// grating surfaces), then (FIELD) N_AIM aim entries or (POLY) S * nm
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
//
// The stock and tilt builds (Build::PT), which every Cooke path launches,
// run the merit backward's design of their own (fused_trace.cuh: the
// ablation, per-thread sums, step_fwd_pt and step_adjoint_pt): the slots
// of surfaces 1 .. S-1 per thread in dynamic shared memory, the object
// slot and (FIELD) the aim entries in registers, and (POLY) each warp's
// row of the S * nm dispersion columns, warp sums as before (a thread's
// own would take the shared memory that the occupancy needs).
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
  constexpr bool GR = Bd::GRAT && !POLY;
  constexpr int NF = POLY || GR ? 5 : 4;
  constexpr int NW_MAX = BWD_BLOCK / 32;
  constexpr int NCOMP_MAX = CAP * N_GF + (Bd::SAG ? CAP * NC_MAX : 0) +
                            (GR ? CAP * N_GRAT_COLS : 0) +
                            (POLY ? CAP * MAX_NM : N_AIM);
  __shared__ T sp[CAP * NUM_P];
  __shared__ T sr[CAP * N_ROT];
  __shared__ T sa[N_AIM];
  __shared__ T sm[POLY ? CAP * MAX_NM : 1];
  __shared__ T scf[Bd::SAG ? CAP * NC_MAX : 1];
  __shared__ int sf[NF * CAP];
  __shared__ int ssag[Bd::SAG || GR || Bd::NURBS ? CAP : 1];
  // the per-warp rows (PT: the per-thread sums) in dynamic shared memory
  constexpr bool DYN = Bd::DYN;
  __shared__ T acc_s[DYN || Bd::PT ? 1 : NW_MAX * NCOMP_MAX];
  __shared__ T npre[CAP];  // mono: n_pre of surface s (uniform)
  load_mats<T, POLY>(mats, S, nm, sm);
  load_coefs<T, Bd::SAG>(cf, S, nc, scf);
  // the layout rows of the aux-bearing surfaces follow the table (AUX)
  const T* lay = Bd::AUX ? cf + (int64_t)S * nc : nullptr;
  load_tables<T, NF, FIELD>(params, aim, flags, S, sp, sa, sf, sr);
  const int nsagc = Bd::SAG ? nsag * Bd::block(nc)
                             : (GR ? nsag * N_GRAT_COLS
                                   : (Bd::NURBS ? nsag * nc : 0));
  const int ncomp =
      S * N_GF + nsagc + (FIELD ? N_AIM : 0) + (POLY ? S * nm : 0);
  if constexpr (Bd::PT) {
    // column c of this thread at col[c * 32] (store_pt_row): the slots of
    // surfaces 1 .. S-1; the object row's n_post slot and (FIELD) the aim
    // entries are summed in registers and stored after the last ray. POLY:
    // each warp's row of the S * nm dispersion coefficient columns after
    // the threads' columns, warp sums (the same column for every ray of
    // the warp, which a thread's own columns would cost shared memory
    // that the occupancy needs)
    constexpr int NAIM = FIELD ? N_AIM : 0;
    const int ncols = (S - 1) * N_GF + 1 + NAIM;
    const int nrow = POLY ? S * nm : 0;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T* const acc = acc_rows<T, true>(acc_s);
    T* const col = acc + warp * ncols * 32 + lane;
    T* const prows = acc + (blockDim.x >> 5) * ncols * 32;
    T* const prow = prows + warp * nrow;
    for (int c = 0; c < ncols; ++c) col[c * 32] = T(0);
    for (int j = lane; j < nrow; j += 32) prow[j] = T(0);
    // each surface's row and flags for the step, uniform across the rays
    // (POLY: the indices and their ratios per ray)
    __shared__ __align__(16) T pt_q[CAP * PT_ROW];
    __shared__ int pt_f[CAP];
    if (threadIdx.x == 0) {
      fill_npre(sp, sf, S, npre);
      for (int s = 1; s < S; ++s) {
        fill_pt_row(sp + s * NUM_P, npre[s], pt_q + s * PT_ROW);
        pt_f[s] = pt_flags(sf[s], sf[S + s], POLY ? 0 : sf[F_ABS * S + s],
                           sf[F_TILT * S + s]);
      }
    }
    __syncthreads();
    T g_obj = T(0), g_aim[NAIM + 1] = {};
    // the input state (x, y, z, L, M, N) of surface s, its input
    // intensity (mono) or n_pre (POLY), then what its forward step saved
    T st[CAP][7 + N_SV];
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    // POLY: the warp sums need every lane, so the warp runs its last
    // chunk of rays whole, its lanes past R adding zeros
    const int64_t end = POLY ? R + 31 - (R + 31) % 32 : R;
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < end;
         i += stride) {
      const bool valid = !POLY || i < R;
      T v[8], Px = T(0), Py = T(0), w = T(1), n = T(0), n_last = T(1);
      T g[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
      if (valid) {
        launch_state<T, FIELD>(i, sa, px, py, in, v, Px, Py);
        if constexpr (POLY) {
          w = wl[i];
          n = n_formula(sf[F_FORMULA * S], sm, nm, w);
        }
        for (int s = 1; s < S; ++s) {
          const T* q = pt_q + s * PT_ROW;
#pragma unroll
          for (int k = 0; k < 6; ++k) st[s][k] = v[k];
          st[s][6] = POLY ? n : v[6];
          T n_pre = q[Q_NPRE], npost = q[Q_NPOST], u = q[Q_U];
          if constexpr (POLY) {
            n_pre = n;
            npost = sf[S + s] ? n
                              : n_formula(sf[F_FORMULA * S + s], sm + s * nm,
                                          nm, w);
            u = n / npost;
          }
          n = step_fwd_pt<T, true, Bd::TILT>(pt_f[s], q, sr + s * N_ROT, u,
                                             n_pre, npost, v[0], v[1], v[2],
                                             v[3], v[4], v[5], v[6], v[7],
                                             st[s] + 7);
        }
        n_last = n;
        // cotangents of (x, y, z, L, M, N, n, i, opd)
#pragma unroll
        for (int k = 0; k < 6; ++k) g[k] = cot.p[k][i];
        g[7] = cot.p[6][i];
        g[8] = cot.p[7][i];
      }
      for (int s = S - 1; s >= 1; --s) {
        const int refl = sf[S + s];
        const T* q = pt_q + s * PT_ROW;
        T gc[N_GF] = {};
        T n_pre = q[Q_NPRE], npost = q[Q_NPOST], u = q[Q_U];
        T inpost = q[Q_INP];
        if constexpr (POLY) {
          // the next surface's n_pre, or the chain's last index
          n_pre = valid ? st[s][6] : T(1);
          npost = refl ? n_pre : (s + 1 < S && valid ? st[s + 1][6] : n_last);
          u = n_pre / npost;
          inpost = T(1) / npost;
        }
        if (valid) {
          step_adjoint_pt<T, true, Bd::TILT>(
              pt_f[s], q, sr + s * N_ROT, u, inpost, n_pre, npost, st[s][0],
              st[s][1], st[s][2], st[s][3], st[s][4], st[s][5],
              POLY ? T(0) : st[s][6], st[s] + 7, g, gc);
          T* c = col + (s - 1) * N_GF * 32;
          // POLY: the n_post slot is the cotangent of npost, for the
          // coefficients
#pragma unroll
          for (int j = 0; j < N_GF; ++j)
            if (!POLY || j != 3) c[j * 32] += gc[j];
        }
        if constexpr (POLY) {
          if (!refl) {
            const int fc = sf[F_FORMULA * S + s];
            for (int j = 0; j < nm; ++j) {
              if (!dn_used(fc, nm, j)) continue;
              T d = valid ? gc[3] * dn_dcoef(fc, sm + s * nm, nm, w, npost, j)
                          : T(0);
              d = warp_sum(d);
              if (lane == 0) prow[s * nm + j] += d;
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
          T d = valid ? g[6] * dn_dcoef(fc, sm, nm, w, n0, j) : T(0);
          d = warp_sum(d);
          if (lane == 0) prow[j] += d;
        }
      } else {
        g_obj += g[6];
      }
      if constexpr (FIELD) {
        const T ga[N_AIM] = {g[0], g[1], g[2], g[3], g[4], g[5], g[0] * Px,
                             g[1] * Py};
#pragma unroll
        for (int j = 0; j < N_AIM; ++j) g_aim[j] += ga[j];
      } else if (valid) {
#pragma unroll
        for (int k = 0; k < 6; ++k) din.p[k][i] = g[k];
        din.p[6][i] = g[7];
        din.p[7][i] = g[8];
      }
    }
    T* c = col + (S - 1) * N_GF * 32;
    c[0] = g_obj;
#pragma unroll
    for (int j = 0; j < NAIM; ++j) c[(1 + j) * 32] = g_aim[j];
    __syncthreads();
    store_pt_row<T, N_GF>(acc, ncols, S, NAIM, prows, nrow, partial);
  } else {
    const int nw = blockDim.x >> 5;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    T* acc = acc_rows<T, DYN>(acc_s);
    const int astride = DYN ? ncomp : NCOMP_MAX;
    const int nacc = DYN ? nw * ncomp : NW_MAX * NCOMP_MAX;
    for (int j = threadIdx.x; j < nacc; j += blockDim.x) acc[j] = T(0);
    // the knot table and the NURBS surfaces' homogeneous nets after the
    // rows (from a 4-vector boundary), then the warps' staged records
    // (NURBS: nurbs_tables, nurbs_bwd_bytes)
    T* const nets = acc + (Bd::NURBS ? nu_net_stride(nacc) : nacc);
    int nwords = 0;
    if constexpr (Bd::NURBS) nwords = nurbs_tables(cf, S, nc, nets);
    const NuTab<T> ntab{nets, cf, S, nc};
    if (threadIdx.x == 0) {
      fill_npre(sp, sf, S, npre);
      if constexpr (Bd::SAG) fill_sag<Bd::AUX>(sf, S, ssag);
      if constexpr (GR) fill_grat(sf + F_GRAT * S, S, ssag);
      if constexpr (Bd::NURBS) fill_nurbs(sf, S, ssag);
    }
    __syncthreads();
    T* row = acc + warp * astride;
    const int xbase = S * N_GF + nsagc;  // the aim or dispersion columns
    // NURBS: the warp's staged records for the net columns (lane r's at
    // srec + r * 2 NU_PT, its spans at sidx + 4 r), this lane's at rec, idx
    T* const srec = nets + nwords + warp * 32 * 2 * NU_PT;
    int* const sidx = reinterpret_cast<int*>(
        nets + nwords + nw * 32 * 2 * NU_PT) + warp * 32 * 4;
    T* const rec = srec + lane * 2 * NU_PT;
    int* const idx = sidx + lane * 4;

    // the input state (x, y, z, L, M, N) of surface s, then its input
    // intensity (mono) or its n_pre (POLY)
    T st[CAP][7];
    // NURBS: each NURBS surface's stopped iterate (us, vs) from the forward
    // sweep, from which the reverse step takes its corrected step; the
    // Newton builds (SAG): each Newton surface's stopped iterate t_s, and in
    // the Cartesian builds the rest of its record, N_KEEP values (step_fwd
    // with KEEP and step_adjoint_kept, which only they run)
    T suv[Bd::NURBS ? CAP : 1][2];
    T ts[Bd::SAG ? CAP : 1][Bd::FREE ? N_KEEP : 1];
    // the Newton builds: a Newton surface's block of columns, this lane's
    // values (add_*_cols with STAGE), for warp_cols_staged
    T cv[Bd::SAG ? N_STAGE : 1];
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
          if constexpr (GR)
            n = step_fwd_grat<T, true>(sf[s], refl, sf[F_ABS * S + s],
                                       sf[F_TILT * S + s], sp + s * NUM_P,
                                       sr + s * N_ROT, npre[s], npost, v[0],
                                       v[1], v[2], v[3], v[4], v[5], v[6],
                                       v[7], sf[F_GRAT * S + s]);
          else if constexpr (Bd::NURBS)
            n = step_fwd_nurbs<T, true>(
                sf[s], refl, POLY ? 0 : sf[F_ABS * S + s], sf[F_TILT * S + s],
                sp + s * NUM_P, sr + s * N_ROT, ntab, s, niters,
                POLY ? n : npre[s], npost, v[0], v[1], v[2], v[3], v[4],
                v[5], v[6], v[7], nullptr, nullptr, suv[s]);
          else
          n = step_fwd<T, true, Bd::TILT, Bd::SAG, Bd::FREE, Bd::DEEP, Bd::AUX,
                       true>(
              sf[s], refl, POLY ? 0 : sf[F_ABS * S + s], sf[F_TILT * S + s],
              sp + s * NUM_P, sr + s * N_ROT, scf + s * nc, lay_of(lay, s, nc),
              nc, niters,
              POLY ? n : npre[s], npost, v[0], v[1], v[2], v[3], v[4], v[5],
              v[6], v[7], nullptr, nullptr, ts[s]);
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
        T gs[Bd::NURBS ? 1 : (Bd::FREE ? N_GS_CART : N_GS_RAD)] = {};
        T n_pre = npre[s], npost = sp[s * NUM_P + P_NPOST];
        if constexpr (POLY) {
          n_pre = valid ? st[s][6] : T(1);
          npost = refl ? n_pre : (s + 1 < S && valid ? st[s + 1][6] : n_last);
        }
        if constexpr (GR) {
          if (valid)
            step_adjoint_grat<T, true>(
                sf[s], refl, sf[F_ABS * S + s], sf[F_TILT * S + s],
                sp + s * NUM_P, sr + s * N_ROT, n_pre, npost, st[s][0],
                st[s][1], st[s][2], st[s][3], st[s][4], st[s][5], st[s][6], g,
                gc, gs, sf[F_GRAT * S + s]);
        } else if constexpr (Bd::NURBS) {
          if (valid)
            step_adjoint_nurbs<T, true>(
                sf[s], refl, POLY ? 0 : sf[F_ABS * S + s], sf[F_TILT * S + s],
                sp + s * NUM_P, sr + s * N_ROT, ntab, s, suv[s], n_pre,
                npost, st[s][0], st[s][1], st[s][2], st[s][3], st[s][4],
                st[s][5],
                POLY ? T(0) : st[s][6], g, gc, rec, idx);
          else
            nu_rec_none(idx);
        } else {
        if (valid)
          step_adjoint_kept<T, true, Bd::TILT, Bd::SAG, Bd::FREE, Bd::DEEP,
                            Bd::AUX>(
              sf[s], refl, POLY ? 0 : sf[F_ABS * S + s], sf[F_TILT * S + s],
              sp + s * NUM_P, sr + s * N_ROT, scf + s * nc, lay_of(lay, s, nc),
              nc, n_pre, npost, st[s][0], st[s][1], st[s][2], st[s][3],
              st[s][4], st[s][5], POLY ? T(0) : st[s][6], g, gc, gs, ts[s]);
        }
        T g_np = T(0);  // POLY: the cotangent of npost, for the coefficients
        if constexpr (POLY) {
          g_np = gc[3];
          gc[3] = T(0);
        }
        if constexpr (Bd::SAG) {
          // the slots, then the block's columns staged per lane, each
          // summed by the butterfly (warp_cols_add)
          T v16[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) v16[j] = j < N_GF ? gc[j] : T(0);
          warp_cols_add<T, 16>(v16, N_GF, lane, row + s * N_GF);
          T* const cb = row + S * N_GF + ssag[s] * Bd::block(nc);
          if (Bd::FREE && is_cart_of<Bd::AUX>(sf[s])) {
            add_cart_cols_at<T, Bd::DEEP, Bd::AUX, true>(
                sf[s], gs, lay_of(lay, s, nc), nc, sp[s * NUM_P + P_G1],
                sp[s * NUM_P + P_G2], lane, cv, 0);
            warp_cols_staged(cv, nc + 2, lane, cb);
          } else if (is_newton_of<Bd::AUX>(sf[s])) {
            add_coef_cols<T, true>(gs, nc, lane, cv, 0);
            warp_cols_staged(cv, nc, lane, cb);
          }
        } else {
  #pragma unroll
          for (int j = 0; j < N_GF; ++j) {
            const T v = warp_sum(gc[j]);
            if (lane == 0) row[s * N_GF + j] += v;
          }
        }
        if constexpr (GR)
          if (sf[F_GRAT * S + s])
            add_grat_cols(gs, lane, row, S * N_GF + ssag[s] * N_GRAT_COLS);
        if constexpr (Bd::NURBS)
          if (sf[s] == NURBS)
            nurbs_warp_cols(srec, sidx, nu_surf(ntab, s), lane, row,
                            S * N_GF + ssag[s] * nc);
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
        if constexpr (Bd::SAG) {
          T ga[N_AIM] = {g[0], g[1], g[2], g[3], g[4], g[5], g[0] * Px,
                         g[1] * Py};
          warp_cols_add<T, N_AIM>(ga, N_AIM, lane, row + xbase);
        } else {
          const T ga[N_AIM] = {g[0], g[1], g[2], g[3], g[4], g[5],
                               g[0] * Px, g[1] * Py};
  #pragma unroll
          for (int j = 0; j < N_AIM; ++j) {
            const T v = warp_sum(ga[j]);
            if (lane == 0) row[xbase + j] += v;
          }
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
}

template <typename P>
Rays8<P> rays8(void* const* ptrs) {
  Rays8<P> r;
  for (int k = 0; k < 8; ++k) r.p[k] = ptrs == nullptr ? nullptr : (P)ptrs[k];
  return r;
}

// ``build``: the instantiation the spec needs (ops/launch.py: build_of).
// NU: the nurbs build's launcher (nurbs_trace.cu), which takes it alone.
template <typename T, bool FIELD, bool POLY, bool NU = false>
int fwd_launch(const T* params, const T* aim, const T* mats, const int* flags,
               int S, int build, const T* cf, int nc, int kt, int niters,
               int nm, const T* px, const T* py, void* const* in, int64_t R,
               void* const* out, cudaStream_t stream) {
  if (POLY && (nm < 1 || nm > MAX_NM)) return (int)cudaErrorInvalidValue;
  const auto body = [&](auto b) {
    constexpr int B = decltype(b)::value;
    if (!shape_ok<B>(S, nc, niters)) return (int)cudaErrorInvalidValue;
    const int64_t blocks = (R + FWD_BLOCK - 1) / FWD_BLOCK;
    const auto kernel = trace_fwd_kernel<T, FIELD, POLY, B>;
    if (Build<B>::NURBS && kt <= S) return (int)cudaErrorInvalidValue;
    // the tables, with room for a net on every surface (the forward's
    // launch does not count the NURBS surfaces)
    const size_t dyn = Build<B>::NURBS ? nurbs_bytes<T>(S, nc, kt) : 0;
    if (int e2 = set_dyn_smem<Build<B>::NURBS>(kernel, dyn)) return e2;
    if (blocks > 0)
      kernel<<<(unsigned)blocks, FWD_BLOCK, dyn, stream>>>(
          params, aim, mats, flags, S, nm, cf, nc, niters, px, py,
          rays8<const T*>(in), POLY ? (const T*)in[8] : nullptr, R,
          rays8<T*>(out));
    return (int)cudaGetLastError();
  };
  if constexpr (NU)
    return dispatch_in<B_NURBS>(build, body);
  else
    return dispatch_build<!POLY>(build, body);
}

// ``block``: the threads of a block, a multiple of 32 up to BWD_BLOCK (the
// per-thread-sum builds, Build::PT: ops/launch.py, bwd_shape).
template <typename T, bool FIELD, bool POLY, bool NU = false>
int bwd_launch(const T* params, const T* aim, const T* mats, const int* flags,
               int S, int build, const T* cf, int nc, int kt, int niters,
               int nsag, int nm, const T* px, const T* py, void* const* in,
               void* const* cot, int64_t R, void* const* din, T* partial,
               int nblocks, int block, T* out, cudaStream_t stream) {
  if (nblocks < 1 || (POLY && (nm < 1 || nm > MAX_NM)) || nsag < 0 ||
      nsag > S || block < 32 || block > BWD_BLOCK || block % 32)
    return (int)cudaErrorInvalidValue;
  const int ncb = block_cols(build, nc);
  const int nsagc =
      build & (BIT_SAG | BIT_GRAT | BIT_NURBS) ? nsag * ncb : 0;
  const int n_extra = FIELD ? N_AIM : (POLY ? S * nm : 0);
  const auto body = [&](auto b) {
    constexpr int B = decltype(b)::value;
    if (!shape_ok<B>(S, nc, niters)) return (int)cudaErrorInvalidValue;
    const auto kernel = trace_bwd_kernel<T, FIELD, POLY, B>;
    const int ncomp = S * N_GF + nsagc + n_extra;
    size_t dyn;
    if constexpr (Build<B>::PT) {
      dyn = pt_bytes<T>(block, (S - 1) * N_GF + 1 + (FIELD ? N_AIM : 0),
                        POLY ? S * nm : 0);
      if (int e2 = set_pt_smem(kernel, dyn)) return e2;
    } else if constexpr (Build<B>::NURBS) {
      if (kt <= S || nsag < 1) return (int)cudaErrorInvalidValue;
      dyn = nurbs_bwd_bytes<T>(block, ncomp, nsag, nc, kt);
      if (int e2 = set_pt_smem(kernel, dyn)) return e2;
    } else {
      dyn = dyn_bytes<T, Build<B>::DYN>(block / 32, ncomp);
      if (int e2 = set_dyn_smem<Build<B>::DYN>(kernel, dyn)) return e2;
    }
    kernel<<<nblocks, block, dyn, stream>>>(
        params, aim, mats, flags, S, nm, cf, nc, niters, nsag, px, py,
        rays8<const T*>(in), POLY ? (const T*)in[8] : nullptr,
        rays8<const T*>(cot), R, rays8<T*>(din), partial);
    return (int)cudaGetLastError();
  };
  int e;
  if constexpr (NU)
    e = dispatch_in<B_NURBS>(build, body);
  else
    e = dispatch_build<!POLY>(build, body);
  if (e != 0) return e;
  if constexpr (NU) {
    return reduce_launch<T, N_GF, false, true>(partial, nblocks, S, nc, ncb,
                                               nsagc, flags, n_extra, out,
                                               stream);
  } else {
    if (build & BIT_GRAT)
      return reduce_launch<T, N_GF, true>(partial, nblocks, S, nc, ncb,
                                          nsagc, flags + F_GRAT * S, n_extra,
                                          out, stream);
    return reduce_launch<T, N_GF>(partial, nblocks, S, nc, ncb, nsagc, flags,
                                  n_extra, out, stream);
  }
}

// Resident blocks per SM of the backward (the stock, tilt and Newton
// builds; NU: the nurbs build) of ``mode`` (0 generic, 1 field, 2 poly) at
// ``block`` threads and ``dyn`` bytes (ops/launch.py: bwd_grid).
template <typename T, bool NU = false>
int trace_bwd_occupancy(int mode, int build, int block, int64_t dyn,
                        int* out) {
  const auto body = [&](auto b) {
    constexpr int B = decltype(b)::value;
    if (mode == 1)
      return pt_occupancy(trace_bwd_kernel<T, true, false, B>, block, dyn,
                          out);
    if (mode == 2)
      return pt_occupancy(trace_bwd_kernel<T, false, true, B>, block, dyn,
                          out);
    return pt_occupancy(trace_bwd_kernel<T, false, false, B>, block, dyn,
                        out);
  };
  if constexpr (NU)
    return dispatch_in<B_NURBS>(build, body);
  else
    return dispatch_in<B_STOCK, B_TILT, B_SAG, B_FREE, B_DEEP, B_DEEP_FREE,
                       B_AUX, B_DEEP_AUX>(build, body);
}

}  // namespace

// The C entries of a build set: otc_<kernel>NAME_<SUF> (NAME empty, or
// _nurbs for the nurbs build with NU).
#define OTC_TRACE(SUF, T, NAME, NU)                                          \
  extern "C" int otc_trace_fwd##NAME##_##SUF(                                \
      const T* params, const int* flags, int S, int build, const T* cf,      \
      int nc, int kt, int niters, void* const* in, int64_t R,                \
      void* const* out, void* stream) {                                      \
    return fwd_launch<T, false, false, NU>(                                  \
        params, nullptr, nullptr, flags, S, build, cf, nc, kt, niters, 0,    \
        nullptr, nullptr, in, R, out, (cudaStream_t)stream);                 \
  }                                                                          \
  extern "C" int otc_trace_field_fwd##NAME##_##SUF(                          \
      const T* params, const T* aim, const int* flags, int S, int build,     \
      const T* cf, int nc, int kt, int niters, const T* px, const T* py,     \
      int64_t R, void* const* out, void* stream) {                           \
    return fwd_launch<T, true, false, NU>(                                   \
        params, aim, nullptr, flags, S, build, cf, nc, kt, niters, 0, px,    \
        py, nullptr, R, out, (cudaStream_t)stream);                          \
  }                                                                          \
  extern "C" int otc_trace_fwd_poly##NAME##_##SUF(                           \
      const T* params, const T* mats, const int* flags, int S, int build,    \
      const T* cf, int nc, int kt, int niters, int nm, void* const* in,      \
      int64_t R, void* const* out, void* stream) {                           \
    return fwd_launch<T, false, true, NU>(                                   \
        params, nullptr, mats, flags, S, build, cf, nc, kt, niters, nm,      \
        nullptr, nullptr, in, R, out, (cudaStream_t)stream);                 \
  }                                                                          \
  extern "C" int otc_trace_bwd##NAME##_##SUF(                                \
      const T* params, const int* flags, int S, int build, const T* cf,      \
      int nc, int kt, int niters, int nsag, void* const* in,                 \
      void* const* cot, int64_t R, void* const* din, T* partial,             \
      int nblocks, int block, T* out, void* stream) {                        \
    return bwd_launch<T, false, false, NU>(                                  \
        params, nullptr, nullptr, flags, S, build, cf, nc, kt, niters, nsag, \
        0, nullptr, nullptr, in, cot, R, din, partial, nblocks, block, out,  \
        (cudaStream_t)stream);                                               \
  }                                                                          \
  extern "C" int otc_trace_field_bwd##NAME##_##SUF(                          \
      const T* params, const T* aim, const int* flags, int S, int build,     \
      const T* cf, int nc, int kt, int niters, int nsag, const T* px,        \
      const T* py, void* const* cot, int64_t R, T* partial, int nblocks,     \
      int block, T* out, void* stream) {                                     \
    return bwd_launch<T, true, false, NU>(                                   \
        params, aim, nullptr, flags, S, build, cf, nc, kt, niters, nsag, 0,  \
        px, py, nullptr, cot, R, nullptr, partial, nblocks, block, out,      \
        (cudaStream_t)stream);                                               \
  }                                                                          \
  extern "C" int otc_trace_bwd_poly##NAME##_##SUF(                           \
      const T* params, const T* mats, const int* flags, int S, int build,    \
      const T* cf, int nc, int kt, int niters, int nsag, int nm,             \
      void* const* in, void* const* cot, int64_t R, void* const* din,        \
      T* partial, int nblocks, int block, T* out, void* stream) {            \
    return bwd_launch<T, false, true, NU>(                                   \
        params, nullptr, mats, flags, S, build, cf, nc, kt, niters, nsag,    \
        nm, nullptr, nullptr, in, cot, R, din, partial, nblocks, block, out, \
        (cudaStream_t)stream);                                               \
  }
