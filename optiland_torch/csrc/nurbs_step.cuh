// K6d, NURBS surfaces, on the device (sm_90a): the net's evaluation on the
// ray's span with first and second derivatives, the two-plane 2x2 Newton
// solve of the ray intersection on the parameters (u, v), and the nurbs
// build's surface step, forward and hand-derived adjoint. A line-by-line
// transcription of ops/step.py (step_plain and step_adjoint_plain with a
// NURBS surface: nurbs_forward, nurbs_adjoint, net_cotangent) and of
// core/nurbs.py (basis_ders, homogeneous, rational, _uv_step); change them
// together. Included at the end of step.cuh; only the nurbs build's sources
// (nurbs_trace.cu, nurbs_merit.cu, nurbs_pol.cu) instantiate it.
//
// A surface's net is its coefficient row: the control points P[d, i, j] at
// d nu nv + i nv + j (d = x, y, z), then the weights W[i, j] at 3 nu nv +
// i nv + j. Its knot table row (ops/launch.py: kernel_tables) holds nu, nv,
// p, q, the u knots from column 4 and the v knots from column 4 + NU_KMAX;
// the rows after the S surfaces' (the tail) hold the reciprocal knot
// differences (nu_tail). Each block copies the knot table into its dynamic
// shared memory and forms after it each net's homogeneous points (W P, W),
// one 4-vector a control point, the nets of the NURBS surfaces only
// (nurbs_tables); the raw net stays in global memory, where the guess and
// the backwards' column sums read it.
//
// The evaluation, shared by every nurbs kernel (nu_eval, nu_eval_rec):
//  * the span (nu_span): the last knot interval [U_i, U_i+1) holding u, and
//    i = n at the last knot (the JAX package's basis_list), by a binary
//    search of the knot row, five fixed steps for NU_KMAX knots;
//  * the basis (nu_basis): Cox-de Boor on the span only, the p + 1
//    functions i0 - r (r = 0..p) of degree p that can be nonzero there, from
//    the triangle N_{i,k} = a N_{i,k-1} + c N_{i+1,k-1}, differentiated
//    forward in u (to second order for the adjoint's corrected point), in
//    registers; a and c multiply by the reciprocal knot differences of the
//    tail (0 for an empty interval: the term the recurrence skips), so the
//    basis divides by nothing;
//  * the sums (nu_sums): the span's v basis contracted row by row with the
//    homogeneous points, then the u basis with the rows (core/nurbs.py:
//    homogeneous), and one reciprocal of the weight sum for S, S_u, S_v.
// Every loop runs to the compile-time bound NU_PMAX, guarded by the
// surface's degree, and the solve's evaluations are inlined, so no point
// passes through local memory; the forwards ask ptxas for 3 resident
// blocks an SM in f32 and 2 in f64 (step.cuh: fwd_min_blocks).
//
// The solve (nurbs_solve, nurbs_finish): the planes of the ray (Martin et
// al.), the guess from the net's corner points, ``niters`` clipped 2x2
// Newton steps (|det| < 1e-14 clamped to 1e-14, one reciprocal of det),
// then one more from that stopped point, through which the adjoint runs;
// t = |S - r0| and the normal Su x Sv / |.|, flipped toward -z.
//
// The backwards' forward sweep keeps each NURBS surface's stopped point
// (us, vs) (step_fwd_nurbs' uv), and the reverse step takes the one
// corrected step from it (nurbs_corrected: two evaluations of the net in
// place of the solve's niters + 2 and two more) and differentiates it
// (nurbs_adjoint, which evaluates nothing): the normal through the second
// derivatives, the clip as jnp.clip's derivative (1/2 at exactly 0 or 1),
// the correction through the Jacobian at the stopped point (the residual
// term kept) and the planes. The two evaluations leave the ray's record:
// the spans and basis values of both points, beside the homogeneous
// cotangents of the net's sums there. A warp stages its rays' records in
// shared memory, and each lane owns some of the net's control points and
// adds, in lane order, the records whose spans cover them ((p + 1)(q + 1)
// control points a point, not the whole net) into their 4 columns of the
// warp's row (nurbs_own_cols): no float atomics, no shuffles, and two
// launches give the same bits.

#pragma once

namespace {

// A ray's record of a NURBS surface's adjoint for its net columns
// (nurbs_own_cols): the spans (idx: those of u and v at the stopped point,
// then at the corrected one) and, in ``rec``, NU_PT values per point: the
// homogeneous cotangents of the net's sums there (g_H (3), g_Hu (3), g_Hv
// (3), g_w, g_wu, g_wv: nu_homog_cot), then the basis values and first
// derivatives of u and of v, NU_PMAX + 1 slots each (p + 1 or q + 1 of
// them written).
constexpr int NU_OFF_NU = 12, NU_OFF_DU = NU_OFF_NU + NU_PMAX + 1,
              NU_OFF_NV = NU_OFF_DU + NU_PMAX + 1,
              NU_OFF_DV = NU_OFF_NV + NU_PMAX + 1,
              NU_PT = NU_OFF_DV + NU_PMAX + 1;

// The binary span search's first step: the largest power of two below
// NU_KMAX, so that its five steps reach every index of a knot row.
constexpr int NU_SPAN_STEP = 16;
static_assert(2 * NU_SPAN_STEP - 1 >= NU_KMAX, "the span search's steps");

// The stride of a surface's homogeneous net in shared memory: its nc
// columns rounded up to 4-vectors, so that every control point's (W P, W)
// lies on a 16-byte boundary.
__host__ __device__ inline int nu_net_stride(int nc) { return (nc + 3) & ~3; }

// The values of a nurbs build's tables in dynamic shared memory: the kt
// rows of the knot table (the S surfaces' rows and the tail's), then ns
// homogeneous nets (the NURBS surfaces', or a bound on their count).
__host__ __device__ inline int64_t nurbs_words(int ns, int nc, int kt) {
  return (int64_t)kt * NU_KT + (int64_t)ns * nu_net_stride(nc);
}

// Bytes of a nurbs build's tables (nurbs_words) in dynamic shared memory.
template <typename T>
size_t nurbs_bytes(int ns, int nc, int kt) {
  return (size_t)nurbs_words(ns, nc, kt) * sizeof(T);
}

// The tail of the knot table (ops/launch.py: _knot_tail), after the S
// surfaces' rows: its row count E and the count ns of NURBS surfaces, then
// for each surface s the offset in the tail of its reciprocal knot
// differences, then for each surface s the slot of its homogeneous net
// among the ns (both 0 for a surface without a net), then each NURBS
// surface's reciprocals: in u, for k = 1..p, the nk_u values
// 1 / (U[i + k] - U[i]) (i = 0..nk_u - 1; 0 where the interval is empty
// or i + k passes the last knot), then the same in v.
template <typename T>
__device__ __forceinline__ const T* nu_tail(const T* kt_rows, int S) {
  return kt_rows + S * NU_KT;
}

// Load a nurbs build's tables into the dynamic shared memory at ``dyn``
// from the kernel's coefficient buffer ``cf`` (the (S, nc) table, then the
// knot table with its tail): the knot table as it is, then each NURBS
// surface's homogeneous points (W P_x, W P_y, W P_z, W) at 4 cp of its
// net's slot. Returns the values it takes (nurbs_words); the caller
// synchronises.
template <typename T>
__device__ __forceinline__ int nurbs_tables(const T* cf, int S, int nc,
                                            T* dyn) {
  const int ncq = nu_net_stride(nc);
  const T* gk = cf + (int64_t)S * nc;
  const T* gt = nu_tail(gk, S);
  const int kt = S + (int)gt[0], ns = (int)gt[1];
  for (int i = threadIdx.x; i < kt * NU_KT; i += blockDim.x) dyn[i] = gk[i];
  T* const nets = dyn + kt * NU_KT;
  const int q = ncq / 4;
  for (int i = threadIdx.x; i < S * q; i += blockDim.x) {
    const int s = i / q, cp = i - s * q;
    const int npw = (int)gk[s * NU_KT] * (int)gk[s * NU_KT + 1];
    if (cp >= npw) continue;
    const T* r = cf + (int64_t)s * nc;
    const T W = r[3 * npw + cp];
    T* h = nets + (int)gt[2 + S + s] * ncq + 4 * cp;
    h[0] = W * r[cp];
    h[1] = W * r[npw + cp];
    h[2] = W * r[2 * npw + cp];
    h[3] = W;
  }
  return (int)nurbs_words(ns, nc, kt);
}

// The dynamic shared memory of a kernel, as T.
template <typename T>
__device__ __forceinline__ T* dyn_base() {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  return reinterpret_cast<T*>(dyn_smem);
}

// A kernel's nurbs tables: the shared ones at ``tab`` (nurbs_tables) and
// the coefficient buffer ``cf`` in global memory, of S surfaces of nc
// columns.
template <typename T>
struct NuTab {
  const T* tab;
  const T* cf;
  int S, nc;
};

// Surface s's part of them: its homogeneous net ``h``, knot row ``kn`` and
// reciprocal knot differences ``rc`` in shared memory, its raw net row
// ``raw`` in global memory.
template <typename T>
struct NuSurf {
  const T* h;
  const T* kn;
  const T* rc;
  const T* raw;
};

template <typename T>
__device__ __forceinline__ NuSurf<T> nu_surf(const NuTab<T>& t, int s) {
  const T* tail = nu_tail(t.tab, t.S);
  const int kt = t.S + (int)tail[0];
  NuSurf<T> f;
  f.h = t.tab + kt * NU_KT + (int)tail[2 + t.S + s] * nu_net_stride(t.nc);
  f.kn = t.tab + s * NU_KT;
  f.rc = tail + (int)tail[2 + s];
  f.raw = t.cf + (int64_t)s * t.nc;
  return f;
}

// A control point's homogeneous 4-vector from shared memory.
__device__ __forceinline__ void nu_ld4(const float* h, float* c) {
  const float4 v = *reinterpret_cast<const float4*>(h);
  c[0] = v.x;
  c[1] = v.y;
  c[2] = v.z;
  c[3] = v.w;
}
__device__ __forceinline__ void nu_ld4(const double* h, double* c) {
  const double2 a = *reinterpret_cast<const double2*>(h);
  const double2 b = *reinterpret_cast<const double2*>(h + 2);
  c[0] = a.x;
  c[1] = a.y;
  c[2] = b.x;
  c[3] = b.y;
}

// The span of u in the knot row U of m degree-0 intervals (m + 1 knots,
// n + 1 basis functions): the last i < m with U[i] <= u < U[i + 1], n at
// u = U[m], -1 where neither holds (u outside the knots, or NaN). The
// knots do not decrease (ops/launch.py: _nurbs_bound), so the largest k
// with U[k] <= u comes from a binary search in fixed steps, and it is the
// span where k < m: the interval [U[k], U[k + 1]) is then not empty.
template <typename T, typename S>
__device__ __forceinline__ int nu_span(const S* U, int m, int n, T u) {
  int k = -1;
#pragma unroll
  for (int step = NU_SPAN_STEP; step >= 1; step >>= 1)
    if (k + step <= m && U[k + step] <= u) k += step;
  int i0 = k < m ? k : -1;
  if (u == U[m]) i0 = n;
  return i0;
}

// The basis functions i0 - r (r = 0..p) of degree p at u and their
// derivatives (ORD 1: first, 2: also second).
template <typename T>
struct NuB {
  int i0;
  T N[NU_PMAX + 1], D[NU_PMAX + 1], D2[NU_PMAX + 1];
};

// The basis of the knot row U (n + p + 2 knots) at u, with the row's
// reciprocal knot differences rc (nu_tail), in T from tables of S.
template <typename T, int ORD, typename S>
__device__ __forceinline__ void nu_basis(const S* U, const S* rc, int n,
                                         int p, T u, NuB<T>& b) {
  const int nk = n + p + 2;
  const int m = nk - 1;  // the degree-0 intervals
  const int i0 = nu_span(U, m, n, u);
  b.i0 = i0;
#pragma unroll
  for (int r = 0; r <= NU_PMAX; ++r) {
    b.N[r] = T(0);
    b.D[r] = T(0);
    b.D2[r] = T(0);
  }
  if (i0 >= 0) b.N[0] = T(1);
#pragma unroll
  for (int k = 1; k <= NU_PMAX; ++k) {
    if (k > p) break;
    const S* rk = rc + (k - 1) * nk;
#pragma unroll
    for (int r = NU_PMAX; r >= 0; --r) {
      if (r > k) continue;
      const int i = i0 - r;
      T nv = T(0), dv = T(0), d2v = T(0);
      if (i >= 0 && i <= m - 1 - k) {
        // a = (u - U_i) / (U_i+k - U_i), 0 for an empty interval
        const T da = T(rk[i]), a = (u - T(U[i])) * da;
        nv = a * b.N[r];
        if (ORD >= 1) dv = da * b.N[r] + a * b.D[r];
        if (ORD >= 2) d2v = T(2) * da * b.D[r] + a * b.D2[r];
        if (r >= 1) {
          // c = (U_i+k+1 - u) / (U_i+k+1 - U_i+1)
          const T rcc = T(rk[i + 1]), c = (T(U[i + k + 1]) - u) * rcc;
          const T dc = -rcc;
          nv = nv + c * b.N[r - 1];
          if (ORD >= 1) dv = dv + dc * b.N[r - 1] + c * b.D[r - 1];
          if (ORD >= 2) d2v = d2v + T(2) * dc * b.D[r - 1] + c * b.D2[r - 1];
        }
      }
      b.N[r] = nv;
      if (ORD >= 1) b.D[r] = dv;
      if (ORD >= 2) b.D2[r] = d2v;
    }
  }
}

// The net's point at (u, v): S and its u- and v-derivatives (ORD 2: also
// the second ones), the weight sum w (1 where it is 0) and its
// derivatives wu, wv (core/nurbs.py: homogeneous, rational).
template <typename T>
struct NuPt {
  T S[3], Su[3], Sv[3], Suu[3], Suv[3], Svv[3];
  T w, wu, wv;
};

// The homogeneous sums of the span's control points (x, y, z, w): H[0]
// the value, [1] d/du, [2] d/dv, (ORD 2) [3] uu, [4] uv, [5] vv; the v
// basis contracted with each row of the span first, then the u basis with
// the rows; in T from points of S.
template <typename T, int ORD, typename S>
__device__ __forceinline__ void nu_sums(const S* h, int nu, int nv, int p,
                                        int q, const NuB<T>& bu,
                                        const NuB<T>& bv,
                                        T (&H)[ORD >= 2 ? 6 : 3][4]) {
  constexpr int NS = ORD >= 2 ? 6 : 3;
#pragma unroll
  for (int o = 0; o < NS; ++o) H[o][0] = H[o][1] = H[o][2] = H[o][3] = T(0);
#pragma unroll
  for (int ru = 0; ru <= NU_PMAX; ++ru) {
    if (ru > p) break;
    const int i = bu.i0 - ru;
    if (i < 0 || i >= nu) continue;
    // the row's v sums: A0 of N_j(v), A1 of N_j'(v), (ORD 2) A2 of N_j''(v)
    T A0[4] = {T(0), T(0), T(0), T(0)}, A1[4] = {T(0), T(0), T(0), T(0)};
    T A2[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll
    for (int rv = 0; rv <= NU_PMAX; ++rv) {
      if (rv > q) break;
      const int j = bv.i0 - rv;
      if (j < 0 || j >= nv) continue;
      S c[4];
      nu_ld4(h + 4 * (i * nv + j), c);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        A0[d] += bv.N[rv] * c[d];
        A1[d] += bv.D[rv] * c[d];
        if constexpr (ORD >= 2) A2[d] += bv.D2[rv] * c[d];
      }
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      H[0][d] += bu.N[ru] * A0[d];
      H[1][d] += bu.D[ru] * A0[d];
      H[2][d] += bu.N[ru] * A1[d];
      if constexpr (ORD >= 2) {
        H[3][d] += bu.D2[ru] * A0[d];
        H[4][d] += bu.D[ru] * A1[d];
        H[5][d] += bu.N[ru] * A2[d];
      }
    }
  }
}

// The point in C (the compute type) from the tables of T.
template <typename T, int ORD, bool REC, typename C = T>
__device__ __forceinline__ NuPt<C> nu_eval_at(const NuSurf<T>& f, C u, C v,
                                              T* rec, int* idx) {
  const T* kn = f.kn;
  const int nu = (int)kn[0], nv = (int)kn[1];
  const int p = min((int)kn[2], NU_PMAX), q = min((int)kn[3], NU_PMAX);
  NuB<C> bu, bv;
  nu_basis<C, ORD>(kn + 4, f.rc, nu - 1, p, u, bu);
  nu_basis<C, ORD>(kn + 4 + NU_KMAX, f.rc + p * (nu + p + 1), nv - 1, q, v,
                   bv);
  if constexpr (REC) {
    // the spans and the 1-D values and first derivatives, for the column
    // sums (nurbs_own_cols)
    idx[0] = bu.i0;
    idx[1] = bv.i0;
#pragma unroll
    for (int r = 0; r <= NU_PMAX; ++r) {
      if (r <= p) {
        rec[NU_OFF_NU + r] = T(bu.N[r]);
        rec[NU_OFF_DU + r] = T(bu.D[r]);
      }
      if (r <= q) {
        rec[NU_OFF_NV + r] = T(bv.N[r]);
        rec[NU_OFF_DV + r] = T(bv.D[r]);
      }
    }
  }
  C H[ORD >= 2 ? 6 : 3][4];
  nu_sums<C, ORD>(f.h, nu, nv, p, q, bu, bv, H);
  NuPt<C> pt;
  const C ww = H[0][3] == C(0) ? C(1) : H[0][3];
  const C rw = C(1) / ww;
  pt.w = ww;
  pt.wu = H[1][3];
  pt.wv = H[2][3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    pt.S[d] = H[0][d] * rw;
    pt.Su[d] = (H[1][d] - pt.S[d] * pt.wu) * rw;
    pt.Sv[d] = (H[2][d] - pt.S[d] * pt.wv) * rw;
    if constexpr (ORD >= 2) {
      pt.Suu[d] = (H[3][d] - pt.Su[d] * pt.wu - pt.Su[d] * pt.wu -
                   pt.S[d] * H[3][3]) * rw;
      pt.Suv[d] = (H[4][d] - pt.Su[d] * pt.wv - pt.Sv[d] * pt.wu -
                   pt.S[d] * H[4][3]) * rw;
      pt.Svv[d] = (H[5][d] - pt.Sv[d] * pt.wv - pt.Sv[d] * pt.wv -
                   pt.S[d] * H[5][3]) * rw;
    } else {
      pt.Suu[d] = pt.Suv[d] = pt.Svv[d] = C(0);
    }
  }
  return pt;
}

template <typename T, int ORD, typename C = T>
__device__ __forceinline__ NuPt<C> nu_eval(const NuSurf<T>& f, C u, C v) {
  return nu_eval_at<T, ORD, false, C>(f, u, v, nullptr, nullptr);
}

// nu_eval, writing the point's spans to idx[0..1] and its basis values and
// first derivatives to the record point ``rec`` (NU_OFF_NU ..).
template <typename T, int ORD>
__device__ __noinline__ NuPt<T> nu_eval_rec(const NuSurf<T>& f, T u, T v,
                                            T* rec, int* idx) {
  return nu_eval_at<T, ORD, true>(f, u, v, rec, idx);
}

// The two planes whose intersection line is the ray: normals N1, N2 and
// offsets d1, d2 (core/nurbs.py: _planes).
template <typename T>
struct NuPlanes {
  T N1[3], N2[3], d1, d2;
};

template <typename T>
__device__ __forceinline__ NuPlanes<T> nu_planes(T x, T y, T z, T L, T M,
                                                 T N) {
  NuPlanes<T> pl;
  const bool mask = (L > M) && (L > N);
  T h1 = sqrt_(L * L + M * M), h2 = sqrt_(N * N + M * M);
  h1 = h1 == T(0) ? T(1) : h1;
  h2 = h2 == T(0) ? T(1) : h2;
  pl.N1[0] = mask ? M / h1 : T(0);
  pl.N1[1] = mask ? -L / h1 : N / h2;
  pl.N1[2] = mask ? T(0) : -M / h2;
  pl.N2[0] = pl.N1[1] * N - pl.N1[2] * M;
  pl.N2[1] = pl.N1[2] * L - pl.N1[0] * N;
  pl.N2[2] = pl.N1[0] * M - pl.N1[1] * L;
  pl.d1 = -(pl.N1[0] * x + pl.N1[1] * y + pl.N1[2] * z);
  pl.d2 = -(pl.N2[0] * x + pl.N2[1] * y + pl.N2[2] * z);
  return pl;
}

template <typename T>
__device__ __forceinline__ T nu_dot(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__device__ __forceinline__ void nu_cross(const T* a, const T* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename T>
__device__ __forceinline__ T nu_clip(T u) {
  return u < T(0) ? T(0) : (u > T(1) ? T(1) : u);
}

// d clip(U, 0, 1) / dU as jnp.clip forms it (ops/step.py: clip01_grad).
template <typename T>
__device__ __forceinline__ T nu_clip_grad(T U) {
  const T lo = U > T(0) ? T(1) : (U == T(0) ? T(0.5) : T(0));
  const T hi = U < T(1) ? T(1) : (U == T(1) ? T(0.5) : T(0));
  return lo * hi;
}

// The correction step at (u, v): the residuals and their Jacobian, the
// clamped det, (du, dv) and whether the clamp bound.
template <typename T>
struct NuStep {
  T f[6];  // f1, f2, f1u, f2u, f1v, f2v
  T det, du, dv;
  bool clamped;
};

template <typename T>
__device__ __forceinline__ NuStep<T> nu_step(const NuPlanes<T>& pl,
                                             const NuPt<T>& e) {
  NuStep<T> st;
  st.f[0] = nu_dot(pl.N1, e.S) + pl.d1;
  st.f[1] = nu_dot(pl.N2, e.S) + pl.d2;
  st.f[2] = nu_dot(pl.N1, e.Su);
  st.f[3] = nu_dot(pl.N2, e.Su);
  st.f[4] = nu_dot(pl.N1, e.Sv);
  st.f[5] = nu_dot(pl.N2, e.Sv);
  const T det = st.f[2] * st.f[5] - st.f[4] * st.f[3];
  st.clamped = abs_(det) < T(1e-14);
  st.det = st.clamped ? T(1e-14) : det;
  const T rdet = T(1) / st.det;
  st.du = (st.f[0] * st.f[5] - st.f[1] * st.f[4]) * rdet;
  st.dv = (st.f[1] * st.f[2] - st.f[0] * st.f[3]) * rdet;
  return st;
}

// The stopped point (us, vs): the guess from the net's corner points (the
// raw net's first and last x and y) and ``niters`` clipped Newton steps.
template <typename T>
__device__ __forceinline__ void nurbs_solve(const NuSurf<T>& f, int niters,
                                            T x, T y, T z, T L, T M, T N,
                                            T& us, T& vs) {
  const int npw = (int)f.kn[0] * (int)f.kn[1];
  const NuPlanes<T> pl = nu_planes(x, y, z, L, M, N);
  const T x0 = f.raw[0], x1 = f.raw[npw - 1];
  const T y0 = f.raw[npw], y1 = f.raw[2 * npw - 1];
  T u = nu_clip((x - x0) / (x1 - x0 == T(0) ? T(1) : x1 - x0));
  T v = nu_clip((y - y0) / (y1 - y0 == T(0) ? T(1) : y1 - y0));
  for (int it = 0; it < niters; ++it) {
    const NuStep<T> st = nu_step(pl, nu_eval<T, 1>(f, u, v));
    u = nu_clip(u - st.du);
    v = nu_clip(v - st.dv);
  }
  us = u;
  vs = v;
}

// t and the unit normal (flipped toward -z) after the correction step from
// the stopped point (us, vs).
template <typename T>
struct NuHit {
  T t, n[3];
};

// t = |S - r0| and the unit normal Su x Sv / |.| (flipped toward -z) at the
// net's point e.
template <typename T>
__device__ __forceinline__ NuHit<T> nu_hit(const NuPt<T>& e, T x, T y, T z) {
  NuHit<T> h;
  const T D[3] = {e.S[0] - x, e.S[1] - y, e.S[2] - z};
  h.t = sqrt_(nu_dot(D, D));
  T n[3];
  nu_cross(e.Su, e.Sv, n);
  T mag = sqrt_(nu_dot(n, n));
  mag = mag == T(0) ? T(1) : mag;
  const T nz = n[2] / mag;
  const T flip = sign_(nz == T(0) ? T(1) : -nz);
#pragma unroll
  for (int d = 0; d < 3; ++d) h.n[d] = n[d] / mag * flip;
  return h;
}

// t and the unit normal after the correction step from the stopped point
// (us, vs), computed in C.
template <typename T, typename C = T>
__device__ __forceinline__ NuHit<T> nurbs_finish(const NuSurf<T>& f, T x, T y,
                                                 T z, T L, T M, T N, T us,
                                                 T vs) {
  const NuPlanes<C> pl = nu_planes(C(x), C(y), C(z), C(L), C(M), C(N));
  const NuStep<C> st = nu_step(pl, nu_eval<T, 1>(f, C(us), C(vs)));
  const NuHit<C> h = nu_hit(
      nu_eval<T, 1>(f, nu_clip(C(us) - st.du), nu_clip(C(vs) - st.dv)), C(x),
      C(y), C(z));
  NuHit<T> o;
  o.t = T(h.t);
#pragma unroll
  for (int d = 0; d < 3; ++d) o.n[d] = T(h.n[d]);
  return o;
}

// pol_bwd's forward sweep: the hit in double whatever T, out of line. The
// float gradient of the exit intensity is ill-conditioned where the s/p
// basis nearly degenerates (near-normal incidence near the vertex of a
// polarized NURBS lens): there a few ulps in the states the forward sweep
// leaves move pol_bwd's float input cotangents by up to 1e-3 of their
// largest, in the plain version's float as much as in the kernel's. The
// states of a hit taken in double are near the exact ones; the reverse's
// precision moved nothing (PERF.md: the NURBS forwards).
template <typename T>
__device__ __noinline__ NuHit<T> nurbs_finish_bwd(const NuSurf<T>& f, T x,
                                                  T y, T z, T L, T M, T N,
                                                  T us, T vs) {
  return nurbs_finish<T, double>(f, x, y, z, L, M, N, us, vs);
}

// The homogeneous cotangents of a point's sums (ops/step.py:
// net_cotangent) from those of S, Su, Sv there: g_H, g_Hu, g_Hv, g_w,
// g_wu, g_wv, into o[0..11].
template <typename T>
__device__ __forceinline__ void nu_homog_cot(const NuPt<T>& e, const T* gS,
                                             const T* gSu, const T* gSv,
                                             T* o) {
  T gSt[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    gSt[d] = gS[d] - (e.wu * gSu[d] + e.wv * gSv[d]) / e.w;
    o[d] = gSt[d] / e.w;
    o[3 + d] = gSu[d] / e.w;
    o[6 + d] = gSv[d] / e.w;
  }
  o[9] = -(nu_dot(gSt, e.S) + nu_dot(gSu, e.Su) + nu_dot(gSv, e.Sv)) / e.w;
  o[10] = -nu_dot(gSu, e.S) / e.w;
  o[11] = -nu_dot(gSv, e.S) / e.w;
}

// The one corrected step from the stopped point (us, vs), which the adjoint
// differentiates (ops/step.py: nurbs_forward after the solve): the planes,
// the net at (us, vs) to first order, the step, and the net at the clipped
// corrected point (u1, v1) to second order; t and the normal are nu_hit's
// of that point. Two evaluations, where the solve took niters + 2; they
// write the spans and basis of both points to the ray's record (rec,
// idx), for the net's columns.
template <typename T>
struct NuFwd {
  NuPlanes<T> pl;
  NuPt<T> es, e1;
  NuStep<T> st;
  T U, V;  // the corrected point before the clip
};

template <typename T>
__device__ __noinline__ void nurbs_corrected(const NuSurf<T>& sf, T x, T y,
                                             T z, T L, T M, T N, T us, T vs,
                                             NuFwd<T>& f, T* rec, int* idx) {
  f.pl = nu_planes(x, y, z, L, M, N);
  f.es = nu_eval_rec<T, 1>(sf, us, vs, rec, idx);
  f.st = nu_step(f.pl, f.es);
  f.U = us - f.st.du;
  f.V = vs - f.st.dv;
  f.e1 = nu_eval_rec<T, 2>(sf, nu_clip(f.U), nu_clip(f.V), rec + NU_PT,
                           idx + 2);
}

// Reverse of the intersection through the corrected step ``f``
// (nurbs_corrected, from the local position (x, y, z) and direction (L, M,
// N)) for the cotangents of t and of the normal ``g_n`` (before the step's
// sign alignment): adds those of the local position to g_r0 and of the
// direction to g_k, and writes the homogeneous cotangents of both points
// to the ray's record ``rec`` (ops/step.py: nurbs_adjoint). It evaluates
// nothing.
template <typename T>
__device__ __noinline__ void nurbs_adjoint(const NuFwd<T>& f, T x, T y, T z,
                                           T L, T M, T N, T g_t,
                                           const T* g_n, T* g_r0, T* g_k,
                                           T* rec) {
  const NuPlanes<T>& pl = f.pl;
  const NuPt<T>& es = f.es;
  const NuPt<T>& e1 = f.e1;
  const NuStep<T>& st = f.st;
  const T U = f.U, V = f.V;
  const T r0[3] = {x, y, z};
  const T D[3] = {e1.S[0] - x, e1.S[1] - y, e1.S[2] - z};
  const T t = sqrt_(nu_dot(D, D));
  T n[3];
  nu_cross(e1.Su, e1.Sv, n);
  T mag = sqrt_(nu_dot(n, n));
  mag = mag == T(0) ? T(1) : mag;
  const T nh[3] = {n[0] / mag, n[1] / mag, n[2] / mag};
  const T flip = sign_(nh[2] == T(0) ? T(1) : -nh[2]);

  // the normal: Su x Sv / |.|, flipped
  const T g_nh[3] = {flip * g_n[0], flip * g_n[1], flip * g_n[2]};
  const T nd = nu_dot(nh, g_nh);
  const T g_nr[3] = {(g_nh[0] - nh[0] * nd) / mag,
                     (g_nh[1] - nh[1] * nd) / mag,
                     (g_nh[2] - nh[2] * nd) / mag};
  T g_Su1[3], g_Sv1[3];
  nu_cross(e1.Sv, g_nr, g_Su1);
  nu_cross(g_nr, e1.Su, g_Sv1);
  // t = |S1 - r0|
  T g_S1[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    g_S1[d] = g_t * D[d] / t;
    g_r0[d] -= g_S1[d];
  }
  const T g_u1 = nu_dot(g_S1, e1.Su) + nu_dot(g_Su1, e1.Suu) +
                 nu_dot(g_Sv1, e1.Suv);
  const T g_v1 = nu_dot(g_S1, e1.Sv) + nu_dot(g_Su1, e1.Suv) +
                 nu_dot(g_Sv1, e1.Svv);
  nu_homog_cot(e1, g_S1, g_Su1, g_Sv1, rec + NU_PT);
  // u1 = clip(us - du), v1 = clip(vs - dv)
  const T g_du = -g_u1 * nu_clip_grad(U);
  const T g_dv = -g_v1 * nu_clip_grad(V);
  const T f1 = st.f[0], f2 = st.f[1], f1u = st.f[2], f2u = st.f[3];
  const T f1v = st.f[4], f2v = st.f[5], det = st.det;
  const T g_f1 = (g_du * f2v - g_dv * f2u) / det;
  const T g_f2 = (g_dv * f1u - g_du * f1v) / det;
  T g_f1u = g_dv * f2 / det;
  T g_f2u = -g_dv * f1 / det;
  T g_f1v = -g_du * f2 / det;
  T g_f2v = g_du * f1 / det;
  const T g_det =
      st.clamped ? T(0) : -(g_du * st.du + g_dv * st.dv) / det;
  g_f1u += g_det * f2v;
  g_f2v += g_det * f1u;
  g_f1v -= g_det * f2u;
  g_f2u -= g_det * f1v;
  // f_k = N_k . S + d_k, f_ku = N_k . S_u, f_kv = N_k . S_v at (us, vs)
  T g_N1[3], g_N2[3], g_Ss[3], g_Sus[3], g_Svs[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    g_N1[d] = g_f1 * es.S[d] + g_f1u * es.Su[d] + g_f1v * es.Sv[d];
    g_N2[d] = g_f2 * es.S[d] + g_f2u * es.Su[d] + g_f2v * es.Sv[d];
    g_Ss[d] = g_f1 * pl.N1[d] + g_f2 * pl.N2[d];
    g_Sus[d] = g_f1u * pl.N1[d] + g_f2u * pl.N2[d];
    g_Svs[d] = g_f1v * pl.N1[d] + g_f2v * pl.N2[d];
  }
  nu_homog_cot(es, g_Ss, g_Sus, g_Svs, rec);
  // d_k = -N_k . r0
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    g_N1[d] -= g_f1 * r0[d];
    g_N2[d] -= g_f2 * r0[d];
    g_r0[d] -= g_f1 * pl.N1[d] + g_f2 * pl.N2[d];
  }
  // N2 = N1 x k
  const T k[3] = {L, M, N};
  T gk[3], t1[3];
  nu_cross(g_N2, pl.N1, gk);
  nu_cross(k, g_N2, t1);
#pragma unroll
  for (int d = 0; d < 3; ++d) g_N1[d] += t1[d];
  // N1 = (M, -L, 0) / |(L, M)| where L > M and L > N, else
  // (0, N, -M) / |(N, M)|
  const bool mask = (L > M) && (L > N);
  if (mask) {
    const T h1 = sqrt_(L * L + M * M);
    const T a1 = pl.N1[0] * g_N1[0] + pl.N1[1] * g_N1[1];
    gk[0] -= (g_N1[1] - pl.N1[1] * a1) / h1;
    gk[1] += (g_N1[0] - pl.N1[0] * a1) / h1;
  } else {
    T h2 = sqrt_(N * N + M * M);
    h2 = h2 == T(0) ? T(1) : h2;
    const T a2 = pl.N1[1] * g_N1[1] + pl.N1[2] * g_N1[2];
    gk[1] -= (g_N1[2] - pl.N1[2] * a2) / h2;
    gk[2] += (g_N1[1] - pl.N1[1] * a2) / h2;
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) g_k[d] += gk[d];
}

// A NURBS surface's net columns from the records of the warp's rays
// (nurbs_corrected, nurbs_adjoint), staged in shared memory: lane r's
// record at srec + r * 2 NU_PT, its spans at sidx + 4 r (a lane without a
// ray: nu_rec_none). Each lane owns the control points cp = lane, lane +
// 32, ... and sums, over the records in lane order, both points of each
// (the stopped before the corrected) whose span covers cp ((p + 1)(q + 1)
// control points a point): G_d of b g_H + b_u g_Hu + b_v g_Hv (d = x, y,
// z; b = N_i(u) N_j(v), b_u and b_v its derivatives) and g of b g_w + b_u
// g_wu + b_v g_wv; then it adds cp's columns W G_d and its weight's
// P . G + g to the warp's row ``row`` from column ``base`` (ops/step.py:
// net_cotangent at both points), P and W from the raw net in global
// memory. No float atomics and no shuffles, in a fixed order. Called by
// every lane of the warp between two __syncwarp (nurbs_warp_cols).
template <typename T>
__device__ __noinline__ void nurbs_own_cols(const T* srec, const int* sidx,
                                            const NuSurf<T>& f, int lane,
                                            T* row, int base) {
  const T* kn = f.kn;
  const T* net = f.raw;
  const int nv = (int)kn[1], npw = (int)kn[0] * nv;
  const int p = min((int)kn[2], NU_PMAX), q = min((int)kn[3], NU_PMAX);
  for (int cp = lane; cp < npw; cp += 32) {
    const int i = cp / nv, j = cp - i * nv;
    T G[3] = {T(0), T(0), T(0)}, g = T(0);
#pragma unroll 1
    for (int r = 0; r < 32; ++r) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int ru = sidx[4 * r + 2 * k] - i;
        const int rv = sidx[4 * r + 2 * k + 1] - j;
        if (ru < 0 || ru > p || rv < 0 || rv > q) continue;
        const T* pt = srec + (r * 2 + k) * NU_PT;
        const T Bu = pt[NU_OFF_NU + ru], dBu = pt[NU_OFF_DU + ru];
        const T Bv = pt[NU_OFF_NV + rv], dBv = pt[NU_OFF_DV + rv];
        const T b = Bu * Bv, bu = dBu * Bv, bv = Bu * dBv;
#pragma unroll
        for (int d = 0; d < 3; ++d)
          G[d] += b * pt[d] + bu * pt[3 + d] + bv * pt[6 + d];
        g += b * pt[9] + bu * pt[10] + bv * pt[11];
      }
    }
    const T W = net[3 * npw + cp];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      row[base + d * npw + cp] += W * G[d];
      g += net[d * npw + cp] * G[d];
    }
    row[base + 3 * npw + cp] += g;
  }
}

// A lane without a ray: spans that cover no control point.
__device__ __forceinline__ void nu_rec_none(int* idx) {
  idx[0] = idx[1] = idx[2] = idx[3] = -(1 << 20);
}

// nurbs_own_cols of the warp's staged records, once every lane has written
// its own and before any lane writes its next.
template <typename T>
__device__ __forceinline__ void nurbs_warp_cols(const T* srec,
                                                const int* sidx,
                                                const NuSurf<T>& f, int lane,
                                                T* row, int base) {
  __syncwarp();
  nurbs_own_cols(srec, sidx, f, lane, row, base);
  __syncwarp();
}

// Dynamic shared memory of a nurbs-build backward of ``block`` threads:
// its per-warp rows of ncomp columns (rounded up to 4-vectors, where the
// tables start), the tables of kt knot rows and ns nets of nc columns
// (nurbs_bytes), then each lane's staged record (ops/launch.py:
// nurbs_bwd_bytes).
template <typename T>
size_t nurbs_bwd_bytes(int block, int ncomp, int ns, int nc, int kt) {
  return (size_t)nu_net_stride((block / 32) * ncomp) * sizeof(T) +
         nurbs_bytes<T>(ns, nc, kt) +
         (size_t)block * (2 * NU_PT * sizeof(T) + 4 * sizeof(int));
}

// The nurbs build's forward step (ops/step.py: step_plain with a NURBS
// surface): step_fwd's PLANE and STANDARD branches with the tilts, and a
// NURBS surface's intersection and normal from one parameter solve on its
// net (surface s of the tables ``tb``) with ``niters`` stopped steps. The
// extras (adot_out, kloc) as step_fwd's; ``uv`` takes a NURBS surface's
// stopped point (us, vs) for the backwards' reverse step; with HIT64
// (pol_bwd's forward sweep) its hit is taken in double (nurbs_finish_bwd).
// A function of its own, as step_fwd_grat, so the other builds' step keeps
// its code.
template <typename T, bool FULL, bool HIT64 = false>
__device__ __forceinline__ T step_fwd_nurbs(int code, int refl, int absorbs,
                                            int tilted, const T* p,
                                            const T* rot, const NuTab<T>& tb,
                                            int s, int niters, T n_pre,
                                            T npost, T& x, T& y, T& z, T& L,
                                            T& M, T& N, T& inten, T& opd,
                                            T* adot_out = nullptr,
                                            T* kloc = nullptr,
                                            T* uv = nullptr) {
  const T R = p[P_RADIUS], k = p[P_CONIC], pos = p[P_POS];
  T xl = x - p[P_DX], yl = y - p[P_DY], zl = z - pos;
  if (tilted) rot_local(rot, xl, yl, zl, L, M, N);
  T t, nx = T(0), ny = T(0), nz = T(-1);
  if (code == NURBS) {
    const NuSurf<T> f = nu_surf(tb, s);
    T us, vs;
    nurbs_solve(f, niters, xl, yl, zl, L, M, N, us, vs);
    const NuHit<T> h =
        HIT64 && uv ? nurbs_finish_bwd(f, xl, yl, zl, L, M, N, us, vs)
                    : nurbs_finish(f, xl, yl, zl, L, M, N, us, vs);
    t = h.t;
    nx = h.n[0];
    ny = h.n[1];
    nz = h.n[2];
    if (uv) {
      uv[0] = us;
      uv[1] = vs;
    }
  } else {
    t = code == STANDARD ? dist_standard(R, k, xl, yl, zl, L, M, N)
                         : dist_plane(zl, N);
  }
  T x1 = xl + t * L, y1 = yl + t * M, z1 = zl + t * N;
  if constexpr (FULL) {
    if (absorbs) inten = inten * exp_(T(ABS) * p[P_KPRE] * t * T(1e3));
    opd = opd + abs_(t * n_pre);
    const T ap = p[P_APMAX];
    if (x1 * x1 + y1 * y1 > ap * ap) inten = T(0);
  }
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
  if (kloc) {
    kloc[0] = L;
    kloc[1] = M;
    kloc[2] = N;
  }
  T n_next;
  if (refl) {
    L = L - T(2) * adot * nx;
    M = M - T(2) * adot * ny;
    N = N - T(2) * adot * nz;
    n_next = n_pre;
  } else {
    const T u = n_pre / npost;
    const T w = sqrt_(T(1) - u * u * (T(1) - adot * adot)) - u * adot;
    L = u * L + nx * w;
    M = u * M + ny * w;
    N = u * N + nz * w;
    n_next = npost;
  }
  if (kloc) {
    kloc[3] = L;
    kloc[4] = M;
    kloc[5] = N;
  }
  if (tilted) rot_global(rot, x1, y1, z1, L, M, N);
  x = x1 + p[P_DX];
  y = y1 + p[P_DY];
  z = z1 + pos;
  return n_next;
}

// The nurbs build's reverse step (ops/step.py: step_adjoint_plain with a
// NURBS surface): step_adjoint_kept's PLANE and STANDARD branches with the
// tilts, ``gext`` as there, and a NURBS surface's (surface s of the tables
// ``tb``) intersection and normal taken again from its stopped point
// ``uv`` (the forward sweep's: nurbs_corrected) and reversed through
// nurbs_adjoint, which with the evaluations writes the ray's record (rec,
// idx: nurbs_own_cols). A
// change to step_adjoint_kept's PLANE and STANDARD code is made here too (and
// in step_adjoint_grat).
template <typename T, bool FULL>
__device__ __forceinline__ void step_adjoint_nurbs(
    int code, int refl, int absorbs, int tilted, const T* p, const T* rot,
    const NuTab<T>& tb, int s, const T* uv, T n_pre, T npost, T x, T y, T z,
    T L, T M, T N, T i_in, T* g, T* gc, T* rec, int* idx,
    const T* gext = nullptr) {
  const T R = p[P_RADIUS], k = p[P_CONIC], pos = p[P_POS];
  const T dx = p[P_DX], dy = p[P_DY];
  const bool std_ = code == STANDARD;
  const bool nrb = code == NURBS;
  const T g_nn = g[6];

  // ---- recompute the forward intermediates (in the surface's frame) ----
  T xl = x - dx, yl = y - dy, zl = z - pos;
  if (tilted) rot_local(rot, xl, yl, zl, L, M, N);
  T cu = T(0), A = T(0), a = T(0), Bq = T(0), b = T(0), Cq = T(0), c = T(0);
  T sd = T(0), sg = T(0), q = T(0), t1 = T(0), t2 = T(0), t, Ns = T(1);
  bool use1 = false, a0 = false, q0 = false, big = false;
  NuFwd<T> fw;
  T nx = T(0), ny = T(0), nz = T(-1);
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
  } else if (nrb) {
    nurbs_corrected(nu_surf(tb, s), xl, yl, zl, L, M, N, uv[0], uv[1], fw,
                    rec, idx);
    const NuHit<T> h = nu_hit(fw.e1, xl, yl, zl);
    t = h.t;
    nx = h.n[0];
    ny = h.n[1];
    nz = h.n[2];
  } else {
    big = abs_(N) > T(1e-14);
    Ns = big ? N : T(1e-14);
    t = -zl / Ns;
  }
  const T x1 = xl + t * L, y1 = yl + t * M, z1 = zl + t * N;
  T r2 = T(0), rq = T(0), invd = T(0), fx = T(0), fy = T(0), im = T(1);
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

  // the local post-interaction directions
  T Lo, Mo, No, u = T(0), root = T(1), w = T(0);
  if (refl) {
    Lo = L - T(2) * adot * nxs;
    Mo = M - T(2) * adot * nys;
    No = N - T(2) * adot * nzs;
  } else {
    u = n_pre / npost;
    root = sqrt_(T(1) - u * u * (T(1) - adot * adot));
    w = root - u * adot;
    Lo = u * L + nxs * w;
    Mo = u * M + nys * w;
    No = u * N + nzs * w;
  }

  // ---- globalize: rotate back (tilted), then translate ----
  T go[6] = {g[0], g[1], g[2], g[3], g[4], g[5]};
  T d_r[3] = {T(0), T(0), T(0)};
  if (tilted) rot_global_adjoint(rot, x1, y1, z1, Lo, Mo, No, go, d_r);
  T g_dx = g[0], g_dy = g[1], g_pos = g[2];
  T g_x1 = go[0], g_y1 = go[1], g_z1 = go[2];
  const T gLi = gext ? go[3] + gext[3] : go[3];
  const T gMi = gext ? go[4] + gext[4] : go[4];
  const T gNi = gext ? go[5] + gext[5] : go[5];

  // ---- interact ----
  T gL, gM, gN, g_nxs, g_nys, g_nzs, g_adot, g_npre, g_npost;
  if (refl) {
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
  // ---- normal (STANDARD; the plane normal is constant, a NURBS surface's
  // comes from its solve, which takes its cotangent below) ----
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
  } else if (nrb) {
    const T g_n[3] = {sgn * g_nxs, sgn * g_nys, sgn * g_nzs};
    T g_r0[3] = {T(0), T(0), T(0)}, g_kk[3] = {T(0), T(0), T(0)};
    nurbs_adjoint(fw, xl, yl, zl, L, M, N, g_t, g_n, g_r0, g_kk, rec);
    g_xl += g_r0[0];
    g_yl += g_r0[1];
    g_zl += g_r0[2];
    gL += g_kk[0];
    gM += g_kk[1];
    gN += g_kk[2];
    g_R = T(0);
  } else {
    g_zl -= g_t / Ns;
    if (big) gN += g_t * zl / (Ns * Ns);
    g_R = T(0);
  }

  // ---- tilts: through the rotations (tilted), or at zero, where each
  // rotation's generator acts on the state ----
  T gi[6] = {g_xl, g_yl, g_zl, gL, gM, gN};
  if (tilted) {
    rot_local_adjoint(rot, xl, yl, zl, L, M, N, gi, d_r);
  } else {
    d_r[0] = g_yl * zl - g_zl * yl + gM * N - gN * M - go[1] * z1 +
             go[2] * y1 - go[4] * No + go[5] * Mo;
    d_r[1] = -g_xl * zl + g_zl * xl - gL * N + gN * L + go[0] * z1 -
             go[2] * x1 + go[3] * No - go[5] * Lo;
    d_r[2] = g_xl * yl - g_yl * xl + gL * M - gM * L - go[0] * y1 +
             go[1] * x1 - go[3] * Mo + go[4] * Lo;
  }

  // ---- localize ----
  g_dx -= gi[0];
  g_dy -= gi[1];
  g_pos -= gi[2];
#pragma unroll
  for (int c2 = 0; c2 < 6; ++c2) g[c2] = gi[c2];
  g[6] = g_npre;
  gc[0] = g_R;
  gc[1] = g_k;
  gc[2] = g_pos;
  gc[3] = g_npost;
  gc[4] = g_dx;
  gc[5] = g_dy;
  gc[6] = d_r[0];
  gc[7] = d_r[1];
  gc[8] = d_r[2];
  if constexpr (FULL) {
    g[7] = g_i;  // g[8], the opd cotangent, passes through unchanged
    gc[9] = g_kpre;
  }
}

// The NURBS surfaces' column blocks of a backward's partial row (the
// nurbs build): sidx[s] the index of surface s among them.
__device__ __forceinline__ void fill_nurbs(const int* codes, int S,
                                           int* sidx) {
  int n = 0;
  for (int s = 0; s < S; ++s) {
    sidx[s] = n;
    if (codes[s] == NURBS) ++n;
  }
}

}  // namespace
