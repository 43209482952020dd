// The polarized trace kernels' templates (pol_trace.cu) and their
// launchers, in every build: pol_trace.cu instantiates the stock to
// deep_aux builds, nurbs_pol.cu the nurbs build (launchers with NU), each
// with its own C entries. See pol_trace.cu for what the kernels do and
// what bounds them.

#pragma once

#include "step.cuh"

namespace {

// The polarized backward's steps: step_fwd_pt_ext (the extras written),
// step_adjoint_pt_ext and step_adjoint_kept_ext (the extras' cotangents
// taken), the merit and trace backwards' steps read again with STEP_EXT
#define STEP_EXT 1
#define STEP_NAME(f) f##_ext
#include "step_kept.cuh"
#include "step_pt.cuh"
#undef STEP_EXT
#undef STEP_NAME

// coat kinds (optiland_torch/ops/pol_trace.py holds the same values)
constexpr int K_NONE = 0, K_SIMPLE = 1, K_FRESNEL = 2, K_POLARIZER = 3,
              K_RETARDER = 4, K_TMM = 5;
constexpr int MAX_LAYERS = 15;
constexpr int NCOAT_MAX = 2 + 2 * MAX_LAYERS;
constexpr int NFLAG = 6;  // code, reflect, absorb, coat kind, layers, tilted
constexpr int F_TILT = 5;
constexpr int N_POL = 26;

template <typename P, int K>
struct Ptrs {
  P p[K];
};

// the polarization states of the intensity mode: per state the launch
// field's (s, p) coefficients (ex_re, ex_im, ey_re, ey_im)
template <typename T>
struct States {
  T c[2][4];
  int n;
};

// ---------------------------------------------------------------------------
// Real-pair complex numbers and 3-vectors
// ---------------------------------------------------------------------------

template <typename T>
struct Cx {
  T r, i;
};
template <typename T>
__device__ __forceinline__ Cx<T> cmul(Cx<T> a, Cx<T> b) {
  return {a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r};
}
template <typename T>
__device__ __forceinline__ Cx<T> cjmul(Cx<T> a, Cx<T> b) {  // conj(a) b
  return {a.r * b.r + a.i * b.i, a.r * b.i - a.i * b.r};
}
template <typename T>
__device__ __forceinline__ Cx<T> cdiv(Cx<T> a, Cx<T> b) {
  const T den = b.r * b.r + b.i * b.i;
  return {(a.r * b.r + a.i * b.i) / den, (a.i * b.r - a.r * b.i) / den};
}
template <typename T>
__device__ __forceinline__ Cx<T> cadd(Cx<T> a, Cx<T> b) {
  return {a.r + b.r, a.i + b.i};
}
template <typename T>
__device__ __forceinline__ Cx<T> csub(Cx<T> a, Cx<T> b) {
  return {a.r - b.r, a.i - b.i};
}
template <typename T>
__device__ __forceinline__ Cx<T> cneg(Cx<T> a) {
  return {-a.r, -a.i};
}
// q = a / b: the cotangents g / conj(b) of a and -g conj(q) / conj(b) of b
template <typename T>
__device__ __forceinline__ void div_adjoint(Cx<T> g, Cx<T> b, Cx<T> q,
                                            Cx<T>& ga, Cx<T>& gb) {
  const Cx<T> bc = {b.r, -b.i};
  ga = cdiv(g, bc);
  gb = cneg(cdiv(cmul(g, Cx<T>{q.r, -q.i}), bc));
}

template <typename T>
__device__ __forceinline__ void cross(const T* a, const T* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}
template <typename T>
__device__ __forceinline__ T dot3(const T* a, const T* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
// c += cross(a, b)
template <typename T>
__device__ __forceinline__ void cross_add(const T* a, const T* b, T* c) {
  T t[3];
  cross(a, b, t);
  c[0] += t[0];
  c[1] += t[1];
  c[2] += t[2];
}

// ---------------------------------------------------------------------------
// Local basis (pol_trace._basis, _basis_adjoint)
// ---------------------------------------------------------------------------

// a product rounded on its own: never contracted into a fused multiply-add
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename T>
struct Basis {
  T s[3], p0[3], p1[3], pfb[3];
  T mag;
  bool deg, use2;
};

// k0 x k1 with each product rounded on its own, as the plain version forms
// it: for k1 == k0 (a plane between equal media) it is exactly 0, and the
// degenerate fallback is taken. A fused multiply-add would leave the
// rounding residual of one product (~1e-8 of it in float32), which passes
// the 1e-12 test and gives s an arbitrary direction.
template <typename T>
__device__ __forceinline__ void basis_fwd(const T* k0, const T* k1,
                                          Basis<T>& b) {
  T sr[3] = {mul_rn(k0[1], k1[2]) - mul_rn(k0[2], k1[1]),
             mul_rn(k0[2], k1[0]) - mul_rn(k0[0], k1[2]),
             mul_rn(k0[0], k1[1]) - mul_rn(k0[1], k1[0])};
  b.deg = sqrt_(dot3(sr, sr)) < T(1e-12);
  const T f1y = k0[2], f1z = -k0[1];  // k0 x xhat = (0, k0z, -k0y)
  b.use2 = sqrt_(f1y * f1y + f1z * f1z) < T(1e-12);
  if (b.use2) {  // k0 x yhat
    b.pfb[0] = -k0[2];
    b.pfb[1] = T(0);
    b.pfb[2] = k0[0];
  } else {
    b.pfb[0] = T(0);
    b.pfb[1] = f1y;
    b.pfb[2] = f1z;
  }
  if (b.deg) cross(b.pfb, k0, sr);
  b.mag = sqrt_(dot3(sr, sr));
  for (int c = 0; c < 3; ++c) b.s[c] = sr[c] / b.mag;
  cross(k0, b.s, b.p0);
  cross(k1, b.s, b.p1);
}

// g_k0, g_k1 += the cotangents of k0, k1 for those of (s, p0, p1); g_s is
// modified
template <typename T>
__device__ __forceinline__ void basis_adjoint(const T* k0, const T* k1,
                                              const Basis<T>& b, T* g_s,
                                              const T* g_p0, const T* g_p1,
                                              T* g_k0, T* g_k1) {
  cross_add(b.s, g_p0, g_k0);
  cross_add(b.s, g_p1, g_k1);
  cross_add(g_p0, k0, g_s);
  cross_add(g_p1, k1, g_s);
  const T sg = dot3(b.s, g_s);
  T g_raw[3];
  for (int c = 0; c < 3; ++c) g_raw[c] = (g_s[c] - b.s[c] * sg) / b.mag;
  if (b.deg) {
    T g_pfb[3];
    cross(k0, g_raw, g_pfb);
    cross_add(g_raw, b.pfb, g_k0);
    if (b.use2) {
      g_k0[0] += g_pfb[2];
      g_k0[2] += -g_pfb[0];
    } else {
      g_k0[1] += -g_pfb[2];
      g_k0[2] += g_pfb[1];
    }
  } else {
    cross_add(k1, g_raw, g_k0);
    cross_add(g_raw, k0, g_k1);
  }
}

// ---------------------------------------------------------------------------
// Jones matrices: J = [[j00, j01, 0], [j10, j11, 0], [0, 0, j22]]
// ---------------------------------------------------------------------------

template <typename T>
struct Jones {
  Cx<T> j00, j01, j10, j11, j22;
};

template <typename T>
__device__ __forceinline__ Jones<T> jones_identity() {
  return {{T(1), T(0)}, {T(0), T(0)}, {T(0), T(0)}, {T(1), T(0)},
          {T(1), T(0)}};
}

// Fresnel (pol_trace._fresnel): the complex root of n^2 - sin^2 as a pair
template <typename T>
struct FresnelV {
  T n, nn, rr, ri;
  bool pos;
  Cx<T> A, B, C, D, js, jq;
};

template <typename T>
__device__ __forceinline__ void fresnel_fwd(T n1, T n2, T adot, int refl,
                                            FresnelV<T>& f, Jones<T>& J) {
  f.n = n2 / n1;
  f.nn = f.n * f.n;
  const T arg = f.nn - T(1) + adot * adot;
  f.pos = arg >= T(0);
  f.rr = f.pos ? sqrt_(arg) : T(0);
  f.ri = f.pos ? T(0) : sqrt_(-arg);
  const T c = adot;
  J = jones_identity<T>();
  if (refl) {
    f.A = {c - f.rr, -f.ri};
    f.B = {c + f.rr, f.ri};
    f.C = {f.nn * c - f.rr, -f.ri};
    f.D = {f.nn * c + f.rr, f.ri};
    f.js = cdiv(f.A, f.B);
    f.jq = cdiv(f.C, f.D);
    J.j00 = f.js;
    J.j11 = cneg(f.jq);
    J.j22 = {T(-1), T(0)};
  } else {
    f.B = {c + f.rr, f.ri};
    f.D = {f.nn * c + f.rr, f.ri};
    f.js = cdiv(Cx<T>{T(2) * c, T(0)}, f.B);
    f.jq = cdiv(Cx<T>{T(2) * f.n * c, T(0)}, f.D);
    J.j00 = f.js;
    J.j11 = f.jq;
  }
}

// Thin-film stack by the real-index transfer matrix (pol_trace._tmm)
template <typename T>
__device__ __forceinline__ T cos_in(T n, T u2) {
  return sqrt_(fmax(n * n - u2, T(1e-30))) / n;
}
// (g_n, g_u2) += of cos = sqrt(max(n^2 - u2, tiny)) / n
template <typename T>
__device__ __forceinline__ void cos_in_adjoint(T n, T u2, T g_cos, T& g_n,
                                               T& g_u2) {
  const T arg = n * n - u2;
  const T sq = sqrt_(fmax(arg, T(1e-30)));
  g_n += -g_cos * sq / (n * n);
  const T g_arg = arg >= T(1e-30) ? g_cos / n * T(0.5) / sq : T(0);
  g_n += T(2) * n * g_arg;
  g_u2 -= g_arg;
}

template <typename T>
__device__ __forceinline__ void layer_step(T& Ar, T& Bi, T& Ci, T& Dr, T c,
                                           T sn, T e) {
  const T a = Ar * c - Bi * e * sn, b = Ar * sn / e + Bi * c;
  const T cc = Ci * c + Dr * e * sn, d = -Ci * sn / e + Dr * c;
  Ar = a;
  Bi = b;
  Ci = cc;
  Dr = d;
}

// the accumulators, the denominator and the output of one polarization
template <typename T>
struct TmmPol {
  T eta0, etas, Ar, Bi, Ci, Dr;
  Cx<T> den, num, out;
};

template <typename T>
__device__ __forceinline__ void tmm_pol(const T* cr, int nl, T u2, T cos0,
                                        T coss, bool spol, int refl,
                                        TmmPol<T>& t) {
  const T n0 = cr[0], ns = cr[1];
  t.eta0 = spol ? n0 * cos0 : n0 / cos0;
  t.etas = spol ? ns * coss : ns / coss;
  t.Ar = T(1);
  t.Bi = T(0);
  t.Ci = T(0);
  t.Dr = T(1);
  for (int l = 0; l < nl; ++l) {
    const T nlay = cr[2 + 2 * l], dl = cr[3 + 2 * l];
    const T cosl = cos_in(nlay, u2);
    const T delta = nlay * dl * cosl;
    const T e = spol ? nlay * cosl : nlay / cosl;
    layer_step(t.Ar, t.Bi, t.Ci, t.Dr, cos_(delta), sin_(delta), e);
  }
  t.den = {t.eta0 * t.Ar + t.etas * t.Dr, t.eta0 * t.etas * t.Bi + t.Ci};
  if (refl) {
    t.num = {t.eta0 * t.Ar - t.etas * t.Dr, t.eta0 * t.etas * t.Bi - t.Ci};
    t.out = cdiv(t.num, t.den);
  } else {
    const T mag = t.den.r * t.den.r + t.den.i * t.den.i;
    t.num = {mag, T(0)};
    t.out = {T(2) * t.eta0 * t.den.r / mag, T(2) * t.eta0 * t.den.i / mag};
  }
}

template <typename T>
__device__ __forceinline__ void tmm_fwd(const T* cr, int nl, T adot, int refl,
                                        Jones<T>& J) {
  const T n0 = cr[0];
  const T u2 = (n0 * n0) * (T(1) - adot * adot);
  const T coss = cos_in(cr[1], u2);
  TmmPol<T> ts, tp;
  tmm_pol(cr, nl, u2, adot, coss, true, refl, ts);
  tmm_pol(cr, nl, u2, adot, coss, false, refl, tp);
  J = jones_identity<T>();
  J.j00 = ts.out;
  if (refl) {
    J.j11 = cneg(tp.out);
    J.j22 = {T(-1), T(0)};
  } else {
    J.j11 = tp.out;
  }
}

// gcr[0 .. 2 + 2 nl) += the coat-row cotangents; g_adot += its own. The
// layer products are undone in reverse with each layer's inverse matrix.
template <typename T>
__device__ __forceinline__ void tmm_adjoint(const T* cr, int nl, T adot,
                                            int refl, Cx<T> g_js, Cx<T> g_jp,
                                            T* gcr, T& g_adot) {
  const T n0 = cr[0], ns = cr[1];
  const T u2 = (n0 * n0) * (T(1) - adot * adot);
  const T cos0 = adot;
  const T coss = cos_in(ns, u2);
  T g_u2 = T(0), g_n0 = T(0), g_ns = T(0), g_cos0 = T(0), g_coss = T(0);
  T g_nl[MAX_LAYERS], g_cosl[MAX_LAYERS], g_c[MAX_LAYERS], g_sn[MAX_LAYERS];
  for (int l = 0; l < nl; ++l) {
    g_nl[l] = T(0);
    g_cosl[l] = T(0);
    g_c[l] = T(0);
    g_sn[l] = T(0);
  }
  for (int pi = 0; pi < 2; ++pi) {
    const bool spol = pi == 0;
    TmmPol<T> t;
    tmm_pol(cr, nl, u2, cos0, coss, spol, refl, t);
    const Cx<T> g_out = spol ? g_js : (refl ? cneg(g_jp) : g_jp);
    T g_eta0, g_etas, gA, gB, gC, gD;
    Cx<T> g_den;
    if (refl) {
      Cx<T> g_num;
      div_adjoint(g_out, t.den, t.out, g_num, g_den);
      g_eta0 = g_num.r * t.Ar + g_num.i * t.etas * t.Bi;
      g_etas = -g_num.r * t.Dr + g_num.i * t.eta0 * t.Bi;
      gA = g_num.r * t.eta0;
      gD = -g_num.r * t.etas;
      gB = g_num.i * t.eta0 * t.etas;
      gC = -g_num.i;
    } else {
      const T mag = t.num.r;
      g_eta0 = (g_out.r * T(2) * t.den.r + g_out.i * T(2) * t.den.i) / mag;
      const T g_mag = -(g_out.r * t.out.r + g_out.i * t.out.i) / mag;
      g_den = {g_out.r * T(2) * t.eta0 / mag + T(2) * t.den.r * g_mag,
               g_out.i * T(2) * t.eta0 / mag + T(2) * t.den.i * g_mag};
      g_etas = T(0);
      gA = gB = gC = gD = T(0);
    }
    g_eta0 += g_den.r * t.Ar + g_den.i * t.etas * t.Bi;
    g_etas += g_den.r * t.Dr + g_den.i * t.eta0 * t.Bi;
    gA += g_den.r * t.eta0;
    gD += g_den.r * t.etas;
    gB += g_den.i * t.eta0 * t.etas;
    gC += g_den.i;
    T Ar = t.Ar, Bi = t.Bi, Ci = t.Ci, Dr = t.Dr;
    for (int l = nl - 1; l >= 0; --l) {
      const T nlay = cr[2 + 2 * l], dl = cr[3 + 2 * l];
      const T cosl = cos_in(nlay, u2);
      const T delta = nlay * dl * cosl;
      const T c = cos_(delta), sn = sin_(delta);
      const T e = spol ? nlay * cosl : nlay / cosl;
      layer_step(Ar, Bi, Ci, Dr, c, -sn, e);  // the state before the layer
      g_c[l] += gA * Ar + gB * Bi + gC * Ci + gD * Dr;
      g_sn[l] += -gA * Bi * e + gB * Ar / e + gC * Dr * e - gD * Ci / e;
      const T g_e = -gA * Bi * sn - gB * Ar * sn / (e * e) + gC * Dr * sn
                    + gD * Ci * sn / (e * e);
      const T nA = gA * c + gB * sn / e, nB = -gA * e * sn + gB * c;
      const T nC = gC * c - gD * sn / e, nD = gC * e * sn + gD * c;
      gA = nA;
      gB = nB;
      gC = nC;
      gD = nD;
      if (spol) {
        g_nl[l] += g_e * cosl;
        g_cosl[l] += g_e * nlay;
      } else {
        g_nl[l] += g_e / cosl;
        g_cosl[l] -= g_e * nlay / (cosl * cosl);
      }
    }
    if (spol) {
      g_n0 += g_eta0 * cos0;
      g_cos0 += g_eta0 * n0;
      g_ns += g_etas * coss;
      g_coss += g_etas * ns;
    } else {
      g_n0 += g_eta0 / cos0;
      g_cos0 -= g_eta0 * n0 / (cos0 * cos0);
      g_ns += g_etas / coss;
      g_coss -= g_etas * ns / (coss * coss);
    }
  }
  for (int l = 0; l < nl; ++l) {
    const T nlay = cr[2 + 2 * l], dl = cr[3 + 2 * l];
    const T cosl = cos_in(nlay, u2);
    const T delta = nlay * dl * cosl;
    const T g_delta = -g_c[l] * sin_(delta) + g_sn[l] * cos_(delta);
    T gn = g_nl[l] + g_delta * dl * cosl;
    cos_in_adjoint(nlay, u2, g_cosl[l] + g_delta * nlay * dl, gn, g_u2);
    gcr[2 + 2 * l] += gn;
    gcr[3 + 2 * l] += g_delta * nlay * cosl;
  }
  cos_in_adjoint(ns, u2, g_coss, g_ns, g_u2);
  gcr[0] += g_n0 + T(2) * n0 * (T(1) - adot * adot) * g_u2;
  gcr[1] += g_ns;
  g_adot += g_cos0 - T(2) * adot * (n0 * n0) * g_u2;
}

// Polarizer and retarder (pol_trace._axis_jones): the global axis projected
// on (s, p0) and, for the polarizer's output, (s, p1)
template <typename T>
__device__ __forceinline__ T unit_or_one(T n) {
  return n == T(0) ? T(1) : n;
}

template <typename T>
__device__ __forceinline__ void axis_fwd(int kind, const T* cr,
                                         const Basis<T>& b, Jones<T>& J) {
  J = jones_identity<T>();
  if (kind == K_POLARIZER) {
    const T* a = cr;
    const T ts = dot3(a, b.s), tpi = dot3(a, b.p0), tpo = dot3(a, b.p1);
    const T ni = unit_or_one(sqrt_(ts * ts + tpi * tpi));
    const T no = unit_or_one(sqrt_(ts * ts + tpo * tpo));
    const T usi = ts / ni, upi = tpi / ni, uso = ts / no, upo = tpo / no;
    J.j00 = {uso * usi, T(0)};
    J.j01 = {uso * upi, T(0)};
    J.j10 = {upo * usi, T(0)};
    J.j11 = {upo * upi, T(0)};
    return;
  }
  const T d = cr[0];
  const T* a = cr + 1;
  const T ts = dot3(a, b.s), tp = dot3(a, b.p0);
  const T nrm = unit_or_one(sqrt_(ts * ts + tp * tp));
  const T us = ts / nrm, up = tp / nrm;
  const T cd2 = cos_(d / T(2)), sd2 = sin_(d / T(2));
  const T S2 = us * us + up * up, D2 = up * up - us * us;
  J.j00 = {cd2 * S2, sd2 * D2};
  J.j01 = {T(0), T(-2) * sd2 * us * up};
  J.j10 = J.j01;
  J.j11 = {cd2 * S2, -sd2 * D2};
}

// cotangents (g1, g2) of t for u = t / |t| (a zero norm taken as 1)
template <typename T>
__device__ __forceinline__ void unit_adjoint(T t1, T t2, T nrm, T u1, T u2,
                                             T& g1, T& g2) {
  const bool nz = nrm != T(0);
  const T n1 = nz ? nrm : T(1);
  const T g_n = nz ? -(g1 * u1 + g2 * u2) / n1 : T(0);
  const T a = g1 / n1 + g_n * t1 / n1, b = g2 / n1 + g_n * t2 / n1;
  g1 = a;
  g2 = b;
}

// gcr += the coat-row cotangents; g_s, g_p0, g_p1 += the basis'
template <typename T>
__device__ __forceinline__ void axis_adjoint(int kind, const T* cr,
                                             const Basis<T>& b,
                                             const Jones<T>& gJ, T* gcr,
                                             T* g_s, T* g_p0, T* g_p1) {
  if (kind == K_POLARIZER) {
    const T* a = cr;
    const T ts = dot3(a, b.s), tpi = dot3(a, b.p0), tpo = dot3(a, b.p1);
    const T ni = sqrt_(ts * ts + tpi * tpi), no = sqrt_(ts * ts + tpo * tpo);
    const T ni1 = unit_or_one(ni), no1 = unit_or_one(no);
    const T usi = ts / ni1, upi = tpi / ni1, uso = ts / no1, upo = tpo / no1;
    T g_uso = gJ.j00.r * usi + gJ.j01.r * upi;
    T g_upo = gJ.j10.r * usi + gJ.j11.r * upi;
    T g_usi = gJ.j00.r * uso + gJ.j10.r * upo;
    T g_upi = gJ.j01.r * uso + gJ.j11.r * upo;
    unit_adjoint(ts, tpi, ni, usi, upi, g_usi, g_upi);
    unit_adjoint(ts, tpo, no, uso, upo, g_uso, g_upo);
    const T g_ts = g_usi + g_uso;
    for (int c = 0; c < 3; ++c) {
      gcr[c] += b.s[c] * g_ts + b.p0[c] * g_upi + b.p1[c] * g_upo;
      g_s[c] += a[c] * g_ts;
      g_p0[c] += a[c] * g_upi;
      g_p1[c] += a[c] * g_upo;
    }
    return;
  }
  const T d = cr[0];
  const T* a = cr + 1;
  const T ts = dot3(a, b.s), tp = dot3(a, b.p0);
  const T nrm = sqrt_(ts * ts + tp * tp);
  const T n1 = unit_or_one(nrm);
  const T us = ts / n1, up = tp / n1;
  const T cd2 = cos_(d / T(2)), sd2 = sin_(d / T(2));
  const T S2 = us * us + up * up, D2 = up * up - us * us;
  const T g_cd2 = (gJ.j00.r + gJ.j11.r) * S2;
  const T g_S2 = (gJ.j00.r + gJ.j11.r) * cd2;
  const T g_D2 = (gJ.j00.i - gJ.j11.i) * sd2;
  const T g_x = gJ.j01.i + gJ.j10.i;
  const T g_sd2 = (gJ.j00.i - gJ.j11.i) * D2 - T(2) * g_x * us * up;
  const T g_usup = T(-2) * sd2 * g_x;
  T g_us = T(2) * us * (g_S2 - g_D2) + g_usup * up;
  T g_up = T(2) * up * (g_S2 + g_D2) + g_usup * us;
  gcr[0] += T(0.5) * (-g_cd2 * sd2 + g_sd2 * cd2);
  unit_adjoint(ts, tp, nrm, us, up, g_us, g_up);
  for (int c = 0; c < 3; ++c) {
    gcr[1 + c] += b.s[c] * g_us + b.p0[c] * g_up;
    g_s[c] += a[c] * g_us;
    g_p0[c] += a[c] * g_up;
  }
}

template <typename T>
__device__ __forceinline__ void jones_fwd(int kind, const T* cr, int nl,
                                          T adot, int refl, const Basis<T>& b,
                                          Jones<T>& J) {
  if (kind == K_FRESNEL) {
    FresnelV<T> f;
    fresnel_fwd(cr[0], cr[1], adot, refl, f, J);
  } else if (kind == K_TMM) {
    tmm_fwd(cr, nl, adot, refl, J);
  } else if (kind == K_POLARIZER || kind == K_RETARDER) {
    axis_fwd(kind, cr, b, J);
  } else {
    J = jones_identity<T>();
  }
}

// ---------------------------------------------------------------------------
// The p update: p <- O_out J O_in p, O_in rows (s, p0, k0), O_out columns
// (s, p1, k1); p as 9 real and 9 imaginary parts, row-major
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void rows_of(const Basis<T>& b, const T* k0,
                                        const T* k1, T (*Bin)[3],
                                        T (*Bout)[3]) {
  for (int c = 0; c < 3; ++c) {
    Bin[0][c] = b.s[c];
    Bin[1][c] = b.p0[c];
    Bin[2][c] = k0[c];
    Bout[0][c] = b.s[c];
    Bout[1][c] = b.p1[c];
    Bout[2][c] = k1[c];
  }
}

// q = Bin p, r = J q
template <typename T>
__device__ __forceinline__ void update_qr(T (*Bin)[3], const T* pr,
                                          const T* pim, const Jones<T>& J,
                                          Cx<T> (*q)[3], Cx<T> (*r)[3]) {
  for (int bb = 0; bb < 3; ++bb)
    for (int l = 0; l < 3; ++l) {
      T a = T(0), c = T(0);
      for (int k = 0; k < 3; ++k) {
        a += Bin[bb][k] * pr[k * 3 + l];
        c += Bin[bb][k] * pim[k * 3 + l];
      }
      q[bb][l] = {a, c};
    }
  for (int l = 0; l < 3; ++l) {
    r[0][l] = cadd(cmul(J.j00, q[0][l]), cmul(J.j01, q[1][l]));
    r[1][l] = cadd(cmul(J.j10, q[0][l]), cmul(J.j11, q[1][l]));
    r[2][l] = cmul(J.j22, q[2][l]);
  }
}

template <typename T>
__device__ __forceinline__ void update_fwd(T* pr, T* pim, const Basis<T>& b,
                                           const T* k0, const T* k1,
                                           const Jones<T>& J) {
  T Bin[3][3], Bout[3][3];
  rows_of(b, k0, k1, Bin, Bout);
  Cx<T> q[3][3], r[3][3];
  update_qr(Bin, pr, pim, J, q, r);
  for (int i = 0; i < 3; ++i)
    for (int l = 0; l < 3; ++l) {
      T a = T(0), c = T(0);
      for (int aa = 0; aa < 3; ++aa) {
        a += Bout[aa][i] * r[aa][l].r;
        c += Bout[aa][i] * r[aa][l].i;
      }
      pr[i * 3 + l] = a;
      pim[i * 3 + l] = c;
    }
}

// ---------------------------------------------------------------------------
// Exit intensity (pol_trace._exit_intensity)
// ---------------------------------------------------------------------------

// launch-space (s, p): p = k x xhat normalized (kept where it vanishes),
// s = p x k; returns |k x xhat|
template <typename T>
__device__ __forceinline__ T launch_basis(const T* k, T* sl, T* pl) {
  const T pr[3] = {T(0), k[2], -k[1]};
  const T nrm = sqrt_(pr[0] * pr[0] + pr[1] * pr[1] + pr[2] * pr[2]);
  const T n1 = nrm == T(0) ? T(1) : nrm;
  for (int c = 0; c < 3; ++c) pl[c] = pr[c] / n1;
  cross(pl, k, sl);
  return nrm;
}

template <typename T>
__device__ __forceinline__ void exit_field(const T* pr, const T* pim,
                                           const T* sl, const T* pl,
                                           const T* cs, T* er, T* ei, T* Er,
                                           T* Ei) {
  for (int c = 0; c < 3; ++c) {
    er[c] = cs[0] * sl[c] + cs[2] * pl[c];
    ei[c] = cs[1] * sl[c] + cs[3] * pl[c];
  }
  for (int row = 0; row < 3; ++row) {
    T a = T(0), b = T(0);
    for (int col = 0; col < 3; ++col) {
      a += pr[row * 3 + col] * er[col] - pim[row * 3 + col] * ei[col];
      b += pr[row * 3 + col] * ei[col] + pim[row * 3 + col] * er[col];
    }
    Er[row] = a;
    Ei[row] = b;
  }
}

template <typename T>
__device__ __forceinline__ T exit_intensity(const T* pr, const T* pim,
                                            const T* k, T i0,
                                            const States<T>& st) {
  T sl[3], pl[3];
  launch_basis(k, sl, pl);
  T total = T(0);
  for (int m = 0; m < st.n; ++m) {
    T er[3], ei[3], Er[3], Ei[3];
    exit_field(pr, pim, sl, pl, st.c[m], er, ei, Er, Ei);
    for (int row = 0; row < 3; ++row)
      total += Er[row] * Er[row] + Ei[row] * Ei[row];
  }
  return total * i0 / T(st.n);
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// Copy the coat table, then (with the sync) the param table, the tilts'
// cosines and sines and the flags, into shared memory.
template <typename T>
__device__ __forceinline__ void load_pol_tables(const T* params,
                                                const T* coat,
                                                const int* flags, int S,
                                                int ncoat, T* sp, T* sc,
                                                int* sf, T* sr) {
  for (int i = threadIdx.x; i < S * ncoat; i += blockDim.x) sc[i] = coat[i];
  load_tables<T, NFLAG, false>(params, nullptr, flags, S, sp, nullptr, sf,
                               sr);
}

// One surface's interaction with p (forward): the simple factor on the
// intensity, then the Jones update.
template <typename T>
__device__ __forceinline__ void pol_surface_fwd(const T* sc, const int* sf,
                                                int S, int ncoat, int s,
                                                const T* k0, const T* k1,
                                                T adot, T& inten, T* pr,
                                                T* pim) {
  const int refl = sf[S + s], kind = sf[3 * S + s];
  const T* cr = sc + s * ncoat;
  if (kind == K_SIMPLE) inten *= cr[refl ? 1 : 0];
  Basis<T> b;
  basis_fwd(k0, k1, b);
  Jones<T> J;
  jones_fwd(kind, cr, sf[4 * S + s], adot, refl, b, J);
  update_fwd(pr, pim, b, k0, k1, J);
}

// Forward: trace each ray through surfaces 1 .. S-1 with its p; write the
// 8 ray arrays and p's 18 parts, or (INTENSITY) the 8 ray arrays with the
// exit intensity of the launch intensity and directions.
template <typename T, bool INTENSITY, int B>
__global__ void __launch_bounds__(FWD_BLOCK, fwd_min_blocks<B>(sizeof(T)))
pol_fwd_kernel(const T* __restrict__ params, const T* __restrict__ coat,
               const int* __restrict__ flags, int S, int ncoat,
               const T* __restrict__ cf, int nc, int niters,
               Ptrs<const T*, 8> in, int64_t R, Ptrs<T*, N_POL> out,
               States<T> st) {
  using Bd = Build<B>;
  constexpr int CAP = Bd::CAP;
  __shared__ T sp[CAP * NUM_P];
  __shared__ T sr[CAP * N_ROT];
  __shared__ T sc[CAP * NCOAT_MAX];
  __shared__ T scf[Bd::SAG ? CAP * NC_MAX : 1];
  __shared__ int sf[NFLAG * CAP];
  load_coefs<T, Bd::SAG>(cf, S, nc, scf);
  // the homogeneous nets and knot rows of the NURBS surfaces (NURBS)
  if constexpr (Bd::NURBS) nurbs_tables(cf, S, nc, dyn_base<T>());
  // the layout rows of the aux-bearing surfaces follow the table (AUX)
  const T* lay = Bd::AUX ? cf + (int64_t)S * nc : nullptr;
  load_pol_tables(params, coat, flags, S, ncoat, sp, sc, sf, sr);
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= R) return;
  T v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = in.p[k][i];
  const T k_launch[3] = {v[3], v[4], v[5]};
  const T i0 = v[6];
  T pr[9], pim[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    pr[j] = (j % 4 == 0) ? T(1) : T(0);
    pim[j] = T(0);
  }
  T n = sp[P_NPOST];
  for (int s = 1; s < S; ++s) {
    T adot, kl[6];  // the local pre- (k0) and post-interaction (k1) directions
    if constexpr (Bd::NURBS)
      n = step_fwd_nurbs<T, true>(
          sf[s], sf[S + s], sf[2 * S + s], sf[F_TILT * S + s],
          sp + s * NUM_P, sr + s * N_ROT, NuTab<T>{dyn_base<T>(), cf, S, nc},
          s, niters, n, sp[s * NUM_P + P_NPOST], v[0], v[1], v[2], v[3],
          v[4], v[5], v[6], v[7], &adot, kl);
    else
    n = step_fwd<T, true, Bd::TILT, Bd::SAG, Bd::FREE, Bd::DEEP, Bd::AUX>(
        sf[s], sf[S + s], sf[2 * S + s], sf[F_TILT * S + s], sp + s * NUM_P,
        sr + s * N_ROT, scf + s * nc, lay_of(lay, s, nc), nc, niters, n,
        sp[s * NUM_P + P_NPOST],
        v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], &adot, kl);
    pol_surface_fwd(sc, sf, S, ncoat, s, kl, kl + 3, adot, v[6], pr, pim);
  }
  if constexpr (INTENSITY) {
    v[6] = exit_intensity(pr, pim, k_launch, i0, st);
#pragma unroll
    for (int k = 0; k < 8; ++k) out.p[k][i] = v[k];
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) out.p[k][i] = v[k];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      out.p[8 + j][i] = pr[j];
      out.p[17 + j][i] = pim[j];
    }
  }
}

// The backward's update, one column at a time: p <- O_out J O_in p acts
// on each column of p alone, so the full mode updates p's three columns
// and the intensity mode each launch state's field e_m = p E0_m in place
// of p (6 reals each where p has 18; the exit intensity reads p only
// through them: the same function summed in another order, whose plain
// twin is pol_trace.py's ``fields`` form). Per column the arithmetic of
// update_qr, update_fwd and update_adjoint.

// q = Bin e, r = J q
template <typename T>
__device__ __forceinline__ void vec_qr(T (*Bin)[3], const T* er,
                                       const T* ei, const Jones<T>& J,
                                       Cx<T>* q, Cx<T>* r) {
  for (int b = 0; b < 3; ++b) {
    T a = T(0), c = T(0);
    for (int k = 0; k < 3; ++k) {
      a += Bin[b][k] * er[k];
      c += Bin[b][k] * ei[k];
    }
    q[b] = {a, c};
  }
  r[0] = cadd(cmul(J.j00, q[0]), cmul(J.j01, q[1]));
  r[1] = cadd(cmul(J.j10, q[0]), cmul(J.j11, q[1]));
  r[2] = cmul(J.j22, q[2]);
}

template <typename T>
__device__ __forceinline__ void vec_update(T (*Bin)[3], T (*Bout)[3],
                                           const Jones<T>& J, T* er, T* ei) {
  Cx<T> q[3], r[3];
  vec_qr(Bin, er, ei, J, q, r);
  for (int i = 0; i < 3; ++i) {
    T a = T(0), c = T(0);
    for (int aa = 0; aa < 3; ++aa) {
      a += Bout[aa][i] * r[aa].r;
      c += Bout[aa][i] * r[aa].i;
    }
    er[i] = a;
    ei[i] = c;
  }
}

// From (Ger, Gei), the cotangent of the column after the update, that of
// the column (er, ei) before it; gJ, gBin, gBout += their cotangents.
template <typename T>
__device__ __forceinline__ void vec_update_adjoint(
    T (*Bin)[3], T (*Bout)[3], const Jones<T>& J, const T* er, const T* ei,
    T* Ger, T* Gei, Jones<T>& gJ, T (*gBin)[3], T (*gBout)[3]) {
  Cx<T> q[3], r[3];
  vec_qr(Bin, er, ei, J, q, r);
  Cx<T> gr[3];
  for (int aa = 0; aa < 3; ++aa) {
    T a = T(0), c = T(0);
    for (int i = 0; i < 3; ++i) {
      a += Bout[aa][i] * Ger[i];
      c += Bout[aa][i] * Gei[i];
    }
    gr[aa] = {a, c};
  }
  for (int aa = 0; aa < 3; ++aa)
    for (int i = 0; i < 3; ++i)
      gBout[aa][i] += r[aa].r * Ger[i] + r[aa].i * Gei[i];
  Cx<T> gq[3];
  gq[0] = cadd(cjmul(J.j00, gr[0]), cjmul(J.j10, gr[1]));
  gq[1] = cadd(cjmul(J.j01, gr[0]), cjmul(J.j11, gr[1]));
  gq[2] = cjmul(J.j22, gr[2]);
  gJ.j00 = cadd(gJ.j00, cjmul(q[0], gr[0]));
  gJ.j01 = cadd(gJ.j01, cjmul(q[1], gr[0]));
  gJ.j10 = cadd(gJ.j10, cjmul(q[0], gr[1]));
  gJ.j11 = cadd(gJ.j11, cjmul(q[1], gr[1]));
  gJ.j22 = cadd(gJ.j22, cjmul(q[2], gr[2]));
  for (int b = 0; b < 3; ++b)
    for (int k = 0; k < 3; ++k)
      gBin[b][k] += gq[b].r * er[k] + gq[b].i * ei[k];
  for (int k = 0; k < 3; ++k) {
    T a = T(0), c = T(0);
    for (int b = 0; b < 3; ++b) {
      a += Bin[b][k] * gq[b].r;
      c += Bin[b][k] * gq[b].i;
    }
    Ger[k] = a;
    Gei[k] = c;
  }
}

// Column m of the polarization ``pol``: p's column m (18 reals, row-major,
// real parts first) or VEC field m (6 reals each); get and set.
template <bool VEC, typename T>
__device__ __forceinline__ void col_get(const T* pol, int m, T* er, T* ei) {
  for (int k = 0; k < 3; ++k) {
    er[k] = VEC ? pol[6 * m + k] : pol[3 * k + m];
    ei[k] = VEC ? pol[6 * m + 3 + k] : pol[9 + 3 * k + m];
  }
}
template <bool VEC, typename T>
__device__ __forceinline__ void col_set(T* pol, int m, const T* er,
                                        const T* ei) {
  for (int k = 0; k < 3; ++k) {
    (VEC ? pol[6 * m + k] : pol[3 * k + m]) = er[k];
    (VEC ? pol[6 * m + 3 + k] : pol[9 + 3 * k + m]) = ei[k];
  }
}

// The backward's Fresnel coefficients: fresnel_fwd's, with one reciprocal
// of each denominator (|B|^2, |D|^2 and n1) where the coefficients and
// their adjoint divide by it several times (a rounding apart), or (DIV)
// with fresnel_fwd's own divides: the nurbs build's, whose phase 28 check
// holds it within 1e-3 of the plain version's f32 rounding near a nearly
// degenerate basis (PERF.md §6). The backward forms a Fresnel surface's
// coefficients in its forward sweep and again in reverse.
template <typename T>
struct FresnelR {
  T n, nn, rr, ri, in1, iB, iD;
  bool pos;
  Cx<T> B, D, js, jq;
};

// a / b by the reciprocal ib of |b|^2, or (DIV) by cdiv
template <bool DIV, typename T>
__device__ __forceinline__ Cx<T> cdiv_r(Cx<T> a, Cx<T> b, T ib) {
  if constexpr (DIV) return cdiv(a, b);
  return {(a.r * b.r + a.i * b.i) * ib, (a.i * b.r - a.r * b.i) * ib};
}

template <bool DIV, typename T>
__device__ __forceinline__ void fresnel_fwd_r(T n1, T n2, T adot, int refl,
                                              FresnelR<T>& f, Jones<T>& J) {
  f.in1 = DIV ? T(0) : T(1) / n1;
  f.n = DIV ? n2 / n1 : n2 * f.in1;
  f.nn = f.n * f.n;
  const T arg = f.nn - T(1) + adot * adot;
  f.pos = arg >= T(0);
  f.rr = f.pos ? sqrt_(arg) : T(0);
  f.ri = f.pos ? T(0) : sqrt_(-arg);
  const T c = adot;
  J = jones_identity<T>();
  f.B = {c + f.rr, f.ri};
  f.D = {f.nn * c + f.rr, f.ri};
  f.iB = DIV ? T(0) : T(1) / (f.B.r * f.B.r + f.B.i * f.B.i);
  f.iD = DIV ? T(0) : T(1) / (f.D.r * f.D.r + f.D.i * f.D.i);
  if (refl) {
    f.js = cdiv_r<DIV>(Cx<T>{c - f.rr, -f.ri}, f.B, f.iB);
    f.jq = cdiv_r<DIV>(Cx<T>{f.nn * c - f.rr, -f.ri}, f.D, f.iD);
    J.j00 = f.js;
    J.j11 = cneg(f.jq);
    J.j22 = {T(-1), T(0)};
  } else {
    f.js = cdiv_r<DIV>(Cx<T>{T(2) * c, T(0)}, f.B, f.iB);
    f.jq = cdiv_r<DIV>(Cx<T>{T(2) * f.n * c, T(0)}, f.D, f.iD);
    J.j00 = f.js;
    J.j11 = f.jq;
  }
}

// q = a / b: the cotangents g / conj(b) of a and -g conj(q) / conj(b) of b
// (div_adjoint; with the reciprocal ib of |b|^2 unless DIV)
template <bool DIV, typename T>
__device__ __forceinline__ void div_adjoint_r(Cx<T> g, Cx<T> b, T ib, Cx<T> q,
                                              Cx<T>& ga, Cx<T>& gb) {
  const Cx<T> bc = {b.r, -b.i};
  ga = cdiv_r<DIV>(g, bc, ib);
  gb = cneg(cdiv_r<DIV>(cmul(g, Cx<T>{q.r, -q.i}), bc, ib));
}

template <bool DIV, typename T>
__device__ __forceinline__ void fresnel_adjoint_r(T n1, T n2, T adot,
                                                  int refl,
                                                  const FresnelR<T>& f,
                                                  Cx<T> g_js, Cx<T> g_jp,
                                                  T& g_n1, T& g_n2,
                                                  T& g_adot) {
  const T c = adot;
  T g_c, g_nn, g_n = T(0);
  Cx<T> g_root;
  if (refl) {
    Cx<T> gA, gB, gC, gD;
    div_adjoint_r<DIV>(g_js, f.B, f.iB, f.js, gA, gB);
    div_adjoint_r<DIV>(cneg(g_jp), f.D, f.iD, f.jq, gC, gD);
    g_c = gA.r + gB.r + f.nn * (gC.r + gD.r);
    g_nn = c * (gC.r + gD.r);
    g_root = cadd(csub(gB, gA), csub(gD, gC));
  } else {
    Cx<T> gnum, gB, gnum2, gD;
    div_adjoint_r<DIV>(g_js, f.B, f.iB, f.js, gnum, gB);
    div_adjoint_r<DIV>(g_jp, f.D, f.iD, f.jq, gnum2, gD);
    g_c = T(2) * gnum.r + gB.r + T(2) * f.n * gnum2.r + f.nn * gD.r;
    g_n = T(2) * c * gnum2.r;
    g_nn = c * gD.r;
    g_root = cadd(gB, gD);
  }
  const T g_arg = f.pos ? g_root.r * T(0.5) / f.rr
                        : -g_root.i * T(0.5) / f.ri;
  g_nn += g_arg;
  g_adot = g_c + T(2) * adot * g_arg;
  g_n += T(2) * f.n * g_nn;
  g_n1 = DIV ? -g_n * n2 / (n1 * n1) : -g_n * n2 * f.in1 * f.in1;
  g_n2 = DIV ? g_n / n1 : g_n * f.in1;
}

// The launch fields E0_m of the states (exit_field's er, ei): state m's
// (re, im) at e[6 m], e[6 m + 3]
template <typename T>
__device__ __forceinline__ void launch_fields(const T* k, const States<T>& st,
                                              T* e) {
  T sl[3], pl[3];
  launch_basis(k, sl, pl);
  for (int m = 0; m < 2; ++m)
    if (m < st.n)
      for (int c = 0; c < 3; ++c) {
        e[6 * m + c] = st.c[m][0] * sl[c] + st.c[m][2] * pl[c];
        e[6 * m + 3 + c] = st.c[m][1] * sl[c] + st.c[m][3] * pl[c];
      }
}

// g_k = the launch directions' cotangent for (g_sl, g_pl), those of the
// launch basis (s, p) of launch_basis(k) (nrm: its |k x xhat|); g_pl is
// modified
template <typename T>
__device__ __forceinline__ void launch_basis_adjoint(const T* k, const T* pl,
                                                     T nrm, const T* g_sl,
                                                     T* g_pl, T* g_k) {
  // s = pl x k
  cross(g_sl, pl, g_k);
  cross_add(k, g_sl, g_pl);
  // pl = (0, N, -M) / |.| (a zero norm taken as 1)
  T g_pr[3];
  if (nrm != T(0)) {
    const T proj = dot3(pl, g_pl);
    for (int c = 0; c < 3; ++c) g_pr[c] = (g_pl[c] - pl[c] * proj) / nrm;
  } else {
    for (int c = 0; c < 3; ++c) g_pr[c] = g_pl[c];
  }
  g_k[1] -= g_pr[2];
  g_k[2] += g_pr[1];
}

// g_k: the launch directions' cotangent for Ge, that of the launch fields
// (the vector form's)
template <typename T>
__device__ __forceinline__ void launch_fields_adjoint(const T* k,
                                                      const States<T>& st,
                                                      const T* Ge, T* g_k) {
  T sl[3], pl[3];
  const T nrm = launch_basis(k, sl, pl);
  T g_sl[3] = {T(0), T(0), T(0)}, g_pl[3] = {T(0), T(0), T(0)};
  for (int m = 0; m < 2; ++m)
    if (m < st.n) {
      const T* cs = st.c[m];
      for (int c = 0; c < 3; ++c) {
        g_sl[c] += cs[0] * Ge[6 * m + c] + cs[1] * Ge[6 * m + 3 + c];
        g_pl[c] += cs[2] * Ge[6 * m + c] + cs[3] * Ge[6 * m + 3 + c];
      }
    }
  launch_basis_adjoint(k, pl, nrm, g_sl, g_pl, g_k);
}

// Gr, Gi: the cotangent of p; g_k: of the launch directions; g_i0: of the
// launch intensity, for the cotangent g_out of the exit intensity (the
// matrix form's: the nurbs build's intensity mode)
template <typename T>
__device__ __forceinline__ void exit_intensity_adjoint(
    const T* pr, const T* pim, const T* k, T i0, const States<T>& st,
    T g_out, T* Gr, T* Gi, T* g_k, T& g_i0) {
  T sl[3], pl[3];
  const T nrm = launch_basis(k, sl, pl);
  T total = T(0);
  for (int m = 0; m < st.n; ++m) {
    T er[3], ei[3], Er[3], Ei[3];
    exit_field(pr, pim, sl, pl, st.c[m], er, ei, Er, Ei);
    for (int row = 0; row < 3; ++row)
      total += Er[row] * Er[row] + Ei[row] * Ei[row];
  }
  const T n = T(st.n);
  const T g_tot = g_out * i0 / n;
  g_i0 = g_out * total / n;
  for (int j = 0; j < 9; ++j) Gr[j] = Gi[j] = T(0);
  T g_sl[3] = {T(0), T(0), T(0)}, g_pl[3] = {T(0), T(0), T(0)};
  for (int m = 0; m < st.n; ++m) {
    const T* cs = st.c[m];
    T er[3], ei[3], Er[3], Ei[3];
    exit_field(pr, pim, sl, pl, cs, er, ei, Er, Ei);
    T gEr[3], gEi[3];
    for (int row = 0; row < 3; ++row) {
      gEr[row] = T(2) * g_tot * Er[row];
      gEi[row] = T(2) * g_tot * Ei[row];
    }
    for (int row = 0; row < 3; ++row)
      for (int col = 0; col < 3; ++col) {
        Gr[row * 3 + col] += gEr[row] * er[col] + gEi[row] * ei[col];
        Gi[row * 3 + col] += gEi[row] * er[col] - gEr[row] * ei[col];
      }
    for (int col = 0; col < 3; ++col) {
      T ger = T(0), gei = T(0);
      for (int row = 0; row < 3; ++row) {
        ger += pr[row * 3 + col] * gEr[row] + pim[row * 3 + col] * gEi[row];
        gei += pr[row * 3 + col] * gEi[row] - pim[row * 3 + col] * gEr[row];
      }
      g_sl[col] += cs[0] * ger + cs[1] * gei;
      g_pl[col] += cs[2] * ger + cs[3] * gei;
    }
  }
  launch_basis_adjoint(k, pl, nrm, g_sl, g_pl, g_k);
}

// One surface's polarization update in the backward's forward sweep: p's
// three columns (``pol``'s 18 reals), or VEC the nst fields (6 reals
// each); a Fresnel surface's J by fresnel_fwd_r<DIV>
template <typename T, bool VEC, bool DIV>
__device__ __forceinline__ void pol_update_fwd(int kind, const T* cr, int nl,
                                               int refl, const T* k0,
                                               const T* k1, T adot, T* pol,
                                               int nst) {
  Basis<T> b;
  basis_fwd(k0, k1, b);
  Jones<T> J;
  FresnelR<T> f;
  if (kind == K_FRESNEL)
    fresnel_fwd_r<DIV>(cr[0], cr[1], adot, refl, f, J);
  else
    jones_fwd(kind, cr, nl, adot, refl, b, J);
  T Bin[3][3], Bout[3][3];
  rows_of(b, k0, k1, Bin, Bout);
  for (int m = 0; m < (VEC ? 2 : 3); ++m)
    if (!VEC || m < nst) {
      T er[3], ei[3];
      col_get<VEC>(pol, m, er, ei);
      vec_update(Bin, Bout, J, er, ei);
      col_set<VEC>(pol, m, er, ei);
    }
}

// The reverse of one surface's polarization update from its local
// directions k0, k1 and adot and the polarization before it, ``pb``: G,
// the cotangent of the polarization after the surface (in ``pol``'s
// layout), becomes that before it; gco += the coat row's cotangents; gext
// = those of (k0, k1, adot), for the step's reverse. A Fresnel surface
// forms its coefficients once, for J and its adjoint.
template <typename T, bool VEC, bool DIV>
__device__ __forceinline__ void pol_update_adjoint(int kind, const T* cr,
                                                   int nl, int refl,
                                                   const T* k0, const T* k1,
                                                   T adot, const T* pb,
                                                   int nst, T* G, T* gco,
                                                   T* gext) {
  Basis<T> b;
  basis_fwd(k0, k1, b);
  Jones<T> J;
  FresnelR<T> f;
  if (kind == K_FRESNEL)
    fresnel_fwd_r<DIV>(cr[0], cr[1], adot, refl, f, J);
  else
    jones_fwd(kind, cr, nl, adot, refl, b, J);
  T Bin[3][3], Bout[3][3], gBin[3][3], gBout[3][3];
  rows_of(b, k0, k1, Bin, Bout);
  const Cx<T> z = {T(0), T(0)};
  Jones<T> gJ = {z, z, z, z, z};
  for (int a = 0; a < 3; ++a)
    for (int c = 0; c < 3; ++c) gBin[a][c] = gBout[a][c] = T(0);
  for (int m = 0; m < (VEC ? 2 : 3); ++m)
    if (!VEC || m < nst) {
      T er[3], ei[3], Ger[3], Gei[3];
      col_get<VEC>(pb, m, er, ei);
      col_get<VEC>(G, m, Ger, Gei);
      vec_update_adjoint(Bin, Bout, J, er, ei, Ger, Gei, gJ, gBin, gBout);
      col_set<VEC>(G, m, Ger, Gei);
    }
  T g_s[3], g_p0[3], g_p1[3];
  for (int c = 0; c < 3; ++c) {
    g_s[c] = gBin[0][c] + gBout[0][c];
    g_p0[c] = gBin[1][c];
    g_p1[c] = gBout[1][c];
    gext[c] = gBin[2][c];
    gext[3 + c] = gBout[2][c];
  }
  gext[6] = T(0);
  if (kind == K_FRESNEL) {
    T gn1, gn2, ga;
    fresnel_adjoint_r<DIV>(cr[0], cr[1], adot, refl, f, gJ.j00, gJ.j11, gn1,
                           gn2, ga);
    gco[0] += gn1;
    gco[1] += gn2;
    gext[6] += ga;
  } else if (kind == K_TMM) {
    tmm_adjoint(cr, nl, adot, refl, gJ.j00, gJ.j11, gco, gext[6]);
  } else if (kind == K_POLARIZER || kind == K_RETARDER) {
    axis_adjoint(kind, cr, b, gJ, gco, g_s, g_p0, g_p1);
  }
  basis_adjoint(k0, k1, b, g_s, g_p0, g_p1, gext, gext + 3);
}

// A surface's N_GF slots and ncoat coat columns, summed over the warp by
// the butterfly (warp_cols_steps): the slots and the first 16 - N_GF coat
// columns in one pass of 16 values, the others 16 at a time; one
// shared-memory add per column, into the warp's row at ``slots`` and
// ``coats``.
template <typename T>
__device__ __forceinline__ void pol_cols_add(const T* gc, const T* gco,
                                             int ncoat, int lane, T* slots,
                                             T* coats) {
  constexpr int NF = 16 - N_GF;  // the coat columns of the first pass
  T v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i)
    v[i] = i < N_GF ? gc[i] : (i - N_GF < ncoat ? gco[i - N_GF] : T(0));
  warp_cols_steps<8>(v, lane);
  const int c = lane >> 1;  // lane 2 c ends with column c's sum
  if ((lane & 1) == 0) {
    if (c < N_GF)
      slots[c] += v[0];
    else if (c - N_GF < ncoat)
      coats[c - N_GF] += v[0];
  }
  for (int g0 = NF; g0 < ncoat; g0 += 16) {
    T w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = g0 + i < ncoat ? gco[g0 + i] : T(0);
    warp_cols_add<T, 16>(w, ncoat - g0, lane, coats + g0);
  }
}

// Backward: retrace each ray keeping, per surface, its input state, adot,
// what its step's reverse would compute again (the stock and tilt builds:
// step_fwd_pt's roots and distance; the Newton builds: step_fwd's KEEP
// record; nurbs: the stopped (u, v)), the intensity before the coating and
// the polarization before the surface (p, or INTENSITY the launch states'
// fields: the vector form, VEC, in every build but nurbs), then run the
// reverse sweep seeded with its output cotangents: per surface the
// polarization's reverse, from the local directions (the kept states,
// rotated into a tilted surface's frame) and adot, then the step's reverse
// with the cotangents of those extras (step_adjoint_pt_ext,
// step_adjoint_kept_ext, step_adjoint_nurbs).
// One partial row per block over a grid-stride loop of ray chunks (one
// wave of blocks: ops/launch.py, bwd_grid), compact layout: [s * N_GF
// + j] for surface s and parameter slot j, then (SAG) ncb coefficient
// columns for each of the nsag Newton surfaces (NURBS: nc net columns for
// each NURBS surface), then [.. + s * ncoat + c] for its coat column c;
// each warp sums a surface's slots and coat columns by the butterfly
// (pol_cols_add), the Newton columns staged (warp_cols_staged). The 8
// per-ray input cotangents are written too. The sag, deep and nurbs builds
// keep their per-warp rows in dynamic shared memory.
template <typename T, bool INTENSITY, int B>
__global__ void __launch_bounds__(BWD_BLOCK)
pol_bwd_kernel(const T* __restrict__ params, const T* __restrict__ coat,
               const int* __restrict__ flags, int S, int ncoat,
               const T* __restrict__ cf, int nc, int niters, int nsag,
               Ptrs<const T*, 8> in, Ptrs<const T*, N_POL> cot, int64_t R,
               Ptrs<T*, 8> din, T* __restrict__ partial, States<T> stt) {
  using Bd = Build<B>;
  constexpr int CAP = Bd::CAP;
  constexpr int NW_MAX = BWD_BLOCK / 32;
  constexpr int NCOMP_MAX =
      CAP * (N_GF + NCOAT_MAX) + (Bd::SAG ? CAP * NC_MAX : 0);
  // the stock and tilt builds' step: step_fwd_pt, step_adjoint_pt
  constexpr bool PTS = Bd::PT;
  // the intensity mode's vector form: the launch states' fields in place
  // of p (VEC), but in the nurbs build, which keeps p and Fresnel's
  // divides (DIV: fresnel_fwd_r)
  constexpr bool VEC = INTENSITY && !Bd::NURBS;
  constexpr bool DIV = Bd::NURBS;
  // the polarization per surface: p's 18 reals, or the fields' 6 each
  constexpr int NPOL = VEC ? 12 : 18;
  __shared__ T sp[CAP * NUM_P];
  __shared__ T sr[CAP * N_ROT];
  __shared__ T sc[CAP * NCOAT_MAX];
  __shared__ T scf[Bd::SAG ? CAP * NC_MAX : 1];
  __shared__ int sf[NFLAG * CAP];
  __shared__ int ssag[Bd::SAG || Bd::NURBS ? CAP : 1];
  // each surface's row and flags for step_fwd_pt (PTS)
  __shared__ __align__(16) T pt_q[PTS ? CAP * PT_ROW : 1];
  __shared__ int pt_f[PTS ? CAP : 1];
  // the per-warp rows in dynamic shared memory from the sag build up: at
  // NC_MAX = 36 the sag build's static rows would pass 48 KB (the nurbs
  // build's too, its nets and knot rows after them)
  constexpr bool DYN = Bd::SAG || Bd::NURBS;
  __shared__ T acc_s[DYN ? 1 : NW_MAX * NCOMP_MAX];
  __shared__ T npre[CAP];
  load_coefs<T, Bd::SAG>(cf, S, nc, scf);
  // the layout rows of the aux-bearing surfaces follow the table (AUX)
  const T* lay = Bd::AUX ? cf + (int64_t)S * nc : nullptr;
  load_pol_tables(params, coat, flags, S, ncoat, sp, sc, sf, sr);
  const int nsagc =
      Bd::SAG ? nsag * Bd::block(nc) : (Bd::NURBS ? nsag * nc : 0);
  const int ncomp = S * (N_GF + ncoat) + nsagc;
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
    if constexpr (Bd::NURBS) fill_nurbs(sf, S, ssag);
    if constexpr (PTS)
      for (int s = 1; s < S; ++s) {
        fill_pt_row(sp + s * NUM_P, npre[s], pt_q + s * PT_ROW);
        pt_f[s] = pt_flags(sf[s], sf[S + s], sf[2 * S + s],
                           sf[F_TILT * S + s]);
      }
  }
  __syncthreads();
  T* row = acc + warp * astride;
  // NURBS: the warp's staged records for the net columns (lane r's at
  // srec + r * 2 NU_PT, its spans at sidx + 4 r), this lane's at rec, idx
  T* const srec = nets + nwords + warp * 32 * 2 * NU_PT;
  int* const sidx = reinterpret_cast<int*>(
      nets + nwords + nw * 32 * 2 * NU_PT) + warp * 32 * 4;
  T* const rec = srec + lane * 2 * NU_PT;
  int* const idx = sidx + lane * 4;
  const int cbase = S * N_GF + nsagc;  // the coat columns
  const int nst = INTENSITY ? stt.n : 0;

  // the input state (x, y, z, L, M, N, i) of surface s, then (PTS) what
  // step_fwd_pt saved
  T st[CAP][7 + (PTS ? N_SV : 0)];
  // the Newton builds: each Newton surface's record (step_fwd with KEEP);
  // NURBS: each NURBS surface's stopped (us, vs)
  T ts[Bd::SAG ? CAP : 1][Bd::FREE ? N_KEEP : 1];
  T suv[Bd::NURBS ? CAP : 1][2];
  T ad[CAP];  // adot of surface s
  T ps[CAP][NPOL];  // the polarization before surface s
  T istep[CAP];     // intensity after the step, before the coating
  // the Newton builds: a Newton surface's block of columns, this lane's
  // values (add_*_cols with STAGE), for warp_cols_staged
  T cv[Bd::SAG ? N_STAGE : 1];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t base = (int64_t)blockIdx.x * blockDim.x; base < R;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    const bool valid = i < R;
    // cotangents of (x, y, z, L, M, N, n, i, opd), of the polarization,
    // and of the launch directions and intensity through the exit
    // intensity
    T g[9] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
    T G[NPOL];
    T g_kl[3] = {T(0), T(0), T(0)}, g_il = T(0);
    T kfin[3] = {T(0), T(0), T(0)};
    T k_launch[3] = {T(0), T(0), T(0)};
    if (valid) {
      T v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = in.p[k][i];
      k_launch[0] = v[3];
      k_launch[1] = v[4];
      k_launch[2] = v[5];
      const T i0 = v[6];
      T pol[NPOL] = {};
      if constexpr (VEC) {
        launch_fields(k_launch, stt, pol);
      } else {
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          pol[j] = (j % 4 == 0) ? T(1) : T(0);
          pol[9 + j] = T(0);
        }
      }
      for (int s = 1; s < S; ++s) {
#pragma unroll
        for (int k = 0; k < 7; ++k) st[s][k] = v[k];
#pragma unroll
        for (int j = 0; j < NPOL; ++j) ps[s][j] = pol[j];
        T kl[6];
        if constexpr (Bd::NURBS) {
          step_fwd_nurbs<T, true, true>(
              sf[s], sf[S + s], sf[2 * S + s], sf[F_TILT * S + s],
              sp + s * NUM_P, sr + s * N_ROT, ntab, s, niters, npre[s],
              sp[s * NUM_P + P_NPOST], v[0], v[1], v[2], v[3], v[4], v[5],
              v[6], v[7], &ad[s], kl, suv[s]);
        } else if constexpr (PTS) {
          const T* q = pt_q + s * PT_ROW;
          step_fwd_pt_ext<T, true, Bd::TILT>(
              pt_f[s], q, sr + s * N_ROT, q[Q_U], q[Q_NPRE], q[Q_NPOST],
              v[0], v[1], v[2], v[3], v[4], v[5], v[6], v[7], st[s] + 7,
              &ad[s], kl);
        } else {
          step_fwd<T, true, Bd::TILT, Bd::SAG, Bd::FREE, Bd::DEEP, Bd::AUX,
                   true>(
              sf[s], sf[S + s], sf[2 * S + s], sf[F_TILT * S + s],
              sp + s * NUM_P, sr + s * N_ROT, scf + s * nc,
              lay_of(lay, s, nc), nc, niters, npre[s],
              sp[s * NUM_P + P_NPOST], v[0], v[1], v[2], v[3], v[4], v[5],
              v[6], v[7], &ad[s], kl, ts[s]);
        }
        istep[s] = v[6];
        const int refl = sf[S + s], kind = sf[3 * S + s];
        const T* cr = sc + s * ncoat;
        if (kind == K_SIMPLE) v[6] *= cr[refl ? 1 : 0];
        pol_update_fwd<T, VEC, DIV>(kind, cr, sf[4 * S + s], refl, kl,
                                    kl + 3, ad[s], pol, nst);
      }
      kfin[0] = v[3];
      kfin[1] = v[4];
      kfin[2] = v[5];
#pragma unroll
      for (int k = 0; k < 6; ++k) g[k] = cot.p[k][i];
      if constexpr (INTENSITY && !VEC) {
        // the chain's own intensity reaches no output
        g[8] = cot.p[7][i];
        exit_intensity_adjoint(pol, pol + 9, k_launch, i0, stt, cot.p[6][i],
                               G, G + 9, g_kl, g_il);
      } else if constexpr (VEC) {
        // the chain's own intensity reaches no output; the exit intensity
        // i0 / n sum_m |e_m|^2
        g[8] = cot.p[7][i];
        T total = T(0);
        for (int j = 0; j < NPOL; ++j)
          if (j < 6 * nst) total += pol[j] * pol[j];
        const T g_out = cot.p[6][i];
        const T g_tot = g_out * i0 / T(nst);
        g_il = g_out * total / T(nst);
#pragma unroll
        for (int j = 0; j < NPOL; ++j) G[j] = T(2) * g_tot * pol[j];
      } else {
        g[7] = cot.p[6][i];
        g[8] = cot.p[7][i];
#pragma unroll
        for (int j = 0; j < 18; ++j) G[j] = cot.p[8 + j][i];
      }
    }
    for (int s = S - 1; s >= 1; --s) {
      T gc[N_GF] = {};
      T gs[Bd::NURBS ? 1 : (Bd::FREE ? N_GS_CART : N_GS_RAD)] = {};
      T gco[NCOAT_MAX];
      for (int c = 0; c < ncoat; ++c) gco[c] = T(0);
      if (valid) {
        const int refl = sf[S + s], kind = sf[3 * S + s];
        const int tilted = sf[F_TILT * S + s];
        const T* cr = sc + s * ncoat;
        const int nl = sf[4 * S + s];
        if (kind == K_SIMPLE) {
          const int col = refl ? 1 : 0;
          gco[col] += g[7] * istep[s];
          g[7] *= cr[col];
        }
        // the local pre- and post-interaction directions: the step's input
        // and output directions, rotated into a tilted surface's frame
        T k0[3] = {st[s][3], st[s][4], st[s][5]};
        T k1[3];
        for (int c = 0; c < 3; ++c)
          k1[c] = s + 1 < S ? st[s + 1][3 + c] : kfin[c];
        if (Bd::TILT && tilted) {
          rot_local_dir(sr + s * N_ROT, k0);
          rot_local_dir(sr + s * N_ROT, k1);
        }
        T gext[7];
        pol_update_adjoint<T, VEC, DIV>(kind, cr, nl, refl, k0, k1, ad[s],
                                        ps[s], nst, G, gco, gext);
        if constexpr (Bd::NURBS) {
          step_adjoint_nurbs<T, true>(
              sf[s], refl, sf[2 * S + s], tilted, sp + s * NUM_P,
              sr + s * N_ROT, ntab, s, suv[s], npre[s],
              sp[s * NUM_P + P_NPOST], st[s][0], st[s][1], st[s][2],
              st[s][3], st[s][4], st[s][5], st[s][6], g, gc, rec, idx, gext);
        } else if constexpr (PTS) {
          const T* q = pt_q + s * PT_ROW;
          step_adjoint_pt_ext<T, true, Bd::TILT>(
              pt_f[s], q, sr + s * N_ROT, q[Q_U], q[Q_INP], q[Q_NPRE],
              q[Q_NPOST], st[s][0], st[s][1], st[s][2], st[s][3], st[s][4],
              st[s][5], st[s][6], st[s] + 7, g, gc, gext);
        } else {
          step_adjoint_kept_ext<T, true, Bd::TILT, Bd::SAG, Bd::FREE,
                                Bd::DEEP, Bd::AUX>(
              sf[s], refl, sf[2 * S + s], tilted, sp + s * NUM_P,
              sr + s * N_ROT, scf + s * nc, lay_of(lay, s, nc), nc, npre[s],
              sp[s * NUM_P + P_NPOST], st[s][0], st[s][1], st[s][2],
              st[s][3], st[s][4], st[s][5], st[s][6], g, gc, gs, ts[s],
              gext);
        }
      }
      pol_cols_add(gc, gco, ncoat, lane, row + s * N_GF,
                   row + cbase + s * ncoat);
      if constexpr (Bd::SAG) {
        // the block's columns staged per lane, summed by the butterfly
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
      }
      if constexpr (Bd::NURBS) {
        if (!valid) nu_rec_none(idx);
        if (sf[s] == NURBS)
          nurbs_warp_cols(srec, sidx, nu_surf(ntab, s), lane, row,
                          S * N_GF + ssag[s] * nc);
      }
    }
    // n_pre of surface 1 is the object row's n_post
    {
      const T v = warp_sum(g[6]);
      if (lane == 0) row[0 * N_GF + 3] += v;
    }
    if (valid) {
      if constexpr (VEC) launch_fields_adjoint(k_launch, stt, G, g_kl);
#pragma unroll
      for (int k = 0; k < 3; ++k) din.p[k][i] = g[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) din.p[3 + k][i] = g[3 + k] + g_kl[k];
      din.p[6][i] = g[7] + g_il;
      din.p[7][i] = g[8];
    }
  }
  __syncthreads();
  store_partial_row(acc, astride, nw, ncomp, partial);
}

template <typename P, int K>
Ptrs<P, K> ptrs(void* const* p, int n) {
  Ptrs<P, K> r;
  for (int k = 0; k < K; ++k) r.p[k] = k < n ? (P)p[k] : nullptr;
  return r;
}

template <typename T>
States<T> states_of(const double* c, int n) {
  States<T> s;
  for (int m = 0; m < 2; ++m)
    for (int j = 0; j < 4; ++j) s.c[m][j] = T(c[4 * m + j]);
  s.n = n;
  return s;
}

int check_shape(int ncoat, int nstates) {
  if (ncoat < 4 || ncoat > NCOAT_MAX || nstates < 0 || nstates > 2)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// ``build``: the instantiation the spec needs (ops/launch.py: build_of).
// NU: the nurbs build's launchers (nurbs_pol.cu), which take it alone.
template <typename T, bool NU = false>
int fwd_launch(const T* params, const T* coat, const int* flags, int S,
               int build, const T* cf, int nc, int kt, int niters, int ncoat,
               void* const* in, int64_t R, void* const* out, int intensity,
               const double* c, int nstates, cudaStream_t stream) {
  if (int e = check_shape(ncoat, nstates)) return e;
  if (intensity && nstates < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (R + FWD_BLOCK - 1) / FWD_BLOCK;
  if (blocks == 0) return (int)cudaGetLastError();
  const States<T> st = states_of<T>(c, nstates);
  const auto body = [&](auto b) {
    constexpr int B = decltype(b)::value;
    if (!shape_ok<B>(S, nc, niters)) return (int)cudaErrorInvalidValue;
    const auto kernel =
        intensity ? pol_fwd_kernel<T, true, B> : pol_fwd_kernel<T, false, B>;
    if (Build<B>::NURBS && kt <= S) return (int)cudaErrorInvalidValue;
    // the tables, with room for a net on every surface (the forward's
    // launch does not count the NURBS surfaces)
    const size_t dyn = Build<B>::NURBS ? nurbs_bytes<T>(S, nc, kt) : 0;
    if (int e2 = set_dyn_smem<Build<B>::NURBS>(kernel, dyn)) return e2;
    kernel<<<(unsigned)blocks, FWD_BLOCK, dyn, stream>>>(
        params, coat, flags, S, ncoat, cf, nc, niters,
        ptrs<const T*, 8>(in, 8), R,
        ptrs<T*, N_POL>(out, intensity ? 8 : N_POL), st);
    return (int)cudaGetLastError();
  };
  if constexpr (NU)
    return dispatch_in<B_NURBS>(build, body);
  else
    return dispatch_build(build, body);
}

template <typename T, bool NU = false>
int bwd_launch(const T* params, const T* coat, const int* flags, int S,
               int build, const T* cf, int nc, int kt, int niters, int nsag,
               int ncoat, void* const* in, void* const* cot, int64_t R,
               void* const* din, T* partial, int nblocks, T* out,
               int intensity, const double* c, int nstates,
               cudaStream_t stream) {
  if (int e = check_shape(ncoat, nstates)) return e;
  if (nblocks < 1 || (intensity && nstates < 1) || nsag < 0 || nsag > S)
    return (int)cudaErrorInvalidValue;
  const States<T> st = states_of<T>(c, nstates);
  const int ncb = block_cols(build, nc);
  const int nsagc = build & (BIT_SAG | BIT_NURBS) ? nsag * ncb : 0;
  const auto body = [&](auto b) {
    constexpr int B = decltype(b)::value;
    constexpr bool DYN = Build<B>::SAG || Build<B>::NURBS;
    if (!shape_ok<B>(S, nc, niters)) return (int)cudaErrorInvalidValue;
    const auto kernel =
        intensity ? pol_bwd_kernel<T, true, B> : pol_bwd_kernel<T, false, B>;
    const int ncomp = S * (N_GF + ncoat) + nsagc;
    size_t dyn;
    if constexpr (Build<B>::NURBS) {
      if (kt <= S || nsag < 1) return (int)cudaErrorInvalidValue;
      dyn = nurbs_bwd_bytes<T>(BWD_BLOCK, ncomp, nsag, nc, kt);
      if (int e2 = set_pt_smem(kernel, dyn)) return e2;
    } else {
      dyn = dyn_bytes<T, DYN>(BWD_BLOCK / 32, ncomp);
      if (int e2 = set_dyn_smem<DYN>(kernel, dyn)) return e2;
    }
    kernel<<<nblocks, BWD_BLOCK, dyn, stream>>>(
        params, coat, flags, S, ncoat, cf, nc, niters, nsag,
        ptrs<const T*, 8>(in, 8),
        ptrs<const T*, N_POL>(cot, intensity ? 8 : N_POL), R,
        ptrs<T*, 8>(din, 8), partial, st);
    return (int)cudaGetLastError();
  };
  int e;
  if constexpr (NU)
    e = dispatch_in<B_NURBS>(build, body);
  else
    e = dispatch_build(build, body);
  if (e != 0) return e;
  return reduce_launch<T, N_GF, false, NU>(partial, nblocks, S, nc, ncb,
                                           nsagc, flags, S * ncoat, out,
                                           stream);
}

// Resident blocks per SM of pol_bwd (NU: the nurbs build) in ``intensity``
// mode at ``block`` threads and ``dyn`` bytes (ops/launch.py: bwd_grid,
// which launches one wave of them).
template <typename T, bool NU = false>
int pol_bwd_occupancy(int intensity, int build, int block, int64_t dyn,
                      int* out) {
  const auto body = [&](auto b) {
    constexpr int B = decltype(b)::value;
    if (intensity)
      return pt_occupancy(pol_bwd_kernel<T, true, B>, block, dyn, out);
    return pt_occupancy(pol_bwd_kernel<T, false, B>, block, dyn, out);
  };
  if constexpr (NU)
    return dispatch_in<B_NURBS>(build, body);
  else
    return dispatch_build(build, body);
}

}  // namespace

// The polarized C entries of a build set: otc_pol_<fwd|bwd>NAME_<SUF>
// (NAME empty, or _nurbs for the nurbs build with NU).
#define OTC_POL(SUF, T, NAME, NU)                                            \
  extern "C" int otc_pol_fwd##NAME##_##SUF(                                  \
      const T* params, const T* coat, const int* flags, int S, int build,    \
      const T* cf, int nc, int kt, int niters, int ncoat, void* const* in,   \
      int64_t R, void* const* out, int intensity, double c0, double c1,      \
      double c2, double c3, double c4, double c5, double c6, double c7,      \
      int nstates, void* stream) {                                           \
    const double c[8] = {c0, c1, c2, c3, c4, c5, c6, c7};                    \
    return fwd_launch<T, NU>(params, coat, flags, S, build, cf, nc, kt,      \
                             niters, ncoat, in, R, out, intensity, c,        \
                             nstates, (cudaStream_t)stream);                 \
  }                                                                          \
  extern "C" int otc_pol_bwd##NAME##_##SUF(                                  \
      const T* params, const T* coat, const int* flags, int S, int build,    \
      const T* cf, int nc, int kt, int niters, int nsag, int ncoat,          \
      void* const* in, void* const* cot, int64_t R, void* const* din,        \
      T* partial, int nblocks, T* out, int intensity, double c0, double c1,  \
      double c2, double c3, double c4, double c5, double c6, double c7,      \
      int nstates, void* stream) {                                           \
    const double c[8] = {c0, c1, c2, c3, c4, c5, c6, c7};                    \
    return bwd_launch<T, NU>(params, coat, flags, S, build, cf, nc, kt,      \
                             niters, nsag, ncoat, in, cot, R, din, partial,  \
                             nblocks, out, intensity, c, nstates,            \
                             (cudaStream_t)stream);                          \
  }                                                                          \
  extern "C" int otc_pol_bwd_occupancy##NAME##_##SUF(                        \
      int intensity, int build, int block, int64_t dyn, int* out) {          \
    return pol_bwd_occupancy<T, NU>(intensity, build, block, dyn, out);      \
  }
