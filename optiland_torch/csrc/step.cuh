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
// A tilted surface (its flag set where a tilt angle is nonzero or not
// finite) rotates the ray into its frame, z then y then x by the negated
// angles, and back in reverse order after the interaction (_rot_local and
// _rot_global); the cosines and sines of its angles come from the
// shared-memory table that load_tables fills. step_adjoint routes every
// cotangent through the rotations and gives the true d/d(rx, ry, rz); an
// untilted surface runs no rotation and keeps the zero-tilt derivative, the
// rotations' generators, which is what the general form gives at zero.
// The TILT template flag of the step (and of every kernel) compiles the
// rotations in; the launchers take TILT = false for a system without a
// tilted surface, whose kernels then keep the registers and local memory
// they had without the tilt code.
//
// The polarized traces (pol_trace.cu) also read the step's "extras": the
// local-frame pre- and post-interaction directions, which step_fwd writes
// to ``kloc``, and adot, which it writes to ``adot_out``; step_adjoint
// takes their cotangents in ``gext``. The pointers are null in the other
// kernels.
//
// The index after the surface is an argument (``npost``): the param
// table's P_NPOST column in the monochromatic traces, the per-ray value of
// the surface's dispersion formula in the polychromatic one (n_formula,
// and dn_dcoef for its adjoint: materials/dispersion.py's
// n_formula_scalar_terms and n_formula_scalar_grad).

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
constexpr int MAX_NM = 20;  // dispersion coefficients per surface (poly)
constexpr int N_ROT = 6;    // cos rx, sin rx, cos ry, sin ry, cos rz, sin rz
constexpr int FWD_BLOCK = 256;
constexpr int BWD_BLOCK = 128;
constexpr int RED_BLOCK = 256;

// Per-surface gradient slots of the backwards and the param-table column of
// each: radius, conic, pos, n_post, dx, dy, and the tilts rx, ry, rz in
// both forms, then k_pre in the FULL form (ops/step.py: GRAD_COLS,
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
__device__ __forceinline__ float log_(float v) { return logf(v); }
__device__ __forceinline__ double log_(double v) { return log(v); }
__device__ __forceinline__ float pow_(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double pow_(double a, double b) { return pow(a, b); }
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
// Tilt rotations (_rot_local / _rot_global and their adjoints)
// ---------------------------------------------------------------------------

// (a, b) <- (a c - b s, a s + b c): rotate_z on (x, y) and rotate_x on
// (y, z) by the angle of (c, s); rotate_y by theta is this on (x, z) with
// (c, -s).
template <typename T>
__device__ __forceinline__ void rot_ab(T& a, T& b, T c, T s) {
  const T a2 = a * c - b * s;
  b = a * s + b * c;
  a = a2;
}

// Into the surface's frame: R_x(-rx) R_y(-ry) R_z(-rz) of the position and
// the direction.
template <typename T>
__device__ __forceinline__ void rot_local(const T* r, T& x, T& y, T& z, T& L,
                                          T& M, T& N) {
  rot_ab(x, y, r[4], -r[5]);
  rot_ab(L, M, r[4], -r[5]);
  rot_ab(x, z, r[2], r[3]);
  rot_ab(L, N, r[2], r[3]);
  rot_ab(y, z, r[0], -r[1]);
  rot_ab(M, N, r[0], -r[1]);
}

// rot_local of a direction k[0..2] alone.
template <typename T>
__device__ __forceinline__ void rot_local_dir(const T* r, T* k) {
  rot_ab(k[0], k[1], r[4], -r[5]);
  rot_ab(k[0], k[2], r[2], r[3]);
  rot_ab(k[1], k[2], r[0], -r[1]);
}

template <typename T>
__device__ __forceinline__ void rot_global(const T* r, T& x, T& y, T& z,
                                           T& L, T& M, T& N) {
  rot_ab(y, z, r[0], r[1]);
  rot_ab(M, N, r[0], r[1]);
  rot_ab(x, z, r[2], -r[3]);
  rot_ab(L, N, r[2], -r[3]);
  rot_ab(x, y, r[4], r[5]);
  rot_ab(L, M, r[4], r[5]);
}

// Reverse of one rot_ab by (c, s) of the pairs (a, b) and (A, B), given as
// its outputs with their cotangents: returns the derivative with respect to
// the angle, and rotates the pairs and their cotangents back to its inputs
// (ops/step.py: _rot_ab_adjoint).
template <typename T>
__device__ __forceinline__ T rot_ab_adjoint(T& a, T& b, T& A, T& B, T& ga,
                                            T& gb, T& gA, T& gB, T c, T s) {
  const T d = -ga * b + gb * a - gA * B + gB * A;
  rot_ab(a, b, c, -s);
  rot_ab(A, B, c, -s);
  rot_ab(ga, gb, c, -s);
  rot_ab(gA, gB, c, -s);
  return d;
}

// Reverse of rot_global at the local state (x .. N) it rotates: g (x, y, z,
// L, M, N) becomes the cotangents of that state; d_r[0..2] += the
// derivatives with respect to rx, ry, rz (ops/step.py: _rot_global_adjoint).
template <typename T>
__device__ __forceinline__ void rot_global_adjoint(const T* r, T x, T y, T z,
                                                   T L, T M, T N, T* g,
                                                   T* d_r) {
  rot_global(r, x, y, z, L, M, N);
  d_r[2] += rot_ab_adjoint(x, y, L, M, g[0], g[1], g[3], g[4], r[4], r[5]);
  d_r[1] -= rot_ab_adjoint(x, z, L, N, g[0], g[2], g[3], g[5], r[2], -r[3]);
  d_r[0] += rot_ab_adjoint(y, z, M, N, g[1], g[2], g[4], g[5], r[0], r[1]);
}

// Reverse of rot_local at its output, the local state (x .. N): g becomes
// the cotangents of its input; d_r[0..2] += the angle derivatives
// (ops/step.py: _rot_local_adjoint).
template <typename T>
__device__ __forceinline__ void rot_local_adjoint(const T* r, T x, T y, T z,
                                                  T L, T M, T N, T* g,
                                                  T* d_r) {
  d_r[0] -= rot_ab_adjoint(y, z, M, N, g[1], g[2], g[4], g[5], r[0], -r[1]);
  d_r[1] += rot_ab_adjoint(x, z, L, N, g[0], g[2], g[3], g[5], r[2], r[3]);
  d_r[2] -= rot_ab_adjoint(x, y, L, M, g[0], g[1], g[3], g[4], r[4], -r[5]);
}

// ---------------------------------------------------------------------------
// Dispersion formulas (materials/dispersion.py: n_formula_scalar_terms, and
// its derivative n_formula_scalar_grad), per ray, from a surface's nm
// coefficients cv. Codes 0-9 and 11; TABULATED_N (10) never reaches the
// kernels. The (B, C) pairs run from cv[1] (codes 1, 2, 3, 5, 6) or cv[9]
// (code 4); zero-padded pairs contribute exactly zero terms.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int n_pairs(int nm) { return (nm - 1) / 2; }
__device__ __forceinline__ int n_pairs4(int nm) {
  return nm > 9 ? (nm - 9) / 2 : 0;
}

template <typename T>
__device__ T n_formula(int code, const T* cv, int nm, T w) {
  const T w2 = w * w;
  const int np = n_pairs(nm);
  switch (code) {
    case 0:
      return cv[0];
    case 1:
    case 2: {  // Sellmeier (w^2 - C^2), Sellmeier-2 (w^2 - C)
      T n2 = T(1) + cv[0];
      for (int k = 0; k < np; ++k) {
        const T b = cv[1 + 2 * k], c = cv[2 + 2 * k];
        n2 = n2 + b * w2 / (code == 1 ? w2 - c * c : w2 - c);
      }
      return sqrt_(n2);
    }
    case 3:
    case 5: {  // polynomial (sqrt), Cauchy
      T acc = cv[0];
      for (int k = 0; k < np; ++k)
        acc = acc + cv[1 + 2 * k] * pow_(w, cv[2 + 2 * k]);
      return code == 3 ? sqrt_(acc) : acc;
    }
    case 4: {
      T n2 = cv[0] + cv[1] * pow_(w, cv[2]) / (w2 - pow_(cv[3], cv[4])) +
             cv[5] * pow_(w, cv[6]) / (w2 - pow_(cv[7], cv[8]));
      for (int k = 0; k < n_pairs4(nm); ++k)
        n2 = n2 + cv[9 + 2 * k] * pow_(w, cv[10 + 2 * k]);
      return sqrt_(n2);
    }
    case 6: {  // gases
      const T winv2 = T(1) / w2;
      T n = T(1) + cv[0];
      for (int k = 0; k < np; ++k)
        n = n + cv[1 + 2 * k] / (cv[2 + 2 * k] - winv2);
      return n;
    }
    case 7: {  // Herzberger
      const T inv = T(1) / (w2 - T(0.028));
      T n = cv[0] + cv[1] * inv + cv[2] * (inv * inv);
      for (int k = 3; k < nm; ++k) n = n + cv[k] * pow_(w, T(2 * (k - 2)));
      return n;
    }
    case 8: {  // retro
      const T b = cv[0] + cv[1] * w2 / (w2 - cv[2]) + cv[3] * w2;
      return sqrt_((T(1) + T(2) * b) / (T(1) - b));
    }
    case 9: {  // exotic
      const T e = w - cv[4];
      return sqrt_(cv[0] + cv[1] / (w2 - cv[2]) + cv[3] * e / (e * e + cv[5]));
    }
    case 11: {  // Buchdahl
      const T d = w - cv[4];
      const T om = d / (T(1) + cv[5] * d);
      return cv[0] + cv[1] * om + cv[2] * (om * om) + cv[3] * (om * om * om);
    }
    default:
      return nan_<T>();
  }
}

// True where dn/d cv[j] can be nonzero (the columns the formula reads).
__device__ __forceinline__ bool dn_used(int code, int nm, int j) {
  switch (code) {
    case 0:
      return j == 0;
    case 1:
    case 2:
    case 3:
    case 5:
    case 6:
      return j <= 2 * n_pairs(nm);
    case 4:
      return j <= 8 || (j - 9) / 2 < n_pairs4(nm);
    case 7:
      return true;
    case 8:
      return j <= 3;
    default:  // 9, 11
      return j <= 5;
  }
}

// d(x^y)/dx and d(x^y)/dy as JAX forms them for a float exponent:
// y x^(y - 1) (NaN at x = y = 0), and log(x) x^y with 0 where x == 0.
template <typename T>
__device__ __forceinline__ T dpow_dbase(T x, T y) {
  return y * pow_(x, y - T(1));
}
template <typename T>
__device__ __forceinline__ T dpow_dexp(T x, T y) {
  return log_(x == T(0) ? T(1) : x) * pow_(x, y);
}

// dn/d cv[j] at wavelength w, where n is the formula's value there.
template <typename T>
__device__ T dn_dcoef(int code, const T* cv, int nm, T w, T n, int j) {
  const T w2 = w * w;
  const T sq = T(0.5) / n;  // dn/d(n^2) of the square-root forms
  switch (code) {
    case 0:
      return j == 0 ? T(1) : T(0);
    case 1:
    case 2: {
      if (j == 0) return sq;
      const int k = (j - 1) / 2;
      const T b = cv[1 + 2 * k], c = cv[2 + 2 * k];
      const T den = code == 1 ? w2 - c * c : w2 - c;
      if (j % 2) return sq * w2 / den;
      return sq * b * w2 * (code == 1 ? T(2) * c : T(1)) / (den * den);
    }
    case 3:
    case 5: {
      const T f = code == 3 ? sq : T(1);
      if (j == 0) return f;
      const int k = (j - 1) / 2;
      const T c = cv[2 + 2 * k];
      if (j % 2) return f * pow_(w, c);
      return f * cv[1 + 2 * k] * dpow_dexp(w, c);
    }
    case 4: {
      if (j == 0) return sq;
      if (j <= 8) {
        const int a = j < 5 ? 1 : 5;
        const T ca = cv[a], ce = cv[a + 1], cb = cv[a + 2], cx = cv[a + 3];
        const T den = w2 - pow_(cb, cx);
        const T num = pow_(w, ce);
        switch (j - a) {
          case 0:
            return sq * num / den;
          case 1:
            return sq * ca * dpow_dexp(w, ce) / den;
          case 2:
            return sq * ca * num / (den * den) * dpow_dbase(cb, cx);
          default:
            return sq * ca * num / (den * den) * dpow_dexp(cb, cx);
        }
      }
      const int k = (j - 9) / 2;
      const T c = cv[10 + 2 * k];
      if ((j - 9) % 2 == 0) return sq * pow_(w, c);
      return sq * cv[9 + 2 * k] * dpow_dexp(w, c);
    }
    case 6: {
      if (j == 0) return T(1);
      const int k = (j - 1) / 2;
      const T den = cv[2 + 2 * k] - T(1) / w2;
      if (j % 2) return T(1) / den;
      return -cv[1 + 2 * k] / (den * den);
    }
    case 7: {
      const T inv = T(1) / (w2 - T(0.028));
      if (j == 0) return T(1);
      if (j == 1) return inv;
      if (j == 2) return inv * inv;
      return pow_(w, T(2 * (j - 2)));
    }
    case 8: {
      const T den = w2 - cv[2];
      const T b = cv[0] + cv[1] * w2 / den + cv[3] * w2;
      const T db = sq * T(3) / ((T(1) - b) * (T(1) - b));
      if (j == 0) return db;
      if (j == 1) return db * w2 / den;
      if (j == 2) return db * cv[1] * w2 / (den * den);
      return db * w2;
    }
    case 9: {
      const T den = w2 - cv[2];
      const T e = w - cv[4];
      const T q = e * e + cv[5];
      switch (j) {
        case 0:
          return sq;
        case 1:
          return sq / den;
        case 2:
          return sq * cv[1] / (den * den);
        case 3:
          return sq * e / q;
        case 4:
          return -sq * cv[3] * (q - T(2) * e * e) / (q * q);
        default:
          return -sq * cv[3] * e / (q * q);
      }
    }
    default: {  // 11, Buchdahl
      const T d = w - cv[4];
      const T f = T(1) + cv[5] * d;
      const T om = d / f;
      const T dn_dom = cv[1] + T(2) * cv[2] * om + T(3) * cv[3] * (om * om);
      switch (j) {
        case 0:
          return T(1);
        case 1:
          return om;
        case 2:
          return om * om;
        case 3:
          return om * om * om;
        case 4:
          return -dn_dom / (f * f);
        default:
          return -dn_dom * d * d / (f * f);
      }
    }
  }
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

// One forward surface step; returns n of the medium after the surface
// (``npost`` through a refractive surface). ``inten`` and ``opd`` are read
// and written only in the FULL form; ``adot_out``, when not null, receives
// |cos| of the angle of incidence, and ``kloc`` the local pre- and
// post-interaction directions (L0, M0, N0, L1, M1, N1). ``rot`` holds the
// surface's N_ROT cosines and sines, read where ``tilted`` is set; TILT =
// false compiles the rotations out (a system without tilted surfaces).
template <typename T, bool FULL, bool TILT>
__device__ __forceinline__ T step_fwd(int code, int refl, int absorbs,
                                      int tilted, const T* p, const T* rot,
                                      T n_pre, T npost, T& x, T& y, T& z,
                                      T& L, T& M, T& N, T& inten, T& opd,
                                      T* adot_out = nullptr,
                                      T* kloc = nullptr) {
  const T R = p[P_RADIUS], k = p[P_CONIC], pos = p[P_POS];
  T xl = x - p[P_DX], yl = y - p[P_DY], zl = z - pos;
  if (TILT && tilted) rot_local(rot, xl, yl, zl, L, M, N);
  const T t = code == STANDARD ? dist_standard(R, k, xl, yl, zl, L, M, N)
                               : dist_plane(zl, N);
  T x1 = xl + t * L, y1 = yl + t * M, z1 = zl + t * N;
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
  if (TILT && tilted) rot_global(rot, x1, y1, z1, L, M, N);
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
// of (radius, conic, pos, n_post, dx, dy, rx, ry, rz, and FULL: k_pre); the
// n_post slot is the cotangent of ``npost``.
template <typename T, bool FULL, bool TILT>
__device__ __forceinline__ void step_adjoint(int code, int refl, int absorbs,
                                             int tilted, const T* p,
                                             const T* rot, T n_pre, T npost,
                                             T x, T y, T z, T L, T M, T N,
                                             T i_in, T* g, T* gc,
                                             const T* gext = nullptr) {
  const T R = p[P_RADIUS], k = p[P_CONIC], pos = p[P_POS];
  const T dx = p[P_DX], dy = p[P_DY];
  const bool std_ = code == STANDARD;
  const T g_nn = g[6];

  // ---- recompute the forward intermediates (in the surface's frame) ----
  T xl = x - dx, yl = y - dy, zl = z - pos;
  if (TILT && tilted) rot_local(rot, xl, yl, zl, L, M, N);
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
  if (TILT && tilted)
    rot_global_adjoint(rot, x1, y1, z1, Lo, Mo, No, go, d_r);
  T g_dx = g[0], g_dy = g[1], g_pos = g[2];
  T g_x1 = go[0], g_y1 = go[1], g_z1 = go[2];
  // cotangents of the local post-interaction directions: the output's and
  // the extras' L1, M1, N1
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

  // ---- tilts: through the rotations (tilted), or at zero, where each
  // rotation's generator acts on the state ----
  T gi[6] = {g_xl, g_yl, g_zl, gL, gM, gN};
  if (TILT && tilted) {
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
// per-surface flags into shared memory, and form each surface's N_ROT
// cosines and sines of its tilts (read by tilted surfaces only).
template <typename T, int NF, bool AIM>
__device__ __forceinline__ void load_tables(const T* params, const T* aim,
                                            const int* flags, int S, T* sp,
                                            T* sa, int* sf, T* srot) {
  for (int i = threadIdx.x; i < S * NUM_P; i += blockDim.x) sp[i] = params[i];
  if constexpr (AIM)
    for (int i = threadIdx.x; i < N_AIM; i += blockDim.x) sa[i] = aim[i];
  for (int i = threadIdx.x; i < NF * S; i += blockDim.x) sf[i] = flags[i];
  for (int i = threadIdx.x; i < 3 * S; i += blockDim.x) {
    const T ang = params[(i / 3) * NUM_P + P_RX + i % 3];
    srot[2 * i] = cos_(ang);
    srot[2 * i + 1] = sin_(ang);
  }
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
