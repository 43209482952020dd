// Device code shared by the port's trace kernels (sm_90a): the PLANE,
// STANDARD, tilt, annular-aperture, EVEN_ASPHERE/ODD_ASPHERE,
// POLYNOMIAL_XY/CHEBYSHEV/TOROIDAL/BICONIC, ZERNIKE_SAG/FORBES_QBFS/
// FORBES_Q2D and grating branches of _step_tile (the NURBS branch is in
// nurbs_step.cuh, which this header includes at its end)
// (optiland_tpu/ops/pallas_trace.py), forward and hand-derived adjoint,
// and what the kernels around the step share: the shared-memory table
// loaders, the per-warp gradient rows of the backwards, and their
// fixed-order reduction kernel. The step is a line-by-line transcription of
// optiland_torch/ops/step.py (step_plain, step_adjoint_plain) and of the
// sag terms of optiland_torch/core/geometry.py (sag_point, cart_point);
// change them together.
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
// The TILT template flag of the step compiles the rotations in; the SAG
// flag also the radial Newton families and, in the FULL form, the annular
// clip; the CART flag the Cartesian families, the AUX flag their
// aux-bearing ones. Every kernel is compiled in nine builds (Build<B>
// below, each an OR of flag bits): stock (none), tilt, sag (tilt and
// sag), free (tilt, sag and the Cartesian families), aux (free with the
// aux-bearing families), deep, deep_free and deep_aux (sag, free and
// aux for up to DEEP_SURF surfaces), and nurbs (tilt and K6d, NURBS
// surfaces: nurbs_step.cuh); the monochromatic ones in a tenth, grat (tilt
// and K6c, gratings). The launchers take the least build
// that covers the spec (ops/launch.py: build_of), so a system without a
// tilted surface, an asphere, a freeform or an annulus runs the stock
// code, whose registers and local memory are those it had before the
// other branches, a radial asphere, shallow or deep, the sag or deep code,
// which carries no Cartesian branch, and a freeform without an
// aux-bearing surface code without their evaluator. The Cartesian and
// deep backwards keep their per-warp gradient rows in dynamic shared
// memory (the polarized backward's sag build too: at NC_MAX = 36 its
// static rows would pass 48 KB).
//
// K6b, the radial Newton families (s = conic(r^2) + sum_i C_i rho^(i+1),
// rho = r^2 even, r odd): sag_point gives s and W (ds/dx = x W), and for
// the adjoint dW/dr^2 and the radius, conic and coefficient derivatives.
// The intersection starts at the conic's closed form (the plane's where that
// is not finite) and takes newton_iters steps t <- t - f/f' on f(t) = z(t) -
// s(x(t), y(t)), f' = N - W (X L + Y M) clamped to 1e-14, then one more:
// the adjoint differentiates that last step at the stopped iterate (the
// implicit-function gradient, with its f f'_theta / f'^2 term), and the
// normal (x W, y W, -1) rsqrt(.) through the sag's second derivative. The
// coefficient row's gradient comes back as five scalars per ray (a, b, c,
// rho_s, rho_1: dC_i = a rho_s^(i+1) + (i+1) (b rho_s^i + c rho_1^i)),
// which the backwards expand into nc columns for each Newton surface.
// K6b, the Cartesian families: cart_point gives s and the separate slopes
// (sx, sy), and for the adjoint their Hessian and their derivatives with
// respect to the radius, the conic, p1 and p2 (P_G1, P_G2). The tables
// (POLYNOMIAL_XY x^i y^j, CHEBYSHEV T_i(x/p1) T_j(y/p2), row-major squares
// of side ceil(sqrt(nc))) are summed row by row with running
// one-dimensional recurrences (Basis1), no per-ray arrays; CHEBYSHEV's
// normal is the reference's dT convention (ChebN), not its sag's
// derivative. Newton's f' = N - (sx L + sy M). The adjoint returns
// N_GS_CART scalars per ray: the coefficient weights (a, b, c) at the
// Newton point and at the normal's point, both points, and the p1 and p2
// cotangents; add_cart_cols expands them into the nc coefficient columns
// and the P_G1, P_G2 columns of the surface's block (nc + 2 columns in the
// free and deep_free builds), warp sums in column order, no float atomics.
// The aux-bearing families (ZERNIKE_SAG, FORBES_QBFS, FORBES_Q2D) are
// Cartesian families of the AUX builds whose row comes laid out in slots,
// read with the surface's rows of the layout table ``lay`` (aux_point_call,
// add_aux_cols; out of line, so the four others keep their registers).
// K6a, the annular clip: the FULL step of the sag build zeroes the
// intensity of a ray with x^2 + y^2 < ap_min^2 on every surface (ap_min is
// 0, which clips nothing, where no RadialAperture sets it).
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

#include <type_traits>

namespace {

constexpr int NUM_P = 15;
constexpr int P_RADIUS = 0, P_CONIC = 1, P_POS = 2, P_NPOST = 3;
constexpr int P_APMAX = 4, P_KPRE = 5;
constexpr int P_DX = 6, P_DY = 7, P_RX = 8, P_RY = 9, P_RZ = 10;
constexpr int P_G1 = 11, P_G2 = 12, P_APMIN = 13, P_MLAM = 14;
constexpr int N_AIM = 8;
constexpr int A_X0 = 0, A_Y0 = 1, A_Z0 = 2, A_L = 3, A_M = 4, A_N = 5;
constexpr int A_SX = 6, A_SY = 7;
constexpr int PLANE = 0, STANDARD = 1, EVEN_ASPHERE = 2, ODD_ASPHERE = 3;
constexpr int POLYNOMIAL_XY = 4, CHEBYSHEV = 5, TOROIDAL = 7, BICONIC = 8;
constexpr int ZERNIKE_SAG = 6, FORBES_QBFS = 9, FORBES_Q2D = 10;
constexpr int NURBS = 12;
// an aux-bearing surface's layout table row per slot: the recurrence
// constants (a, b, c, e), then the flag 4 |m| + 2 sin + pre
// (geometry.py: LAY_COLS, Q2D_EPS)
constexpr int LAY_COLS = 5;
constexpr double Q2D_EPS = 1e-12;
// Beer-Lambert factor exp(ABS * k_pre * t * 1e3), k_pre = k / wavelength
constexpr double ABS = -12.566370614359172;  // -4 pi

// launch shapes (optiland_torch/ops/launch.py holds the same values)
constexpr int STOCK_SURF = 16;  // surfaces of the stock, tilt and sag builds
constexpr int DEEP_SURF = 64;   // surfaces of the deep build
constexpr int NC_MAX = 36;      // geometry coefficients per surface
// the nurbs build's bound on a net (ops/launch.py: NC_NURBS, NU_PMAX,
// NU_KMAX, NU_KT): its row of 4 nu nv columns, its degrees, its knots each
// way, and its knot table row (nu, nv, p, q, the u knots, the v knots)
constexpr int NC_NURBS = 256;
constexpr int NU_PMAX = 7;
constexpr int NU_KMAX = 24;
constexpr int NU_KT = 4 + 2 * NU_KMAX;
// the per-ray record of a Newton surface's coefficient cotangents
// (step_adjoint's gs): 5 scalars of a radial family, 12 of a Cartesian one
constexpr int N_GS_RAD = 5, N_GS_CART = 12;
constexpr int MAX_NM = 20;  // dispersion coefficients per surface (poly)
constexpr int N_ROT = 6;    // cos rx, sin rx, cos ry, sin ry, cos rz, sin rz
constexpr int FWD_BLOCK = 256;
constexpr int BWD_BLOCK = 128;
constexpr int RED_BLOCK = 256;

// The builds of every kernel (ops/launch.py: STOCK .. DEEP_AUX, NURBS):
// a build is an OR of flags, each a branch of the step or the surface
// reach. TILT the rotations, SAG the radial Newton families and the
// annular clip, CART the Cartesian families, AUX their aux-bearing ones
// (ZERNIKE_SAG, FORBES_QBFS, FORBES_Q2D), DEEP the reach of DEEP_SURF
// surfaces, NURBS the NURBS surfaces, GRAT the gratings. Each flag
// is its own, so a deep system without a freeform runs the deep code that
// carries no Cartesian branch, and a freeform without an aux-bearing
// surface the code without their evaluator. DYN: the backwards keep their
// per-warp gradient rows in dynamic shared memory (the Cartesian, the
// deep and the nurbs builds; the polarized backward's sag build too, see
// pol_trace.cuh).
//
// GRAT (the tenth build, B_GRAT: the tilts and K6c, grating diffraction)
// is compiled for the monochromatic kernels only (fast_trace.cu's mono
// mode and fused_trace.cu; dispatch_build<true>): a grating surface (a
// flag row of its own, F_GRAT) diffracts instead of refracting or
// reflecting, and the backwards sum its P_G1 and P_G2 columns in a block
// of N_GRAT_COLS after the per-surface slots (grad_reduce_kernel, GR). Its
// PLANE and STANDARD substrates need no other branch; the launchers refuse
// a grating beside a Newton family, an annular clip or past STOCK_SURF
// surfaces (ops/launch.py: build_of).
//
// NURBS (the ninth build, B_NURBS: the tilts and K6d, NURBS surfaces) is
// compiled for every trace kernel, in source files of its own
// (nurbs_trace.cu, nurbs_merit.cu, nurbs_pol.cu: the kernel templates of
// fast_trace.cuh, fused_trace.cuh and pol_trace.cuh instantiated for it,
// the launchers' NU flag), so the other
// builds' sources and machine code stay as they were. A NURBS surface
// solves for its parameters (u, v) on its control net (nurbs_step.cuh:
// step_fwd_nurbs, step_adjoint_nurbs, functions of their own as the grat
// build's), whose row and knot table the kernels keep in dynamic shared
// memory; the backwards sum its 4 nu nv net columns in a block of nc
// (grad_reduce_kernel, NU). Its PLANE and STANDARD neighbours need no
// other branch; the launchers refuse a NURBS surface beside a Newton
// family, a grating, an annular clip or past STOCK_SURF surfaces, and a
// net past NC_NURBS columns, NU_PMAX degrees or NU_KMAX knots
// (ops/launch.py: build_of, kernel_tables).
constexpr int BIT_TILT = 1, BIT_SAG = 2, BIT_CART = 4, BIT_AUX = 8,
              BIT_DEEP = 16, BIT_GRAT = 32, BIT_NURBS = 64;
constexpr int B_STOCK = 0, B_TILT = BIT_TILT, B_SAG = B_TILT | BIT_SAG,
              B_FREE = B_SAG | BIT_CART, B_DEEP = B_SAG | BIT_DEEP,
              B_DEEP_FREE = B_FREE | BIT_DEEP, B_AUX = B_FREE | BIT_AUX,
              B_DEEP_AUX = B_DEEP_FREE | BIT_AUX, B_GRAT = B_TILT | BIT_GRAT,
              B_NURBS = B_TILT | BIT_NURBS;
// a grating surface's block of a backward's partial row: P_G1, P_G2
constexpr int N_GRAT_COLS = 2;
template <int B>
struct Build {
  static constexpr bool TILT = B & BIT_TILT;
  static constexpr bool SAG = B & BIT_SAG;
  static constexpr bool FREE = B & BIT_CART;
  static constexpr bool AUX = B & BIT_AUX;
  static constexpr bool DEEP = B & BIT_DEEP;
  static constexpr bool GRAT = B & BIT_GRAT;
  static constexpr bool NURBS = B & BIT_NURBS;
  static constexpr bool DYN = FREE || DEEP || NURBS;
  static constexpr int CAP = DEEP ? DEEP_SURF : STOCK_SURF;
  static __host__ __device__ int block(int nc) { return FREE ? nc + 2 : nc; }
};

// Columns of a Newton surface's block of a backward's partial row in build
// ``build`` (Build<B>::block): nc coefficients, then (CART) P_G1 and P_G2;
// a grating's in the grating build: P_G1 and P_G2; a NURBS surface's in
// the nurbs build: nc (its net's 4 nu nv columns, zero-padded).
inline int block_cols(int build, int nc) {
  if (build & BIT_GRAT) return N_GRAT_COLS;
  if (build & BIT_NURBS) return nc;
  return build & BIT_CART ? nc + 2 : nc;
}

// Launch a launcher body for the build ``build``, one of Bs (the compiled
// builds): f gets the build as an std::integral_constant, so the body
// instantiates its kernels for it.
template <int B0, int... Bs, typename F>
int dispatch_in(int build, F&& f) {
  if (build == B0) return f(std::integral_constant<int, B0>{});
  if constexpr (sizeof...(Bs) > 0)
    return dispatch_in<Bs...>(build, static_cast<F&&>(f));
  else
    return (int)cudaErrorInvalidValue;
}
// The builds of every kernel, and (WITH_GRAT: the monochromatic kernels)
// the grating build.
template <bool WITH_GRAT = false, typename F>
int dispatch_build(int build, F&& f) {
  if constexpr (WITH_GRAT)
    return dispatch_in<B_STOCK, B_TILT, B_SAG, B_FREE, B_DEEP, B_DEEP_FREE,
                       B_AUX, B_DEEP_AUX, B_GRAT>(build, static_cast<F&&>(f));
  else
    return dispatch_in<B_STOCK, B_TILT, B_SAG, B_FREE, B_DEEP, B_DEEP_FREE,
                       B_AUX, B_DEEP_AUX>(build, static_cast<F&&>(f));
}

// The surface count, coefficient width and Newton steps a build takes.
template <int B>
bool shape_ok(int S, int nc, int niters) {
  return S >= 2 && S <= Build<B>::CAP && nc >= 1 &&
         nc <= (Build<B>::NURBS ? NC_NURBS : NC_MAX) && niters >= 0;
}

// Dynamic shared memory of a backward's per-warp rows: nw rows of ncomp
// where they are dynamic (DYN), none where they are static.
template <typename T, bool DYN>
size_t dyn_bytes(int nw, int ncomp) {
  return DYN ? (size_t)nw * ncomp * sizeof(T) : 0;
}

template <bool DYN, typename K>
int set_dyn_smem(K kernel, size_t bytes) {
  if constexpr (DYN)
    return (int)cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
  return 0;
}

// The Newton families: radial (sag_point) and Cartesian (cart_point).
__device__ __forceinline__ bool is_radial(int code) {
  return code == EVEN_ASPHERE || code == ODD_ASPHERE;
}
// The aux-bearing families, Cartesian too: their row is laid out
// (geometry.py: aux_layout) and read with the surface's layout rows.
__device__ __forceinline__ bool is_aux(int code) {
  return code == ZERNIKE_SAG || code == FORBES_QBFS || code == FORBES_Q2D;
}
__device__ __forceinline__ bool is_cart4(int code) {
  return code == POLYNOMIAL_XY || code == CHEBYSHEV || code == TOROIDAL ||
         code == BICONIC;
}
__device__ __forceinline__ bool is_cart(int code) {
  return is_cart4(code) || is_aux(code);
}
// The Cartesian families a build's step takes: the aux-bearing ones only
// where it has their evaluator (AUX).
template <bool AUX>
__device__ __forceinline__ bool is_cart_of(int code) {
  return AUX ? is_cart(code) : is_cart4(code);
}

// Surface s's rows of the (S, nc, LAY_COLS) layout table (null without
// one: no aux-bearing surface).
template <typename T>
__device__ __forceinline__ const T* lay_of(const T* lay, int s, int nc) {
  return lay ? lay + (int64_t)s * nc * LAY_COLS : nullptr;
}
__device__ __forceinline__ bool is_newton(int code) {
  return is_radial(code) || is_cart(code);
}
// The Newton families a build's step takes (the aux-bearing ones where
// AUX), so the other builds compile to the code they had before them.
template <bool AUX>
__device__ __forceinline__ bool is_newton_of(int code) {
  return is_radial(code) || is_cart_of<AUX>(code);
}

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
__device__ __forceinline__ float acos_(float v) { return acosf(v); }
__device__ __forceinline__ double acos_(double v) { return acos(v); }
__device__ __forceinline__ float pow_(float a, float b) { return powf(a, b); }
__device__ __forceinline__ float tan_(float v) { return tanf(v); }
__device__ __forceinline__ double tan_(double v) { return tan(v); }
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

// The radial terms of a Newton family at r2 = x^2 + y^2 (geometry.py:
// sag_point): s, W (ds/dx = x W), and with GRAD dW/dr2, ds/dcu, ds/dk,
// dW/dcu, dW/dk, rho (r2 even, r odd) and beta (dW/dC_i = (i+1) beta
// rho^i: 2 even, 1/r odd, 0 at r = 0, where the odd terms have no slope).
template <typename T>
struct SagPt {
  T s, W, Wr, s_cu, s_k, W_cu, W_k, rho, beta;
};

template <typename T, bool GRAD>
__device__ __forceinline__ void sag_point(int code, T cu, T k, const T* cf,
                                          int nc, T r2, SagPt<T>& o) {
  const T e = (T(1) + k) * (cu * cu);
  const T q = sqrt_(T(1) - e * r2);
  o.s = cu * r2 / (T(1) + q);
  o.W = cu / q;
  const bool even = code == EVEN_ASPHERE;
  const bool at0 = r2 == T(0);
  const T rho = even ? r2 : (at0 ? T(0) : sqrt_(r2));
  const T rs = (even || at0) ? T(1) : rho;
  T P = T(0), G1 = T(0);
  for (int i = nc - 1; i >= 0; --i) {
    P = P * rho + cf[i];
    G1 = G1 * rho + T(i + 1) * cf[i];
  }
  o.s = o.s + P * rho;
  if (even)
    o.W = o.W + T(2) * G1;
  else if (!at0)
    o.W = o.W + G1 / rs;
  if constexpr (GRAD) {
    // 2 g''(r2) (even); sum (i+1)(i-1) C_i r^i, over 2 r^3 below (odd)
    T H = T(0);
    for (int i = nc - 1; i >= (even ? 1 : 0); --i)
      H = H * rho + (even ? T(2 * i * (i + 1)) : T((i + 1) * (i - 1))) * cf[i];
    const T q3 = q * q * q;
    o.Wr = cu * e / (T(2) * q3);
    if (even) {
      o.Wr = o.Wr + H;
      o.beta = T(2);
    } else {
      if (!at0) o.Wr = o.Wr + H / (T(2) * (rs * rs * rs));
      o.beta = at0 ? T(0) : T(1) / rs;
    }
    const T cu3 = cu * cu * cu;
    o.s_cu = r2 / (q * (T(1) + q));
    o.s_k = cu3 * (r2 * r2) / (T(2) * q * ((T(1) + q) * (T(1) + q)));
    o.W_cu = T(1) / q3;
    o.W_k = cu3 * r2 / (T(2) * q3);
    o.rho = rho;
  }
}

// One Newton step t - f/f' (geometry.py: newton_step).
template <typename T>
__device__ __forceinline__ T newton_step(int code, T cu, T k, const T* cf,
                                         int nc, T xl, T yl, T zl, T L, T M,
                                         T N, T t) {
  const T X = xl + t * L, Y = yl + t * M;
  SagPt<T> sp;
  sag_point<T, false>(code, cu, k, cf, nc, X * X + Y * Y, sp);
  const T f = zl + t * N - sp.s;
  T fp = N - sp.W * (X * L + Y * M);
  fp = abs_(fp) > T(1e-14) ? fp : T(1e-14);
  return t - f / fp;
}

// ``steps`` Newton steps from the conic's closed form, or the plane's where
// that is not finite (geometry.py: newton_start).
template <typename T>
__device__ __forceinline__ T newton_t(int code, T R, T k, const T* cf, int nc,
                                      int steps, T xl, T yl, T zl, T L, T M,
                                      T N) {
  T t = dist_standard(R, k, xl, yl, zl, L, M, N);
  if (!isfinite(t)) t = dist_plane(zl, N);
  const T cu = T(1) / R;
  for (int it = 0; it < steps; ++it)
    t = newton_step(code, cu, k, cf, nc, xl, yl, zl, L, M, N, t);
  return t;
}

// ---------------------------------------------------------------------------
// K6b, the Cartesian Newton families (geometry.py: cart_point, the basis
// recurrences _basis_1d, the row sums _table_sums, coef_weights and
// coef_columns)
// ---------------------------------------------------------------------------

// Side of a POLYNOMIAL_XY or CHEBYSHEV table: ceil(sqrt(nc)).
__device__ __forceinline__ int table_side(int nc) {
  int s = 0;
  while (s * s < nc) ++s;
  return s;
}

// The reference's Chebyshev normal term dT_n(t) = n sin(n th) / D, th =
// acos(clip(t)), D = sqrt(max(1 - t^2, 1e-14)), and what its derivative
// reads: dD/dt and dth/dt, which is -rsqrt(1 - c^2) inside |t| < 1 and
// 0 inf = NaN outside (the clip's zero derivative times acos' infinite one,
// as in JAX).
template <typename T>
struct ChebN {
  T th, D, dD, dth;
};

template <typename T>
__device__ __forceinline__ void cheb_norm_prep(T t, ChebN<T>& c) {
  const bool in = abs_(t) < T(1);
  const T cl = in ? t : sign_(t);
  c.th = acos_(cl);
  const T omt = T(1) - t * t;
  c.D = sqrt_(omt > T(1e-14) ? omt : T(1e-14));
  c.dD = omt > T(1e-14) ? -t / c.D : T(0);
  c.dth = -rsqrt_(T(1) - cl * cl) * (in ? T(1) : T(0));
}

// The one-dimensional basis along one coordinate v, index by index
// (geometry.py: _basis_1d): f, f1, f2 (value, d/dv, d^2/dv^2); fp, f1p
// (d/dp of f and f1); with a ChebN, g, g1, gp (the normal term dT_n(t) and
// its d/dv, d/dp). POLYNOMIAL_XY: v^n by f_{n+1} = v f_n, f1_{n+1} = v f1_n
// + f_n, f2_{n+1} = v f2_n + 2 f1_n; CHEBYSHEV: T_n(t), t = v / p, by the
// recurrences of T, T', T'' from T_-1 = t, T'_-1 = 1, T''_-1 = 0.
template <typename T>
struct Basis1 {
  bool cheb;
  int n;
  T v, p, t;
  T c0, c1, c2;  // f, f1, f2 (CHEBYSHEV: T, T', T'' in t)
  T q0, q1, q2;  // the previous index's (CHEBYSHEV)

  __device__ __forceinline__ void start(bool ch, T v_, T p_) {
    cheb = ch;
    n = 0;
    v = v_;
    p = p_;
    t = ch ? v_ / p_ : T(0);
    c0 = T(1);
    c1 = T(0);
    c2 = T(0);
    q0 = t;
    q1 = T(1);
    q2 = T(0);
  }
  __device__ __forceinline__ void next() {
    if (cheb) {
      const T n0 = T(2) * t * c0 - q0;
      const T n1 = T(2) * c0 + T(2) * t * c1 - q1;
      const T n2 = T(4) * c1 + T(2) * t * c2 - q2;
      q0 = c0;
      q1 = c1;
      q2 = c2;
      c0 = n0;
      c1 = n1;
      c2 = n2;
    } else {
      const T n2 = v * c2 + T(2) * c1;
      c1 = v * c1 + c0;
      c0 = v * c0;
      c2 = n2;
    }
    ++n;
  }
  __device__ __forceinline__ T f() const { return c0; }
  __device__ __forceinline__ T f1() const { return cheb ? c1 / p : c1; }
  __device__ __forceinline__ T f2() const { return cheb ? c2 / (p * p) : c2; }
  __device__ __forceinline__ T fp() const { return cheb ? -t * f1() : T(0); }
  __device__ __forceinline__ T f1p() const {
    return cheb ? -t * f2() - f1() / p : T(0);
  }
  // the normal term and its derivatives (CHEBYSHEV)
  __device__ __forceinline__ T g(const ChebN<T>& c) const {
    return n == 0 ? T(0) : T(n) * sin_(T(n) * c.th) / c.D;
  }
  __device__ __forceinline__ T g1(const ChebN<T>& c) const {
    if (n == 0) return T(0);
    const T num = T(n) * sin_(T(n) * c.th);
    const T dd = T(n * n) * cos_(T(n) * c.th) * c.dth / c.D -
                 num * c.dD / (c.D * c.D);
    return dd / p;
  }
  __device__ __forceinline__ T gp(const ChebN<T>& c) const {
    return -t * g1(c);
  }
};

// The table's sums at (X, Y) (geometry.py: _table_sums), row by row: each
// row i summed over j with the y basis, then weighted by the x basis at i.
// NORMAL (CHEBYSHEV): the reference's normal terms in place of Px, Py.
template <typename T>
struct TabS {
  T P, Px, Py, Pxx, Pxy, Pyx, Pyy, Pp1, Pp2, Pxp1, Pxp2, Pyp1, Pyp2;
};

template <typename T, bool GRAD, bool NORMAL>
__device__ __forceinline__ void table_sums(int code, const T* cf, int nc,
                                           T p1, T p2, T X, T Y, TabS<T>& o) {
  const int side = table_side(nc);
  const bool cheb = code == CHEBYSHEV;
  const bool nx = NORMAL && cheb;
  ChebN<T> chx = {}, chy = {};
  if (nx) {
    cheb_norm_prep(X / p1, chx);
    cheb_norm_prep(Y / p2, chy);
  }
  o = TabS<T>{};
  Basis1<T> bx;
  bx.start(cheb, X, p1);
  for (int i = 0; i < side && i * side < nc; ++i) {
    T rf = T(0), rf1 = T(0), rf2 = T(0), rfp = T(0), rf1p = T(0);
    T rg = T(0), rg1 = T(0), rgp = T(0);
    Basis1<T> by;
    by.start(cheb, Y, p2);
    for (int j = 0; j < side && i * side + j < nc; ++j) {
      const T C = cf[i * side + j];
      rf = rf + C * by.f();
      rf1 = rf1 + C * by.f1();
      if (GRAD) {
        rf2 = rf2 + C * by.f2();
        rfp = rfp + C * by.fp();
        rf1p = rf1p + C * by.f1p();
      }
      if (nx) {
        rg = rg + C * by.g(chy);
        if (GRAD) {
          rg1 = rg1 + C * by.g1(chy);
          rgp = rgp + C * by.gp(chy);
        }
      }
      by.next();
    }
    o.P = o.P + bx.f() * rf;
    if (nx) {
      const T gx = bx.g(chx);
      o.Px = o.Px + gx * rf;
      o.Py = o.Py + bx.f() * rg;
      if (GRAD) {
        o.Pxx = o.Pxx + bx.g1(chx) * rf;
        o.Pxy = o.Pxy + gx * rf1;
        o.Pyx = o.Pyx + bx.f1() * rg;
        o.Pyy = o.Pyy + bx.f() * rg1;
        o.Pp1 = o.Pp1 + bx.fp() * rf;
        o.Pp2 = o.Pp2 + bx.f() * rfp;
        o.Pxp1 = o.Pxp1 + bx.gp(chx) * rf;
        o.Pxp2 = o.Pxp2 + gx * rfp;
        o.Pyp1 = o.Pyp1 + bx.fp() * rg;
        o.Pyp2 = o.Pyp2 + bx.f() * rgp;
      }
    } else {
      o.Px = o.Px + bx.f1() * rf;
      o.Py = o.Py + bx.f() * rf1;
      if (GRAD) {
        o.Pxx = o.Pxx + bx.f2() * rf;
        o.Pxy = o.Pxy + bx.f1() * rf1;
        o.Pyx = o.Pyx + bx.f1() * rf1;
        o.Pyy = o.Pyy + bx.f() * rf2;
        o.Pp1 = o.Pp1 + bx.fp() * rf;
        o.Pp2 = o.Pp2 + bx.f() * rfp;
        o.Pxp1 = o.Pxp1 + bx.f1p() * rf;
        o.Pxp2 = o.Pxp2 + bx.f1() * rfp;
        o.Pyp1 = o.Pyp1 + bx.fp() * rf1;
        o.Pyp2 = o.Pyp2 + bx.f() * rf1p;
      }
    }
    bx.next();
  }
}

// A Cartesian family's sag and slopes at (X, Y) (geometry.py:
// cart_point): s, sx, sy; NORMAL: the normal's slopes (CHEBYSHEV's
// reference convention). GRAD: hxx = d sx/dX, hxy = d sx/dY, hyx = d sy/dX,
// hyy = d sy/dY, the (s, sx, sy) derivatives with respect to the radius,
// the conic, p1 and p2, and TOROIDAL's zy = (ds, dsx, dsy, dsy') of its
// profile z_y and of z_y'.
template <typename T>
struct CartPt {
  T s, sx, sy;
  T hxx, hxy, hyx, hyy;
  T dR[3], dk[3], dp1[3], dp2[3];
  T zy[4];
};

template <typename T>
__device__ __forceinline__ T inv_radius(T r) {
  return isinf(r) ? T(0) : T(1) / r;
}

// K6b, the aux-bearing families (geometry.py: _aux_point, _slot_terms,
// _conic_factor_terms). The surface's laid-out row cf holds nc slots, read
// with its layout rows ``lay`` (global memory, the same entry for every
// lane: one broadcast read through the read-only cache). Slot j's radial
// function phi_j(v) follows phi_j = (a + b v) phi_(j-1) - c phi_(j-2) + e
// (times v (1 - v) where its flag says ``pre``), its angular factor is Re
// or Im of z^m, z = (X + iY) / p1, v = (X^2 + Y^2 + eps) / p1^2; the powers
// of z run up with the blocks' m, which come in order. A Forbes surface
// multiplies the slots' sum by its conic factor Phi(r^2) and cuts it past
// v = 1, on its clamped base conic; a Zernike surface has the
// curvature-form conic and no Zernike slope at exactly r = 0 (the
// reference's guarded origin).

template <typename T>
__device__ __forceinline__ T ldg_(const T* p) {
  return __ldg(p);
}

// The running slot recurrences at one point: start(), then next() per slot
// in order gives the slot's A = (A, Ax, Ay[, Axx, Axy, Ayy]) and F = (F,
// F1[, F2]), the derivatives of F in v.
template <typename T, bool GRAD>
struct AuxSlots {
  T v, ip, zr, zi;
  T P0r, P0i, P1r, P1i, P2r, P2i;  // z^m, z^(m-1), z^(m-2)
  T f1, f2, d1, d2, e1, e2;        // phi, phi', phi'' of j-1, j-2
  int mc, m;
  T A[6], F[3];
  __device__ __forceinline__ void start(T X, T Y, T p1, T eps) {
    v = (X * X + Y * Y + eps) / (p1 * p1);
    ip = T(1) / p1;
    zr = X * ip;
    zi = Y * ip;
    P0r = T(1);
    P0i = P1r = P1i = P2r = P2i = T(0);
    f1 = f2 = d1 = d2 = e1 = e2 = T(0);
    mc = 0;
  }
  __device__ __forceinline__ void next(const T* lrow) {
    const T a = ldg_(lrow), b = ldg_(lrow + 1), c = ldg_(lrow + 2),
            e = ldg_(lrow + 3);
    const int flag = (int)ldg_(lrow + 4);
    m = flag >> 2;
    while (mc < m) {
      P2r = P1r;
      P2i = P1i;
      P1r = P0r;
      P1i = P0i;
      const T r = P0r * zr - P0i * zi;
      P0i = P0r * zi + P0i * zr;
      P0r = r;
      ++mc;
    }
    const T g = a + b * v;
    const T ph = g * f1 - c * f2 + e;
    const T dph = b * f1 + g * d1 - c * d2;
    T ddph = T(0);
    if constexpr (GRAD) {
      ddph = T(2) * b * d1 + g * e1 - c * e2;
      e2 = e1;
      e1 = ddph;
    }
    f2 = f1;
    f1 = ph;
    d2 = d1;
    d1 = dph;
    if (flag & 1) {
      const T w = v * (T(1) - v), w1 = T(1) - T(2) * v;
      F[0] = w * ph;
      F[1] = w1 * ph + w * dph;
      if constexpr (GRAD) F[2] = T(-2) * ph + T(2) * w1 * dph + w * ddph;
    } else {
      F[0] = ph;
      F[1] = dph;
      if constexpr (GRAD) F[2] = ddph;
    }
    const T k1 = T(m) * ip, k2 = T(m * (m - 1)) * ip * ip;
    if (flag & 2) {
      A[0] = P0i;
      A[1] = k1 * P1i;
      A[2] = k1 * P1r;
      if constexpr (GRAD) {
        A[3] = k2 * P2i;
        A[4] = k2 * P2r;
        A[5] = -k2 * P2i;
      }
    } else {
      A[0] = P0r;
      A[1] = k1 * P1r;
      A[2] = -k1 * P1i;
      if constexpr (GRAD) {
        A[3] = k2 * P2r;
        A[4] = -k2 * P2i;
        A[5] = -k2 * P2r;
      }
    }
  }
};

// The Forbes conic factor Phi(r^2) = sqrt(num / den) and its derivatives
// (Phi, Phi_r, Phi_rr, Phi_k, Phi_rk, Phi_c, Phi_rc; r for r^2, c for
// cu^2); a radicand clamped at 1e-12 passes no derivative.
template <typename T>
__device__ __forceinline__ void conic_factor_terms(T cu, T k, T r2, T* o) {
  const T c2 = cu * cu;
  const T nr = T(1) - k * c2 * r2, dr = T(1) - (k + T(1)) * c2 * r2;
  const T mn = nr > T(1e-12) ? T(1) : T(0), md = dr > T(1e-12) ? T(1) : T(0);
  const T num = nr > T(1e-12) ? nr : T(1e-12);
  const T den = dr > T(1e-12) ? dr : T(1e-12);
  const T Phi = sqrt_(num) / sqrt_(den);
  const T n_r = -k * c2 * mn, d_r = -(k + T(1)) * c2 * md;
  const T a = n_r / num, b = d_r / den;
  const T g = (a - b) / T(2);
  o[0] = Phi;
  o[1] = Phi * g;
  o[2] = Phi * (g * g + (b * b - a * a) / T(2));
  // d/dk, then d/d(cu^2)
  const T nv[2] = {-c2 * r2 * mn, -k * r2 * mn};
  const T dv[2] = {-c2 * r2 * md, -(k + T(1)) * r2 * md};
  const T nrv[2] = {-c2 * mn, -k * mn};
  const T drv[2] = {-c2 * md, -(k + T(1)) * md};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const T gv = (nv[i] / num - dv[i] / den) / T(2);
    const T g_v =
        (nrv[i] / num - a * nv[i] / num - drv[i] / den + b * dv[i] / den) /
        T(2);
    o[3 + 2 * i] = Phi * gv;
    o[4 + 2 * i] = Phi * (gv * g + g_v);
  }
}

// cart_point of an aux-bearing family, out of line: the four other
// Cartesian families do not carry its registers. o.zy holds the weights
// coef_weights reads: of s, then 2 X Phi_r and 2 Y Phi_r, then of the
// slopes.
template <typename T, bool GRAD>
__device__ __noinline__ void aux_point_call(int code, T R, T k, T p1,
                                            const T* cf, const T* lay,
                                            int nc, T X, T Y, CartPt<T>* out) {
  CartPt<T>& o = *out;
  const bool zern = code == ZERNIKE_SAG;
  const T r2 = X * X + Y * Y;
  const T cu = zern ? T(1) / R : inv_radius(R);
  const T e = (T(1) + k) * (cu * cu);
  const T vq = T(1) - e * r2;
  const T q0 = sqrt_(zern || vq > T(0) ? vq : T(0));
  const T W = !zern && q0 == T(0) ? nan_<T>() : cu / q0;
  const T eps = code == FORBES_Q2D ? T(Q2D_EPS) : T(0);
  const T p12 = p1 * p1;
  const T vx = T(2) * X / p12, vy = T(2) * Y / p12, vxx = T(2) / p12;
  AuxSlots<T, GRAD> sl;
  sl.start(X, Y, p1, eps);
  const T v = sl.v;
  T S = T(0), Sx = T(0), Sy = T(0), Sxx = T(0), Sxy = T(0), Syy = T(0);
  T Sp = T(0), Sxp = T(0), Syp = T(0);
  for (int j = 0; j < nc; ++j) {
    sl.next(lay + j * LAY_COLS);
    const T c = cf[j];
    const T* A = sl.A;
    const T* F = sl.F;
    S += c * (A[0] * F[0]);
    Sx += c * (A[1] * F[0] + A[0] * F[1] * vx);
    Sy += c * (A[2] * F[0] + A[0] * F[1] * vy);
    if constexpr (GRAD) {
      Sxx += c * (A[3] * F[0] + T(2) * A[1] * F[1] * vx +
                  A[0] * F[2] * vx * vx + A[0] * F[1] * vxx);
      Sxy += c * (A[4] * F[0] + A[1] * F[1] * vy + A[2] * F[1] * vx +
                  A[0] * F[2] * vx * vy);
      Syy += c * (A[5] * F[0] + T(2) * A[2] * F[1] * vy +
                  A[0] * F[2] * vy * vy + A[0] * F[1] * vxx);
      const T m = T(sl.m);
      Sp -= c * (m * A[0] * F[0] + T(2) * v * A[0] * F[1]) / p1;
      Sxp -= c *
             (m * A[1] * F[0] + T(2) * v * A[1] * F[1] + m * A[0] * F[1] * vx +
              T(2) * v * A[0] * F[2] * vx + T(2) * A[0] * F[1] * vx) /
             p1;
      Syp -= c *
             (m * A[2] * F[0] + T(2) * v * A[2] * F[1] + m * A[0] * F[1] * vy +
              T(2) * v * A[0] * F[2] * vy + T(2) * A[0] * F[1] * vy) /
             p1;
    }
  }
  const bool at0 = zern && r2 == T(0);
  if (at0) Sx = Sy = Sxx = Sxy = Syy = Sxp = Syp = T(0);
  T ph[7] = {T(1), T(0), T(0), T(0), T(0), T(0), T(0)};
  if (!zern) {
    conic_factor_terms(cu, k, r2, ph);
    const T keep = v <= T(1) ? T(1) : T(0);
#pragma unroll
    for (int i = 0; i < 7; ++i) ph[i] *= keep;
  }
  const T Phi = ph[0], Pr = ph[1];
  o.s = cu * r2 / (T(1) + q0) + Phi * S;
  o.sx = X * W + T(2) * X * Pr * S + Phi * Sx;
  o.sy = Y * W + T(2) * Y * Pr * S + Phi * Sy;
  if constexpr (GRAD) {
    const T Prr = ph[2], Pk = ph[3], Prk = ph[4], Pc = ph[5], Prc = ph[6];
    o.zy[0] = Phi;
    o.zy[1] = T(2) * X * Pr;
    o.zy[2] = T(2) * Y * Pr;
    o.zy[3] = at0 ? T(0) : Phi;
    const T q3 = q0 * q0 * q0;
    const T Wr = cu * e / (T(2) * q3);
    o.hxx = W + T(2) * X * X * Wr + T(2) * Pr * S + T(4) * X * X * Prr * S +
            T(4) * X * Pr * Sx + Phi * Sxx;
    o.hxy = T(2) * X * Y * Wr + T(4) * X * Y * Prr * S + T(2) * X * Pr * Sy +
            T(2) * Y * Pr * Sx + Phi * Sxy;
    o.hyx = o.hxy;
    o.hyy = W + T(2) * Y * Y * Wr + T(2) * Pr * S + T(4) * Y * Y * Prr * S +
            T(4) * Y * Pr * Sy + Phi * Syy;
    const T mcu2 = -cu * cu;      // d cu / dR
    const T dc2 = T(2) * cu * mcu2;  // d cu^2 / dR
    o.dR[0] = mcu2 * r2 / (q0 * (T(1) + q0)) + dc2 * Pc * S;
    o.dR[1] = mcu2 * X / q3 + dc2 * (T(2) * X * Prc * S + Pc * Sx);
    o.dR[2] = mcu2 * Y / q3 + dc2 * (T(2) * Y * Prc * S + Pc * Sy);
    const T cu3 = cu * cu * cu;
    const T Wk = cu3 * r2 / (T(2) * q3);
    o.dk[0] = cu3 * (r2 * r2) / (T(2) * q0 * ((T(1) + q0) * (T(1) + q0))) +
              Pk * S;
    o.dk[1] = X * Wk + T(2) * X * Prk * S + Pk * Sx;
    o.dk[2] = Y * Wk + T(2) * Y * Prk * S + Pk * Sy;
    o.dp1[0] = Phi * Sp;
    o.dp1[1] = T(2) * X * Pr * Sp + Phi * Sxp;
    o.dp1[2] = T(2) * Y * Pr * Sp + Phi * Syp;
    o.dp2[0] = o.dp2[1] = o.dp2[2] = T(0);
  }
}

template <typename T, bool GRAD, bool NORMAL, bool AUX = false>
__device__ __forceinline__ void cart_point(int code, T R, T k, T p1, T p2,
                                           const T* cf, const T* lay, int nc,
                                           T X, T Y, CartPt<T>& o) {
  const T nan = nan_<T>();
  if constexpr (AUX) {
    if (is_aux(code)) {
      // through a copy of its own: ``o`` stays out of local memory for the
      // other families when cart_point is inlined
      CartPt<T> ao;
      aux_point_call<T, GRAD>(code, R, k, p1, cf, lay, nc, X, Y, &ao);
      o = ao;
      return;
    }
  }
  if (code == POLYNOMIAL_XY || code == CHEBYSHEV) {
    const T cu = T(1) / R;
    const T e = (T(1) + k) * (cu * cu);
    const T r2 = X * X + Y * Y;
    const T q = sqrt_(T(1) - e * r2);
    const T W = cu / q;
    TabS<T> tb;
    table_sums<T, GRAD, NORMAL>(code, cf, nc, p1, p2, X, Y, tb);
    o.s = cu * r2 / (T(1) + q) + tb.P;
    o.sx = X * W + tb.Px;
    o.sy = Y * W + tb.Py;
    if constexpr (GRAD) {
      const T q3 = q * q * q;
      const T Wr = cu * e / (T(2) * q3);
      o.hxx = W + T(2) * X * X * Wr + tb.Pxx;
      o.hxy = T(2) * X * Y * Wr + tb.Pxy;
      o.hyx = T(2) * X * Y * Wr + tb.Pyx;
      o.hyy = W + T(2) * Y * Y * Wr + tb.Pyy;
      const T mcu2 = -cu * cu;
      o.dR[0] = mcu2 * r2 / (q * (T(1) + q));
      o.dR[1] = mcu2 * X / q3;
      o.dR[2] = mcu2 * Y / q3;
      const T cu3 = cu * cu * cu;
      const T Wk = cu3 * r2 / (T(2) * q3);
      o.dk[0] = cu3 * (r2 * r2) / (T(2) * q * ((T(1) + q) * (T(1) + q)));
      o.dk[1] = X * Wk;
      o.dk[2] = Y * Wk;
      o.dp1[0] = tb.Pp1;
      o.dp1[1] = tb.Pxp1;
      o.dp1[2] = tb.Pyp1;
      o.dp2[0] = tb.Pp2;
      o.dp2[1] = tb.Pxp2;
      o.dp2[2] = tb.Pyp2;
    }
    return;
  }
  if (code == BICONIC) {
    const T cx = inv_radius(R), cy = inv_radius(p1);
    const T vx = T(1) - (T(1) + k) * (cx * cx) * (X * X);
    const T vy = T(1) - (T(1) + p2) * (cy * cy) * (Y * Y);
    const T qx = sqrt_(vx > T(0) ? vx : T(0));
    const T qy = sqrt_(vy > T(0) ? vy : T(0));
    const bool clamped = qx == T(0) || qy == T(0);
    o.s = cx * (X * X) / (T(1) + qx) + cy * (Y * Y) / (T(1) + qy);
    o.sx = clamped ? nan : cx * X / qx;
    o.sy = clamped ? nan : cy * Y / qy;
    if constexpr (GRAD) {
      const T qx3 = qx * qx * qx, qy3 = qy * qy * qy;
      o.hxx = cx / qx3;
      o.hxy = T(0);
      o.hyx = T(0);
      o.hyy = cy / qy3;
      const T mcx2 = -cx * cx, mcy2 = -cy * cy;
      const T cx3 = cx * cx * cx, cy3 = cy * cy * cy;
      const T X2 = X * X, Y2 = Y * Y;
      o.dR[0] = mcx2 * X2 / (qx * (T(1) + qx));
      o.dR[1] = mcx2 * X / qx3;
      o.dR[2] = T(0);
      o.dk[0] = cx3 * (X2 * X2) / (T(2) * qx * ((T(1) + qx) * (T(1) + qx)));
      o.dk[1] = X * cx3 * X2 / (T(2) * qx3);
      o.dk[2] = T(0);
      o.dp1[0] = mcy2 * Y2 / (qy * (T(1) + qy));
      o.dp1[1] = T(0);
      o.dp1[2] = mcy2 * Y / qy3;
      o.dp2[0] = cy3 * (Y2 * Y2) / (T(2) * qy * ((T(1) + qy) * (T(1) + qy)));
      o.dp2[1] = T(0);
      o.dp2[2] = Y * cy3 * Y2 / (T(2) * qy3);
    }
    return;
  }
  // TOROIDAL: the profile z_y(Y), its derivatives, and theirs in cy, p2
  const T cy = inv_radius(p1);
  const T Y2 = Y * Y;
  const T vy = T(1) - (T(1) + p2) * (cy * cy) * Y2;
  const T qy = sqrt_(vy > T(0) ? vy : T(0));
  T A = T(0), A1 = T(0), A2 = T(0);
  for (int i = nc - 1; i >= 0; --i) {
    A = A * Y2 + cf[i];
    A1 = A1 * Y2 + T(2 * i + 2) * cf[i];
    A2 = A2 * Y2 + T((2 * i + 2) * (2 * i + 1)) * cf[i];
  }
  const T zy = cy * Y2 / (T(1) + qy) + A * Y2;
  const T zy1 = (qy == T(0) ? nan : cy * Y / qy) + A1 * Y;
  const bool cyl = isinf(R);
  const T D = R - zy;
  const T inside = D * D - X * X;
  const T sq = sqrt_(inside < T(0) ? nan : inside);
  const T sg = sign_(D);
  const T G = sg * D / sq;
  o.s = cyl ? zy : zy + D - sg * sq;
  o.sx = qy == T(0) ? nan : (cyl ? T(0) : sg * X / sq);
  o.sy = cyl ? zy1 : G * zy1;
  if constexpr (GRAD) {
    if (cyl) {
      // the JAX package's branch not taken: 0 inf = NaN in every
      // derivative that reaches R or z_y
      o.hxx = o.hxy = o.hyx = o.hyy = nan;
      for (int c = 0; c < 3; ++c) {
        o.dR[c] = o.dp1[c] = o.dp2[c] = nan;
        o.dk[c] = T(0);
      }
      for (int c = 0; c < 4; ++c) o.zy[c] = nan;
      return;
    }
    const T qy3 = qy * qy * qy;
    const T zy2 = cy / qy3 + A2;
    const T sq3 = sq * sq * sq;
    o.zy[0] = G;
    o.zy[1] = sg * X * D / sq3;
    o.zy[2] = sg * X * X * zy1 / sq3;
    o.zy[3] = G;
    o.hxx = sg * D * D / sq3;
    o.hxy = sg * X * D * zy1 / sq3;
    o.hyx = o.hxy;
    o.hyy = zy2 * G + sg * X * X * zy1 * zy1 / sq3;
    o.dR[0] = T(1) - G;
    o.dR[1] = -o.zy[1];
    o.dR[2] = -o.zy[2];
    o.dk[0] = o.dk[1] = o.dk[2] = T(0);
    const T cy3 = cy * cy * cy;
    const T zy_cy = Y2 / (qy * (T(1) + qy)), zy1_cy = Y / qy3;
    const T zy_p2 =
        cy3 * (Y2 * Y2) / (T(2) * qy * ((T(1) + qy) * (T(1) + qy)));
    const T zy1_p2 = Y * cy3 * Y2 / (T(2) * qy3);
    const T mcy2 = -cy * cy;
    o.dp1[0] = mcy2 * (o.zy[0] * zy_cy);
    o.dp1[1] = mcy2 * (o.zy[1] * zy_cy);
    o.dp1[2] = mcy2 * (o.zy[2] * zy_cy + o.zy[3] * zy1_cy);
    o.dp2[0] = o.zy[0] * zy_p2;
    o.dp2[1] = o.zy[1] * zy_p2;
    o.dp2[2] = o.zy[2] * zy_p2 + o.zy[3] * zy1_p2;
  }
}

// One Newton step t - f/f' of a Cartesian family, f' = N - (sx L + sy M)
// (geometry.py: newton_step).
template <typename T, bool AUX = false>
__device__ __forceinline__ T cart_newton_step(int code, T R, T k, T p1,
                                              T p2, const T* cf,
                                              const T* lay, int nc, T xl,
                                              T yl, T zl, T L, T M, T N,
                                              T t) {
  const T X = xl + t * L, Y = yl + t * M;
  CartPt<T> cp;
  cart_point<T, false, false, AUX>(code, R, k, p1, p2, cf, lay, nc, X, Y,
                                   cp);
  T fp = N - (cp.sx * L + cp.sy * M);
  const T f = zl + t * N - cp.s;
  fp = abs_(fp) > T(1e-14) ? fp : T(1e-14);
  return t - f / fp;
}

// ``steps`` Newton steps of a Cartesian family from the conic's closed form
// of the surface's radius and conic (the plane's where not finite).
template <typename T, bool AUX = false>
__device__ __forceinline__ T cart_newton_t(int code, T R, T k, T p1, T p2,
                                           const T* cf, const T* lay, int nc,
                                           int steps, T xl, T yl, T zl, T L,
                                           T M, T N) {
  T t = dist_standard(R, k, xl, yl, zl, L, M, N);
  if (!isfinite(t)) t = dist_plane(zl, N);
  for (int it = 0; it < steps; ++it)
    t = cart_newton_step<T, AUX>(code, R, k, p1, p2, cf, lay, nc, xl, yl, zl,
                                 L, M, N, t);
  return t;
}

// The weights (a, b, c) of a Cartesian family's coefficient cotangents at
// a point from the cotangents of its s, sx, sy (geometry.py: coef_weights).
template <typename T, bool AUX = false>
__device__ __forceinline__ void coef_weights(int code, const CartPt<T>& cp,
                                             T g_s, T g_sx, T g_sy, T* w) {
  if (code == TOROIDAL) {
    w[0] = g_s * cp.zy[0] + g_sx * cp.zy[1] + g_sy * cp.zy[2];
    w[1] = g_sy * cp.zy[3];
    w[2] = T(0);
  } else if (AUX && is_aux(code)) {
    w[0] = g_s * cp.zy[0] + g_sx * cp.zy[1] + g_sy * cp.zy[2];
    w[1] = g_sx * cp.zy[3];
    w[2] = g_sy * cp.zy[3];
  } else if (code == BICONIC) {
    w[0] = w[1] = w[2] = T(0);
  } else {
    w[0] = g_s;
    w[1] = g_sx;
    w[2] = g_sy;
  }
}


// The Cartesian work of the deep_free build's step sits out of line (CALL):
// one copy per kernel instead of one inlined at each of the deep step's
// call sites, which halves nvcc's time (202 s to 105 s for five builds on
// the H100 machine, PERF.md). ptxas still sizes a kernel for its callees,
// so the deep_free adjoints hold more registers than the deep ones, which
// carry no Cartesian branch.
// The aux builds' calls take the layout rows too (the *_aux_call
// functions); the deep_free build's keep the signature they had before the
// aux-bearing families, so it compiles to the same code.
template <typename T, bool GRAD, bool NORMAL>
__device__ __noinline__ void cart_point_call(int code, T R, T k, T p1, T p2,
                                             const T* cf, int nc, T X, T Y,
                                             CartPt<T>* o) {
  cart_point<T, GRAD, NORMAL>(code, R, k, p1, p2, cf, nullptr, nc, X, Y, *o);
}
template <typename T, bool GRAD, bool NORMAL>
__device__ __noinline__ void cart_point_aux_call(int code, T R, T k, T p1,
                                                 T p2, const T* cf,
                                                 const T* lay, int nc, T X,
                                                 T Y, CartPt<T>* o) {
  cart_point<T, GRAD, NORMAL, true>(code, R, k, p1, p2, cf, lay, nc, X, Y,
                                    *o);
}

template <typename T>
__device__ __noinline__ T cart_newton_t_call(int code, T R, T k, T p1, T p2,
                                             const T* cf, int nc, int steps,
                                             T xl, T yl, T zl, T L, T M,
                                             T N) {
  return cart_newton_t<T>(code, R, k, p1, p2, cf, nullptr, nc, steps, xl, yl,
                          zl, L, M, N);
}
template <typename T>
__device__ __noinline__ T cart_newton_t_aux_call(int code, T R, T k, T p1,
                                                 T p2, const T* cf,
                                                 const T* lay, int nc,
                                                 int steps, T xl, T yl, T zl,
                                                 T L, T M, T N) {
  return cart_newton_t<T, true>(code, R, k, p1, p2, cf, lay, nc, steps, xl,
                                yl, zl, L, M, N);
}

// cart_point, in line or (CALL) out of line.
template <typename T, bool GRAD, bool NORMAL, bool CALL, bool AUX>
__device__ __forceinline__ void cart_point_at(int code, T R, T k, T p1, T p2,
                                              const T* cf, const T* lay,
                                              int nc, T X, T Y,
                                              CartPt<T>& o) {
  if constexpr (CALL && AUX)
    cart_point_aux_call<T, GRAD, NORMAL>(code, R, k, p1, p2, cf, lay, nc, X,
                                         Y, &o);
  else if constexpr (CALL)
    cart_point_call<T, GRAD, NORMAL>(code, R, k, p1, p2, cf, nc, X, Y, &o);
  else
    cart_point<T, GRAD, NORMAL, AUX>(code, R, k, p1, p2, cf, lay, nc, X, Y,
                                     o);
}

// cart_newton_t, in line or (CALL) out of line.
template <typename T, bool CALL, bool AUX>
__device__ __forceinline__ T cart_newton_at(int code, T R, T k, T p1, T p2,
                                            const T* cf, const T* lay,
                                            int nc, int steps, T xl, T yl,
                                            T zl, T L, T M, T N) {
  if constexpr (CALL && AUX)
    return cart_newton_t_aux_call(code, R, k, p1, p2, cf, lay, nc, steps, xl,
                                  yl, zl, L, M, N);
  else if constexpr (CALL)
    return cart_newton_t_call(code, R, k, p1, p2, cf, nc, steps, xl, yl, zl,
                              L, M, N);
  else
    return cart_newton_t<T, AUX>(code, R, k, p1, p2, cf, lay, nc, steps, xl,
                                 yl, zl, L, M, N);
}

// ---------------------------------------------------------------------------
// K6c: grating diffraction (ops/step.py's grating branch, kernels.py's
// grating_vector and grating_diffract)
// ---------------------------------------------------------------------------

// The forward intermediates of a grating surface, which its adjoint reads.
template <typename T>
struct Grat {
  T f[3];                 // the groove vector
  T t[3], g[3], gmag;     // STANDARD: the groove tangent, n x t, |n x t|
  T tmag, ta, dzd, den, sqq, qg, r2;
  T ff, ffc, deff, fn, kv[3], P[3], D, rad, root, npost;
  bool ok;                // the order propagates
};

// max(v, lo) with a NaN kept (jnp.maximum, torch.clamp)
template <typename T>
__device__ __forceinline__ T clamp_lo(T v, T lo) {
  return v < lo ? lo : v;
}

// The groove vector of a grating of groove angle p[P_G2] at local (x1, y1)
// (n0: the raw, unflipped normal), d_eff, the tangential momentum P, its
// root and D = d_eff n_post (n_post = n_pre on a reflective grating), and
// the diffracted directions (Lo, Mo, No); (nx, ny, nz) is the normal
// aligned against the ray.
template <typename T>
__device__ __forceinline__ void grat_fwd(int code, int refl, T R, T k,
                                         const T* p, T x1, T y1, T nx0,
                                         T ny0, T nz0, T L, T M, T N, T nx,
                                         T ny, T nz, T adot, T n_pre,
                                         T npost, Grat<T>& G, T& Lo, T& Mo,
                                         T& No) {
  const T al = p[P_G2];
  if (code == STANDARD) {
    G.r2 = x1 * x1 + y1 * y1;
    G.qg = T(1) - (T(1) + k) * G.r2 / (R * R);
    G.sqq = sqrt_(clamp_lo(G.qg, T(1e-14)));
    G.den = R * G.sqq;
    G.ta = tan_(al);
    G.dzd = (x1 + y1 * G.ta) / G.den;
    G.tmag = sqrt_(T(1) + G.ta * G.ta + G.dzd * G.dzd);
    G.t[0] = T(1) / G.tmag;
    G.t[1] = G.ta / G.tmag;
    G.t[2] = G.dzd / G.tmag;
    G.g[0] = ny0 * G.t[2] - nz0 * G.t[1];
    G.g[1] = -nx0 * G.t[2] + nz0 * G.t[0];
    G.g[2] = nx0 * G.t[1] - ny0 * G.t[0];
    G.gmag = sqrt_(G.g[0] * G.g[0] + G.g[1] * G.g[1] + G.g[2] * G.g[2]);
    G.f[0] = -G.g[0] / G.gmag;
    G.f[1] = -G.g[1] / G.gmag;
    G.f[2] = -G.g[2] / G.gmag;
  } else {
    G.f[0] = -sin_(al);
    G.f[1] = cos_(al);
    G.f[2] = T(0);
  }
  G.ff = G.f[0] * G.f[0] + G.f[1] * G.f[1];
  G.ffc = clamp_lo(G.ff, T(1e-12));
  G.deff = p[P_G1] / sqrt_(G.ffc);
  G.npost = refl ? n_pre : npost;
  G.fn = G.f[0] * nx + G.f[1] * ny + G.f[2] * nz;
  const T mlam = p[P_MLAM];
  const T n[3] = {nx, ny, nz};
  G.kv[0] = L - adot * nx;
  G.kv[1] = M - adot * ny;
  G.kv[2] = N - adot * nz;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    G.P[j] = G.deff * n_pre * G.kv[j] + mlam * (G.f[j] - G.fn * n[j]);
  G.D = G.deff * G.npost;
  G.rad = G.D * G.D - (G.P[0] * G.P[0] + G.P[1] * G.P[1] + G.P[2] * G.P[2]);
  G.ok = G.rad >= T(0);
  G.root = G.ok ? sqrt_(G.rad) : T(0);
  const T sp = refl ? T(-1) : T(1);
  Lo = (sp * G.P[0] + nx * G.root) / G.D;
  Mo = (sp * G.P[1] + ny * G.root) / G.D;
  No = (sp * G.P[2] + nz * G.root) / G.D;
}

// Reverse of grat_fwd for the cotangents gi of (Lo, Mo, No) and g_nn of
// n_next: gk the cotangents of (L, M, N), gn those of the aligned normal
// (the raw normal's, through the STANDARD groove frame, in gn0), g_adot,
// g_npre and g_npost (the table's P_NPOST; none on a reflective grating);
// the groove frame's cotangents of x1, y1, the conic and the radius are
// added to g_x1, g_y1, g_k and g_R; g_p1 and g_p2 are the period's and the
// groove angle's.
template <typename T>
__device__ __forceinline__ void grat_adjoint(
    int code, int refl, T R, T k, const T* p, T x1, T y1, T nx0, T ny0,
    T nz0, T nx, T ny, T nz, T adot, T n_pre, const Grat<T>& G, T Lo, T Mo,
    T No, const T* gi, T g_nn, T* gk, T* gn, T* gn0, T& g_adot, T& g_npre,
    T& g_npost, T& g_x1, T& g_y1, T& g_k, T& g_R, T& g_p1, T& g_p2) {
  const T mlam = p[P_MLAM];
  const T n[3] = {nx, ny, nz};
  const T sp = refl ? T(-1) : T(1);
  // k_out = (sp P + n root) / D
  T gP[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gP[j] = sp * gi[j] / G.D;
    gn[j] = gi[j] * G.root / G.D;
  }
  const T g_root = (gi[0] * nx + gi[1] * ny + gi[2] * nz) / G.D;
  T g_D = -(gi[0] * Lo + gi[1] * Mo + gi[2] * No) / G.D;
  // root = sqrt(rad) where the order propagates, else 0
  const T g_rad = G.ok ? g_root * T(0.5) / G.root : T(0);
  g_D += T(2) * G.D * g_rad;
#pragma unroll
  for (int j = 0; j < 3; ++j) gP[j] -= T(2) * G.P[j] * g_rad;
  // D = d_eff n_post; P = d_eff n_pre (k - adot n) + mlam (f - fn n)
  const T gPk = gP[0] * G.kv[0] + gP[1] * G.kv[1] + gP[2] * G.kv[2];
  const T g_deff = g_D * G.npost + n_pre * gPk;
  const T g_npost_g = g_D * G.deff;
  g_npre = G.deff * gPk;
#pragma unroll
  for (int j = 0; j < 3; ++j) gk[j] = G.deff * n_pre * gP[j];
  const T gPn = gP[0] * nx + gP[1] * ny + gP[2] * nz;
  g_adot = -G.deff * n_pre * gPn;
  const T g_fn = -mlam * gPn;
  const T c_n = G.deff * n_pre * adot + mlam * G.fn;
  T gf[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    gn[j] -= c_n * gP[j];
    gf[j] = mlam * gP[j] + g_fn * n[j];
    gn[j] += g_fn * G.f[j];
  }
  // d_eff = d / sqrt(max(fx^2 + fy^2, 1e-12))
  g_p1 = g_deff / sqrt_(G.ffc);
  const T g_ff =
      G.ff > T(1e-12) ? T(-0.5) * g_deff * G.deff / G.ffc : T(0);
  gf[0] += T(2) * G.f[0] * g_ff;
  gf[1] += T(2) * G.f[1] * g_ff;
  if (refl) {
    g_npre = g_npre + g_nn + g_npost_g;
    g_npost = T(0);
  } else {
    g_npost = g_nn + g_npost_g;
  }
  gn0[0] = gn0[1] = gn0[2] = T(0);
  if (code == STANDARD) {
    // f = -g / |g|, g = n0 x t, t = (1, ta, dzd) / tmag
    T gh[3], ggh[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      ggh[j] = -gf[j];
      gh[j] = G.g[j] / G.gmag;
    }
    const T ghd = gh[0] * ggh[0] + gh[1] * ggh[1] + gh[2] * ggh[2];
    T gg[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) gg[j] = (ggh[j] - gh[j] * ghd) / G.gmag;
    gn0[0] = G.t[1] * gg[2] - G.t[2] * gg[1];
    gn0[1] = G.t[2] * gg[0] - G.t[0] * gg[2];
    gn0[2] = G.t[0] * gg[1] - G.t[1] * gg[0];
    const T gt[3] = {gg[1] * nz0 - gg[2] * ny0, gg[2] * nx0 - gg[0] * nz0,
                     gg[0] * ny0 - gg[1] * nx0};
    const T gtd = G.t[0] * gt[0] + G.t[1] * gt[1] + G.t[2] * gt[2];
    T g_ta = (gt[1] - G.t[1] * gtd) / G.tmag;
    const T g_dzd = (gt[2] - G.t[2] * gtd) / G.tmag;
    // dzd = (x1 + y1 ta) / den, den = R sqrt(max(qg, 1e-14))
    g_x1 += g_dzd / G.den;
    g_y1 += g_dzd * G.ta / G.den;
    g_ta += g_dzd * y1 / G.den;
    const T g_den = -g_dzd * G.dzd / G.den;
    g_p2 = g_ta * (T(1) + G.ta * G.ta);
    g_R += g_den * G.sqq;
    const T g_qg = G.qg > T(1e-14) ? g_den * R * T(0.5) / G.sqq : T(0);
    g_k -= g_qg * G.r2 / (R * R);
    g_R += g_qg * T(2) * (T(1) + k) * G.r2 / (R * R * R);
    g_x1 -= T(2) * x1 * g_qg * (T(1) + k) / (R * R);
    g_y1 -= T(2) * y1 * g_qg * (T(1) + k) / (R * R);
  } else {
    // f = (-sin p2, cos p2, 0)
    g_p2 = -cos_(p[P_G2]) * gf[0] - sin_(p[P_G2]) * gf[1];
  }
}

// One forward surface step; returns n of the medium after the surface
// (``npost`` through a refractive surface). ``inten`` and ``opd`` are read
// and written only in the FULL form; ``adot_out``, when not null, receives
// |cos| of the angle of incidence, and ``kloc`` the local pre- and
// post-interaction directions (L0, M0, N0, L1, M1, N1). ``rot`` holds the
// surface's N_ROT cosines and sines, read where ``tilted`` is set; TILT =
// false compiles the rotations out (a system without tilted surfaces). SAG
// compiles in the radial Newton families, which read the surface's nc
// coefficients ``cf`` and take ``niters`` steps, and the annular clip; CART
// the Cartesian ones, which also read P_G1 and P_G2 (CALL: out of line).
template <typename T, bool FULL, bool TILT, bool SAG, bool CART = false,
          bool CALL = false, bool AUX = false>
__device__ __forceinline__ T step_fwd(int code, int refl, int absorbs,
                                      int tilted, const T* p, const T* rot,
                                      const T* cf, const T* lay, int nc,
                                      int niters,
                                      T n_pre, T npost, T& x, T& y, T& z,
                                      T& L, T& M, T& N, T& inten, T& opd,
                                      T* adot_out = nullptr,
                                      T* kloc = nullptr) {
  const T R = p[P_RADIUS], k = p[P_CONIC], pos = p[P_POS];
  T xl = x - p[P_DX], yl = y - p[P_DY], zl = z - pos;
  if (TILT && tilted) rot_local(rot, xl, yl, zl, L, M, N);
  T t;
  if (SAG && is_radial(code))
    t = newton_t(code, R, k, cf, nc, niters + 1, xl, yl, zl, L, M, N);
  else if (CART && is_cart_of<AUX>(code))
    t = cart_newton_at<T, CALL, AUX>(code, R, k, p[P_G1], p[P_G2], cf, lay, nc,
                                niters + 1, xl, yl, zl, L, M, N);
  else
    t = code == STANDARD ? dist_standard(R, k, xl, yl, zl, L, M, N)
                         : dist_plane(zl, N);
  T x1 = xl + t * L, y1 = yl + t * M, z1 = zl + t * N;
  if constexpr (FULL) {
    if (absorbs) inten = inten * exp_(T(ABS) * p[P_KPRE] * t * T(1e3));
    opd = opd + abs_(t * n_pre);
    const T ap = p[P_APMAX];
    if (x1 * x1 + y1 * y1 > ap * ap) inten = T(0);
    if constexpr (SAG) {
      const T am = p[P_APMIN];
      if (x1 * x1 + y1 * y1 < am * am) inten = T(0);
    }
  }
  T nx = T(0), ny = T(0), nz = T(-1);
  if (CART && is_cart_of<AUX>(code)) {
    // the normal's slopes (CHEBYSHEV: the reference's, and 1 / sqrt)
    CartPt<T> cp;
    cart_point_at<T, false, true, CALL, AUX>(code, R, k, p[P_G1], p[P_G2], cf,
                                             lay, nc,
                                        x1, y1, cp);
    const T m2 = cp.sx * cp.sx + cp.sy * cp.sy + T(1);
    const T im = code == CHEBYSHEV ? T(1) / sqrt_(m2) : rsqrt_(m2);
    nx = cp.sx * im;
    ny = cp.sy * im;
    nz = -im;
  } else if (SAG && is_radial(code)) {
    SagPt<T> sp;
    sag_point<T, false>(code, T(1) / R, k, cf, nc, x1 * x1 + y1 * y1, sp);
    const T fx = x1 * sp.W, fy = y1 * sp.W;
    const T im = rsqrt_(fx * fx + fy * fy + T(1));
    nx = fx * im;
    ny = fy * im;
    nz = -im;
  } else if (code == STANDARD) {
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

// The grating build's forward step (GRAT): step_fwd's PLANE and STANDARD
// branches with the tilts, and on a grating surface (``grat``) the
// diffraction (grat_fwd) in place of the refraction or reflection, whose
// evanescent orders the FULL form gives zero intensity. A function of its
// own, as step_adjoint_grat.
template <typename T, bool FULL>
__device__ __forceinline__ T step_fwd_grat(int code, int refl, int absorbs,
                                           int tilted, const T* p,
                                           const T* rot, T n_pre, T npost,
                                           T& x, T& y, T& z, T& L, T& M,
                                           T& N, T& inten, T& opd, int grat) {
  const T R = p[P_RADIUS], k = p[P_CONIC], pos = p[P_POS];
  T xl = x - p[P_DX], yl = y - p[P_DY], zl = z - pos;
  if (tilted) rot_local(rot, xl, yl, zl, L, M, N);
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
  const T nxs = nx * sg, nys = ny * sg, nzs = nz * sg;
  const T adot = abs_(dot);
  T n_next;
  if (grat) {
    // the groove frame reads the raw normal (nx, ny, nz)
    Grat<T> G;
    grat_fwd(code, refl, R, k, p, x1, y1, nx, ny, nz, L, M, N, nxs, nys, nzs,
             adot, n_pre, npost, G, L, M, N);
    if constexpr (FULL)
      if (!G.ok) inten = T(0);  // an evanescent order
    n_next = G.npost;
  } else if (refl) {
    L = L - T(2) * adot * nxs;
    M = M - T(2) * adot * nys;
    N = N - T(2) * adot * nzs;
    n_next = n_pre;
  } else {
    const T u = n_pre / npost;
    const T w = sqrt_(T(1) - u * u * (T(1) - adot * adot)) - u * adot;
    L = u * L + nxs * w;
    M = u * M + nys * w;
    N = u * N + nzs * w;
    n_next = npost;
  }
  if (tilted) rot_global(rot, x1, y1, z1, L, M, N);
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
// n_post slot is the cotangent of ``npost``. For a radial Newton surface
// (SAG) ``gs`` receives (a, b, c, rho_s, rho_1) of its coefficient
// cotangents, dC_i = a rho_s^(i+1) + (i+1) (b rho_s^i + c rho_1^i); for a
// Cartesian one (CART) the N_GS_CART scalars add_cart_cols expands: the
// weights (a, b, c) at the Newton point (Xs, Ys), those at the normal's
// point (x1, y1), and the cotangents of p1 and p2. CALL: the Cartesian work
// out of line.
template <typename T, bool FULL, bool TILT, bool SAG, bool CART = false,
          bool CALL = false, bool AUX = false>
__device__ __forceinline__ void step_adjoint(int code, int refl, int absorbs,
                                             int tilted, const T* p,
                                             const T* rot, const T* cf,
                                             const T* lay, int nc,
                                             int niters, T n_pre,
                                             T npost, T x, T y, T z, T L,
                                             T M, T N, T i_in, T* g, T* gc,
                                             T* gs = nullptr,
                                             const T* gext = nullptr) {
  const T R = p[P_RADIUS], k = p[P_CONIC], pos = p[P_POS];
  const T dx = p[P_DX], dy = p[P_DY];
  const bool std_ = code == STANDARD;
  const bool newton = SAG && is_radial(code);
  const bool cart = CART && is_cart_of<AUX>(code);
  const T p1 = p[P_G1], p2 = p[P_G2];
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
  } else if (newton || cart) {
    // the stopped iterate t_s, then the one step the gradient runs through
    t = T(0);
  } else {
    big = abs_(N) > T(1e-14);
    Ns = big ? N : T(1e-14);
    t = -zl / Ns;
  }
  T t_s = T(0), Xs = T(0), Ys = T(0), fN = T(0), fpN = T(1);
  bool okf = false;
  SagPt<T> sps = {}, sp1 = {};
  if (newton) {
    cu = T(1) / R;
    t_s = newton_t(code, R, k, cf, nc, niters, xl, yl, zl, L, M, N);
    Xs = xl + t_s * L;
    Ys = yl + t_s * M;
    sag_point<T, true>(code, cu, k, cf, nc, Xs * Xs + Ys * Ys, sps);
    fN = zl + t_s * N - sps.s;
    const T fp = N - sps.W * (Xs * L + Ys * M);
    okf = abs_(fp) > T(1e-14);
    fpN = okf ? fp : T(1e-14);
    t = t_s - fN / fpN;
  }
  T sxs = T(0), sys = T(0);  // the slopes at the Newton point (CART)
  if (cart) {
    t_s = cart_newton_at<T, CALL, AUX>(code, R, k, p1, p2, cf, lay, nc, niters,
                                       xl, yl,
                                  zl, L, M, N);
    Xs = xl + t_s * L;
    Ys = yl + t_s * M;
    CartPt<T> cp;
    cart_point_at<T, false, false, CALL, AUX>(code, R, k, p1, p2, cf, lay, nc,
                                              Xs, Ys,
                                         cp);
    fN = zl + t_s * N - cp.s;
    sxs = cp.sx;
    sys = cp.sy;
    const T fp = N - (sxs * L + sys * M);
    okf = abs_(fp) > T(1e-14);
    fpN = okf ? fp : T(1e-14);
    t = t_s - fN / fpN;
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
  } else if (newton) {
    sag_point<T, true>(code, cu, k, cf, nc, x1 * x1 + y1 * y1, sp1);
    fx = x1 * sp1.W;
    fy = y1 * sp1.W;
    im = rsqrt_(fx * fx + fy * fy + T(1));
    nx = fx * im;
    ny = fy * im;
    nz = -im;
  } else if (cart) {
    // the normal's slopes (CHEBYSHEV: the reference's, and 1 / sqrt)
    CartPt<T> cp;
    cart_point_at<T, false, true, CALL, AUX>(code, R, k, p1, p2, cf, lay, nc,
                                             x1, y1,
                                        cp);
    fx = cp.sx;
    fy = cp.sy;
    const T m2 = fx * fx + fy * fy + T(1);
    im = code == CHEBYSHEV ? T(1) / sqrt_(m2) : rsqrt_(m2);
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
  T c_sag = T(0);
  if (newton) {
    // n = (x1 W1, y1 W1, -1) rsqrt(.), W1 = W(x1^2 + y1^2)
    const T g_nx = sgn * g_nxs, g_ny = sgn * g_nys, g_nz = sgn * g_nzs;
    T g_fx = g_nx * im;
    T g_fy = g_ny * im;
    const T g_im = g_nx * fx + g_ny * fy - g_nz;
    const T g_mg = T(-0.5) * g_im * im * im * im;
    g_fx += T(2) * fx * g_mg;
    g_fy += T(2) * fy * g_mg;
    g_x1 += g_fx * sp1.W;
    g_y1 += g_fy * sp1.W;
    const T g_W1 = g_fx * x1 + g_fy * y1;
    const T g_r2 = g_W1 * sp1.Wr;
    g_x1 += T(2) * x1 * g_r2;
    g_y1 += T(2) * y1 * g_r2;
    g_cu += g_W1 * sp1.W_cu;
    g_k += g_W1 * sp1.W_k;
    c_sag = g_W1 * sp1.beta;
  }
  // CART: the radius, p1 and p2 cotangents of the normal, and its
  // coefficient weights
  T g_Rd = T(0), g_p1 = T(0), g_p2 = T(0), w1[3] = {T(0), T(0), T(0)};
  if (cart) {
    // n = (fx, fy, -1) im, (fx, fy) the normal's slopes at (x1, y1)
    const T g_nx = sgn * g_nxs, g_ny = sgn * g_nys, g_nz = sgn * g_nzs;
    T g_fx = g_nx * im;
    T g_fy = g_ny * im;
    const T g_im = g_nx * fx + g_ny * fy - g_nz;
    const T g_mg = T(-0.5) * g_im * im * im * im;
    g_fx += T(2) * fx * g_mg;
    g_fy += T(2) * fy * g_mg;
    CartPt<T> cp;
    cart_point_at<T, true, true, CALL, AUX>(code, R, k, p1, p2, cf, lay, nc,
                                            x1, y1,
                                       cp);
    g_x1 += g_fx * cp.hxx + g_fy * cp.hyx;
    g_y1 += g_fx * cp.hxy + g_fy * cp.hyy;
    g_Rd = g_fx * cp.dR[1] + g_fy * cp.dR[2];
    g_k += g_fx * cp.dk[1] + g_fy * cp.dk[2];
    g_p1 = g_fx * cp.dp1[1] + g_fy * cp.dp1[2];
    g_p2 = g_fx * cp.dp2[1] + g_fy * cp.dp2[2];
    coef_weights<T, AUX>(code, cp, T(0) * g_fx, g_fx, g_fy, w1);
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
    if constexpr (SAG) {
      const T am = p[P_APMIN];
      if (x1 * x1 + y1 * y1 < am * am) g_i = T(0);
    }
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
  } else if (newton) {
    // t = t_s - f / f' at the stopped t_s: f = zl + t_s N - s(X, Y),
    // f' = N - W (X L + Y M), X = xl + t_s L, Y = yl + t_s M
    const T g_f = -g_t / fpN;
    const T g_fp = okf ? g_t * fN / (fpN * fpN) : T(0);
    g_zl += g_f;
    gN += g_f * t_s + g_fp;
    const T g_s = -g_f;
    const T g_W = -g_fp * (Xs * L + Ys * M);
    gL -= g_fp * sps.W * Xs;
    gM -= g_fp * sps.W * Ys;
    T g_X = -g_fp * sps.W * L;
    T g_Y = -g_fp * sps.W * M;
    const T g_r2 = g_s * sps.W * T(0.5) + g_W * sps.Wr;  // ds/dr2 = W / 2
    g_X += T(2) * Xs * g_r2;
    g_Y += T(2) * Ys * g_r2;
    g_cu += g_s * sps.s_cu + g_W * sps.W_cu;
    g_k += g_s * sps.s_k + g_W * sps.W_k;
    g_xl += g_X;
    g_yl += g_Y;
    gL += g_X * t_s;
    gM += g_Y * t_s;
    g_R = -g_cu * (cu * cu);
    gs[0] = g_s;
    gs[1] = g_W * sps.beta;
    gs[2] = c_sag;
    gs[3] = sps.rho;
    gs[4] = sp1.rho;
  } else if (cart) {
    // t = t_s - f / f' at the stopped t_s: f = zl + t_s N - s(X, Y),
    // f' = N - (sx L + sy M), X = xl + t_s L, Y = yl + t_s M
    const T g_f = -g_t / fpN;
    const T g_fp = okf ? g_t * fN / (fpN * fpN) : T(0);
    g_zl += g_f;
    gN += g_f * t_s + g_fp;
    const T g_s = -g_f;
    const T g_sx = -g_fp * L;
    const T g_sy = -g_fp * M;
    gL -= g_fp * sxs;
    gM -= g_fp * sys;
    CartPt<T> cp;
    cart_point_at<T, true, false, CALL, AUX>(code, R, k, p1, p2, cf, lay, nc,
                                             Xs, Ys,
                                        cp);
    const T g_X = g_s * cp.sx + g_sx * cp.hxx + g_sy * cp.hyx;
    const T g_Y = g_s * cp.sy + g_sx * cp.hxy + g_sy * cp.hyy;
    g_R = g_Rd + g_s * cp.dR[0] + g_sx * cp.dR[1] + g_sy * cp.dR[2];
    g_k += g_s * cp.dk[0] + g_sx * cp.dk[1] + g_sy * cp.dk[2];
    g_p1 += g_s * cp.dp1[0] + g_sx * cp.dp1[1] + g_sy * cp.dp1[2];
    g_p2 += g_s * cp.dp2[0] + g_sx * cp.dp2[1] + g_sy * cp.dp2[2];
    coef_weights<T, AUX>(code, cp, g_s, g_sx, g_sy, gs);
    // a parameter the family's sag does not read gets no cotangent
    // (geometry.py: cart_reads)
    if (code == TOROIDAL) g_k = T(0);
    if (code == POLYNOMIAL_XY) g_p1 = g_p2 = T(0);
    if (AUX && is_aux(code)) g_p2 = T(0);
    g_xl += g_X;
    g_yl += g_Y;
    gL += g_X * t_s;
    gM += g_Y * t_s;
    gs[3] = Xs;
    gs[4] = Ys;
    gs[5] = w1[0];
    gs[6] = w1[1];
    gs[7] = w1[2];
    gs[8] = x1;
    gs[9] = y1;
    gs[10] = g_p1;
    gs[11] = g_p2;
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

// The grating build's reverse step (GRAT: ops/step.py's
// step_adjoint_plain with ``grating``): step_adjoint's PLANE and STANDARD
// branches with the tilts, and a grating surface's diffraction in place of
// the refraction or reflection (grat_adjoint), whose P_G1 and P_G2
// cotangents go to gs[0] and gs[1]. A function of its own, so the other
// builds' step_adjoint keeps the code it had before gratings: the same
// branch under a template flag of step_adjoint and step_fwd, even one
// that if constexpr leaves out of the other builds, changed the machine
// code of 33 of their 208 functions (PERF.md §6, ``torch_build_compare.py
// sass``). A change to step_adjoint's or step_fwd's PLANE and STANDARD
// code is made here too; the grat build's parity checks against the
// shared plain step (test_torch_cuda.py, chip_smoke.py phase 25) catch
// the two drifting apart.
template <typename T, bool FULL>
__device__ __forceinline__ void step_adjoint_grat(
    int code, int refl, int absorbs, int tilted, const T* p, const T* rot,
    T n_pre, T npost, T x, T y, T z, T L, T M, T N, T i_in, T* g, T* gc,
    T* gs, int grat) {
  const T R = p[P_RADIUS], k = p[P_CONIC], pos = p[P_POS];
  const T dx = p[P_DX], dy = p[P_DY];
  const bool std_ = code == STANDARD;
  const T g_nn = g[6];

  // ---- recompute the forward intermediates (in the surface's frame) ----
  T xl = x - dx, yl = y - dy, zl = z - pos;
  if (tilted) rot_local(rot, xl, yl, zl, L, M, N);
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
  Grat<T> G;
  if (grat) {
    grat_fwd(code, refl, R, k, p, x1, y1, nx, ny, nz, L, M, N, nxs, nys, nzs,
             adot, n_pre, npost, G, Lo, Mo, No);
  } else if (refl) {
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
  const T gLi = go[3], gMi = go[4], gNi = go[5];

  // ---- interact ----
  T gL, gM, gN, g_nxs, g_nys, g_nzs, g_adot, g_npre, g_npost;
  // the grating's cotangents of the raw normal, the conic and the radius
  // (its groove frame), P_G1 and P_G2
  T gn0[3] = {T(0), T(0), T(0)}, g_kg = T(0), g_Rg = T(0), g_p1 = T(0),
    g_p2 = T(0);
  if (grat) {
    const T gi[3] = {gLi, gMi, gNi};
    T gk[3], gn[3];
    grat_adjoint(code, refl, R, k, p, x1, y1, nx, ny, nz, nxs, nys, nzs, adot,
                 n_pre, G, Lo, Mo, No, gi, g_nn, gk, gn, gn0, g_adot, g_npre,
                 g_npost, g_x1, g_y1, g_kg, g_Rg, g_p1, g_p2);
    gL = gk[0];
    gM = gk[1];
    gN = gk[2];
    g_nxs = gn[0];
    g_nys = gn[1];
    g_nzs = gn[2];
  } else if (refl) {
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
  gL += nxs * g_adot;
  gM += nys * g_adot;
  gN += nzs * g_adot;
  g_nxs += L * g_adot;
  g_nys += M * g_adot;
  g_nzs += N * g_adot;

  T g_k = T(0) + g_kg, g_cu = T(0);
  // ---- normal (STANDARD; the plane normal is constant) ----
  if (std_) {
    const T g_nx = sgn * g_nxs + gn0[0], g_ny = sgn * g_nys + gn0[1],
            g_nz = sgn * g_nzs + gn0[2];
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
    if (grat && !G.ok) g_i = T(0);  // an evanescent order
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
  gc[0] = g_R + g_Rg;
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
  gs[0] = g_p1;
  gs[1] = g_p2;
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

// Copy the (S, nc) geometry coefficient table into shared memory (SAG;
// load_tables, which follows, synchronises).
template <typename T, bool SAG>
__device__ __forceinline__ void load_coefs(const T* cf, int S, int nc,
                                           T* scf) {
  if constexpr (SAG)
    for (int i = threadIdx.x; i < S * nc; i += blockDim.x) scf[i] = cf[i];
}

// The Newton surfaces' column blocks of a backward's partial row: ssag[s]
// the index of surface s among them; returns how many there are.
template <bool AUX>
__device__ __forceinline__ int fill_sag(const int* sf, int S, int* ssag) {
  int n = 0;
  for (int s = 0; s < S; ++s) {
    ssag[s] = n;
    if (is_newton_of<AUX>(sf[s])) ++n;
  }
  return n;
}

// The per-warp gradient rows of a backward: static shared memory of
// NW_MAX x NCOMP rows, or (DYN: Build::DYN, or the polarized sag build) the
// dynamic shared memory,
// nw rows of the launch's ncomp.
template <typename T, bool DYN>
__device__ __forceinline__ T* acc_rows(T* acc_static) {
  if constexpr (DYN) {
    extern __shared__ __align__(16) unsigned char dyn_smem[];
    return reinterpret_cast<T*>(dyn_smem);
  } else {
    return acc_static;
  }
}

// Expand a Newton surface's five coefficient scalars gs (step_adjoint) into
// its nc columns, warp sums in column order, added by lane 0 to the warp's
// row ``row`` from column ``base``.
template <typename T>
__device__ __forceinline__ void add_coef_cols(const T* gs, int nc, int lane,
                                              T* row, int base) {
  T ps = T(1), p1 = T(1);
  for (int j = 0; j < nc; ++j) {
    T v = gs[0] * ps * gs[3] + T(j + 1) * (gs[1] * ps + gs[2] * p1);
    ps *= gs[3];
    p1 *= gs[4];
    v = warp_sum(v);
    if (lane == 0) row[base + j] += v;
  }
}

// Expand a Cartesian surface's per-ray record gs (step_adjoint: the weights
// (a, b, c) at the Newton point (Xs, Ys), those at the normal's point
// (X1, Y1), then the cotangents of p1 and p2) into its nc coefficient
// columns and its P_G1 and P_G2 columns (geometry.py: coef_columns), warp
// sums in column order, added by lane 0 to the warp's row ``row`` from
// column ``base``.
// Expand an aux-bearing surface's weights gs (at the Newton point and at
// the normal's point) into its nc slot columns (geometry.py: coef_columns):
// slot j takes a psi_j + b d psi_j/dx + c d psi_j/dy at each point, warp
// sums in column order, added by lane 0 to ``row`` from column ``base``.
// Out of line, as aux_point_call.
template <typename T>
__device__ __noinline__ void add_aux_cols(int code, const T* gs, const T* lay,
                                          int nc, T p1, int lane, T* row,
                                          int base) {
  const T eps = code == FORBES_Q2D ? T(Q2D_EPS) : T(0);
  const T p12 = p1 * p1;
  AuxSlots<T, false> ss, s1;
  ss.start(gs[3], gs[4], p1, eps);
  s1.start(gs[8], gs[9], p1, eps);
  const T vxs = T(2) * gs[3] / p12, vys = T(2) * gs[4] / p12;
  const T vx1 = T(2) * gs[8] / p12, vy1 = T(2) * gs[9] / p12;
  for (int j = 0; j < nc; ++j) {
    ss.next(lay + j * LAY_COLS);
    s1.next(lay + j * LAY_COLS);
    T v = gs[0] * (ss.A[0] * ss.F[0]) +
          gs[1] * (ss.A[1] * ss.F[0] + ss.A[0] * ss.F[1] * vxs) +
          gs[2] * (ss.A[2] * ss.F[0] + ss.A[0] * ss.F[1] * vys);
    v = v + (gs[5] * (s1.A[0] * s1.F[0]) +
             gs[6] * (s1.A[1] * s1.F[0] + s1.A[0] * s1.F[1] * vx1) +
             gs[7] * (s1.A[2] * s1.F[0] + s1.A[0] * s1.F[1] * vy1));
    v = warp_sum(v);
    if (lane == 0) row[base + j] += v;
  }
}
template <typename T, bool AUX = false>
__device__ __forceinline__ void add_cart_cols(int code, const T* gs,
                                              const T* lay, int nc, T p1,
                                              T p2, int lane, T* row,
                                              int base) {
  if (AUX && is_aux(code)) {
    add_aux_cols(code, gs, lay, nc, p1, lane, row, base);
  } else if (code == TOROIDAL) {
    T pw_s = gs[4], pw_1 = gs[9];
    for (int i = 0; i < nc; ++i) {
      T v = gs[0] * pw_s * gs[4] + gs[1] * T(2 * i + 2) * pw_s;
      v = v + (gs[5] * pw_1 * gs[9] + gs[6] * T(2 * i + 2) * pw_1);
      pw_s = pw_s * (gs[4] * gs[4]);
      pw_1 = pw_1 * (gs[9] * gs[9]);
      v = warp_sum(v);
      if (lane == 0) row[base + i] += v;
    }
  } else if (code != BICONIC) {
    const int side = table_side(nc);
    const bool cheb = code == CHEBYSHEV;
    ChebN<T> chx = {}, chy = {};
    if (cheb) {
      cheb_norm_prep(gs[8] / p1, chx);
      cheb_norm_prep(gs[9] / p2, chy);
    }
    Basis1<T> bxs, bx1;
    bxs.start(cheb, gs[3], p1);
    bx1.start(cheb, gs[8], p1);
    for (int i = 0; i < side && i * side < nc; ++i) {
      Basis1<T> bys, by1;
      bys.start(cheb, gs[4], p2);
      by1.start(cheb, gs[9], p2);
      const T dx1 = cheb ? bx1.g(chx) : bx1.f1();
      for (int j = 0; j < side && i * side + j < nc; ++j) {
        const T dy1 = cheb ? by1.g(chy) : by1.f1();
        T v = gs[0] * (bxs.f() * bys.f()) + gs[1] * (bxs.f1() * bys.f()) +
              gs[2] * (bxs.f() * bys.f1());
        v = v + (gs[5] * (bx1.f() * by1.f()) + gs[6] * (dx1 * by1.f()) +
                 gs[7] * (bx1.f() * dy1));
        v = warp_sum(v);
        if (lane == 0) row[base + i * side + j] += v;
        bys.next();
        by1.next();
      }
      bxs.next();
      bx1.next();
    }
  }
  const T v1 = warp_sum(gs[10]);
  const T v2 = warp_sum(gs[11]);
  if (lane == 0) {
    row[base + nc] += v1;
    row[base + nc + 1] += v2;
  }
}

// add_cart_cols out of line (the deep builds, see cart_point_call).
template <typename T>
__device__ __noinline__ void add_cart_cols_call(int code, const T* gs, int nc,
                                                T p1, T p2, int lane, T* row,
                                                int base) {
  add_cart_cols<T>(code, gs, nullptr, nc, p1, p2, lane, row, base);
}
template <typename T>
__device__ __noinline__ void add_cart_cols_aux_call(int code, const T* gs,
                                                    const T* lay, int nc,
                                                    T p1, T p2, int lane,
                                                    T* row, int base) {
  add_cart_cols<T, true>(code, gs, lay, nc, p1, p2, lane, row, base);
}

// add_cart_cols, in line or (CALL) out of line.
template <typename T, bool CALL, bool AUX>
__device__ __forceinline__ void add_cart_cols_at(int code, const T* gs,
                                                 const T* lay, int nc, T p1,
                                                 T p2, int lane, T* row,
                                                 int base) {
  if constexpr (CALL && AUX)
    add_cart_cols_aux_call(code, gs, lay, nc, p1, p2, lane, row, base);
  else if constexpr (CALL)
    add_cart_cols_call(code, gs, nc, p1, p2, lane, row, base);
  else
    add_cart_cols<T, AUX>(code, gs, lay, nc, p1, p2, lane, row, base);
}

// The block's partial row of the summed gradients: the sum of the nw
// per-warp rows of acc (``stride`` apart), in warp order.
template <typename T>
__device__ __forceinline__ void store_partial_row(const T* acc, int stride,
                                                  int nw, int ncomp,
                                                  T* partial) {
  for (int j = threadIdx.x; j < ncomp; j += blockDim.x) {
    T v = T(0);
    for (int w = 0; w < nw; ++w) v += acc[w * stride + j];
    partial[(int64_t)blockIdx.x * ncomp + j] = v;
  }
}

// Fixed-order sum of a backward's partial rows (compact layout: NG slots per
// surface, then a block of ncb columns for each Newton surface (nsagc in
// all; ``codes`` are the surfaces' geometry codes): its nc coefficient
// columns, and where ncb = nc + 2 (the free and deep_free builds) its P_G1
// and P_G2 columns; then n_extra entries), one block per compact column. The
// sum is scattered into the (S*NUM_P + S*nc [+ extras]) layout, whose other
// entries the caller has zeroed. GR (the grating build): the blocks are the
// grating surfaces' (``codes`` is the grating flag row), ncb = N_GRAT_COLS
// columns each, P_G1 and P_G2. NU (the nurbs build): the blocks are the
// NURBS surfaces', ncb = nc coefficient columns each.
template <typename T, int NG, bool GR = false, bool NU = false>
__global__ void __launch_bounds__(RED_BLOCK)
grad_reduce_kernel(const T* __restrict__ partial, int nblocks, int S, int nc,
                   int ncb, int nsagc, const int* __restrict__ codes,
                   int n_extra, T* __restrict__ out) {
  __shared__ T red[2][32];
  const int ncomp = S * NG + nsagc + n_extra;
  const int col = blockIdx.x;
  T v = T(0), unused = T(0);
  for (int b = threadIdx.x; b < nblocks; b += blockDim.x)
    v += partial[(int64_t)b * ncomp + col];
  block_sum2(v, unused, red);
  if (threadIdx.x == 0) {
    int dst;
    if (col < S * NG) {
      dst = (col / NG) * NUM_P + kGradCol[col % NG];
    } else if (col < S * NG + nsagc) {
      const int kk = (col - S * NG) / ncb, j = (col - S * NG) % ncb;
      const int ncoef = GR ? 0 : nc;  // the block's coefficient columns
      int s = 0, seen = -1;
      for (; s < S; ++s)
        if ((GR ? codes[s] != 0
                : (NU ? codes[s] == NURBS : is_newton(codes[s]))) &&
            ++seen == kk)
          break;
      dst = j < ncoef ? S * NUM_P + s * nc + j
                      : s * NUM_P + (j == ncoef ? P_G1 : P_G2);
    } else {
      dst = S * (NUM_P + nc) + (col - S * NG - nsagc);
    }
    out[dst] = v;
  }
}

// The grating surfaces' column blocks of a backward's partial row (the
// grating build): sidx[s] the index of surface s among them (``grat`` its
// flag row).
__device__ __forceinline__ void fill_grat(const int* grat, int S, int* sidx) {
  int n = 0;
  for (int s = 0; s < S; ++s) {
    sidx[s] = n;
    if (grat[s]) ++n;
  }
}

// Add a grating surface's P_G1 and P_G2 cotangents (step_adjoint's gs[0],
// gs[1]) as warp sums to the warp's row ``row`` from column ``base``.
template <typename T>
__device__ __forceinline__ void add_grat_cols(const T* gs, int lane, T* row,
                                              int base) {
  const T v1 = warp_sum(gs[0]);
  const T v2 = warp_sum(gs[1]);
  if (lane == 0) {
    row[base] += v1;
    row[base + 1] += v2;
  }
}

// Launch the reduction of a backward's partial rows (launchers' tail).
template <typename T, int NG, bool GR = false, bool NU = false>
int reduce_launch(const T* partial, int nblocks, int S, int nc, int ncb,
                  int nsagc, const int* codes, int n_extra, T* out,
                  cudaStream_t stream) {
  grad_reduce_kernel<T, NG, GR, NU><<<S * NG + nsagc + n_extra, RED_BLOCK, 0,
                                      stream>>>(partial, nblocks, S, nc, ncb,
                                                nsagc, codes, n_extra, out);
  return (int)cudaGetLastError();
}

}  // namespace

#include "nurbs_step.cuh"
