// step_adjoint_kept, the Newton builds' reverse step, read twice: by
// step.cuh with STEP_EXT 0 (the merit and trace backwards' step, as it
// was) and by pol_trace.cuh with STEP_EXT 1 (step_adjoint_kept_ext, the
// polarized backward's, which also takes ``gext``, the cotangents of the
// extras k0, k1 and adot). So the polarized backward shares the step's
// arithmetic while the other kernels keep their machine code: a flag
// inside the shared function, even one that if constexpr leaves out, moved
// it (PERF.md §6). No include guard; STEP_NAME(f) names the function.

// The Newton builds' reverse sweep through one surface step (transcribes
// step.step_adjoint_plain with ``t_s``; step_fwd with KEEP before it). In:
// the step's input state (and, FULL, its input intensity i_in), the
// cotangents g of its outputs (x, y, z, L, M, N, n_next, and FULL: i,
// opd) and, STEP_EXT, ``gext``, those of its extras (L0, M0, N0, L1, M1,
// N1, adot). Out: g becomes the cotangents of the inputs (x, y, z, L, M,
// N, n_pre, and FULL: i, opd), gc the cotangents of (radius, conic, pos,
// n_post, dx, dy, rx, ry, rz, and FULL: k_pre); the n_post slot is the
// cotangent of ``npost``. For a radial Newton surface (SAG) ``gs``
// receives (a, b, c, rho_s, rho_1) of its coefficient cotangents, dC_i = a
// rho_s^(i+1) + (i+1) (b rho_s^i + c rho_1^i); for a Cartesian one (CART)
// the N_GS_CART scalars add_cart_cols expands: the weights (a, b, c) at
// the Newton point (Xs, Ys), those at the normal's point (x1, y1), and the
// cotangents of p1 and p2. CALL: the Cartesian work out of line. A Newton
// surface starts from ``ts``, the record of its forward sweep, instead of
// taking niters steps again (a Cartesian one also takes f, f' and the
// slopes at t_s and the normal's slopes from it, where it evaluated its
// sag again). A function of its own, as step_adjoint_grat, step_adjoint_pt
// and step_adjoint_nurbs, which share its PLANE and STANDARD code: a
// change to it is made in each, and the builds' parity checks against the
// shared plain step (test_torch_cuda.py, chip_smoke.py) catch them
// drifting apart.
template <typename T, bool FULL, bool TILT, bool SAG, bool CART = false,
          bool CALL = false, bool AUX = false>
__device__ __forceinline__ void STEP_NAME(step_adjoint_kept)(
    int code, int refl, int absorbs, int tilted, const T* p, const T* rot,
    const T* cf, const T* lay, int nc, T n_pre, T npost, T x, T y, T z, T L,
    T M, T N, T i_in, T* g, T* gc, T* gs, const T* ts
#if STEP_EXT
    , const T* gext
#endif
    ) {
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
    t_s = ts[K_TS];
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
    // the record of the forward sweep's last step: f' was clamped where
    // |f'| <= 1e-14, to 1e-14 exactly
    t_s = ts[K_TS];
    Xs = xl + t_s * L;
    Ys = yl + t_s * M;
    fN = ts[K_F];
    fpN = ts[K_FP];
    okf = fpN != T(1e-14);
    sxs = ts[K_SX];
    sys = ts[K_SY];
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
    fx = ts[K_NX];
    fy = ts[K_NY];
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
  // cotangents of the local post-interaction directions (STEP_EXT: the
  // output's and the extras' L1, M1, N1)
#if STEP_EXT
  const T gLi = go[3] + gext[3], gMi = go[4] + gext[4],
          gNi = go[5] + gext[5];
#else
  const T gLi = go[3], gMi = go[4], gNi = go[5];
#endif

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
#if STEP_EXT
  // the extras' local pre-interaction directions and adot
  gL += gext[0];
  gM += gext[1];
  gN += gext[2];
  g_adot += gext[6];
#endif
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
