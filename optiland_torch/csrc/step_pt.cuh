// step_fwd_pt and step_adjoint_pt, the stock and tilt builds' steps, read
// twice: by step.cuh with STEP_EXT 0 (the merit and trace backwards'
// steps, as they were) and by pol_trace.cuh with STEP_EXT 1 (the _ext
// names, the polarized backward's: the forward step also writes adot and
// the local directions to ``adot_out`` and ``kloc``, the reverse step
// takes their cotangents ``gext``). So the polarized backward shares the
// step's arithmetic while the other kernels keep their machine code: a
// flag inside the shared function, even one that if constexpr leaves out,
// moved it (PERF.md §6). No include guard; STEP_NAME(f) names the
// function.

template <typename T, bool FULL, bool TILT>
__device__ __forceinline__ T STEP_NAME(step_fwd_pt)(int fl, const T* qr, const T* rot,
                                         T u, T n_pre, T npost, T& x, T& y,
                                         T& z, T& L, T& M, T& N, T& inten,
                                         T& opd, T* sv
#if STEP_EXT
                                         , T* adot_out, T* kloc
#endif
                                         ) {
  const int code = fl & 15, refl = fl & 16, absorbs = fl & 32;
  const int tilted = fl & 64;
  const T cu = qr[Q_CU], k = qr[Q_K], pos = qr[Q_POS];
  const T dx = qr[Q_DX], dy = qr[Q_DY];
  T xl = x - dx, yl = y - dy, zl = z - pos;
  if (TILT && tilted) rot_local(rot, xl, yl, zl, L, M, N);
  T t;
  if (code == STANDARD) {
    const T a = cu * (k * (N * N) + L * L + M * M + N * N);
    const T b = T(2) * (cu * (k * N * zl + L * xl + M * yl + N * zl) - N);
    const T c = cu * (k * (zl * zl) + xl * xl + yl * yl + zl * zl) -
                T(2) * zl;
    const T d = b * b - T(4) * a * c;
    const T sd = d < T(0) ? nan_<T>() : sqrt_(d);
    const T s = b >= T(0) ? T(1) : T(-1);
    const T q = T(-0.5) * (b + s * sd);
    const T t1 = a == T(0) ? inf_<T>() : q / a;
    const T t2 = q == T(0) ? T(0) : c / q;
    t = abs_(zl + t1 * N) <= abs_(zl + t2 * N) ? t1 : t2;
    sv[0] = t1;
    sv[1] = t2;
    sv[2] = sd;
  } else {
    t = dist_plane(zl, N);
    sv[0] = t;
  }
  T x1 = xl + t * L, y1 = yl + t * M, z1 = zl + t * N;
  if constexpr (FULL) {
    if (absorbs) inten = inten * exp_(T(ABS) * qr[Q_KPRE] * t * T(1e3));
    opd = opd + abs_(t * n_pre);
    const T ap = qr[Q_APMAX];
    if (x1 * x1 + y1 * y1 > ap * ap) inten = T(0);
  }
  T nx = T(0), ny = T(0), nz = T(-1);
  if (code == STANDARD) {
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
#if STEP_EXT
  *adot_out = adot;
  kloc[0] = L;
  kloc[1] = M;
  kloc[2] = N;
#endif
  T n_next;
  if (refl) {
    L = L - T(2) * adot * nx;
    M = M - T(2) * adot * ny;
    N = N - T(2) * adot * nz;
    n_next = n_pre;
  } else {
    const T root = sqrt_(T(1) - u * u * (T(1) - adot * adot));
    const T w = root - u * adot;
    sv[3] = root;
    L = u * L + nx * w;
    M = u * M + ny * w;
    N = u * N + nz * w;
    n_next = npost;
  }
#if STEP_EXT
  kloc[3] = L;
  kloc[4] = M;
  kloc[5] = N;
#endif
  if (TILT && tilted) rot_global(rot, x1, y1, z1, L, M, N);
  x = x1 + dx;
  y = y1 + dy;
  z = z1 + pos;
  return n_next;
}

// The reverse step of step_fwd_pt from the surface's input state and what
// the forward step saved (``sv``): step_adjoint_kept's PLANE and STANDARD
// branches with the tilts (gc: the N_G or, FULL, N_GF slots).
template <typename T, bool FULL, bool TILT>
__device__ __forceinline__ void STEP_NAME(step_adjoint_pt)(
    int fl, const T* qr, const T* rot, T u, T inpost, T n_pre, T npost, T x,
    T y, T z, T L, T M, T N, T i_in, const T* sv, T* g, T* gc
#if STEP_EXT
    , const T* gext
#endif
    ) {
  const int code = fl & 15, refl = fl & 16, absorbs = fl & 32;
  const int tilted = fl & 64;
  const T cu = qr[Q_CU], k = qr[Q_K], pos = qr[Q_POS];
  const T dx = qr[Q_DX], dy = qr[Q_DY];
  const bool std_ = code == STANDARD;
  const T g_nn = g[6];

  // ---- the forward intermediates (in the surface's frame) ----
  T xl = x - dx, yl = y - dy, zl = z - pos;
  if (TILT && tilted) rot_local(rot, xl, yl, zl, L, M, N);
  T A = T(0), a = T(0), Bq = T(0), b = T(0), Cq = T(0), c = T(0);
  T sd = T(0), sg = T(0), q = T(0), t1 = T(0), t2 = T(0), t, Ns = T(1);
  bool use1 = false, a0 = false, q0 = false, big = false;
  if (std_) {
    A = k * (N * N) + L * L + M * M + N * N;
    a = cu * A;
    Bq = k * N * zl + L * xl + M * yl + N * zl;
    b = T(2) * (cu * Bq - N);
    Cq = k * (zl * zl) + xl * xl + yl * yl + zl * zl;
    c = cu * Cq - T(2) * zl;
    sd = sv[2];
    sg = b >= T(0) ? T(1) : T(-1);
    q = T(-0.5) * (b + sg * sd);
    a0 = a == T(0);
    q0 = q == T(0);
    t1 = sv[0];
    t2 = sv[1];
    use1 = abs_(zl + t1 * N) <= abs_(zl + t2 * N);
    t = use1 ? t1 : t2;
  } else {
    big = abs_(N) > T(1e-14);
    Ns = big ? N : T(1e-14);
    t = sv[0];
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
  T Lo, Mo, No, root = T(1), w = T(0);
  if (refl) {
    Lo = L - T(2) * adot * nxs;
    Mo = M - T(2) * adot * nys;
    No = N - T(2) * adot * nzs;
  } else {
    root = sv[3];
    w = root - u * adot;
    Lo = u * L + nxs * w;
    Mo = u * M + nys * w;
    No = u * N + nzs * w;
  }

  // ---- globalize: rotate back (tilted), then translate ----
  T go[6] = {g[0], g[1], g[2], g[3], g[4], g[5]};
  T d_r[3] = {T(0), T(0), T(0)};
  if (TILT && tilted) rot_global_adjoint(rot, x1, y1, z1, Lo, Mo, No, go, d_r);
  T g_dx = g[0], g_dy = g[1], g_pos = g[2];
  T g_x1 = go[0], g_y1 = go[1], g_z1 = go[2];
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
    const T iroot = T(1) / root;
    g_u = g_u - g_w * u * (T(1) - adot * adot) * iroot;
    g_adot = g_adot + g_w * u * u * adot * iroot;
    g_npre = g_u * inpost;
    g_npost = g_nn - g_u * u * inpost;
  }
#if STEP_EXT
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
  // ---- normal (STANDARD; the plane normal is constant) ----
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
    const T ap = qr[Q_APMAX];
    g_i = x1 * x1 + y1 * y1 > ap * ap ? T(0) : g[7];
    if (absorbs) {
      const T kpre = qr[Q_KPRE];
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
    // one reciprocal: of a (t = t1 = q / a) or of q (t = t2 = c / q)
    const T rden = ok1 || ok2 ? T(1) / (ok1 ? a : q) : T(0);
    const T g_q = ok1 ? g_t * rden : (ok2 ? -g_t * t2 * rden : T(0));
    T g_a = ok1 ? -g_t * t1 * rden : T(0);
    T g_c = ok2 ? g_t * rden : T(0);
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
    const T iN = T(1) / Ns;
    g_zl -= g_t * iN;
    if (big) gN += g_t * zl * iN * iN;
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
