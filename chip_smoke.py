#!/usr/bin/env python3
"""Chip smoke test of optiland_torch's main path on one CUDA card.

Builds the CUDA kernels of ``optiland_torch/csrc`` with nvcc, holds each
kernel against its plain PyTorch version on the card, and drives the paths
below at full width (2^24 rays, float32), each with the launch counts set
to 0 just before it and read just after:

  * the merit path (phase 7): the optimizer step of the fused RMS-spot
    merit, ``spot_rms_fast_field``, in-kernel PRNG pupil (merit_fwd,
    merit_bwd); every timed step here and below takes the value and the
    gradient with respect to every stack leaf;
  * the generic path (phase 10): the value and gradient of
    ``analysis.spot.rms_spot_size`` (generate_rays, then ``trace`` on the
    trace_fwd/trace_bwd kernels), pupil samples from prng_disk, and one
    ``Optic.trace`` of ~2^24 hexapolar rays;
  * the field path (phase 11): the value and gradient of the mean squared
    spot radius through ``trace_fast_field`` (trace_field_fwd,
    trace_field_bwd), as ``bench.py``'s ``pallas-field`` step;
  * the Huygens PSF path (phase 13): the value and gradient of the centre
    pixel of ``psf.huygens_psf`` at its defaults (128 x 128 image points,
    12,644 pupil points), with the wavefront and grid traces on
    trace_fwd/trace_bwd and the field sums on huygens_fwd,
    huygens_bwd_img and huygens_bwd_pup, whose parity phase 12 checks;
  * the polarized step (phase 15): ``bench.py``'s ``polarized`` class, the
    Fresnel-coated N-BK7 singlet in H polarization at 2^24 rays, the value
    and gradient of its merit through ``trace_fast_pol_intensity``
    (pol_fwd_intensity, pol_bwd_intensity), with its ``polarized_axis``
    and ``polarized_tmm`` classes and one polarized ``Optic.trace`` of
    ~2^24 rays (pol_fwd); phase 14 holds the polarized kernels against
    their plain versions;
  * the vectorial Huygens PSF path (phase 16): the value and gradient of
    the centre pixel of ``HuygensPSF`` of a polarized optic at its defaults
    (the polarized traces on pol_fwd/pol_bwd, three field sums per state on
    the Huygens kernels).
  * the polychromatic step (phase 17): ``bench.py``'s poly class, the
    Cooke triplet at 2^24 rays with wavelengths 0.48/0.55/0.65 um cycling by
    ray, the value and gradient (``mat_coeffs`` included) of the RMS-spot
    merit through ``trace_fast_poly`` (trace_fwd_poly, trace_bwd_poly);
    the poly kernels against their plain versions before it, on the Cooke
    triplet and on a variant whose media use every other formula code;
  * the tilted steps (phase 18): a toleranced Cooke triplet (every lens
    surface tilted by 0.5-2 mrad and decentred by 0.01-0.05 mm) through
    the merit (merit_fwd, merit_bwd), field (trace_field_fwd,
    trace_field_bwd) and generic (trace_fwd, trace_bwd) steps, and the
    polarized step of bench.py's singlet with its first surface tilted
    (pol_fwd_intensity, pol_bwd_intensity); every tilted kernel against its
    plain version before them, and the general tilt adjoint at zero angles
    against the untilted code;
  * the K6 steps (phases 19-20): the sag builds of every trace kernel
    (EVEN/ODD_ASPHERE and the annular clip) and their deep builds (more
    than 16 surfaces) against their plain versions at check size
    (AsphericSinglet, untilted, tilted and odd; HubbleTelescope, whose
    obscuration clips; ObjectiveUS008879901, 26 surfaces; the poly mode on
    the tilted asphere; K8/K9 on the Fresnel-coated asphere), then the
    merit, field and generic value+grad steps of bench.py's tilted_asphere,
    HubbleTelescope and ObjectiveUS008879901 at full width over every stack
    leaf, and the sag and deep kernels timed against their plain versions
    with their bounds;
  * the freeform steps (phases 21-22): the free build of every trace kernel
    (the Cartesian families POLYNOMIAL_XY, CHEBYSHEV, TOROIDAL, BICONIC)
    against its plain version at check size in f64, per ray and per
    gradient column (P_G1, P_G2 and each coefficient column) to 1e-11, on
    the freeform singlets of ``samples/freeform.py`` at (Hx, Hy) = (0.3,
    0.7), the tilted XY singlet and a 5 x 5 XY table, and K8/K9 on the
    Fresnel-coated XY singlet; then the merit, field and generic
    value+grad steps of the XY and toroidal singlets and the merit steps
    of the Chebyshev and biconic ones at full width over every stack leaf,
    the poly and polarized steps of the XY singlet, and the free kernels
    timed against their f32 plain versions with their bounds;
  * the aux-bearing steps (phases 23-24): the aux build of every trace
    kernel (the free build with their evaluator) on the ZERNIKE_SAG, FORBES_QBFS and FORBES_Q2D singlets of
    ``samples/freeform.py`` (their coefficient rows laid out, with the
    layout table), the tilted Zernike singlet and a 36-term fringe Zernike
    (a table of NC_MAX columns), and the deep_aux build on a 20-surface
    system behind a Zernike and a Q2d surface, against the plain versions
    at check size in f64 to 1e-11 per ray and per gradient column, and in
    f32 against the f64 plain versions; K8/K9 on the coated Zernike
    singlet; the poly and polarized kernels of each family timed at check
    size; then the merit, field and generic value+grad steps of the three
    singlets at full width over every stack leaf, the poly step of the Q2d
    singlet and the polarized step of the coated Zernike one, and the
    aux merit and trace kernels on each singlet timed against their f32
    plain versions with their bounds (kernel rows tagged with the family);
  * the grating steps (phases 25-26): the grat build of the six
    monochromatic kernels (K6c, grating diffraction) on the three golden
    grating lenses and the tilted one of ``samples/grating.py`` against
    their plain versions at check size in f64 to 1e-11 per ray and per
    gradient column (the grating's P_G1 and P_G2 included) and in f32
    against the f64 plain versions; a grating beside an asphere raising on
    the card with no launch; a polychromatic and a polarized grating trace
    on the plain engine on the card against the CPU; then the merit, field
    and generic value+grad steps of the three golden lenses at full width
    over every stack leaf (the period's and groove angle's gradients
    finite and nonzero), and the grat kernels on each lens timed against
    their f32 plain versions with their bounds (rows tagged with the lens);
  * the NURBS steps (phases 27-28): the nurbs build of every trace kernel
    (K6d, the two-plane (u, v) solve on a NURBS net; its own sources
    ``csrc/nurbs_*.cu``) on the three lenses of ``samples/nurbs.py`` and
    the tilted rational one against their plain versions at check size in
    f64 to 1e-11 per ray and per gradient column (the net's 4 nu nv
    columns included) and in f32 against the f64 plain versions, the poly
    mode on the rational lens, K8/K9 on its Fresnel-coated variant, and a
    NURBS surface beside an asphere raising on the card with no launch;
    then the merit, field and generic value+grad steps of the golden
    rational and conic-fit lenses at full width over every stack leaf
    (the net's gradient finite and nonzero), the poly and polarized steps
    of the rational lens, and each nurbs kernel's full-width launch held
    against its f32 plain version chunk by chunk (2^22 rays each) and
    timed against it, with its bound (rows tagged with the lens).

It prints:

  * the card's name and power limit (nvidia-smi);
  * one line per phase, each raising on a failed check;
  * a ``{"kernels": [...]}`` JSON line: per kernel its time at its path's
    shape, the plain version's time, its launches on the paths, and its
    bound (the larger of operations over the card's float32 peak and bytes
    over its memory rate);
  * as the last line, ``{"ok": true, "device": {...}}``.

Run it from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It exits non-zero without a CUDA device, and when the ``optiland_torch``
package is not beside it. Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet):
PEAK_F32_OPS = 67e12  # float32 outside the tensor cores, operations/s
PEAK_BYTES = 3.35e12  # HBM3, bytes/s
PEAK_F64_OPS = 34e12  # float64 outside the tensor cores (data sheet)

# Operations per ray counted from csrc/fused_trace.cu (one add, multiply,
# divide, sqrt, rsqrt, sin, cos, compare, select, abs or integer op each):
OPS_PRNG = 112  # 10 Philox rounds of 10 integer ops, 2 shifts, 2 int->float,
#                 2 scales, sqrt, 2pi multiply, cos, sin, 2 multiplies
OPS_LAUNCH = 4  # x = Px sx + x0, y = Py sy + y0
OPS_FWD_STANDARD = 109  # localize 3, intersect 48, propagate 6, normal 20,
#                          dot/sign/abs 10, refract 19, globalize 3
OPS_FWD_PLANE = 47  # localize 3, intersect 4, propagate 6, dot/sign/abs 10,
#                      refract 19, globalize 3 (normal is constant)
OPS_BWD_STANDARD = 260  # recomputed forward 90 + adjoint 170
OPS_BWD_PLANE = 90  # recomputed forward 40 + adjoint 50
OPS_STATS = 8  # block sums and centred squares per ray
OPS_SEED = 6  # dL/dx, dL/dy seeds
OPS_AIM_BWD = 10  # aim cotangents per ray (launch adjoint)
# Added by the full step of csrc/step.cuh (intensity and OPD), per surface:
OPS_FULL_FWD = 9  # OPD 3 (multiply, abs, add), clip 6 (r^2 3, ap^2, compare,
#                   select)
OPS_ABS_FWD = 5  # where the medium absorbs: 3 multiplies, exp, multiply
OPS_FULL_BWD = 23  # the forward's 9, clip adjoint 6, OPD adjoint 8
OPS_ABS_BWD = 18  # the forward's 5, exp and 12 multiplies/adds of its adjoint
# Operations per (image point, pupil point) pair, counted from
# csrc/huygens.cu (a sqrt, a divide and sincospi's sine and cosine count one
# each, as above):
OPS_PAIR = 27  # displacement 3, R^2 5, sqrt, 1/R, phase argument, sin, cos,
#                n.d 5, obliquity 3, amplitude times phase 6
OPS_FWD_ACC = 6  # two terms (2 multiplies each) and their sums
OPS_ADJ = 39  # the pair's adjoint: cotangents of the phase, 1/R, obliquity
#               and n.d 30, displacement cotangents 9
OPS_IMG_ACC = 3  # image-coordinate sums
OPS_PUP_EXTRA = 21  # normal cotangents 3, pre/pim cotangents 10, 8 sums
# Operations per ray and surface added by the polarized kernels, counted from
# csrc/pol_trace.cu as above (a 3-term dot product 5, a complex multiply 6,
# a complex divide 11). The backward is counted as the forward once plus the
# adjoint of each part; what the kernel recomputes (the step's forward in
# step_adjoint, the basis, the Jones matrix, q and r) is not work the
# function needs and is not counted again.
OPS_STEP_ADJ = {1: 170, 0: 50}  # the step's adjoint by geometry code
#                                 (standard, plane): OPS_BWD_* less the
#                                 recomputed forward
OPS_FULL_ADJ = 14  # clip adjoint 6, OPD adjoint 8
OPS_EXTRAS_ADJ = 10  # the cotangents of adot and of the pre/post directions
#                      into the step's
OPS_POL_BASIS = 46  # k0 x k1 9, the fallback test 4, |s| 6, 3 divides, two
#                     cross products 18, the degenerate test and selects 6
OPS_POL_BASIS_ADJ = 86  # 4 crosses added 48, s.g 5, the normalization 9,
#                         the cross product's adjoint 24
OPS_POL_UPDATE = 282  # q = O_in p 90, r = J q 102, O_out^T r 90
OPS_POL_UPDATE_ADJ = 593  # g_r 90, g_Oout 99, g_q 102, g_J 110, g_Oin 99,
#                           the cotangent of p 90, the basis rows 3
OPS_POL_JONES = {"none": 0, "simple": 1, "fresnel": 35, "polarizer": 35,
                 "retarder": 40}  # tmm: OPS_TMM_BASE + OPS_TMM_LAYER x L
OPS_POL_JONES_ADJ = {"none": 0, "simple": 3, "fresnel": 93,
                     "polarizer": 79, "retarder": 69}
#  fresnel: two complex-divide adjoints 60, the rest 33; polarizer: 12, two
#  unit-vector adjoints 30, the axis and basis cotangents 37; retarder: 30,
#  a unit-vector adjoint 15, the axis and basis cotangents 24
OPS_TMM_BASE = 50  # u2 3, cos in the substrate 5, 2 x (eta 2, den 6, out 13)
OPS_TMM_LAYER = 42  # per layer, both polarizations: cos 5, delta 2, cos,
#                     sin, eta 1, the layer product 12 (x 2 less shared)
OPS_TMM_ADJ_BASE = 130  # per polarization the output's adjoint 23, the
#                         eta/den cotangents 18, eta's adjoint 10; the
#                         substrate cosine's adjoint and the coat row 27
OPS_TMM_ADJ_LAYER = 141  # per layer, 2 x 57 (the product's adjoint), and
#                          the phase and cosine adjoints 27
OPS_POL_EXIT = (17, 96)  # (launch basis 15 and the scale 2, per state:
#                           field 12, p E 72, |E|^2 12)
OPS_POL_EXIT_ADJ = (41, 180)  # (the launch basis' adjoint 37 and 4, per
#                               state: g_E 12, g_p 72, the field's 96)
# Operations per ray added by a tilted surface in every kernel's TILT
# instantiation, counted from csrc/step.cuh (a plane rotation rot_ab is 4
# multiplies and 2 adds). A backward counts the forward's once and their
# adjoint; the rotations it recomputes are not counted again.
OPS_TILT_FWD = 72  # rot_local and rot_global, 6 plane rotations each
OPS_TILT_ADJ = 147  # rot_global_adjoint and rot_local_adjoint: 6 angle
#                     derivatives (4 multiplies, 3 adds) and their sums
#                     48, 24 back-rotations of the state and its cotangents
#                     144, less the zero-tilt generator terms they replace
#                     (3 x 15)
# Operations per ray of a surface of a Newton family (EVEN/ODD_ASPHERE) in
# the SAG and DEEP builds, counted from csrc/step.cuh as above, for nc
# coefficients and newton_iters steps: the forward takes newton_iters + 1
# steps (the last the one the gradient runs through) from the conic's closed
# form, and its normal from one more sag evaluation; the backward counts
# the forward once and the adjoint.
OPS_NEWTON_START = 3  # isfinite and select over the closed form
OPS_NEWTON_STEP = 43  # X, Y 4, r^2 3, f 4, f' 5, clamp 3, t - f/f' 2, and
#                       sag_point's conic terms 10, rho, s and W sums 12
OPS_NEWTON_COEF = 5  # per coefficient and sag evaluation: two Horner steps
OPS_NEWTON_NORMAL = 30  # sag_point 22, (x W, y W) rsqrt 8, in place of the
#                         conic normal's 20
OPS_NEWTON_ADJ = 110  # two sag points' second-derivative and parameter
#                       terms 2 x 25, the normal's adjoint 25, the step's 35
OPS_NEWTON_ADJ_COEF = 14  # per coefficient: two Horner steps of the second
#                           derivative 6, the column and its sum 8
OPS_ANNULAR = 6  # the annular clip of the full step (sag and deep builds,
#                  every surface): r^2 3, ap_min^2, compare, select
# Operations per ray of a surface of a Cartesian family (POLYNOMIAL_XY 4,
# CHEBYSHEV 5, TOROIDAL 7, BICONIC 8) in the FREE and DEEP_FREE builds:
# what the function needs, not the port's explicit-basis recurrences. A
# table of side n = ceil(sqrt(nc)) is summed as the radial families' are,
# by Horner's rule (CHEBYSHEV by Clenshaw's): each table entry is one step
# of its row's inner sums, each row (or each index of a one-dimensional
# basis) one step of the outer sums; an FMA counts 2, as above. Each entry
# is (base, per entry, per row); the step adds 15 (X, Y 4, f 3, f' 4,
# clamp 2, t - f/f' 2), the normal its normalization 8.
OPS_CART_POINT = {  # s, sx, sy at a point
    4: (19, 4, 6),  # the conic base 19; per entry the row's value and its
    #                 y-derivative (2 FMAs); per row s, sx, sy (3 FMAs)
    5: (23, 7, 10),  # base and t = X / p1, Y / p2 with the slopes' 1 / p1,
    #                  1 / p2 (4); per entry Clenshaw's step of the row (FMA,
    #                  add) and of its derivative (2 FMAs); per row the outer
    #                  steps of s 3, sx 4, sy 3
    7: (33, 5, 0),  # the toroid's profile and rotation 33; per coefficient
    #                 two Horner steps of z_y and z_y' (as OPS_NEWTON_COEF)
    8: (30, 0, 0)}  # the two conic profiles
OPS_CART_NORMAL = {  # the normal's slopes at a point
    4: OPS_CART_POINT[4], 7: OPS_CART_POINT[7], 8: OPS_CART_POINT[8],
    5: (35, 4, 16)}  # the reference's dT convention: base 19, t 2, clip,
#                      acos, max and sqrt of each direction 14; per entry
#                      the row's sums over T_j and dT_j (2 FMAs); per row
#                      T_i 2 and dT_i = i sin(i th) / D 4 in each direction
#                      and the outer sums of sx, sy (2 FMAs)
OPS_CART_GRAD = {  # the adjoint's point at the Newton iterate: s, sx, sy,
    #                the Hessian and their radius, conic, p1, p2 derivatives
    4: (45, 6, 12),  # per entry the row's value, first and second
    #                  y-derivatives (3 FMAs); per row the outer sums s, sx,
    #                  sxx, sy, sxy, syy (6 FMAs)
    5: (61, 11, 21),  # base and the normalization 4, the p1, p2
    #                   derivatives from the slopes and the Hessian (d/dp1 =
    #                   -(X / p1) d/dX and its chain) 12; per entry
    #                   Clenshaw's steps of the value 3 and of both
    #                   derivatives 4 + 4; per row the outer steps of s, sx,
    #                   sxx (3, 4, 4), sy, sxy (3, 4) and syy 3
    7: (110, 7, 0),  # per coefficient the Horner steps of z_y, z_y' and
    #                  z_y'' (2, 2, 3)
    8: (60, 0, 0)}
OPS_CART_GRAD_NORMAL = {  # the same at the normal's point, for its slopes
    4: OPS_CART_GRAD[4], 7: OPS_CART_GRAD[7], 8: OPS_CART_GRAD[8],
    5: (71, 8, 48)}  # base 45, the dT convention's clip, acos, sqrt 14 and
#                      the p1, p2 derivatives 12; per entry the row's sums
#                      over T_j, dT_j, T_j', dT_j' (4 FMAs); per row T_i 2,
#                      T_i' 4, dT_i 4 and its derivative 8 in each direction,
#                      and the outer sums of the two slopes and their four
#                      derivatives (6 FMAs)
OPS_CART_COL = {  # each coefficient column: (per column, per row)
    4: (15, 8),  # per column at the Newton point three basis products and
    #              a phi + b phi_x + c phi_y (3 + 5), at the normal's point
    #              two products and their weights (2 + 3), the sum of both
    #              1, the warp sum 1; per row x^i, i x^(i-1) at both points
    #              in both directions (2 x 2 x 2)
    5: (15, 24),  # per row T_i 2 and T_i' 4 at the Newton point, T_i 2
    #               and dT_i 4 at the normal's, in both directions
    7: (12, 0),  # per coefficient and point the power y^(2i+2), its
    #              derivative term and their weights (1 + 1 + 3), the sum
    #              of both 1, the warp sum 1
    8: (0, 0)}
OPS_CART_ADJ = 96  # the normal's adjoint 25, the step's 45, the weights 6,
#                    the P_G1 and P_G2 columns 20
# The aux-bearing Cartesian families (ZERNIKE_SAG 6, FORBES_QBFS 9,
# FORBES_Q2D 10) over the nc slots of their laid-out row: per point (base,
# per slot). Per slot the three-term recurrence of phi and phi' (the
# constant a + b v, then 2 + 3 FMAs: 11), the angular factor Re or Im of
# z^m and its slopes (4, the power's update amortized over a block), the
# slot's terms of s, sx, sy (15); a Forbes slot 2 more, the v (1 - v)
# factor of its m = 0 blocks. The base: the conic 19, v, its slopes and z
# 8, the slopes' sums 3 (ZERNIKE_SAG); Forbes' clamped conic 21, v and z
# 8, the conic factor Phi and Phi_r 25, the cut 2, the sums with Phi 6.
OPS_AUX_POINT = {6: (30, 30), 9: (62, 32), 10: (62, 32)}
# the adjoint's points (s, sx, sy, the Hessian and the radius, conic and
# p1 derivatives): per slot also phi'' 5, the v (1 - v) factor's F'' 2,
# the angular second derivatives 4, the Hessian's three sums 24 and the p1
# sums 30; the base the Hessian's conic terms 12, dR and dk 20, the
# weights 4 (ZERNIKE_SAG 66); Forbes also Phi's five derivatives in r^2,
# k and cu^2 40 and their products with the sums 34
OPS_AUX_GRAD = {6: (66, 95), 9: (140, 97), 10: (140, 97)}
OPS_AUX_COL = 48  # per slot column: the recurrences and angular factors at
#                   both points (2 x 15), the three weighted terms at each
#                   (2 x 8), the sum of both 1, the warp sum 1
# Operations per ray of a grating surface (K6c) in the GRAT build, counted
# from csrc/step.cuh (grat_fwd, grat_adjoint) as above; they take the place
# of the refraction (its 19 forward, 35 in the adjoint) on that surface.
OPS_REFRACT = (19, 35)
OPS_GRAT_FWD = {0: 62,  # plane: the groove vector 3 (sin, cos, negate);
                #          d_eff 7, n_post 1, f.n 5, k - adot n 6, P 16, D 1,
                #          rad 7, the propagation test 1, root 2, the sign 1,
                #          the directions 12
                1: 101}  # conic: its groove frame 42 (r^2 3, the root's
#                          argument 5, clamp 2, sqrt, R x, tan, dz/dxi 3, the
#                          tangent's norm 5 and 3 divides, n x t 9, |n x t|
#                          6, f 3) and the 59 above
OPS_GRAT_ADJ = {0: 114,  # the diffraction's adjoint 109 (the cotangents of
                #           P, n, root, D, rad, d_eff, the indices, f and
                #           the clamp), the groove vector's 5
                1: 203}  # and the groove frame's 94 (|g| normalization 20,
#                          two cross products 18, the tangent's norm 13, dz/
#                          dxi 11, tan 3, the root and its clamp 20, the raw
#                          normal's cotangent 3)
# Operations per ray of a NURBS surface (K6d, code 12) in the NURBS build,
# counted from csrc/nurbs_step.cuh as above for degrees (p, q): what the
# function needs on the ray's span, not the columns the kernel sweeps. A
# basis entry of the Cox-de Boor triangle (p (p + 3) / 2 per direction,
# the derivatives carried along) is 2 knot differences, 2 divides, the
# value 3 and the first derivative 6 (20 with the reciprocals), 26 with
# the second; a control point of the span adds its products b, b_u, b_v
# (3) and per sum W b and its 4 FMAs (8: 3 sums, 6 with the second
# derivatives); the quotient S, S_u, S_v 20 (50 with the second
# derivatives). The forward: the planes 30, the corner guess 10, then
# newton_iters + 1 steps (an evaluation and the residuals 30, det 3,
# clamp 2, du and dv 8, clips 4: 47) and the point's evaluation, t 8 and
# the normal 22, in place of the plane's intersection (4). The adjoint:
# the corrected point's second-order evaluation, the chain back through
# the normal, t, the clip, the correction and the planes (150), and per
# control point of the span at both points its 4 columns (30 each point).
OPS_NU_ENTRY = (20, 26)
OPS_NU_CTRL = (27, 54)
OPS_NU_QUOT = (20, 50)
OPS_NU_STEP = 47
OPS_NU_FWD_BASE = 30 + 10 + 8 + 22 - 4
OPS_NU_ADJ = 150
OPS_NU_COL = 60


def nurbs_ops(net, niters):
    """(forward, adjoint) operations per ray of a NURBS surface's geometry
    beyond the plane step's (OPS_FWD_PLANE, OPS_STEP_ADJ[0])."""
    _, _, _, p, q, _, _ = net
    ctrl = (p + 1) * (q + 1)
    tri = p * (p + 3) // 2 + q * (q + 3) // 2

    def point(o):
        return OPS_NU_ENTRY[o] * tri + OPS_NU_CTRL[o] * ctrl + OPS_NU_QUOT[o]

    fwd = OPS_NU_FWD_BASE + (niters + 1) * (point(0) + OPS_NU_STEP) + point(0)
    return fwd, point(1) + OPS_NU_ADJ + OPS_NU_COL * ctrl


POL_NAMES = ("pol_fwd", "pol_fwd_intensity", "pol_bwd", "pol_bwd_intensity")
# the golden grating lenses of phase 26 (samples/grating.py)
GRAT_NAMES = ("plane_grating", "curved_grating", "refl_grating")
# the NURBS lenses of phase 28 (samples/nurbs.py: the golden rational net
# and the golden conic fit), and the nurbs build's sources by kernel family
NURBS_TAGS = ("rational", "fitted")
NURBS_SOURCES = {"merit": "optiland_torch/csrc/nurbs_merit.cu",
                 "trace": "optiland_torch/csrc/nurbs_trace.cu",
                 "pol": "optiland_torch/csrc/nurbs_pol.cu"}
NEWTON_CODES = (2, 3, 4, 5, 6, 7, 8, 9, 10)  # radial and Cartesian families


def geo_ops(code, nc, niters, grating=False, net=None):
    """(forward, adjoint) operations per ray of one surface step's geometry
    by its code: PLANE and STANDARD as counted above (a ``grating`` one
    diffracting in place of the refraction), a Newton family
    (codes 2, 3 radial; 4, 5, 7, 8 Cartesian; 6, 9, 10 aux-bearing, nc the
    slots of the laid-out table) with its newton_iters + 1 steps and nc
    coefficients, a NURBS surface (12) of net structure ``net``
    (nurbs_ops). The adjoint excludes the recomputed forward
    (OPS_STEP_ADJ)."""
    if code == 12:
        fwd, adj = nurbs_ops(net, niters)
        return OPS_FWD_PLANE + fwd, OPS_STEP_ADJ[0] + adj
    if grating:
        fwd, adj = geo_ops(code, nc, niters)
        return (fwd - OPS_REFRACT[0] + OPS_GRAT_FWD[code],
                adj - OPS_REFRACT[1] + OPS_GRAT_ADJ[code])
    if code in OPS_AUX_POINT:
        (bp, sp), (bg, sg) = OPS_AUX_POINT[code], OPS_AUX_GRAD[code]
        point, grad = bp + sp * nc, bg + sg * nc
        fwd = (OPS_FWD_STANDARD - 20 + OPS_NEWTON_START
               + (niters + 1) * (point + 15) + point + 8)
        return fwd, (OPS_STEP_ADJ[1] + 2 * grad + OPS_CART_ADJ
                     + OPS_AUX_COL * nc)
    if code in OPS_CART_POINT:
        side = math.isqrt(nc) + (math.isqrt(nc) ** 2 < nc)

        def cost(table):
            base, entry, row = table[code]
            return base + entry * nc + row * side

        fwd = (OPS_FWD_STANDARD - 20 + OPS_NEWTON_START
               + (niters + 1) * (cost(OPS_CART_POINT) + 15)
               + cost(OPS_CART_NORMAL) + 8)
        col, col_row = OPS_CART_COL[code]
        return fwd, (OPS_STEP_ADJ[1] + cost(OPS_CART_GRAD)
                     + cost(OPS_CART_GRAD_NORMAL) + OPS_CART_ADJ
                     + col * nc + col_row * side)
    if code in (2, 3):
        fwd = (OPS_FWD_STANDARD - 20 + OPS_NEWTON_START
               + (niters + 1) * (OPS_NEWTON_STEP + OPS_NEWTON_COEF * nc)
               + OPS_NEWTON_NORMAL + OPS_NEWTON_COEF * nc)
        return fwd, OPS_STEP_ADJ[1] + OPS_NEWTON_ADJ + OPS_NEWTON_ADJ_COEF * nc
    return ((OPS_FWD_STANDARD, OPS_STEP_ADJ[1]) if code == 1
            else (OPS_FWD_PLANE, OPS_STEP_ADJ[0]))


# bench.py's poly class: wavelengths (um) cycling by ray index
POLY_WLS = (0.48, 0.55, 0.65)


def formula_ops(code, nm):
    """(forward, adjoint) operations per ray of one evaluation of dispersion
    formula ``code`` over ``nm`` coefficients, counted from step.cuh's
    n_formula and dn_dcoef, a pow as 3 (log, multiply, exp), a divide, a
    square root or a log as 1, every term of the fixed-width row (the
    zero-padded ones run too): the forward's value; the adjoint's
    derivative of each coefficient the formula reads, with its product by
    the index cotangent."""
    npair = (nm - 1) // 2
    npair4 = (nm - 9) // 2 if nm > 9 else 0
    return {
        0: (0, 2),
        1: (3 + 5 * npair, 2 + 14 * npair),
        2: (3 + 4 * npair, 2 + 11 * npair),
        3: (3 + 5 * npair, 2 + 14 * npair),
        4: (22 + 5 * npair4, 122 + 14 * npair4),
        5: (1 + 5 * npair, 2 + 14 * npair),
        6: (3 + 3 * npair, 2 + 10 * npair),
        7: (8 + 5 * (nm - 3), 8 + 5 * (nm - 3)),
        8: (12, 40),
        9: (14, 72),
        11: (12, 60),
    }[code]


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(ok, msg):
    if not ok:
        fail(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def rel(a, b):
    a, b = (float(v.detach()) if hasattr(v, "detach") else float(v)
            for v in (a, b))
    return abs(a - b) / max(abs(b), 1e-300)


# Roundings of a float32 OPD of the wavefront, each at most 2^-24 of the
# path scale: per path (the ray's and the chief ray's) the three surface
# segments (intersection distance, its product with n, the running sum),
# the reference-sphere distance and the subtraction, ~13 each
N_ROUND_WF = 26


def psf_f32_bound(torch, hu, data, data32, img, norm, psf, wl_um, m=5.0):
    """Per-pixel bound on |psf_f32 - psf| for the f64 vectorial PSF ``psf``
    (normalized by ``norm``) of the f64 wavefront ``data`` on the image
    points ``img``, given the f32 wavefront ``data32`` of the same pupil
    points; returns (bound, sigma, parts).

    Each term T_q of a field sum carries an error of relative RMS sigma:
    the f32 wavefront's own (its phase 2 pi dOPD, its pupil points' k |dp|
    and its fields' |dE| / |E|, measured against ``data`` as RMS values
    weighted by |E|^2) and the sum's phase rounding k R_max 2^-24
    (hu.f32_bound). For independent errors a sum F = sum_q T_q becomes
    F e^(-sigma^2 / 2) plus a random part of RMS sigma sqrt(S2), S2 =
    sum_q |T_q|^2, so

        | |F_f32|^2 - |F|^2 | <= 2 sigma^2 |F|^2 + 2 m sigma |F| sqrt(S2)
                                 + m^2 sigma^2 S2

    (the coherent loss counted twice, the random part to m of its RMS),
    summed over the components by Cauchy-Schwarz. The normalization, the
    same sum at one point with zero OPD, gets the same bound; psf = 100
    |F|^2 / norm then takes both."""
    k = 2.0 * math.pi / (wl_um * 1e-3)
    px, py, pz = data.pupil_x, data.pupil_y, data.pupil_z
    _, kr = hu.f32_bound(img, (px, py, pz), k)
    valid = data.intensity > 0
    a2 = sum(torch.where(valid, E[:, c], 0).abs() ** 2
             for E in data.E_exits for c in range(3))
    w = a2 / a2.sum()

    def rms(err):
        err = torch.where(valid, err, 0)
        return float(torch.sqrt((w * err**2).sum()))

    def diff(u, v):
        return (u.to(v.dtype) - v).abs()

    dp = torch.sqrt(sum(diff(u, v) ** 2 for u, v in zip(
        (data32.pupil_x, data32.pupil_y, data32.pupil_z), (px, py, pz))))
    de = torch.sqrt(sum(diff(u, v) ** 2 for e32, e64 in zip(
        data32.E_exits, data.E_exits) for u, v in zip(e32.T, e64.T)))
    parts = {
        "sigma_phase": rms(2 * math.pi * diff(data32.opd, data.opd)),
        "sigma_pos": rms(k * dp),
        "sigma_amp": rms(de / torch.sqrt(a2).clamp_min(1e-300)),
        "sigma_sum": kr,
    }
    sigma = math.sqrt(sum(v * v for v in parts.values()))
    nx, ny, nz = (v / data.radius for v in (px, py, pz))

    def s2_of(ix, iy, iz):
        out = []
        rows = max(1, hu.PLAIN_PAIRS // px.shape[0])
        for a in range(0, ix.shape[0], rows):
            dx, dy, dz = (i[a:a + rows, None] - p[None, :]
                          for i, p in ((ix, px), (iy, py), (iz, pz)))
            R = torch.sqrt(dx * dx + dy * dy + dz * dz)
            obl = 0.5 * (1.0 + (dx * nx + dy * ny + dz * nz) / R)
            out.append(((obl / R) ** 2) @ a2)
        return torch.cat(out)

    def bound_of(f2, s2):
        return (2 * sigma**2 * f2 + 2 * m * sigma * torch.sqrt(f2 * s2)
                + (m * sigma) ** 2 * s2)

    s2 = s2_of(*img).reshape(psf.shape)
    zero = img[0].new_zeros(1)
    s2_n = s2_of(zero, zero, img[2][:1])[0]
    raw = psf * norm / 100.0
    b_n = bound_of(norm, s2_n)
    bound = 100.0 * (bound_of(raw, s2) + psf / 100.0 * b_n) / (norm - b_n)
    parts["norm_rel"] = float(b_n / norm)
    return bound, sigma, parts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check-log2", type=int, default=20,
                    help="log2 of the ray count of the parity phases")
    ap.add_argument("--full-log2", type=int, default=24,
                    help="log2 of the ray count of the main path")
    ap.add_argument("--steps", type=int, default=20,
                    help="timed value+grad steps of the main path")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import optiland_torch
    except ImportError as e:
        print(f"chip_smoke: optiland_torch is not beside this script ({e})",
              file=sys.stderr)
        return 1
    if not os.path.abspath(optiland_torch.__file__).startswith(HERE + os.sep):
        print("chip_smoke: optiland_torch was imported from elsewhere: "
              f"{optiland_torch.__file__}", file=sys.stderr)
        return 1

    from optiland_torch import config
    from optiland_torch.analysis import rms_spot_size
    from optiland_torch.core import raygen
    from optiland_torch.core.geometry import CART_CODES
    from optiland_torch.ops import _cuda
    from optiland_torch.ops import fast_trace as ftr
    from optiland_torch.ops import fused_trace as ft
    from optiland_torch.ops import huygens as hu
    from optiland_torch.ops import pol_trace as pt
    from optiland_torch.ops.launch import BUILD_SUFFIX, launch_key
    from optiland_torch.optic import Optic
    from optiland_torch.psf import HuygensPSF, huygens_psf, pupil_grid_coords
    from optiland_torch.ops import launch as launch_build
    from optiland_torch.core import trace as trace_core
    from optiland_torch.samples import (
        AsphericSinglet, CookeTriplet, freeform, grating, nurbs, perturbed,
        registry,
    )

    # the NURBS lenses of phases 27-28 (samples/nurbs.py)
    NURBS_LENSES = {"rational": nurbs.rational_nurbs,
                    "fitted": nurbs.fitted_nurbs,
                    "bspline": nurbs.bspline_nurbs,
                    "tilted": nurbs.tilted_nurbs}

    def reset_counts():
        ft.reset_launch_counts()
        ftr.reset_launch_counts()
        hu.reset_launch_counts()
        pt.reset_launch_counts()

    def counts():
        return {**ft.LAUNCHES, **ftr.LAUNCHES, **hu.LAUNCHES, **pt.LAUNCHES}

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    config.set_device("cuda")
    report = {"phases": {}}

    # ---- phase 1: the card ----
    card = card_line()
    log(card)
    report["card"] = card

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    log(f"build: nvcc {_cuda.BUILD_SECONDS:.1f} s, load {build_s:.1f} s "
        f"({' '.join(_cuda.NVCC_FLAGS)})")
    builds = {b: suf[1:] or "stock" for b, suf in BUILD_SUFFIX.items()}
    for line in _cuda.BUILD_LOG.splitlines():
        m = re.search(r"Compiling entry.*?\d([a-z_]+_kernel)I([fd])"
                      r"((?:L[bi]\d+E)*)E", line)
        if m:
            name, targs = m.group(1), re.findall(r"L[bi]\d+", m.group(3))
            labels = {"huygens_img_kernel": {"Li0": "forward",
                                             "Li1": "image adjoint"},
                      "pol_fwd_kernel": {"Lb0": "full", "Lb1": "intensity"},
                      "pol_bwd_kernel": {"Lb0": "full", "Lb1": "intensity"},
                      "trace_fwd_kernel": {"Lb0": "", "Lb1": ""},
                      "trace_bwd_kernel": {"Lb0": "", "Lb1": ""}}
            kind = [labels.get(name, {}).get(a, "") for a in targs]
            if name.startswith("trace_"):
                kind = [("field" if targs[0] == "Lb1" else "generic")
                        + (", poly" if targs[1] == "Lb1" else "")]
                targs = targs[2:]
            elif name.startswith("pol_"):
                targs = targs[1:]
            if name.startswith(("trace_", "pol_", "merit_")) and targs:
                kind.append(builds[int(targs[-1][2:])])
            kind = [k for k in kind if k]
            log(f"  ptxas: {name}<"
                f"{'float' if m.group(2) == 'f' else 'double'}"
                f"{''.join(', ' + k for k in kind)}>")
        elif ("registers" in line or "spill" in line or "error" in line
              or line.startswith("nvcc ")):
            log(f"  ptxas: {line.strip()}")
    report["build"] = {"seconds": build_s, "log": _cuda.BUILD_LOG}

    Rc = 1 << args.check_log2
    Rf = 1 << args.full_log2
    H = (0.0, 0.7)
    WL = 0.55
    kerr = {}

    # ---- phase 3: prng_disk against the plain Philox ----
    seed3, off3 = 0x1234_5678_9ABC, 12345
    for dt, tol in ((torch.float32, 1e-6), (torch.float64, 1e-14)):
        k = ft.prng_disk(seed3, Rc, off3, dt, dev, with_u=True)
        p = ft.prng_disk_plain(seed3, Rc, off3, dt, dev, with_u=True)
        torch.cuda.synchronize()
        check(torch.equal(k[2], p[2]) and torch.equal(k[3], p[3]),
              f"prng_disk {dt}: raw u values differ from the plain Philox")
        err = max(float((k[0] - p[0]).abs().max()),
                  float((k[1] - p[1]).abs().max()))
        check(err <= tol, f"prng_disk {dt}: |Px/Py - plain| = {err} > {tol}")
        log(f"phase 3 prng_disk {str(dt)[6:]}: u identical, "
            f"max |dP| = {err:.3e} (tol {tol})")
        report["phases"][f"prng_disk_{dt}"] = err

    # ---- systems, samples, tables ----
    systems = {}
    for name, dt in (("f64", torch.float64), ("f32", torch.float32)):
        config.set_precision("float64" if dt == torch.float64 else "float32")
        systems[name] = CookeTriplet().system
    rng = np.random.default_rng(2024)
    r = np.sqrt(rng.uniform(size=Rc))
    th = rng.uniform(0, 2 * np.pi, size=Rc)
    Px64 = torch.tensor(r * np.cos(th), dtype=torch.float64, device=dev)
    Py64 = torch.tensor(r * np.sin(th), dtype=torch.float64, device=dev)
    spec = ft._spec_of(systems["f64"])
    S = systems["f64"].cfg.num_surfaces
    nc = systems["f64"].stack.coeffs.shape[1]

    def tables(system):
        with torch.no_grad():
            return (ft.build_param_table(system, WL).contiguous(),
                    ft.aim_vector(system, *H).contiguous())

    # ---- phase 4: merit_fwd against the plain version ----
    p64, a64 = tables(systems["f64"])
    rows_k = ft.merit_fwd(p64, a64, spec, Rc, Px=Px64, Py=Py64)
    rows_p = ft.merit_fwd_plain(p64, a64, spec, Rc, Px=Px64, Py=Py64)
    loss_k, xb, yb = ft._chan_combine(rows_k, Rc)
    loss_p = ft._chan_combine(rows_p, Rc)[0]
    e = rel(loss_k, loss_p)
    check(e <= 1e-12, f"merit_fwd f64: loss rel err {e} > 1e-12")
    p32, a32 = tables(systems["f32"])
    rows32 = ft.merit_fwd(p32, a32, spec, Rc, Px=Px64.float(), Py=Py64.float())
    loss32 = ft._chan_combine(rows32, Rc)[0]
    e32 = rel(loss32, loss_k)
    check(e32 <= 1e-4, f"merit_fwd f32: loss rel err vs f64 {e32} > 1e-4")
    log(f"phase 4 merit_fwd: f64 loss {float(loss_k):.15e} rel err vs plain "
        f"{e:.2e} (tol 1e-12); f32 rel err vs f64 {e32:.2e} (tol 1e-4)")
    report["phases"]["merit_fwd"] = {"f64_rel": e, "f32_rel": e32}

    # ---- phase 5: merit_bwd against the hand adjoint and autograd ----
    def leaf_system(system):
        leaves = {k: v.detach().clone().requires_grad_(v.numel() > 0)
                  for k, v in system.stack.leaves().items()}
        return system.replace(stack=system.stack.replace(**leaves)), leaves

    def leaf_grads(system, flat):
        """Stack-leaf gradients of a flat (params, coeffs, aim) cotangent."""
        s2, leaves = leaf_system(system)
        params = ft.build_param_table(s2, WL)
        aim = ft.aim_vector(s2, *H)
        dparams = flat[: S * ft.NUM_P].reshape(S, ft.NUM_P)
        daim = flat[S * (ft.NUM_P + nc):]
        used = {k: v for k, v in leaves.items() if v.requires_grad}
        gs = torch.autograd.grad([params, aim], list(used.values()),
                                 [dparams, daim], allow_unused=True)
        out = {k: (torch.zeros_like(v) if g is None else g)
               for (k, v), g in zip(used.items(), gs)}
        out["coeffs"] = out["coeffs"] + flat[
            S * ft.NUM_P : S * (ft.NUM_P + nc)].reshape(S, nc)
        return out

    def autograd_flat(params, aim, stats, Px, Py):
        p = params.detach().clone().requires_grad_()
        a = aim.detach().clone().requires_grad_()
        x, y = ft.trace_xy_plain(p, a, spec, Px, Py)
        merit = stats[2] * ((x - stats[0]) ** 2 + (y - stats[1]) ** 2).sum()
        gp, ga = torch.autograd.grad(merit, [p, a])
        return torch.cat([gp.reshape(-1), p.new_zeros(S * nc), ga])

    def compare_leaves(ga, gb, rtol, what):
        """|a - b| <= rtol |b| + atol on every entry where the reference b
        is finite, with atol = 1e-12 x the largest |b|: entries that are
        rounding noise about an exact zero (d/d rz of a rotationally
        symmetric surface, ~1e-18) sit far below it."""
        scale = max(float(v[torch.isfinite(v)].abs().max())
                    for v in gb.values() if bool(torch.isfinite(v).any()))
        atol = 1e-12 * scale
        worst = 0.0
        for k, vb in gb.items():
            va = ga[k]
            fin = torch.isfinite(vb)
            if not bool(fin.any()):
                continue
            d = (va[fin] - vb[fin]).abs()
            ok = d <= rtol * vb[fin].abs() + atol
            check(bool(ok.all()), f"{what}: leaf {k} differs: max |d| "
                  f"{float(d.max()):.3e}, ref {vb[fin].tolist()}, "
                  f"got {va[fin].tolist()}")
            big = vb[fin].abs() > 1e-6 * scale  # the entries that matter
            if bool(big.any()):
                worst = max(worst, float((d[big] / vb[fin][big].abs()).max()))
        return worst

    stats64 = torch.stack([xb, yb, torch.tensor(1.0 / Rc, device=dev,
                                                 dtype=torch.float64),
                           torch.zeros((), device=dev, dtype=torch.float64)])
    flat_k = ft.merit_bwd(p64, a64, stats64, spec, nc, Rc, Px=Px64, Py=Py64)
    flat_p = ft.merit_bwd_plain(p64, a64, stats64, spec, nc, Rc, Px=Px64,
                                Py=Py64)
    flat_a = autograd_flat(p64, a64, stats64, Px64, Py64)
    torch.cuda.synchronize()
    g_k = leaf_grads(systems["f64"], flat_k)
    w_hand = compare_leaves(g_k, leaf_grads(systems["f64"], flat_p), 1e-9,
                            "merit_bwd f64 vs hand adjoint")
    w_auto = compare_leaves(g_k, leaf_grads(systems["f64"], flat_a), 1e-9,
                            "merit_bwd f64 vs autograd")
    # the entry point (autograd.Function over the kernels) end to end
    s64, lv64 = leaf_system(systems["f64"])
    ft.spot_rms_fast_field(s64, *H, WL, Px=Px64, Py=Py64).backward()
    g_entry = {k: v.grad for k, v in lv64.items() if v.requires_grad}
    w_entry = compare_leaves(g_entry, leaf_grads(systems["f64"], flat_a),
                             1e-9, "spot_rms_fast_field f64 vs autograd")
    s32, lv32 = leaf_system(systems["f32"])
    ft.spot_rms_fast_field(s32, *H, WL, Px=Px64.float(),
                           Py=Py64.float()).backward()

    def finite_vec(g, ref):
        parts_a, parts_b = [], []
        for k, vb in ref.items():
            fin = torch.isfinite(vb)
            parts_a.append(g[k].double()[fin])
            parts_b.append(vb[fin])
        return torch.cat(parts_a), torch.cat(parts_b)

    va, vb = finite_vec({k: v.grad for k, v in lv32.items()
                         if v.requires_grad}, g_entry)
    l2 = float(torch.linalg.vector_norm(va - vb) / torch.linalg.vector_norm(vb))
    check(l2 <= 1e-3, f"merit_bwd f32: relative L2 gradient error {l2} > 1e-3")
    log(f"phase 5 merit_bwd f64 (worst rel err over entries above 1e-6 x "
        f"the largest): vs hand adjoint {w_hand:.2e}, "
        f"vs autograd {w_auto:.2e}, entry point vs autograd {w_entry:.2e} "
        f"(tol 1e-9); f32 L2 rel err vs f64 {l2:.2e} (tol 1e-3)")
    report["phases"]["merit_bwd"] = {"hand": w_hand, "autograd": w_auto,
                                     "entry": w_entry, "f32_l2": l2}

    # ---- phase 6: the PRNG contract ----
    seed6 = 77
    sa, la = leaf_system(systems["f64"])
    loss_prng = ft.spot_rms_fast_field(sa, *H, WL, num_rays=Rc, seed=seed6)
    loss_prng.backward()
    Pxs, Pys = ft.prng_pupil_samples(seed6, Rc, dtype=torch.float64,
                                     device=dev)
    sb, lb = leaf_system(systems["f64"])
    loss_expl = ft.spot_rms_fast_field(sb, *H, WL, Px=Pxs, Py=Pys)
    loss_expl.backward()
    e6 = rel(loss_prng, loss_expl)
    check(e6 <= 1e-12, f"PRNG contract: loss rel err {e6} > 1e-12")
    w6 = compare_leaves({k: v.grad for k, v in la.items() if v.requires_grad},
                        {k: v.grad for k, v in lb.items() if v.requires_grad},
                        1e-12, "PRNG contract gradients")
    log(f"phase 6 PRNG contract: loss rel err {e6:.2e}, worst gradient rel "
        f"err {w6:.2e} (tol 1e-12)")
    report["phases"]["prng_contract"] = {"loss": e6, "grad": w6}

    # ---- phase 7: the main path at full width ----
    config.set_precision("float32")
    lens = CookeTriplet()
    base = lens.system
    stack = base.stack
    r_inner = torch.nn.Parameter(stack.radius[1:-1].detach().clone())
    opt = torch.optim.Adam([r_inner], lr=1e-3)

    def system_of(radius_inner):
        leaves = dict(stack.leaves())
        leaves["radius"] = torch.cat([stack.radius[:1], radius_inner,
                                      stack.radius[-1:]])
        return base.replace(stack=stack.replace(**leaves)), leaves

    # The main path: every value+grad step below, and nothing else, runs
    # between resetting the launch counts and reading them.
    torch.cuda.synchronize()
    reset_counts()
    t7 = time.perf_counter()
    # value and gradient with respect to every stack leaf
    s7, lv7 = leaf_system(base)
    loss7 = ft.spot_rms_fast_field(s7, *H, WL, num_rays=Rf, seed=1)
    loss7.backward()
    grads7 = {k: v.grad for k, v in lv7.items() if v.grad is not None}
    nan_leaves = {k: int((~torch.isfinite(g)).sum()) for k, g in
                  grads7.items() if not bool(torch.isfinite(g).all())}
    check(bool(torch.isfinite(loss7)), "main path: merit is not finite")
    check(bool(torch.isfinite(grads7["radius"][1:-1]).all()),
          "main path: radius gradient not finite")
    log(f"phase 7 value+grad over {len(grads7)} stack leaves: merit "
        f"{float(loss7.detach()):.9e}; non-finite entries (reference behaviour, "
        f"object/image rows): {nan_leaves}")
    merits = []
    for step in range(5):
        opt.zero_grad()
        sysk, _ = system_of(r_inner)
        loss = ft.spot_rms_fast_field(sysk, *H, WL, num_rays=Rf,
                                      seed=100 + step)
        loss.backward()
        check(bool(torch.isfinite(loss)), f"step {step}: merit not finite")
        check(bool(torch.isfinite(r_inner.grad).all()),
              f"step {step}: gradient not finite")
        opt.step()
        merits.append(float(loss.detach()))
        log(f"  step {step}: merit {merits[-1]:.9e}")

    def vg_step(i):
        # value and gradient with respect to every stack leaf of the system
        # that Adam walked
        sysk, _ = leaf_system(system_of(r_inner)[0])
        loss = ft.spot_rms_fast_field(sysk, *H, WL, num_rays=Rf,
                                      seed=1000 + i)
        loss.backward()

    for i in range(3):  # warm-up
        vg_step(-1 - i)
    torch.cuda.synchronize()
    times = []
    for i in range(args.steps):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        vg_step(i)
        ev1.record()
        ev1.synchronize()
        times.append(ev0.elapsed_time(ev1))
    launches = counts()
    main_s = time.perf_counter() - t7
    steps_run = 1 + 5 + 3 + args.steps
    step_ms = float(np.median(times))
    n_surf = S - 1
    rs = Rf * n_surf / (step_ms * 1e-3)
    log(f"phase 7 main path: {steps_run} value+grad steps in {main_s:.1f} s; "
        f"median value+grad step {step_ms:.3f} ms over {args.steps} steps -> "
        f"{rs:.4e} ray-surf/s (2^{args.full_log2} x {n_surf} / t); launches "
        f"{launches}, per step "
        f"{ {k: v / steps_run for k, v in launches.items()} }")
    # the merit kernels draw their samples in-kernel: the step launches
    # merit_fwd and merit_bwd once each and prng_disk never
    check(launches == {**dict.fromkeys(counts(), 0), "merit_fwd": steps_run,
                       "merit_bwd": steps_run},
          f"main path launches {launches}, expected merit_fwd and merit_bwd "
          f"{steps_run} times each and prng_disk never")
    # full-width sample contract (outside the counted run): the in-kernel
    # draws are prng_disk's
    Pxf, Pyf = ft.prng_pupil_samples(5, Rf, dtype=torch.float32, device=dev)
    with torch.no_grad():
        l_prng = ft.spot_rms_fast_field(base, *H, WL, num_rays=Rf, seed=5)
        l_expl = ft.spot_rms_fast_field(base, *H, WL, Px=Pxf, Py=Pyf)
    check(rel(l_prng, l_expl) <= 1e-6,
          f"full-width PRNG contract: {float(l_prng)} != {float(l_expl)}")
    log(f"phase 7 full-width PRNG contract: loss rel err "
        f"{rel(l_prng, l_expl):.2e} (tol 1e-6)")
    del Pxf, Pyf
    report["phases"]["main"] = {"merits": merits, "step_ms": step_ms,
                                "step_ms_all": times, "ray_surf_per_s": rs,
                                "launches": launches, "steps": steps_run}

    path_launches = {"merit": launches}

    # ---- phase 8: per-kernel times, plain times and bounds at full width --
    p32, a32 = tables(base)
    with torch.no_grad():
        rows_f = ft.merit_fwd(p32, a32, spec, Rf, seed=9)
        lf, xbf, ybf = ft._chan_combine(rows_f, Rf)
    stats32 = torch.stack([xbf, ybf, torch.tensor(1.0 / Rf, device=dev),
                           torch.zeros((), device=dev)])
    # the trace kernels' full-width inputs: the generic path's launch bundle
    # and pupil samples, and random output cotangents of a mean's size (the
    # paths' losses are means over the rays), so that the summed gradients
    # and their max_abs_err are of the size the paths see
    spec32 = ftr.fast_spec(base)
    gen8 = torch.Generator(device=dev).manual_seed(8)
    Px8, Py8 = ft.prng_disk(8, Rf, 0, torch.float32, dev)
    with torch.no_grad():
        rays8 = raygen.generate_rays(base, *H, Px8, Py8, WL)
    ins8 = [getattr(rays8, k).contiguous() for k in ftr.RAY_FIELDS]
    cots8 = [torch.randn(Rf, generator=gen8, device=dev) / Rf
             for _ in range(8)]
    del rays8

    def time_ms(fn, reps, per_event=1, warm=False):
        """Median ms of ``fn`` over ``reps`` timed runs of ``per_event``
        calls each, after one warm-up call unless ``warm`` (the caller has
        just run it)."""
        if not warm:
            fn(0)
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ms = []
        for i in range(reps):
            ev0.record()
            for j in range(per_event):
                fn(1 + i * per_event + j)
            ev1.record()
            ev1.synchronize()
            ms.append(ev0.elapsed_time(ev1) / per_event)
        return float(np.median(ms))

    def max_abs(a, b):
        return max(float((u - v).abs().max()) for u, v in zip(a, b))

    def near32(a, b, what, flips=0, metre=False):
        """f32 ``a`` against ``b`` (f32 or f64), each array on its own:
        2e-4 x max(1, max|b|), and finite where ``b`` is; ``flips`` rays
        may differ in intensity (array 6), a ray whose radius falls within
        rounding of a clip edge being clipped in one only. At the metre
        scale (``metre``) the positions (arrays 0-2) share the scale of the
        largest of them: the rounding of the metre-long coordinates they
        pass through."""
        pos = max(float(b[j].abs().max()) for j in range(3))
        for j, (u, v) in enumerate(zip(a, b)):
            u, v = u.double(), v.double()
            check(torch.equal(torch.isfinite(u), torch.isfinite(v)),
                  f"{what}: array {j}: finite in one and not the other")
            top = max(1.0, float(v.abs().max()),
                      pos if metre and j < 3 else 0.0)
            bad = (u - v).abs() > 2e-4 * top
            n = int(bad.sum())
            check(n <= (flips if j == 6 else 0),
                  f"{what}: array {j}: {n} rays off by more than 2e-4")

    def arr_err(a, b, floor=0.0):
        """Largest |a - b| of each array over that array's largest |b|, or
        over ``floor`` x the largest |b| of all arrays where that is more
        (an array that vanishes but for rounding has no scale of its
        own)."""
        top = floor * max(float(v.abs().max()) for v in b)
        return max(float((u.double() - v.double()).abs().max())
                   / max(float(v.abs().max()), top, 1e-300)
                   for u, v in zip(a, b))

    def chunk_spans(chunk):
        """The full width's spans of ``chunk`` rays (None: one span)."""
        Rk = chunk or Rf
        return [(k * Rk, (k + 1) * Rk) for k in range(Rf // Rk)]

    def chunked_fwd(out_k, outs, spans, what, flip_rate=1e-4):
        """A full-width forward's arrays ``out_k`` against the plain
        version's ``outs`` over ``spans``, chunk by chunk (near32, up to
        ``flip_rate`` of each chunk's rays flipping in intensity); returns
        max |kernel - plain|."""
        e = 0.0
        for k, ((a, b), o) in enumerate(zip(spans, outs)):
            got = [t[a:b] for t in out_k]
            near32(got, o, f"{what}, chunk {k}", int((b - a) * flip_rate))
            e = max(e, max_abs(got, o))
        return e

    def chunked_bwd(din_k, outs, spans, floor=1e-6):
        """A full-width adjoint's input cotangents ``din_k`` against the
        plain version's (din, flat) ``outs`` over ``spans``, chunk by
        chunk: (arr_err of the whole arrays with ``floor``, max |kernel -
        plain|, the plain version's flat gradient summed over the
        chunks)."""
        d_max, r_max = [0.0] * len(din_k), [0.0] * len(din_k)
        flat = None
        for (a, b), (din_c, fl_c) in zip(spans, outs):
            for j, (u, v) in enumerate(zip(din_k, din_c)):
                d_max[j] = max(d_max[j], float(
                    (u[a:b].double() - v.double()).abs().max()))
                r_max[j] = max(r_max[j], float(v.abs().max()))
            flat = fl_c if flat is None else flat + fl_c
        top = floor * max(r_max)
        return (max(d / max(r, top, 1e-300) for d, r in zip(d_max, r_max)),
                max(d_max), flat)

    with torch.no_grad():
        # kernel vs plain at the paths' shapes (f32, 2^24 rays)
        k = ft.prng_disk(9, Rf, 0, torch.float32, dev, with_u=True)
        p = ft.prng_disk_plain(9, Rf, 0, torch.float32, dev, with_u=True)
        check(torch.equal(k[2], p[2]) and torch.equal(k[3], p[3]),
              "prng_disk full width: u differs")
        kerr["prng_disk"] = max(float((k[0] - p[0]).abs().max()),
                                float((k[1] - p[1]).abs().max()))
        check(kerr["prng_disk"] <= 1e-6, "prng_disk full width: |dP| > 1e-6")
        del k, p
        rows_p = ft.merit_fwd_plain(p32, a32, spec, Rf, seed=9)
        kerr["merit_fwd"] = float((rows_f - rows_p).abs().max())
        lp = ft._chan_combine(rows_p, Rf)[0]
        check(rel(lf, lp) <= 1e-4, f"merit_fwd full width: loss rel err "
              f"{rel(lf, lp)} > 1e-4")
        del rows_p
        fk = ft.merit_bwd(p32, a32, stats32, spec, nc, Rf, seed=9)
        fp = ft.merit_bwd_plain(p32, a32, stats32, spec, nc, Rf, seed=9)
        kerr["merit_bwd"] = float((fk - fp).abs().max())

        def l2(a, b):
            # against an all-zero reference: the absolute norm
            nb = float(torch.linalg.vector_norm(b.double()))
            return float(torch.linalg.vector_norm(a.double() - b.double())
                         / (nb if nb > 0 else 1.0))

        l2f = l2(fk, fp)
        check(l2f <= 1e-3, f"merit_bwd full width: L2 rel err {l2f} > 1e-3")
        del fp
        # the trace kernels: each of the 8 per-ray arrays on its own (the
        # stock Cooke triplet clips no ray, so no intensity may flip), the
        # per-ray input cotangents relative to each array's largest value,
        # the summed gradients in L2
        k5a = ftr.trace_fwd(p32, spec32, ins8)
        ref = ftr.trace_fast_plain(p32, spec32, ins8)
        kerr["trace_fwd"] = max_abs(k5a, ref)
        near32(k5a, ref, "trace_fwd full width")
        k1 = ftr.trace_field_fwd(p32, a32, spec32, Px8, Py8)
        ref = ftr.trace_fast_field_plain(p32, a32, spec32, Px8, Py8)
        kerr["trace_field_fwd"] = max_abs(k1, ref)
        near32(k1, ref, "trace_field_fwd full width")
        del k5a, k1, ref
        din_k, flat_k = ftr.trace_bwd(p32, spec32, nc, ins8, cots8)
        din_p, flat_p = ftr.trace_fast_bwd_plain(p32, spec32, nc, ins8, cots8)
        kerr["trace_bwd"] = max(float((flat_k - flat_p).abs().max()),
                                max_abs(din_k, din_p))
        din_err = arr_err(din_k, din_p)
        check(din_err <= 1e-3, f"trace_bwd full width: input cotangents, "
              f"max |d| / max |ref| {din_err} > 1e-3")
        l2_5b = l2(flat_k, flat_p)
        del din_k, din_p
        flat_k = ftr.trace_field_bwd(p32, a32, spec32, nc, Px8, Py8, cots8)
        flat_p = ftr.trace_fast_field_bwd_plain(p32, a32, spec32, nc, Px8,
                                                Py8, cots8)
        kerr["trace_field_bwd"] = float((flat_k - flat_p).abs().max())
        l2_4 = l2(flat_k, flat_p)
        check(max(l2_5b, l2_4) <= 1e-3, f"trace_bwd/trace_field_bwd full "
              f"width: L2 rel err {l2_5b}, {l2_4} > 1e-3")
        del flat_k, flat_p
        torch.cuda.synchronize()
        log(f"phase 8 full-width kernel vs plain (f32): prng_disk max |dP| "
            f"{kerr['prng_disk']:.2e}, merit_fwd loss rel err "
            f"{rel(lf, lp):.2e}, merit_bwd L2 rel err {l2f:.2e}; trace_fwd "
            f"max |d| {kerr['trace_fwd']:.2e}, trace_field_fwd "
            f"{kerr['trace_field_fwd']:.2e} (each array within 2e-4 x "
            f"max(1, max |ref|)), trace_bwd input cotangents {din_err:.2e} "
            f"of each array's largest (tol 1e-3), trace_bwd L2 rel err "
            f"{l2_5b:.2e}, trace_field_bwd {l2_4:.2e}")

        ms = {
            "prng_disk": time_ms(
                lambda i: ft.prng_disk(i, Rf, 0, torch.float32, dev), 10, 5),
            "merit_fwd": time_ms(
                lambda i: ft.merit_fwd(p32, a32, spec, Rf, seed=i), 10, 3),
            "merit_bwd": time_ms(
                lambda i: ft.merit_bwd(p32, a32, stats32, spec, nc, Rf,
                                       seed=i), 10, 3),
            "trace_fwd": time_ms(
                lambda i: ftr.trace_fwd(p32, spec32, ins8), 10, 3),
            "trace_bwd": time_ms(
                lambda i: ftr.trace_bwd(p32, spec32, nc, ins8, cots8), 10, 3),
            "trace_field_fwd": time_ms(
                lambda i: ftr.trace_field_fwd(p32, a32, spec32, Px8, Py8),
                10, 3),
            "trace_field_bwd": time_ms(
                lambda i: ftr.trace_field_bwd(p32, a32, spec32, nc, Px8, Py8,
                                              cots8), 10, 3),
        }
        plain_ms = {
            "prng_disk": time_ms(
                lambda i: ft.prng_disk_plain(i, Rf, 0, torch.float32, dev),
                3),
            "merit_fwd": time_ms(
                lambda i: ft.merit_fwd_plain(p32, a32, spec, Rf, seed=i), 3),
            "merit_bwd": time_ms(
                lambda i: ft.merit_bwd_plain(p32, a32, stats32, spec, nc, Rf,
                                             seed=i), 3),
            "trace_fwd": time_ms(
                lambda i: ftr.trace_fast_plain(p32, spec32, ins8), 3),
            "trace_bwd": time_ms(
                lambda i: ftr.trace_fast_bwd_plain(p32, spec32, nc, ins8,
                                                   cots8), 3),
            "trace_field_fwd": time_ms(
                lambda i: ftr.trace_fast_field_plain(p32, a32, spec32, Px8,
                                                     Py8), 3),
            "trace_field_bwd": time_ms(
                lambda i: ftr.trace_fast_field_bwd_plain(p32, a32, spec32, nc,
                                                         Px8, Py8, cots8), 3),
        }
    del ins8, cots8, Px8, Py8
    log("phase 8 kernel ms at 2^%d rays (f32): %s; plain ms: %s" % (
        args.full_log2, {k: round(v, 4) for k, v in ms.items()},
        {k: round(v, 2) for k, v in plain_ms.items()}))

    codes = spec[0][1:]
    n_std = sum(c == 1 for c in codes)
    n_pl = len(codes) - n_std
    n_abs = sum(spec32[2][1:])
    nb_f = -(-Rf // ft.FWD_BLOCK)
    nb_b = min(-(-Rf // ft.BWD_BLOCK), ft.BWD_MAX_BLOCKS)
    ncomp = S * len(ft.GRAD_COLS) + ft.N_AIM
    ncomp_full = S * len(ftr.FULL_GRAD_COLS)
    table_bytes = (S * ft.NUM_P + ft.N_AIM + 2 * S) * 4
    out_bytes = (S * (ft.NUM_P + nc) + ft.N_AIM) * 4
    fwd_full = (n_std * OPS_FWD_STANDARD + n_pl * OPS_FWD_PLANE
                + len(codes) * OPS_FULL_FWD + n_abs * OPS_ABS_FWD)
    bwd_full = (n_std * OPS_BWD_STANDARD + n_pl * OPS_BWD_PLANE
                + len(codes) * OPS_FULL_BWD + n_abs * OPS_ABS_BWD)
    work = {
        "prng_disk": (Rf * OPS_PRNG, Rf * 2 * 4),
        "merit_fwd": (Rf * (OPS_PRNG + OPS_LAUNCH + n_std * OPS_FWD_STANDARD
                            + n_pl * OPS_FWD_PLANE + OPS_STATS),
                      table_bytes + nb_f * 5 * 4),
        "merit_bwd": (Rf * (OPS_PRNG + OPS_LAUNCH + OPS_SEED + OPS_AIM_BWD
                            + n_std * OPS_BWD_STANDARD + n_pl * OPS_BWD_PLANE),
                      table_bytes + 16 + 2 * nb_b * ncomp * 4 + out_bytes),
        # 8 arrays in, 8 out
        "trace_fwd": (Rf * fwd_full, table_bytes + Rf * 16 * 4),
        # 8 arrays and 8 cotangents in, 8 input cotangents out
        "trace_bwd": (Rf * bwd_full, table_bytes + Rf * 24 * 4
                      + 2 * nb_b * ncomp_full * 4 + out_bytes),
        # Px, Py in, 8 arrays out
        "trace_field_fwd": (Rf * (OPS_LAUNCH + fwd_full),
                            table_bytes + Rf * 10 * 4),
        # Px, Py and 8 cotangents in
        "trace_field_bwd": (Rf * (OPS_LAUNCH + OPS_AIM_BWD + bwd_full),
                            table_bytes + Rf * 10 * 4
                            + 2 * nb_b * (ncomp_full + ft.N_AIM) * 4
                            + out_bytes),
    }
    for name, (ops, nbytes) in work.items():
        b64 = max(ops / PEAK_F64_OPS, 2 * nbytes / PEAK_BYTES) * 1e3
        log(f"bound {name}: {ops / 1e9:.2f} Gop, {nbytes / 1e6:.1f} MB -> "
            f"f32 {max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES) * 1e3:.4f} ms,"
            f" f64 {b64:.4f} ms ("
            f"{'operations' if ops / PEAK_F64_OPS >= 2 * nbytes / PEAK_BYTES else 'bytes'})")

    # ---- phase 9: the trace kernels against their plain versions ----
    config.set_precision("float64")

    def mirror_system():
        """A concave conic mirror (the reflect branch)."""
        lens = Optic()
        lens.surfaces.add(index=0, radius=float("inf"), thickness=float("inf"))
        lens.surfaces.add(index=1, radius=-200.0, thickness=-100.0,
                          material="mirror", is_stop=True, conic=-0.5)
        lens.surfaces.add(index=2)
        lens.set_aperture(aperture_type="EPD", value=20)
        lens.fields.set_type(field_type="angle")
        lens.fields.add(y=0)
        lens.fields.add(y=1)
        lens.wavelengths.add(value=0.55, is_primary=True)
        return lens.system

    def vignetted_system():
        """The Cooke triplet with a 2 mm semi-aperture at the stop."""
        lens = CookeTriplet()
        lens.surfaces.surfaces[4].aperture = 4.0
        lens._invalidate()
        return lens.system

    def flat_err(a, b, rtol, what, floor=1e-12):
        """|a - b| <= rtol |b| + floor max|b| wherever b is finite; returns
        the worst relative error over the entries above 1e-6 max|b|."""
        fin = torch.isfinite(b)
        a, b = a[fin].double(), b[fin].double()
        scale = float(b.abs().max())
        d = (a - b).abs()
        check(bool((d <= rtol * b.abs() + floor * scale).all()),
              f"{what}: max |d| {float(d.max()):.3e} (largest |ref| "
              f"{scale:.3e})")
        big = b.abs() > 1e-6 * scale
        # an all-zero reference (a trace whose outputs reach no loss) is
        # matched exactly by the check above
        return float((d[big] / b[big].abs()).max()) if bool(big.any()) else 0.0

    g9 = torch.Generator(device=dev).manual_seed(9)
    res9 = {}
    for kind, sysk in (("cooke", systems["f64"]), ("mirror", mirror_system()),
                       ("vignetted", vignetted_system())):
        spec_k = ftr.fast_spec(sysk)
        pk, ak = tables(sysk)
        nc_k, S_k = sysk.stack.coeffs.shape[1], len(spec_k[0])
        with torch.no_grad():
            rays = raygen.generate_rays(sysk, *H, Px64, Py64, WL)
        ins = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
        ins[6] = 0.5 + 0.5 * torch.rand(Rc, generator=g9, device=dev,
                                        dtype=torch.float64)
        ins[7] = torch.rand(Rc, generator=g9, device=dev, dtype=torch.float64)
        cots = [torch.randn(Rc, generator=g9, device=dev, dtype=torch.float64)
                for _ in range(8)]
        r = {}
        # K5a, K5b against the plain versions and autograd of the plain trace
        out_k = ftr.trace_fwd(pk, spec_k, ins)
        r["trace_fwd"] = arr_err(out_k, ftr.trace_fast_plain(pk, spec_k, ins))
        din_k, fl_k = ftr.trace_bwd(pk, spec_k, nc_k, ins, cots)
        din_p, fl5_p = ftr.trace_fast_bwd_plain(pk, spec_k, nc_k, ins, cots)
        pg = pk.clone().requires_grad_()
        insg = [t.clone().requires_grad_() for t in ins]
        out_a = ftr.trace_fast_plain(pg, spec_k, insg)
        auto = torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(out_a, cots)), [pg] + insg)
        fl_a = torch.cat([auto[0].reshape(-1), pk.new_zeros(S_k * nc_k)])
        r["trace_bwd"] = flat_err(fl_k, fl5_p, 1e-9, f"trace_bwd {kind}")
        r["trace_bwd_autograd"] = flat_err(fl_k, fl_a, 1e-9,
                                           f"trace_bwd {kind} vs autograd")
        r["trace_bwd_din"] = arr_err(din_k, din_p)
        r["trace_bwd_din_autograd"] = arr_err(din_k, auto[1:])
        del out_a, auto, insg
        # K1, K4
        out_f = ftr.trace_field_fwd(pk, ak, spec_k, Px64, Py64)
        r["trace_field_fwd"] = arr_err(
            out_f, ftr.trace_fast_field_plain(pk, ak, spec_k, Px64, Py64))
        fl_k = ftr.trace_field_bwd(pk, ak, spec_k, nc_k, Px64, Py64, cots)
        fl4_p = ftr.trace_fast_field_bwd_plain(pk, ak, spec_k, nc_k, Px64,
                                               Py64, cots)
        pg, ag = pk.clone().requires_grad_(), ak.clone().requires_grad_()
        out_a = ftr.trace_fast_field_plain(pg, ag, spec_k, Px64, Py64)
        gp, ga = torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(out_a, cots)), [pg, ag])
        fl_a = torch.cat([gp.reshape(-1), pk.new_zeros(S_k * nc_k), ga])
        r["trace_field_bwd"] = flat_err(fl_k, fl4_p, 1e-9,
                                        f"trace_field_bwd {kind}")
        r["trace_field_bwd_autograd"] = flat_err(
            fl_k, fl_a, 1e-9, f"trace_field_bwd {kind} vs autograd")
        del out_a
        for key in ("trace_fwd", "trace_field_fwd", "trace_bwd_din",
                    "trace_bwd_din_autograd"):
            check(r[key] <= 1e-10, f"{key} {kind} f64: rel err {r[key]} > "
                  f"1e-10")
        if kind == "vignetted":
            n_clip = int((out_f[6] == 0).sum())
            check(0 < n_clip < Rc, f"vignetted: {n_clip} of {Rc} rays "
                  "clipped; the clip did not run")
            r["clipped"] = n_clip
        # f32 against the f64 plain versions
        if kind != "mirror":
            p32k, a32k = pk.float(), ak.float()
            ins32 = [t.float() for t in ins]
            cots32 = [t.float() for t in cots]
            flips = Rc // 10_000
            near32(ftr.trace_fwd(p32k, spec_k, ins32),
                   ftr.trace_fast_plain(pk, spec_k, ins), f"trace_fwd f32 "
                   f"{kind}", flips)
            near32(ftr.trace_field_fwd(p32k, a32k, spec_k, Px64.float(),
                                       Py64.float()),
                   out_f, f"trace_field_fwd f32 {kind}", flips)
            din32, fl32 = ftr.trace_bwd(p32k, spec_k, nc_k, ins32, cots32)
            near32(din32[:6], din_p[:6], f"trace_bwd f32 {kind}")
            r["trace_bwd_f32_l2"] = l2(fl32, fl5_p)
            fl32 = ftr.trace_field_bwd(p32k, a32k, spec_k, nc_k,
                                       Px64.float(), Py64.float(), cots32)
            r["trace_field_bwd_f32_l2"] = l2(fl32, fl4_p)
            check(max(r["trace_bwd_f32_l2"], r["trace_field_bwd_f32_l2"])
                  <= 1e-3, f"{kind} f32 gradients: L2 rel err "
                  f"{r['trace_bwd_f32_l2']}, {r['trace_field_bwd_f32_l2']}"
                  " > 1e-3")
        torch.cuda.synchronize()
        res9[kind] = r
        log(f"phase 9 trace kernels {kind} (2^{args.check_log2} rays, f64 "
            f"vs plain; per-ray arrays: max |d| / max |ref|, tol 1e-10; "
            f"gradients: worst rel err over entries above 1e-6 x the "
            f"largest, tol 1e-9): " + ", ".join(
                f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}"
                for k, v in r.items()))
    report["phases"]["trace_kernels"] = res9
    del ins, cots, din_k, din_p

    # ---- phase 10: the generic path at full width ----
    config.set_precision("float32")

    def timed(step_fn, seed0):
        for i in range(3):  # warm-up
            step_fn(seed0 - 1 - i)
        torch.cuda.synchronize()
        times = []
        for i in range(args.steps):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            step_fn(seed0 + i)
            ev1.record()
            ev1.synchronize()
            times.append(ev0.elapsed_time(ev1))
        return times

    def generic_loss(system, seed):
        Px, Py = ft.prng_disk(seed, Rf, 0, torch.float32, dev)
        return rms_spot_size(system, *H, Px, Py, WL)

    def field_loss(system, seed):
        Px, Py = ft.prng_disk(seed, Rf, 0, torch.float32, dev)
        f = ftr.trace_fast_field(system, *H, Px, Py, WL)
        return ((f.x - f.x.mean()) ** 2 + (f.y - f.y.mean()) ** 2).mean()

    paths = {}
    for name, loss_fn, seed0 in (("generic", generic_loss, 2000),
                                 ("field", field_loss, 3000)):
        phase = 10 if name == "generic" else 11
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        # value and gradient with respect to every stack leaf
        sl, lv = leaf_system(base)
        first = loss_fn(sl, seed0 - 100)
        first.backward()
        check(bool(torch.isfinite(first)), f"{name} path: value not finite")
        check(bool(torch.isfinite(lv["radius"].grad[1:-1]).all()),
              f"{name} path: radius gradient not finite")

        def vg_path(i, loss_fn=loss_fn):
            # every stack leaf, as phase 7's timed steps
            sysk, _ = leaf_system(system_of(r_inner)[0])
            loss = loss_fn(sysk, i)
            loss.backward()

        times_p = timed(vg_path, seed0)
        got = counts()
        wall = time.perf_counter() - t0
        n_steps = 1 + 3 + args.steps
        fwd, bwd = (("trace_fwd", "trace_bwd") if name == "generic"
                    else ("trace_field_fwd", "trace_field_bwd"))
        expect = {**dict.fromkeys(got, 0), fwd: n_steps, bwd: n_steps,
                  "prng_disk": n_steps}
        check(got == expect, f"{name} path launches {got}, expected {expect}")
        path_launches[name] = got
        step_p = float(np.median(times_p))
        rs_p = Rf * n_surf / (step_p * 1e-3)
        paths[name] = {"value": float(first.detach()), "step_ms": step_p,
                       "step_ms_all": times_p, "ray_surf_per_s": rs_p,
                       "launches": got, "steps": n_steps}
        log(f"phase {phase} {name} path: {n_steps} value+grad steps in "
            f"{wall:.1f} s; value over every stack leaf "
            f"{float(first.detach()):.9e}; median value+grad step "
            f"{step_p:.3f} ms over {args.steps} steps -> {rs_p:.4e} "
            f"ray-surf/s; launches {got}, per step 1 {fwd}, 1 {bwd}, 1 "
            f"prng_disk")
        if name == "generic":
            # Optic.trace of ~2^24 hexapolar rays, forward, no history
            rings = int(round((np.sqrt(12 * Rf - 3) - 3) / 6))
            lens32 = CookeTriplet()
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            res = lens32.trace(Hy=0.7, num_rays=rings, record=False)
            torch.cuda.synchronize()
            t_ot = time.perf_counter() - t0
            got = counts()
            n_rays = 1 + 3 * rings * (rings + 1)
            check(got == {**dict.fromkeys(got, 0), "trace_fwd": 1},
                  f"Optic.trace launches {got}, expected trace_fwd once")
            check(res.x.shape == (n_rays,) and res.history is None,
                  f"Optic.trace: shape {tuple(res.x.shape)}")
            check(bool(torch.isfinite(res.x).all() and torch.isfinite(res.y)
                       .all() and ((res.i >= 0) & (res.i <= 1)).all()),
                  "Optic.trace: non-finite rays or intensity outside [0, 1]")
            path_launches["optic_trace"] = got
            paths["optic_trace"] = {"rays": n_rays, "rings": rings,
                                    "host_s": t_ot, "launches": got}
            log(f"phase 10 Optic.trace(Hy=0.7, num_rays={rings}, "
                f"record=False): {n_rays} hexapolar rays in {t_ot:.2f} s "
                f"host wall (rings, transfer, launch side, trace_fwd); "
                f"launches {got}")
            del res

    # The three paths compute one function: the mean squared spot radius
    # of the same pupil samples (outside the counted runs).
    with torch.no_grad():
        Pxc, Pyc = ft.prng_disk(77, Rf, 0, torch.float32, dev)
        v_gen = rms_spot_size(base, *H, Pxc, Pyc, WL) ** 2
        f = ftr.trace_fast_field(base, *H, Pxc, Pyc, WL)
        v_field = ((f.x - f.x.mean()) ** 2 + (f.y - f.y.mean()) ** 2).mean()
        v_merit = ft.spot_rms_fast_field(base, *H, WL, Px=Pxc, Py=Pyc)
        del f, Pxc, Pyc
    e_paths = max(rel(v_gen, v_merit), rel(v_field, v_merit))
    check(e_paths <= 1e-4, f"the paths disagree on the mean squared spot "
          f"radius: generic {float(v_gen)}, field {float(v_field)}, merit "
          f"{float(v_merit)}")
    log(f"phase 11 cross-check: the three paths agree on the mean squared spot radius of "
        f"the same 2^{args.full_log2} samples: merit {float(v_merit):.9e}, "
        f"rel err generic {rel(v_gen, v_merit):.2e}, field "
        f"{rel(v_field, v_merit):.2e} (tol 1e-4, f32)")
    report["phases"]["paths"] = paths

    # ---- phase 12: the Huygens kernels against their plain versions ----
    npix, c13 = 128, 64  # huygens_psf's default image_size; centre pixel
    n_pup = int(pupil_grid_coords(128)[2].sum())  # the default num_rays

    def huygens_case(P, Q, seed):
        """Image points near the focus of a 52.45 mm reference sphere (the
        Cooke triplet's at field (0, 0.7)), pupil points on it with normals
        towards the image, random amplitudes, OPD and field cotangents: the
        phase k R ~ 6e5 rad of the PSF path. Float64 arrays that hold
        float32 values, so that the f32 kernels see the same inputs."""
        g = torch.Generator(device=dev).manual_seed(seed)

        def u(n, lo, hi):
            return lo + (hi - lo) * torch.rand(n, generator=g, device=dev,
                                               dtype=torch.float64)

        Rp, k = 52.45, 2 * np.pi / (WL * 1e-3)
        img = [u(P, -0.02, 0.02), u(P, -0.02, 0.02), u(P, -1e-3, 1e-3)]
        r, th = 5.0 * u(Q, 0, 1).sqrt(), u(Q, 0, 2 * np.pi)
        px, py = r * th.cos(), r * th.sin()
        pz = -(Rp**2 - px**2 - py**2).sqrt()
        pup = hu.pupil_arrays(px, py, pz, u(Q, 0.5, 1.0),
                              1e-4 * torch.randn(Q, generator=g, device=dev,
                                                 dtype=torch.float64), k, -Rp)
        cots = [torch.randn(P, generator=g, device=dev, dtype=torch.float64)
                for _ in range(2)]
        return ([[t.float().double().contiguous() for t in grp]
                 for grp in (img, pup, cots)] + [k])

    def huygens_all(img, pup, cots, k, plain=False):
        """(re, im), the 3 image and the 8 pupil gradients."""
        if plain:
            return (hu.huygens_fwd_plain(img, pup, k)
                    + hu.huygens_bwd_img_plain(img, pup, *cots, k)
                    + hu.huygens_bwd_pup_plain(img, pup, *cots, k))
        return (hu.huygens_fwd(img, pup, k) + hu.huygens_bwd_img(img, pup,
                                                                 *cots, k)
                + hu.huygens_bwd_pup(img, pup, *cots, k))

    def autograd_adjoints(img, pup, cots, k):
        """The 11 input cotangents by autograd of the plain forward, over
        chunks of image points (each chunk's graph freed before the next)."""
        rows = max(1, hu.PLAIN_PAIRS // pup[0].shape[0])
        pg = [t.clone().requires_grad_() for t in pup]
        d_img, d_pup = [[] for _ in range(3)], [torch.zeros_like(t)
                                                for t in pup]
        for a in range(0, img[0].shape[0], rows):
            ig = [t[a:a + rows].clone().requires_grad_() for t in img]
            re_a, im_a = hu.huygens_fwd_plain(ig, pg, k)
            g = torch.autograd.grad((re_a * cots[0][a:a + rows]).sum()
                                    + (im_a * cots[1][a:a + rows]).sum(),
                                    ig + pg)
            for o, v in zip(d_img, g[:3]):
                o.append(v)
            for o, v in zip(d_pup, g[3:]):
                o += v
        return tuple(torch.cat(o) for o in d_img) + tuple(d_pup)

    # the f64 kernels against the plain version and autograd, and the f32
    # kernels on the same values against the f64 plain version, at odd
    # sizes and at the PSF path's two shapes: the field sum (P = 16,384
    # image points) and the normalization (P = 1), Q = 12,644
    names13 = (("huygens_fwd", slice(0, 2)), ("huygens_bwd_img", slice(2, 5)),
               ("huygens_bwd_pup", slice(5, 13)))
    res12 = {}
    for P12, Q12 in ((4099, 8191), (1, 8191), (npix * npix, n_pup),
                     (1, n_pup)):
        img, pup, cots, k = huygens_case(P12, Q12, 12)
        out = huygens_all(img, pup, cots, k)
        ref = huygens_all(img, pup, cots, k, plain=True)
        scale = float(torch.hypot(ref[0], ref[1]).max())
        e_f = max_abs(out[:2], ref[:2]) / scale
        check(e_f <= 1e-9, f"huygens_fwd {P12}x{Q12} f64: |d| / max |field| "
              f"{e_f} > 1e-9")
        auto = autograd_adjoints(img, pup, cots, k)
        e_hand, e_auto = arr_err(out[2:], ref[2:]), arr_err(out[2:], auto)
        check(max(e_hand, e_auto) <= 1e-8, f"huygens adjoints {P12}x{Q12} "
              f"f64: rel err vs plain {e_hand}, vs autograd {e_auto} > 1e-8")
        del out, auto
        lo = [[t.float() for t in grp] for grp in (img, pup, cots)]
        out32 = huygens_all(*lo, k)
        b32, kr = hu.f32_bound(img, pup, k)
        r_worst, r_rms = hu.error_ratios(out32, ref,
                                         *hu.term_sums(img, pup, *cots, k),
                                         b32, kr)
        check(max(r_worst, r_rms) <= 1.0, f"huygens kernels f32 {P12}x{Q12}"
              f": error {r_worst} x the per-entry bound, RMS error {r_rms} "
              f"x the RMS bound")
        res = {"fwd": e_f, "bwd_vs_plain": e_hand, "bwd_vs_autograd": e_auto,
               "f32_bound": b32, "f32_worst_ratio": r_worst,
               "f32_rms_ratio": r_rms}
        if P12 == npix * npix:
            # the kernels line's max_abs_err: f32 kernel against the f32
            # plain version at the PSF field sum's shape
            with torch.no_grad():
                plain32 = huygens_all(*lo, k, plain=True)
            for name, sl in names13:
                kerr[name] = max_abs(out32[sl], plain32[sl])
            res["f32_max_abs_vs_plain32"] = {n: kerr[n] for n, _ in names13}
            res["max_abs_ref"] = {n: max(float(v.abs().max()) for v in ref[sl])
                                  for n, sl in names13}
            del plain32
        torch.cuda.synchronize()
        res12[f"{P12}x{Q12}"] = res
        log(f"phase 12 huygens kernels P={P12} Q={Q12}: f64 field |d| / max "
            f"|field| {e_f:.2e} (tol 1e-9); f64 adjoints, per array |d| / "
            f"max |ref|: vs plain {e_hand:.2e}, vs autograd of the plain "
            f"forward {e_auto:.2e} (tol 1e-8); f32 vs f64 plain: worst "
            f"entry {r_worst:.3e} x b sum |term|, RMS {r_rms:.3e} x (b RMS "
            f"sqrt(sum |term|^2) + k R_max 2^-24 RMS |ref|), b = (6 k R_max "
            f"+ 16) 2^-24 = {b32:.3e} (tol 1 each)")
        del img, pup, cots, lo, ref, out32
    report["phases"]["huygens_kernels"] = res12
    log(f"phase 12 max |f32 kernel - f32 plain| at P={npix * npix}, "
        f"Q={n_pup}: { {n: float(f'{kerr[n]:.4g}') for n, _ in names13} }, "
        f"largest |f64 plain| "
        f"{res12[f'{npix * npix}x{n_pup}']['max_abs_ref']}")

    # ---- phase 13: the Huygens PSF path at full width ----
    config.set_precision("float32")
    psf_base = CookeTriplet().system

    def psf_vg(_=None):
        """Value and gradient of the centre pixel (Strehl x 100) with
        respect to every stack leaf, at the entry point's defaults."""
        sl, lv = leaf_system(psf_base)
        psf, _, _ = huygens_psf(sl, *H, WL)
        strehl = psf[c13, c13] / 100
        strehl.backward()
        return psf.detach(), strehl.detach(), lv

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    psf13, strehl13, lv13 = psf_vg()
    check(tuple(psf13.shape) == (npix, npix)
          and bool(torch.isfinite(psf13).all()), "PSF: not finite")
    check(0.0 < float(strehl13) <= 1.2, f"PSF: Strehl {float(strehl13)}")
    grads13 = {k: v.grad for k, v in lv13.items() if v.grad is not None}
    check(bool(torch.isfinite(grads13["radius"][1:-1]).all()),
          "PSF path: radius gradient not finite")
    nan13 = {k: int((~torch.isfinite(g)).sum()) for k, g in grads13.items()
             if not bool(torch.isfinite(g).all())}
    times13 = timed(psf_vg, 0)
    got13 = counts()
    wall13 = time.perf_counter() - t0
    n13 = 1 + 3 + args.steps
    # per step: the field sum and the normalization's one-point sum, each
    # with both adjoints (the image grid and the image plane's z depend on
    # the lens); 6 traces forward and backward: chief ray, pupil, image
    # grid and working F-number at (0, 0.7), chief ray and pupil on axis
    expect13 = {**dict.fromkeys(got13, 0),
                "huygens_fwd": 2 * n13, "huygens_bwd_img": 2 * n13,
                "huygens_bwd_pup": 2 * n13, "trace_fwd": 6 * n13,
                "trace_bwd": 6 * n13}
    check(got13 == expect13, f"PSF path launches {got13}, expected "
          f"{expect13}")
    path_launches["huygens"] = got13
    step13 = float(np.median(times13))
    pairs13 = npix * npix * n_pup
    log(f"phase 13 PSF path: {n13} value+grad steps in {wall13:.1f} s; "
        f"Strehl {float(strehl13):.9e} ({npix}x{npix} image points, "
        f"{n_pup} pupil points, {pairs13:.4e} pairs per field sum); median "
        f"value+grad step {step13:.3f} ms over {args.steps} steps; "
        f"non-finite gradient entries (reference behaviour): {nan13}; "
        f"launches {got13}")
    # one f64 call of the same PSF (outside the counted run). In f32 one
    # rounding unit of a ~75 mm optical path, 7.6e-6 mm, is 0.014 waves of
    # OPD (0.087 rad), and the wavefront gathers several per pupil point,
    # partly common to neighbouring points (the chief ray and the reference
    # sphere are shared), so the f32 PSF is not held to the sum's phase
    # bound of phase 12: the check allows 3e-2 of the peak at every pixel
    config.set_precision("float64")
    with torch.no_grad():
        psf64, _, _ = huygens_psf(CookeTriplet().system, *H, WL)
    s64 = float(psf64[c13, c13]) / 100
    peak = float(psf64.abs().max())
    e_s = abs(float(strehl13) - s64) * 100 / peak
    e_psf = float((psf13.double() - psf64).abs().max()) / peak
    check(max(e_s, e_psf) <= 3e-2, f"PSF f32 vs f64: Strehl |d| {e_s}, "
          f"max |d| {e_psf} of the peak > 3e-2")
    log(f"phase 13 PSF f32 vs f64: Strehl {float(strehl13):.9e} vs "
        f"{s64:.9e} (rel err {abs(float(strehl13) - s64) / s64:.2e}); "
        f"|d| / peak: Strehl pixel {e_s:.2e}, worst pixel {e_psf:.2e} (tol "
        f"3e-2)")
    report["phases"]["huygens_psf"] = {
        "strehl": float(strehl13), "strehl_f64": s64, "strehl_rel": e_s,
        "psf_rel": e_psf, "step_ms": step13, "step_ms_all": times13,
        "launches": got13, "steps": n13, "pupil_points": n_pup,
        "pairs": pairs13, "nan_entries": nan13}
    del psf13, psf64, lv13, grads13

    # the Huygens kernels at bench.py's shape (P = 16,384, Q = 65,536, f32)
    config.set_precision("float32")
    Pb, Qb = 16384, 65536
    *groups, k = huygens_case(Pb, Qb, 13)
    img, pup, cots = ([t.float() for t in grp] for grp in groups)
    del groups
    with torch.no_grad():
        got = huygens_all(img, pup, cots, k)
        ref = huygens_all(img, pup, cots, k, plain=True)
        # kernel and plain version, each within the bound of the exact sum
        bb, kr = hu.f32_bound(img, pup, k)
        rb, rr = hu.error_ratios(got, ref, *hu.term_sums(img, pup, *cots, k),
                                 2 * bb, 2 * kr)
        check(max(rb, rr) <= 1.0, f"huygens kernels at bench shape: error "
              f"{rb} x the per-entry bound, RMS error {rr} x the RMS bound")
        # the largest |kernel - plain| and |plain| of each kernel's outputs
        err_b = {n: max_abs(got[sl], ref[sl]) for n, sl in names13}
        ref_scale = {n: max(float(v.abs().max()) for v in ref[sl])
                     for n, sl in names13}
        del got, ref
        ms.update({
            "huygens_fwd": time_ms(lambda i: hu.huygens_fwd(img, pup, k), 10),
            "huygens_bwd_img": time_ms(
                lambda i: hu.huygens_bwd_img(img, pup, *cots, k), 10),
            "huygens_bwd_pup": time_ms(
                lambda i: hu.huygens_bwd_pup(img, pup, *cots, k), 10),
        })
        plain_ms.update({
            "huygens_fwd": time_ms(
                lambda i: hu.huygens_fwd_plain(img, pup, k), 3),
            "huygens_bwd_img": time_ms(
                lambda i: hu.huygens_bwd_img_plain(img, pup, *cots, k), 3),
            "huygens_bwd_pup": time_ms(
                lambda i: hu.huygens_bwd_pup_plain(img, pup, *cots, k), 3),
        })
    del img, pup, cots
    pairs_b = Pb * Qb
    work.update({
        # 3 image arrays and 8 pupil arrays in; (re, im) out
        "huygens_fwd": (pairs_b * (OPS_PAIR + OPS_FWD_ACC),
                        (5 * Pb + 8 * Qb) * 4),
        # and the 2 cotangents in; 3 image gradients out
        "huygens_bwd_img": (pairs_b * (OPS_PAIR + OPS_ADJ + OPS_IMG_ACC),
                            (8 * Pb + 8 * Qb) * 4),
        # 5 image-side arrays and 8 pupil arrays in; 8 pupil gradients out
        "huygens_bwd_pup": (pairs_b * (OPS_PAIR + OPS_ADJ + OPS_PUP_EXTRA),
                            (5 * Pb + 16 * Qb) * 4),
    })
    report["phases"]["huygens_bench_shape"] = {
        "bound_ratio": rb, "rms_ratio": rr, "max_abs_err": err_b,
        "max_abs_ref": ref_scale}
    log(f"phase 13 huygens kernels at P={Pb}, Q={Qb} (f32) against the f32 "
        f"plain version: worst entry {rb:.3e} x twice the per-entry bound, "
        f"RMS {rr:.3e} x twice the RMS bound; max |d| "
        f"{ {k: float(f'{v:.4g}') for k, v in err_b.items()} } against "
        f"largest |plain| {ref_scale}; ms "
        f"{ {k: round(ms[k], 4) for k in hu.LAUNCHES} }; plain ms "
        f"{ {k: round(plain_ms[k], 2) for k in hu.LAUNCHES} }")

    # ---- phase 14: the polarized kernels against their plain versions ----
    config.set_precision("float64")
    from optiland_torch.polarization import create_polarization
    from optiland_torch.samples import polarized as pol_samples

    STATE_H = create_polarization("H")
    g14 = torch.Generator(device=dev).manual_seed(14)

    def pol_err(a, b):
        """arr_err of the 8 ray arrays; the p entries' largest |a - b| over
        the largest |p| entry (some entries vanish exactly, and their
        rounding noise has no scale of its own)."""
        e = arr_err(a[:8], b[:8])
        if len(b) > 8:
            scale = max(float(v.abs().max()) for v in b[8:])
            e = max(e, max(float((u - v).abs().max())
                           for u, v in zip(a[8:], b[8:])) / scale)
        return e

    def pol_parity(pk, coat_k, spec_k, nc_k, ins, c, states, intensity,
                   what, coeffs=None, lay=None, f32_plain=False):
        """pol_fwd and pol_bwd (f64 inputs) against their plain versions,
        and the f32 kernels on the same inputs rounded to f32 against the
        f64 plain versions; raises on a failed check, returns the errors.
        f64: the per-ray arrays to 1e-10 of each array's largest value (the
        input cotangents: or of 1e-6 of the largest of all, where an array
        is smaller, as the summed gradients' entries), the summed gradients
        to 1e-9 of each entry. f32: p and the intensity are products of
        S - 1 updates of ~400 rounded operations each, ~1e-5 of their O(1)
        size; the per-ray arrays within 1e-4 x max(1, max |ref|), the input
        cotangents within 1e-3 of each array's largest or of 1e-4 of the
        largest of all (an array that analytically vanishes, as the launch
        z's of a trace whose loss reads only x and y, carries the f32
        rounding of the others, ~1e-7 of their size), the summed gradients
        to 1e-3 in L2. ``f32_plain``: the f32 plain version runs on the
        same rounded inputs too, and the input cotangents are held within
        1e-3 or within 4x the plain version's own error, whichever is more:
        K9's f32 adjoint, as the reference's, divides a cancelling sum by
        |k0 x k1| (ROADMAP Queue 3), so near normal incidence the plain
        version errs past 1e-3 as well; 4x leaves room for the kernel's
        other rounding order and contractions."""
        r = {}
        out_k = pt.pol_fwd(pk, coat_k, spec_k, ins, states, intensity, coeffs,
                           lay)
        out_p = pt.pol_fwd_plain(pk, coat_k, spec_k, ins, states, intensity,
                                 coeffs, lay)
        din_k, fl_k = pt.pol_bwd(pk, coat_k, spec_k, nc_k, ins, c, states,
                                 intensity, coeffs, lay)
        din_p, fl_p = pt.pol_bwd_plain(pk, coat_k, spec_k, ins, c, states,
                                       intensity, coeffs, nc_k,
                                       with_coeffs=True, lay=lay)
        r["fwd"] = pol_err(out_k, out_p)
        r["bwd_din"] = arr_err(din_k, din_p, 1e-6)
        r["bwd"] = flat_err(fl_k, fl_p, 1e-9, f"pol_bwd {what}")
        for key in ("fwd", "bwd_din"):
            check(r[key] <= 1e-10, f"{key} {what} f64: rel err {r[key]} > "
                  f"1e-10")
        c32 = None if coeffs is None else coeffs.float()
        l32 = None if lay is None else lay.float()
        out32 = pt.pol_fwd(pk.float(), coat_k.float(), spec_k,
                           [t.float() for t in ins], states, intensity, c32,
                           l32)
        r["f32"] = max(float((u.double() - v).abs().max())
                       / max(1.0, float(v.abs().max()))
                       for u, v in zip(out32, out_p))
        din32, fl32 = pt.pol_bwd(pk.float(), coat_k.float(), spec_k, nc_k,
                                 [t.float() for t in ins],
                                 [t.float() for t in c], states, intensity,
                                 c32, l32)
        r["f32_din"] = arr_err(din32, din_p, 1e-4)
        r["f32_grad_l2"] = l2(fl32, fl_p)
        tol_din = 1e-3
        if f32_plain:
            din32p, _ = pt.pol_bwd_plain(
                pk.float(), coat_k.float(), spec_k, [t.float() for t in ins],
                [t.float() for t in c], states, intensity, c32, nc_k,
                with_coeffs=True, lay=l32)
            r["f32_plain_din"] = arr_err(din32p, din_p, 1e-4)
            tol_din = max(tol_din, 4 * r["f32_plain_din"])
            del din32p
        check(r["f32"] <= 1e-4 and r["f32_din"] <= tol_din
              and r["f32_grad_l2"] <= 1e-3,
              f"pol kernels f32 {what}: "
              f"per-ray error {r['f32']} > 1e-4, input cotangents "
              f"{r['f32_din']} > {tol_din} or gradient L2 "
              f"{r['f32_grad_l2']} > 1e-3")
        return r

    res14 = {}
    for kind in pol_samples.KINDS + pol_samples.BENCH_CLASSES[1:]:
        lens_k = (pol_samples.bench_polarized(kind)
                  if kind in pol_samples.BENCH_CLASSES
                  else pol_samples.polarized_system(kind))
        sysk = lens_k.system
        spec_k = pt.pol_spec(sysk, WL)
        check(spec_k is not None, f"phase 14 {kind}: not pol_supported")
        nc_k = sysk.stack.coeffs.shape[1]
        with torch.no_grad():
            pk = ft.build_param_table(sysk, WL).contiguous()
            rays = raygen.generate_rays(sysk, *H, Px64, Py64, WL)
        coat_k = pt.build_coat_table(sysk, WL, torch.float64, dev)
        ins = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
        ins[6] = 0.5 + 0.5 * torch.rand(Rc, generator=g14, device=dev,
                                        dtype=torch.float64)
        ins[7] = torch.rand(Rc, generator=g14, device=dev,
                            dtype=torch.float64)
        cots = [torch.randn(Rc, generator=g14, device=dev,
                            dtype=torch.float64) for _ in range(pt.N_POL)]
        r = {}
        for mode, states, intensity in (
                ("full", None, False),
                ("H", pt.pol_states(STATE_H), True),
                ("unpolarized", pt.pol_states(None), True)):
            c = cots[:8] if intensity else cots
            for key, v in pol_parity(pk, coat_k, spec_k, nc_k, ins, c,
                                     states, intensity,
                                     f"{kind} {mode}").items():
                r[f"{key}_{mode}"] = v
        torch.cuda.synchronize()
        res14[kind] = r
        log(f"phase 14 pol kernels {kind} (2^{args.check_log2} rays, f64 vs "
            f"plain: per-ray arrays max |d| / max |ref| tol 1e-10, "
            f"gradients worst rel err tol 1e-9; f32 vs f64 plain: per-ray "
            f"tol 1e-4 x max(1, max |ref|), input cotangents tol 1e-3 of "
            f"each array's largest, gradient L2 tol 1e-3): "
            + ", ".join(f"{k} {v:.2e}" for k, v in r.items()))
    report["phases"]["pol_kernels"] = res14
    del ins, cots

    # ---- phase 15: the polarized step at full width ----
    config.set_precision("float32")

    def pol_loss(system, seed):
        """bench.py's polarized step: pupil from prng_disk, generate_rays,
        the in-kernel exit intensity, the spread of (x i, y i)."""
        Px, Py = ft.prng_disk(seed, Rf, 0, torch.float32, dev)
        rays = raygen.generate_rays(system, *H, Px, Py, WL)
        out = pt.trace_fast_pol_intensity(system, rays, WL, state=STATE_H)
        x, y = out.x * out.i, out.y * out.i
        return ((x - x.mean()) ** 2 + (y - y.mean()) ** 2).mean()

    res15 = {}
    for cls, steps in (("polarized", args.steps), ("polarized_axis", 3),
                       ("polarized_tmm", 3)):
        pbase = pol_samples.bench_polarized(cls).system
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sl, lv = leaf_system(pbase)
        first = pol_loss(sl, 4000)
        first.backward()
        check(bool(torch.isfinite(first)), f"{cls}: value not finite")
        check(bool(torch.isfinite(lv["radius"].grad[1:-1]).all()),
              f"{cls}: radius gradient not finite")
        nan15 = {k: int((~torch.isfinite(v.grad)).sum())
                 for k, v in lv.items()
                 if v.grad is not None and not bool(torch.isfinite(v.grad)
                                                    .all())}

        def vg_pol(i, pbase=pbase):
            sk, _ = leaf_system(pbase)
            pol_loss(sk, i).backward()

        if steps == args.steps:
            times15 = timed(vg_pol, 4100)
            n15 = 1 + 3 + args.steps
        else:
            for i in range(steps):
                vg_pol(4100 + i)
            torch.cuda.synchronize()
            times15 = []
            n15 = 1 + steps
        got15 = counts()
        wall15 = time.perf_counter() - t0
        expect15 = {**dict.fromkeys(got15, 0), "prng_disk": n15,
                    "pol_fwd_intensity": n15, "pol_bwd_intensity": n15}
        check(got15 == expect15, f"{cls} launches {got15}, expected "
              f"{expect15}")
        path_launches[cls] = got15
        step15 = float(np.median(times15)) if times15 else None
        res15[cls] = {"value": float(first.detach()), "step_ms": step15,
                      "step_ms_all": times15, "launches": got15,
                      "steps": n15, "nan_entries": nan15}
        log(f"phase 15 {cls}: {n15} value+grad steps over every stack leaf "
            f"in {wall15:.1f} s, value {float(first.detach()):.9e}; "
            + (f"median step {step15:.3f} ms over {args.steps} steps -> "
               f"{Rf * 3 / (step15 * 1e-3):.4e} ray-surf/s; "
               if step15 else "")
            + f"non-finite gradient entries: {nan15}; launches {got15}")
    # one polarized Optic.trace of ~2^24 hexapolar rays (pol_fwd)
    rings = int(round((np.sqrt(12 * Rf - 3) - 3) / 6))
    lens_pol = pol_samples.bench_polarized()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = lens_pol.trace(Hy=0.7, num_rays=rings, record=False)
    torch.cuda.synchronize()
    t_pot = time.perf_counter() - t0
    got = counts()
    n_rays = 1 + 3 * rings * (rings + 1)
    check(got == {**dict.fromkeys(got, 0), "pol_fwd": 1},
          f"polarized Optic.trace launches {got}, expected pol_fwd once")
    check(res.x.shape == (n_rays,) and tuple(res.p.shape) == (n_rays, 3, 3),
          f"polarized Optic.trace: shapes {tuple(res.x.shape)}, "
          f"{tuple(res.p.shape)}")
    check(bool(torch.isfinite(res.x).all() and torch.isfinite(res.p).all()
               and ((res.i >= 0) & (res.i <= 1)).all()),
          "polarized Optic.trace: non-finite rays or p, or intensity "
          "outside [0, 1]")
    path_launches["pol_optic_trace"] = got
    res15["optic_trace"] = {"rays": n_rays, "host_s": t_pot, "launches": got,
                            "mean_i": float(res.i.mean())}
    log(f"phase 15 polarized Optic.trace(Hy=0.7, num_rays={rings}, "
        f"record=False): {n_rays} rays in {t_pot:.2f} s host wall; mean "
        f"polarized intensity {float(res.i.mean()):.6f}; launches {got}")
    del res
    report["phases"]["pol_paths"] = res15

    def pol_full_width(system, intensities, seed, tag=""):
        """The polarized kernels alone at the polarized step's shape (2^24
        rays, f32) on ``system``, in the modes ``intensities``: times into
        ms, plain times into plain_ms and max |kernel - plain| into kerr,
        under each kernel's launch-count name (its build's) and ``tag``,
        with the coefficient and layout tables of launch.kernel_tables,
        and the f32 kernels held
        against the f32 plain versions. The plain versions run over four
        chunks of 2^22 rays (their intermediates at 2^24 would not fit
        beside the rest). Returns the spec and the errors."""
        spec_p = pt.pol_spec(system, WL)
        check(spec_p is not None, "pol_full_width: not pol_supported")
        with torch.no_grad():
            cf_p, lay_p = launch_build.kernel_tables(system, torch.float32)
        S_p, nc_p = len(spec_p[0]), cf_p.shape[1]
        tilt = any(spec_p[5])
        build = pt._build(spec_p)
        with torch.no_grad():
            pp = ft.build_param_table(system, WL).contiguous()
            Pxp, Pyp = ft.prng_disk(15, Rf, 0, torch.float32, dev)
            rays = raygen.generate_rays(system, *H, Pxp, Pyp, WL)
        del Pxp, Pyp
        coat_p = pt.build_coat_table(system, WL, torch.float32, dev)
        ins_p = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
        del rays
        gen15 = torch.Generator(device=dev).manual_seed(seed)
        cots_p = [torch.randn(Rf, generator=gen15, device=dev) / Rf
                  for _ in range(pt.N_POL)]
        st_h = pt.pol_states(STATE_H)
        spans = chunk_spans(Rf // 4)

        def chunked_plain(kind, intensity, i=0):
            """The plain version over the chunks: the outputs (fwd: per-ray
            arrays; bwd: (din, flat))."""
            outs = []
            for a, b in spans:
                ins_c = [t[a:b] for t in ins_p]
                if kind == "fwd":
                    outs.append(pt.pol_fwd_plain(pp, coat_p, spec_p, ins_c,
                                                 st_h, intensity, cf_p,
                                                 lay_p))
                else:
                    c = [t[a:b] for t in (cots_p[:8] if intensity
                                          else cots_p)]
                    outs.append(pt.pol_bwd_plain(pp, coat_p, spec_p, ins_c,
                                                 c, st_h, intensity, cf_p,
                                                 nc_p, with_coeffs=True,
                                                 lay=lay_p))
            return outs

        # each chunk of the kernel's outputs against the plain version's:
        # every array on its own within 2e-4 x max(1, max |ref|) and finite
        # where the plain one is (near32; a ray whose radius falls within
        # rounding of the stop's edge may be clipped in one only, so in the
        # full mode, or on a tilted system, up to 1 in 10^4 may differ in
        # intensity); the input cotangents within 1e-3 of each array's
        # largest value, the summed gradients to 1e-3 in L2
        errs = {}
        with torch.no_grad():
            for intensity in intensities:
                name = launch_key(
                    "pol_fwd_intensity" if intensity else "pol_fwd",
                    build) + tag
                bname = launch_key(
                    "pol_bwd_intensity" if intensity else "pol_bwd",
                    build) + tag
                c = cots_p[:8] if intensity else cots_p
                out_k = pt.pol_fwd(pp, coat_p, spec_p, ins_p, st_h,
                                   intensity, cf_p, lay_p)
                kerr[name] = chunked_fwd(
                    out_k, chunked_plain("fwd", intensity), spans,
                    f"{name} full width",
                    0.0 if intensity and not tilt else 1e-4)
                del out_k
                din_k, fl_k = pt.pol_bwd(pp, coat_p, spec_p, nc_p, ins_p, c,
                                         st_h, intensity, cf_p, lay_p)
                errs[bname], din_abs, fl_sum = chunked_bwd(
                    din_k, chunked_plain("bwd", intensity), spans, 0.0)
                check(errs[bname] <= 1e-3, f"{bname} full width: input "
                      f"cotangents, max |d| / max |ref| {errs[bname]} > "
                      f"1e-3")
                kerr[bname] = max(din_abs,
                                  float((fl_k - fl_sum).abs().max()))
                g_l2 = l2(fl_k, fl_sum)
                check(g_l2 <= 1e-3, f"{bname} full width: gradient L2 rel "
                      f"err {g_l2} > 1e-3")
                errs[f"{bname}_l2"] = g_l2
                del din_k
                ms[name] = time_ms(lambda i, it=intensity: pt.pol_fwd(
                    pp, coat_p, spec_p, ins_p, st_h, it, cf_p, lay_p), 10, 3)
                ms[bname] = time_ms(lambda i, it=intensity, c=c: pt.pol_bwd(
                    pp, coat_p, spec_p, nc_p, ins_p, c, st_h, it, cf_p,
                    lay_p), 5)
                plain_ms[name] = time_ms(
                    lambda i, it=intensity: chunked_plain("fwd", it), 2)
                plain_ms[bname] = time_ms(
                    lambda i, it=intensity: chunked_plain("bwd", it), 2)
            torch.cuda.synchronize()
        return spec_p, errs

    spec_p, din_err15 = pol_full_width(pol_samples.bench_polarized().system,
                                       (False, True), 15)
    report["phases"]["pol_full_width"] = din_err15
    log("phase 15 polarized kernels at 2^%d rays (f32, the bench singlet) "
        "against the f32 plain version: every output array within 2e-4 x "
        "max(1, max |ref|); input cotangents (tol 1e-3 of each array's "
        "largest) and gradient L2 (tol 1e-3) %s; ms %s; plain ms (4 chunks) "
        "%s; max |kernel - plain| %s" % (
            args.full_log2,
            {k: float(f"{v:.3e}") for k, v in din_err15.items()},
            {k: round(ms[k], 4) for k in POL_NAMES},
            {k: round(plain_ms[k], 2) for k in POL_NAMES},
            {k: float(f"{kerr[k]:.4g}") for k in POL_NAMES}))

    def pol_ops(spec_k, n_states, nc_k=1, nets=None):
        """Operations per ray of (pol_fwd, pol_fwd_intensity, pol_bwd,
        pol_bwd_intensity) for the kernels' spec, surface by surface: its
        geometry code (``geo_ops``, nc_k coefficients, a NURBS surface's
        structure from ``nets``, its system's geom_aux), absorption, coat
        kind and tilt."""
        nets = nets or (None,) * len(spec_k[0])
        codes, _, absorbs, kinds, layers, tilted = spec_k[:6]
        names = {pt.NONE: "none", pt.SIMPLE: "simple", pt.FRESNEL: "fresnel",
                 pt.POLARIZER: "polarizer", pt.RETARDER: "retarder"}
        fwd = adj = 0
        for s in range(1, len(codes)):
            g_f, g_a = geo_ops(codes[s], nc_k, spec_k[-1], net=nets[s])
            if kinds[s] == pt.TMM:
                jones = OPS_TMM_BASE + OPS_TMM_LAYER * layers[s]
                jones_adj = OPS_TMM_ADJ_BASE + OPS_TMM_ADJ_LAYER * layers[s]
            else:
                jones = OPS_POL_JONES[names[kinds[s]]]
                jones_adj = OPS_POL_JONES_ADJ[names[kinds[s]]]
            fwd += (g_f + OPS_FULL_FWD + OPS_ABS_FWD * bool(absorbs[s])
                    + OPS_POL_BASIS + OPS_POL_UPDATE + jones)
            adj += (g_a + OPS_FULL_ADJ + OPS_EXTRAS_ADJ
                    + (OPS_ABS_BWD - OPS_ABS_FWD) * bool(absorbs[s])
                    + OPS_POL_BASIS_ADJ + OPS_POL_UPDATE_ADJ + jones_adj)
            if tilted[s]:
                fwd += OPS_TILT_FWD
                adj += OPS_TILT_ADJ
        exit_f = OPS_POL_EXIT[0] + OPS_POL_EXIT[1] * n_states
        exit_a = OPS_POL_EXIT_ADJ[0] + OPS_POL_EXIT_ADJ[1] * n_states
        return fwd, fwd + exit_f, fwd + adj, fwd + exit_f + adj + exit_a

    n_h = len(pt.pol_states(STATE_H))
    ops_f, ops_fi, ops_b, ops_bi = pol_ops(spec_p, n_h)
    S_p = len(spec_p[0])
    tbl = (S_p * (ft.NUM_P + 4) + 6 * S_p) * 4
    red = 2 * ft.BWD_MAX_BLOCKS * S_p * (len(ftr.FULL_GRAD_COLS) + 4) * 4
    work.update({
        # 8 arrays in, 26 out
        "pol_fwd": (Rf * ops_f, tbl + Rf * 34 * 4),
        # 8 arrays in, 8 out, the exit intensity of one state
        "pol_fwd_intensity": (Rf * ops_fi, tbl + Rf * 16 * 4),
        # 8 arrays and 26 cotangents in, 8 input cotangents out
        "pol_bwd": (Rf * ops_b, tbl + Rf * 42 * 4 + red),
        # 8 arrays and 8 cotangents in, 8 out, the exit intensity's adjoint
        "pol_bwd_intensity": (Rf * ops_bi, tbl + Rf * 24 * 4 + red),
    })
    log(f"phase 15 operations per ray (from the spec: codes {spec_p[0]}, "
        f"coat kinds {spec_p[3]}): pol_fwd {ops_f}, pol_fwd_intensity "
        f"{ops_fi}, pol_bwd {ops_b}, pol_bwd_intensity {ops_bi}")

    # ---- phase 16: the vectorial Huygens PSF path ----
    # examples/08's coated doublet in H polarization at EPD 4, without its
    # image solve
    lens16 = pol_samples.coated_doublet("H", epd=4.0)
    psf16_base = lens16.system

    def psf16_vg(system):
        """Value and gradient of the centre pixel of the vectorial PSF with
        respect to every stack leaf, at the entry point's defaults."""
        sl, lv = leaf_system(system)
        psf, _, norm = huygens_psf(sl, 0.0, 0.0, WL, pol_state=STATE_H,
                                   vectorial=True)
        strehl = psf[c13, c13] / 100
        strehl.backward()
        return psf.detach(), strehl.detach(), lv, norm.detach()

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    psf16, strehl16, lv16, norm16 = psf16_vg(psf16_base)
    check(tuple(psf16.shape) == (npix, npix)
          and bool(torch.isfinite(psf16).all()), "vectorial PSF: not finite")
    check(0.0 < float(strehl16) <= 1.2, f"vectorial PSF: Strehl "
          f"{float(strehl16)}")
    grads16 = {k: v.grad for k, v in lv16.items() if v.grad is not None}
    check(bool(torch.isfinite(grads16["radius"][1:-1]).all()),
          "vectorial PSF path: radius gradient not finite")
    nan16 = {k: int((~torch.isfinite(g)).sum()) for k, g in grads16.items()
             if not bool(torch.isfinite(g).all())}
    times16 = timed(lambda i: psf16_vg(psf16_base), 0)
    got16 = counts()
    wall16 = time.perf_counter() - t0
    n16 = 1 + 3 + args.steps
    # per step: 3 components x (the field sum, the normalization), each
    # with both adjoints; 4 polarized traces forward and backward: chief
    # ray, pupil, image grid, working F-number (field (0, 0): the
    # normalization reuses the wavefront)
    expect16 = {**dict.fromkeys(got16, 0),
                "huygens_fwd": 6 * n16, "huygens_bwd_img": 6 * n16,
                "huygens_bwd_pup": 6 * n16, "pol_fwd": 4 * n16,
                "pol_bwd": 4 * n16}
    check(got16 == expect16, f"vectorial PSF path launches {got16}, "
          f"expected {expect16}")
    path_launches["vectorial_psf"] = got16
    # the entry point a user calls: HuygensPSF of the polarized optic
    with torch.no_grad():
        h16 = HuygensPSF(lens16, (0.0, 0.0), WL)
    check(type(h16).__name__ == "VectorialHuygensPSF"
          and abs(h16.strehl_ratio() - float(strehl16)) <= 1e-6,
          f"HuygensPSF: {type(h16).__name__}, Strehl {h16.strehl_ratio()} "
          f"vs {float(strehl16)}")
    step16 = float(np.median(times16))

    # the polarized kernels at the inputs this path gives them: one more
    # f32 step and one f64 step (outside the counted run) with pol_bwd
    # recording its arguments, the traces' inputs and output cotangents
    def captured(fn):
        calls, bwd = [], pt.pol_bwd

        def record(*a):
            calls.append(a)
            return bwd(*a)

        pt.pol_bwd = record
        try:
            out = fn()
        finally:
            pt.pol_bwd = bwd
        return out, calls

    _, calls32 = captured(lambda: psf16_vg(psf16_base))
    config.set_precision("float64")
    lens64 = pol_samples.coated_doublet("H", epd=4.0)
    sys64 = lens64.system
    (psf64, _, _, norm64), calls64 = captured(lambda: psf16_vg(sys64))
    check(len(calls32) == len(calls64) == 4, f"vectorial PSF: "
          f"{len(calls32)} f32 and {len(calls64)} f64 polarized traces "
          f"recorded, expected 4 each")
    res16 = {}
    for prec, calls in (("f32", calls32), ("f64", calls64)):
        for (params, coat, spec_c, nc_c, rays_c, cots_c, states, inten,
             coeffs_c, lay_c) in calls:
            n_c = rays_c[0].shape[0]
            what = f"vectorial PSF {prec} trace of {n_c} rays"
            with torch.no_grad():
                r = pol_parity(params.detach().double(), coat.double(),
                               spec_c, nc_c, [t.double() for t in rays_c],
                               [t.double() for t in cots_c], states, inten,
                               what, coeffs=coeffs_c.double(),
                               lay=None if lay_c is None else lay_c.double())
            res16[f"{prec}_{n_c}"] = r
    torch.cuda.synchronize()
    log("phase 16 polarized kernels at the vectorial PSF path's inputs "
        "(the f32 step's and the f64 step's traces; f64 kernels vs plain: "
        "per-ray arrays tol 1e-10, gradients tol 1e-9; f32 kernels on the "
        "f32 step's inputs vs the f64 plain versions: per-ray tol 1e-4 x "
        "max(1, max |ref|), input cotangents tol 1e-3, gradient L2 tol "
        "1e-3): " + "; ".join(
            f"{k} rays: " + ", ".join(f"{n} {v:.2e}" for n, v in r.items())
            for k, r in res16.items()))

    # the f64 PSF with the plain polarized versions in place of the
    # kernels, against the f64 PSF of the kernels
    fwd_kernel = pt.pol_fwd
    pt.pol_fwd = pt.pol_fwd_plain
    try:
        with torch.no_grad():
            psf64_plain, _, _ = huygens_psf(sys64, 0.0, 0.0, WL,
                                            pol_state=STATE_H,
                                            vectorial=True)
    finally:
        pt.pol_fwd = fwd_kernel
    peak64 = float(psf64.abs().max())
    e_plain = float((psf64 - psf64_plain).abs().max()) / peak64
    check(e_plain <= 1e-9, f"vectorial PSF f64, kernels vs plain polarized "
          f"versions: max |d| {e_plain} of the peak > 1e-9")

    # f32 against f64, every pixel within the bound derived from f32
    # rounding (psf_f32_bound; PERF.md gives the derivation)
    from optiland_torch.core import trace as trace_core
    from optiland_torch.psf.huygens_fresnel import _image_grid
    from optiland_torch.wavefront import compute_wavefront_data

    with torch.no_grad():
        xg, yg, mask = pupil_grid_coords(128)
        data64 = compute_wavefront_data(sys64, 0.0, 0.0, WL, xg[mask],
                                        yg[mask], pol_state=STATE_H)
        gx, gy, gz, _ = _image_grid(sys64, 0.0, 0.0, WL, npix)
        zc = torch.zeros(1, dtype=torch.float64, device=dev)
        chief, _ = trace_core.trace(
            sys64, raygen.generate_rays(sys64, 0.0, 0.0, zc, zc, WL),
            record=False, wavelength=WL)
        path_mm = float(chief.opd.abs().max() + data64.radius.abs())
        config.set_precision("float32")
        xg32, yg32, mask32 = pupil_grid_coords(128)
        data32 = compute_wavefront_data(psf16_base, 0.0, 0.0, WL,
                                        xg32[mask32], yg32[mask32],
                                        pol_state=STATE_H)
        config.set_precision("float64")
        bound16, sigma16, parts16 = psf_f32_bound(
            torch, hu, data64, data32, (gx.reshape(-1), gy.reshape(-1),
                                        gz.reshape(-1)),
            norm64, psf64, WL)
    # the f32 wavefront's phase error against its rounding estimate
    s_wf = (2 * math.pi / (WL * 1e-3) * path_mm * 2.0**-24
            * math.sqrt(N_ROUND_WF / 3))
    check(parts16["sigma_phase"] <= s_wf, f"vectorial PSF: f32 wavefront "
          f"phase RMS error {parts16['sigma_phase']} rad > {s_wf}")
    # and its exit fields against the per-ray tolerance of phase 14 (the
    # products of S - 1 rounded updates, ~1e-5 of their size)
    check(parts16["sigma_amp"] <= 1e-4, f"vectorial PSF: f32 exit fields' "
          f"RMS relative error {parts16['sigma_amp']} > 1e-4")
    d16 = (psf16.double() - psf64).abs()
    ratio16 = float((d16 / bound16).max())
    s64 = float(psf64[c13, c13]) / 100
    e_s = abs(float(strehl16) - s64)
    check(ratio16 <= 1.0, f"vectorial PSF f32 vs f64: a pixel off by "
          f"{ratio16} x its bound")
    log(f"phase 16 vectorial PSF path: {n16} value+grad steps in "
        f"{wall16:.1f} s; Strehl {float(strehl16):.9e} (f64 {s64:.9e}, "
        f"f64 with the plain polarized versions: max |d| {e_plain:.2e} of "
        f"the peak, tol 1e-9); f32 vs f64: worst pixel {ratio16:.3e} x its "
        f"bound (tol 1), |d| at the Strehl pixel {e_s * 100:.3e} against "
        f"{float(bound16[c13, c13]):.3e} (peak {peak64:.4f}); per-term RMS "
        f"error sigma {sigma16:.4e} ("
        + ", ".join(f"{k} {v:.3e}" for k, v in parts16.items())
        + f"; the wavefront phase's rounding estimate {s_wf:.3e} rad over "
        f"{path_mm:.2f} mm); median value+grad step "
        f"{step16:.3f} ms over {args.steps} steps; non-finite gradient "
        f"entries: {nan16}; launches {got16}")
    report["phases"]["vectorial_psf"] = {
        "strehl": float(strehl16), "strehl_f64": s64, "strehl_abs_err": e_s,
        "f64_plain_rel": e_plain, "f32_bound_ratio": ratio16,
        "sigma": sigma16, **parts16, "sigma_phase_estimate": s_wf,
        "path_mm": path_mm,
        "pol_kernels": res16, "step_ms": step16, "step_ms_all": times16,
        "launches": got16, "steps": n16, "nan_entries": nan16}
    del psf16, psf64, psf64_plain, lv16, grads16, calls32, calls64
    config.set_precision("float32")

    # ---- phase 17: the polychromatic kernels (K5a/K5b poly mode) ----
    config.set_precision("float64")

    def cycled(n, dtype):
        """Wavelengths 0.48/0.55/0.65 um cycling by ray index, made on the
        card (bench.py's poly class)."""
        return torch.tensor(POLY_WLS, dtype=dtype, device=dev)[
            torch.arange(n, device=dev) % 3]

    g17 = torch.Generator(device=dev).manual_seed(17)
    res17 = {}
    for kind, sysk in (("cooke", systems["f64"]), ("zoo", perturbed.zoo_system(systems["f64"], POLY_WLS))):
        spec_k = ftr.poly_spec(sysk)
        check(spec_k is not None, f"phase 17 {kind}: no poly spec")
        nc_k, S_k = sysk.stack.coeffs.shape[1], len(spec_k[0])
        with torch.no_grad():
            pk = ftr.build_poly_table(sysk).contiguous()
            rays = raygen.generate_rays(sysk, *H, Px64, Py64, WL)
        mk = sysk.stack.mat_coeffs.detach().contiguous()
        ins = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
        ins[6] = 0.5 + 0.5 * torch.rand(Rc, generator=g17, device=dev,
                                        dtype=torch.float64)
        ins[7] = torch.rand(Rc, generator=g17, device=dev, dtype=torch.float64)
        ins.append(cycled(Rc, torch.float64))
        cots = [torch.randn(Rc, generator=g17, device=dev, dtype=torch.float64)
                for _ in range(8)]
        r = {}
        out_k = ftr.trace_fwd_poly(pk, mk, spec_k, ins)
        out_p = ftr.trace_fwd_poly_plain(pk, mk, spec_k, ins)
        r["trace_fwd_poly"] = arr_err(out_k, out_p)
        din_k, fl_k = ftr.trace_bwd_poly(pk, mk, spec_k, nc_k, ins, cots)
        din_p, fl_p = ftr.trace_bwd_poly_plain(pk, mk, spec_k, nc_k, ins,
                                               cots)
        pg, mg = pk.clone().requires_grad_(), mk.clone().requires_grad_()
        insg = [t.clone().requires_grad_() for t in ins[:8]]
        out_a = ftr.trace_fwd_poly_plain(pg, mg, spec_k, insg + ins[8:])
        auto = torch.autograd.grad(
            sum((o * c).sum() for o, c in zip(out_a, cots)), [pg, mg] + insg)
        fl_a = torch.cat([auto[0].reshape(-1), pk.new_zeros(S_k * nc_k),
                          auto[1].reshape(-1)])
        check(torch.equal(torch.isfinite(fl_k), torch.isfinite(fl_p)),
              f"trace_bwd_poly {kind}: finite in one and not the other")
        r["trace_bwd_poly"] = flat_err(fl_k, fl_p, 1e-9,
                                       f"trace_bwd_poly {kind}")
        # autograd of the plain forward where the hand adjoint is finite
        # (d x^y / dx at x = y = 0 is NaN by JAX's rule, 0 by torch's)
        fin_p = torch.isfinite(fl_p)
        r["trace_bwd_poly_autograd"] = flat_err(
            fl_k[fin_p], fl_a[fin_p], 1e-9,
            f"trace_bwd_poly {kind} vs autograd")
        r["trace_bwd_poly_din"] = arr_err(din_k, din_p)
        r["trace_bwd_poly_din_autograd"] = arr_err(din_k, auto[2:])
        dm_k = fl_k[-mk.numel():].reshape(mk.shape)
        dm_p = fl_p[-mk.numel():].reshape(mk.shape)
        check(torch.equal(dm_k != 0, dm_p != 0), f"trace_bwd_poly {kind}: "
              "the nonzero coefficient gradients differ from the plain "
              "version's")
        r["dmats_nonzero"] = int((dm_k != 0).sum())
        del out_a, auto, insg
        for key in ("trace_fwd_poly", "trace_bwd_poly_din",
                    "trace_bwd_poly_din_autograd"):
            check(r[key] <= 1e-10, f"{key} {kind} f64: rel err {r[key]} > "
                  "1e-10")
        if kind == "cooke":
            # f32 against the f64 plain versions
            p32k, m32k = pk.float(), mk.float()
            ins32 = [t.float() for t in ins]
            cots32 = [t.float() for t in cots]
            near32(ftr.trace_fwd_poly(p32k, m32k, spec_k, ins32), out_p,
                   f"trace_fwd_poly f32 {kind}", Rc // 10_000)
            din32, fl32 = ftr.trace_bwd_poly(p32k, m32k, spec_k, nc_k, ins32,
                                             cots32)
            near32(din32[:6], din_p[:6], f"trace_bwd_poly f32 {kind}")
            r["trace_bwd_poly_f32_l2"] = l2(fl32, fl_p)
            check(r["trace_bwd_poly_f32_l2"] <= 1e-3, f"trace_bwd_poly f32 "
                  f"{kind}: L2 rel err {r['trace_bwd_poly_f32_l2']} > 1e-3")
            # one wavelength for every ray: the monochromatic kernel's x, y
            # (it also absorbs, which moves only the intensity)
            ins1 = ins[:8] + [torch.full_like(ins[0], WL)]
            pm, _ = tables(sysk)
            mono = ftr.trace_fwd(pm, ftr.fast_spec(sysk), ins[:8])
            one = ftr.trace_fwd_poly(pk, mk, spec_k, ins1)
            r["mono_xy"] = max(float((a - b).abs().max())
                               for a, b in zip(one[:2], mono[:2]))
            check(r["mono_xy"] <= 1e-10, f"trace_fwd_poly at one wavelength "
                  f"vs trace_fwd: |dx|, |dy| {r['mono_xy']} > 1e-10 mm")
        torch.cuda.synchronize()
        res17[kind] = r
        log(f"phase 17 poly kernels {kind} (formulas {spec_k[4]}, "
            f"2^{args.check_log2} rays at {POLY_WLS} um; f64 vs plain: "
            f"per-ray arrays max |d| / max |ref| tol 1e-10, gradients "
            f"(every coefficient column) worst rel err tol 1e-9): "
            + ", ".join(f"{k} {v:.2e}" if isinstance(v, float) else
                        f"{k} {v}" for k, v in r.items()))
    report["phases"]["poly_kernels"] = res17
    del ins, cots, din_k, din_p

    # the poly step at full width: bench.py's poly class on the port
    config.set_precision("float32")

    def poly_loss(system, seed):
        Px, Py = ft.prng_disk(seed, Rf, 0, torch.float32, dev)
        rays = raygen.generate_rays(system, *H, Px, Py,
                                    cycled(Rf, torch.float32))
        f = ftr.trace_fast_poly(system, rays)
        return ((f.x - f.x.mean()) ** 2 + (f.y - f.y.mean()) ** 2).mean()

    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    sl, lv = leaf_system(base)
    first = poly_loss(sl, 5000)
    first.backward()
    g_m = lv["mat_coeffs"].grad
    check(bool(torch.isfinite(first)), "poly step: value not finite")
    check(bool(torch.isfinite(lv["radius"].grad[1:-1]).all()),
          "poly step: radius gradient not finite")
    check(bool(torch.isfinite(g_m[1:-1]).all()) and bool((g_m != 0).any()),
          "poly step: mat_coeffs gradient not finite or all zero")
    nan17 = {k: int((~torch.isfinite(v.grad)).sum()) for k, v in lv.items()
             if v.grad is not None and not bool(torch.isfinite(v.grad).all())}
    def vg17(i):
        s_, _ = leaf_system(base)
        poly_loss(s_, i).backward()

    times17 = timed(vg17, 5100)
    got17 = counts()
    wall17 = time.perf_counter() - t0
    n17 = 1 + 3 + args.steps
    expect17 = {**dict.fromkeys(got17, 0), "prng_disk": n17,
                "trace_fwd_poly": n17, "trace_bwd_poly": n17}
    check(got17 == expect17, f"poly step launches {got17}, expected "
          f"{expect17}")
    path_launches["poly"] = got17
    step17 = float(np.median(times17))
    log(f"phase 17 poly step (Cooke triplet, f32, 2^{args.full_log2} rays "
        f"at {POLY_WLS} um cycling by ray): {n17} value+grad steps over "
        f"every stack leaf in {wall17:.1f} s, value "
        f"{float(first.detach()):.9e}; median step {step17:.3f} ms over "
        f"{args.steps} steps -> {Rf * n_surf / (step17 * 1e-3):.4e} "
        f"ray-surf/s; mat_coeffs gradient {int((g_m != 0).sum())} nonzero "
        f"entries; non-finite gradient entries: {nan17}; launches {got17}")
    report["phases"]["poly_step"] = {
        "value": float(first.detach()), "step_ms": step17,
        "step_ms_all": times17, "launches": got17, "steps": n17,
        "nan_entries": nan17}
    del lv, sl, first, g_m

    # the poly kernels alone at the step's shape (2^24 rays, f32)
    spec_q = ftr.poly_spec(base)
    with torch.no_grad():
        pq = ftr.build_poly_table(base).contiguous()
        Pxq, Pyq = ft.prng_disk(17, Rf, 0, torch.float32, dev)
        rays = raygen.generate_rays(base, *H, Pxq, Pyq, WL)
    mq = base.stack.mat_coeffs.detach().contiguous()
    ins_q = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
    ins_q.append(cycled(Rf, torch.float32))
    del rays, Pxq, Pyq
    gen17 = torch.Generator(device=dev).manual_seed(170)
    cots_q = [torch.randn(Rf, generator=gen17, device=dev) / Rf
              for _ in range(8)]
    with torch.no_grad():
        k5a = ftr.trace_fwd_poly(pq, mq, spec_q, ins_q)
        ref = ftr.trace_fwd_poly_plain(pq, mq, spec_q, ins_q)
        kerr["trace_fwd_poly"] = max_abs(k5a, ref)
        near32(k5a, ref, "trace_fwd_poly full width")
        del k5a, ref
        din_k, flat_k = ftr.trace_bwd_poly(pq, mq, spec_q, nc, ins_q, cots_q)
        din_p, flat_p = ftr.trace_bwd_poly_plain(pq, mq, spec_q, nc, ins_q,
                                                 cots_q)
        fin = torch.isfinite(flat_p)
        kerr["trace_bwd_poly"] = max(float((flat_k[fin] - flat_p[fin]).abs()
                                           .max()), max_abs(din_k, din_p))
        din_err17 = arr_err(din_k, din_p)
        l2_17 = l2(flat_k[fin], flat_p[fin])
        check(din_err17 <= 1e-3 and l2_17 <= 1e-3, f"trace_bwd_poly full "
              f"width: input cotangents {din_err17} or gradient L2 {l2_17} "
              "> 1e-3")
        del din_k, din_p, flat_k, flat_p
        ms["trace_fwd_poly"] = time_ms(
            lambda i: ftr.trace_fwd_poly(pq, mq, spec_q, ins_q), 10, 3)
        ms["trace_bwd_poly"] = time_ms(
            lambda i: ftr.trace_bwd_poly(pq, mq, spec_q, nc, ins_q, cots_q),
            10, 3)
        plain_ms["trace_fwd_poly"] = time_ms(
            lambda i: ftr.trace_fwd_poly_plain(pq, mq, spec_q, ins_q), 3)
        plain_ms["trace_bwd_poly"] = time_ms(
            lambda i: ftr.trace_bwd_poly_plain(pq, mq, spec_q, nc, ins_q,
                                               cots_q), 3)
        # the monochromatic kernels on the same bundle, for the cost of
        # the formulas
        ms17_mono = {
            "trace_fwd": time_ms(lambda i: ftr.trace_fwd(
                p32, spec32, ins_q[:8]), 10, 3),
            "trace_bwd": time_ms(lambda i: ftr.trace_bwd(
                p32, spec32, nc, ins_q[:8], cots_q), 10, 3)}
    # the formulas each ray evaluates: the object row's and each refracting
    # surface's; the adjoint evaluates them again in its retrace and then
    # the derivative of every coefficient each formula reads
    nm_q = mq.shape[1]
    evals = [0] + [s for s in range(1, S) if not spec_q[1][s]]
    f_fwd = sum(formula_ops(spec_q[4][s], nm_q)[0] for s in evals)
    f_bwd = f_fwd + sum(formula_ops(spec_q[4][s], nm_q)[1] for s in evals)
    n_red = S * (len(ftr.FULL_GRAD_COLS) + nm_q)
    work.update({
        # 9 arrays in (the 8 and the wavelengths), 8 out; no absorption
        "trace_fwd_poly": (Rf * (fwd_full - n_abs * OPS_ABS_FWD + f_fwd),
                           table_bytes + S * nm_q * 4 + Rf * 17 * 4),
        # 9 arrays and 8 cotangents in, 8 input cotangents out
        "trace_bwd_poly": (Rf * (bwd_full - n_abs * OPS_ABS_BWD + f_bwd),
                           table_bytes + S * nm_q * 4 + Rf * 25 * 4
                           + 2 * nb_b * n_red * 4 + out_bytes
                           + S * nm_q * 4),
    })
    report["phases"]["poly_full_width"] = {
        "din_err": din_err17, "grad_l2": l2_17, "mono_ms": ms17_mono,
        "formula_ops": {"fwd": f_fwd, "bwd": f_bwd}}
    log(f"phase 17 poly kernels at 2^{args.full_log2} rays (f32, Cooke "
        f"triplet) vs the f32 plain versions: every output array within 2e-4 "
        f"x max(1, max |ref|), input cotangents {din_err17:.2e} (tol 1e-3), "
        f"gradient L2 {l2_17:.2e} (tol 1e-3); ms trace_fwd_poly "
        f"{ms['trace_fwd_poly']:.4f}, trace_bwd_poly "
        f"{ms['trace_bwd_poly']:.4f} (mono kernels on the same bundle "
        f"{ms17_mono}); plain ms {plain_ms['trace_fwd_poly']:.2f}, "
        f"{plain_ms['trace_bwd_poly']:.2f}; formula operations per ray "
        f"forward {f_fwd}, adjoint {f_bwd}")
    del ins_q, cots_q

    # ---- phase 18: tilted surfaces in every trace kernel (K6 tilts) ----
    config.set_precision("float64")
    tc64 = perturbed.toleranced_cooke().system
    ts64 = perturbed.tilted_singlet().system
    spec_t = ftr.fast_spec(tc64, field=True)
    mspec_t = ft._spec_of(tc64)
    check(spec_t[3] == (False,) + (True,) * 6 + (False,)
          and mspec_t[2] == spec_t[3], f"phase 18: tilt flags {spec_t[3]}")
    g18 = torch.Generator(device=dev).manual_seed(18)
    nc_t = tc64.stack.coeffs.shape[1]
    S_t = len(spec_t[0])
    pk, ak = tables(tc64)
    with torch.no_grad():
        rays = raygen.generate_rays(tc64, *H, Px64, Py64, WL)
    ins = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
    ins[6] = 0.5 + 0.5 * torch.rand(Rc, generator=g18, device=dev,
                                    dtype=torch.float64)
    ins[7] = torch.rand(Rc, generator=g18, device=dev, dtype=torch.float64)
    cots = [torch.randn(Rc, generator=g18, device=dev, dtype=torch.float64)
            for _ in range(pt.N_POL)]
    r = {}
    r["trace_fwd"] = arr_err(ftr.trace_fwd(pk, spec_t, ins),
                             ftr.trace_fast_plain(pk, spec_t, ins))
    din_k, fl_k = ftr.trace_bwd(pk, spec_t, nc_t, ins, cots[:8])
    din_p, fl5_p = ftr.trace_fast_bwd_plain(pk, spec_t, nc_t, ins, cots[:8])
    r["trace_bwd"] = flat_err(fl_k, fl5_p, 1e-9, "tilted trace_bwd")
    r["trace_bwd_din"] = arr_err(din_k, din_p)
    pg = pk.clone().requires_grad_()
    insg = [t.clone().requires_grad_() for t in ins]
    out_a = ftr.trace_fast_plain(pg, spec_t, insg)
    auto = torch.autograd.grad(
        sum((o * c).sum() for o, c in zip(out_a, cots)), [pg] + insg)
    r["trace_bwd_autograd"] = flat_err(
        fl_k, torch.cat([auto[0].reshape(-1), pk.new_zeros(S_t * nc_t)]),
        1e-9, "tilted trace_bwd vs autograd")
    del out_a, auto, insg
    out_f = ftr.trace_field_fwd(pk, ak, spec_t, Px64, Py64)
    r["trace_field_fwd"] = arr_err(
        out_f, ftr.trace_fast_field_plain(pk, ak, spec_t, Px64, Py64))
    fl4_k = ftr.trace_field_bwd(pk, ak, spec_t, nc_t, Px64, Py64, cots[:8])
    fl4_p = ftr.trace_fast_field_bwd_plain(pk, ak, spec_t, nc_t, Px64, Py64,
                                           cots[:8])
    r["trace_field_bwd"] = flat_err(fl4_k, fl4_p, 1e-9,
                                    "tilted trace_field_bwd")
    rows_k = ft.merit_fwd(pk, ak, mspec_t, Rc, Px=Px64, Py=Py64)
    rows_p = ft.merit_fwd_plain(pk, ak, mspec_t, Rc, Px=Px64, Py=Py64)
    lk, xbt, ybt = ft._chan_combine(rows_k, Rc)
    r["merit_fwd"] = rel(lk, ft._chan_combine(rows_p, Rc)[0])
    st_t = torch.stack([xbt, ybt, torch.tensor(1.0 / Rc, device=dev,
                                               dtype=torch.float64),
                        torch.zeros((), device=dev, dtype=torch.float64)])
    fm_k = ft.merit_bwd(pk, ak, st_t, mspec_t, nc_t, Rc, Px=Px64, Py=Py64)
    fm_p = ft.merit_bwd_plain(pk, ak, st_t, mspec_t, nc_t, Rc, Px=Px64,
                              Py=Py64)
    r["merit_bwd"] = flat_err(fm_k, fm_p, 1e-9, "tilted merit_bwd")
    for key in ("trace_fwd", "trace_bwd_din", "trace_field_fwd"):
        check(r[key] <= 1e-10, f"tilted {key} f64: rel err {r[key]} > 1e-10")
    check(r["merit_fwd"] <= 1e-12, f"tilted merit_fwd f64: loss rel err "
          f"{r['merit_fwd']} > 1e-12")
    # every tilt column of every tilted surface is reached
    dp = fl_k[: S_t * ft.NUM_P].reshape(S_t, ft.NUM_P)
    check(bool((dp[1:7, 8:11] != 0).all()), "tilted trace_bwd: a tilt "
          "gradient of a tilted surface is zero")
    # f32 against the f64 plain versions
    p32t, a32t = pk.float(), ak.float()
    ins32 = [t.float() for t in ins]
    cots32 = [t.float() for t in cots[:8]]
    near32(ftr.trace_fwd(p32t, spec_t, ins32),
           ftr.trace_fast_plain(pk, spec_t, ins), "tilted trace_fwd f32",
           Rc // 10_000)
    near32(ftr.trace_field_fwd(p32t, a32t, spec_t, Px64.float(),
                               Py64.float()), out_f,
           "tilted trace_field_fwd f32", Rc // 10_000)
    r["trace_bwd_f32_l2"] = l2(ftr.trace_bwd(p32t, spec_t, nc_t, ins32,
                                             cots32)[1], fl5_p)
    r["trace_field_bwd_f32_l2"] = l2(ftr.trace_field_bwd(
        p32t, a32t, spec_t, nc_t, Px64.float(), Py64.float(), cots32), fl4_p)
    r["merit_bwd_f32_l2"] = l2(ft.merit_bwd(
        p32t, a32t, st_t.float(), mspec_t, nc_t, Rc, Px=Px64.float(),
        Py=Py64.float()), fm_p)
    check(max(r["trace_bwd_f32_l2"], r["trace_field_bwd_f32_l2"],
              r["merit_bwd_f32_l2"]) <= 1e-3, f"tilted f32 gradients: L2 "
          f"rel err above 1e-3: {r}")
    # the zero tilt: every surface of the stock Cooke triplet flagged as
    # tilted, at zero angles, against the untilted code, on the card
    spec_c = ftr.fast_spec(systems["f64"], field=True)
    forced = spec_c[:3] + ((True,) * S_t,) + spec_c[4:]
    pc, ac = tables(systems["f64"])
    with torch.no_grad():
        rays = raygen.generate_rays(systems["f64"], *H, Px64, Py64, WL)
    ins_c = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
    a0 = ftr.trace_bwd(pc, spec_c, nc_t, ins_c, cots[:8])
    a1 = ftr.trace_bwd(pc, forced, nc_t, ins_c, cots[:8])
    r["zero_tilt_bwd"] = flat_err(a1[1], a0[1], 1e-12,
                                  "trace_bwd, tilt flags forced on at zero")
    r["zero_tilt_din"] = arr_err(a1[0], a0[0])
    r["zero_tilt_fwd"] = arr_err(ftr.trace_fwd(pc, forced, ins_c),
                                 ftr.trace_fwd(pc, spec_c, ins_c))
    check(r["zero_tilt_din"] <= 1e-12 and r["zero_tilt_fwd"] <= 1e-12,
          f"zero tilt forced on: {r['zero_tilt_din']}, {r['zero_tilt_fwd']}"
          " > 1e-12")
    del ins_c, a0, a1, din_k, din_p
    # K8/K9 on the tilted singlet, both modes (pol_parity: f64 and f32)
    spec_s = pt.pol_spec(ts64, WL)
    check(spec_s is not None and spec_s[5][1], "phase 18: the tilted singlet "
          "is not pol_supported or not flagged")
    nc_s = ts64.stack.coeffs.shape[1]
    with torch.no_grad():
        pks = ft.build_param_table(ts64, WL).contiguous()
        rays = raygen.generate_rays(ts64, *H, Px64, Py64, WL)
    coat_s = pt.build_coat_table(ts64, WL, torch.float64, dev)
    ins_s = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
    ins_s[6] = ins[6]
    for mode, states, intensity in (("full", None, False),
                                    ("H", pt.pol_states(STATE_H), True)):
        c = cots[:8] if intensity else cots
        for key, v in pol_parity(pks, coat_s, spec_s, nc_s, ins_s, c, states,
                                 intensity, f"tilted singlet {mode}").items():
            r[f"pol_{key}_{mode}"] = v
    torch.cuda.synchronize()
    res18 = {"parity": r}
    log(f"phase 18 tilted kernels (toleranced Cooke triplet: K1-K5; tilted "
        f"singlet: K8/K9; 2^{args.check_log2} rays, f64 vs plain: per-ray "
        f"tol 1e-10, gradients tol 1e-9, zero tilt forced on vs untilted "
        f"tol 1e-12; f32 vs f64 plain: L2 tol 1e-3): " + ", ".join(
            f"{k} {v:.2e}" for k, v in r.items()))
    del ins, ins_s, cots, fl_k, fl5_p, fl4_k, fl4_p, fm_k, fm_p

    # the tilted steps at full width (f32): value+grad over every leaf
    config.set_precision("float32")
    tc32 = perturbed.toleranced_cooke().system
    ts32 = perturbed.tilted_singlet().system

    def tilted_merit_loss(system, seed):
        return ft.spot_rms_fast_field(system, *H, WL, num_rays=Rf, seed=seed)

    steps18 = {}
    for name, sysk, loss_fn, kern, seed0 in (
            ("tilted_merit", tc32, tilted_merit_loss,
             ("merit_fwd_tilt", "merit_bwd_tilt"), 6000),
            ("tilted_field", tc32, field_loss,
             ("prng_disk", "trace_field_fwd_tilt", "trace_field_bwd_tilt"),
             6100),
            ("tilted_generic", tc32, generic_loss,
             ("prng_disk", "trace_fwd_tilt", "trace_bwd_tilt"), 6200),
            ("tilted_pol", ts32, pol_loss,
             ("prng_disk", "pol_fwd_intensity_tilt",
              "pol_bwd_intensity_tilt"), 6300)):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        sl, lv = leaf_system(sysk)
        first = loss_fn(sl, seed0 - 100)
        first.backward()
        check(bool(torch.isfinite(first)), f"{name}: value not finite")
        tilted_rows = ([1] if name == "tilted_pol"
                       else list(perturbed.TOLERANCES))
        for k in ("radius", "rx", "ry", "rz", "dx", "dy"):
            gk = lv[k].grad[tilted_rows]
            check(bool(torch.isfinite(gk).all()) and bool((gk != 0).all()),
                  f"{name}: {k} gradient of the tilted surfaces not finite "
                  f"or zero: {gk.tolist()}")
        nan18 = {k: int((~torch.isfinite(v.grad)).sum())
                 for k, v in lv.items() if v.grad is not None
                 and not bool(torch.isfinite(v.grad).all())}

        def vg18(i, sysk=sysk, loss_fn=loss_fn):
            s_, _ = leaf_system(sysk)
            loss_fn(s_, i).backward()

        times18 = timed(vg18, seed0)
        got18 = counts()
        wall18 = time.perf_counter() - t0
        n18 = 1 + 3 + args.steps
        expect18 = {**dict.fromkeys(got18, 0), **dict.fromkeys(kern, n18)}
        check(got18 == expect18, f"{name} launches {got18}, expected "
              f"{expect18}")
        path_launches[name] = got18
        step18 = float(np.median(times18))
        steps18[name] = {"value": float(first.detach()), "step_ms": step18,
                         "step_ms_all": times18, "launches": got18,
                         "steps": n18, "nan_entries": nan18}
        log(f"phase 18 {name}: {n18} value+grad steps over every stack leaf "
            f"in {wall18:.1f} s, value {float(first.detach()):.9e}; median "
            f"step {step18:.3f} ms over {args.steps} steps; non-finite "
            f"gradient entries: {nan18}; launches {got18}")
    res18["steps"] = steps18
    # the three Cooke paths compute one function on the same samples
    with torch.no_grad():
        Pxc, Pyc = ft.prng_disk(78, Rf, 0, torch.float32, dev)
        v_gen = rms_spot_size(tc32, *H, Pxc, Pyc, WL) ** 2
        f = ftr.trace_fast_field(tc32, *H, Pxc, Pyc, WL)
        v_field = ((f.x - f.x.mean()) ** 2 + (f.y - f.y.mean()) ** 2).mean()
        v_merit = ft.spot_rms_fast_field(tc32, *H, WL, Px=Pxc, Py=Pyc)
        del f, Pxc, Pyc
    e18 = max(rel(v_gen, v_merit), rel(v_field, v_merit))
    check(e18 <= 1e-4, f"tilted paths disagree: generic {float(v_gen)}, "
          f"field {float(v_field)}, merit {float(v_merit)}")
    res18["paths_rel"] = e18
    # the tilted kernels (the TILT instantiations) at full width on the
    # toleranced Cooke triplet: the generic path's launch bundle and pupil
    # samples and cotangents of a mean's size, as phase 8 gives the
    # untilted ones; each held against its f32 plain version on the inputs
    # it is timed on, as phase 8 holds the untilted ones (a ray whose
    # radius falls within rounding of a decentred clip edge may be clipped
    # in one only: up to 1 in 10^4 may differ in intensity)
    spec_t32 = ftr.fast_spec(tc32, field=True)
    mspec_t32 = ft._spec_of(tc32)
    check(spec_t32[:3] == spec32[:3], "phase 18: the toleranced triplet's "
          "codes or absorption differ from the stock triplet's")
    pt32, at32 = tables(tc32)
    gen18 = torch.Generator(device=dev).manual_seed(180)
    with torch.no_grad():
        Px8, Py8 = ft.prng_disk(8, Rf, 0, torch.float32, dev)
        rays8 = raygen.generate_rays(tc32, *H, Px8, Py8, WL)
    ins8 = [getattr(rays8, k).contiguous() for k in ftr.RAY_FIELDS]
    del rays8
    cots8 = [torch.randn(Rf, generator=gen18, device=dev) / Rf
             for _ in range(8)]
    flips = Rf // 10_000
    full18 = {}
    with torch.no_grad():
        rows_t = ft.merit_fwd(pt32, at32, mspec_t32, Rf, seed=9)
        rows_p = ft.merit_fwd_plain(pt32, at32, mspec_t32, Rf, seed=9)
        kerr["merit_fwd_tilt"] = float((rows_t - rows_p).abs().max())
        lt, xbt, ybt = ft._chan_combine(rows_t, Rf)
        full18["merit_fwd_loss_rel"] = rel(lt, ft._chan_combine(rows_p,
                                                                Rf)[0])
        check(full18["merit_fwd_loss_rel"] <= 1e-4, f"tilted merit_fwd full "
              f"width: loss rel err {full18['merit_fwd_loss_rel']} > 1e-4")
        del rows_t, rows_p
        stats_t = torch.stack([xbt, ybt, torch.tensor(1.0 / Rf, device=dev),
                               torch.zeros((), device=dev)])
        fk = ft.merit_bwd(pt32, at32, stats_t, mspec_t32, nc, Rf, seed=9)
        fp = ft.merit_bwd_plain(pt32, at32, stats_t, mspec_t32, nc, Rf,
                                seed=9)
        kerr["merit_bwd_tilt"] = float((fk - fp).abs().max())
        full18["merit_bwd_l2"] = l2(fk, fp)
        del fk, fp
        k5a = ftr.trace_fwd(pt32, spec_t32, ins8)
        ref = ftr.trace_fast_plain(pt32, spec_t32, ins8)
        kerr["trace_fwd_tilt"] = max_abs(k5a, ref)
        near32(k5a, ref, "tilted trace_fwd full width", flips)
        k1 = ftr.trace_field_fwd(pt32, at32, spec_t32, Px8, Py8)
        ref = ftr.trace_fast_field_plain(pt32, at32, spec_t32, Px8, Py8)
        kerr["trace_field_fwd_tilt"] = max_abs(k1, ref)
        near32(k1, ref, "tilted trace_field_fwd full width", flips)
        del k5a, k1, ref
        din_k, flat_k = ftr.trace_bwd(pt32, spec_t32, nc, ins8, cots8)
        din_p, flat_p = ftr.trace_fast_bwd_plain(pt32, spec_t32, nc, ins8,
                                                 cots8)
        kerr["trace_bwd_tilt"] = max(float((flat_k - flat_p).abs().max()),
                                     max_abs(din_k, din_p))
        full18["trace_bwd_din"] = arr_err(din_k, din_p)
        check(full18["trace_bwd_din"] <= 1e-3, f"tilted trace_bwd full "
              f"width: input cotangents, max |d| / max |ref| "
              f"{full18['trace_bwd_din']} > 1e-3")
        full18["trace_bwd_l2"] = l2(flat_k, flat_p)
        del din_k, din_p
        flat_k = ftr.trace_field_bwd(pt32, at32, spec_t32, nc, Px8, Py8,
                                     cots8)
        flat_p = ftr.trace_fast_field_bwd_plain(pt32, at32, spec_t32, nc,
                                                Px8, Py8, cots8)
        kerr["trace_field_bwd_tilt"] = float((flat_k - flat_p).abs().max())
        full18["trace_field_bwd_l2"] = l2(flat_k, flat_p)
        del flat_k, flat_p
        for key in ("merit_bwd_l2", "trace_bwd_l2", "trace_field_bwd_l2"):
            check(full18[key] <= 1e-3, f"tilted {key} full width: gradient "
                  f"L2 rel err {full18[key]} > 1e-3")
        ms.update({
            "merit_fwd_tilt": time_ms(lambda i: ft.merit_fwd(
                pt32, at32, mspec_t32, Rf, seed=i), 10, 3),
            "merit_bwd_tilt": time_ms(lambda i: ft.merit_bwd(
                pt32, at32, stats_t, mspec_t32, nc, Rf, seed=i), 10, 3),
            "trace_fwd_tilt": time_ms(lambda i: ftr.trace_fwd(
                pt32, spec_t32, ins8), 10, 3),
            "trace_bwd_tilt": time_ms(lambda i: ftr.trace_bwd(
                pt32, spec_t32, nc, ins8, cots8), 10, 3),
            "trace_field_fwd_tilt": time_ms(lambda i: ftr.trace_field_fwd(
                pt32, at32, spec_t32, Px8, Py8), 10, 3),
            "trace_field_bwd_tilt": time_ms(lambda i: ftr.trace_field_bwd(
                pt32, at32, spec_t32, nc, Px8, Py8, cots8), 10, 3),
        })
        plain_ms.update({
            "merit_fwd_tilt": time_ms(lambda i: ft.merit_fwd_plain(
                pt32, at32, mspec_t32, Rf, seed=i), 3),
            "merit_bwd_tilt": time_ms(lambda i: ft.merit_bwd_plain(
                pt32, at32, stats_t, mspec_t32, nc, Rf, seed=i), 3),
            "trace_fwd_tilt": time_ms(lambda i: ftr.trace_fast_plain(
                pt32, spec_t32, ins8), 3),
            "trace_bwd_tilt": time_ms(lambda i: ftr.trace_fast_bwd_plain(
                pt32, spec_t32, nc, ins8, cots8), 3),
            "trace_field_fwd_tilt": time_ms(
                lambda i: ftr.trace_fast_field_plain(pt32, at32, spec_t32,
                                                     Px8, Py8), 3),
            "trace_field_bwd_tilt": time_ms(
                lambda i: ftr.trace_fast_field_bwd_plain(
                    pt32, at32, spec_t32, nc, Px8, Py8, cots8), 3),
        })
    del ins8, cots8, Px8, Py8
    # the tilted polarized kernels in intensity mode (the tilted
    # polarized step's) on the tilted singlet, as phase 15 holds the
    # untilted ones
    spec_ts, pol18 = pol_full_width(ts32, (True,), 181)
    full18.update(pol18)
    res18["full_width"] = full18
    # bounds: the untilted kernels' work plus the rotations of each tilted
    # surface
    n_tilt = sum(spec_t32[3])
    for name, extra in (("merit_fwd", OPS_TILT_FWD),
                        ("merit_bwd", OPS_TILT_FWD + OPS_TILT_ADJ),
                        ("trace_fwd", OPS_TILT_FWD),
                        ("trace_bwd", OPS_TILT_FWD + OPS_TILT_ADJ),
                        ("trace_field_fwd", OPS_TILT_FWD),
                        ("trace_field_bwd", OPS_TILT_FWD + OPS_TILT_ADJ)):
        ops, nbytes = work[name]
        work[name + "_tilt"] = (ops + Rf * n_tilt * extra, nbytes)
    _, ops_fi_t, _, ops_bi_t = pol_ops(spec_ts, n_h)
    work["pol_fwd_intensity_tilt"] = (Rf * ops_fi_t,
                                      work["pol_fwd_intensity"][1])
    work["pol_bwd_intensity_tilt"] = (Rf * ops_bi_t,
                                      work["pol_bwd_intensity"][1])
    report["phases"]["tilts"] = res18
    tilt_names = [k for k in ms if k.endswith("_tilt")]
    log(f"phase 18 tilted kernels at 2^{args.full_log2} rays (f32; "
        f"toleranced Cooke triplet, K1-K5; tilted singlet, K8/K9 intensity "
        f"mode) against the f32 plain versions: every output array within "
        f"2e-4 x max(1, max |ref|) ({flips} intensity flips allowed), "
        f"merit_fwd loss rel err (tol 1e-4), input cotangents (tol 1e-3 of "
        f"each array's largest) and gradient L2 (tol 1e-3) "
        f"{ {k: float(f'{v:.3e}') for k, v in full18.items()} }; max "
        f"|kernel - plain| "
        f"{ {k: float(f'{kerr[k]:.4g}') for k in tilt_names} }; ms { {k: round(ms[k], 4) for k in tilt_names} } (untilted, "
        f"stock triplet and bench singlet: "
        f"{ {k[:-5]: round(ms[k[:-5]], 4) for k in tilt_names} }); plain ms "
        f"{ {k: round(plain_ms[k], 2) for k in tilt_names} }; operations per "
        f"ray added per tilted surface: forward {OPS_TILT_FWD}, backward "
        f"{OPS_TILT_FWD + OPS_TILT_ADJ} ({n_tilt} tilted surfaces)")
    config.set_precision("float32")

    def launch_suffix(build):
        return BUILD_SUFFIX[build]

    def bound_ms_of(ops, nbytes):
        return max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES) * 1e3

    def trace_work(spec_k, mspec_k, nc_k, R, nets=None):
        """(operations, bytes) at R rays of the six kernels of a system's
        build (keys with its launch suffixes), counted per surface from its
        geometry code, tilt, absorption and build, as phase 8 counts the
        stock triplet's; a Newton surface counts its newton_iters + 1
        forward steps and its adjoint (OPS_NEWTON_*), a NURBS surface its
        solve on its structure in ``nets`` (nurbs_ops)."""
        nets = nets or (None,) * len(spec_k[0])
        codes, absorbs, tilted = spec_k[0], spec_k[2], spec_k[3]
        niters, grat = spec_k[-1], ftr._grat(spec_k)
        build = ftr._build(spec_k)
        suf = launch_suffix(build)
        msuf = launch_suffix(ft._build(mspec_k))
        S_k = len(codes)
        n_sag = len(launch_build.sag_surfaces(codes, build, grat))
        ncb = launch_build.block_width(nc_k, build)

        def fwd(c, g, net):
            return geo_ops(c, nc_k, niters, g, net)[0]

        def bwd(c, g, net):
            if c in NEWTON_CODES or c == 12:
                return sum(geo_ops(c, nc_k, niters, net=net))
            base = OPS_BWD_STANDARD if c == 1 else OPS_BWD_PLANE
            # a grating: its forward and adjoint for the refraction's
            return base + ((OPS_GRAT_FWD[c] + OPS_GRAT_ADJ[c]
                            - sum(OPS_REFRACT)) if g else 0)

        geo_f = sum(fwd(c, g, n) + OPS_TILT_FWD * t for c, t, g, n in zip(
            codes[1:], tilted[1:], grat[1:], nets[1:]))
        geo_b = sum(bwd(c, g, n) + (OPS_TILT_FWD + OPS_TILT_ADJ) * t
                    for c, t, g, n in zip(codes[1:], tilted[1:], grat[1:],
                                          nets[1:]))
        ann = OPS_ANNULAR if build & launch_build.BIT_SAG else 0
        full_f = geo_f + (S_k - 1) * (OPS_FULL_FWD + ann) + OPS_ABS_FWD * sum(
            absorbs[1:])
        full_b = geo_b + (S_k - 1) * (OPS_FULL_BWD + 2 * ann) \
            + OPS_ABS_BWD * sum(absorbs[1:])
        nb_f = -(-R // ft.FWD_BLOCK)
        nb_b = min(-(-R // ft.BWD_BLOCK), ft.BWD_MAX_BLOCKS)
        ncomp_m = S_k * len(ft.GRAD_COLS) + n_sag * ncb + ft.N_AIM
        ncomp_f = S_k * len(ftr.FULL_GRAD_COLS) + n_sag * ncb
        tb = (S_k * ft.NUM_P + ft.N_AIM + 2 * S_k + S_k * nc_k) * 4
        ob = (S_k * (ft.NUM_P + nc_k) + ft.N_AIM) * 4
        return {
            "merit_fwd" + msuf: (R * (OPS_PRNG + OPS_LAUNCH + geo_f
                                      + OPS_STATS), tb + nb_f * 5 * 4),
            "merit_bwd" + msuf: (R * (OPS_PRNG + OPS_LAUNCH + OPS_SEED
                                      + OPS_AIM_BWD + geo_b),
                                 tb + 16 + 2 * nb_b * ncomp_m * 4 + ob),
            "trace_fwd" + suf: (R * full_f, tb + R * 16 * 4),
            "trace_bwd" + suf: (R * full_b, tb + R * 24 * 4
                                + 2 * nb_b * ncomp_f * 4 + ob),
            "trace_field_fwd" + suf: (R * (OPS_LAUNCH + full_f),
                                      tb + R * 10 * 4),
            "trace_field_bwd" + suf: (R * (OPS_LAUNCH + OPS_AIM_BWD + full_b),
                                      tb + R * 10 * 4 + 2 * nb_b
                                      * (ncomp_f + ft.N_AIM) * 4 + ob),
        }

    # ---- phase 19: K6a, K6b and the deep build at check size ----
    # the sag build (EVEN/ODD_ASPHERE, the annular clip) and the deep build
    # (more than 16 surfaces) of every trace kernel against its plain
    # version, f64, and f32 against the f64 plain versions; each system's
    # pupil includes the on-axis chief ray, which lands exactly on the
    # vertex of an on-axis asphere (the odd family's zero slope there)
    config.set_precision("float64")
    K6 = {
        "asphere": (AsphericSinglet, (0.0, 0.0)),
        "tilted_asphere": (perturbed.tilted_asphere, (0.0, 0.0)),
        "odd_asphere": (perturbed.odd_asphere, (0.0, 0.0)),
        "hubble": (lambda: registry.build_sample("HubbleTelescope"),
                   (0.0, 1.0)),
        "objective26": (lambda: registry.build_sample("ObjectiveUS008879901"),
                        (0.0, 0.7)),
    }
    g19 = torch.Generator(device=dev).manual_seed(19)
    Px19, Py19 = Px64.clone(), Py64.clone()
    Px19[0] = Py19[0] = 0.0

    def k6_inputs(system, field, Px, Py, gen, n_cots=8):
        """Param table, aim vector, coefficient table, launch bundle (random
        intensities and paths) and output cotangents of a K6 system."""
        wl_k = float(system.wavelengths[system.cfg.primary_index])
        R_k = Px.shape[0]
        dt_k = Px.dtype
        with torch.no_grad():
            pk_ = ft.build_param_table(system, wl_k).contiguous()
            ak_ = ft.aim_vector(system, *field).contiguous()
            rays_ = raygen.generate_rays(system, *field, Px, Py, wl_k)
        ins_ = [getattr(rays_, k).contiguous() for k in ftr.RAY_FIELDS]
        ins_[6] = 0.5 + 0.5 * torch.rand(R_k, generator=gen, device=dev,
                                         dtype=dt_k)
        ins_[7] = torch.rand(R_k, generator=gen, device=dev, dtype=dt_k)
        cots_ = [torch.randn(R_k, generator=gen, device=dev, dtype=dt_k)
                 / (R_k if dt_k == torch.float32 else 1)
                 for _ in range(n_cots)]
        return (wl_k, pk_, ak_, system.stack.coeffs.contiguous(), ins_,
                cots_)

    def fwd_err(a, b, what, metre):
        """arr_err of a trace's 8 arrays; at the metre scale (``metre``)
        the positions and OPD (arrays 0-2, 7) are held to 2e-8 mm absolute
        instead, the rounding of metre-long paths."""
        if not metre:
            return arr_err(a, b)
        pos = max(float((a[j] - b[j]).abs().max()) for j in (0, 1, 2, 7))
        check(pos <= 2e-8, f"{what}: positions or OPD off by {pos} mm > "
              "2e-8 mm")
        return arr_err([a[j] for j in (3, 4, 5, 6)],
                       [b[j] for j in (3, 4, 5, 6)])

    res19 = {}
    for kname, (builder, field) in K6.items():
        sysk = builder().system
        spec_k = ftr.fast_spec(sysk, field=True)
        mspec_k = ft._spec_of(sysk)
        check(spec_k is not None, f"phase 19: {kname} is not covered")
        S_k = len(spec_k[0])
        _, pk, ak, ck, ins, cots = k6_inputs(sysk, field, Px19, Py19, g19)
        nck = ck.shape[1]
        r = {}
        out_k = ftr.trace_fwd(pk, spec_k, ins, ck)
        metre = kname == "hubble"
        r["trace_fwd"] = fwd_err(out_k, ftr.trace_fast_plain(
            pk, spec_k, ins, ck), f"{kname} trace_fwd", metre)
        din_k, fl_k = ftr.trace_bwd(pk, spec_k, nck, ins, cots, ck)
        din_p, fl_p = ftr.trace_fast_bwd_plain(pk, spec_k, nck, ins, cots, ck)
        # gradients at the metre scale: floor 1e-8 of the largest entry
        floor = 1e-8 if metre else 1e-12
        r["trace_bwd"] = flat_err(fl_k, fl_p, 1e-9, f"{kname} trace_bwd",
                                  floor)
        r["trace_bwd_din"] = arr_err(din_k, din_p, 1e-6)
        # the coefficient gradient, column by column
        dco_k = fl_k[S_k * ft.NUM_P:].reshape(S_k, nck)
        dco_p = fl_p[S_k * ft.NUM_P:].reshape(S_k, nck)
        sag_rows = [s for s, c in enumerate(spec_k[0]) if c in (2, 3)]
        r["dcoeffs_cols"] = [
            float((dco_k[sag_rows, j] - dco_p[sag_rows, j]).abs().max()
                  / dco_p[sag_rows, j].abs().max()) for j in range(nck)
        ] if sag_rows else []
        check(all(e <= 1e-9 for e in r["dcoeffs_cols"]) and (
            not sag_rows or bool((dco_p[sag_rows] != 0).all())),
            f"{kname}: dcoeffs columns {r['dcoeffs_cols']}")
        check(bool((dco_k[[s for s in range(S_k) if s not in sag_rows]]
                    == 0).all()), f"{kname}: dcoeffs of a surface that is "
              "no asphere")
        out_f = ftr.trace_field_fwd(pk, ak, spec_k, Px19, Py19, ck)
        r["trace_field_fwd"] = fwd_err(out_f, ftr.trace_fast_field_plain(
            pk, ak, spec_k, Px19, Py19, ck), f"{kname} trace_field_fwd",
            metre)
        fl4_k = ftr.trace_field_bwd(pk, ak, spec_k, nck, Px19, Py19, cots, ck)
        fl4_p = ftr.trace_fast_field_bwd_plain(pk, ak, spec_k, nck, Px19,
                                               Py19, cots, ck)
        r["trace_field_bwd"] = flat_err(fl4_k, fl4_p, 1e-9,
                                        f"{kname} trace_field_bwd", floor)
        rows_k = ft.merit_fwd(pk, ak, mspec_k, Rc, Px=Px19, Py=Py19,
                              coeffs=ck)
        rows_p = ft.merit_fwd_plain(pk, ak, mspec_k, Rc, Px=Px19, Py=Py19,
                                    coeffs=ck)
        lk, xbk, ybk = ft._chan_combine(rows_k, Rc)
        r["merit_fwd"] = rel(lk, ft._chan_combine(rows_p, Rc)[0])
        st_k = torch.stack([xbk, ybk, torch.tensor(1.0 / Rc, device=dev,
                                                   dtype=torch.float64),
                            torch.zeros((), device=dev, dtype=torch.float64)])
        fm_k = ft.merit_bwd(pk, ak, st_k, mspec_k, nck, Rc, Px=Px19, Py=Py19,
                            coeffs=ck)
        fm_p = ft.merit_bwd_plain(pk, ak, st_k, mspec_k, nck, Rc, Px=Px19,
                                  Py=Py19, coeffs=ck)
        r["merit_bwd"] = flat_err(fm_k, fm_p, 1e-9, f"{kname} merit_bwd",
                                  floor)
        for key in ("trace_fwd", "trace_bwd_din", "trace_field_fwd"):
            # input cotangents at the metre scale: 1e-9 (the rounding of
            # metre-long paths)
            tol = 1e-9 if metre and key == "trace_bwd_din" else 1e-10
            check(r[key] <= tol, f"{kname} {key} f64: rel err {r[key]} > "
                  f"{tol}")
        tol = 1e-10 if metre else 1e-12  # metre-scale rounding
        check(r["merit_fwd"] <= tol, f"{kname} merit_fwd f64: loss rel "
              f"err {r['merit_fwd']} > {tol}")
        if kname == "hubble":
            r["clipped"] = int((out_f[6] == 0).sum())
            r["clipped_by_annulus"] = int(
                ((out_f[6] == 0) & (Px19.square() + Py19.square()
                                    < 0.25)).sum())
            check(0 < r["clipped_by_annulus"] and r["clipped"] < Rc,
                  f"hubble: the obscuration clips {r['clipped']} rays")
        # f32 kernels against the f64 plain versions
        p32k, a32k, c32k = pk.float(), ak.float(), ck.float()
        ins32 = [t.float() for t in ins]
        cots32 = [t.float() for t in cots]
        near32(ftr.trace_fwd(p32k, spec_k, ins32, c32k),
               ftr.trace_fast_plain(pk, spec_k, ins, ck),
               f"{kname} trace_fwd f32", Rc // 10_000, metre)
        near32(ftr.trace_field_fwd(p32k, a32k, spec_k, Px19.float(),
                                   Py19.float(), c32k), out_f,
               f"{kname} trace_field_fwd f32", Rc // 10_000, metre)
        r["trace_bwd_f32_l2"] = l2(ftr.trace_bwd(p32k, spec_k, nck, ins32,
                                                 cots32, c32k)[1], fl_p)
        r["trace_field_bwd_f32_l2"] = l2(ftr.trace_field_bwd(
            p32k, a32k, spec_k, nck, Px19.float(), Py19.float(), cots32,
            c32k), fl4_p)
        r["merit_bwd_f32_l2"] = l2(ft.merit_bwd(
            p32k, a32k, st_k.float(), mspec_k, nck, Rc, Px=Px19.float(),
            Py=Py19.float(), coeffs=c32k), fm_p)
        # at the metre scale the merit gradient's per-ray terms
        # 2 (y - ybar) dy/dtheta cancel below f32's resolution of the
        # ~150 mm image coordinates: its f32-vs-f64 error measures that
        # cancellation, not the kernel (held to f64 above), and is recorded
        # only
        f32_keys = ["trace_bwd_f32_l2", "trace_field_bwd_f32_l2"] + (
            [] if metre else ["merit_bwd_f32_l2"])
        check(max(r[k] for k in f32_keys) <= 1e-3, f"{kname} f32 "
              f"gradients: L2 rel err above 1e-3: {r}")
        torch.cuda.synchronize()
        res19[kname] = r
        log(f"phase 19 {kname} ({S_k} surfaces, codes {spec_k[0]}, build "
            f"{BUILD_SUFFIX[ftr._build(spec_k)][1:] or 'stock'}"
            "; "
            f"2^{args.check_log2} rays, f64 vs plain: per-ray tol 1e-10, "
            f"gradients tol 1e-9; f32 vs f64 plain: L2 tol 1e-3): "
            + ", ".join(f"{k} {v:.2e}" if isinstance(v, float)
                        else f"{k} {v}" for k, v in r.items()))
        del ins, cots, din_k, din_p, fl_k, fl_p
    # the poly mode on the tilted asphere, wavelengths cycling by ray
    sys_q = perturbed.tilted_asphere().system
    spec_q6 = ftr.poly_spec(sys_q)
    _, _, _, cq, ins, cots = k6_inputs(sys_q, (0.0, 0.0), Px19, Py19, g19)
    pq = ftr.build_poly_table(sys_q).contiguous()
    mq = sys_q.stack.mat_coeffs.contiguous()
    ins9 = ins + [cycled(Rc, torch.float64)]
    r = {"trace_fwd_poly": arr_err(
        ftr.trace_fwd_poly(pq, mq, spec_q6, ins9, cq),
        ftr.trace_fwd_poly_plain(pq, mq, spec_q6, ins9, cq))}
    din_k, fl_k = ftr.trace_bwd_poly(pq, mq, spec_q6, cq.shape[1], ins9,
                                     cots, cq)
    din_p, fl_p = ftr.trace_bwd_poly_plain(pq, mq, spec_q6, cq.shape[1],
                                           ins9, cots, cq)
    r["trace_bwd_poly"] = flat_err(fl_k, fl_p, 1e-9, "asphere trace_bwd_poly")
    r["trace_bwd_poly_din"] = arr_err(din_k, din_p, 1e-6)
    r["trace_bwd_poly_f32_l2"] = l2(ftr.trace_bwd_poly(
        pq.float(), mq.float(), spec_q6, cq.shape[1],
        [t.float() for t in ins9], [t.float() for t in cots],
        cq.float())[1], fl_p)
    check(r["trace_fwd_poly"] <= 1e-10 and r["trace_bwd_poly_din"] <= 1e-10
          and r["trace_bwd_poly_f32_l2"] <= 1e-3, f"asphere poly: {r}")
    res19["tilted_asphere_poly"] = r
    # K8, K9 on the Fresnel-coated asphere in H, both modes
    sys_c = perturbed.coated_asphere("H").system
    wl_c, pkc, _, cc, ins, cots = k6_inputs(sys_c, (0.0, 0.0), Px19, Py19,
                                            g19, pt.N_POL)
    spec_pc = pt.pol_spec(sys_c, wl_c)
    check(spec_pc is not None, "phase 19: the coated asphere is not "
          "pol_supported")
    coat_c = pt.build_coat_table(sys_c, wl_c, torch.float64, dev)
    for mode, states, intensity in (("full", None, False),
                                    ("H", pt.pol_states(STATE_H), True)):
        c = cots[:8] if intensity else cots
        for key, v in pol_parity(pkc, coat_c, spec_pc, cc.shape[1], ins, c,
                                 states, intensity, f"coated asphere {mode}",
                                 coeffs=cc).items():
            r[f"pol_{key}_{mode}"] = v
    res19["coated_asphere"] = {k: v for k, v in r.items()
                               if k.startswith("pol_")}
    torch.cuda.synchronize()
    log("phase 19 poly mode (tilted asphere) and K8/K9 (coated asphere, H): "
        + ", ".join(f"{k} {v:.2e}" for k, v in r.items()))
    report["phases"]["k6_parity"] = res19
    del ins, cots, ins9, din_k, din_p, fl_k, fl_p

    # ---- phase 20: the K6 systems' steps at full width (f32) ----
    # the merit, field and generic value+grad steps of tilted_asphere,
    # HubbleTelescope (Hy = 1) and ObjectiveUS008879901 (Hy = 0.7), every
    # stack leaf
    config.set_precision("float32")
    steps20 = {}
    full20 = {}
    k6_sys32 = {}
    for kname in ("tilted_asphere", "hubble", "objective26"):
        builder, field = K6[kname]
        sys32 = builder().system
        k6_sys32[kname] = sys32
        wl_k = float(sys32.wavelengths[sys32.cfg.primary_index])
        spec_k = ftr.fast_spec(sys32, field=True)
        suf = launch_suffix(ftr._build(spec_k))
        msuf = launch_suffix(ft._build(ft._spec_of(sys32)))

        def merit20(system, seed, field=field, wl_k=wl_k):
            return ft.spot_rms_fast_field(system, *field, wl_k, num_rays=Rf,
                                          seed=seed)

        def field20(system, seed, field=field, wl_k=wl_k):
            Px, Py = ft.prng_disk(seed, Rf, 0, torch.float32, dev)
            f = ftr.trace_fast_field(system, *field, Px, Py, wl_k)
            return ((f.x - f.x.mean()) ** 2 + (f.y - f.y.mean()) ** 2).mean()

        def generic20(system, seed, field=field, wl_k=wl_k):
            Px, Py = ft.prng_disk(seed, Rf, 0, torch.float32, dev)
            return rms_spot_size(system, *field, Px, Py, wl_k)

        for pname, loss_fn, kern, seed0 in (
                ("merit", merit20, ("merit_fwd" + msuf, "merit_bwd" + msuf),
                 7000),
                ("field", field20, ("prng_disk", "trace_field_fwd" + suf,
                                    "trace_field_bwd" + suf), 7100),
                ("generic", generic20, ("prng_disk", "trace_fwd" + suf,
                                        "trace_bwd" + suf), 7200)):
            name = f"{kname}_{pname}"
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            sl, lv = leaf_system(sys32)
            first = loss_fn(sl, seed0 - 100)
            first.backward()
            check(bool(torch.isfinite(first)), f"{name}: value not finite")
            check(bool(torch.isfinite(lv["radius"].grad[1:-1]).all()),
                  f"{name}: radius gradient not finite")
            if kname == "tilted_asphere":
                gc1 = lv["coeffs"].grad[1]
                check(bool(torch.isfinite(gc1).all() and (gc1 != 0).all()),
                      f"{name}: coefficient gradient {gc1.tolist()}")

            def vg20(i, sysk=sys32, loss_fn=loss_fn):
                s_, _ = leaf_system(sysk)
                loss_fn(s_, i).backward()

            times20 = timed(vg20, seed0)
            got20 = counts()
            wall20 = time.perf_counter() - t0
            n20 = 1 + 3 + args.steps
            expect20 = {**dict.fromkeys(got20, 0),
                        **dict.fromkeys(kern, n20)}
            check(got20 == expect20, f"{name} launches {got20}, expected "
                  f"{expect20}")
            path_launches[name] = got20
            step20 = float(np.median(times20))
            steps20[name] = {"value": float(first.detach()),
                             "step_ms": step20, "step_ms_all": times20,
                             "launches": {k: v for k, v in got20.items()
                                          if v},
                             "steps": n20}
            log(f"phase 20 {name}: {n20} value+grad steps over every stack "
                f"leaf in {wall20:.1f} s, value {float(first.detach()):.9e};"
                f" median step {step20:.3f} ms over {args.steps} steps; "
                f"launches { {k: v for k, v in got20.items() if v} }")
        # the three paths compute one function on the same samples; at the
        # metre scale the f32 image coordinates (~150 mm) resolve the
        # ~0.03 mm spot to ~1e-3 only, so HubbleTelescope's paths are held
        # to each other in f64 (its f32 spread is recorded)

        def paths_rel(system, dt):
            with torch.no_grad():
                Pxc, Pyc = ft.prng_disk(79, Rf, 0, dt, dev)
                v_gen = rms_spot_size(system, *field, Pxc, Pyc, wl_k) ** 2
                f = ftr.trace_fast_field(system, *field, Pxc, Pyc, wl_k)
                v_field = ((f.x - f.x.mean()) ** 2
                           + (f.y - f.y.mean()) ** 2).mean()
                v_merit = ft.spot_rms_fast_field(system, *field, wl_k,
                                                 Px=Pxc, Py=Pyc)
            return (max(rel(v_gen, v_merit), rel(v_field, v_merit)),
                    (float(v_gen), float(v_field), float(v_merit)))

        e20, vals = paths_rel(sys32, torch.float32)
        if kname == "hubble":
            full20["hubble_paths_rel_f32"] = e20
            config.set_precision("float64")
            e20, vals = paths_rel(builder().system, torch.float64)
            config.set_precision("float32")
        check(e20 <= 1e-4, f"{kname} paths disagree: generic, field, merit "
              f"{vals}")
        full20[f"{kname}_paths_rel"] = e20
    report["phases"]["k6_steps"] = steps20

    # the sag build (tilted asphere) and the deep build (ObjectiveUS008879901)
    # of each kernel at full width, on the generic path's launch bundle and
    # cotangents of a mean's size: held against the f32 plain versions on
    # the launches they are timed on, timed, with their bounds
    def kernels_full_width(sys32, field, suf, gen, full, tag="", chunk=None):
        """The merit and trace kernels of ``sys32``'s build (launch suffix
        ``suf``) at full width, on the generic path's launch bundle and
        cotangents of a mean's size: each full-width launch held against
        the f32 plain versions chunk by chunk (errors into ``full`` and
        kerr), timed (ms, plain_ms), with their bounds (work), under each
        kernel's launch key and ``tag``. The plain versions run over the
        full width in chunks of ``chunk`` rays (None: one chunk; the NURBS
        build's plain versions at full width would not fit): the per-ray
        outputs are compared chunk by chunk and the gradients summed over
        the chunks. The comparison's run is the warm-up of the plain
        versions' timing (one timed run where chunked, else two)."""
        spec_k = ftr.fast_spec(sys32, field=True)
        mspec_k = ft._spec_of(sys32)
        check(launch_suffix(ftr._build(spec_k)) == suf,
              f"{suf}: build {ftr._build(spec_k)}")
        with torch.no_grad():
            Px8, Py8 = ft.prng_disk(8, Rf, 0, torch.float32, dev)
        _, pk, ak, _, ins8, cots8 = k6_inputs(sys32, field, Px8, Py8, gen)
        ck, lk = launch_build.kernel_tables(sys32, torch.float32)
        nck = ck.shape[1]
        spans = chunk_spans(chunk)
        Rk = spans[0][1]
        reps = 1 if chunk else 2
        mname = "merit_fwd" + launch_suffix(ft._build(mspec_k)) + tag
        bname = "merit_bwd" + launch_suffix(ft._build(mspec_k)) + tag
        suf = suf + tag
        stats_t = None
        # each kernel's plain version over the spans (fn(i): seed i)
        plain = {
            mname: lambda i: [ft.merit_fwd_plain(
                pk, ak, mspec_k, Rk, seed=i, offset=a, coeffs=ck, lay=lk)
                for a, b in spans],
            bname: lambda i: [ft.merit_bwd_plain(
                pk, ak, stats_t, mspec_k, nck, Rk, seed=i, offset=a,
                coeffs=ck, lay=lk) for a, b in spans],
            "trace_fwd" + suf: lambda i: [ftr.trace_fast_plain(
                pk, spec_k, [t[a:b] for t in ins8], ck, lk)
                for a, b in spans],
            "trace_bwd" + suf: lambda i: [ftr.trace_fast_bwd_plain(
                pk, spec_k, nck, [t[a:b] for t in ins8],
                [t[a:b] for t in cots8], ck, lk) for a, b in spans],
            "trace_field_fwd" + suf: lambda i: [ftr.trace_fast_field_plain(
                pk, ak, spec_k, Px8[a:b], Py8[a:b], ck, lk)
                for a, b in spans],
            "trace_field_bwd" + suf: lambda i: [
                ftr.trace_fast_field_bwd_plain(
                    pk, ak, spec_k, nck, Px8[a:b], Py8[a:b],
                    [t[a:b] for t in cots8], ck, lk) for a, b in spans],
        }
        with torch.no_grad():
            rows_t = ft.merit_fwd(pk, ak, mspec_k, Rf, seed=9, coeffs=ck,
                                  lay=lk)
            rows_p = torch.cat(plain[mname](9))
            kerr[mname] = float((rows_t - rows_p).abs().max())
            lt, xbt, ybt = ft._chan_combine(rows_t, Rf)
            full[f"{mname}_loss_rel"] = rel(lt, ft._chan_combine(
                rows_p, Rf)[0])
            check(full[f"{mname}_loss_rel"] <= 1e-4, f"{mname} full width:"
                  f" loss rel err {full[f'{mname}_loss_rel']} > 1e-4")
            del rows_t, rows_p
            stats_t = torch.stack([xbt, ybt, torch.tensor(1.0 / Rf,
                                                          device=dev),
                                   torch.zeros((), device=dev)])
            fk = ft.merit_bwd(pk, ak, stats_t, mspec_k, nck, Rf, seed=9,
                              coeffs=ck, lay=lk)
            fp = sum(plain[bname](9))
            kerr[bname] = float((fk - fp).abs().max())
            full[f"{bname}_l2"] = l2(fk, fp)
            del fk, fp
            k5a = ftr.trace_fwd(pk, spec_k, ins8, ck, lk)
            kerr["trace_fwd" + suf] = chunked_fwd(
                k5a, plain["trace_fwd" + suf](0), spans,
                f"trace_fwd{suf} full width")
            del k5a
            k1 = ftr.trace_field_fwd(pk, ak, spec_k, Px8, Py8, ck, lk)
            kerr["trace_field_fwd" + suf] = chunked_fwd(
                k1, plain["trace_field_fwd" + suf](0), spans,
                f"trace_field_fwd{suf} full width")
            del k1
            din_k, flat_k = ftr.trace_bwd(pk, spec_k, nck, ins8, cots8, ck,
                                          lk)
            din_e, din_abs, flat_p = chunked_bwd(
                din_k, plain["trace_bwd" + suf](0), spans)
            kerr["trace_bwd" + suf] = max(float((flat_k - flat_p).abs().max()),
                                          din_abs)
            full[f"trace_bwd{suf}_din"] = din_e
            check(din_e <= 1e-3, f"trace_bwd{suf} full width: input "
                  f"cotangents, max |d| / max |ref| {din_e} > 1e-3")
            full[f"trace_bwd{suf}_l2"] = l2(flat_k, flat_p)
            del din_k, flat_k, flat_p
            flat_k = ftr.trace_field_bwd(pk, ak, spec_k, nck, Px8, Py8,
                                         cots8, ck, lk)
            flat_p = sum(plain["trace_field_bwd" + suf](0))
            kerr["trace_field_bwd" + suf] = float(
                (flat_k - flat_p).abs().max())
            full[f"trace_field_bwd{suf}_l2"] = l2(flat_k, flat_p)
            del flat_k, flat_p
            for key in (f"{bname}_l2", f"trace_bwd{suf}_l2",
                        f"trace_field_bwd{suf}_l2"):
                check(full[key] <= 1e-3, f"{key} full width: gradient L2 "
                      f"rel err {full[key]} > 1e-3")
            ms.update({
                mname: time_ms(lambda i: ft.merit_fwd(
                    pk, ak, mspec_k, Rf, seed=i, coeffs=ck, lay=lk), 10, 3),
                bname: time_ms(lambda i: ft.merit_bwd(
                    pk, ak, stats_t, mspec_k, nck, Rf, seed=i, coeffs=ck,
                    lay=lk), 10, 3),
                "trace_fwd" + suf: time_ms(lambda i: ftr.trace_fwd(
                    pk, spec_k, ins8, ck, lk), 10, 3),
                "trace_bwd" + suf: time_ms(lambda i: ftr.trace_bwd(
                    pk, spec_k, nck, ins8, cots8, ck, lk), 10, 3),
                "trace_field_fwd" + suf: time_ms(
                    lambda i: ftr.trace_field_fwd(pk, ak, spec_k, Px8, Py8,
                                                  ck, lk), 10, 3),
                "trace_field_bwd" + suf: time_ms(
                    lambda i: ftr.trace_field_bwd(pk, ak, spec_k, nck, Px8,
                                                  Py8, cots8, ck, lk), 10, 3),
            })
            plain_ms.update({k: time_ms(fn, reps, warm=True)
                             for k, fn in plain.items()})
        work.update({k + tag: v for k, v in
                     trace_work(spec_k, mspec_k, nck, Rf,
                                sys32.cfg.geom_aux).items()})
        del ins8, cots8, Px8, Py8, plain
        torch.cuda.synchronize()

    def poly_pol_full_width(sys_q, sys_c, suf, field, gen, names, steps,
                            seed, pol_seed, full, tag="", chunk=None):
        """The poly mode and the polarized kernels (intensity mode) of build
        ``suf``: bench's poly step on ``sys_q`` (None: none) and its
        polarized step on ``sys_c``, three counted value+grad steps each
        over every leaf (``names``: their keys in path_launches and
        ``steps``); then the kernels at full width, with the coefficient
        and layout tables of launch.kernel_tables, against their f32 plain
        versions (errors into ``full`` and kerr), timed, with their bounds,
        under each kernel's launch key and ``tag``. A tagged (aux-bearing)
        system's step needs a nonzero coefficient gradient somewhere (a
        Forbes slot past its surface's terms gets none), the others
        everywhere."""
        runs = [(names[1], sys_c, pol_loss,
                 ("prng_disk", "pol_fwd_intensity" + suf,
                  "pol_bwd_intensity" + suf))]
        if sys_q is not None:
            runs.insert(0, (names[0], sys_q, poly_loss,
                            ("prng_disk", "trace_fwd_poly" + suf,
                             "trace_bwd_poly" + suf)))
        for name, sysk, loss_fn, kern in runs:
            torch.cuda.synchronize()
            reset_counts()
            for i in range(3):
                s_, lv_ = leaf_system(sysk)
                v_ = loss_fn(s_, seed + i)
                v_.backward()
                gc1 = lv_["coeffs"].grad[1]
                nz = (gc1 != 0).any() if tag else (gc1 != 0).all()
                check(bool(torch.isfinite(v_))
                      and bool(torch.isfinite(gc1).all()) and bool(nz),
                      f"{name}: value {float(v_)} or coefficient gradient "
                      f"{gc1.tolist()}")
            got = counts()
            expect = {**dict.fromkeys(got, 0), **dict.fromkeys(kern, 3)}
            check(got == expect, f"{name} launches {got}, expected {expect}")
            path_launches[name] = got
            steps[name] = {"value": float(v_.detach()),
                           "launches": {k: v for k, v in got.items() if v}}
        if sys_q is not None:
            poly_full_width(sys_q, suf, field, gen, full, tag, chunk)
        spec_c, pol_errs = pol_full_width(sys_c, (True,), pol_seed, tag)
        full.update(pol_errs)
        with torch.no_grad():
            nc_c = launch_build.kernel_tables(sys_c, torch.float32)[0].shape[1]
        _, ops_fi, _, ops_bi = pol_ops(spec_c, n_h, nc_c,
                                       sys_c.cfg.geom_aux)
        work["pol_fwd_intensity" + suf + tag] = (
            Rf * ops_fi, work["pol_fwd_intensity"][1])
        work["pol_bwd_intensity" + suf + tag] = (
            Rf * ops_bi, work["pol_bwd_intensity"][1])

    def poly_full_width(sys_q, suf, field, gen, full, tag="", chunk=None):
        """The poly mode's kernels of build ``suf`` at full width on
        ``sys_q`` against their f32 plain versions chunk by chunk, timed,
        with their bounds (poly_pol_full_width); ``chunk`` as
        kernels_full_width's."""
        spec_q = ftr.poly_spec(sys_q)
        fname = "trace_fwd_poly" + suf + tag
        bname = "trace_bwd_poly" + suf + tag
        spans = chunk_spans(chunk)
        reps = 1 if chunk else 2
        with torch.no_grad():
            pq = ftr.build_poly_table(sys_q).contiguous()
            Pxq, Pyq = ft.prng_disk(17, Rf, 0, torch.float32, dev)
            rays = raygen.generate_rays(sys_q, *field, Pxq, Pyq, WL)
            mq = sys_q.stack.mat_coeffs.contiguous()
            cq, lq = launch_build.kernel_tables(sys_q, torch.float32)
            ncq = cq.shape[1]
            ins_q = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
            ins_q.append(cycled(Rf, torch.float32))
            del rays, Pxq, Pyq
            cots_q = [torch.randn(Rf, generator=gen, device=dev) / Rf
                      for _ in range(8)]

            # the plain versions over the spans
            def fwd_plain(i):
                return [ftr.trace_fwd_poly_plain(
                    pq, mq, spec_q, [t[a:b] for t in ins_q], cq, lq)
                    for a, b in spans]

            def bwd_plain(i):
                return [ftr.trace_bwd_poly_plain(
                    pq, mq, spec_q, ncq, [t[a:b] for t in ins_q],
                    [t[a:b] for t in cots_q], cq, lq) for a, b in spans]

            k5a = ftr.trace_fwd_poly(pq, mq, spec_q, ins_q, cq, lq)
            kerr[fname] = chunked_fwd(k5a, fwd_plain(0), spans,
                                      f"{fname} full width", 0.0)
            del k5a
            din_k, flat_k = ftr.trace_bwd_poly(pq, mq, spec_q, ncq, ins_q,
                                               cots_q, cq, lq)
            din_e, din_abs, flat_p = chunked_bwd(din_k, bwd_plain(0), spans)
            kerr[bname] = max(float((flat_k - flat_p).abs().max()), din_abs)
            full[f"{bname}_din"] = din_e
            full[f"{bname}_l2"] = l2(flat_k, flat_p)
            check(full[f"{bname}_din"] <= 1e-3 and full[f"{bname}_l2"] <= 1e-3,
                  f"{bname} full width: {full}")
            del din_k, flat_k, flat_p
            ms[fname] = time_ms(lambda i: ftr.trace_fwd_poly(
                pq, mq, spec_q, ins_q, cq, lq), 10, 3)
            ms[bname] = time_ms(lambda i: ftr.trace_bwd_poly(
                pq, mq, spec_q, ncq, ins_q, cots_q, cq, lq), 10, 3)
            plain_ms[fname] = time_ms(fwd_plain, reps, warm=True)
            plain_ms[bname] = time_ms(bwd_plain, reps, warm=True)
        del ins_q, cots_q
        # the formulas' operations as phase 17 counts them, over the build's
        # geometry (no absorption in the poly mode)
        nm = mq.shape[1]
        S_q = len(spec_q[0])
        evals = [0] + [s_ for s_ in range(1, S_q) if not spec_q[1][s_]]
        f_f = sum(formula_ops(spec_q[4][s_], nm)[0] for s_ in evals)
        f_b = f_f + sum(formula_ops(spec_q[4][s_], nm)[1] for s_ in evals)
        tw = trace_work(spec_q, ft._spec_of(sys_q), ncq, Rf,
                        sys_q.cfg.geom_aux)
        n_abs = sum(spec_q[2][1:])
        work[fname] = (tw["trace_fwd" + suf][0] + Rf * (f_f - n_abs
                                                        * OPS_ABS_FWD),
                       tw["trace_fwd" + suf][1] + S_q * nm * 4 + Rf * 4)
        work[bname] = (tw["trace_bwd" + suf][0] + Rf * (f_b - n_abs
                                                        * OPS_ABS_BWD),
                       tw["trace_bwd" + suf][1] + 2 * S_q * nm * 4 + Rf * 4)

    gen20 = torch.Generator(device=dev).manual_seed(200)
    for kname, suf in (("tilted_asphere", "_sag"), ("objective26", "_deep")):
        kernels_full_width(k6_sys32[kname], K6[kname][1], suf, gen20, full20)
    # the sag builds of the poly mode and of the polarized kernels: bench's
    # poly step on the tilted asphere and its polarized step on the
    # Fresnel-coated asphere
    poly_pol_full_width(k6_sys32["tilted_asphere"],
                        perturbed.coated_asphere("H").system, "_sag", H,
                        gen20, ("tilted_asphere_poly", "coated_asphere_pol"),
                        steps20, 7300, 201, full20)
    report["phases"]["k6_full_width"] = full20
    k6_names = [n + s for s in ("_sag", "_deep")
                for n in ("merit_fwd", "merit_bwd", "trace_fwd", "trace_bwd",
                          "trace_field_fwd", "trace_field_bwd")] + [
        "trace_fwd_poly_sag", "trace_bwd_poly_sag", "pol_fwd_intensity_sag",
        "pol_bwd_intensity_sag"]
    log(f"phase 20 sag and deep kernels at 2^{args.full_log2} rays (f32; "
        f"tilted asphere, ObjectiveUS008879901; poly mode on the tilted "
        f"asphere, intensity mode on the coated asphere) against the f32 plain "
        f"versions: forwards within 2e-4 x max(1, max |ref|), input "
        f"cotangents (tol 1e-3) and gradient L2 (tol 1e-3) "
        f"{ {k: float(f'{v:.3e}') for k, v in full20.items()} }; max "
        f"|kernel - plain| { {k: float(f'{kerr[k]:.4g}') for k in k6_names} }"
        f"; ms { {k: round(ms[k], 4) for k in k6_names} }; plain ms "
        f"{ {k: round(plain_ms[k], 2) for k in k6_names} }; bounds ms "
        f"{ {k: round(bound_ms_of(*work[k]), 4) for k in k6_names} }")

    # ---- phase 21: K6b's Cartesian families at check size (f64) ----
    # the free build of every trace kernel against its plain version on the
    # freeform singlets (samples/freeform.py) at (Hx, Hy) = (0.3, 0.7), the
    # tilted XY singlet and the 5 x 5 XY table: merit fwd/bwd, trace
    # fwd/bwd, field fwd/bwd, poly fwd/bwd; pol fwd/bwd in both modes on the
    # Fresnel-coated XY singlet. Per-ray arrays and every gradient column
    # (P_G1, P_G2 and each coefficient column included) to 1e-11 relative.
    t21 = time.perf_counter()
    config.set_precision("float64")
    FREE = {
        "polynomial": lambda: freeform.freeform_singlet("polynomial"),
        "chebyshev": lambda: freeform.freeform_singlet("chebyshev"),
        "toroidal": lambda: freeform.freeform_singlet("toroidal"),
        "biconic": lambda: freeform.freeform_singlet("biconic"),
        "polynomial_tilted": lambda: freeform.freeform_singlet(
            "polynomial", tilted=True),
        "polynomial_5x5": lambda: freeform.freeform_singlet(
            "polynomial", coefficients=freeform.CMAT5),
    }
    HF = freeform.H
    g21 = torch.Generator(device=dev).manual_seed(21)
    res21 = {}

    def col_errs(fk, fp, S_k, nc_k, rows, what, tol=1e-11):
        """Every gradient column of the Newton rows ``rows`` (P_G1, P_G2,
        then each coefficient column) and the whole flat gradient: |d| <=
        tol |ref| + 1e-13 max|ref|; returns the worst relative errors."""
        e = {"all": flat_err(fk, fp, tol, what, 1e-13)}
        dpk = fk[:S_k * ft.NUM_P].reshape(S_k, ft.NUM_P)
        dpp = fp[:S_k * ft.NUM_P].reshape(S_k, ft.NUM_P)
        dck = fk[S_k * ft.NUM_P:S_k * (ft.NUM_P + nc_k)].reshape(S_k, nc_k)
        dcp = fp[S_k * ft.NUM_P:S_k * (ft.NUM_P + nc_k)].reshape(S_k, nc_k)
        cols = [("p1", dpk[rows, 11], dpp[rows, 11]),
                ("p2", dpk[rows, 12], dpp[rows, 12])] + [
            (f"c{j}", dck[rows, j], dcp[rows, j]) for j in range(nc_k)]
        for key, a, b in cols:
            d = float((a - b).abs().max())
            top = float(b.abs().max())
            check(d <= tol * top + 1e-13 * float(fp.abs().max()),
                  f"{what} column {key}: |d| {d:.3e}, |ref| {top:.3e}")
            e[key] = d / top if top > 0 else d
        return e

    def free_parity(fname, sysk, build, what, f32=False, rows=None,
                    poly=True):
        """The free (or deep_free, aux, grat) build of every trace kernel
        but the polarized ones (and with ``poly`` False the polychromatic
        ones) against its plain version on ``sysk`` (f64, the
        coefficient and layout tables of launch.kernel_tables): per-ray
        arrays to 1e-11 and every gradient column of the Cartesian
        surfaces, or of ``rows`` (col_errs); with ``f32`` also trace_fwd
        and trace_bwd in f32 on the same inputs against the f64 plain
        versions (near32, the input cotangents within 1e-3, the gradient
        to 1e-3 in L2)."""
        spec_k = ftr.fast_spec(sysk, field=True)
        mspec_k = ft._spec_of(sysk)
        check(ftr._build(spec_k) == build and ft._build(mspec_k) == build,
              f"{what} {fname}: build {ftr._build(spec_k)}")
        S_k = len(spec_k[0])
        _, pk, ak, _, ins, cots = k6_inputs(sysk, HF, Px64, Py64, g21)
        ck, lk = launch_build.kernel_tables(sysk, torch.float64)
        nck = ck.shape[1]
        if rows is None:
            rows = [s for s, c in enumerate(spec_k[0]) if c in CART_CODES]
        r = {"trace_fwd": arr_err(ftr.trace_fwd(pk, spec_k, ins, ck, lk),
                                  ftr.trace_fast_plain(pk, spec_k, ins, ck,
                                                       lk))}
        din_k, fl_k = ftr.trace_bwd(pk, spec_k, nck, ins, cots, ck, lk)
        din_p, fl_p = ftr.trace_fast_bwd_plain(pk, spec_k, nck, ins, cots, ck,
                                               lk)
        r["trace_bwd_din"] = arr_err(din_k, din_p, 1e-6)
        r["trace_bwd"] = col_errs(fl_k, fl_p, S_k, nck, rows,
                                  f"{fname} trace_bwd")
        if f32:
            p32, c32 = pk.float(), ck.float()
            l32 = None if lk is None else lk.float()
            ins32 = [t.float() for t in ins]
            near32(ftr.trace_fwd(p32, spec_k, ins32, c32, l32),
                   ftr.trace_fast_plain(pk, spec_k, ins, ck, lk),
                   f"{fname} trace_fwd f32 vs f64")
            din32, fl32 = ftr.trace_bwd(p32, spec_k, nck, ins32,
                                        [t.float() for t in cots], c32, l32)
            r["f32_din"] = arr_err(din32, din_p, 1e-4)
            r["f32_grad_l2"] = l2(fl32, fl_p)
            check(r["f32_din"] <= 1e-3 and r["f32_grad_l2"] <= 1e-3,
                  f"{fname} trace_bwd f32 vs f64: input cotangents "
                  f"{r['f32_din']}, gradient L2 {r['f32_grad_l2']}")
            del ins32, din32, fl32
        r["trace_field_fwd"] = arr_err(
            ftr.trace_field_fwd(pk, ak, spec_k, Px64, Py64, ck, lk),
            ftr.trace_fast_field_plain(pk, ak, spec_k, Px64, Py64, ck, lk))
        r["trace_field_bwd"] = col_errs(
            ftr.trace_field_bwd(pk, ak, spec_k, nck, Px64, Py64, cots, ck,
                                lk),
            ftr.trace_fast_field_bwd_plain(pk, ak, spec_k, nck, Px64, Py64,
                                           cots, ck, lk),
            S_k, nck, rows, f"{fname} trace_field_bwd")
        rows_k = ft.merit_fwd(pk, ak, mspec_k, Rc, Px=Px64, Py=Py64,
                              coeffs=ck, lay=lk)
        lk_, xbk, ybk = ft._chan_combine(rows_k, Rc)
        r["merit_fwd"] = rel(lk_, ft._chan_combine(ft.merit_fwd_plain(
            pk, ak, mspec_k, Rc, Px=Px64, Py=Py64, coeffs=ck, lay=lk),
            Rc)[0])
        st_k = torch.stack([xbk, ybk, torch.tensor(1.0 / Rc, device=dev,
                                                   dtype=torch.float64),
                            torch.zeros((), device=dev, dtype=torch.float64)])
        r["merit_bwd"] = col_errs(
            ft.merit_bwd(pk, ak, st_k, mspec_k, nck, Rc, Px=Px64, Py=Py64,
                         coeffs=ck, lay=lk),
            ft.merit_bwd_plain(pk, ak, st_k, mspec_k, nck, Rc, Px=Px64,
                               Py=Py64, coeffs=ck, lay=lk),
            S_k, nck, rows, f"{fname} merit_bwd")
        if poly:
            spec_q = ftr.poly_spec(sysk)
            pq = ftr.build_poly_table(sysk).contiguous()
            mq = sysk.stack.mat_coeffs.contiguous()
            ins9 = ins + [cycled(Rc, torch.float64)]
            r["trace_fwd_poly"] = arr_err(
                ftr.trace_fwd_poly(pq, mq, spec_q, ins9, ck, lk),
                ftr.trace_fwd_poly_plain(pq, mq, spec_q, ins9, ck, lk))
            din_k, fl_k = ftr.trace_bwd_poly(pq, mq, spec_q, nck, ins9, cots,
                                             ck, lk)
            din_p, fl_p = ftr.trace_bwd_poly_plain(pq, mq, spec_q, nck, ins9,
                                                   cots, ck, lk)
            r["trace_bwd_poly_din"] = arr_err(din_k, din_p, 1e-6)
            r["trace_bwd_poly"] = col_errs(fl_k, fl_p, S_k, nck, rows,
                                           f"{fname} trace_bwd_poly")
        for key in ("trace_fwd", "trace_bwd_din", "trace_field_fwd",
                    "trace_fwd_poly", "trace_bwd_poly_din", "merit_fwd"):
            check(r.get(key, 0.0) <= 1e-11, f"{fname} {key} f64: rel err "
                  f"{r.get(key)} > 1e-11")
        torch.cuda.synchronize()
        log(f"{what} {fname} (codes {spec_k[0]}, nc {nck}, "
            f"{BUILD_SUFFIX[build][1:]} build; 2^{args.check_log2} rays, f64 "
            f"vs plain, tol 1e-11 per ray and per gradient column): "
            + ", ".join(
                f"{k} {v:.2e}" if isinstance(v, float) else
                f"{k} max {max(v.values()):.2e} (p1 {v['p1']:.1e}, p2 "
                f"{v['p2']:.1e}, coefficient columns "
                f"{max(v[c] for c in v if c.startswith('c')):.1e})"
                for k, v in r.items()))
        return r

    for fname, builder in FREE.items():
        res21[fname] = free_parity(fname, builder().system, launch_build.FREE,
                                   "phase 21")
    # K8/K9 on the Fresnel-coated XY singlet, both modes
    sys_c = freeform.coated_freeform("polynomial", "H").system
    wl_c, pkc, _, cc, ins, cots = k6_inputs(sys_c, HF, Px64, Py64, g21,
                                            pt.N_POL)
    spec_pc = pt.pol_spec(sys_c, wl_c)
    check(spec_pc is not None and pt._build(spec_pc) == launch_build.FREE,
          "phase 21: the coated XY singlet is not on the free build")
    coat_c = pt.build_coat_table(sys_c, wl_c, torch.float64, dev)
    r = {}
    for mode, states, intensity in (("full", None, False),
                                    ("H", pt.pol_states(STATE_H), True)):
        c = cots[:8] if intensity else cots
        for key, v in pol_parity(pkc, coat_c, spec_pc, cc.shape[1], ins, c,
                                 states, intensity, f"coated XY {mode}",
                                 coeffs=cc).items():
            r[f"pol_{key}_{mode}"] = v
        check(max(r[f"pol_{k}_{mode}"] for k in ("fwd", "bwd_din", "bwd"))
              <= 1e-11, f"coated XY {mode}: {r}")
    res21["coated_polynomial"] = r
    report["phases"]["free_parity"] = res21
    del ins, cots
    torch.cuda.synchronize()
    log(f"phase 21 K8/K9 (coated XY singlet, f64 vs plain tol 1e-11; f32 as "
        f"phase 14): " + ", ".join(f"{k} {v:.2e}" for k, v in r.items())
        + f"; phase 21 wall {time.perf_counter() - t21:.1f} s")

    # ---- phase 22: the freeform steps at full width (f32) ----
    # the merit, field and generic value+grad steps of the XY-polynomial
    # and toroidal singlets and the merit steps of the Chebyshev and
    # biconic ones at (Hx, Hy) = (0.3, 0.7), every stack leaf; the poly
    # step of the XY singlet and the polarized step of the coated one
    # (three counted steps each); then the free build of each kernel at
    # full width against its f32 plain version, timed, with its bound
    t22 = time.perf_counter()
    config.set_precision("float32")
    steps22, full22 = {}, {}
    free32 = {}
    for fname, paths in (("polynomial", ("merit", "field", "generic")),
                         ("toroidal", ("merit", "field", "generic")),
                         ("chebyshev", ("merit",)), ("biconic", ("merit",))):
        sys32 = FREE[fname]().system
        free32[fname] = sys32

        def merit22(system, seed):
            return ft.spot_rms_fast_field(system, *HF, WL, num_rays=Rf,
                                          seed=seed)

        def field22(system, seed):
            Px, Py = ft.prng_disk(seed, Rf, 0, torch.float32, dev)
            f = ftr.trace_fast_field(system, *HF, Px, Py, WL)
            return ((f.x - f.x.mean()) ** 2 + (f.y - f.y.mean()) ** 2).mean()

        def generic22(system, seed):
            Px, Py = ft.prng_disk(seed, Rf, 0, torch.float32, dev)
            return rms_spot_size(system, *HF, Px, Py, WL)

        fns = {"merit": (merit22, ("merit_fwd_free", "merit_bwd_free")),
               "field": (field22, ("prng_disk", "trace_field_fwd_free",
                                   "trace_field_bwd_free")),
               "generic": (generic22, ("prng_disk", "trace_fwd_free",
                                       "trace_bwd_free"))}
        for pname in paths:
            loss_fn, kern = fns[pname]
            name = f"{fname}_{pname}"
            seed0 = 8000 + 100 * len(steps22)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            sl, lv = leaf_system(sys32)
            first = loss_fn(sl, seed0 - 100)
            first.backward()
            check(bool(torch.isfinite(first)), f"{name}: value not finite")
            g_r = lv["radius"].grad[1]
            g_c = lv["coeffs"].grad[1]
            g_p = lv["geo_p1"].grad[1]
            check(bool(torch.isfinite(g_r) and torch.isfinite(g_c).all()
                       and torch.isfinite(g_p)), f"{name}: gradient not "
                  f"finite: radius {float(g_r)}, p1 {float(g_p)}, "
                  f"coeffs {g_c.tolist()}")
            check(fname == "biconic" or bool((g_c != 0).any()),
                  f"{name}: coefficient gradient {g_c.tolist()}")
            check(fname == "polynomial" or float(g_p) != 0,
                  f"{name}: geo_p1 gradient 0")

            def vg22(i, sysk=sys32, loss_fn=loss_fn):
                s_, _ = leaf_system(sysk)
                loss_fn(s_, i).backward()

            times22 = timed(vg22, seed0)
            got22 = counts()
            n22 = 1 + 3 + args.steps
            expect22 = {**dict.fromkeys(got22, 0),
                        **dict.fromkeys(kern, n22)}
            check(got22 == expect22, f"{name} launches {got22}, expected "
                  f"{expect22}")
            path_launches[name] = got22
            step22 = float(np.median(times22))
            steps22[name] = {"value": float(first.detach()),
                             "step_ms": step22, "step_ms_all": times22,
                             "launches": {k: v for k, v in got22.items()
                                          if v},
                             "steps": n22}
            log(f"phase 22 {name}: {n22} value+grad steps over every stack "
                f"leaf in {time.perf_counter() - t0:.1f} s, value "
                f"{float(first.detach()):.9e}; median step {step22:.3f} ms "
                f"over {args.steps} steps; launches "
                f"{ {k: v for k, v in got22.items() if v} }")
    xy32 = free32["polynomial"]
    report["phases"]["free_steps"] = steps22
    # the free build of each kernel at full width on the XY singlet, its
    # poly mode and the polarized kernels on the coated one
    gen22 = torch.Generator(device=dev).manual_seed(220)
    kernels_full_width(xy32, HF, "_free", gen22, full22)
    poly_pol_full_width(xy32, freeform.coated_freeform("polynomial",
                                                       "H").system,
                        "_free", HF, gen22,
                        ("polynomial_poly", "coated_polynomial_pol"),
                        steps22, 8900, 221, full22)
    report["phases"]["free_full_width"] = full22
    free_names = [n + "_free" for n in (
        "merit_fwd", "merit_bwd", "trace_fwd", "trace_bwd", "trace_field_fwd",
        "trace_field_bwd", "trace_fwd_poly", "trace_bwd_poly",
        "pol_fwd_intensity", "pol_bwd_intensity")]
    log(f"phase 22 free kernels at 2^{args.full_log2} rays (f32; XY singlet, "
        f"coated for K8/K9) against the f32 plain versions: forwards within "
        f"2e-4 x max(1, max |ref|), input cotangents (tol 1e-3) and "
        f"gradient L2 (tol 1e-3) "
        f"{ {k: float(f'{v:.3e}') for k, v in full22.items()} }; max "
        f"|kernel - plain| "
        f"{ {k: float(f'{kerr[k]:.4g}') for k in free_names} }; ms "
        f"{ {k: round(ms[k], 4) for k in free_names} }; plain ms "
        f"{ {k: round(plain_ms[k], 2) for k in free_names} }; bounds ms "
        f"{ {k: round(bound_ms_of(*work[k]), 4) for k in free_names} }; "
        f"phase 22 wall {time.perf_counter() - t22:.1f} s")

    # ---- phase 23: K6b's aux-bearing families at check size (f64) ----
    # the aux build of every trace kernel against its plain version on the
    # Zernike, Qbfs and Q2d singlets (samples/freeform.py) at (Hx, Hy) =
    # (0.3, 0.7), the tilted Zernike singlet and a 36-term fringe Zernike
    # (the coefficient table at NC_MAX), and the deep_aux build on a
    # 20-surface system behind a Zernike and a Q2d surface: per-ray arrays
    # and every gradient column (P_G1, P_G2, each slot column) to 1e-11,
    # trace_fwd/trace_bwd in f32 against the f64 plain versions; K8/K9 on
    # each family's Fresnel-coated singlet; then the poly and polarized
    # kernels of each family timed at check size (f32)
    t23 = time.perf_counter()
    config.set_precision("float64")

    AUXF = {
        "zernike": lambda: freeform.freeform_singlet("zernike"),
        "forbes_qbfs": lambda: freeform.freeform_singlet("forbes_qbfs"),
        "forbes_q2d": lambda: freeform.freeform_singlet("forbes_q2d"),
        "zernike_tilted": lambda: freeform.freeform_singlet(
            "zernike", tilted=True),
        "zernike_36": lambda: freeform.freeform_singlet(
            "zernike", coefficients=freeform.ZC36),
    }
    res23 = {}
    for fname, builder in AUXF.items():
        res23[fname] = free_parity(fname, builder().system, launch_build.AUX,
                                   "phase 23", f32=True)
    check(launch_build.kernel_tables(AUXF["zernike_36"]().system,
                                     torch.float64)[0].shape[1]
          == launch_build.NC_MAX, "phase 23: the 36-term Zernike table")
    res23["deep_aux"] = free_parity("deep_aux", freeform.deep_aux().system,
                                    launch_build.DEEP_AUX, "phase 23",
                                    f32=True)
    # K8/K9 on each family's Fresnel-coated singlet, both modes. The f32
    # input cotangents are held against the f32 plain version's own error
    # too: K9's f32 adjoint loses accuracy as 1 / |k0 x k1| near normal
    # incidence, and a ray of the coated Qbfs singlet meets its Forbes
    # surface at |k0 x k1| ~ 8e-5 (ROADMAP Queue 3)
    for fam in freeform.AUX_FAMILIES:
        sys_z = freeform.coated_freeform(fam, "H").system
        wl_z, pkz, _, _, ins, cots = k6_inputs(sys_z, HF, Px64, Py64, g21,
                                               pt.N_POL)
        cz, lz = launch_build.kernel_tables(sys_z, torch.float64)
        spec_pz = pt.pol_spec(sys_z, wl_z)
        check(spec_pz is not None and pt._build(spec_pz) == launch_build.AUX,
              f"phase 23: the coated {fam} singlet is not on the aux build")
        coat_z = pt.build_coat_table(sys_z, wl_z, torch.float64, dev)
        r = {}
        for mode, states, intensity in (("full", None, False),
                                        ("H", pt.pol_states(STATE_H), True)):
            c = cots[:8] if intensity else cots
            for key, v in pol_parity(
                    pkz, coat_z, spec_pz, cz.shape[1], ins, c, states,
                    intensity, f"coated {fam} {mode}", coeffs=cz, lay=lz,
                    f32_plain=True).items():
                r[f"pol_{key}_{mode}"] = v
            check(max(r[f"pol_{k}_{mode}"] for k in ("fwd", "bwd_din", "bwd"))
                  <= 1e-11, f"coated {fam} {mode}: {r}")
        res23[f"coated_{fam}"] = r
        del ins, cots
        log(f"phase 23 K8/K9 (coated {fam} singlet, f64 vs plain tol 1e-11; "
            "f32 as phase 14, input cotangents within 1e-3 or 4x the f32 "
            "plain version's error): "
            + ", ".join(f"{k} {v:.2e}" for k, v in r.items()))
    # the poly kernels on each family's singlet and the polarized kernels
    # (intensity mode) on its Fresnel-coated one at check size, f32, timed
    config.set_precision("float32")
    check_ms = {}
    for fam in freeform.AUX_FAMILIES:
        sq = freeform.freeform_singlet(fam).system
        spec_q = ftr.poly_spec(sq)
        cq, lq = launch_build.kernel_tables(sq, torch.float32)
        with torch.no_grad():
            pq = ftr.build_poly_table(sq).contiguous()
            mq = sq.stack.mat_coeffs.contiguous()
            Pxq, Pyq = ft.prng_disk(23, Rc, 0, torch.float32, dev)
            rays = raygen.generate_rays(sq, *HF, Pxq, Pyq, WL)
            ins_q = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
            ins_q.append(cycled(Rc, torch.float32))
            cots_q = [torch.randn(Rc, generator=g21, device=dev) / Rc
                      for _ in range(8)]
            ncq = cq.shape[1]
            check_ms[f"trace_fwd_poly_aux_{fam}"] = time_ms(
                lambda i: ftr.trace_fwd_poly(pq, mq, spec_q, ins_q, cq, lq),
                10, 3)
            check_ms[f"trace_bwd_poly_aux_{fam}"] = time_ms(
                lambda i: ftr.trace_bwd_poly(pq, mq, spec_q, ncq, ins_q,
                                             cots_q, cq, lq), 10, 3)
            sc = freeform.coated_freeform(fam, "H").system
            spec_c = pt.pol_spec(sc, WL)
            cc_, lc_ = launch_build.kernel_tables(sc, torch.float32)
            pc = ft.build_param_table(sc, WL).contiguous()
            coat_c = pt.build_coat_table(sc, WL, torch.float32, dev)
            rays = raygen.generate_rays(sc, *HF, Pxq, Pyq, WL)
            ins_c = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
            st_h = pt.pol_states(STATE_H)
            check_ms[f"pol_fwd_intensity_aux_{fam}"] = time_ms(
                lambda i: pt.pol_fwd(pc, coat_c, spec_c, ins_c, st_h, True,
                                     cc_, lc_), 10, 3)
            check_ms[f"pol_bwd_intensity_aux_{fam}"] = time_ms(
                lambda i: pt.pol_bwd(pc, coat_c, spec_c, cc_.shape[1], ins_c,
                                     cots_q, st_h, True, cc_, lc_), 10, 3)
            del rays, ins_q, ins_c, cots_q
    report["phases"]["aux_parity"] = res23
    report["phases"]["aux_check_ms"] = check_ms
    torch.cuda.synchronize()
    log(f"phase 23 poly and polarized kernels at 2^{args.check_log2} rays "
        f"(f32, ms): { {k: round(v, 4) for k, v in check_ms.items()} }; "
        f"phase 23 wall {time.perf_counter() - t23:.1f} s")

    # ---- phase 24: the aux-bearing singlets' steps at full width (f32) ----
    # the merit, field and generic value+grad steps of the Zernike, Qbfs
    # and Q2d singlets at (Hx, Hy) = (0.3, 0.7) over every stack leaf, the
    # poly step of the Q2d singlet and the polarized step of each coated
    # singlet (three counted steps each); then the aux build of each merit,
    # trace, poly (Q2d) and polarized kernel at full width against its f32
    # plain version, timed, with its bound (rows tagged with the family)
    t24 = time.perf_counter()
    steps24, full24 = {}, {}
    aux32 = {}
    for fname in freeform.AUX_FAMILIES:
        sys32 = AUXF[fname]().system
        aux32[fname] = sys32
        for pname in ("merit", "field", "generic"):
            loss_fn, kern = {
                "merit": (merit22, ("merit_fwd_aux", "merit_bwd_aux")),
                "field": (field22, ("prng_disk", "trace_field_fwd_aux",
                                    "trace_field_bwd_aux")),
                "generic": (generic22, ("prng_disk", "trace_fwd_aux",
                                        "trace_bwd_aux"))}[pname]
            name = f"{fname}_{pname}"
            seed0 = 9600 + 100 * len(steps24)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            sl, lv = leaf_system(sys32)
            first = loss_fn(sl, seed0 - 100)
            first.backward()
            g_c = lv["coeffs"].grad[1]
            g_p = lv["geo_p1"].grad[1]
            check(bool(torch.isfinite(first)) and bool(torch.isfinite(
                lv["radius"].grad[1])) and bool(torch.isfinite(g_c).all())
                and bool(torch.isfinite(g_p)), f"{name}: value or gradient "
                f"not finite: p1 {float(g_p)}, coeffs {g_c.tolist()}")
            check(bool((g_c != 0).any()) and float(g_p) != 0,
                  f"{name}: coefficient or geo_p1 gradient 0")

            def vg24(i, sysk=sys32, loss_fn=loss_fn):
                s_, _ = leaf_system(sysk)
                loss_fn(s_, i).backward()

            times24 = timed(vg24, seed0)
            got24 = counts()
            n24 = 1 + 3 + args.steps
            expect24 = {**dict.fromkeys(got24, 0),
                        **dict.fromkeys(kern, n24)}
            check(got24 == expect24, f"{name} launches {got24}, expected "
                  f"{expect24}")
            path_launches[name] = got24
            step24 = float(np.median(times24))
            steps24[name] = {"value": float(first.detach()),
                             "step_ms": step24, "step_ms_all": times24,
                             "launches": {k: v for k, v in got24.items()
                                          if v},
                             "steps": n24}
            log(f"phase 24 {name}: {n24} value+grad steps over every stack "
                f"leaf in {time.perf_counter() - t0:.1f} s, value "
                f"{float(first.detach()):.9e}; median step {step24:.3f} ms "
                f"over {args.steps} steps; launches "
                f"{ {k: v for k, v in got24.items() if v} }")
    # each family's kernels at full width; the poly step of the Q2d
    # singlet and the polarized step of each coated singlet (three counted
    # steps each), their kernels at full width
    gen24 = torch.Generator(device=dev).manual_seed(240)
    for k, fname in enumerate(freeform.AUX_FAMILIES):
        kernels_full_width(aux32[fname], HF, "_aux", gen24, full24,
                           tag=f"_{fname}")
        poly_pol_full_width(
            aux32[fname] if fname == "forbes_q2d" else None,
            freeform.coated_freeform(fname, "H").system, "_aux", HF, gen24,
            (f"{fname}_poly", f"{fname}_coated_pol"), steps24,
            9900 + 10 * k, 241 + k, full24, tag=f"_{fname}")
    report["phases"]["aux_steps"] = steps24
    report["phases"]["aux_full_width"] = full24
    aux_names = [n + "_aux_" + fam for fam in freeform.AUX_FAMILIES
                 for n in ("merit_fwd", "merit_bwd", "trace_fwd",
                           "trace_bwd", "trace_field_fwd",
                           "trace_field_bwd", "pol_fwd_intensity",
                           "pol_bwd_intensity")] + [
        "trace_fwd_poly_aux_forbes_q2d", "trace_bwd_poly_aux_forbes_q2d"]
    log(f"phase 24 aux kernels at 2^{args.full_log2} rays on the Zernike, "
        f"Qbfs and Q2d singlets (f32; poly mode on the Q2d singlet, "
        f"intensity mode on the coated ones) against the f32 plain versions: "
        f"forwards within 2e-4 x max(1, max |ref|), input cotangents (tol "
        f"1e-3) and gradient L2 (tol 1e-3) "
        f"{ {k: float(f'{v:.3e}') for k, v in full24.items()} }; max "
        f"|kernel - plain| "
        f"{ {k: float(f'{kerr[k]:.4g}') for k in aux_names} }; ms "
        f"{ {k: round(ms[k], 4) for k in aux_names} }; plain ms "
        f"{ {k: round(plain_ms[k], 2) for k in aux_names} }; bounds ms "
        f"{ {k: round(bound_ms_of(*work[k]), 4) for k in aux_names} }; "
        f"phase 24 wall {time.perf_counter() - t24:.1f} s")

    # ---- phase 25: K6c, gratings, at check size (f64) ----
    # the grat build of the six monochromatic kernels against their plain
    # versions on the three golden grating lenses and the tilted one
    # (samples/grating.py) at (Hx, Hy) = (0.3, 0.7): per-ray arrays and
    # every gradient column (the grating's P_G1 and P_G2 included) to
    # 1e-11, trace_fwd/trace_bwd in f32 against the f64 plain versions;
    # a grating beside an asphere raises on the card and launches nothing;
    # a polychromatic and a polarized grating trace run the plain engine
    # on the card, as in the JAX package, against the f64 plain engine on
    # the CPU
    t25 = time.perf_counter()
    config.set_precision("float64")
    res25 = {}
    for gname in grating.NAMES:
        sysg = grating.BUILDERS[gname]().system
        grows = [s_ for s_, g_ in enumerate(ftr._grat(ftr.fast_spec(sysg)))
                 if g_]
        res25[gname] = free_parity(gname, sysg, launch_build.GRAT,
                                   "phase 25", f32=True, rows=grows,
                                   poly=False)
    # the refusal: a grating beside an even asphere
    lens_a = grating.plane_grating()
    s1 = lens_a.surfaces.surfaces[1]
    s1.surface_type, s1.coefficients = "even_asphere", (1e-5, -2e-8)
    lens_a._invalidate()
    sys_a = lens_a.system
    rays_a = raygen.generate_rays(sys_a, *HF, Px64[:4096], Py64[:4096], WL)
    reset_counts()
    refused = 0
    for call in (lambda: trace_core.trace(sys_a, rays_a, record=False,
                                          wavelength=WL),
                 lambda: ft.spot_rms_fast_field(sys_a, *HF, WL,
                                                Px=Px64[:4096],
                                                Py=Py64[:4096])):
        try:
            call()
        except NotImplementedError as e:
            refused += "grating beside EVEN_ASPHERE" in str(e)
    check(refused == 2 and not any(counts().values()),
          f"phase 25: a grating beside an asphere ran on the card: "
          f"{refused} refusals, launches "
          f"{ {k: v for k, v in counts().items() if v} }")
    # a wavelength per ray and a polarized coated grating: the plain
    # engine on the card, against the plain engine on the CPU
    w25 = torch.tensor(POLY_WLS, dtype=torch.float64,
                       device=dev)[torch.arange(4096, device=dev) % 3]
    sys_p = grating.plane_grating().system
    rays_p = raygen.generate_rays(sys_p, *HF, Px64[:4096], Py64[:4096],
                                  WL).replace(w=w25)
    out_poly, _ = trace_core.trace(sys_p, rays_p, record=False)
    out_pol = grating.coated_grating("H").trace(Hx=0.3, Hy=0.7, num_rays=12,
                                                record=False).rays
    check(not any(counts().values()), "phase 25: the poly or polarized "
          f"grating launched { {k: v for k, v in counts().items() if v} }")
    config.set_device("cpu")
    ref_poly, _ = trace_core.trace(grating.plane_grating().system,
                                   rays_p.replace(**{
                                       k: getattr(rays_p, k).cpu() for k in
                                       ftr.RAY_FIELDS + ("w",)}),
                                   record=False)
    ref_pol = grating.coated_grating("H").trace(Hx=0.3, Hy=0.7, num_rays=12,
                                                record=False).rays
    config.set_device("cuda")
    for what, got, ref in (("poly", out_poly, ref_poly),
                           ("polarized", out_pol, ref_pol)):
        a_ = [getattr(got, k).cpu() for k in ftr.RAY_FIELDS]
        b_ = [getattr(ref, k) for k in ftr.RAY_FIELDS]
        check(all(bool(torch.isfinite(u).all()) for u in a_),
              f"phase 25 {what} grating on the card: not finite")
        res25[f"{what}_plain_engine"] = arr_err(a_, b_)
        check(res25[f"{what}_plain_engine"] <= 1e-12, f"phase 25 {what} "
              f"grating: card vs CPU {res25[f'{what}_plain_engine']}")
    report["phases"]["grat_parity"] = res25
    torch.cuda.synchronize()
    log(f"phase 25 refusal beside an asphere on the card: {refused} of 2 "
        f"entry points raise, no launch; poly and polarized gratings on the "
        f"plain engine, card vs CPU (f64, tol 1e-12): poly "
        f"{res25['poly_plain_engine']:.2e}, polarized "
        f"{res25['polarized_plain_engine']:.2e}; phase 25 wall "
        f"{time.perf_counter() - t25:.1f} s")

    # ---- phase 26: the grating lenses' steps at full width (f32) ----
    # the merit, field and generic value+grad steps of the three golden
    # grating lenses at (Hx, Hy) = (0.3, 0.7) over every stack leaf (the
    # grating's geo_p1 and geo_p2 gradients finite and nonzero); then the
    # grat build of each merit and trace kernel at full width against its
    # f32 plain version, timed, with its bound (rows tagged with the lens)
    t26 = time.perf_counter()
    config.set_precision("float32")
    steps26, full26 = {}, {}
    grat32 = {}
    for gname in GRAT_NAMES:
        sys32 = grating.BUILDERS[gname]().system
        grat32[gname] = sys32
        gs26 = ftr._grat(ftr.fast_spec(sys32)).index(True)
        for pname in ("merit", "field", "generic"):
            loss_fn, kern = {
                "merit": (merit22, ("merit_fwd_grat", "merit_bwd_grat")),
                "field": (field22, ("prng_disk", "trace_field_fwd_grat",
                                    "trace_field_bwd_grat")),
                "generic": (generic22, ("prng_disk", "trace_fwd_grat",
                                        "trace_bwd_grat"))}[pname]
            name = f"{gname}_{pname}"
            seed0 = 9800 + 100 * len(steps26)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            sl, lv = leaf_system(sys32)
            first = loss_fn(sl, seed0 - 100)
            first.backward()
            g_p1 = lv["geo_p1"].grad[gs26]
            g_p2 = lv["geo_p2"].grad[gs26]
            check(bool(torch.isfinite(first)) and bool(torch.isfinite(g_p1))
                  and bool(torch.isfinite(g_p2)) and float(g_p1) != 0
                  and float(g_p2) != 0, f"{name}: value or grating "
                  f"gradient: {float(first)}, p1 {float(g_p1)}, p2 "
                  f"{float(g_p2)}")

            def vg26(i, sysk=sys32, loss_fn=loss_fn):
                s_, _ = leaf_system(sysk)
                loss_fn(s_, i).backward()

            times26 = timed(vg26, seed0)
            got26 = counts()
            n26 = 1 + 3 + args.steps
            expect26 = {**dict.fromkeys(got26, 0),
                        **dict.fromkeys(kern, n26)}
            check(got26 == expect26, f"{name} launches {got26}, expected "
                  f"{expect26}")
            path_launches[name] = got26
            step26 = float(np.median(times26))
            steps26[name] = {"value": float(first.detach()),
                             "step_ms": step26, "step_ms_all": times26,
                             "launches": {k: v for k, v in got26.items()
                                          if v},
                             "steps": n26,
                             "grating_grads": [float(g_p1), float(g_p2)]}
            log(f"phase 26 {name}: {n26} value+grad steps over every stack "
                f"leaf in {time.perf_counter() - t0:.1f} s, value "
                f"{float(first.detach()):.9e}, d/d(period, groove angle) "
                f"({float(g_p1):.6e}, {float(g_p2):.6e}); median step "
                f"{step26:.3f} ms over {args.steps} steps; launches "
                f"{ {k: v for k, v in got26.items() if v} }")
    gen26 = torch.Generator(device=dev).manual_seed(260)
    for gname in GRAT_NAMES:
        kernels_full_width(grat32[gname], HF, "_grat", gen26, full26,
                           tag=f"_{gname}")
    report["phases"]["grat_steps"] = steps26
    report["phases"]["grat_full_width"] = full26
    grat_names = [n + "_grat_" + g for g in GRAT_NAMES
                  for n in ("merit_fwd", "merit_bwd", "trace_fwd",
                            "trace_bwd", "trace_field_fwd",
                            "trace_field_bwd")]
    log(f"phase 26 grat kernels at 2^{args.full_log2} rays on the three "
        f"golden grating lenses (f32) against the f32 plain versions: "
        f"forwards within 2e-4 x max(1, max |ref|), input cotangents (tol "
        f"1e-3) and gradient L2 (tol 1e-3) "
        f"{ {k: float(f'{v:.3e}') for k, v in full26.items()} }; max "
        f"|kernel - plain| "
        f"{ {k: float(f'{kerr[k]:.4g}') for k in grat_names} }; ms "
        f"{ {k: round(ms[k], 4) for k in grat_names} }; plain ms "
        f"{ {k: round(plain_ms[k], 2) for k in grat_names} }; bounds ms "
        f"{ {k: round(bound_ms_of(*work[k]), 4) for k in grat_names} }; "
        f"phase 26 wall {time.perf_counter() - t26:.1f} s")

    # ---- phase 27: K6d, NURBS surfaces, at check size (f64) ----
    # the nurbs build of every trace kernel against its plain version on
    # the three lenses of samples/nurbs.py (the golden rational net, the
    # golden conic fit, the B-spline paraboloid) and the tilted rational
    # one at (Hx, Hy) = (0.3, 0.7): per-ray arrays and every gradient
    # column (the net's 4 nu nv columns included) to 1e-11, trace_fwd/
    # trace_bwd in f32 against the f64 plain versions; the poly mode on the
    # rational lens; K8/K9 (both modes) on its Fresnel-coated variant; a
    # NURBS surface beside an asphere raises on the card and launches
    # nothing
    t27 = time.perf_counter()
    config.set_precision("float64")
    res27 = {}
    for nname, builder in NURBS_LENSES.items():
        res27[nname] = free_parity(nname, builder().system,
                                   launch_build.NURBS, "phase 27", f32=True,
                                   rows=[1], poly=nname == "rational")
    sys_n = nurbs.coated_nurbs("H").system
    wl_n, pkn, _, _, ins, cots = k6_inputs(sys_n, HF, Px64, Py64, g21,
                                           pt.N_POL)
    cn, ln = launch_build.kernel_tables(sys_n, torch.float64)
    spec_pn = pt.pol_spec(sys_n, wl_n)
    check(spec_pn is not None and pt._build(spec_pn) == launch_build.NURBS,
          "phase 27: the coated NURBS lens is not on the nurbs build")
    coat_n = pt.build_coat_table(sys_n, wl_n, torch.float64, dev)
    r = {}
    for mode, states, intensity in (("full", None, False),
                                    ("H", pt.pol_states(STATE_H), True)):
        c = cots[:8] if intensity else cots
        for key, v in pol_parity(pkn, coat_n, spec_pn, cn.shape[1], ins, c,
                                 states, intensity,
                                 f"coated rational NURBS {mode}", coeffs=cn,
                                 lay=ln, f32_plain=True).items():
            r[f"pol_{key}_{mode}"] = v
        check(max(r[f"pol_{k}_{mode}"] for k in ("fwd", "bwd_din", "bwd"))
              <= 1e-11, f"coated NURBS {mode}: {r}")
    res27["coated"] = r
    del ins, cots
    # the refusal: the fitted lens with its back surface an even asphere
    lens_n = nurbs.fitted_nurbs()
    s2_ = lens_n.surfaces.surfaces[2]
    s2_.surface_type, s2_.coefficients = "even_asphere", (1e-5, -2e-8)
    lens_n._invalidate()
    sys_na = lens_n.system
    rays_na = raygen.generate_rays(sys_na, *HF, Px64[:4096], Py64[:4096], WL)
    reset_counts()
    refused27 = 0
    for call in (lambda: trace_core.trace(sys_na, rays_na, record=False,
                                          wavelength=WL),
                 lambda: ft.spot_rms_fast_field(sys_na, *HF, WL,
                                                Px=Px64[:4096],
                                                Py=Py64[:4096])):
        try:
            call()
        except NotImplementedError as e:
            refused27 += "NURBS surface beside EVEN_ASPHERE" in str(e)
    check(refused27 == 2 and not any(counts().values()),
          f"phase 27: a NURBS surface beside an asphere ran on the card: "
          f"{refused27} refusals, launches "
          f"{ {k: v for k, v in counts().items() if v} }")
    report["phases"]["nurbs_parity"] = res27
    torch.cuda.synchronize()
    log("phase 27 K8/K9 (coated rational NURBS lens, f64 vs plain tol 1e-11; "
        "f32 as phase 14): " + ", ".join(f"{k} {v:.2e}" for k, v in r.items())
        + f"; refusal beside an asphere on the card: {refused27} of 2 entry "
        f"points raise, no launch; phase 27 wall "
        f"{time.perf_counter() - t27:.1f} s")

    # ---- phase 28: the NURBS lenses' steps at full width (f32) ----
    # the merit, field and generic value+grad steps of the golden rational
    # and conic-fit lenses at (Hx, Hy) = (0.3, 0.7) over every stack leaf
    # (the net's gradient finite and nonzero), the poly step of the
    # rational lens and the polarized step of its coated variant; then the
    # nurbs build of each kernel at full width, timed, with its bound, the
    # launch held against its f32 plain version chunk by chunk and the
    # plain version timed over the full width in chunks of 2^22 rays (its
    # per-ray net cotangents at 2^24 would not fit); rows tagged with the
    # lens
    t28 = time.perf_counter()
    config.set_precision("float32")
    steps28, full28 = {}, {}
    nurbs32 = {}
    chunk28 = min(Rf, 1 << 22)
    for nname in NURBS_TAGS:
        sys32 = NURBS_LENSES[nname]().system
        nurbs32[nname] = sys32
        for pname in ("merit", "field", "generic"):
            loss_fn, kern = {
                "merit": (merit22, ("merit_fwd_nurbs", "merit_bwd_nurbs")),
                "field": (field22, ("prng_disk", "trace_field_fwd_nurbs",
                                    "trace_field_bwd_nurbs")),
                "generic": (generic22, ("prng_disk", "trace_fwd_nurbs",
                                        "trace_bwd_nurbs"))}[pname]
            name = f"{nname}_{pname}"
            seed0 = 9900 + 100 * len(steps28)
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            sl, lv = leaf_system(sys32)
            first = loss_fn(sl, seed0 - 100)
            first.backward()
            g_net = lv["coeffs"].grad[1]
            check(bool(torch.isfinite(first))
                  and all(bool(torch.isfinite(v.grad).all())
                          for v in lv.values() if v.grad is not None)
                  and bool((g_net != 0).any()), f"{name}: value "
                  f"{float(first)} or a gradient not finite, or the net's "
                  f"gradient 0")

            def vg28(i, sysk=sys32, loss_fn=loss_fn):
                s_, _ = leaf_system(sysk)
                loss_fn(s_, i).backward()

            times28 = timed(vg28, seed0)
            got28 = counts()
            n28 = 1 + 3 + args.steps
            expect28 = {**dict.fromkeys(got28, 0),
                        **dict.fromkeys(kern, n28)}
            check(got28 == expect28, f"{name} launches {got28}, expected "
                  f"{expect28}")
            path_launches[name] = got28
            step28 = float(np.median(times28))
            steps28[name] = {"value": float(first.detach()),
                             "step_ms": step28, "step_ms_all": times28,
                             "launches": {k: v for k, v in got28.items()
                                          if v},
                             "steps": n28,
                             "net_grad_max": float(g_net.abs().max())}
            log(f"phase 28 {name}: {n28} value+grad steps over every stack "
                f"leaf in {time.perf_counter() - t0:.1f} s, value "
                f"{float(first.detach()):.9e}, max |d/d net| "
                f"{float(g_net.abs().max()):.6e}; median step {step28:.3f} "
                f"ms over {args.steps} steps; launches "
                f"{ {k: v for k, v in got28.items() if v} }")
    gen28 = torch.Generator(device=dev).manual_seed(280)
    for nname in NURBS_TAGS:
        kernels_full_width(nurbs32[nname], HF, "_nurbs", gen28, full28,
                           tag=f"_{nname}", chunk=chunk28)
    poly_pol_full_width(nurbs32["rational"], nurbs.coated_nurbs("H").system,
                        "_nurbs", HF, gen28, ("rational_poly",
                                              "rational_coated_pol"),
                        steps28, 9990, 281, full28, tag="_rational",
                        chunk=chunk28)
    report["phases"]["nurbs_steps"] = steps28
    report["phases"]["nurbs_full_width"] = full28
    nurbs_names = [n + "_nurbs_" + t for t in NURBS_TAGS
                   for n in ("merit_fwd", "merit_bwd", "trace_fwd",
                             "trace_bwd", "trace_field_fwd",
                             "trace_field_bwd")] + [
        n + "_nurbs_rational" for n in ("trace_fwd_poly", "trace_bwd_poly",
                                        "pol_fwd_intensity",
                                        "pol_bwd_intensity")]
    log(f"phase 28 nurbs kernels at 2^{args.full_log2} rays on the rational "
        f"and conic-fit lenses (f32; poly mode on the rational lens, "
        f"intensity mode on its coated variant) against the f32 plain "
        f"versions chunk by chunk (2^22 rays each): forwards within "
        f"2e-4 x max(1, max |ref|), input cotangents (tol 1e-3) and gradient "
        f"L2 (tol 1e-3) "
        f"{ {k: float(f'{v:.3e}') for k, v in full28.items()} }; max "
        f"|kernel - plain| "
        f"{ {k: float(f'{kerr[k]:.4g}') for k in nurbs_names} }; ms "
        f"{ {k: round(ms[k], 4) for k in nurbs_names} }; plain ms (2^22-ray "
        f"chunks) { {k: round(plain_ms[k], 2) for k in nurbs_names} }; "
        f"bounds ms "
        f"{ {k: round(bound_ms_of(*work[k]), 4) for k in nurbs_names} }; "
        f"phase 28 wall {time.perf_counter() - t28:.1f} s")

    # ---- the kernels line ----
    replaces = {
        "prng_disk": "optiland_tpu/ops/pallas_trace.py:1100",
        "merit_fwd": "optiland_tpu/ops/pallas_trace.py:1145",
        "merit_bwd": "optiland_tpu/ops/pallas_trace.py:1196",
        "trace_field_fwd": "optiland_tpu/ops/pallas_trace.py:803",
        "trace_field_bwd": "optiland_tpu/ops/pallas_trace.py:847",
        "trace_fwd": "optiland_tpu/ops/pallas_trace.py:538",
        "trace_bwd": "optiland_tpu/ops/pallas_trace.py:622",
        "trace_fwd_poly": "optiland_tpu/ops/pallas_trace.py:538",
        "trace_bwd_poly": "optiland_tpu/ops/pallas_trace.py:622",
        "huygens_fwd": "optiland_tpu/ops/pallas_huygens.py:91",
        "huygens_bwd_img": "optiland_tpu/ops/pallas_huygens.py:178",
        "huygens_bwd_pup": "optiland_tpu/ops/pallas_huygens.py:204",
        "pol_fwd": "optiland_tpu/ops/pallas_pol.py:465",
        "pol_fwd_intensity": "optiland_tpu/ops/pallas_pol.py:465",
        "pol_bwd": "optiland_tpu/ops/pallas_pol.py:529",
        "pol_bwd_intensity": "optiland_tpu/ops/pallas_pol.py:529",
    }
    sources = {k: "optiland_torch/csrc/fused_trace.cu"
               for k in ("prng_disk", "merit_fwd", "merit_bwd")}
    sources.update({k: "optiland_torch/csrc/fast_trace.cu" for k in
                    ("trace_field_fwd", "trace_field_bwd", "trace_fwd",
                     "trace_bwd", "trace_fwd_poly", "trace_bwd_poly")})
    sources.update({k: "optiland_torch/csrc/huygens.cu" for k in hu.LAUNCHES})
    sources.update({k: "optiland_torch/csrc/pol_trace.cu"
                    for k in POL_NAMES})
    kernels = []
    # every kernel of the paths, the builds the tilted, asphere, freeform
    # and deep paths launch (TILT, SAG, FREE, DEEP: compiled apart from the
    # stock ones) as kernels of their own
    for name in ("merit_fwd", "merit_bwd", "prng_disk", "trace_field_fwd",
                 "trace_field_bwd", "trace_fwd", "trace_bwd", "trace_fwd_poly",
                 "trace_bwd_poly", *hu.LAUNCHES, *POL_NAMES,
                 "merit_fwd_tilt", "merit_bwd_tilt", "trace_field_fwd_tilt",
                 "trace_field_bwd_tilt", "trace_fwd_tilt", "trace_bwd_tilt",
                 "pol_fwd_intensity_tilt", "pol_bwd_intensity_tilt",
                 *k6_names, *free_names, *aux_names, *grat_names,
                 *nurbs_names):
        # a row of an aux-bearing family (phase 24), a grating lens (phase
        # 26) or a NURBS lens (phase 28) counts the launches of its own
        # paths
        fam = next((f for f in freeform.AUX_FAMILIES + GRAT_NAMES
                    + NURBS_TAGS if name.endswith("_" + f)), None)
        key = name if fam is None else name.removesuffix("_" + fam)
        base_name = key.removesuffix(max(
            (suf for suf in BUILD_SUFFIX.values() if suf and key.endswith(suf)),
            key=len,
            default=""))
        ops, nbytes = work[name]
        t_ops = ops / PEAK_F32_OPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        n_launch = sum(c[key] for p_, c in path_launches.items()
                       if fam is None or p_.startswith(fam + "_"))
        check(n_launch > 0, f"kernel {name} was not launched on any path")
        source = sources[base_name]
        if key.endswith("_nurbs"):  # the nurbs build's own sources
            source = NURBS_SOURCES[base_name.split("_")[0]]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces[base_name], "launches": n_launch,
            "max_abs_err": kerr[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
    report["kernels"] = kernels
    report["path_launches"] = path_launches
    report["work"] = {k: {"ops": v[0], "bytes": v[1]} for k, v in work.items()}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
