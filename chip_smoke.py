#!/usr/bin/env python3
"""Chip smoke test of optiland_torch's main path on one CUDA card.

Builds the CUDA kernels of ``optiland_torch/csrc`` with nvcc, holds each
kernel against its plain PyTorch version on the card, and drives three
paths of the Cooke triplet at full width (2^24 rays, float32), each with
the launch counts set to 0 just before it and read just after:

  * the merit path (phase 7): the optimizer step of the fused RMS-spot
    merit, ``spot_rms_fast_field``, in-kernel PRNG pupil (merit_fwd,
    merit_bwd);
  * the generic path (phase 10): the value and gradient of
    ``analysis.spot.rms_spot_size`` (generate_rays, then ``trace`` on the
    trace_fwd/trace_bwd kernels), pupil samples from prng_disk, and one
    ``Optic.trace`` of ~2^24 hexapolar rays;
  * the field path (phase 11): the value and gradient of the mean squared
    spot radius through ``trace_fast_field`` (trace_field_fwd,
    trace_field_bwd), as ``bench.py``'s ``pallas-field`` step.

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
    from optiland_torch.ops import _cuda
    from optiland_torch.ops import fast_trace as ftr
    from optiland_torch.ops import fused_trace as ft
    from optiland_torch.optic import Optic
    from optiland_torch.samples import CookeTriplet

    def reset_counts():
        ft.reset_launch_counts()
        ftr.reset_launch_counts()

    def counts():
        return {**ft.LAUNCHES, **ftr.LAUNCHES}

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
    for line in _cuda.BUILD_LOG.splitlines():
        m = re.search(r"Compiling entry.*\d([a-z_]+_kernel)I([fd])(Lb([01])E)?E",
                      line)
        if m:
            flag = "" if m.group(3) is None else (
                ", field" if m.group(4) == "1" else ", generic")
            log(f"  ptxas: {m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}"
                f"{flag}>")
        elif "registers" in line or "spill" in line or "error" in line:
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
        sysk, _ = system_of(r_inner)
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

    def time_ms(fn, reps, per_event=1):
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

    def near32(a, b, what, flips=0):
        """f32 ``a`` against ``b`` (f32 or f64), each array on its own:
        2e-4 x max(1, max|b|), and finite where ``b`` is; ``flips`` rays
        may differ in intensity (array 6), a ray whose radius falls within
        rounding of a clip edge being clipped in one only."""
        for j, (u, v) in enumerate(zip(a, b)):
            u, v = u.double(), v.double()
            check(torch.equal(torch.isfinite(u), torch.isfinite(v)),
                  f"{what}: array {j}: finite in one and not the other")
            bad = (u - v).abs() > 2e-4 * max(1.0, float(v.abs().max()))
            n = int(bad.sum())
            check(n <= (flips if j == 6 else 0),
                  f"{what}: array {j}: {n} rays off by more than 2e-4")

    def arr_err(a, b):
        """Largest |a - b| of each array over that array's largest |b|."""
        return max(float((u.double() - v.double()).abs().max())
                   / max(float(v.abs().max()), 1e-300) for u, v in zip(a, b))

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
            return float(torch.linalg.vector_norm(a.double() - b.double())
                         / torch.linalg.vector_norm(b.double()))

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

    def flat_err(a, b, rtol, what):
        """|a - b| <= rtol |b| + 1e-12 max|b| wherever b is finite; returns
        the worst relative error over the entries above 1e-6 max|b|."""
        fin = torch.isfinite(b)
        a, b = a[fin].double(), b[fin].double()
        scale = float(b.abs().max())
        d = (a - b).abs()
        check(bool((d <= rtol * b.abs() + 1e-12 * scale).all()),
              f"{what}: max |d| {float(d.max()):.3e} (largest |ref| "
              f"{scale:.3e})")
        big = b.abs() > 1e-6 * scale
        return float((d[big] / b[big].abs()).max())

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
            sysk, _ = system_of(r_inner)
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

    # ---- the kernels line ----
    replaces = {
        "prng_disk": "optiland_tpu/ops/pallas_trace.py:1100",
        "merit_fwd": "optiland_tpu/ops/pallas_trace.py:1145",
        "merit_bwd": "optiland_tpu/ops/pallas_trace.py:1196",
        "trace_field_fwd": "optiland_tpu/ops/pallas_trace.py:803",
        "trace_field_bwd": "optiland_tpu/ops/pallas_trace.py:847",
        "trace_fwd": "optiland_tpu/ops/pallas_trace.py:538",
        "trace_bwd": "optiland_tpu/ops/pallas_trace.py:622",
    }
    sources = {k: "optiland_torch/csrc/fused_trace.cu"
               for k in ("prng_disk", "merit_fwd", "merit_bwd")}
    sources.update({k: "optiland_torch/csrc/fast_trace.cu" for k in
                    ("trace_field_fwd", "trace_field_bwd", "trace_fwd",
                     "trace_bwd")})
    kernels = []
    for name in ("merit_fwd", "merit_bwd", "prng_disk", "trace_field_fwd",
                 "trace_field_bwd", "trace_fwd", "trace_bwd"):
        ops, nbytes = work[name]
        t_ops = ops / PEAK_F32_OPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        n_launch = sum(c[name] for c in path_launches.values())
        check(n_launch > 0, f"kernel {name} was not launched on any path")
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": n_launch,
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
