#!/usr/bin/env python3
"""Chip smoke test of optiland_torch's main path on one CUDA card.

Builds the CUDA kernels of ``optiland_torch/csrc`` with nvcc, holds each
kernel against its plain PyTorch version on the card, drives the optimizer
step of the Cooke triplet's fused RMS-spot merit at full width (2^24 rays,
float32, in-kernel PRNG pupil), and prints:

  * the card's name and power limit (nvidia-smi);
  * one line per phase, each raising on a failed check;
  * a ``{"kernels": [...]}`` JSON line: per kernel its time at the main
    path's shape, the plain version's time, its launches on the main path,
    and its bound (the larger of operations over the card's float32 peak
    and bytes over its memory rate);
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
    from optiland_torch.ops import _cuda
    from optiland_torch.ops import fused_trace as ft
    from optiland_torch.samples import CookeTriplet

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
        m = re.search(r"Compiling entry.*\d([a-z_]+_kernel)I([fd])E", line)
        if m:
            log(f"  ptxas: {m.group(1)}<{'float' if m.group(2) == 'f' else 'double'}>")
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
    ft.reset_launch_counts()
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
    launches = dict(ft.LAUNCHES)
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
    check(launches == {"prng_disk": 0, "merit_fwd": steps_run,
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

    # ---- phase 8: per-kernel times, plain times and bounds at full width --
    p32, a32 = tables(base)
    with torch.no_grad():
        rows_f = ft.merit_fwd(p32, a32, spec, Rf, seed=9)
        lf, xbf, ybf = ft._chan_combine(rows_f, Rf)
    stats32 = torch.stack([xbf, ybf, torch.tensor(1.0 / Rf, device=dev),
                           torch.zeros((), device=dev)])

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

    with torch.no_grad():
        # kernel vs plain at the main path's shapes (f32, PRNG, 2^24 rays)
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
        l2f = float(torch.linalg.vector_norm(fk.double() - fp.double())
                    / torch.linalg.vector_norm(fp.double()))
        check(l2f <= 1e-3, f"merit_bwd full width: L2 rel err {l2f} > 1e-3")
        del fp
        torch.cuda.synchronize()
        log(f"phase 8 full-width kernel vs plain (f32): prng_disk max |dP| "
            f"{kerr['prng_disk']:.2e}, merit_fwd loss rel err "
            f"{rel(lf, lp):.2e}, merit_bwd L2 rel err {l2f:.2e}")

        ms = {
            "prng_disk": time_ms(
                lambda i: ft.prng_disk(i, Rf, 0, torch.float32, dev), 10, 5),
            "merit_fwd": time_ms(
                lambda i: ft.merit_fwd(p32, a32, spec, Rf, seed=i), 10, 3),
            "merit_bwd": time_ms(
                lambda i: ft.merit_bwd(p32, a32, stats32, spec, nc, Rf,
                                       seed=i), 10, 3),
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
        }

    codes = spec[0][1:]
    n_std = sum(c == 1 for c in codes)
    n_pl = len(codes) - n_std
    nb_f = -(-Rf // ft.FWD_BLOCK)
    nb_b = min(-(-Rf // ft.BWD_BLOCK), ft.BWD_MAX_BLOCKS)
    ncomp = S * len(ft.GRAD_COLS) + ft.N_AIM
    table_bytes = (S * ft.NUM_P + ft.N_AIM + 2 * S) * 4
    work = {
        "prng_disk": (Rf * OPS_PRNG, Rf * 2 * 4),
        "merit_fwd": (Rf * (OPS_PRNG + OPS_LAUNCH + n_std * OPS_FWD_STANDARD
                            + n_pl * OPS_FWD_PLANE + OPS_STATS),
                      table_bytes + nb_f * 5 * 4),
        "merit_bwd": (Rf * (OPS_PRNG + OPS_LAUNCH + OPS_SEED + OPS_AIM_BWD
                            + n_std * OPS_BWD_STANDARD + n_pl * OPS_BWD_PLANE),
                      table_bytes + 16 + 2 * nb_b * ncomp * 4
                      + (S * (ft.NUM_P + nc) + ft.N_AIM) * 4),
    }
    replaces = {
        "prng_disk": "optiland_tpu/ops/pallas_trace.py:1100",
        "merit_fwd": "optiland_tpu/ops/pallas_trace.py:1145",
        "merit_bwd": "optiland_tpu/ops/pallas_trace.py:1196",
    }
    kernels = []
    for name in ("merit_fwd", "merit_bwd", "prng_disk"):
        ops, nbytes = work[name]
        t_ops = ops / PEAK_F32_OPS * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": "optiland_torch/csrc/fused_trace.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": kerr[name], "ms": ms[name],
            "plain_ms": plain_ms[name], "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
    for name in ("merit_fwd", "merit_bwd", "prng_disk"):
        ops, nbytes = work[name]
        b64 = max(ops / PEAK_F64_OPS, 2 * nbytes / PEAK_BYTES) * 1e3
        log(f"bound {name}: {ops / 1e9:.2f} Gop, {nbytes / 1e6:.1f} MB -> "
            f"f32 {max(ops / PEAK_F32_OPS, nbytes / PEAK_BYTES) * 1e3:.4f} ms,"
            f" f64 {b64:.4f} ms ("
            f"{'operations' if ops / PEAK_F64_OPS >= 2 * nbytes / PEAK_BYTES else 'bytes'})")
    report["kernels"] = kernels
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
