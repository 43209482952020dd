#!/usr/bin/env python3
"""Where the time of one optiland_torch optimizer step goes, on a CUDA card.

The step is one of the paths of ``chip_smoke.py``, chosen by ``--path``:
the value and gradient, with respect to every stack leaf of the Cooke
triplet (float32, field (0, 0.7), 0.55 um), of

  * ``merit`` (the default): ``spot_rms_fast_field``, in-kernel PRNG pupil;
  * ``generic``: ``analysis.spot.rms_spot_size`` (generate_rays, then the
    trace on the trace_fwd/trace_bwd kernels), pupil samples from
    ``prng_disk``;
  * ``field``: the mean squared spot radius of ``trace_fast_field`` (the
    trace_field_fwd/trace_field_bwd kernels), pupil samples from
    ``prng_disk``;
  * ``huygens``: the centre pixel (Strehl) of ``psf.huygens_psf`` at its
    defaults (128 x 128 image points, 12,644 pupil points): wavefronts and
    image grid on the trace kernels, field sums on the Huygens kernels;
  * ``pol``: ``bench.py``'s polarized step on its Fresnel-coated N-BK7
    singlet (H polarization) instead of the Cooke triplet: the spread of
    (x i, y i) with the exit intensity formed in the kernel
    (``trace_fast_pol_intensity``: pol_fwd_intensity, pol_bwd_intensity),
    pupil samples from ``prng_disk``, gradient over the singlet's stack
    leaves.

This script reports, for that step:

  * the median wall time of the step (CUDA events, as in chip_smoke.py);
  * the same step split into its parts with a synchronize after each
    (the launch side alone: the param table and aim vector, for the
    generic and polarized paths generate_rays, for the Huygens path the two
    wavefronts and the image grid; the whole forward; the backward), host
    clock;
  * from ``torch.profiler`` over a few steps: the device time per step
    summed over all kernels, the device idle share of the step, the number
    of kernel launches, host syncs (``cudaStreamSynchronize``) and memcpy
    calls per step, and the kernels with the most device time.

Run on the card from the repository root:

    python3 tools/profile_torch_step.py [--path merit] [--log2 24] [--steps 10]

``--root DIR`` profiles the optiland_torch of another checkout instead
(for instance the parent commit unpacked with ``git archive``), so two
versions can be compared in one run. It prints one JSON line last and
writes a Chrome trace to ``chiprun_out/profile_torch_step.json`` (with
``-<path>`` for another path than the merit, and ``-<basename of DIR>``
for another checkout, before ``.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("merit", "generic", "field", "huygens",
                                       "pol"),
                    default="merit", help="which step is profiled")
    ap.add_argument("--log2", type=int, default=24, help="log2 of the rays")
    ap.add_argument("--steps", type=int, default=10, help="profiled steps")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose optiland_torch is profiled (to "
                         "compare two versions in one run)")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)

    import torch

    if not torch.cuda.is_available():
        print("profile_torch_step: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    from optiland_torch import config
    from optiland_torch.ops import fused_trace as ft
    from optiland_torch.samples import CookeTriplet

    if args.path != "merit":
        from optiland_torch.analysis import rms_spot_size
        from optiland_torch.core import raygen
        from optiland_torch.ops import fast_trace as ftr
        from optiland_torch.ops import pol_trace as pt
        from optiland_torch.psf import huygens_fresnel as hf
        from optiland_torch.wavefront import compute_wavefront_data

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(card, flush=True)

    config.set_device("cuda")
    config.set_precision("float32")
    R = 1 << args.log2
    H, WL = (0.0, 0.7), 0.55
    if args.path == "pol":
        from optiland_torch.polarization import create_polarization
        from optiland_torch.samples.polarized import bench_polarized

        state = create_polarization("H")
        base = bench_polarized().system
    else:
        base = CookeTriplet().system
    n_surf = base.cfg.num_surfaces - 1
    stack = base.stack

    def system_of():
        """The system with every stack leaf a fresh tensor that requires
        grad, as chip_smoke.py's timed steps take them."""
        leaves = {k: v.detach().clone().requires_grad_(v.numel() > 0)
                  for k, v in stack.leaves().items()}
        return base.replace(stack=stack.replace(**leaves))

    def pupil(i):
        return ft.prng_disk(i, R, 0, torch.float32, "cuda")

    def launch_side(sysk, i):
        """The path's launch side alone, under autograd."""
        if args.path in ("generic", "pol"):
            return raygen.generate_rays(sysk, *H, *pupil(i), WL)
        if args.path == "huygens":
            xg, yg, mask = hf.pupil_grid_coords(128)
            return (compute_wavefront_data(sysk, *H, WL, xg[mask], yg[mask]),
                    compute_wavefront_data(sysk, 0.0, 0.0, WL, xg[mask],
                                           yg[mask]),
                    hf._image_grid(sysk, *H, WL, 128))
        return ft.build_param_table(sysk, WL), ft.aim_vector(sysk, *H)

    def forward(i):
        if args.path == "merit":
            return ft.spot_rms_fast_field(system_of(), *H, WL, num_rays=R,
                                          seed=i)
        if args.path == "generic":
            return rms_spot_size(system_of(), *H, *pupil(i), WL)
        if args.path == "huygens":
            return hf.huygens_psf(system_of(), *H, WL)[0][64, 64] / 100
        if args.path == "pol":
            sysk = system_of()
            rays = raygen.generate_rays(sysk, *H, *pupil(i), WL)
            out = pt.trace_fast_pol_intensity(sysk, rays, WL, state=state)
            x, y = out.x * out.i, out.y * out.i
            return ((x - x.mean()) ** 2 + (y - y.mean()) ** 2).mean()
        f = ftr.trace_fast_field(system_of(), *H, *pupil(i), WL)
        return ((f.x - f.x.mean()) ** 2 + (f.y - f.y.mean()) ** 2).mean()

    def step(i):
        forward(i).backward()

    for i in range(3):
        step(10_000 + i)
    torch.cuda.synchronize()

    # whole step, CUDA events
    walls = []
    for i in range(args.steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        step(i)
        e1.record()
        e1.synchronize()
        walls.append(e0.elapsed_time(e1))
    wall_ms = float(np.median(walls))

    # the same step in parts, synchronized after each: the launch side
    # alone (under autograd), then the whole forward (which builds it
    # again), then the backward
    parts = {"launch_side_fwd": [], "forward": [], "backward": []}
    for i in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        launch_side(system_of(), 20_000 + i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss = forward(20_000 + i)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts["launch_side_fwd"].append((t1 - t0) * 1e3)
        parts["forward"].append((t2 - t1) * 1e3)
        parts["backward"].append((t3 - t2) * 1e3)
    parts_ms = {k: float(np.median(v)) for k, v in parts.items()}

    # profiler: device time, idle share, launches
    from torch.profiler import ProfilerActivity, profile

    n_prof = min(args.steps, 5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for i in range(n_prof):
            step(30_000 + i)
        e1.record()
        e1.synchronize()
    prof_wall = e0.elapsed_time(e1) / n_prof
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    suffix = "" if args.path == "merit" else f"-{args.path}"
    suffix += "" if root == ROOT else f"-{os.path.basename(root)}"
    trace_path = os.path.join(ROOT, "chiprun_out",
                              f"profile_torch_step{suffix}.json")
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    runtime = [e.get("name", "") for e in events
               if e.get("cat") == "cuda_runtime"]
    syncs = sum(n == "cudaStreamSynchronize" for n in runtime) / n_prof
    copies = sum(n.startswith("cudaMemcpy") for n in runtime) / n_prof
    if not kernels:
        print("profile_torch_step: the trace holds no kernel events",
              file=sys.stderr)
        return 1
    dev_us = sum(float(e["dur"]) for e in kernels) / n_prof
    by_name = {}
    for e in kernels:
        d = by_name.setdefault(e["name"], [0.0, 0])
        d[0] += float(e["dur"]) / n_prof
        d[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]

    print(f"optiland_torch from {os.path.dirname(os.path.dirname(ft.__file__))}"
          f", {args.path} path; step wall {wall_ms:.3f} ms (median of "
          f"{args.steps}); "
          + ("" if args.path == "huygens" else
             f"ray-surf/s {R * n_surf / (wall_ms * 1e-3):.4e}; ")
          + f"idle share of the "
          f"unprofiled step {1 - dev_us / 1e3 / wall_ms:.3f}", flush=True)
    print("synchronized parts (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts_ms.items()), flush=True)
    print(f"profiled: wall {prof_wall:.3f} ms/step, device busy "
          f"{dev_us / 1e3:.3f} ms/step, idle share "
          f"{1 - dev_us / 1e3 / prof_wall:.3f}, kernel launches/step "
          f"{len(kernels) / n_prof:.1f}, host syncs/step {syncs:.1f}, "
          f"memcpy calls/step {copies:.1f}", flush=True)
    for name, (us, n) in top:
        print(f"  {us / 1e3:9.4f} ms/step  {n / n_prof:6.1f} launches/step  "
              f"{name[:90]}", flush=True)
    print(json.dumps({
        "card": card, "path": args.path, "rays": R, "step_ms": wall_ms, "step_ms_all": walls,
        "parts_ms": parts_ms, "profiled_step_ms": prof_wall,
        "device_ms_per_step": dev_us / 1e3,
        "idle_share": 1 - dev_us / 1e3 / prof_wall,
        "idle_share_unprofiled": 1 - dev_us / 1e3 / wall_ms,
        "launches_per_step": len(kernels) / n_prof,
        "host_syncs_per_step": syncs, "memcpy_calls_per_step": copies,
        "top_kernels_ms": {k: v[0] / 1e3 for k, v in top},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
