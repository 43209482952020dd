#!/usr/bin/env python3
"""Compare two trees of optiland_torch on one CUDA card: the ptxas lines
of their kernels and the times of their merit and trace kernels.

  python3 tools/torch_build_compare.py build ROOT OUT
      build ROOT's kernels (``ops/_cuda.py``, into ROOT's build directory)
      and write the tree's build names and nvcc's log to OUT;
  python3 tools/torch_build_compare.py ptxas OLD NEW
      match the kernels of two such logs by name, type, template flags
      (trailing false flags dropped) and build name (whatever number each
      tree gives a build) and print
      how many have the same registers, stack frame and spills;
  python3 tools/torch_build_compare.py sass OLD NEW
      match the functions of the two logs' libraries in the same way and
      print how many have the same machine code (``cuobjdump -sass``, the
      hex encodings and the anonymous namespaces' hashes left out): the
      exact check, where equal ptxas lines may still hide other code;
  python3 tools/torch_build_compare.py time ROOT TAG [--aux]
      time merit_fwd, merit_bwd, trace_fwd, trace_bwd, trace_field_fwd and
      trace_field_bwd of ROOT at 2^24 rays, float32 (median of 10 CUDA
      event timings after one warm-up), on the tilted asphere (sag build),
      ObjectiveUS008879901 (deep), and the XY and toroidal singlets
      (free); with ``--aux`` on the Zernike, Qbfs and Q2d singlets in the
      aux build and forced to the deep_aux build, in the order aux,
      deep_aux, deep_aux, aux. Prints one line per system and writes
      ``chiprun_out/compare_<TAG>.json``.

To compare a commit with its parent, unpack the parent into a directory
that .gitignore lists (``git archive``), build both at once, then time
parent, change, change, parent in one call. The trees' own wrappers are
used; an older tree without ``launch.kernel_tables`` gets its stack's
coefficient table.
"""

import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build(root, out):
    sys.path.insert(0, os.path.abspath(root))
    from optiland_torch.ops import _cuda
    from optiland_torch.ops import launch

    suffix = launch.BUILD_SUFFIX
    names = dict(suffix.items() if isinstance(suffix, dict)
                 else enumerate(suffix))
    lib = _cuda.library()
    with open(out, "w") as f:
        f.write("builds " + json.dumps(
            {b: s[1:] or "stock" for b, s in names.items()}) + "\n")
        f.write(f"library {os.path.abspath(lib._name)}\n")
        f.write(f"nvcc {_cuda.BUILD_SECONDS:.1f} s\n" + _cuda.BUILD_LOG)
    print(root, "built in", round(_cuda.BUILD_SECONDS, 1), "s", flush=True)


# an anonymous namespace's mangled name: its hashes differ between trees
ANON = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_(\d+_\w+?_cu)_[0-9a-f]{8}")


def kernel_key(mangled, names):
    """(kernel, type, template flags, build name) of a mangled kernel name,
    or the name without its namespace's hashes for another function."""
    mm = re.search(r"\d([a-z_]+_kernel)I([fd])((?:L[bi]\d+E)*)E", mangled)
    if mm is None:
        return ANON.sub(r"ANON_\1", mangled)
    name, targs = mm.group(1), re.findall(r"L[bi]\d+", mm.group(3))
    if name.startswith(("trace_", "pol_", "merit_")) and targs:
        targs[-1] = names.get(int(targs[-1][2:]), targs[-1])
    else:
        # a template flag added later, false by default, leaves the kernel
        # the tree without it had
        while targs and targs[-1] == "Lb0":
            targs.pop()
    return (name, mm.group(2), tuple(targs))


def parse(path):
    """{(kernel, type, template flags, build name): ptxas lines}."""
    entries, cur, names = {}, None, {}
    for line in open(path):
        if line.startswith("builds "):
            names = {int(k): v for k, v in json.loads(line[7:]).items()}
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = kernel_key(m.group(1), names)
            entries[cur] = []
        elif cur is not None and ("registers" in line
                                  or "stack frame" in line):
            entries[cur].append(re.sub(
                r"\d+ bytes cmem\[\d\]", "",
                line.strip().replace("ptxas info    : ", "")))
    return entries


def ptxas(old, new):
    a, b = parse(old), parse(new)
    same, diffs = 0, []
    for k, v in a.items():
        if k not in b:
            diffs.append(f"missing in {new}: {k}")
        elif v == b[k]:
            same += 1
        else:
            diffs.append(f"differs {k}: {v} -> {b[k]}")
    print(f"ptxas: {same} kernels identical, {len(diffs)} differ or are "
          f"missing, {sum(k not in a for k in b)} only in {new}")
    for line in diffs:
        print("  " + line)


def sass_of(log):
    """{(source, function key): machine code lines} of a log's library."""
    names, lib = {}, None
    for line in open(log):
        if line.startswith("builds "):
            names = {int(k): v for k, v in json.loads(line[7:]).items()}
        elif line.startswith("library "):
            lib = line.split(" ", 1)[1].strip()
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            src = ANON.search(m.group(1))
            cur = (src.group(1) if src else "", kernel_key(m.group(1), names))
            funcs[cur] = []
        elif cur is not None and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            code = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", line)
            funcs[cur].append(ANON.sub(r"ANON_\1", code).strip())
    return funcs


def sass(old, new):
    a, b = sass_of(old), sass_of(new)
    same = [k for k in a if k in b and a[k] == b[k]]
    diff = [k for k in a if k in b and a[k] != b[k]]
    gone = [k for k in a if k not in b]
    print(f"sass: {len(same)} functions identical, {len(diff)} differ, "
          f"{len(gone)} missing in {new}, {sum(k not in a for k in b)} only "
          f"in {new}")
    for k in diff:
        i = next((i for i, (x, y) in enumerate(zip(a[k], b[k])) if x != y),
                 min(len(a[k]), len(b[k])))
        n = sum(x != y for x, y in zip(a[k], b[k]))
        print(f"  differs {k}: {len(a[k])} -> {len(b[k])} instructions, "
              f"{n} differ, the first: {a[k][i:i + 1]} -> {b[k][i:i + 1]}")
    for k in gone:
        print(f"  missing {k}")


def time_tree(root, tag, aux):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from optiland_torch import config
    from optiland_torch.core import raygen
    from optiland_torch.ops import fast_trace as ftr
    from optiland_torch.ops import fused_trace as ft
    from optiland_torch.ops import launch
    from optiland_torch.samples import freeform, perturbed, registry

    config.set_device("cuda")
    config.set_precision("float32")
    R = 1 << 24
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def tables(system):
        if hasattr(launch, "kernel_tables"):
            return launch.kernel_tables(system, torch.float32)
        return system.stack.coeffs.contiguous(), None

    def time_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            ts.append(e0.elapsed_time(e1))
        return sorted(ts)[len(ts) // 2]

    def kernels(system, field):
        wl = float(system.wavelengths[system.cfg.primary_index])
        with torch.no_grad():
            pk = ft.build_param_table(system, wl).contiguous()
            ak = ft.aim_vector(system, *field).contiguous()
            Px, Py = ft.prng_disk(8, R, 0, torch.float32, dev)
            rays = raygen.generate_rays(system, *field, Px, Py, wl)
            ins = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
            del rays
            cots = [torch.randn(R, generator=gen, device=dev) / R
                    for _ in range(8)]
            ck, lk = tables(system)
            lay = () if lk is None else (lk,)
            mlay = {} if lk is None else {"lay": lk}
            nc = ck.shape[1]
            spec = ftr.fast_spec(system, field=True)
            mspec = ft._spec_of(system)
            rows = ft.merit_fwd(pk, ak, mspec, R, seed=9, coeffs=ck, **mlay)
            _, xb, yb = ft._chan_combine(rows, R)
            st = torch.stack([xb, yb, torch.tensor(1.0 / R, device=dev),
                              torch.zeros((), device=dev)])
            res = {
                "merit_fwd": time_ms(lambda: ft.merit_fwd(
                    pk, ak, mspec, R, seed=9, coeffs=ck, **mlay)),
                "merit_bwd": time_ms(lambda: ft.merit_bwd(
                    pk, ak, st, mspec, nc, R, seed=9, coeffs=ck, **mlay)),
                "trace_fwd": time_ms(lambda: ftr.trace_fwd(
                    pk, spec, ins, ck, *lay)),
                "trace_bwd": time_ms(lambda: ftr.trace_bwd(
                    pk, spec, nc, ins, cots, ck, *lay)),
                "trace_field_fwd": time_ms(lambda: ftr.trace_field_fwd(
                    pk, ak, spec, Px, Py, ck, *lay)),
                "trace_field_bwd": time_ms(lambda: ftr.trace_field_bwd(
                    pk, ak, spec, nc, Px, Py, cots, ck, *lay)),
            }
        torch.cuda.synchronize()
        return res

    out = {}
    if not aux:
        for name, make, field in (
                ("tilted_asphere", perturbed.tilted_asphere, (0.0, 0.0)),
                ("objective26", lambda: registry.build_sample(
                    "ObjectiveUS008879901"), (0.0, 0.7)),
                ("polynomial", lambda: freeform.freeform_singlet(
                    "polynomial"), freeform.H),
                ("toroidal", lambda: freeform.freeform_singlet("toroidal"),
                 freeform.H)):
            out[name] = kernels(make().system, field)
    else:
        least = launch.build_of

        def deep(*a, **k):
            b = least(*a, **k)
            return launch.DEEP_AUX if b == launch.AUX else b

        for rep, order in enumerate(((False, True), (True, False))):
            for forced in order:
                ft.build_of = ftr.build_of = deep if forced else least
                for fam in freeform.AUX_FAMILIES:
                    ft.reset_launch_counts()
                    ftr.reset_launch_counts()
                    r = kernels(freeform.freeform_singlet(fam).system,
                                freeform.H)
                    r["launched"] = [k for k, v in {**ft.LAUNCHES,
                                                    **ftr.LAUNCHES}.items()
                                     if v]
                    build = "deep_aux" if forced else "aux"
                    out[f"{fam}_{build}_{rep}"] = r
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"compare_{tag}.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    for k, v in out.items():
        print(tag, k, {kk: round(vv, 4) if isinstance(vv, float) else vv
                       for kk, vv in v.items()}, flush=True)


def main(argv):
    if len(argv) >= 3 and argv[0] == "build":
        build(argv[1], argv[2])
    elif len(argv) == 3 and argv[0] == "ptxas":
        ptxas(argv[1], argv[2])
    elif len(argv) == 3 and argv[0] == "sass":
        sass(argv[1], argv[2])
    elif len(argv) >= 3 and argv[0] == "time":
        time_tree(argv[1], argv[2], "--aux" in argv[3:])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
