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
  python3 tools/torch_build_compare.py mix LOG
      for the backwards of the main path (merit_bwd and trace_bwd in the
      stock and tilt builds), of the nurbs build (merit_bwd, trace_bwd
      in every mode, pol_bwd) and of the Newton builds (merit_bwd and
      trace_bwd in every mode in the sag, deep, free, deep_free, aux and
      deep_aux builds, float32), for the polarized kernels (pol_fwd and
      pol_bwd, both modes, in the stock, tilt and Newton builds,
      float32), and for the nurbs build's forwards
      (merit_fwd, trace_fwd in every mode, pol_fwd; both types) of a build
      log's library: the ptxas line (registers, stack frame, spills,
      static shared memory), the resident blocks per SM that the registers
      and shared memory allow at BWD_BLOCK threads (the dynamic shared
      memory of the per-thread and nurbs designs not counted: ``time``
      prints their launch shapes) or, for the forwards, at FWD_BLOCK with
      a golden NURBS lens's tables, and the static instruction mix of the
      machine code (SHFL, MUFU, LDL/STL, LDS/STS, FFMA/FADD/FMUL,
      DFMA/DADD/DMUL, CALL, all);
  python3 tools/torch_build_compare.py time ROOT TAG --nurbs [--kernels K,..]
                                                            [--f64]
      time the nurbs build's kernels of ROOT at 2^24 rays, float32 (with
      ``--f64`` float64, as ``--newton`` and the others take it too), on the
      golden rational and conic-fit lenses (samples/nurbs.py) at (0.3, 0.7):
      the six of ``time`` below, then on the rational lens trace_fwd_poly
      and trace_bwd_poly (wavelengths cycling by ray) and on its coated
      variant pol_fwd and pol_bwd in the intensity mode; ``--kernels``
      times only the named ones (a tree whose library holds only some
      sources, as a throwaway copy may);
  python3 tools/torch_build_compare.py time ROOT TAG --newton [--kernels K,..]
      time the Newton builds' kernels of ROOT at 2^24 rays, float32: the
      six of ``time`` below on the tilted asphere (sag build),
      ObjectiveUS008879901 (deep), the XY and toroidal singlets (free) and
      the Zernike, Qbfs and Q2d singlets (aux), and trace_fwd_poly and
      trace_bwd_poly (wavelengths 0.48, 0.55, 0.65 um cycling by ray) on
      the tilted asphere, the XY singlet and the Q2d singlet; ``--kernels``
      as for ``--nurbs``;
  python3 tools/torch_build_compare.py time ROOT TAG --pol [--kernels K,..]
                                                         [--systems S,..]
      time the polarized kernels of ROOT at 2^24 rays, float32: pol_fwd,
      pol_bwd, pol_fwd_intensity and pol_bwd_intensity (H) on bench.py's
      three polarized classes, phase 18's tilted singlet, phase 16's coated
      doublet at EPD 4 (brought to focus by ``Optic.image_solve`` where
      the tree has it), the Fresnel-coated asphere (sag build), a stack of
      eight Fresnel-coated plates (18 surfaces: deep build;
      ``samples/polarized.py: coated_plates``, where the tree has it), the
      coated XY singlet (free), the coated Zernike, Qbfs and Q2d singlets
      (aux) and the coated rational NURBS lens (nurbs), with pol_bwd's launch
      shape where the tree gives it (``pol_trace.pol_grid``);
      ``--systems`` times only the named ones (a tree with only some
      builds, as a throwaway copy may);
  python3 tools/torch_build_compare.py time ROOT TAG [--aux | --main]
      time merit_fwd, merit_bwd, trace_fwd, trace_bwd, trace_field_fwd and
      trace_field_bwd of ROOT at 2^24 rays, float32 (median of 10 CUDA
      event timings after one warm-up), on the main path's builds: the
      Cooke triplet (stock build), the toleranced Cooke triplet
      (samples/perturbed.py, tilt build), and bench.py's poly step on the
      Cooke triplet (trace_fwd_poly, trace_bwd_poly; wavelengths 0.48,
      0.55, 0.65 um cycling by ray); then on the tilted asphere (sag
      build), ObjectiveUS008879901 (deep), and the XY and toroidal
      singlets (free); with ``--main`` on the main path's builds only;
      with ``--aux`` on the Zernike, Qbfs and Q2d singlets in the aux build
      and forced to the deep_aux build, in the order aux, deep_aux,
      deep_aux, aux. Prints one line per system and writes
      ``chiprun_out/compare_<TAG>.json``.

To compare a commit with its parent, unpack the parent into a directory
that .gitignore lists (``git archive HEAD~1 | tar -x -C _archive/parent``),
then, in one run on the card, build both at once and time parent,
change, change, parent:

  python3 tools/torch_build_compare.py build _archive/parent chiprun_out/old.log &
  python3 tools/torch_build_compare.py build . chiprun_out/new.log; wait
  python3 tools/torch_build_compare.py sass chiprun_out/old.log chiprun_out/new.log
  for t in _archive/parent:parent .:change .:change _archive/parent:parent; do
    python3 tools/torch_build_compare.py time ${t%%:*} ${t##*:} --main; done

The trees' own wrappers are used; an older tree without
``launch.kernel_tables`` gets its stack's coefficient table.
"""

import json
import os
import re
import shutil
import subprocess
import sys
import time

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
# trailing false template flags of a mangled device function's name (a flag
# added later, false by default, leaves the function the tree without it
# had), in its key and where a kernel calls it
FALSE_TAIL = re.compile(r"(?:Lb0E)+E")


def kernel_key(mangled, names):
    """(kernel, type, template flags, build name) of a mangled kernel name,
    or the name without its namespace's hashes for another function."""
    mm = re.search(r"\d([a-z_]+_kernel)I([fd])((?:L[bi]\d+E)*)E", mangled)
    if mm is None:
        return FALSE_TAIL.sub("E", ANON.sub(r"ANON_\1", mangled))
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
            funcs[cur].append(FALSE_TAIL.sub(
                "E", ANON.sub(r"ANON_\1", code)).strip())
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


# the main path's backwards, whose machine code ``mix`` counts: the merit and
# trace kernels' stock and tilt builds
MIX_KERNELS = ("merit_bwd_kernel", "trace_bwd_kernel", "pol_bwd_kernel")
# the polarized kernels, whose machine code ``mix`` counts in f32 in every
# build but nurbs (whose pol_bwd it counts in both types with the others)
POL_KERNELS = ("pol_fwd_kernel", "pol_bwd_kernel")
# the Newton builds, whose merit and trace backwards ``mix`` counts in f32
NEWTON_BUILDS = ("sag", "deep", "free", "deep_free", "aux", "deep_aux")
# the nurbs build's forwards (merit_fwd; trace_fwd, trace_field_fwd and
# trace_fwd_poly; pol_fwd in both modes), which ``mix`` counts in both types
# at FWD_BLOCK threads with the golden lenses' tables in dynamic shared
# memory (4 surfaces, nc = 196, a knot table of 6 rows)
FWD_KERNELS = ("merit_fwd_kernel", "trace_fwd_kernel", "pol_fwd_kernel")
MIX_CLASSES = {"SHFL": ("SHFL",), "MUFU": ("MUFU",), "LDL/STL": ("LDL", "STL"),
               "LDS/STS": ("LDS", "STS"), "FFMA/FADD/FMUL": ("FFMA", "FADD",
                                                             "FMUL"),
               "DFMA/DADD/DMUL": ("DFMA", "DADD", "DMUL"), "CALL": ("CALL",)}


def golden_tables(size):
    """Dynamic shared memory of a nurbs forward on a golden NURBS lens, by
    the launch side of this tree (before its knot table had a tail: the
    nets and knot rows of 4 surfaces)."""
    sys.path.insert(0, HERE)
    from optiland_torch.ops import launch

    if hasattr(launch, "nurbs_bytes"):
        import torch

        return launch.nurbs_bytes(4, 196, 6, {4: torch.float32,
                                              8: torch.float64}[size])
    return 4 * (196 + launch.NU_KT) * size


def mix(log):
    names = {}
    for line in open(log):
        if line.startswith("builds "):
            names = {int(k): v for k, v in json.loads(line[7:]).items()}
    lines = parse(log)
    code = sass_of(log)
    for (src, key), instrs in sorted(code.items(), key=str):
        fwd = (isinstance(key, tuple) and key[0] in FWD_KERNELS and key[2]
               and key[2][-1] == "nurbs")
        pol = (isinstance(key, tuple) and key[0] in POL_KERNELS
               and key[1] == "f" and key[2] and key[2][-1] in (
                   ("stock", "tilt") + NEWTON_BUILDS))
        if not fwd and not pol and not (
                isinstance(key, tuple) and key[0] in MIX_KERNELS
                and key[2] and (key[2][-1] in (
                    ("nurbs",) if key[0] == "pol_bwd_kernel"
                    else ("stock", "tilt", "nurbs"))
                    or (key[0] != "pol_bwd_kernel" and key[1] == "f"
                        and key[2][-1] in NEWTON_BUILDS))):
            continue
        ops = [re.sub(r"^@!?U?P\w+\s+", "", i.split(";")[0].split("*/", 1)[-1]
                      .strip()).split(" ")[0].split(".")[0] for i in instrs]
        counts = {c: sum(o in ops_ for o in ops)
                  for c, ops_ in MIX_CLASSES.items()}
        counts["all"] = len(ops)
        ptx = " | ".join(lines.get(key, []))
        regs = re.search(r"Used (\d+) registers", ptx)
        smem = re.search(r"(\d+) bytes smem", ptx)
        per_sm = None
        threads = 256 if fwd or (pol and key[0] == "pol_fwd_kernel") \
            else 128
        dyn = golden_tables(4 if key[1] == "f" else 8) if fwd else 0
        if regs:
            # registers go to a warp in units of 256, 64K on an SM; 228 KB
            # of shared memory, 1 KB of it reserved for each block
            per_warp = -(-int(regs.group(1)) * 32 // 256) * 256
            warps = threads // 32
            per_sm = min(65536 // per_warp // warps, 64 // warps, 32,
                         233472 // ((int(smem.group(1)) if smem else 0)
                                    + dyn + 1024))
        print(f"mix {src} {key}: {ptx}; resident blocks per SM at {threads} "
              f"threads from registers and static smem"
              f"{f' and {dyn} B of dynamic' if fwd else ''} {per_sm}; "
              f"instructions {counts}", flush=True)


def time_tree(root, tag, aux, main=False, nurbs=False, only=None,
              newton=False, f64=False, pol=False, systems=None):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from optiland_torch import config
    from optiland_torch.core import raygen
    from optiland_torch.ops import fast_trace as ftr
    from optiland_torch.ops import fused_trace as ft
    from optiland_torch.ops import launch
    from optiland_torch.samples import freeform, perturbed

    config.set_device("cuda")
    config.set_precision("float64" if f64 else "float32")
    dt = torch.float64 if f64 else torch.float32
    R = 1 << 24
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)

    def tables(system):
        if hasattr(launch, "kernel_tables"):
            return launch.kernel_tables(system, dt)
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

    t_start = time.perf_counter()

    def timed(res):
        """{name: ms} of the {name: fn} in ``res`` that ``only`` names,
        each reported on stderr as it is timed."""
        out = {}
        for k, fn in res.items():
            if only is None or k in only:
                out[k] = time_ms(fn)
                print(f"{tag} {k} {out[k]:.4f} ms at "
                      f"{time.perf_counter() - t_start:.1f} s",
                      file=sys.stderr, flush=True)
        return out

    def kernels(system, field):
        wl = float(system.wavelengths[system.cfg.primary_index])
        with torch.no_grad():
            pk = ft.build_param_table(system, wl).contiguous()
            ak = ft.aim_vector(system, *field).contiguous()
            Px, Py = ft.prng_disk(8, R, 0, dt, dev)
            rays = raygen.generate_rays(system, *field, Px, Py, wl)
            ins = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
            del rays
            cots = [torch.randn(R, generator=gen, device=dev, dtype=dt) / R
                    for _ in range(8)]
            ck, lk = tables(system)
            lay = () if lk is None else (lk,)
            mlay = {} if lk is None else {"lay": lk}
            nc = ck.shape[1]
            spec = ftr.fast_spec(system, field=True)
            mspec = ft._spec_of(system)
            rows = ft.merit_fwd(pk, ak, mspec, R, seed=9, coeffs=ck, **mlay)
            _, xb, yb = ft._chan_combine(rows, R)
            st = torch.stack([xb, yb,
                              torch.tensor(1.0 / R, device=dev, dtype=dt),
                              torch.zeros((), device=dev, dtype=dt)])
            res = timed({
                "merit_fwd": lambda: ft.merit_fwd(
                    pk, ak, mspec, R, seed=9, coeffs=ck, **mlay),
                "merit_bwd": lambda: ft.merit_bwd(
                    pk, ak, st, mspec, nc, R, seed=9, coeffs=ck, **mlay),
                "trace_fwd": lambda: ftr.trace_fwd(pk, spec, ins, ck, *lay),
                "trace_bwd": lambda: ftr.trace_bwd(
                    pk, spec, nc, ins, cots, ck, *lay),
                "trace_field_fwd": lambda: ftr.trace_field_fwd(
                    pk, ak, spec, Px, Py, ck, *lay),
                "trace_field_bwd": lambda: ftr.trace_field_bwd(
                    pk, ak, spec, nc, Px, Py, cots, ck, *lay),
            })
            if nurbs and (only is None or any("bwd" in k for k in only)):
                res["shapes"] = shapes(spec, mspec, nc, lk)
        torch.cuda.synchronize()
        return res

    def shapes(spec, mspec, nc, lk):
        """(block, blocks, dynamic bytes) of the nurbs backwards' launches,
        where the tree's bwd_grid takes the nurbs build's shape (and, where
        it takes them, the knot table's rows and the NURBS surfaces)."""
        import inspect

        params = inspect.signature(launch.bwd_grid).parameters
        if "ncomp" not in params:
            return None
        from optiland_torch.ops.step import FULL_GRAD_COLS, GRAD_COLS

        S = len(spec[0])
        out = {}
        for name, mode, sp, build, slots, extra in (
                ("merit_bwd", "merit", mspec, ft._build(mspec), GRAD_COLS,
                 launch.N_AIM),
                ("trace_bwd", "generic", spec, ftr._build(spec),
                 FULL_GRAD_COLS, 0),
                ("trace_bwd", "field", spec, ftr._build(spec),
                 FULL_GRAD_COLS, launch.N_AIM)):
            grat = sp[3] if mode == "merit" else ftr._grat(sp)
            ncomp = (S * len(slots) + extra
                     + launch.sag_columns(sp[0], nc, build, grat))
            tables = {"kt": launch.knot_rows(lk), "ns": len(
                launch.sag_surfaces(sp[0], build, grat))} if "kt" in params \
                else {}
            out[f"{name}_{mode}"] = launch.bwd_grid(
                name, mode, S, 0, dt, build, R, dev, nc=nc,
                ncomp=ncomp, **tables)
        return out

    def nurbs_poly_pol(system, coated):
        """The rational lens's poly kernels and its coated variant's
        polarized ones (intensity mode), with their tables."""
        from optiland_torch.ops import pol_trace as pt
        from optiland_torch.polarization import create_polarization

        wl = torch.tensor((0.48, 0.55, 0.65), device=dev, dtype=dt)[
            torch.arange(R, device=dev) % 3]
        with torch.no_grad():
            ck, lk = tables(system)
            nc = ck.shape[1]
            pk = ftr.build_poly_table(system).contiguous()
            mk = system.stack.mat_coeffs.detach().contiguous()
            Px, Py = ft.prng_disk(17, R, 0, dt, dev)
            rays = raygen.generate_rays(system, 0.3, 0.7, Px, Py, 0.55)
            ins = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
            del rays
            cots = [torch.randn(R, generator=gen, device=dev, dtype=dt) / R
                    for _ in range(8)]
            spec = ftr.poly_spec(system)
            res = timed({
                "trace_fwd_poly": lambda: ftr.trace_fwd_poly(
                    pk, mk, spec, ins + [wl], ck, lk),
                "trace_bwd_poly": lambda: ftr.trace_bwd_poly(
                    pk, mk, spec, nc, ins + [wl], cots, ck, lk),
            })
            wl0 = float(coated.wavelengths[coated.cfg.primary_index])
            pq = ft.build_param_table(coated, wl0).contiguous()
            rays = raygen.generate_rays(coated, 0.3, 0.7, Px, Py, wl0)
            ins = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
            del rays
            pspec = pt.pol_spec(coated, wl0)
            coat = pt.build_coat_table(coated, wl0, dt, dev)
            states = pt.pol_states(create_polarization("H"))
            cc, lc = tables(coated)
            res.update(timed({
                "pol_fwd_intensity": lambda: pt.pol_fwd(
                    pq, coat, pspec, ins, states, True, cc, lc),
                "pol_bwd_intensity": lambda: pt.pol_bwd(
                    pq, coat, pspec, cc.shape[1], ins, cots, states, True,
                    cc, lc),
            }))
        torch.cuda.synchronize()
        return res

    def poly_kernels(system, field=(0.0, 0.7)):
        # bench.py's poly step: the system's rays, wavelengths cycling by
        # ray
        wl = torch.tensor((0.48, 0.55, 0.65), device=dev, dtype=dt)[
            torch.arange(R, device=dev) % 3]
        with torch.no_grad():
            pk = ftr.build_poly_table(system).contiguous()
            mk = system.stack.mat_coeffs.detach().contiguous()
            Px, Py = ft.prng_disk(17, R, 0, dt, dev)
            rays = raygen.generate_rays(system, *field, Px, Py, 0.55)
            ins = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
            ins.append(wl)
            del rays, Px, Py
            cots = [torch.randn(R, generator=gen, device=dev, dtype=dt) / R
                    for _ in range(8)]
            spec = ftr.poly_spec(system)
            ck, lk = tables(system)
            tab = (ck,) if lk is None else (ck, lk)
            nc = ck.shape[1]
            res = timed({
                "trace_fwd_poly": lambda: ftr.trace_fwd_poly(
                    pk, mk, spec, ins, *tab),
                "trace_bwd_poly": lambda: ftr.trace_bwd_poly(
                    pk, mk, spec, nc, ins, cots, *tab),
            })
        torch.cuda.synchronize()
        return res

    def pol_kernels(system, field):
        """pol_fwd and pol_bwd in both modes (H) on a coated system, with
        pol_bwd's launch shapes where the tree's wrapper gives them."""
        from optiland_torch.ops import pol_trace as pt
        from optiland_torch.polarization import create_polarization

        wl = float(system.wavelengths[system.cfg.primary_index])
        with torch.no_grad():
            pk = ft.build_param_table(system, wl).contiguous()
            Px, Py = ft.prng_disk(15, R, 0, dt, dev)
            rays = raygen.generate_rays(system, *field, Px, Py, wl)
            ins = [getattr(rays, k).contiguous() for k in ftr.RAY_FIELDS]
            del rays, Px, Py
            cots = [torch.randn(R, generator=gen, device=dev, dtype=dt) / R
                    for _ in range(pt.N_POL)]
            spec = pt.pol_spec(system, wl)
            coat = pt.build_coat_table(system, wl, dt, dev)
            states = pt.pol_states(create_polarization("H"))
            ck, lk = tables(system)
            nc = ck.shape[1]
            res = timed({
                "pol_fwd": lambda: pt.pol_fwd(pk, coat, spec, ins, None,
                                              False, ck, lk),
                "pol_bwd": lambda: pt.pol_bwd(pk, coat, spec, nc, ins, cots,
                                              None, False, ck, lk),
                "pol_fwd_intensity": lambda: pt.pol_fwd(
                    pk, coat, spec, ins, states, True, ck, lk),
                "pol_bwd_intensity": lambda: pt.pol_bwd(
                    pk, coat, spec, nc, ins, cots[:8], states, True, ck, lk),
            })
            res["build"] = launch.BUILD_SUFFIX[pt._build(spec)][1:] or "stock"
            if hasattr(pt, "pol_grid"):
                for intensity in (False, True):
                    res[f"shape_{'intensity' if intensity else 'full'}"] = \
                        pt.pol_grid(spec, nc, coat.shape[1], R, intensity,
                                    dt, dev, lk)
        torch.cuda.synchronize()
        return res

    def doublet16():
        from optiland_torch.samples import polarized as ps

        lens = ps.coated_doublet("H", epd=4.0)
        if hasattr(lens, "image_solve"):
            lens.image_solve()
        return lens

    from optiland_torch.samples import CookeTriplet

    def objective26():
        # the registry reads its prescriptions where the tree keeps them
        from optiland_torch.samples import registry

        return registry.build_sample("ObjectiveUS008879901")

    out = {}
    if pol:
        from optiland_torch.samples import nurbs as ns
        from optiland_torch.samples import polarized as ps

        for name, make, field in (
                *((cls, lambda cls=cls: ps.bench_polarized(cls), (0.0, 0.7))
                  for cls in ps.BENCH_CLASSES),
                ("tilted_singlet", perturbed.tilted_singlet, (0.0, 0.7)),
                ("doublet16", doublet16, (0.0, 0.0)),
                ("coated_asphere", lambda: perturbed.coated_asphere("H"),
                 (0.0, 0.7)),
                ("plates", getattr(ps, "coated_plates", None),
                 (0.0, 0.7)),
                *((f"coated_{fam}", lambda fam=fam: freeform.coated_freeform(
                    fam, "H"), freeform.H)
                  for fam in ("polynomial",) + freeform.AUX_FAMILIES),
                ("coated_nurbs", lambda: ns.coated_nurbs("H"), (0.3, 0.7))):
            if make is not None and (systems is None or name in systems):
                out[name] = pol_kernels(make().system, field)
    elif newton:
        for name, make, field, poly in (
                ("tilted_asphere", perturbed.tilted_asphere, (0.0, 0.0),
                 True),
                ("objective26", objective26, (0.0, 0.7), False),
                ("polynomial", lambda: freeform.freeform_singlet(
                    "polynomial"), freeform.H, True),
                ("toroidal", lambda: freeform.freeform_singlet("toroidal"),
                 freeform.H, False),
                *((fam, lambda fam=fam: freeform.freeform_singlet(fam),
                   freeform.H, fam == "forbes_q2d")
                  for fam in freeform.AUX_FAMILIES)):
            system = make().system
            out[name] = kernels(system, field)
            if poly and (only is None or {"trace_fwd_poly",
                                          "trace_bwd_poly"} & set(only)):
                out[name + "_poly"] = poly_kernels(system, field)
    elif nurbs:
        from optiland_torch.samples import nurbs as ns

        for name, make in (("rational", ns.rational_nurbs),
                           ("fitted", ns.fitted_nurbs)):
            out[name] = kernels(make().system, (0.3, 0.7))
        if only is None or {"trace_fwd_poly", "trace_bwd_poly",
                            "pol_fwd_intensity",
                            "pol_bwd_intensity"} & set(only):
            out["rational_poly_pol"] = nurbs_poly_pol(
                ns.rational_nurbs().system, ns.coated_nurbs("H").system)
    elif not aux:
        out["cooke"] = kernels(CookeTriplet().system, (0.0, 0.7))
        out["toleranced_cooke"] = kernels(
            perturbed.toleranced_cooke().system, (0.0, 0.7))
        out["cooke_poly"] = poly_kernels(CookeTriplet().system)
    for name, make, field in () if aux or main or nurbs or newton or pol \
            else (
                ("tilted_asphere", perturbed.tilted_asphere, (0.0, 0.0)),
                ("objective26", objective26, (0.0, 0.7)),
                ("polynomial", lambda: freeform.freeform_singlet(
                    "polynomial"), freeform.H),
                ("toroidal", lambda: freeform.freeform_singlet("toroidal"),
                 freeform.H)):
        out[name] = kernels(make().system, field)
    if aux and not nurbs and not pol:
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
    from optiland_torch.ops import _cuda

    print(tag, "card", torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), "nvcc s", _cuda.BUILD_SECONDS, "wall s",
        round(time.perf_counter() - t_start, 1), flush=True)


def main(argv):
    if len(argv) >= 3 and argv[0] == "build":
        build(argv[1], argv[2])
    elif len(argv) == 3 and argv[0] == "ptxas":
        ptxas(argv[1], argv[2])
    elif len(argv) == 3 and argv[0] == "sass":
        sass(argv[1], argv[2])
    elif len(argv) == 2 and argv[0] == "mix":
        mix(argv[1])
    elif len(argv) >= 3 and argv[0] == "time":
        rest = argv[3:]
        only = (rest[rest.index("--kernels") + 1].split(",")
                if "--kernels" in rest else None)
        time_tree(argv[1], argv[2], "--aux" in rest, "--main" in rest,
                  "--nurbs" in rest, only, "--newton" in rest,
                  "--f64" in rest, "--pol" in rest,
                  rest[rest.index("--systems") + 1].split(",")
                  if "--systems" in rest else None)
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
