#!/usr/bin/env python3
"""Time the PyTorch port's trace kernels (the path kernel, its adjoints,
the MMLT kernel, the chain kernel) and the BVH walk against other builds
of them, in turns, in one process on one GPU.

    python3 scripts/chain_kernel_ab.py --other parent=DIR [--other NAME=DIR]
        [--set NAME=CONST:VALUE[,CONST:VALUE]] [--brute-only]
        [--scene cornell const large] [--type orbital green mira]
        [--mode drmlt pssmlt] [--rounds 3] [--diagnose]

Each DIR holds the `.cu` / `.cuh` sources of another revision's
`drmlt_mitsuba_tpu_torch/csrc/`, for example the parent commit's

    git archive HEAD~1 drmlt_mitsuba_tpu_torch/csrc | tar -x -C build/base
    ... --other parent=build/base/drmlt_mitsuba_tpu_torch/csrc

or a copy of the checkout's with one constant changed (for example
`kChainBlock` in drmlt_chain.cu, the block of both chain-kernel modes, or
`kPathBlock` in path_block.cuh).  Its entry points take the checkout's
arguments (ops/build.py), or, a build from before the compacting
adjoints (its path_trace_grad.cu takes no `int compact`), the adjoints'
without the compact flag and the scratch: `OldAdjoint` drops them.  Each
is compiled by ops/build.py, as the checkout's kernels are, into a
library of its own under build/torch_kernels/.  --set makes such a copy
itself, under build/ab/NAME: the checkout's sources with each
`constexpr int CONST = ...;` set to VALUE (for example
`rpt1=kBruteRPT:1` or `block256=kBruteBlock:256`, the intersection
kernel's brute mode, or `global=kGradShmWords:0`, the adjoints' rows in
global memory whatever their size).

The path kernel (65,536 lanes, rr_depth 100) on cornell_box(256, 256) at
depths 8, 6 and 4, the veach door, cornell_scope(256, 256, "const") and
tests/data/cornell.xml (the full scope) and cornell_large.xml (19,586
triangles, the walk), each build and the checkout's one-path-per-thread
launch (`lane`): bit for bit the checkout's, ms per launch in turns;
the adjoint kernels (depth 6, rr 5) on the box, the veach door, [full]
(cornell_scope "const" for the radiance kernel, "kinds" for the albedo
one) and cornell_large.xml, each build and the checkout's one path per
thread alike, with the bound of the work (the twin's tests on the same
lanes) and the share each build reaches; the intersection kernel's BVH mode on 1,048,576 rays against raybench's
20,000-triangle sphere (MRays/s) and cornell_large.xml.
--diagnose: the path kernel on the box at 65,536, 131,072 and 262,144
lanes, depths 8 and 2, and each build's SASS of its path kernels
(cuobjdump) in chiprun_out/chain_kernel_ab_sass_NAME.txt.

The intersection kernel's brute mode (every run; --brute-only: nothing
else): each build's t, id and any hit bit for bit the checkout's and the
plain sweep's on raybench.edge_case at R in BRUTE_EDGE_R and T in
BRUTE_EDGE_T; then, on 1,048,576 rays, closest and any hit timed in
turns on raybench's 3,784-triangle sphere (`--tris 4000`), the
36-triangle box (rays from inside it, and camera rays through its open
side) and raybench's 19,800-triangle sphere without its BVH.
--diagnose adds the 3,784-triangle sphere at 262,144 / 1,048,576 /
4,194,304 rays and its first 36 / 512 triangles at 1,048,576 rays, in
both modes, and each build's SASS instructions per triangle test: every
innermost loop of the intersection kernels with a MUFU.RCP (one per
test), split into FP32, loads, integer and control.  nvidia-smi's SM
clock and power draw are sampled through the run and summarised over the
samples where the card was busy.

On cornell_box(256, 256) (`cornell`, the instantiation of slices 1-4),
cornell_scope(256, 256, "const") (`const`, the full scene scope) and
cornell_large.xml (`large`, the walk):

  * the MMLT kernel on 65,536 lanes: the pooled depths
    1-6 (max_depth 6) and the depth pinned at k = 1 and k = 6 (the grouped
    driver's form); whether each build's output is bit for bit the
    checkout's, and ms per launch (CUDA events over 20 launches after one
    warm-up), every build in the order A B ... B A, --rounds times;
  * the chain kernel, PathConfig(max_depth=8, rr_depth=100) in path mode
    and the k = 6 group in mmlt mode, 65,536 chains, each --type with the
    sampled splat, in each --mode (DRMLT, or the stage-1-only pssmlt
    mode): the twin's stage-2 share (the chains whose z it traced) and,
    for green, the y* share, on the first 4,096 chains over 2 mutations
    (DRMLT mode); whether each build's states and stats after one launch
    of 64 mutations are bit for bit those of the checkout's kernel from
    the same start and Philox seed (pssmlt mode: and stats[1] = stats[3]
    = 0); ms per launch of 64 mutations (CUDA events over 3 launches after
    one warm-up), in turns as above (--rounds 0: no timing);

and each build's ptxas registers, stack and spills of every kernel.
Prints one JSON line and writes chiprun_out/chain_kernel_ab.json, and each
build's whole ptxas report to chiprun_out/chain_kernel_ab_ptxas_NAME.txt.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import bound, nbytes, ptxas_report  # noqa: E402
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig  # noqa: E402
from drmlt_mitsuba_tpu_torch.integrators.drmlt import DRMLTConfig  # noqa: E402
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig  # noqa: E402
from drmlt_mitsuba_tpu_torch.integrators.mcmc import (  # noqa: E402
    state_from_splats,
)
from drmlt_mitsuba_tpu_torch.integrators.mmlt_grouped import (  # noqa: E402
    group_bootstrap, group_starts, make_mmlt_trace_fixed,
)
from drmlt_mitsuba_tpu_torch.integrators.path import (  # noqa: E402
    make_path_trace,
)
from drmlt_mitsuba_tpu_torch.ops import build  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import intersect as IX  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megammlt as MM  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT  # noqa: E402
from drmlt_mitsuba_tpu_torch.scene.builders import (  # noqa: E402
    cornell_box, cornell_scope, veach_door,
)
from drmlt_mitsuba_tpu_torch.utils import cli, raybench  # noqa: E402

CHAINS = 65536
SIZE = 256
N_MUT = 64
MMLT_RUNS = 20
PATH_RUNS = 20
RAYS = 1 << 20
SHARE_CHAINS = 4096   # the twin's stage-2 share: chains x 2 mutations
DATA = ROOT / "tests" / "data"
# the brute mode's edge cases: rays that leave a block, a thread's rays or
# a warp part-filled; triangles below, at and one past a staged tile
# (kBruteTile = 256), up to BVH_MIN_TRIS - 1
BRUTE_EDGE_R = (1, 33, 1000, 65537)
BRUTE_EDGE_T = (1, 36, 257, 3784, 4095)


def load_other(src: Path):
    """Another revision's csrc/ built by ops/build.py: (library path,
    library, ptxas text); a build from before the compacting adjoints
    comes wrapped in OldAdjoint."""
    out = build.build(src)
    lib = ctypes.CDLL(str(out))
    old = "int compact" not in (src / "path_trace_grad.cu").read_text()
    for fn, sig in build._SIGNATURES.items():
        if old and fn in OldAdjoint.ENTRIES:
            sig = build._PATH_TRACE
        getattr(lib, fn).argtypes = sig
        getattr(lib, fn).restype = ctypes.c_int
    return (out, OldAdjoint(lib) if old else lib,
            out.with_suffix(".ptxas.txt").read_text())


def set_constants(name, spec):
    """A copy of the checkout's csrc/ under build/ab/NAME with each
    `constexpr int CONST = ...;` of spec ("CONST:VALUE,...") changed."""
    out = ROOT / "build" / "ab" / name
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(build.CSRC, out)
    for item in spec.split(","):
        key, val = item.split(":")
        hits = 0
        for f in out.iterdir():
            text = f.read_text()
            new, n = re.subn(rf"constexpr int {key} = [^;]+;",
                             f"constexpr int {key} = {val};", text)
            if n:
                f.write_text(new)
                hits += n
        if hits != 1:
            raise SystemExit(f"--set {name}: {key} defined {hits} times")
    return out


# the compact flag of path_trace_launch and of the adjoints' entry points
COMPACT_AT = 30


class OldAdjoint:
    """A build from before the compacting adjoints (one path per thread,
    rows in global memory), called with the checkout's arguments: the
    adjoints' compact flag and scratch go."""

    ENTRIES = ("path_trace_rad_launch", "path_trace_alb_launch")

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name not in self.ENTRIES:
            return fn
        return lambda *a: fn(*a[:COMPACT_AT], *a[COMPACT_AT + 1:-2], a[-1])


class Lane:
    """The checkout's library with the compact flag of the path kernel and
    the adjoints off: one path per thread to its end."""

    ENTRIES = ("path_trace_launch", *OldAdjoint.ENTRIES)

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if name not in self.ENTRIES:
            return fn
        return lambda *a: fn(*a[:COMPACT_AT], 0, *a[COMPACT_AT + 1:])


class using:
    """Route the wrappers' launches through `lib` for a block."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        self.saved, build._lib = build._lib, self.lib

    def __exit__(self, *exc):
        build._lib = self.saved


def step(lib, tables, cfg, state, film, stats, seed, launch, pssmlt):
    """One launch of N_MUT mutations of `lib`'s chain kernel (Philox)."""
    with using(lib):
        MD.drmlt_chain_step(tables, cfg, N_MUT, state, film, stats, seed,
                            launch, pssmlt=pssmlt)


def fresh(s0):
    dev = s0.device
    return (s0.clone(), torch.zeros((SIZE, SIZE, 3), device=dev),
            torch.zeros((6, s0.shape[1]), device=dev))


def events_ms(fn, runs):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(runs):
        fn(i)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / runs


def chain_ms(lib, tables, cfg, s0, pssmlt):
    st, film, stats = fresh(s0)
    return events_ms(lambda i=-1: step(lib, tables, cfg, st, film, stats, 5,
                                       i + 1, pssmlt), 3)


def mmlt_ms(lib, tables, uT):
    def run(i=0):
        with using(lib):
            MM.mmlt_trace(tables, uT)
    return events_ms(run, MMLT_RUNS)


def in_turns(libs, rounds, fn):
    """{build: [ms, ...]}, every build in the order A B ... B A."""
    names = list(libs)
    ms = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            ms[n].append(fn(libs[n]))
    return ms


def fmt_ms(ms):
    return "; ".join(f"{n} mean {sum(v) / max(len(v), 1):.4f} "
                     f"{[round(x, 4) for x in v]}" for n, v in ms.items())


def scene_of(name):
    if name == "cornell":
        return cornell_box(SIZE, SIZE)
    if name == "veach":
        return veach_door(SIZE, SIZE)
    if name in ("const", "kinds"):
        return cornell_scope(SIZE, SIZE, name)
    xml = ("cornell.xml" if name == "cornell_xml"
           else "large/cornell_large.xml")
    return cli.load_scene(str(DATA / xml), {"integrator": "drmlt"})[0]


def same(a, b):
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def compare(libs, rounds, run, runs, label, timed_run=None):
    """Each build's outputs of `run` against the checkout's, bit for bit,
    and ms per call of `timed_run` (default `run`) in turns; prints one
    line, returns the row."""
    outs = {}
    for name, lib in libs.items():
        with using(lib):
            outs[name] = run()
    ref = outs["checkout"]
    row = dict(equal_to_checkout={
        n: all(same(a, b) for a, b in zip(o, ref)) for n, o in outs.items()})

    def timed(lib):
        def once(i=0):
            with using(lib):
                (timed_run or run)()
        return events_ms(once, runs)
    row["ms_per_launch"] = in_turns(libs, rounds, timed)
    print(f"{label}: equal to the checkout's {row['equal_to_checkout']}; "
          f"ms per launch: {fmt_ms(row['ms_per_launch'])}", flush=True)
    return row


PATH_CASES = (("cornell", 8), ("cornell", 6), ("cornell", 4), ("veach", 8),
              ("const", 8), ("cornell_xml", 4), ("large", 8))


def path_cases(libs, rounds, dev, g, report):
    """The path kernel, the adjoints and the intersection kernel."""
    path_libs = dict(libs, lane=Lane(libs["checkout"]))
    for sname, depth in PATH_CASES:
        scene = scene_of(sname)
        tb = MT.make_tables(scene, PathConfig(max_depth=depth, rr_depth=100),
                            dev)
        uT = torch.rand((tb.n_dims, CHAINS), device=dev, generator=g)
        case = f"{sname}/path_trace/d{depth}" + ("[full]" if tb.full else "")
        report["cases"][case] = compare(
            path_libs, rounds, lambda: (MT.path_trace(tb, uT),), PATH_RUNS,
            case)
    adjoint_cases(libs, rounds, dev, g, report)
    for sname in ("sphere-20000", "large"):
        if sname == "sphere-20000":
            scene = raybench.bumpy_sphere(20000)
            o, d = raybench.rays(RAYS, dev)
        else:
            scene = scene_of(sname)
            o = torch.rand((RAYS, 3), device=dev, generator=g) * 554.0 + 1.0
            d = torch.randn((RAYS, 3), device=dev, generator=g)
            d = d / d.norm(dim=1, keepdim=True)
        tb = IX.make_ray_tables(scene, dev)
        tmax = torch.rand(RAYS, device=dev, generator=g) * 600.0
        case = f"{sname}/intersect/bvh (timed: closest)"
        row = compare(libs, rounds, lambda: (*IX.closest(tb, o, d),
                                             IX.any_hit(tb, o, d, tmax)),
                      PATH_RUNS, case, lambda: IX.closest(tb, o, d))
        row["mrays_per_s"] = {n: RAYS / (sum(v) / len(v)) / 1e3 for n, v in
                              row["ms_per_launch"].items()}
        report["cases"][case] = row


# the adjoint kernels' scenes, per mode: the box, the veach door, [full]
# (cornell_scope "const"; "kinds" for the albedo kernel, since "const" has
# a bitmap albedo) and cornell_large.xml (one path per thread there)
ADJOINT_CASES = (("rad", ("cornell", "veach", "const", "large")),
                 ("alb", ("cornell", "veach", "kinds", "large")))


def adjoint_cases(libs, rounds, dev, g, report):
    """The adjoint kernels (depth 6, rr 5), each build and the checkout's
    one-path-per-thread launch (`lane`): bit for bit the checkout's, ms per
    launch in turns, and the work's bound (chip_smoke.bound over the
    twin's ray-triangle and box tests on the same lanes) with the share of
    it each build reaches."""
    adj_libs = dict(libs, lane=Lane(libs["checkout"]))
    cfg = PathConfig(max_depth=6, rr_depth=5)
    for mode, names in ADJOINT_CASES:
        fn = MT.path_trace_rad if mode == "rad" else MT.path_trace_alb
        for sname in names:
            tb = MT.make_tables(scene_of(sname), cfg, dev)
            uT = torch.rand((tb.n_dims, CHAINS), device=dev, generator=g)
            case = (f"{sname}/path_trace_{mode}/d6"
                    + ("[full]" if tb.full else ""))
            row = compare(adj_libs, rounds, lambda: (fn(tb, uT),),
                          PATH_RUNS, case)
            work = {}
            MT.path_trace_reference(tb, uT, work)
            K = tb.em.shape[0] if mode == "rad" else tb.mat.shape[0]
            nodes = tb.nodes
            row["bound_ms"], row["bound_by"] = bound(
                nbytes(uT, tb.tri, tb.mat, tb.em, tb.cam, tb.sph,
                       tb.tri_ext, *((nodes.node, nodes.rec) if nodes
                                     else ()))
                + (3 + 3 * K) * CHAINS * 4, work.get("tri_tests", 0),
                work.get("node_tests", 0))
            row["share_of_bound"] = {
                n: row["bound_ms"] / (sum(v) / len(v))
                for n, v in row["ms_per_launch"].items()}
            print(f"{case}: bound {row['bound_ms']:.4f} ms by "
                  f"{row['bound_by']} ({work}); share reached "
                  + ", ".join(f"{n} {x:.4f}" for n, x in
                              row["share_of_bound"].items()), flush=True)
            report["cases"][case] = row


def brute_rays(sname, n, dev, g):
    """(tables without a BVH, o, d, tmax) of a brute-mode case: raybench's
    sphere (`sphere-N`: its --tris N) and rays, the box's 36 triangles
    and rays from inside it (`cornell`), or camera rays: from the box's
    eye through a square grid of n points over its open side, row by row,
    so a warp's rays are neighbours (`cornell-camera`)."""
    if sname == "cornell-camera":
        side = int(n ** 0.5)
        y, x = torch.meshgrid(torch.linspace(0.0, 548.0, side, device=dev),
                              torch.linspace(0.0, 556.0, side, device=dev),
                              indexing="ij")
        eye = torch.tensor([278.0, 273.0, -800.0], device=dev)
        d = torch.stack([x, y, torch.zeros_like(x)], -1).reshape(-1, 3) - eye
        d = (d / d.norm(dim=1, keepdim=True)).contiguous()
        o = eye.expand_as(d).contiguous()
        tmax = torch.rand(d.shape[0], device=dev, generator=g) * 1400.0
        return (IX.make_ray_tables(scene_of("cornell"), dev, walk=False),
                o, d, tmax)
    if sname == "cornell":
        scene = scene_of("cornell")
        o = torch.rand((n, 3), device=dev, generator=g) * 554.0 + 1.0
        d = torch.randn((n, 3), device=dev, generator=g)
        d = d / d.norm(dim=1, keepdim=True)
        tmax = torch.rand(n, device=dev, generator=g) * 600.0
    else:
        scene = raybench.bumpy_sphere(int(sname.split("-")[1]))
        o, d = raybench.rays(n, dev)
        tmax = torch.rand(n, device=dev, generator=g) * 6.0
    return IX.make_ray_tables(scene, dev, walk=False), o, d, tmax


def brute_timed(libs, rounds, case, tb, o, d, tmax, runs):
    """Closest and any hit of every build: equal to the checkout's, ms per
    launch in turns, MRays/s."""
    rows = {}
    for mode, fn in (("closest", lambda: IX.closest(tb, o, d)),
                     ("any", lambda: (IX.any_hit(tb, o, d, tmax),))):
        row = compare(libs, rounds, fn, runs,
                      f"{case}/{mode} ({tb.tri.shape[0]} triangles, "
                      f"{o.shape[0]} rays)")
        row["mrays_per_s"] = {n: o.shape[0] / (sum(v) / len(v)) / 1e3
                              for n, v in row["ms_per_launch"].items()}
        rows[mode] = row
    return rows


def brute_cases(libs, rounds, dev, g, report):
    """The brute mode: the edge cases bit for bit, then the timed cases."""
    ok = {n: True for n in libs}
    twin_ok = True
    for T in BRUTE_EDGE_T:
        for R in BRUTE_EDGE_R:
            tb, o, d, tmax = raybench.edge_case(T, R, dev, seed=T + R)
            outs = {}
            for name, lib in libs.items():
                with using(lib):
                    outs[name] = (*IX.closest(tb, o, d, tmax),
                                  IX.any_hit(tb, o, d, tmax))
            twin = (*IX.closest_reference(tb, o, d, tmax),
                    IX.any_reference(tb, o, d, tmax))
            for name, out in outs.items():
                ok[name] &= all(same(a, b) for a, b in
                                zip(out, outs["checkout"]))
            twin_ok &= all(same(a, b) for a, b in zip(outs["checkout"], twin))
    report["cases"]["brute/edges"] = dict(equal_to_checkout=ok,
                                          checkout_equal_to_twin=twin_ok,
                                          ms_per_launch={})
    print(f"brute/edges (R in {BRUTE_EDGE_R}, T in {BRUTE_EDGE_T}, both "
          f"modes): equal to the checkout's {ok}; the checkout equal to the "
          f"plain sweep {twin_ok}", flush=True)
    for sname, runs in (("sphere-4000", 10), ("cornell", PATH_RUNS),
                        ("cornell-camera", PATH_RUNS), ("sphere-20000", 2)):
        tb, o, d, tmax = brute_rays(sname, RAYS, dev, g)
        for mode, row in brute_timed(libs, rounds, f"{sname}/brute", tb, o,
                                     d, tmax, runs).items():
            report["cases"][f"{sname}/brute/{mode}"] = row


def brute_diagnose(libs, dev, g, report):
    """The brute mode's scaling in rays and triangles (raybench's sphere,
    its first T triangles; each build once in turns, both modes)."""
    for T, R in ((3784, RAYS // 4), (3784, RAYS), (3784, 4 * RAYS),
                 (36, RAYS), (512, RAYS)):
        tb, o, d, tmax = brute_rays("sphere-4000", R, dev, g)
        tb = IX.RayTables(tri=tb.tri[:T].contiguous(), nodes=None)
        case = f"diagnose/sphere-4000/brute/T{T}/R{R}"
        for mode, row in brute_timed(libs, 1, case, tb, o, d, tmax,
                                     3).items():
            report["cases"][f"{case}/{mode}"] = row


SASS_CLASSES = {
    "fp32": ("FADD", "FMUL", "FFMA", "FSETP", "FSEL", "FMNMX", "FCHK",
             "MUFU", "FSET"),
    "loads": ("LDG", "LDS", "LDL", "LD", "LDC"),
    # integer arithmetic and moves (HFMA2.MMA -RZ, RZ, ... is a move)
    "integer": ("IADD3", "IMAD", "ISETP", "LEA", "LOP3", "SHF", "SEL",
                "HFMA2", "IMNMX", "IABS", "MOV", "PRMT", "S2R", "CS2R", "I2F",
                "F2I", "SHL", "SHR", "IADD", "UIADD3", "UMOV", "ULDC", "ULEA",
                "UISETP", "USHF", "ULOP3", "UIMAD", "USEL", "R2UR", "P2R",
                "R2P"),
    "control": ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BAR", "VOTE",
                "VOTEU", "WARPSYNC", "NOP", "PLOP3", "YIELD", "BREAK", "BPT"),
}


def sass_loops(sass):
    """{function: [loop, ...]} of a cuobjdump -sass listing: every innermost
    loop (a backward branch's span holding no other) with a MUFU.RCP, its
    instructions and MUFU.RCPs (tests) and, per test, its instructions by
    SASS_CLASSES (the rest under "other")."""
    out = {}
    fn, ins, labels, pending = None, [], {}, []

    def flush():
        if fn is None:
            return
        spans = []
        for addr, op, args in ins:
            if op != "BRA":
                continue
            m = re.search(r"\.L_x_\d+|0x[0-9a-f]+", args)
            if not m:
                continue
            tgt = (labels.get(m.group(0)) if m.group(0).startswith(".L")
                   else int(m.group(0), 16))
            if tgt is not None and tgt <= addr:
                spans.append((tgt, addr))
        spans = [s for s in spans if not any(
            o != s and s[0] <= o[0] and o[1] <= s[1] for o in spans)]
        rows = []
        for lo, hi in sorted(set(spans)):
            body = [op for a, op, _ in ins if lo <= a <= hi]
            tests = sum(op == "MUFU" and ".RCP" in args
                        for a, op, args in ins if lo <= a <= hi)
            if not tests:
                continue
            cls = {c: 0 for c in (*SASS_CLASSES, "other")}
            for op in body:
                cls[next((c for c, ops in SASS_CLASSES.items() if op in ops),
                         "other")] += 1
            rows.append(dict(start=hex(lo), end=hex(hi),
                             instructions=len(body), tests=tests,
                             per_test=len(body) / tests,
                             **{c: v / tests for c, v in cls.items()}))
        if rows:
            out[fn] = rows

    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            flush()
            fn, ins, labels, pending = m.group(1), [], {}, []
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)\s*([^;]*);", line)
        if m and fn is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            ins.append((addr, m.group(2), m.group(3) + " " + m.group(4)))
    flush()
    return out


def diagnose(libs, dev, g, report):
    """The path kernel on the box at 65,536, 131,072 and 262,144 lanes,
    depths 8 and 2 (each build and the one-path-per-thread launch, in
    turns), and each build's SASS of its path kernels."""
    path_libs = dict(libs, lane=Lane(libs["checkout"]))
    scene = scene_of("cornell")
    for depth in (8, 2):
        tb = MT.make_tables(scene, PathConfig(max_depth=depth, rr_depth=100),
                            dev)
        for R in (CHAINS, 2 * CHAINS, 4 * CHAINS):
            uT = torch.rand((tb.n_dims, R), device=dev, generator=g)
            case = f"diagnose/cornell/path_trace/d{depth}/R{R}"
            report["cases"][case] = compare(
                path_libs, 1, lambda: (MT.path_trace(tb, uT),), PATH_RUNS,
                case)


def starts(scene, dev, g):
    """{technique: (tables, packed starting state)} on one scene."""
    pcfg = PathConfig(max_depth=8, rr_depth=100, min_depth=1)
    trace = make_path_trace(scene, pcfg, dev)
    D = pcfg.n_dims + pcfg.n_dims % 2
    u = torch.rand((16 * CHAINS, D), device=dev, generator=g)
    u = u[torch.nonzero(trace(u).lum > 0)[:CHAINS, 0]]
    out = {"path": (MT.make_tables(scene, pcfg, dev),
                    MD.pack_chain_state(state_from_splats(u, trace(u))))}
    trace6, _, n6, mt6 = make_mmlt_trace_fixed(scene, 6, True, dev)
    ub = torch.rand((3 * 8192, n6), device=dev, generator=g)
    lums, _ = group_bootstrap(trace6, ub)
    out["mmlt"] = (mt6, MD.pack_chain_state(group_starts(
        trace6, ub, lums, torch.rand(CHAINS, device=dev, generator=g))))
    return out


def mmlt_cases(scene, dev, g):
    """{form: (tables, uT (n_core, CHAINS))}: the pooled depths 1-6, and
    the depth pinned at k = 1 and k = 6 as the grouped driver pins it."""
    out = {}
    t = MM.make_mmlt_tables(scene, BDPTConfig(max_depth=6), dev)
    out["pooled1-6"] = (t, torch.rand((t.n_core, CHAINS), device=dev,
                                      generator=g))
    for k in (1, 6):
        t = MM.make_mmlt_tables(scene, BDPTConfig(max_depth=k), dev)
        uT = torch.rand((t.n_core, CHAINS), device=dev, generator=g)
        uT[0] = 1.0 - 0.5 / k
        out[f"pinned{k}"] = (t, uT)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR", help="another revision's csrc/")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--scene", nargs="+",
                    choices=("cornell", "const", "large"),
                    default=["cornell"])
    ap.add_argument("--set", action="append", default=[],
                    metavar="NAME=CONST:VALUE[,CONST:VALUE]",
                    help="the checkout's csrc/ with constants changed")
    ap.add_argument("--brute-only", action="store_true",
                    help="only the intersection kernel's brute mode")
    ap.add_argument("--diagnose", action="store_true",
                    help="the path kernel at 1, 2 and 4 x 65,536 lanes, "
                         "depths 8 and 2, the brute mode's scaling, and "
                         "their SASS")
    ap.add_argument("--type", nargs="+", choices=("orbital", "green", "mira"),
                    default=["orbital"])
    ap.add_argument("--mode", nargs="+", choices=("drmlt", "pssmlt"),
                    default=["drmlt"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chain_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report = dict(device=smi, cases={})
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    clocks = ROOT / "chiprun_out" / "chain_kernel_ab_clocks.csv"
    with open(clocks, "w") as f:
        sampler = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", "500"], stdout=f)
    try:
        run(args, dev, report)
    finally:
        sampler.terminate()
        sampler.wait(timeout=60)
    # the samples of a busy card: a kernel ran through >= 90% of the period
    sm, watts = [], []
    for line in clocks.read_text().splitlines():
        try:
            a, b, busy = (float(x) for x in line.split(","))
        except ValueError:
            continue
        if busy >= 90:
            sm.append(a)
            watts.append(b)
    if sm:
        report["clocks_busy"] = dict(
            sm_mhz_min=min(sm), sm_mhz_median=statistics.median(sm),
            sm_mhz_max=max(sm), power_w_max=max(watts), samples=len(sm))
        print(f"nvidia-smi while the card was busy: "
              f"{report['clocks_busy']}", flush=True)
    report["seconds"] = time.perf_counter() - t0

    with open(ROOT / "chiprun_out" / "chain_kernel_ab.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({
        "equal_to_checkout": {c: r["equal_to_checkout"]
                              for c, r in report["cases"].items()},
        "ms_mean": {c: {n: sum(v) / len(v) for n, v in
                        r["ms_per_launch"].items() if v}
                    for c, r in report["cases"].items()},
        "clocks_busy": report.get("clocks_busy"),
        "seconds": report["seconds"]}))
    return 0


def run(args, dev, report):
    """Every build, then the cases the arguments ask for, into report."""
    libs = {"checkout": build.load()}
    report["ptxas"] = {"checkout": ptxas_report(build.build_info["ptxas"])}
    others = [s.split("=", 1) for s in args.other]
    others += [(name, set_constants(name, spec)) for name, spec in
               (s.split("=", 1) for s in args.set)]
    texts = {"checkout": build.build_info["ptxas"]}
    paths = {"checkout": build.build_info["path"]}
    for name, d in others:
        paths[name], libs[name], texts[name] = load_other(Path(d))
        report["ptxas"][name] = ptxas_report(texts[name])
    for name, text in texts.items():   # every function's figures, in full
        (ROOT / "chiprun_out" / f"chain_kernel_ab_ptxas_{name}.txt"
         ).write_text(text)
    for name, p in report["ptxas"].items():
        print(f"ptxas {name}: {p}", flush=True)

    g = torch.Generator(device=dev).manual_seed(3)
    if args.diagnose:
        for name, path in paths.items():
            sass = subprocess.run(
                [str(Path(build._nvcc()).with_name("cuobjdump")), "-sass",
                 str(path)], capture_output=True, text=True).stdout
            keep, out = False, []
            wanted = ("intersect_kernel", "brute_sweep_kernel")
            if not args.brute_only:
                wanted += ("path_trace_kernel", "path_lane_kernel",
                           "trace_path", "bvh_")
            for line in sass.splitlines():
                if "Function :" in line:
                    keep = any(f in line for f in wanted)
                if keep:
                    out.append(line)
            (ROOT / "chiprun_out" / f"chain_kernel_ab_sass_{name}.txt"
             ).write_text("\n".join(out))
            loops = {f: v for f, v in sass_loops("\n".join(out)).items()
                     if "intersect_kernel" in f or "brute_sweep" in f}
            report.setdefault("sass_per_test", {})[name] = loops
            for f, rows in loops.items():
                for r in rows:
                    print(f"SASS {name}: {f} loop {r['start']}-{r['end']}: "
                          f"{r['instructions']} instructions, {r['tests']} "
                          f"tests, {r['per_test']:.2f} a test (fp32 "
                          f"{r['fp32']:.2f}, loads {r['loads']:.2f}, "
                          f"integer {r['integer']:.2f}, control "
                          f"{r['control']:.2f}, other {r['other']:.2f})",
                          flush=True)
        if not args.brute_only:
            diagnose(libs, dev, g, report)
        brute_diagnose(libs, dev, g, report)
    brute_cases(libs, args.rounds, dev, g, report)
    if args.brute_only:
        return
    path_cases(libs, args.rounds, dev, g, report)
    for scene_name in args.scene:
        scene = scene_of(scene_name)
        for form, (tb, uT) in mmlt_cases(scene, dev, g).items():
            case = f"{scene_name}/mmlt_trace/{form}"
            outs = {}
            for name, lib in libs.items():
                with using(lib):
                    outs[name] = MM.mmlt_trace(tb, uT)
            ref = outs["checkout"]
            row = dict(equal_to_checkout={
                n: bool(torch.equal(o, ref)) for n, o in outs.items()})
            row["ms_per_launch"] = in_turns(
                libs, args.rounds, lambda lib: mmlt_ms(lib, tb, uT))
            report["cases"][case] = row
            print(f"{case}: equal to the checkout's "
                  f"{row['equal_to_checkout']}; ms per launch of {CHAINS} "
                  f"lanes: {fmt_ms(row['ms_per_launch'])}", flush=True)
        for tech, (tb, s0) in starts(scene, dev, g).items():
            for mode in args.mode:
                pss = mode == "pssmlt"
                for drtype in args.type:
                    case = f"{scene_name}/{tech}/{mode}/{drtype}"
                    cfg = DRMLTConfig(type=drtype, n_chains=CHAINS,
                                      n_bootstrap=100_000, p_large=0.3,
                                      splat_mode="sampled")
                    row = {}
                    if not pss:
                        work = {}
                        MD.drmlt_chain_step_reference(
                            tb, dataclasses.replace(cfg,
                                                    n_chains=SHARE_CHAINS),
                            2, s0[:, :SHARE_CHAINS].contiguous(),
                            torch.zeros((SIZE, SIZE, 3), device=dev),
                            torch.zeros((6, SHARE_CHAINS), device=dev), 5, 0,
                            work=work)
                        row.update(stage2_share=MD.stage2_share(work),
                                   y_rev_share=(work.get("y_rev_lanes", 0)
                                                / work["y_lanes"]))
                    outs = {}
                    for name, lib in libs.items():
                        st, film, stats = fresh(s0)
                        step(lib, tb, cfg, st, film, stats, 11, 0, pss)
                        outs[name] = (st, stats)
                    ref = outs["checkout"]
                    row["equal_to_checkout"] = {
                        n: bool(torch.equal(o[0], ref[0])
                                and torch.equal(o[1], ref[1]))
                        for n, o in outs.items()}
                    if pss:
                        row["no_stage2_stats"] = {
                            n: float(o[1][1].abs().sum()) == 0.0
                            and float(o[1][3].abs().sum()) == 0.0
                            for n, o in outs.items()}
                    row["ms_per_launch"] = in_turns(
                        libs, args.rounds,
                        lambda lib: chain_ms(lib, tb, cfg, s0, pss))
                    report["cases"][case] = row
                    share = ("" if pss else
                             f"stage-2 share {row['stage2_share']:.4f}, y* "
                             f"share {row['y_rev_share']:.4f}; ")
                    print(f"{case}: {share}equal to the checkout's "
                          f"{row['equal_to_checkout']}"
                          + (f", stats[1] = stats[3] = 0 "
                             f"{row['no_stage2_stats']}" if pss else "")
                          + f"; ms per {N_MUT} mutations x {CHAINS} chains: "
                          + fmt_ms(row["ms_per_launch"]), flush=True)


if __name__ == "__main__":
    sys.exit(main())
