#!/usr/bin/env python3
"""Time the PyTorch port's chain kernel and MMLT kernel against other
builds of them, in turns, in one process on one GPU.

    python3 scripts/chain_kernel_ab.py --other parent=DIR [--other NAME=DIR]
        [--scene cornell const] [--type orbital green mira]
        [--mode drmlt pssmlt] [--rounds 3]

Each DIR holds the `.cu` / `.cuh` sources of another revision's
`drmlt_mitsuba_tpu_torch/csrc/` whose `drmlt_chain_launch` and
`mmlt_trace_launch` take the checkout's arguments (ops/build.py), for
example the parent commit's

    git archive HEAD~1 drmlt_mitsuba_tpu_torch/csrc | tar -x -C build/base
    ... --other parent=build/base/drmlt_mitsuba_tpu_torch/csrc

or a copy of the checkout's with one constant changed (for example
`kChainBlock` in drmlt_chain.cu, the block of both modes).  Each is
compiled with the port's nvcc flags in one `nvcc -shared` command into a
library of its own under build/chain_ab/; the checkout's own kernels come
from ops/build.py.

On cornell_box(256, 256) (`cornell`, the instantiation of slices 1-4)
and cornell_scope(256, 256, "const") (`const`, the full scene scope):

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

and each build's ptxas registers, stack and spills of both kernels.
Prints one JSON line and writes chiprun_out/chain_kernel_ab.json, and each
build's whole ptxas report to chiprun_out/chain_kernel_ab_ptxas_NAME.txt.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import ptxas_report  # noqa: E402
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
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megammlt as MM  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT  # noqa: E402
from drmlt_mitsuba_tpu_torch.scene.builders import (  # noqa: E402
    cornell_box, cornell_scope,
)

CHAINS = 65536
SIZE = 256
N_MUT = 64
MMLT_RUNS = 20
SHARE_CHAINS = 4096   # the twin's stage-2 share: chains x 2 mutations
KERNELS = ("drmlt_chain_kernel", "mmlt_trace_kernel")


def ptxas(text):
    """The chain and MMLT kernels' registers, stack, spills and shared
    memory from ptxas -v output."""
    return {k: v for k, v in ptxas_report(text).items()
            if any(n in k for n in KERNELS)}


def build_single(src: Path, out: Path):
    """One `nvcc -shared` over every .cu of src: (library, ptxas text)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
           *sorted(str(p) for p in src.glob("*.cu"))]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    for name in ("drmlt_chain_launch", "mmlt_trace_launch"):
        getattr(lib, name).argtypes = build._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    return lib, res.stdout + res.stderr


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
    return (cornell_box(SIZE, SIZE) if name == "cornell"
            else cornell_scope(SIZE, SIZE, "const"))


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
    ap.add_argument("--scene", nargs="+", choices=("cornell", "const"),
                    default=["cornell"])
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

    libs = {"checkout": build.load()}
    report["ptxas"] = {"checkout": ptxas(build.build_info["ptxas"])}
    others = [s.split("=", 1) for s in args.other]
    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    texts = {"checkout": build.build_info["ptxas"]}
    for name, d in others:
        libs[name], texts[name] = build_single(
            Path(d), build.BUILD_DIR.parent / "chain_ab" / f"{name}.so")
        report["ptxas"][name] = ptxas(texts[name])
    for name, text in texts.items():   # every function's figures, in full
        (ROOT / "chiprun_out" / f"chain_kernel_ab_ptxas_{name}.txt"
         ).write_text(text)
    for name, p in report["ptxas"].items():
        print(f"ptxas {name}: {p}", flush=True)

    g = torch.Generator(device=dev).manual_seed(3)
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
    report["seconds"] = time.perf_counter() - t0

    with open(ROOT / "chiprun_out" / "chain_kernel_ab.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({
        "equal_to_checkout": {c: r["equal_to_checkout"]
                              for c, r in report["cases"].items()},
        "ms_mean": {c: {n: sum(v) / len(v) for n, v in
                        r["ms_per_launch"].items() if v}
                    for c, r in report["cases"].items()},
        "seconds": report["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
