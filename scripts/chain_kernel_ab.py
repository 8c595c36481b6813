#!/usr/bin/env python3
"""Time the PyTorch port's chain kernel against other builds of it, in
turns, in one process on one GPU.

    python3 scripts/chain_kernel_ab.py --other parent=DIR [--other NAME=DIR]
        [--scene cornell const] [--type orbital green mira] [--rounds 3]

Each DIR holds the `.cu` / `.cuh` sources of another revision's
`drmlt_mitsuba_tpu_torch/csrc/` whose `drmlt_chain_launch` takes the
checkout's arguments (ops/build.py), for example the parent commit's

    git archive HEAD~1 drmlt_mitsuba_tpu_torch/csrc | tar -x -C build/base
    ... --other parent=build/base/drmlt_mitsuba_tpu_torch/csrc

or a copy of the checkout's with one constant changed.  Each is compiled
with the port's nvcc flags in one `nvcc -shared` command into a library
of its own under build/chain_ab/; the checkout's own kernels come from
ops/build.py.

On cornell_box(256, 256) (`cornell`, the instantiation of slices 1-4)
and cornell_scope(256, 256, "const") (`const`, the full scene scope),
PathConfig(max_depth=8, rr_depth=100) in path mode and the k = 6 group in
mmlt mode, 65,536 chains, DRMLT of each --type with the sampled splat, it
reports per case:
  * the twin's stage-2 share (the chains whose z it traced) and, for
    green, the y* share, on the first 4,096 chains over 2 mutations;
  * whether each build's states and stats after one launch of 64
    mutations are bit for bit those of the checkout's kernel from the
    same start and Philox seed;
  * ms per launch of 64 mutations (CUDA events over 3 launches after one
    warm-up), every build in the order A B ... B A, --rounds times
    (--rounds 0: no timing);
and each build's ptxas registers, stack and spills.  Prints one JSON line
and writes chiprun_out/chain_kernel_ab.json.
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
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT  # noqa: E402
from drmlt_mitsuba_tpu_torch.scene.builders import (  # noqa: E402
    cornell_box, cornell_scope,
)

CHAINS = 65536
SIZE = 256
N_MUT = 64
SHARE_CHAINS = 4096   # the twin's stage-2 share: chains x 2 mutations


def ptxas(text):
    """The chain kernels' registers, stack, spills and shared memory from
    ptxas -v output."""
    return {k: v for k, v in ptxas_report(text).items()
            if "drmlt_chain_kernel" in k}


def build_single(src: Path, out: Path):
    """One `nvcc -shared` over every .cu of src: (library, ptxas text)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
           *sorted(str(p) for p in src.glob("*.cu"))]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.drmlt_chain_launch.argtypes = build._SIGNATURES["drmlt_chain_launch"]
    lib.drmlt_chain_launch.restype = ctypes.c_int
    return lib, res.stdout + res.stderr


def step(lib, tables, cfg, state, film, stats, seed, launch):
    """One launch of N_MUT mutations of `lib`'s chain kernel (Philox)."""
    saved, build._lib = build._lib, lib
    try:
        MD.drmlt_chain_step(tables, cfg, N_MUT, state, film, stats, seed,
                            launch)
    finally:
        build._lib = saved


def fresh(s0):
    dev = s0.device
    return (s0.clone(), torch.zeros((SIZE, SIZE, 3), device=dev),
            torch.zeros((6, s0.shape[1]), device=dev))


def time_ms(lib, tables, cfg, s0):
    st, film, stats = fresh(s0)
    step(lib, tables, cfg, st, film, stats, 5, 0)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(3):
        step(lib, tables, cfg, st, film, stats, 5, i + 1)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / 3


def starts(scene_name, dev, g):
    """{technique: (tables, packed starting state)} on one scene."""
    scene = (cornell_box(SIZE, SIZE) if scene_name == "cornell"
             else cornell_scope(SIZE, SIZE, "const"))
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR", help="another revision's csrc/")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--scene", nargs="+", choices=("cornell", "const"),
                    default=["cornell"])
    ap.add_argument("--type", nargs="+", choices=("orbital", "green", "mira"),
                    default=["orbital"])
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
    for spec in args.other:
        name, d = spec.split("=", 1)
        libs[name], text = build_single(
            Path(d), build.BUILD_DIR.parent / "chain_ab" / f"{name}.so")
        report["ptxas"][name] = ptxas(text)
    for name, p in report["ptxas"].items():
        print(f"ptxas {name}: {p}", flush=True)

    g = torch.Generator(device=dev).manual_seed(3)
    for scene_name in args.scene:
        for tech, (tb, s0) in starts(scene_name, dev, g).items():
            for drtype in args.type:
                case = f"{scene_name}/{tech}/{drtype}"
                cfg = DRMLTConfig(type=drtype, n_chains=CHAINS,
                                  n_bootstrap=100_000, p_large=0.3,
                                  splat_mode="sampled")
                work = {}
                s4 = s0[:, :SHARE_CHAINS].contiguous()
                MD.drmlt_chain_step_reference(
                    tb, dataclasses.replace(cfg, n_chains=SHARE_CHAINS), 2,
                    s4, torch.zeros((SIZE, SIZE, 3), device=dev),
                    torch.zeros((6, SHARE_CHAINS), device=dev), 5, 0,
                    work=work)
                row = dict(stage2_share=MD.stage2_share(work),
                           y_rev_share=(work.get("y_rev_lanes", 0)
                                        / work["y_lanes"]))
                outs = {}
                for name, lib in libs.items():
                    st, film, stats = fresh(s0)
                    step(lib, tb, cfg, st, film, stats, 11, 0)
                    outs[name] = (st, stats)
                ref = outs["checkout"]
                row["equal_to_checkout"] = {
                    n: bool(torch.equal(o[0], ref[0])
                            and torch.equal(o[1], ref[1]))
                    for n, o in outs.items()}
                names = list(libs)
                ms = {n: [] for n in names}
                for _ in range(args.rounds):
                    for n in names + names[::-1]:
                        ms[n].append(time_ms(libs[n], tb, cfg, s0))
                row["ms_per_launch"] = ms
                report["cases"][case] = row
                print(f"{case}: stage-2 share {row['stage2_share']:.4f}, "
                      f"y* share {row['y_rev_share']:.4f}; equal to the "
                      f"checkout's {row['equal_to_checkout']}; ms per "
                      f"{N_MUT} mutations x {CHAINS} chains: " + "; ".join(
                          f"{n} mean {sum(v) / max(len(v), 1):.3f} "
                          f"{[round(x, 3) for x in v]}"
                          for n, v in ms.items()), flush=True)
    report["seconds"] = time.perf_counter() - t0

    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    with open(ROOT / "chiprun_out" / "chain_kernel_ab.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({
        "equal_to_checkout": {c: r["equal_to_checkout"]
                              for c, r in report["cases"].items()},
        "stage2_share": {c: r["stage2_share"]
                         for c, r in report["cases"].items()},
        "ms_mean": {c: {n: sum(v) / len(v) for n, v in
                        r["ms_per_launch"].items() if v}
                    for c, r in report["cases"].items()},
        "seconds": report["seconds"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
