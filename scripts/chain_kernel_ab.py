#!/usr/bin/env python3
"""Time the PyTorch port's chain kernel against other builds of it, in
turns, in one process on one GPU.

    python3 scripts/chain_kernel_ab.py --other parent=DIR [--other NAME=DIR]

Each DIR holds the `.cu` / `.cuh` sources of another revision's
`drmlt_mitsuba_tpu_torch/csrc/`, for example

    git archive <commit> drmlt_mitsuba_tpu_torch/csrc | tar -x -C build/base
    ... --other base=build/base/drmlt_mitsuba_tpu_torch/csrc

Each is compiled with the port's nvcc flags in one `nvcc -shared` command
into a library of its own under build/chain_ab/; the checkout's own
kernels come from ops/build.py.  A build's entry point is
`drmlt_chain_launch` (the template over the trace body) or
`drmlt_path_launch` (slice 1's path-only kernel); a build from before
the pssmlt mode is called without its flag, one from before the full
scene scope (no SceneExt) without the scene-scope arguments too, and one
from before the BVH walk (no bvh.cuh) without the node-table arguments.

On cornell_box(256, 256) (`--scene cornell`, the instantiation of
slices 1-4) or cornell_scope(256, 256, "const") (`--scene const`, the
full scene scope, which every build compared must have),
PathConfig(max_depth=8, rr_depth=100) and orbital DRMLT with the sampled
splat at 65,536 chains it reports:
  * ms per launch of 64 mutations in path mode (CUDA events over 3
    launches after one warm-up), every build in the order A B ... B A,
    --rounds times; and the same in mmlt mode at k = 6 for the builds
    that have it;
  * whether each build's states and stats after one launch are bit for bit
    those of the checkout's kernel from the same start and Philox seed;
  * each build's ptxas registers, stack and spills;
  * the build time of the checkout's csrc/: one nvcc per source in
    parallel (ops/build.py) against one nvcc command for all sources, in
    turns.
Prints one JSON line and writes chiprun_out/chain_kernel_ab.json
(chain_kernel_ab_const.json with `--scene const`).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from drmlt_mitsuba_tpu_torch.integrators import kernels  # noqa: E402
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
_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
PATH_LAUNCH_SIG = [
    _P, _I, _P, _I, _P, _I, _P,            # tri, T, mat, M, em, E, cam
    _I, _I, _I, _I,                        # max/min/rr depth, use_nee
    _P, _P, _I, _I,                        # state, scratch, D, C
    _P, _I, _I, _P,                        # film, H, W, stats
    _P, _I, _I, _U, _U,                    # uniforms, n_rand, n_mut, seed,
    #                                        launch
    _I, _I, _I,                            # drtype, sampled, timid
    _F, _F, _F, _F, _F, _F,                # p_large, s1, s2, log_ratio,
    #                                        sigma2, dispersion
    _P,                                    # stream
]


def ptxas(text):
    """{entry: {registers, stack, spill_stores}} from ptxas -v output."""
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes cumulative stack",
                      line)
        if m and cur:
            out.setdefault(cur, {}).update(registers=int(m.group(1)),
                                           stack=int(m.group(2)))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and cur:
            out.setdefault(cur, {})["spill_stores"] = int(m.group(1))
    return out


def build_single(src: Path, out: Path):
    """One `nvcc -shared` over every .cu of src: (seconds, ptxas text)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
           *sorted(str(p) for p in src.glob("*.cu"))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{res.stderr}")
    return time.perf_counter() - t0, res.stdout + res.stderr


# the scene-scope arguments after the node table (ops/build.py:_SCENE),
# the last of them the `full` flag
N_SCOPE = 16
# the index of drmlt_chain_launch's `pssmlt` flag: the scene, then 25
# arguments up to fix_emitter_path (ops/build.py:_SIGNATURES)
PSS_ARG = len(build._SCENE) + 25


class _OlderBuild:
    """A build from before the pssmlt mode, and perhaps from before the full
    scene scope (no SceneExt in path_trace.cuh) and the BVH walk (no
    bvh.cuh): its drmlt_chain_launch lacks those arguments, which are
    dropped."""

    def __init__(self, lib, walk, scoped):
        self.lib, self.walk, self.scoped = lib, walk, scoped

    def drmlt_chain_launch(self, *args):
        args = list(args)
        if args.pop(PSS_ARG):
            raise ValueError("this build has no pssmlt mode")
        if not self.scoped:
            if args[10] and not self.walk:
                raise ValueError("this build cannot walk a BVH")
            if args[10 + N_SCOPE]:
                raise ValueError("this build has the scene scope of slices "
                                 "1-4")
            args = (args[:7] + (args[7:11] if self.walk else [])
                    + args[11 + N_SCOPE:])
        return self.lib.drmlt_chain_launch(*args)


def load(path: Path, src: Path):
    """(library, entry name) with its argument types set."""
    lib = ctypes.CDLL(str(path))
    if hasattr(lib, "drmlt_chain_launch"):
        entry, sig = "drmlt_chain_launch", list(build._SIGNATURES[
            "drmlt_chain_launch"])
        if "int pssmlt" not in (src / "drmlt_chain.cu").read_text():
            del sig[PSS_ARG]
            walk = (src / "bvh.cuh").exists()
            scoped = "SceneExt" in (src / "path_trace.cuh").read_text()
            if not scoped:
                sig = (sig[:7] + (sig[7:11] if walk else [])
                       + sig[11 + N_SCOPE:])
            lib.drmlt_chain_launch.argtypes = sig
            lib.drmlt_chain_launch.restype = ctypes.c_int
            return _OlderBuild(lib, walk, scoped), entry
    else:
        entry, sig = "drmlt_path_launch", PATH_LAUNCH_SIG
    fn = getattr(lib, entry)
    fn.argtypes = sig
    fn.restype = ctypes.c_int
    return lib, entry


def step(lib, entry, tables, cfg, state, film, stats, seed, launch):
    """One launch of N_MUT mutations of `lib`'s chain kernel (Philox)."""
    if entry == "drmlt_chain_launch":
        saved, build._lib = build._lib, lib
        try:
            MD.drmlt_chain_step(tables, cfg, N_MUT, state, film, stats, seed,
                                launch)
        finally:
            build._lib = saved
        return
    D, C = state.shape[0] - 6, state.shape[1]
    kel = MD.stage1_kernel(cfg)
    scratch = torch.empty((2 * D, C), dtype=torch.float32,
                          device=state.device)
    rc = lib.drmlt_path_launch(
        *MT.table_args(tables)[:7], *MT.table_args(tables)[11 + N_SCOPE:],
        state.data_ptr(), scratch.data_ptr(), D, C,
        film.data_ptr(), film.shape[0], film.shape[1], stats.data_ptr(),
        None, MD.n_rand(cfg, D), N_MUT, seed, launch,
        MD._DRTYPE_CODE[cfg.type], int(cfg.splat_mode == "sampled"),
        int(cfg.timid_after_large), cfg.p_large, kel.s1, kel.s2,
        kel.log_ratio, cfg.scale_second * cfg.sigma,
        kernels.WrappedCauchy(cfg.rho).dispersion,
        torch.cuda.current_stream(state.device).cuda_stream)
    build.check(rc, "drmlt_path_launch")


def fresh(s0):
    dev = s0.device
    return (s0.clone(), torch.zeros((SIZE, SIZE, 3), device=dev),
            torch.zeros((6, s0.shape[1]), device=dev))


def time_ms(lib, entry, tables, cfg, s0):
    st, film, stats = fresh(s0)
    step(lib, entry, tables, cfg, st, film, stats, 5, 0)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for i in range(3):
        step(lib, entry, tables, cfg, st, film, stats, 5, i + 1)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / 3


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=DIR", help="another revision's csrc/")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--scene", choices=("cornell", "const"),
                    default="cornell")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chain_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    report = dict(device=smi)

    # build time of the checkout's sources: parallel (ops/build.py) vs one
    # command, in turns; the last parallel build is the library used below
    single = build.BUILD_DIR.parent / "chain_ab" / "single.so"
    times = {"parallel": [], "single": []}
    for kind in ("single", "parallel", "parallel", "single", "parallel"):
        if kind == "single":
            times[kind].append(build_single(build.CSRC, single)[0])
        else:
            build.library_path().unlink(missing_ok=True)
            build._lib = None
            build.load()
            times[kind].append(build.build_info["seconds"])
    report["build_s"] = times
    print(f"build seconds {times}", flush=True)

    libs = {"checkout": (build.load(), "drmlt_chain_launch")}
    report["ptxas"] = {"checkout": ptxas(build.build_info["ptxas"])}
    for spec in args.other:
        name, d = spec.split("=", 1)
        out = build.BUILD_DIR.parent / "chain_ab" / f"{name}.so"
        _, text = build_single(Path(d), out)
        libs[name] = load(out, Path(d))
        report["ptxas"][name] = ptxas(text)
    for name, p in report["ptxas"].items():
        print(f"ptxas {name}: {p}", flush=True)

    g = torch.Generator(device=dev).manual_seed(3)
    scene = (cornell_box(SIZE, SIZE) if args.scene == "cornell"
             else cornell_scope(SIZE, SIZE, "const"))
    report["scene"] = args.scene
    pcfg = PathConfig(max_depth=8, rr_depth=100, min_depth=1)
    tables = MT.make_tables(scene, pcfg, dev)
    trace = make_path_trace(scene, pcfg, dev)
    D = pcfg.n_dims + pcfg.n_dims % 2
    u = torch.rand((16 * CHAINS, D), device=dev, generator=g)
    u = u[torch.nonzero(trace(u).lum > 0)[:CHAINS, 0]]
    cases = {"path": (tables, MD.pack_chain_state(
        state_from_splats(u, trace(u))))}
    trace6, _, n6, mt6 = make_mmlt_trace_fixed(scene, 6, True, dev)
    ub = torch.rand((3 * 8192, n6), device=dev, generator=g)
    lums, _ = group_bootstrap(trace6, ub)
    cases["mmlt_k6"] = (mt6, MD.pack_chain_state(group_starts(
        trace6, ub, lums, torch.rand(CHAINS, device=dev, generator=g))))
    cfg = DRMLTConfig(type="orbital", n_chains=CHAINS, n_bootstrap=100_000,
                      p_large=0.3, splat_mode="sampled")

    # bit equality with the checkout's kernel after one launch
    report["equal_to_checkout"] = {}
    for case, (tb, s0) in cases.items():
        outs = {}
        for name, (lib, entry) in libs.items():
            if case != "path" and entry != "drmlt_chain_launch":
                continue
            st, film, stats = fresh(s0)
            step(lib, entry, tb, cfg, st, film, stats, 11, 0)
            outs[name] = (st, stats)
        ref = outs["checkout"]
        report["equal_to_checkout"][case] = {
            n: bool(torch.equal(o[0], ref[0]) and torch.equal(o[1], ref[1]))
            for n, o in outs.items()}
    print(f"states and stats equal to the checkout's: "
          f"{report['equal_to_checkout']}", flush=True)

    report["ms_per_64_mutations"] = {}
    for case, (tb, s0) in cases.items():
        names = [n for n, (_, e) in libs.items()
                 if case == "path" or e == "drmlt_chain_launch"]
        res = {n: [] for n in names}
        for _ in range(args.rounds):
            for n in names + names[::-1]:
                res[n].append(time_ms(*libs[n], tb, cfg, s0))
        report["ms_per_64_mutations"][case] = res
        print(f"{case} ms per {N_MUT} mutations x {CHAINS} chains: " +
              "; ".join(f"{n} mean {sum(v) / len(v):.3f} "
                        f"{[round(x, 3) for x in v]}"
                        for n, v in res.items()), flush=True)

    os.makedirs(ROOT / "chiprun_out", exist_ok=True)
    out = "chain_kernel_ab" + ("" if args.scene == "cornell" else "_const")
    with open(ROOT / "chiprun_out" / f"{out}.json", "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"equal_to_checkout": report["equal_to_checkout"],
                      "ms_mean": {c: {n: sum(v) / len(v) for n, v in r.items()}
                                  for c, r in
                                  report["ms_per_64_mutations"].items()},
                      "build_s": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
