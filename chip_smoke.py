#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's DRMLT path render once on one GPU.

    python3 chip_smoke.py

Phases (each prints one line naming the device; any failure exits
non-zero):
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: nvcc builds csrc/ (time, and each kernel's registers / spills /
     shared memory from ptxas);
  3. path kernel vs its plain twin: 65536 lanes, depth 8, 256x256 Cornell
     box with a diffuse, mirror and glass tall box;
  4. chain kernel vs its twin on identical uniforms: 4096 chains, n_mut 2,
     orbital / green / mira x three / sampled, plus the Philox stream
     (chains, film and per-chain stats compared);
  5. the slice: render_drmlt_path at 65536 chains, 256x256, depth 8,
     orbital, sampled splat, ~256 mutations per pixel (a first call, then
     the timed warm call), checked against a Monte-Carlo render_pt through
     the path kernel; both kernels' launch counters must be above 0 after
     it; then one more warm render under torch.profiler for the device-busy
     share and each kernel's device time;
  6. the chain kernel vs its twin at the slice's shape (65536 chains x
     64 mutations from the slice's final state, Philox and uniforms), then
     each kernel's time against its twin's at the slice's shapes (CUDA
     events, after a warm-up).
Then one JSON line of kernels, and last one JSON line
{"ok": true, "device": {...}}.  Details also go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from drmlt_mitsuba_tpu_torch.integrators.drmlt import (  # noqa: E402
    DRMLTConfig, render_drmlt_path,
)
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig  # noqa: E402
from drmlt_mitsuba_tpu_torch.integrators.mcmc import (  # noqa: E402
    state_from_splats,
)
from drmlt_mitsuba_tpu_torch.integrators.path import (  # noqa: E402
    make_path_trace, render_pt,
)
from drmlt_mitsuba_tpu_torch.ops import build  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT  # noqa: E402
from drmlt_mitsuba_tpu_torch.render import film as filmlib  # noqa: E402
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box  # noqa: E402

SIZE = 256
DEPTH = 8
CHAINS = 65536
# lane tolerances: the library is built with --fmad=false, so kernel and
# twin round alike; lanes may still differ where the CUDA math library and
# PyTorch's kernels differ in a transcendental's last bit and a hit or a
# coin sits on that edge.  Held to the reference's own kernel-vs-XLA
# allowance (tests/test_megatrace.py: 0.2% of lanes, means to 5e-3).
MAX_BAD_LANES = 0.002
MEAN_RTOL = 5e-3


class Fail(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise Fail(msg)


def sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, runs, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(runs):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / runs


def ptxas_report(text):
    """{kernel: 'N registers, S spill stores, L spill loads, smem B'}."""
    out = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(1)),
                                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
            m2 = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = int(m2.group(1)) if m2 else 0
    return out


def lane_diff(a, b):
    """(max abs, mean abs, share of lanes with rel diff > 1e-3) of (3, R)."""
    a = a.double()
    b = b.double()
    d = (a - b).abs()
    rel = d / (b.abs() + 1e-3)
    return (float(d.max()), float(d.mean()),
            float((rel > 1e-3).any(0).double().mean()))


def device_profile(events, wall_s):
    """(busy share, {kernel: (device ms, launches)}) from the device-side
    events of a torch.profiler trace: the union of their intervals over
    wall_s.  Host operator rows are skipped, so no interval counts twice."""
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in dev):
        if b > end:             # microseconds
            busy += b - max(a, end)
            end = b
    per = {}
    for e in dev:
        t, n = per.get(e.name, (0.0, 0))
        per[e.name] = (t + e.time_range.elapsed_us() / 1e3, n + 1)
    return busy / 1e6 / wall_s, per


def compare_chain(tables, cfg, n_mut, state0, size, seed, launch, uni):
    """Run the chain kernel and its twin from state0 on separate clones of
    the state, film and stats; returns lane agreement (the share of chains
    whose PSS rows agree to 2e-5), the films' relative L1 difference, the
    largest state difference over agreeing chains and the stats' sums."""
    out = []
    for fn in (MD.drmlt_path_step, MD.drmlt_path_step_reference):
        st = state0.clone()
        film = torch.zeros((size, size, 3), device=state0.device)
        stats = torch.zeros((6, state0.shape[1]), device=state0.device)
        fn(tables, cfg, n_mut, st, film, stats, seed, launch, uni)
        torch.cuda.synchronize()
        out.append((st, film, stats))
    (sk, fk, tk), (sr, fr, tr) = out
    D = sk.shape[0] - 6
    ok = (sk[:D] - sr[:D]).abs().max(0).values <= 2e-5
    return dict(lane_agreement=float(ok.double().mean()),
                film_rel_l1=float((fk - fr).abs().sum() / fr.abs().sum()),
                state_max_abs=(float((sk - sr)[:, ok].abs().max())
                               if bool(ok.any()) else float("inf")),
                stats_kernel=tk.sum(1).tolist(), stats_twin=tr.sum(1).tolist(),
                stats_agree=bool(torch.allclose(tk.sum(1), tr.sum(1),
                                                rtol=1e-2, atol=1.0)))


def check_chain(tag, r):
    need(r["lane_agreement"] >= 1.0 - MAX_BAD_LANES * 5,
         f"{tag}: lanes disagree")
    need(r["film_rel_l1"] <= 1e-2, f"{tag}: films differ")
    need(r["stats_agree"], f"{tag}: stats differ: {r['stats_kernel']} vs "
         f"{r['stats_twin']}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    report = {"device": name}

    # ---- 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    print(smi)
    print(f"[1 device] {name}: torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # ---- 2. build -----------------------------------------------------------
    build.load()
    regs = ptxas_report(build.build_info["ptxas"])
    report["build"] = dict(seconds=build.build_info["seconds"],
                           cached=build.build_info["cached"], ptxas=regs)
    for k in ("path_trace_kernel", "drmlt_path_kernel"):
        need(any(k in n for n in regs), f"ptxas reported no {k}")
    print(f"[2 build] {name}: nvcc {build.build_info['seconds']:.1f} s "
          f"(cached={build.build_info['cached']}); " + "; ".join(
              f"{n}: {r}" for n, r in regs.items()))

    pcfg = PathConfig(max_depth=DEPTH, rr_depth=100, min_depth=1)
    D = pcfg.n_dims + pcfg.n_dims % 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    # ---- 3. path kernel vs twin ---------------------------------------------
    path_err = 0.0
    report["path_vs_twin"] = {}
    for tall in ("diffuse", "mirror", "glass"):
        scene = cornell_box(SIZE, SIZE, tall_box_material=tall)
        tables = MT.make_tables(scene, pcfg, dev)
        uT = torch.rand((pcfg.n_dims, CHAINS), generator=gen, device=dev)
        k = MT.path_trace(tables, uT)
        torch.cuda.synchronize()
        t = MT.path_trace_reference(tables, uT)
        mx, mean, bad = lane_diff(k, t)
        m_rel = float(((k.double().mean(1) - t.double().mean(1)).abs()
                       / t.double().mean(1).abs()).max())
        report["path_vs_twin"][tall] = dict(max_abs=mx, mean_abs=mean,
                                            bad_lanes=bad, mean_rel=m_rel)
        print(f"[3 path kernel vs twin] {name}: {tall}: max |d| {mx:.3e}, "
              f"mean |d| {mean:.3e}, lanes differing {bad:.5f}, "
              f"channel-mean rel {m_rel:.2e}")
        need(bool(torch.isfinite(k).all()), f"{tall}: non-finite radiance")
        need(bad <= MAX_BAD_LANES, f"{tall}: {bad:.4f} of lanes differ")
        need(m_rel <= MEAN_RTOL, f"{tall}: channel means differ {m_rel}")
        path_err = max(path_err, mx)

    # ---- 4. chain kernel vs twin --------------------------------------------
    scene = cornell_box(SIZE, SIZE)
    tables = MT.make_tables(scene, pcfg, dev)
    trace = make_path_trace(scene, pcfg, dev)
    C4 = 4096
    cand = torch.rand((16 * C4, D), generator=gen, device=dev)
    lum = trace(cand).lum
    u0 = cand[torch.nonzero(lum > 0)[:C4, 0]]
    need(u0.shape[0] == C4, "too few valid starting states")
    state0 = MD.pack_chain_state(state_from_splats(u0, trace(u0)))
    chain_err = 0.0
    report["chain_vs_twin"] = {}
    cases = [(t, s, True) for t in ("orbital", "green", "mira")
             for s in ("three", "sampled")] + [("orbital", "sampled", False)]
    for drtype, mode, given in cases:
        ccfg = DRMLTConfig(type=drtype, splat_mode=mode, n_chains=C4)
        uni = (torch.rand((2 * MD.n_rand(ccfg, D), C4), generator=gen,
                          device=dev) if given else None)
        r = compare_chain(tables, ccfg, 2, state0, SIZE, 77, 3, uni)
        tag = f"{drtype}/{mode}/{'uniforms' if given else 'philox'}"
        report["chain_vs_twin"][tag] = r
        print(f"[4 chain kernel vs twin] {name}: {tag}: lanes agreeing "
              f"{r['lane_agreement']:.5f}, film rel L1 "
              f"{r['film_rel_l1']:.2e}, state max |d| "
              f"{r['state_max_abs']:.2e}, stats (a1 a2 accept1 accept2 "
              f"large moved) {r['stats_kernel']} vs {r['stats_twin']}")
        check_chain(tag, r)
        chain_err = max(chain_err, r["state_max_abs"])

    # ---- 5. the slice -------------------------------------------------------
    cfg = DRMLTConfig(type="orbital", n_chains=CHAINS, n_bootstrap=100_000,
                      p_large=0.3, splat_mode="sampled")
    fc = filmlib.make_film_config(SIZE, SIZE, "box")
    n_steps = SIZE * SIZE * 256 // CHAINS
    # the first render in a process also pays one-off allocator and
    # library set-up (0.14-0.20 s against ~0.12 s warm on the card), so it
    # is timed on its own and the metric is a second, warm render
    gen.manual_seed(6)
    _, first_wall = sync_time(lambda: render_drmlt_path(
        scene, pcfg, cfg, fc, gen, n_steps))
    gen.manual_seed(7)
    build.reset_launches()
    (img, aux), wall = sync_time(lambda: render_drmlt_path(
        scene, pcfg, cfg, fc, gen, n_steps))
    launches = dict(build.LAUNCHES)
    n_mutations = CHAINS * aux["steps"]
    finite = bool(torch.isfinite(img).all())
    b = float(aux["b"])
    acc2 = float(aux["stats"]["accept2"])
    gen.manual_seed(8)
    ref_film, ref_wall = sync_time(lambda: render_pt(
        scene, pcfg, gen, SIZE * SIZE * 64, fc, mode="accum"))
    ref = filmlib.develop(fc, ref_film, mode="accum")
    m_img = img.double().mean((0, 1))
    m_ref = ref.double().mean((0, 1))
    mean_rel = float((m_img - m_ref).abs().mean() / m_ref.mean())
    blk = SIZE // 16
    bi = img.double().reshape(16, blk, 16, blk, 3).mean((1, 3))
    br = ref.double().reshape(16, blk, 16, blk, 3).mean((1, 3))
    block_l1 = float((bi - br).abs().sum() / br.abs().sum())
    report["slice"] = dict(
        b=b, wall_s=wall, first_wall_s=first_wall, mutations=n_mutations,
        mutations_per_s=n_mutations / wall, steps=aux["steps"],
        image_mean=m_img.tolist(), ref_mean=m_ref.tolist(),
        mean_rel_err=mean_rel, block_rel_l1=block_l1, accept2=acc2,
        accept1=float(aux["stats"]["accept1"]), finite=finite,
        launches=launches, ref_wall_s=ref_wall)
    print(f"[5 slice] {name}: b {b:.6f}, warm wall {wall:.3f} s for "
          f"{n_mutations} mutations ({n_mutations / wall:.4e} mutations/s, "
          f"bootstrap included; first call {first_wall:.3f} s), "
          f"image mean {m_img.tolist()}, finite "
          f"{finite}, vs MC mean rel {mean_rel:.4f}, 16x16-block rel L1 "
          f"{block_l1:.4f}, accept2 {acc2:.4f}, launches {launches}")
    need(finite, "slice image not finite")
    need(launches["path_trace"] > 0 and launches["drmlt_path"] > 0,
         f"a kernel of the path did not launch: {launches}")
    # MCMC-vs-MC: 16.8M mutations against 4.2M MC samples.  The image
    # scale b alone varies by 1.8% (relative std) between seeds at 106,496
    # bootstrap samples (path luminance CV ~7 on this box), so 0.08 is
    # about four of its standard deviations
    need(mean_rel < 0.08, f"slice mean differs from MC by {mean_rel}")
    need(block_l1 < 0.25, f"slice blocks differ from MC by {block_l1}")
    need(acc2 > 0.02, f"orbital stage 2 accepts too rarely ({acc2})")

    # tracing only the device: recording host operators as well slows the
    # host side of the render ~1.6x and so understates the share
    gen.manual_seed(9)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, prof_wall = sync_time(lambda: render_drmlt_path(
            scene, pcfg, cfg, fc, gen, n_steps))
    busy, per = device_profile(prof.events(), prof_wall)
    top = sorted(per.items(), key=lambda kv: -kv[1][0])
    report["slice_profile"] = dict(wall_s=prof_wall, busy_share=busy,
                                   kernels_ms=[[k, t, n] for k, (t, n) in top])
    print(f"[5 slice profile] {name}: device busy {busy:.4f} of a "
          f"{prof_wall:.3f} s render; " + "; ".join(
              f"{k.split('(')[0][:60]} {t:.3f} ms x{n}"
              for k, (t, n) in top[:4]))
    need(busy > 0, "the profiler saw no device activity")

    # ---- 6. chain kernel vs twin at the slice's shape; timing ---------------
    report["chain_vs_twin_slice_shape"] = {}
    for given in (False, True):
        uni = (torch.rand((64 * MD.n_rand(cfg, D), CHAINS), generator=gen,
                          device=dev) if given else None)
        r = compare_chain(tables, cfg, 64, aux["state"], SIZE, 5, 0, uni)
        del uni
        tag = f"orbital/sampled/{'uniforms' if given else 'philox'}"
        report["chain_vs_twin_slice_shape"][tag] = r
        print(f"[6 chain kernel vs twin, {CHAINS} chains x 64 mutations] "
              f"{name}: {tag}: lanes agreeing {r['lane_agreement']:.5f}, "
              f"film rel L1 {r['film_rel_l1']:.2e}, state max |d| "
              f"{r['state_max_abs']:.2e}, stats {r['stats_kernel']} vs "
              f"{r['stats_twin']}")
        check_chain(tag, r)
        chain_err = max(chain_err, r["state_max_abs"])

    uT = torch.rand((pcfg.n_dims, CHAINS), generator=gen, device=dev)
    ms_path = event_ms(lambda: MT.path_trace(tables, uT), runs=20)
    plain_path = event_ms(lambda: MT.path_trace_reference(tables, uT),
                          runs=3)
    # kernel and twin each advance their own copy of the slice's state; the
    # twin ran twice at this shape just above, which is its warm-up
    states = [aux["state"].clone() for _ in range(2)]
    films = [torch.zeros((SIZE, SIZE, 3), device=dev) for _ in range(2)]
    stats = [torch.zeros((6, CHAINS), device=dev) for _ in range(2)]
    ms_chain = event_ms(lambda: MD.drmlt_path_step(
        tables, cfg, 64, states[0], films[0], stats[0], 5, 0), runs=5)
    plain_chain = event_ms(lambda: MD.drmlt_path_step_reference(
        tables, cfg, 64, states[1], films[1], stats[1], 5, 0), runs=1,
        warmup=0)
    report["timing_ms"] = dict(path_trace=ms_path, path_trace_plain=plain_path,
                               drmlt_path_n_mut64=ms_chain,
                               drmlt_path_plain_n_mut64=plain_chain)
    print(f"[6 timing] {name}: path_trace_kernel {ms_path:.3f} ms vs twin "
          f"{plain_path:.3f} ms ({CHAINS} lanes, depth {DEPTH}); "
          f"drmlt_path_kernel {ms_chain:.3f} ms vs twin {plain_chain:.3f} ms "
          f"({CHAINS} chains x 64 mutations = "
          f"{CHAINS * 64 / (ms_chain / 1e3):.4e} mutations/s)")

    kernels = [
        dict(name="path_trace_kernel", route="cuda",
             source="drmlt_mitsuba_tpu_torch/csrc/path_trace.cu",
             replaces="drmlt_mitsuba_tpu/ops/pallas/megatrace.py:1555",
             launches=launches["path_trace"], max_abs_err=path_err,
             ms=ms_path, plain_ms=plain_path),
        dict(name="drmlt_path_kernel", route="cuda",
             source="drmlt_mitsuba_tpu_torch/csrc/drmlt_path.cu",
             replaces="drmlt_mitsuba_tpu/ops/pallas/megadrmlt.py:105",
             launches=launches["drmlt_path"], max_abs_err=chain_err,
             ms=ms_chain, plain_ms=plain_chain),
    ]
    report["kernels"] = kernels
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
