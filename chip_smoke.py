#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's three slices once on one GPU: the DRMLT path
render, the depth-grouped DRMLT-over-MMLT render and differentiable
rendering (inverse rendering through the adjoint and splat kernels).

    python3 chip_smoke.py

Phases (each prints one line naming the device; any failure exits
non-zero):
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: nvcc builds csrc/ (time, and each kernel's registers / spills /
     stack / shared memory from ptxas);
  3. path kernel vs its plain twin: 65536 lanes, depth 8, 256x256 Cornell
     box with a diffuse, mirror and glass tall box, and the veach-door
     scene;
  4. chain kernel (path mode) vs its twin on identical uniforms: 4096
     chains, n_mut 2, orbital / green / mira x three / sampled, plus the
     Philox stream (chains, film and per-chain stats compared);
  5. slice 1: render_drmlt_path at 65536 chains, 256x256, depth 8,
     orbital, sampled splat, ~256 mutations per pixel (a first call, then
     the timed warm call), checked against a Monte-Carlo render_pt through
     the path kernel; the path kernels' launch counters must be above 0
     after it; then one more warm render under torch.profiler for the
     device-busy share and each kernel's device time;
  6. the chain kernel (path mode) vs its twin at the slice's shape (65536
     chains x 64 mutations from the slice's final state, Philox and
     uniforms), then each path kernel's time against its twin's at the
     slice's shapes (CUDA events, after a warm-up);
  7. MMLT kernel vs its twin: 65536 lanes, depths 1-6, on the Cornell box
     with the three tall-box materials and on the veach-door scene;
  8. chain kernel (mmlt mode) vs its twin: 4096 chains x 2 mutations at
     k = 6 and k = 1 (orbital / green / mira x three / sampled x uniforms /
     Philox, fix_emitter_path on for mira), and at the slice's shape
     (65536 chains x 64 mutations at k = 6 and k = 1, Philox and uniforms,
     on the Cornell box; and at k = 4, Philox, on the veach-door scene);
  9. slice 2: render_drmlt_mmlt_grouped at 65536 chains, 256x256,
     max_depth 6, orbital, ~256 mutations per pixel, on the Cornell box
     and the veach-door scene (sampled splat: first call, then the timed
     warm call; then the three-state splat, warm), each against a
     Monte-Carlo render_pt (max_depth 6) through the path kernel: the
     channel means, and the image's shape (16x16 blocks, each image scaled
     to unit mean) against the noise of two MC and two MCMC renders; the
     MMLT kernels' launch counters must be above 0 after the Cornell render;
     one more warm render per scene under torch.profiler for the
     device-busy share, each kernel's device time and the chain kernel's
     time per depth group; and the spread of the image scale b over 32
     bootstrap seeds per scene;
 10. each MMLT kernel's time against its twin's at the slice's shapes;
 11. slice 3, the splat kernel vs its twin: the 65,536 box-filter taps of a
     render_pt chunk into a 256x256 film (per-pixel sums to rtol 1e-5, the
     backward gather exact), timed against the twin and index_add_;
 12. the adjoint kernels (radiance, albedo) vs their twins: 65,536 lanes,
     max_depth 6, rr_depth 5, on the Cornell box with each tall box and on
     the veach door (rgb bit-equal on >= 99.8% of lanes, Jacobian rows to
     rtol 1e-5 there, the gradient of mean(lum) through the kernels vs the
     twins' rows), each kernel's time, and grad-paths/s as the JAX bench
     defines it (forward + backward, 16 calls);
 13. the replay gradient (path kernel forward, autograd of the twin
     backward) at rr_depth 100 against the adjoint kernels' gradients (rtol
     1e-3), grad_replay_paths_per_sec and the replay's peak memory;
 14. slice 3's main path, inverse rendering: 40 Adam steps (lr 0.25) on
     the red wall's albedo through sigmoid(param), and then on the light's
     radiance scale, each with a per-pixel image loss through the splat
     kernel against a target rendered with the same 65,536 lanes; the
     launch counters are reset before and read after it.
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

from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig  # noqa: E402
from drmlt_mitsuba_tpu_torch.integrators.drmlt import (  # noqa: E402
    DRMLTConfig, render_drmlt_path,
)
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig  # noqa: E402
from drmlt_mitsuba_tpu_torch.integrators.mcmc import (  # noqa: E402
    state_from_splats,
)
from drmlt_mitsuba_tpu_torch.integrators.mmlt_grouped import (  # noqa: E402
    N_MUT, group_bootstrap, group_starts, make_mmlt_trace_fixed,
    render_drmlt_mmlt_grouped,
)
from drmlt_mitsuba_tpu_torch.integrators.path import (  # noqa: E402
    make_path_trace, render_pt,
)
from drmlt_mitsuba_tpu_torch.core.spectrum import (  # noqa: E402
    LUMINANCE_WEIGHTS,
)
from drmlt_mitsuba_tpu_torch.ops import build  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import splat as SP  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megammlt as MM  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT  # noqa: E402
from drmlt_mitsuba_tpu_torch.render import film as filmlib  # noqa: E402
from drmlt_mitsuba_tpu_torch.scene.builders import (  # noqa: E402
    cornell_box, veach_door,
)

SIZE = 256
DEPTH = 8
MMLT_DEPTH = 6
CHAINS = 65536
B_SEEDS = 32     # bootstrap seeds for the spread of b (phase 9)
# slice 3 (the JAX bench's differentiable-rendering config, bench.py:211)
GRAD_DEPTH, GRAD_RR = 6, 5
GRAD_CALLS = 16  # forward + backward calls per grad-paths/s figure
ADAM_STEPS = 40
C4 = 4096        # chains of the short kernel-vs-twin comparisons
# lane tolerances: the library is built with --fmad=false, so kernel and
# twin round alike; lanes may still differ where the CUDA math library and
# PyTorch's kernels differ in a transcendental's last bit and a hit or a
# coin sits on that edge.  Held to the reference's own kernel-vs-XLA
# allowances (tests/test_megatrace.py: 0.2% of lanes, means to 5e-3;
# tests/test_megammlt.py: R/250 lanes, i.e. >= 99.6% agreeing)
MAX_BAD_LANES = 0.002
MAX_BAD_LANES_MMLT = 0.004
MEAN_RTOL = 5e-3
# MCMC-vs-MC gates on the image mean (channel-mean relative error).  The
# image's mean luminance is the bootstrap's b, so each gate sits about four
# relative standard deviations of b out, b's spread over bootstrap seeds
# measured on the H100 (PERF.md): path 1.8% (64 seeds), MMLT Cornell box
# 0.46% and veach door 4.3% (32 seeds each, phase 9)
MC_GATE = {"path": 0.08, "cornell": 0.02, "veach": 0.18}
# the slice-2 image's shape against MC (shape_l1): at most this multiple of
# what the noise of two MC renders and of two MCMC renders, each measured
# in the same run, predicts for one of each (about 1 when neither image is
# biased)
SHAPE_GATE = 1.5
# published H100 SXM peaks at 700 W (NVIDIA data sheet): HBM bandwidth and
# FP32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12


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


def device_ms(fn, runs):
    """(device ms per call, device busy share of the window): the summed
    device time of every kernel `fn` launches, from torch.profiler, over
    `runs` calls after a warm-up.  For kernels too short for CUDA events
    to separate from the host's launch overhead."""
    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = sync_time(lambda: [fn() for _ in range(runs)])
    busy, per = device_profile(prof.events(), wall)
    return sum(t for t, _ in per.values()) / runs, busy


def bound(n_bytes, tri_tests):
    """(least ms for the work on the card, which side binds it): the bytes
    each input read once and each output written once over the HBM rate,
    against the ray-triangle tests the run's data needed times their FP32
    operations over the FP32 peak."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = tri_tests * MT.FLOP_PER_TRI_TEST / PEAK_FP32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def ptxas_report(text):
    """{entry function: {registers, stack, spill_stores, spill_loads, smem}}
    (stack: the entry's cumulative stack size, its callees' included)."""
    out = {}
    cur = props = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            props = m.group(1)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and props == cur:
            out.setdefault(cur, {}).update(spill_stores=int(m.group(2)),
                                           spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(cur, {})["registers"] = int(m.group(1))
            m2 = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = int(m2.group(1)) if m2 else 0
            m3 = re.search(r"(\d+) bytes cumulative stack size", line)
            out[cur]["stack"] = int(m3.group(1)) if m3 else 0
    return out


def lane_diff(a, b, pos_rows=0):
    """(max abs, mean abs, share of lanes with rel diff > 1e-3) of (n, R)
    outputs.  The last pos_rows rows are film positions, compared only on
    lanes that carry light (a zero-valued sample's position is arbitrary
    and never splatted with weight)."""
    a = a.double()
    b = b.double()
    d = (a - b).abs()
    rel = d / (b.abs() + 1e-3)
    n_val = a.shape[0] - pos_rows
    bad = (rel[:n_val] > 1e-3).any(0)
    if pos_rows:
        lit = (b[:n_val].abs() > 1e-7).any(0)
        bad = bad | ((rel[n_val:] > 1e-3).any(0) & lit)
        d = torch.cat([d[:n_val], d[n_val:] * lit])
    return float(d.max()), float(d.mean()), float(bad.double().mean())


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


def compare_chain(tables, cfg, n_mut, state0, size, seed, launch, uni,
                  work=None):
    """Run the chain kernel and its twin from state0 on separate clones of
    the state, film and stats; returns lane agreement (the share of chains
    whose PSS rows agree to 2e-5), the films' relative L1 difference, the
    largest state difference over agreeing chains, the stats' sums and the
    twin's wall seconds (work: the twin counts its ray-triangle tests)."""
    out = []
    twin_s = 0.0
    for fn in (MD.drmlt_chain_step, MD.drmlt_chain_step_reference):
        st = state0.clone()
        film = torch.zeros((size, size, 3), device=state0.device)
        stats = torch.zeros((6, state0.shape[1]), device=state0.device)
        kw = ({} if fn is MD.drmlt_chain_step or work is None
              else dict(work=work))
        _, twin_s = sync_time(lambda: fn(tables, cfg, n_mut, st, film, stats,
                                         seed, launch, uni, **kw))
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
                                                rtol=1e-2, atol=1.0)),
                twin_s=twin_s)


def check_chain(tag, r):
    need(r["lane_agreement"] >= 1.0 - MAX_BAD_LANES * 5,
         f"{tag}: lanes disagree")
    need(r["film_rel_l1"] <= 1e-2, f"{tag}: films differ")
    need(r["stats_agree"], f"{tag}: stats differ: {r['stats_kernel']} vs "
         f"{r['stats_twin']}")


def blocks(img):
    blk = SIZE // 16
    return img.double().reshape(16, blk, 16, blk, 3).mean((1, 3))


def mc_compare(img, ref):
    """(channel-mean relative error, 16x16-block relative L1)."""
    m_img = img.double().mean((0, 1))
    m_ref = ref.double().mean((0, 1))
    mean_rel = float((m_img - m_ref).abs().mean() / m_ref.mean())
    bi, br = blocks(img), blocks(ref)
    return mean_rel, float((bi - br).abs().sum() / br.abs().sum())


def shape_l1(a, b):
    """16x16-block relative L1 of a against b, each scaled to unit mean:
    where the light lands, whatever the image's scale b."""
    ba, bb = blocks(a), blocks(b)
    return float((ba / ba.mean() - bb / bb.mean()).abs().mean())


def group_launches(aux):
    """{k: chain-kernel launches} of a grouped render, in launch order."""
    out = {}
    for k, steps_eff in aux["steps_eff"].items():
        nm = 16 if aux["steps_per_group"][k - 1] < 32 else N_MUT
        out[k] = steps_eff // nm
    return out


def slice2_starts(scene, k, gen, dev):
    """The grouped driver's own bootstrap and chain starts for group k at
    the slice's size: (tables, packed state, n_dims)."""
    trace, _, n_dims, tables = make_mmlt_trace_fixed(scene, k, True, dev)
    n_total = -(-max(8192, 100_000 // MMLT_DEPTH) // 8192) * 8192
    u_boot = torch.rand((n_total, n_dims), generator=gen, device=dev)
    lums, _ = group_bootstrap(trace, u_boot)
    u_pick = torch.rand((CHAINS,), generator=gen, device=dev)
    state = group_starts(trace, u_boot, lums, u_pick)
    return tables, MD.pack_chain_state(state), n_dims


def grad_rate(step, calls):
    """(paths per second, seconds) of `calls` forward + backward calls of
    CHAINS lanes each, after one warm-up call (bench.py:245-302)."""
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return calls * CHAINS / dt, dt


def film_image(fc, sp):
    """The accum film's rgb of a batch of splats, through film.splat (the
    splat kernel on the card; differentiable in the values)."""
    scale = torch.tensor([fc.width, fc.height], dtype=torch.float32,
                         device=sp.value.device)
    film = filmlib.splat(fc, filmlib.new_film(fc, sp.value.device),
                         sp.pos[:, 0, :] * scale, sp.value[:, 0, :],
                         mode="accum")
    return film[..., :3]


def inverse_render(trace, leaf, value, p0, truth, target, u, fc,
                   steps=ADAM_STEPS):
    """The inverse-rendering loop of tests/test_gradients.py:55 with a
    per-pixel image loss: Adam (lr 0.25) on p for `steps` steps.  Returns
    (losses, recovered value, ms per step, largest error)."""
    p = p0.clone().requires_grad_()
    opt = torch.optim.Adam([p], lr=0.25)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        opt.zero_grad()
        loss = ((film_image(fc, trace(leaf(p), u)) - target) ** 2).sum()
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / steps * 1e3
    got = value(p).detach()
    return ([float(x) for x in losses], got, ms,
            float((got - truth).abs().max()))


def slice3(name, dev, gen, fc, report):
    """Phases 11-14; returns the kernels' JSON entries' numbers."""
    lum_w = torch.tensor(LUMINANCE_WEIGHTS, device=dev)
    gcfg = PathConfig(max_depth=GRAD_DEPTH, rr_depth=GRAD_RR)
    cornell = cornell_box(SIZE, SIZE)
    out = {}

    # ---- 11. splat kernel vs twin ------------------------------------------
    trace = make_path_trace(cornell, gcfg, dev)
    u = torch.rand((CHAINS, gcfg.n_dims), generator=gen, device=dev)
    sp = trace(u)
    scale = torch.tensor([SIZE, SIZE], dtype=torch.float32, device=dev)
    py, px, vals = filmlib.taps(fc, sp.pos[:, 0, :] * scale,
                                sp.value[:, 0, :], mode="accum")
    need(vals.shape[0] == CHAINS, f"{vals.shape[0]} taps")
    film0 = filmlib.new_film(fc, dev)
    k = SP.splat_add_(film0.clone(), py, px, vals)
    torch.cuda.synchronize()
    t = SP.splat_add_reference_(film0.clone(), py, px, vals)
    splat_err = float((k - t).abs().max())
    splat_ok = bool(torch.allclose(k, t, rtol=1e-5, atol=0.0))
    # the backward: the gather of the film cotangent, against the twin's
    # (autograd on the CPU)
    ct = torch.rand((SIZE, SIZE, 4), generator=gen, device=dev)
    v = vals.detach().clone().requires_grad_()
    SP.splat_add(film0, py, px, v).backward(ct)
    v_cpu = vals.detach().cpu().requires_grad_()
    SP.splat_add(film0.cpu(), py.cpu(), px.cpu(), v_cpu).backward(ct.cpu())
    gather_exact = bool(torch.equal(v.grad.cpu(), v_cpu.grad))
    # per call on the host's clock (CUDA events around back-to-back calls,
    # launch overhead included) and on the device's (profiler)
    film_k = film0.clone()
    film_t = film0.clone()
    flat = py * SIZE + px
    film_l = film0.clone().view(-1, 4)
    calls = {
        "kernel": lambda: SP.splat_add_(film_k, py, px, vals),
        "twin": lambda: SP.splat_add_reference_(film_t, py, px, vals),
        "index_add_": lambda: film_l.index_add_(0, flat, vals)}
    call_ms = {k: event_ms(fn, runs=200, warmup=5) for k, fn in calls.items()}
    dev_ms = {k: device_ms(fn, runs=50)[0] for k, fn in calls.items()}
    ms_splat, plain_splat, lib_splat = (dev_ms["kernel"], dev_ms["twin"],
                                        dev_ms["index_add_"])
    # film read and written, int32 indices and f32 values read once
    bound_splat = bound(2 * nbytes(film0) + nbytes(py, px, vals), 0)
    report["splat_vs_twin"] = dict(
        taps=CHAINS, max_abs=splat_err, rtol_1e5=splat_ok,
        gather_exact=gather_exact, device_ms=dev_ms, call_ms=call_ms,
        bound_ms=bound_splat[0])
    print(f"[11 splat kernel vs twin] {name}: {CHAINS} box-filter taps of a "
          f"render_pt chunk into a {SIZE}x{SIZE} film: max |d| "
          f"{splat_err:.3e}, per-pixel rtol 1e-5 {splat_ok}, backward "
          f"gather exact {gather_exact}; device ms per call: "
          f"splat_add_kernel {ms_splat:.4f}, twin {plain_splat:.4f}, "
          f"index_add_ {lib_splat:.4f} (bound {bound_splat[0]:.5f} ms by "
          f"{bound_splat[1]}); per call with launch overhead (events): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in call_ms.items()))
    need(splat_ok, f"splat kernel differs from its twin by {splat_err}")
    need(gather_exact, "the splat backward is not the exact gather")
    out["splat"] = (splat_err, ms_splat, plain_splat, bound_splat, lib_splat)

    # ---- 12. adjoint kernels vs twins ----------------------------------------
    scenes = {t: cornell_box(SIZE, SIZE, tall_box_material=t)
              for t in ("diffuse", "mirror", "glass")}
    scenes["veach"] = veach_door(SIZE, SIZE)
    report["adjoint_vs_twin"] = {}
    adj_err = {"rad": 0.0, "alb": 0.0}
    for sname, sc in scenes.items():
        tables = MT.make_tables(sc, gcfg, dev)
        uT = torch.rand((gcfg.n_dims, CHAINS), generator=gen, device=dev)
        row = []
        for mode, fn, twin in (("rad", MT.path_trace_rad,
                                MT.path_trace_rad_reference),
                               ("alb", MT.path_trace_alb,
                                MT.path_trace_alb_reference)):
            kk = fn(tables, uT)
            torch.cuda.synchronize()
            tt = twin(tables, uT)
            same = (kk[:3] == tt[:3]).all(0)
            rows_ok = ((kk[3:] - tt[3:]).abs()
                       <= 1e-5 * tt[3:].abs()).all(0) & same
            err = (float((kk[3:] - tt[3:])[:, same].abs().max())
                   if bool(same.any()) else float("inf"))
            # d mean(lum) / d param through the kernel's rows and the twin's
            g_k = torch.einsum("c,kcr->kc", lum_w, kk[3:].view(-1, 3, CHAINS))
            g_t = torch.einsum("c,kcr->kc", lum_w, tt[3:].view(-1, 3, CHAINS))
            g_rel = float(((g_k - g_t).abs() / (g_t.abs() + 1e-12)).max())
            r = dict(rgb_bit_equal=float(same.double().mean()),
                     rows_rtol_1e5=float(rows_ok.double().mean()),
                     rows_max_abs=err, grad_rel=g_rel,
                     finite=bool(torch.isfinite(kk).all()))
            report["adjoint_vs_twin"][f"{sname}/{mode}"] = r
            row.append(f"{mode}: rgb bit-equal {r['rgb_bit_equal']:.5f}, "
                       f"rows {r['rows_rtol_1e5']:.5f}, grad rel {g_rel:.1e}")
            need(r["finite"], f"{sname}/{mode}: non-finite rows")
            need(r["rgb_bit_equal"] >= 1.0 - MAX_BAD_LANES,
                 f"{sname}/{mode}: rgb rows differ")
            need(r["rows_rtol_1e5"] >= 1.0 - MAX_BAD_LANES,
                 f"{sname}/{mode}: Jacobian rows differ")
            need(g_rel <= 1e-5, f"{sname}/{mode}: gradients differ {g_rel}")
            adj_err[mode] = max(adj_err[mode], float((kk - tt).abs().max()))
        print(f"[12 adjoint kernels vs twins] {name}: {sname}, {CHAINS} "
              f"lanes, depth {GRAD_DEPTH}: " + "; ".join(row))

    tables = MT.make_tables(cornell, gcfg, dev)
    uT = torch.rand((gcfg.n_dims, CHAINS), generator=gen, device=dev)
    u_g = uT.T.contiguous()
    work = {}
    MT.path_trace_reference(tables, uT, work)
    timing = {}
    for mode, fn, twin, K in (
            ("rad", MT.path_trace_rad, MT.path_trace_rad_reference,
             tables.em.shape[0]),
            ("alb", MT.path_trace_alb, MT.path_trace_alb_reference,
             tables.mat.shape[0])):
        ms = event_ms(lambda: fn(tables, uT), runs=20)
        plain = event_ms(lambda: twin(tables, uT), runs=3)
        rows = fn(tables, uT)[3:].view(K, 3, CHAINS)
        g = torch.rand((CHAINS, 3), generator=gen, device=dev)
        lib = event_ms(lambda: torch.einsum("rc,kcr->kc", g, rows), runs=50)
        bnd = bound(nbytes(uT, tables.tri, tables.mat, tables.em, tables.cam)
                    + (3 + 3 * K) * CHAINS * 4, work["tri_tests"])
        timing[mode] = (ms, plain, bnd, lib)
    rad0 = cornell.emitters.radiance.to(dev)
    alb0 = cornell.materials.albedo.to(dev)
    trace_r = MT.make_mega_trace_rad(cornell, gcfg, dev)
    trace_a = MT.make_mega_trace_alb(cornell, gcfg, dev)

    def step_r():
        r = rad0.clone().requires_grad_()
        return torch.autograd.grad(trace_r(r, u_g).lum.mean(), r)[0]

    def step_a():
        a = alb0.clone().requires_grad_()
        return torch.autograd.grad(trace_a(a, u_g).lum.mean(), a)[0]

    rate_r, _ = grad_rate(step_r, GRAD_CALLS)
    rate_a, _ = grad_rate(step_a, GRAD_CALLS)
    # where a forward + backward call's time goes on the device
    step_dev_ms, step_busy = device_ms(step_r, runs=GRAD_CALLS)
    report["adjoint_timing"] = dict(
        rad_ms=timing["rad"][0], rad_plain_ms=timing["rad"][1],
        rad_einsum_ms=timing["rad"][3], alb_ms=timing["alb"][0],
        alb_plain_ms=timing["alb"][1], alb_einsum_ms=timing["alb"][3],
        bound_ms=timing["rad"][2][0], tri_tests=work["tri_tests"],
        grad_paths_per_sec=rate_r, grad_albedo_paths_per_sec=rate_a,
        rad_step_device_ms=step_dev_ms, rad_step_busy_share=step_busy)
    print(f"[12 timing] {name}: path_trace_rad_kernel {timing['rad'][0]:.3f} "
          f"ms vs twin {timing['rad'][1]:.3f} ms, its einsum "
          f"{timing['rad'][3]:.4f} ms; path_trace_alb_kernel "
          f"{timing['alb'][0]:.3f} ms vs twin {timing['alb'][1]:.3f} ms, its "
          f"einsum {timing['alb'][3]:.4f} ms ({CHAINS} lanes, depth "
          f"{GRAD_DEPTH}, rr {GRAD_RR}; bound {timing['rad'][2][0]:.4f} ms by "
          f"{timing['rad'][2][1]}, {work['tri_tests']} ray-triangle tests); "
          f"grad_paths_per_sec {rate_r:.4e}, grad_albedo_paths_per_sec "
          f"{rate_a:.4e} (forward + backward, {GRAD_CALLS} calls; a "
          f"radiance call keeps the device busy {step_dev_ms:.3f} ms, a "
          f"busy share of {step_busy:.3f})")
    out["rad"] = (adj_err["rad"], *timing["rad"])
    out["alb"] = (adj_err["alb"], *timing["alb"])

    # ---- 13. replay gradient vs the adjoints ---------------------------------
    rcfg = PathConfig(max_depth=GRAD_DEPTH, rr_depth=100)
    diff = MT.make_mega_trace_diff(cornell, rcfg, dev)
    t_r = MT.make_mega_trace_rad(cornell, rcfg, dev)
    t_a = MT.make_mega_trace_alb(cornell, rcfg, dev)
    r1, a1 = rad0.clone().requires_grad_(), alb0.clone().requires_grad_()
    build.reset_launches()
    g_diff = torch.autograd.grad(
        diff({"emitters.radiance": r1, "materials.albedo": a1},
             u_g).lum.mean(), [r1, a1])
    replay_launches = build.LAUNCHES["path_trace"]
    r2, a2 = rad0.clone().requires_grad_(), alb0.clone().requires_grad_()
    g_rad = torch.autograd.grad(t_r(r2, u_g).lum.mean(), r2)[0]
    g_alb = torch.autograd.grad(t_a(a2, u_g).lum.mean(), a2)[0]
    rel_r = float(((g_diff[0] - g_rad).abs() / g_rad.abs().clamp(min=1e-12))
                  .max())
    rel_a = float(((g_diff[1] - g_alb).abs() / g_alb.abs().clamp(min=1e-12))
                  .max())

    def step_replay():
        r = rad0.clone().requires_grad_()
        lum = diff({"emitters.radiance": r}, u_g).lum
        return torch.autograd.grad(lum.mean(), r)[0]

    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    rate_replay, replay_s = grad_rate(step_replay, 2)
    peak = torch.cuda.max_memory_allocated(dev) - base_mem
    # the replay's forward is kernel #5 at this config: its time, the
    # twin's, and the work bound of the same lanes
    rtab = MT.make_tables(cornell, rcfg, dev)
    ruT = u_g.T.contiguous()
    ms_fwd = event_ms(lambda: MT.path_trace(rtab, ruT), runs=20)
    plain_fwd = event_ms(lambda: MT.path_trace_reference(rtab, ruT), runs=3)
    rwork = {}
    MT.path_trace_reference(rtab, ruT, rwork)
    bound_fwd = bound(nbytes(ruT, rtab.tri, rtab.mat, rtab.em, rtab.cam)
                      + 3 * CHAINS * 4, rwork["tri_tests"])
    report["replay"] = dict(grad_rel_radiance=rel_r, grad_rel_albedo=rel_a,
                            path_kernel_launches=replay_launches,
                            grad_replay_paths_per_sec=rate_replay,
                            replay_call_s=replay_s / 2,
                            peak_bytes_over_baseline=peak,
                            forward_ms=ms_fwd, forward_plain_ms=plain_fwd,
                            forward_bound_ms=bound_fwd[0],
                            tri_tests=rwork["tri_tests"])
    print(f"[13 replay gradient] {name}: {CHAINS} lanes, depth {GRAD_DEPTH}, "
          f"rr 100: vs the adjoint kernels, radiance rel {rel_r:.2e}, albedo "
          f"rel {rel_a:.2e} (path kernel launches {replay_launches}); "
          f"grad_replay_paths_per_sec {rate_replay:.4e} "
          f"({replay_s / 2:.3f} s per call), peak memory "
          f"{peak / 2**20:.1f} MiB above the {base_mem / 2**20:.1f} MiB "
          f"already allocated; its forward, path_trace_kernel, {ms_fwd:.3f} "
          f"ms vs twin {plain_fwd:.3f} ms (bound {bound_fwd[0]:.4f} ms by "
          f"{bound_fwd[1]}, {rwork['tri_tests']} ray-triangle tests)")
    need(replay_launches > 0, "the replay forward did not run the kernel")
    need(rel_r <= 1e-3 and rel_a <= 1e-3,
         f"replay and adjoint gradients differ ({rel_r}, {rel_a})")
    out["replay"] = (rate_replay, replay_s / 2, ms_fwd, plain_fwd,
                     bound_fwd)

    # ---- 14. inverse rendering (slice 3's main path) -------------------------
    icfg = PathConfig(max_depth=GRAD_DEPTH, rr_depth=100)
    u_i = torch.rand((CHAINS, icfg.n_dims), generator=gen, device=dev)
    tr_a = MT.make_mega_trace_alb(cornell, icfg, dev)
    tr_r = MT.make_mega_trace_rad(cornell, icfg, dev)
    with torch.no_grad():
        target = film_image(fc, tr_a(alb0, u_i))
    build.reset_launches()
    losses_a, got_a, ms_a, err_a = inverse_render(
        tr_a, lambda p: torch.cat([alb0[:1], torch.sigmoid(p)[None],
                                   alb0[2:]]),
        torch.sigmoid, torch.zeros(3, device=dev), alb0[1], target, u_i, fc)
    losses_r, got_r, ms_r, err_r = inverse_render(
        tr_r, lambda p: rad0 * p, lambda p: p,
        torch.tensor(0.5, device=dev), torch.tensor(1.0, device=dev),
        target, u_i, fc)
    launches3 = dict(build.LAUNCHES)
    # device view of 10 more albedo steps: busy share and kernel times
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, prof_wall = sync_time(lambda: inverse_render(
            tr_a, lambda p: torch.cat([alb0[:1], torch.sigmoid(p)[None],
                                       alb0[2:]]),
            torch.sigmoid, torch.zeros(3, device=dev), alb0[1], target, u_i,
            fc, steps=10))
    busy3, per3 = device_profile(prof.events(), prof_wall)
    top3 = sorted(per3.items(), key=lambda kv: -kv[1][0])
    report["inverse"] = dict(
        albedo=dict(losses=losses_a, recovered=got_a.tolist(),
                    truth=alb0[1].tolist(), max_err=err_a, ms_per_step=ms_a),
        radiance_scale=dict(losses=losses_r, recovered=float(got_r),
                            max_err=err_r, ms_per_step=ms_r),
        launches=launches3, profile_wall_s=prof_wall, busy_share=busy3,
        kernels_ms=[[k, t, n] for k, (t, n) in top3])
    print(f"[14 inverse rendering] {name}: {CHAINS} lanes, {SIZE}x{SIZE} "
          f"per-pixel loss, depth {GRAD_DEPTH}, rr 100, Adam lr 0.25 x "
          f"{ADAM_STEPS}: albedo {[round(x, 4) for x in got_a.tolist()]} vs "
          f"{[round(x, 4) for x in alb0[1].tolist()]} (max err {err_a:.4f}), "
          f"loss {losses_a[0]:.4e} -> {losses_a[-1]:.4e}, {ms_a:.3f} ms per "
          f"step; radiance scale {float(got_r):.4f} vs 1 (err {err_r:.4f}), "
          f"loss {losses_r[0]:.4e} -> {losses_r[-1]:.4e}, {ms_r:.3f} ms per "
          f"step; launches {launches3}")
    print(f"[14 inverse rendering profile] {name}: device busy {busy3:.4f} "
          f"of {prof_wall:.3f} s for 10 albedo steps; " + "; ".join(
              f"{k.split('(')[0][:60]} {t:.3f} ms x{n}"
              for k, (t, n) in top3[:6]))
    for tag, losses, err in (("albedo", losses_a, err_a),
                             ("radiance scale", losses_r, err_r)):
        need(losses[-1] < 0.01 * losses[0],
             f"{tag}: loss fell only to {losses[-1] / losses[0]:.4f}")
        need(err <= 0.08, f"{tag}: recovered to within {err}")
    need(all(launches3[k] > 0 for k in ("splat_add", "path_trace_rad",
                                        "path_trace_alb")),
         f"a kernel of slice 3 did not launch: {launches3}")
    out["launches"] = launches3
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    report = {"device": name}
    t_start = time.perf_counter()

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
    for k in ("path_trace_kernel", "mmlt_trace_kernel",
              "drmlt_chain_kernelINS_9PathTrace",
              "drmlt_chain_kernelINS_9MmltTrace", "splat_add_kernel",
              "path_trace_rad_kernel", "path_trace_alb_kernel"):
        need(any(k in n for n in regs), f"ptxas reported no {k}")
    print(f"[2 build] {name}: nvcc {build.build_info['seconds']:.1f} s "
          f"(cached={build.build_info['cached']}); " + "; ".join(
              f"{n}: {r}" for n, r in regs.items() if "kernel" in n))

    pcfg = PathConfig(max_depth=DEPTH, rr_depth=100, min_depth=1)
    D = pcfg.n_dims + pcfg.n_dims % 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    # ---- 3. path kernel vs twin ---------------------------------------------
    path_err = 0.0
    report["path_vs_twin"] = {}
    for tall in ("diffuse", "mirror", "glass", "veach"):
        scene = (veach_door(SIZE, SIZE) if tall == "veach" else
                 cornell_box(SIZE, SIZE, tall_box_material=tall))
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

    # ---- 5. slice 1 ---------------------------------------------------------
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
    # render_pt splats through the splat kernel (phase 11 checks it)
    ref_splats = build.LAUNCHES["splat_add"]
    mean_rel, block_l1 = mc_compare(img, ref)
    m_img = img.double().mean((0, 1))
    m_ref = ref.double().mean((0, 1))
    report["slice"] = dict(
        b=b, wall_s=wall, first_wall_s=first_wall, mutations=n_mutations,
        mutations_per_s=n_mutations / wall, steps=aux["steps"],
        image_mean=m_img.tolist(), ref_mean=m_ref.tolist(),
        mean_rel_err=mean_rel, block_rel_l1=block_l1, accept2=acc2,
        accept1=float(aux["stats"]["accept1"]), finite=finite,
        launches=launches, ref_wall_s=ref_wall, ref_splat_launches=ref_splats)
    print(f"[5 slice] {name}: b {b:.6f}, warm wall {wall:.3f} s for "
          f"{n_mutations} mutations ({n_mutations / wall:.4e} mutations/s, "
          f"bootstrap included; first call {first_wall:.3f} s), "
          f"image mean {m_img.tolist()}, finite "
          f"{finite}, vs MC mean rel {mean_rel:.4f}, 16x16-block rel L1 "
          f"{block_l1:.4f}, accept2 {acc2:.4f}, launches {launches}; the MC "
          f"render_pt: {ref_splats} splat kernel launches")
    need(finite, "slice image not finite")
    need(launches["path_trace"] > 0 and launches["drmlt_path"] > 0,
         f"a kernel of the path did not launch: {launches}")
    need(ref_splats > 0, "render_pt did not splat through the kernel")
    # MCMC-vs-MC: 16.8M mutations against 4.2M MC samples.  The image
    # scale b alone varies by 1.8% (relative std) between seeds at 106,496
    # bootstrap samples (path luminance CV ~7 on this box), so 0.08 is
    # about four of its standard deviations
    need(mean_rel < MC_GATE["path"],
         f"slice mean differs from MC by {mean_rel}")
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
    path_chain_work = {}
    for given in (False, True):
        uni = (torch.rand((64 * MD.n_rand(cfg, D), CHAINS), generator=gen,
                          device=dev) if given else None)
        # the uniforms-mode twin also counts its ray-triangle tests: 64
        # mutations from the slice's state, the work bound below
        r = compare_chain(tables, cfg, 64, aux["state"], SIZE, 5, 0, uni,
                          work=path_chain_work if given else None)
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
    path_work = {}
    MT.path_trace_reference(tables, uT, path_work)
    bound_path = bound(nbytes(uT, tables.tri, tables.mat, tables.em,
                              tables.cam) + 3 * CHAINS * 4,
                       path_work["tri_tests"])
    # kernel and twin each advance their own copy of the slice's state; the
    # twin ran twice at this shape just above, which is its warm-up
    states = [aux["state"].clone() for _ in range(2)]
    films = [torch.zeros((SIZE, SIZE, 3), device=dev) for _ in range(2)]
    stats = [torch.zeros((6, CHAINS), device=dev) for _ in range(2)]
    ms_chain = event_ms(lambda: MD.drmlt_chain_step(
        tables, cfg, 64, states[0], films[0], stats[0], 5, 0), runs=5)
    plain_chain = event_ms(lambda: MD.drmlt_chain_step_reference(
        tables, cfg, 64, states[1], films[1], stats[1], 5, 0), runs=1,
        warmup=0)
    # state read and written, film and stats written, once per launch
    bound_chain = bound(2 * nbytes(states[0]) + nbytes(films[0])
                        + 2 * nbytes(stats[0]),
                        path_chain_work["tri_tests"])
    report["timing_ms"] = dict(path_trace=ms_path, path_trace_plain=plain_path,
                               drmlt_path_n_mut64=ms_chain,
                               drmlt_path_plain_n_mut64=plain_chain)
    print(f"[6 timing] {name}: path_trace_kernel {ms_path:.3f} ms vs twin "
          f"{plain_path:.3f} ms ({CHAINS} lanes, depth {DEPTH}; bound "
          f"{bound_path[0]:.4f} ms by {bound_path[1]}, "
          f"{path_work['tri_tests']} ray-triangle tests); "
          f"drmlt_chain_kernel[path] {ms_chain:.3f} ms vs twin "
          f"{plain_chain:.3f} ms ({CHAINS} chains x 64 mutations = "
          f"{CHAINS * 64 / (ms_chain / 1e3):.4e} mutations/s; bound "
          f"{bound_chain[0]:.4f} ms by {bound_chain[1]}, "
          f"{path_chain_work['tri_tests']} ray-triangle tests)")

    # ---- 7. MMLT kernel vs twin ---------------------------------------------
    mmlt_err = 0.0
    report["mmlt_vs_twin"] = {}
    mmlt_scenes = {t: cornell_box(SIZE, SIZE, tall_box_material=t)
                   for t in ("diffuse", "mirror", "glass")}
    mmlt_scenes["veach"] = veach_door(SIZE, SIZE)
    for sname, sc in mmlt_scenes.items():
        row = []
        for depth in range(1, MMLT_DEPTH + 1):
            mt = MM.make_mmlt_tables(sc, BDPTConfig(max_depth=depth), dev)
            uT = torch.rand((mt.n_core, CHAINS), generator=gen, device=dev)
            k = MM.mmlt_trace(mt, uT)
            torch.cuda.synchronize()
            t = MM.mmlt_trace_reference(mt, uT)
            mx, mean, bad = lane_diff(k, t, pos_rows=2)
            m_rel = float(((k[:3].double().mean(1) - t[:3].double().mean(1))
                           .abs() / (t[:3].double().mean(1).abs() + 1e-12))
                          .max())
            report["mmlt_vs_twin"][f"{sname}/{depth}"] = dict(
                max_abs=mx, mean_abs=mean, bad_lanes=bad, mean_rel=m_rel)
            row.append(f"d{depth} {1 - bad:.5f} {mx:.1e}")
            need(bool(torch.isfinite(k).all()), f"{sname}/{depth}: non-finite")
            need(bad <= MAX_BAD_LANES_MMLT,
                 f"MMLT {sname}/{depth}: {bad:.4f} of lanes differ")
            need(m_rel <= MEAN_RTOL, f"MMLT {sname}/{depth}: means {m_rel}")
            mmlt_err = max(mmlt_err, mx)
        print(f"[7 MMLT kernel vs twin] {name}: {sname}, {CHAINS} lanes "
              f"(depth, lanes agreeing, max |d|): " + ", ".join(row))

    # ---- 8. chain kernel (mmlt mode) vs twin --------------------------------
    report["mmlt_chain_vs_twin"] = {}
    mmlt_chain_err = 0.0
    cornell = mmlt_scenes["diffuse"]
    starts = {}
    for kk in (MMLT_DEPTH, 1):
        mtab, st0, Dk = slice2_starts(cornell, kk, gen, dev)
        starts[kk] = (mtab, st0, Dk)
        s4 = st0[:, :C4].contiguous()
        for drtype in ("orbital", "green", "mira"):
            for mode in ("three", "sampled"):
                for given in (True, False):
                    ccfg = DRMLTConfig(type=drtype, splat_mode=mode,
                                       n_chains=C4,
                                       fix_emitter_path=drtype == "mira")
                    uni = (torch.rand((2 * MD.n_rand(ccfg, Dk), C4),
                                      generator=gen, device=dev)
                           if given else None)
                    r = compare_chain(mtab, ccfg, 2, s4, SIZE, 31, 2, uni)
                    tag = (f"k{kk}/{drtype}/{mode}/"
                           f"{'uniforms' if given else 'philox'}")
                    report["mmlt_chain_vs_twin"][tag] = r
                    check_chain(tag, r)
                    mmlt_chain_err = max(mmlt_chain_err, r["state_max_abs"])
        agree = min(r["lane_agreement"] for t, r in
                    report["mmlt_chain_vs_twin"].items()
                    if t.startswith(f"k{kk}/"))
        print(f"[8 chain kernel, mmlt mode, vs twin] {name}: k {kk} (D "
              f"{Dk}), {C4} chains x 2 mutations, 12 configurations: lowest "
              f"lane agreement {agree:.5f}")

    cfg2 = DRMLTConfig(type="orbital", n_chains=CHAINS, n_bootstrap=100_000,
                       p_large=0.3, splat_mode="sampled")
    mmlt_chain_work = {}
    plain_mmlt_chain = None
    # the Cornell box at k = 6 and k = 1 in both modes, and the veach door
    # at a group that runs there (b_1 = 0), k = 4, Philox
    big = [("cornell", kk, given) for kk in (MMLT_DEPTH, 1)
           for given in (False, True)] + [("veach", 4, False)]
    for sname, kk, given in big:
        if sname == "cornell":
            mtab, st0, Dk = starts[kk]
        else:
            mtab, st0, Dk = slice2_starts(mmlt_scenes[sname], kk, gen, dev)
        uni = (torch.rand((64 * MD.n_rand(cfg2, Dk), CHAINS),
                          generator=gen, device=dev) if given else None)
        # at k = 6 the Philox twin's wall is its time (plain_ms; the kernel
        # is timed from the same state below) and the uniforms twin counts
        # the ray-triangle tests of 64 mutations
        head = (sname, kk) == ("cornell", MMLT_DEPTH)
        r = compare_chain(mtab, cfg2, 64, st0, SIZE, 5, 0, uni,
                          work=mmlt_chain_work if (given and head) else None)
        del uni
        if head and not given:
            plain_mmlt_chain = r["twin_s"] * 1e3
        tag = (f"{'' if sname == 'cornell' else sname + '/'}k{kk}/orbital/"
               f"sampled/{'uniforms' if given else 'philox'}")
        report["mmlt_chain_vs_twin"]["slice_shape/" + tag] = r
        print(f"[8 chain kernel, mmlt mode, vs twin, {CHAINS} chains x "
              f"64 mutations] {name}: {tag}: lanes agreeing "
              f"{r['lane_agreement']:.5f}, film rel L1 "
              f"{r['film_rel_l1']:.2e}, state max |d| "
              f"{r['state_max_abs']:.2e}, stats {r['stats_kernel']} vs "
              f"{r['stats_twin']}")
        check_chain(tag, r)
        mmlt_chain_err = max(mmlt_chain_err, r["state_max_abs"])

    # ---- 9. slice 2 ---------------------------------------------------------
    bcfg = BDPTConfig(max_depth=MMLT_DEPTH, light_image=True)
    ref_cfg = PathConfig(max_depth=MMLT_DEPTH, rr_depth=100)
    cfg3 = DRMLTConfig(type="orbital", n_chains=CHAINS, n_bootstrap=100_000,
                       p_large=0.3, splat_mode="three")
    report["slice2"] = {}
    launches2 = None
    for sname in ("cornell", "veach"):
        sc = cornell if sname == "cornell" else mmlt_scenes["veach"]
        gen.manual_seed(16)
        _, first_wall2 = sync_time(lambda: render_drmlt_mmlt_grouped(
            sc, bcfg, cfg2, fc, gen, n_steps))
        gen.manual_seed(17)
        build.reset_launches()
        (img2, aux2), wall2 = sync_time(lambda: render_drmlt_mmlt_grouped(
            sc, bcfg, cfg2, fc, gen, n_steps))
        launches_s = dict(build.LAUNCHES)
        if sname == "cornell":
            launches2 = launches_s
        muts = sum(CHAINS * s for s in aux2["steps_eff"].values())
        gen.manual_seed(18)
        spp = 64 if sname == "cornell" else 256
        ref_film2, ref_wall2 = sync_time(lambda: render_pt(
            sc, ref_cfg, gen, SIZE * SIZE * spp, fc, mode="accum"))
        ref2 = filmlib.develop(fc, ref_film2, mode="accum")
        mean_rel2, block_l12 = mc_compare(img2, ref2)
        # a second MC render: the MC side of the shape check's noise
        gen.manual_seed(22)
        ref2b = filmlib.develop(fc, render_pt(
            sc, ref_cfg, gen, SIZE * SIZE * spp, fc, mode="accum"),
            mode="accum")
        # the reference estimator, the three-state splat, after a warm-up
        gen.manual_seed(19)
        render_drmlt_mmlt_grouped(sc, bcfg, cfg3, fc, gen, n_steps)
        gen.manual_seed(20)
        (img3, aux3), wall3 = sync_time(lambda: render_drmlt_mmlt_grouped(
            sc, bcfg, cfg3, fc, gen, n_steps))
        muts3 = sum(CHAINS * s for s in aux3["steps_eff"].values())
        mean_rel3, _ = mc_compare(img3, ref2)
        groups = {}
        for k in range(1, MMLT_DEPTH + 1):
            st_k = aux2["stats"].get(k)
            groups[k] = dict(
                b_k=aux2["b_k"][k - 1], steps=aux2["steps_per_group"][k - 1],
                steps_eff=aux2["steps_eff"].get(k, 0),
                accept1=float(st_k["accept1"]) if st_k else 0.0,
                accept2=float(st_k["accept2"]) if st_k else 0.0)
        # device profile of one more warm render: busy share, kernels, and
        # the chain kernel's device time per depth group (launch order)
        gen.manual_seed(21)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (img_p, auxp), prof_wall2 = sync_time(
                lambda: render_drmlt_mmlt_grouped(sc, bcfg, cfg2, fc, gen,
                                                  n_steps))
        evs = prof.events()
        busy2, per2 = device_profile(evs, prof_wall2)
        chain_ev = sorted((e.time_range.start, e.time_range.elapsed_us())
                          for e in evs if e.device_type == DeviceType.CUDA
                          and "drmlt_chain_kernel" in e.name)
        per_group_ms, i = {}, 0
        for k, n_l in group_launches(auxp).items():
            per_group_ms[k] = sum(us for _, us in chain_ev[i:i + n_l]) / 1e3
            i += n_l
        # the shape check: MCMC against MC, and what the noise of two
        # renders of each kind (the sampled renders of seeds 17 and 21)
        # predicts for it
        shape = shape_l1(img2, ref2)
        noise_mc = shape_l1(ref2b, ref2)
        noise_mcmc = shape_l1(img_p, img2)
        shape_expected = ((noise_mc ** 2 + noise_mcmc ** 2) / 2) ** 0.5
        # the spread of the image scale b over bootstrap seeds (no chains)
        bs = []
        for s in range(B_SEEDS):
            gen.manual_seed(1000 + s)
            bs.append(float(render_drmlt_mmlt_grouped(
                sc, bcfg, cfg2, fc, gen, 0)[1]["b"]))
        bs_t = torch.tensor(bs, dtype=torch.float64)
        b_rel_std = float(bs_t.std() / bs_t.mean())
        top2 = sorted(per2.items(), key=lambda kv: -kv[1][0])
        report["slice2"][sname] = dict(
            b=float(aux2["b"]), groups=groups, wall_s=wall2,
            first_wall_s=first_wall2, mutations=muts,
            mutations_per_s=muts / wall2, three_wall_s=wall3,
            three_mutations_per_s=muts3 / wall3, mean_rel_err=mean_rel2,
            block_rel_l1=block_l12, three_mean_rel_err=mean_rel3,
            shape_l1=shape, shape_noise_mc=noise_mc,
            shape_noise_mcmc=noise_mcmc, shape_expected=shape_expected,
            ref_spp=spp, ref_wall_s=ref_wall2,
            image_mean=img2.double().mean((0, 1)).tolist(),
            ref_mean=ref2.double().mean((0, 1)).tolist(),
            launches=launches_s, profile_wall_s=prof_wall2,
            busy_share=busy2, chain_ms_per_group=per_group_ms,
            kernels_ms=[[k, t, n] for k, (t, n) in top2],
            b_seeds=bs, b_rel_std=b_rel_std)
        print(f"[9 slice 2] {name}: {sname}: b {float(aux2['b']):.6f} "
              f"(rel std over {B_SEEDS} seeds {b_rel_std:.4f}); groups (k: "
              f"b_k, steps, accept1, accept2) " + ", ".join(
                  f"{k}: {g['b_k']:.5f} {g['steps_eff']} "
                  f"{g['accept1']:.3f} {g['accept2']:.3f}"
                  for k, g in groups.items())
              + f"; sampled: warm {wall2:.3f} s for {muts} mutations "
              f"({muts / wall2:.4e} mutations/s, bootstrap included; first "
              f"call {first_wall2:.3f} s); three-state: {wall3:.3f} s "
              f"({muts3 / wall3:.4e} mutations/s); vs MC ({spp} spp) mean "
              f"rel {mean_rel2:.4f} (three-state {mean_rel3:.4f}), "
              f"16x16-block rel L1 {block_l12:.4f}; shape L1 {shape:.4f} "
              f"against {shape_expected:.4f} from the noise of two MC "
              f"({noise_mc:.4f}) and two MCMC ({noise_mcmc:.4f}) renders "
              f"(ratio {shape / shape_expected:.3f}, gate {SHAPE_GATE}); "
              f"launches {launches_s}")
        per_group = {k: round(v, 3) for k, v in per_group_ms.items()}
        print(f"[9 slice 2 profile] {name}: {sname}: device busy "
              f"{busy2:.4f} of a {prof_wall2:.3f} s render; chain kernel ms "
              f"per group {per_group}; " + "; ".join(
                  f"{k.split('(')[0][:60]} {t:.3f} ms x{n}"
                  for k, (t, n) in top2[:4]))
        need(bool(torch.isfinite(img2).all())
             and bool(torch.isfinite(img3).all()),
             f"slice 2 {sname}: image not finite")
        need(mean_rel2 < MC_GATE[sname] and mean_rel3 < MC_GATE[sname],
             f"slice 2 {sname}: mean differs from MC by {mean_rel2} "
             f"(three-state {mean_rel3})")
        if sname == "cornell":
            need(block_l12 < 0.25, f"slice 2 blocks differ from MC by "
                 f"{block_l12}")
        need(shape < SHAPE_GATE * shape_expected,
             f"slice 2 {sname}: shape differs from MC by {shape}, the "
             f"noise predicts {shape_expected}")
        need(busy2 > 0, "the profiler saw no device activity")
    need(launches2["mmlt_trace"] > 0 and launches2["drmlt_mmlt"] > 0,
         f"a kernel of the MMLT path did not launch: {launches2}")

    # ---- 10. MMLT kernels' timing -------------------------------------------
    mt6 = MM.make_mmlt_tables(cornell, BDPTConfig(max_depth=MMLT_DEPTH), dev)
    uT = torch.rand((mt6.n_core, CHAINS), generator=gen, device=dev)
    ms_mmlt = event_ms(lambda: MM.mmlt_trace(mt6, uT), runs=20)
    plain_mmlt = event_ms(lambda: MM.mmlt_trace_reference(mt6, uT), runs=3)
    mmlt_work = {}
    MM.mmlt_trace_reference(mt6, uT, mmlt_work)
    bound_mmlt = bound(nbytes(uT, mt6.tri, mt6.mat, mt6.em, mt6.cam)
                       + 5 * CHAINS * 4, mmlt_work["tri_tests"])
    mtab6, st6, _ = starts[MMLT_DEPTH]
    st_k = st6.clone()
    film_k = torch.zeros((SIZE, SIZE, 3), device=dev)
    stats_k = torch.zeros((6, CHAINS), device=dev)
    ms_mmlt_chain = event_ms(lambda: MD.drmlt_chain_step(
        mtab6, cfg2, 64, st_k, film_k, stats_k, 5, 0), runs=5)
    bound_mmlt_chain = bound(2 * nbytes(st_k) + nbytes(film_k)
                             + 2 * nbytes(stats_k),
                             mmlt_chain_work["tri_tests"])
    report["timing_ms"].update(
        mmlt_trace=ms_mmlt, mmlt_trace_plain=plain_mmlt,
        drmlt_mmlt_k6_n_mut64=ms_mmlt_chain,
        drmlt_mmlt_plain_k6_n_mut64=plain_mmlt_chain)
    print(f"[10 timing] {name}: mmlt_trace_kernel {ms_mmlt:.3f} ms vs twin "
          f"{plain_mmlt:.3f} ms ({CHAINS} lanes, depth {MMLT_DEPTH}; bound "
          f"{bound_mmlt[0]:.4f} ms by {bound_mmlt[1]}, "
          f"{mmlt_work['tri_tests']} ray-triangle tests); "
          f"drmlt_chain_kernel[mmlt] {ms_mmlt_chain:.3f} ms vs twin "
          f"{plain_mmlt_chain:.3f} ms ({CHAINS} chains x 64 mutations at k "
          f"{MMLT_DEPTH} = {CHAINS * 64 / (ms_mmlt_chain / 1e3):.4e} "
          f"mutations/s; bound {bound_mmlt_chain[0]:.4f} ms by "
          f"{bound_mmlt_chain[1]}, {mmlt_chain_work['tri_tests']} "
          f"ray-triangle tests); whole script "
          f"{time.perf_counter() - t_start:.1f} s")

    # ---- 11-14. slice 3 -----------------------------------------------------
    s3 = slice3(name, dev, gen, fc, report)

    src = "drmlt_mitsuba_tpu_torch/csrc/"
    ref_src = "drmlt_mitsuba_tpu/ops/pallas/"

    def entry(kname, source, replaces, launched, err, ms, plain, bnd,
              library=None):
        return dict(name=kname, route="cuda", source=src + source,
                    replaces=ref_src + replaces, launches=launched,
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd[0],
                    bound_by=bnd[1], library_ms=library)

    kernels = [
        entry("path_trace_kernel", "path_trace.cu", "megatrace.py:1555",
              launches["path_trace"], path_err, ms_path, plain_path,
              bound_path),
        entry("drmlt_chain_kernel[path]", "drmlt_chain.cu",
              "megadrmlt.py:105", launches["drmlt_path"], chain_err,
              ms_chain, plain_chain, bound_chain),
        entry("mmlt_trace_kernel", "mmlt_trace.cu", "megammlt.py:214",
              launches2["mmlt_trace"], mmlt_err, ms_mmlt, plain_mmlt,
              bound_mmlt),
        entry("drmlt_chain_kernel[mmlt]", "drmlt_chain.cu",
              "megadrmlt.py:105", launches2["drmlt_mmlt"], mmlt_chain_err,
              ms_mmlt_chain, plain_mmlt_chain, bound_mmlt_chain),
        # library: index_add_ of the taps; the einsum of the backward
        entry("splat_add_kernel", "splat.cu", "splat_kernel.py:79",
              s3["launches"]["splat_add"], *s3["splat"]),
        entry("path_trace_rad_kernel", "path_trace_grad.cu",
              "megatrace.py:1798", s3["launches"]["path_trace_rad"],
              *s3["rad"]),
        entry("path_trace_alb_kernel", "path_trace_grad.cu",
              "megatrace.py:1943", s3["launches"]["path_trace_alb"],
              *s3["alb"]),
    ]
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
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
