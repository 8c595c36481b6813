#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's slices once on one GPU: the DRMLT path
render, the depth-grouped DRMLT-over-MMLT render, differentiable
rendering (inverse rendering through the adjoint and splat kernels),
asset-scale scenes (the XML loader, the BVH walk in every trace kernel,
the intersection kernel), the trace kernels' full scene scope (analytic
spheres, the conductor / rough-conductor / null kinds, bitmap albedo,
constant and image environments, the thin lens), PSSMLT (the chain
kernel's pssmlt mode, the host PSSMLT integrator, the CLI's
integrator=pssmlt), the generic DRMLT step (the mixture, the
acceptance map, the pooled MMLT route, every reconstruction filter and
the CLI routes they open) and the bidirectional layer (BDPT, the
wavefront MMLT trace, the thin lens, over the intersection kernel), and
the forward renderers (the particle tracer, field, multichannel and
motion AOVs), every sampler and the CLI's flags and outputs.

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
     Philox stream (chains, film and per-chain stats compared), each
     with its stage-2 share (the chains whose z the twin traced; phases
     6, 8, 10 and 21 print it too, beside the kernel's time);
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
     twins' rows; the compacting kernels bit for bit their one-path-per-
     thread launches, both timed in turns on each scene), each kernel's
     time, and grad-paths/s as the JAX bench defines it (forward +
     backward, 16 calls);
 13. the replay gradient (path kernel forward, autograd of the twin
     backward) at rr_depth 100 against the adjoint kernels' gradients (rtol
     1e-3), grad_replay_paths_per_sec and the replay's peak memory;
 14. slice 3's main path, inverse rendering: 40 Adam steps (lr 0.25) on
     the red wall's albedo through sigmoid(param), and then on the light's
     radiance scale, each with a per-pixel image loss through the splat
     kernel against a target rendered with the same 65,536 lanes; the
     launch counters are reset before and read after it;
 15. slice 4, the intersection kernel vs its plain version on 1,048,576
     rays: brute mode (bumpy sphere, 4,000 triangles) and BVH mode (bumpy
     sphere at 20,000 and 65,826, cornell_large.xml): t bit-equal, id and
     any-hit equal on every ray, and in BVH mode the walk equal to the
     brute kernel; times, MRays/s, bounds (the brute mode's in both
     closest and any-hit mode); then raybench (the kernel's entry point)
     at 20,000 and 4,000 triangles with the counters reset;
 16. every trace kernel on cornell_large.xml (19,586 triangles, the walk)
     vs its twin: the path kernel (65,536 lanes, depth 8), the MMLT kernel
     at depths 1-6 and both adjoints (65,536 lanes, the twins on the
     first 16,384), the chain kernel in both modes at 4,096 x 2 (Philox),
     and at 65,536 x 64 against its own brute mode bit for bit;
 17. slice 4's main path: both renders of cornell_large.xml through the
     CLI's load_scene and render at 65,536 chains, 256 mutations per
     pixel (grouped MMLT depth 6; path depth 8), each against a
     Monte-Carlo render_pt of the same scene and its b against the
     36-triangle box's b (phases 5 and 9), with the counters reset before
     and read after, and a profiled render for the busy share and the
     chain kernel's ms per launch / per depth group;
 18. the depth-2 path trace at 65,536 lanes on cornell_box(tessellate =
     1, 2, 4, 8, 11, 13, 24, 44: 36 to 65,826 triangles), walk against
     brute mode (paths/s, bit-equal), a BVH built for the walk's side at
     or below BVH_MIN_TRIS: where the two cross;
 19. slice 5, the full-scope instantiation of the path kernel and of both
     adjoints vs their twins (65,536 lanes, depth 8; the albedo adjoint
     where the albedos are constant) on tests/data/cornell.xml and the
     256x256 configurations of cornell_scope (kinds, const, thinlens, env64,
     env256), and their times on the const configuration;
 20. the MMLT kernel vs its twin at depths 1-6 on each of them but the
     thin lens;
 21. the chain kernel in both modes vs its twin at 4,096 x 2 (uniforms and
     Philox) on each, and at 65,536 x 64 on const (its time);
 22. slice 5's main path, the counters reset before each CLI render and
     read after it (the MC references and b seeds do not count): both CLI
     renders of tests/data/cornell.xml (-D spp=4096, orbital,
     sampled, 65,536 chains) and the 256x256 renders (path depth 8, MMLT
     depth 6, 65,536 chains, 256 mutations per pixel), each against a
     Monte-Carlo render_pt (channel means within four standard deviations
     of b over bootstrap seeds, measured in the run; the 16x16-block shape,
     each image at unit mean, within 1.5x what the noise of two MC and of
     two MCMC renders predicts, as phase 9); a plain-MC witness on env64,
     whose MMLT renders have wide gates: the MMLT technique's 64x64 MC
     image against the path technique's (z of the means < 4, rms of the
     4x4-block z-scores < 1.5); the white furnace
     (every pixel of furnace_sphere within 5 sigma of its analytic value,
     through the path kernel; the DRMLT render's mean); a profiled warm
     render of each technique;
 23. slice 6, PSSMLT: (a) the chain kernel's pssmlt mode vs its twin at
     4,096 x 2 (mira / green x three / sampled, uniforms and Philox) in
     path mode and mmlt mode at k = 1-6 on the 36-triangle box and in both
     modes (k = 6) on the full-scope const configuration, and at 65,536 x
     64 (Philox) on both (stats[1] == stats[3] == 0 exactly); its time on
     the box against its twin's and the bound, and against the DRMLT mode
     in turns at k = 6; (b) the main path's kernel form: the grouped render
     with pssmlt=True on the Cornell box and the veach door (65,536
     chains, 256 mutations per pixel) against phase 9's MC renders with
     its gates, mutations/s, the chain kernel's ms per depth group against
     the DRMLT mode's (phase 9) and the busy share; (c) render_pssmlt over
     the path kernel on the box, Kelemen and Veach weights, against phase
     5's MC render and gate, mutations/s, the busy share; (d) the CLI's
     integrator=pssmlt on tests/data/cornell.xml in both techniques in
     fresh processes against phase 22's MC renders and gates (path with
     Kelemen's weights, the pooled MMLT trace with Veach's); the pooled
     trace with Kelemen's weights, biased by its pinned depth dim as in
     the reference, against the estimator's expected channel ratios (from
     a plain-MC pass of the trace and the chains' depth shares): the fresh
     render's channel means / MC, and Kelemen / Veach on the same chains
     in this process; and a -D averageLuminance render (Veach weights: the
     image scales by it over b).  The counters are reset before each
     render of (b)-(d) and read after it;
 24. slice 7, the generic DRMLT step: (a) one drmlt_step_from_uniforms
     step of 16,384 chains (green, mira, orbital, each with the acceptance
     map, and the green mixture) through the path kernel and through its
     twin on the CPU, on the same starts and uniforms (>= 99% of chains
     with equal state, the film within 5e-3 of its max); (b) render_drmlt
     on the box (65,536 chains, 256 mutations per pixel): green with the
     acceptance map, mira, orbital, green with the mixture, each against
     phase 5's MC render (MC_GATE["path"] and the shape check), the
     accmap's R / G sums equal to the summed accept counts, and the green
     render's mutations/s and device-busy share beside render_drmlt_path's;
     (c) the CLI's pooled MMLT route (grouped=false, fixEmitterPath) and
     the grouped route with acceptanceMap on the box at max_depth 6
     against phase 9's MC (MC_GATE["cornell"]); (d) the splat kernel
     against its twin on 1,048,576 splats of each of the six filters
     (per pixel within 1e-5 of the sum of |tap| there), and a copy of
     tests/data/cornell.xml without its <rfilter> (the gaussian default)
     through the CLI's drmlt path route, the grouped MMLT route,
     integrator=path and drmlt with twoStage and with separateDirect,
     each within phase 22's gate of the box-filter MC.  The counters are
     reset before each render of (b)-(d) and read after it; the kernels
     line adds those launches to #4, #5 and #9;
 25. slice 8, the bidirectional wavefront (integrators/bidir.py) over
     the intersection kernel: (a) trace_bdpt at max_depth 5 on 65,536
     lanes of the box (brute mode) and on 16,384 lanes of
     cornell_large.xml (the walk), every splat of every lane against the
     same function on the CPU over the twins (lanes differing <= 0.2%,
     channel means to 5e-3), its ms per 65,536 samples, the device-busy
     share and the intersection kernel's launches and device time;
     (b) trace_mmlt_wavefront against the MMLT kernel (#9) on the same
     pinhole PSS vectors, depths 1-5; (c) the CLI's integrator=bdpt and
     drmlt / pssmlt with technique=bdpt on the box at 256x256, depth 8,
     against phase 5's MC render (BDPT_GATE for the plain estimator,
     printed beside the mean's noise estimated from the 16x16 blocks;
     MC_GATE["path"] for the MCMC routes); (d) drmlt + mmlt,
     grouped and pooled, on a thin-lens copy of the box at max_depth 6
     (the wavefront, never the MMLT kernel) against a thin-lens
     render_pt (MC_GATE["cornell"]); (e) tests/data/cornell.xml through
     integrator=bdpt against phase 22's MC render and gate; (f) the
     splat kernel against its twin on the light-image splats of the
     veach door (whose camera stands inside the room, so some fall off
     the film with zero value) and on splats off the film on every side
     (dropped, never clamped).  The counters are reset before each card
     run of (a) and each render of (c)-(e) and read after it; the kernels
     line adds those launches to #1 / #2 (brute mode), #3 (the walk) and
     #4.
 26. slice 9, the forward renderers (integrators/misc.py), the samplers
     and the CLI's new routes: (a) render_field, all nine kinds, on the
     box at 256x256 x 4 spp (brute mode) and on a 64x64 film of
     cornell_large.xml (the walk), each held per pixel against the same
     call on the CPU over the twins on the same uniforms, within 1e-5 of
     the sum of |value| landing in the pixel (the splat kernel's atomics
     add in another order; the first hits are the same triangles, t
     within a few ulps: PyTorch's elementwise kernels round a camera
     ray's direction differently on the two devices on some lanes), and
     its ms a render; (b) render_motion_aov of the box translated +20 x over the
     shutter against the CPU; (c) render_ptracer on the box at depth 8
     against phase 5's MC (PTRACER_GATE, the image mean's noise from the
     blocks printed beside it), its paths/s; (d) render_pt under each of
     the six samplers on the box, 16 renders of 1 spp each under their
     own shifts, their mean against phase 5's MC within four standard
     errors of the replicates (and SAMPLER_GATE); each sampler's matrix
     on the card bit for bit the CPU's on the same indices and shifts
     (or jitter); the paths/s of a 16-spp render, the median of
     SAMPLER_TIMINGS renders taken in turns over the samplers, with its
     min-max, beside independent's; (e) in a fresh process,
     tests/data/cornell.xml through integrator=field -o .npy (equal to
     the same render in this process), integrator=pssmlt with -t (stops
     after one block of two) and with -r (a partial EXR a block and
     _time.csv; its image against phase 22's MC), and a copy with
     <sampler type="sobol"> (written to chiprun_out/cornell_sobol.xml)
     through integrator=path against phase 22's MC and gate; and -x in
     another fresh process, which leaves the output as it was.  The
     counters are reset before each card run and read after it (the fresh
     processes print theirs); the kernels line adds those launches to
     #1 / #2, #3, #4 and #5.
Then one JSON line of kernels, and last one JSON line
{"ok": true, "device": {...}}.  Details also go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig  # noqa: E402
from drmlt_mitsuba_tpu_torch.integrators.drmlt import (  # noqa: E402
    DRMLTConfig, DRMLTUniforms, draw_drmlt_uniforms,
    drmlt_mixture_step_from_uniforms, drmlt_step_from_uniforms,
    render_drmlt, render_drmlt_path,
)
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig  # noqa: E402
from drmlt_mitsuba_tpu_torch.integrators.mcmc import (  # noqa: E402
    ChainState, bootstrap, state_from_splats,
)
from drmlt_mitsuba_tpu_torch.integrators.mmlt import (  # noqa: E402
    make_mmlt_trace, mmlt_masks, mmlt_n_dims,
)
from drmlt_mitsuba_tpu_torch.integrators.mmlt_grouped import (  # noqa: E402
    N_MUT, group_bootstrap, group_starts, make_mmlt_trace_fixed,
    render_drmlt_mmlt_grouped,
)
from drmlt_mitsuba_tpu_torch.integrators.path import (  # noqa: E402
    make_path_trace, render_pt,
)
from drmlt_mitsuba_tpu_torch.integrators.pssmlt import (  # noqa: E402
    PSSMLTConfig, render_pssmlt,
)
from drmlt_mitsuba_tpu_torch.core.spectrum import (  # noqa: E402
    LUMINANCE_WEIGHTS,
)
from drmlt_mitsuba_tpu_torch.ops import build  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import intersect as IX  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import splat as SP  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megadrmlt as MD  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megammlt as MM  # noqa: E402
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT  # noqa: E402
from drmlt_mitsuba_tpu_torch.render import film as filmlib  # noqa: E402
from drmlt_mitsuba_tpu_torch.scene.builders import (  # noqa: E402
    cornell_box, cornell_scope, furnace_sphere, veach_door,
)
from drmlt_mitsuba_tpu_torch.scene.bvh import build_bvh, pack_nodes  # noqa: E402
from drmlt_mitsuba_tpu_torch.scene.types import prepare_scene  # noqa: E402
from drmlt_mitsuba_tpu_torch.utils import cli, raybench  # noqa: E402
from drmlt_mitsuba_tpu_torch.utils.exr import read_exr  # noqa: E402

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


def bound(n_bytes, tri_tests, node_tests=0, past_b1=None):
    """(least ms for the work on the card, which side binds it): the bytes
    each input read once and each output written once over the HBM rate,
    against the ray-triangle and ray-box tests the run's data needed times
    their FP32 operations over the FP32 peak.  past_b1 (the brute sweep,
    which ends a test at b1 unless 0 <= b1 <= 1): the tests count up to b1
    and only past_b1 of them in full."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    tri_ops = (tri_tests * MT.FLOP_PER_TRI_TEST if past_b1 is None else
               tri_tests * IX.FLOP_TRI_TO_B1
               + past_b1 * (MT.FLOP_PER_TRI_TEST - IX.FLOP_TRI_TO_B1))
    t_ops = (tri_ops
             + node_tests * MT.FLOP_PER_NODE_TEST) / PEAK_FP32_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def same_bits(a, b):
    """Whether two float tensors are equal bit for bit."""
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def warp_bounce_row(active):
    """The warp-bounces of one path per thread, the lane-bounces / 32 and
    the compacted kernel's at its block (ops/megatrace.py:warp_bounces)
    for the twin's live masks."""
    return dict(per_thread=MT.warp_bounces(active),
                lanes_32=int(torch.stack(active).sum()) // 32,
                compacted=MT.warp_bounces(active, MT.PATH_BLOCK))


def path_turns(tables, uT, rounds=2, fn=MT.path_trace):
    """ms per launch of a path or adjoint kernel `fn` (compact) and of one
    path per thread (lane), in turns lane, compact, compact, lane,
    `rounds` times: {"compact": [...], "lane": [...]}."""
    ms = {"compact": [], "lane": []}
    for _ in range(rounds):
        for m in ("lane", "compact", "compact", "lane"):
            ms[m].append(event_ms(lambda: fn(
                tables, uT, compact=m == "compact"), runs=10))
    return ms


def fmt_turns(turns):
    return ", ".join(f"{m} {sum(v) / len(v):.4f} ms" for m, v in turns.items())


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


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
                  work=None, pssmlt=False):
    """Run the chain kernel and its twin from state0 on separate clones of
    the state, film and stats; returns lane agreement (the share of chains
    whose PSS rows agree to 2e-5), the films' relative L1 difference, the
    largest state difference over agreeing chains, the stats' sums and the
    twin's wall seconds (work: the twin counts its ray-triangle tests;
    pssmlt: both run the pssmlt mode)."""
    out = []
    twin_s = 0.0
    for fn in (MD.drmlt_chain_step, MD.drmlt_chain_step_reference):
        st = state0.clone()
        film = torch.zeros((size, size, 3), device=state0.device)
        stats = torch.zeros((6, state0.shape[1]), device=state0.device)
        kw = ({} if fn is MD.drmlt_chain_step or work is None
              else dict(work=work))
        kw["pssmlt"] = pssmlt
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
    blk = img.shape[0] // 16
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
            lane_eq = same_bits(kk, fn(tables, uT, compact=False))
            turns = path_turns(tables, uT, fn=fn)
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
                     finite=bool(torch.isfinite(kk).all()),
                     equal_to_lane_kernel=lane_eq, turns_ms=turns)
            report["adjoint_vs_twin"][f"{sname}/{mode}"] = r
            row.append(f"{mode}: rgb bit-equal {r['rgb_bit_equal']:.5f}, "
                       f"rows {r['rows_rtol_1e5']:.5f}, grad rel {g_rel:.1e}, "
                       f"bit-equal to one path per thread {lane_eq}, in "
                       f"turns {fmt_turns(turns)}")
            need(lane_eq, f"{sname}/{mode}: the compacting adjoint differs "
                 f"from one path per thread")
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
          f"ms vs twin {timing['rad'][1]:.3f} ms, its backward's einsum "
          f"{timing['rad'][3]:.4f} ms; path_trace_alb_kernel "
          f"{timing['alb'][0]:.3f} ms vs twin {timing['alb'][1]:.3f} ms, its "
          f"backward's einsum {timing['alb'][3]:.4f} ms ({CHAINS} lanes, depth "
          f"{GRAD_DEPTH}, rr {GRAD_RR}; bound {timing['rad'][2][0]:.4f} ms by "
          f"{timing['rad'][2][1]}, {work['tri_tests']} ray-triangle tests); "
          f"grad_paths_per_sec {rate_r:.4e}, grad_albedo_paths_per_sec "
          f"{rate_a:.4e} (forward + backward, {GRAD_CALLS} calls; a "
          f"radiance call keeps the device busy {step_dev_ms:.3f} ms, a "
          f"busy share of {step_busy:.3f})")
    # the einsum is the backward's own cost, not the same function: no
    # PyTorch call traces a path, so the kernels line has no library time
    out["rad"] = (adj_err["rad"], *timing["rad"][:3])
    out["alb"] = (adj_err["alb"], *timing["alb"][:3])

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



LARGE_XML = os.path.join(ROOT, "tests", "data", "large", "cornell_large.xml")
RAYS = 1 << 20   # raybench's rays
TWIN_LANES = 16384   # the MMLT and adjoint twins' lane subset (phase 16)
# slice 4's b against the 36-triangle Cornell box's b (the same geometry
# and materials): about four standard deviations of the difference of two
# independent b's, from b's spread over bootstrap seeds (PERF.md: path
# 1.8%, MMLT 0.46%, so sqrt(2) x 1.8% x 4 and sqrt(2) x 0.46% x 4)
B_GATE = {"path": 0.10, "mmlt": 0.026}


def box_rays(n, gen, dev):
    """Rays from inside the 556-unit box in uniform directions."""
    o = torch.rand((n, 3), generator=gen, device=dev) * 554.0 + 1.0
    d = torch.randn((n, 3), generator=gen, device=dev)
    return o, d / d.norm(dim=1, keepdim=True)


def ray_bytes(tables, n, out_bytes=8):
    """Bytes the intersection kernel must move: o, d, tmax read, t and id
    written (any hit: one byte), and the tables read once."""
    nd = tables.nodes
    tab = nbytes(tables.tri) + (0 if nd is None else
                                nbytes(nd.node, nd.rec))
    return n * (28 + out_bytes) + tab


def slice4(name, dev, gen, fc, report, b_path, b_mmlt):
    """Phases 15-18: asset-scale scenes (the BVH walk in every trace kernel,
    the intersection kernel, the XML loader).  Returns the kernels-line
    figures of the intersection kernel and the walk."""
    out = {}
    # ---- 15. the intersection kernel vs its plain version -------------------
    cases = [("sphere-4000", raybench.bumpy_sphere(4000)),
             ("sphere-20000", raybench.bumpy_sphere(20000)),
             ("sphere-65826", raybench.bumpy_sphere(65826)),
             ("cornell_large", cli.load_scene(LARGE_XML, {})[0])]
    report["intersect"] = {}
    for cname, sc in cases:
        sc = prepare_scene(sc)
        tables = IX.make_ray_tables(sc, dev)
        if cname.startswith("sphere"):
            o, d = raybench.rays(RAYS, dev)
            tmax = torch.rand(RAYS, generator=gen, device=dev) * 6.0
        else:
            o, d = box_rays(RAYS, gen, dev)
            tmax = torch.rand(RAYS, generator=gen, device=dev) * 900.0
        t, i = IX.closest(tables, o, d)
        hit = IX.any_hit(tables, o, d, tmax)
        torch.cuda.synchronize()
        work = {}
        (rt, ri), plain_s = sync_time(lambda: IX.closest_reference(
            tables, o, d, work=work))
        awork = {}
        ra = IX.any_reference(tables, o, d, tmax, work=awork)
        t_eq = float((t.view(torch.int32) == rt.view(torch.int32))
                     .double().mean())
        i_eq = float((i == ri).double().mean())
        a_eq = float((hit == ra).double().mean())
        mode = "bvh" if tables.nodes is not None else "brute"
        row = dict(mode=mode, triangles=sc.tris.v0.shape[0], t_equal=t_eq,
                   id_equal=i_eq, any_equal=a_eq,
                   hit_share=float((i >= 0).double().mean()))
        ms = event_ms(lambda: IX.closest(tables, o, d), runs=10)
        bnd = bound(ray_bytes(tables, RAYS), work.get("tri_tests", 0),
                    work.get("node_tests", 0), work.get("tri_past_b1"))
        row.update(ms=ms, mrays_per_s=RAYS / ms / 1e3, plain_ms=plain_s * 1e3,
                   bound_ms=bnd[0], bound_by=bnd[1], **work)
        if mode == "brute":
            # the brute mode's any-hit sweep, timed and bounded apart
            ms_a = event_ms(lambda: IX.any_hit(tables, o, d, tmax), runs=10)
            bnd_a = bound(ray_bytes(tables, RAYS, 1), awork["tri_tests"],
                          past_b1=awork["tri_past_b1"])
            row["any"] = dict(ms=ms_a, mrays_per_s=RAYS / ms_a / 1e3,
                              bound_ms=bnd_a[0], bound_by=bnd_a[1],
                              tri_tests=awork["tri_tests"],
                              tri_past_b1=awork["tri_past_b1"],
                              blocked_share=float(hit.double().mean()))
        if mode == "bvh":
            brute = IX.make_ray_tables(sc, dev, walk=False)
            bt, bi = IX.closest(brute, o, d)
            ba = IX.any_hit(brute, o, d, tmax)
            ms_b = event_ms(lambda: IX.closest(brute, o, d), runs=1)
            row.update(walk_equals_brute=bool(
                torch.equal(bt.view(torch.int32), t.view(torch.int32))
                and torch.equal(bi, i) and torch.equal(ba, hit)),
                brute_ms=ms_b)
            need(row["walk_equals_brute"], f"{cname}: walk != brute kernel")
        report["intersect"][cname] = row
        print(f"[15 intersection kernel vs plain] {name}: {cname} "
              f"({row['triangles']} triangles, {mode}), {RAYS} rays: t "
              f"bit-equal {t_eq:.6f}, id equal {i_eq:.6f}, any-hit equal "
              f"{a_eq:.6f} (hits {row['hit_share']:.3f}); {ms:.3f} ms "
              f"({row['mrays_per_s']:.1f} MRays/s) vs plain "
              f"{row['plain_ms']:.1f} ms; bound {bnd[0]:.4f} ms by {bnd[1]} "
              f"({work.get('node_tests', 0)} box tests, "
              f"{work.get('tri_tests', 0)} triangle tests)"
              + (f"; the walk equals the brute kernel "
                 f"({row['brute_ms']:.2f} ms)" if mode == "bvh" else
                 f"; any hit {row['any']['ms']:.3f} ms "
                 f"({row['any']['mrays_per_s']:.1f} MRays/s), bound "
                 f"{row['any']['bound_ms']:.4f} ms by "
                 f"{row['any']['bound_by']} "
                 f"({row['any']['tri_tests']} triangle tests)"))
        need(t_eq == 1.0 and i_eq == 1.0 and a_eq == 1.0,
             f"{cname}: intersection kernel differs from its plain version")
    # raybench, the entry point of the intersection kernel, in both modes
    report["raybench_launches"] = {}
    for tris in (20000, 4000):
        build.reset_launches()
        raybench.main(["--tris", str(tris), "--rays", str(RAYS)])
        report["raybench_launches"][tris] = build.LAUNCHES["intersect"]
        need(build.LAUNCHES["intersect"] > 0, "raybench launched nothing")
    out["intersect_bvh"] = dict(
        launches=report["raybench_launches"][20000], err=0.0,
        **{k: report["intersect"]["sphere-20000"][k] for k in
           ("ms", "plain_ms", "bound_ms", "bound_by")})
    out["intersect_brute"] = dict(
        launches=report["raybench_launches"][4000], err=0.0,
        **{k: report["intersect"]["sphere-4000"][k] for k in
           ("ms", "plain_ms", "bound_ms", "bound_by")})

    # ---- 16. every trace kernel on the large scene vs its twin --------------
    scene, settings = cli.load_scene(LARGE_XML, {"integrator": "drmlt"})
    need(scene.bvh is not None, "the large scene has no BVH")
    pcfg = PathConfig(max_depth=DEPTH, rr_depth=100)
    tables = MT.make_tables(scene, pcfg, dev)
    uT = torch.rand((pcfg.n_dims, CHAINS), generator=gen, device=dev)
    k = MT.path_trace(tables, uT)
    lane_eq = same_bits(k, MT.path_trace(tables, uT, compact=False))
    torch.cuda.synchronize()
    walk_work, live = {}, []
    t, plain_s = sync_time(lambda: MT.path_trace_reference(
        tables, uT, walk_work, live))
    wb = warp_bounce_row(live)
    mx, mean, bad = lane_diff(k, t)
    ms_walk = event_ms(lambda: MT.path_trace(tables, uT), runs=10)
    turns = path_turns(tables, uT, rounds=1)
    nd = tables.nodes
    bnd = bound(nbytes(uT, tables.tri, tables.mat, tables.em, tables.cam,
                       nd.node, nd.rec) + 3 * CHAINS * 4,
                walk_work["tri_tests"], walk_work["node_tests"])
    report["large_path_vs_twin"] = dict(
        max_abs=mx, mean_abs=mean, bad_lanes=bad, ms=ms_walk,
        plain_ms=plain_s * 1e3, bound_ms=bnd[0], bound_by=bnd[1],
        equal_to_lane_kernel=lane_eq, turns=turns, warp_bounces=wb,
        **walk_work)
    print(f"[16 path kernel on the large scene vs twin] {name}: "
          f"{scene.tris.v0.shape[0]} triangles, BVH of {nd.n_nodes} nodes, "
          f"{CHAINS} lanes, depth {DEPTH}: lanes differing {bad:.5f}, max |d| "
          f"{mx:.2e}; bit-equal to one path per thread {lane_eq}; "
          f"{ms_walk:.3f} ms vs twin {plain_s * 1e3:.0f} ms; in turns "
          f"{fmt_turns(turns)}; warp-bounces (twin) {wb}; "
          f"bound {bnd[0]:.4f} ms by {bnd[1]} ({walk_work['node_tests']} box "
          f"tests, {walk_work['tri_tests']} triangle tests)")
    need(bad <= MAX_BAD_LANES, f"large scene path kernel: {bad} lanes differ")
    need(lane_eq, "large scene: the compacting path kernel differs from "
         "one path per thread")
    out["walk"] = dict(err=mx, ms=ms_walk, plain_ms=plain_s * 1e3,
                       bound_ms=bnd[0], bound_by=bnd[1])

    row = []
    for depth in range(1, MMLT_DEPTH + 1):
        mt = MM.make_mmlt_tables(scene, BDPTConfig(max_depth=depth), dev)
        uM = torch.rand((mt.n_core, CHAINS), generator=gen, device=dev)
        k = MM.mmlt_trace(mt, uM)[:, :TWIN_LANES]
        torch.cuda.synchronize()
        t = MM.mmlt_trace_reference(mt, uM[:, :TWIN_LANES].contiguous())
        mx, _, bad = lane_diff(k, t, pos_rows=2)
        row.append(f"d{depth} {1 - bad:.5f}")
        report[f"large_mmlt_vs_twin_d{depth}"] = dict(max_abs=mx,
                                                      bad_lanes=bad)
        need(bad <= MAX_BAD_LANES_MMLT, f"large MMLT d{depth}: {bad} differ")
    print(f"[16 MMLT kernel on the large scene vs twin] {name}: {CHAINS} "
          f"lanes, the twin on the first {TWIN_LANES} (depth, lanes "
          f"agreeing): " + ", ".join(row))

    for mode, fn, twin in (("rad", MT.path_trace_rad,
                            MT.path_trace_rad_reference),
                           ("alb", MT.path_trace_alb,
                            MT.path_trace_alb_reference)):
        gcfg = PathConfig(max_depth=GRAD_DEPTH, rr_depth=GRAD_RR)
        gt = MT.make_tables(scene, gcfg, dev)
        uG = torch.rand((gcfg.n_dims, CHAINS), generator=gen, device=dev)
        k = fn(gt, uG)[:, :TWIN_LANES]
        torch.cuda.synchronize()
        t = twin(gt, uG[:, :TWIN_LANES].contiguous())
        same = (k[:3] == t[:3]).all(0)
        rows_ok = bool(torch.allclose(k[3:, same], t[3:, same], rtol=1e-5,
                                      atol=0.0))
        share = float(same.double().mean())
        report[f"large_{mode}_vs_twin"] = dict(rgb_bit_equal=share,
                                              rows_rtol_1e5=rows_ok)
        print(f"[16 {mode} adjoint kernel on the large scene vs twin] "
              f"{name}: rgb bit-equal on {share:.5f} of {TWIN_LANES} lanes, "
              f"Jacobian rows within rtol 1e-5 there: {rows_ok}")
        need(share >= 1.0 - MAX_BAD_LANES and rows_ok,
             f"large scene {mode} adjoint differs from its twin")

    # the chain kernel, both modes: against the twin at 4,096 x 2; at
    # 65,536 x 64 against its own brute mode (the same launch without the
    # node table; state and stats bit for bit), since the twin would take
    # ~10 minutes there
    cfg = DRMLTConfig(type="orbital", n_chains=CHAINS, n_bootstrap=100_000,
                      p_large=0.3, splat_mode="sampled")
    trace = make_path_trace(scene, pcfg, dev)
    D = pcfg.n_dims + pcfg.n_dims % 2
    cand = torch.rand((2 * CHAINS, D), generator=gen, device=dev)
    u0 = cand[torch.nonzero(trace(cand).lum > 0)[:CHAINS, 0]]
    need(u0.shape[0] == CHAINS, "too few valid starting states")
    path_state = MD.pack_chain_state(state_from_splats(u0, trace(u0)))
    mtab, mstate, _ = slice2_starts(scene, MMLT_DEPTH, gen, dev)
    out["chain"] = {}
    for tech, tab, st0 in (("path", tables, path_state),
                           ("mmlt", mtab, mstate)):
        r = compare_chain(tab, dataclasses.replace(cfg, n_chains=C4), 2,
                          st0[:, :C4].contiguous(), SIZE, 41, 1, None)
        report[f"large_chain_vs_twin_{tech}"] = r
        print(f"[16 chain kernel ({tech}) on the large scene vs twin] "
              f"{name}: {C4} chains x 2 mutations, Philox: lanes agreeing "
              f"{r['lane_agreement']:.5f}, film rel L1 "
              f"{r['film_rel_l1']:.2e}, stats {r['stats_kernel']} vs "
              f"{r['stats_twin']}")
        check_chain(f"large {tech}", r)
        runs = []
        for tb in (tab, dataclasses.replace(tab, nodes=None)):
            st = st0.clone()
            film = torch.zeros((SIZE, SIZE, 3), device=dev)
            stats = torch.zeros((6, CHAINS), device=dev)
            _, sec = sync_time(lambda: MD.drmlt_chain_step(
                tb, cfg, 64, st, film, stats, 43, 0))
            runs.append((st, film, stats, sec))
        (sw, fw, tw, _), (sb, fb, tb_, brute_s) = runs
        # the film's atomic adds land in no fixed order: rtol 1e-5
        film_rel = float((fw - fb).abs().sum() / fb.abs().sum())
        same = bool(torch.equal(sw, sb) and torch.equal(tw, tb_)
                    and film_rel <= 1e-5)
        st = st0.clone()
        film = torch.zeros((SIZE, SIZE, 3), device=dev)
        stats = torch.zeros((6, CHAINS), device=dev)
        ms = event_ms(lambda: MD.drmlt_chain_step(tab, cfg, 64, st, film,
                                                  stats, 43, 0), runs=3)
        out["chain"][tech] = ms
        report[f"large_chain_walk_vs_brute_{tech}"] = dict(
            equal=same, film_rel_l1=film_rel, walk_ms=ms,
            brute_ms=brute_s * 1e3)
        print(f"[16 chain kernel ({tech}) walk vs brute mode] {name}: "
              f"{CHAINS} chains x 64 mutations: state and stats bit-equal, "
              f"film rel L1 {film_rel:.1e}: {same}; walk {ms:.2f} ms, brute "
              f"{brute_s * 1e3:.1f} ms per launch")
        need(same, f"large {tech}: the walk and the sweep differ")

    # ---- 17. both renders of the XML scene through the CLI's functions ------
    args = argparse.Namespace(chains=CHAINS, spp=256, seed=0)
    report["slice4"] = {}
    for tech, depth, b_ref in (("mmlt", MMLT_DEPTH, b_mmlt),
                               ("path", DEPTH, b_path)):
        (sc, st), load_s = sync_time(lambda: cli.load_scene(
            LARGE_XML, {"integrator": "drmlt", "technique": tech}))
        st.integrator["maxDepth"] = depth
        cli.render(args, sc, st, dev)              # first call
        args.seed = 1
        build.reset_launches()
        (img, aux), wall = sync_time(lambda: cli.render(args, sc, st, dev))
        launches = dict(build.LAUNCHES)
        if tech == "mmlt":
            muts = sum(CHAINS * s for s in aux["steps_eff"].values())
        else:
            muts = CHAINS * aux["steps"]
        gen.manual_seed(30)
        ref = filmlib.develop(fc, render_pt(
            sc, PathConfig(max_depth=depth, rr_depth=100), gen,
            SIZE * SIZE * 64, fc, mode="accum"), mode="accum")
        mean_rel, block_l1 = mc_compare(img, ref)
        b = float(aux["b"])
        b_rel = abs(b - b_ref) / b_ref
        args.seed = 2
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (_, auxp), prof_wall = sync_time(lambda: cli.render(
                args, sc, st, dev))
        evs = prof.events()
        busy, per = device_profile(evs, prof_wall)
        chain_ev = sorted((e.time_range.start, e.time_range.elapsed_us())
                          for e in evs if e.device_type == DeviceType.CUDA
                          and "drmlt_chain_kernel" in e.name)
        if tech == "mmlt":
            chain_ms, i = {}, 0
            for kk, n_l in group_launches(auxp).items():
                chain_ms[kk] = round(sum(us for _, us in
                                         chain_ev[i:i + n_l]) / 1e3, 3)
                i += n_l
        else:
            chain_ms = round(sum(us for _, us in chain_ev) / 1e3
                             / max(len(chain_ev), 1), 3)
        report["slice4"][tech] = dict(
            load_s=load_s, b=b, b_36=b_ref, b_rel=b_rel, wall_s=wall,
            mutations=muts,
            mutations_per_s=muts / wall, mean_rel_err=mean_rel,
            block_rel_l1=block_l1, launches=launches, busy_share=busy,
            profile_wall_s=prof_wall, chain_ms=chain_ms)
        print(f"[17 slice 4, {tech} render of cornell_large.xml] {name}: "
              f"load (XML, OBJ, BVH build on the host) {load_s:.2f} s; b "
              f"{b:.6f} vs the 36-triangle box's {b_ref:.6f} (rel "
              f"{b_rel:.4f}, gate {B_GATE[tech]}); warm {wall:.3f} s for "
              f"{muts} mutations ({muts / wall:.4e} mutations/s, bootstrap "
              f"included); vs MC mean rel {mean_rel:.4f}, 16x16-block rel "
              f"L1 {block_l1:.4f}; chain kernel ms "
              f"{'per group ' if tech == 'mmlt' else 'per launch '}"
              f"{chain_ms}; device busy {busy:.4f}; launches {launches}")
        need(bool(torch.isfinite(img).all()), f"{tech}: image not finite")
        gate = MC_GATE["cornell" if tech == "mmlt" else "path"]
        need(mean_rel < gate and block_l1 < 0.25,
             f"large {tech}: differs from MC by {mean_rel} / {block_l1}")
        need(b_rel < B_GATE[tech], f"large {tech}: b {b} vs {b_ref}")
        names = (("mmlt_trace", "drmlt_mmlt") if tech == "mmlt" else
                 ("path_trace", "drmlt_path"))
        need(all(launches[n] > 0 for n in names),
             f"a kernel of the large-scene path did not launch: {launches}")
        out.setdefault("walk_launches", 0)
        out["walk_launches"] += sum(launches[n] for n in names)

    # ---- 18. the depth-2 path-trace sweep over the triangle count -----------
    pcfg2 = PathConfig(max_depth=2, rr_depth=100)
    u2 = torch.rand((pcfg2.n_dims, CHAINS), generator=gen, device=dev)
    report["sweep"] = {}
    # at and below BVH_MIN_TRIS the tables carry no BVH; one is built here
    # for the walk's side, to place the crossover
    for tess in (1, 2, 4, 8, 11, 13, 24, 44):
        sc = prepare_scene(cornell_box(SIZE, SIZE, tessellate=tess))
        brute = dataclasses.replace(MT.make_tables(sc, pcfg2, dev),
                                    nodes=None)
        t = sc.tris
        tb = dataclasses.replace(brute, nodes=pack_nodes(
            sc.bvh if sc.bvh is not None else build_bvh(
                t.v0.numpy(), t.e1.numpy(), t.e2.numpy()), brute.tri))
        ms_w = event_ms(lambda: MT.path_trace(tb, u2), runs=10)
        ms_b = event_ms(lambda: MT.path_trace(brute, u2), runs=2)
        same = bool(torch.equal(MT.path_trace(tb, u2),
                                MT.path_trace(brute, u2)))
        T = sc.tris.v0.shape[0]
        report["sweep"][T] = dict(walk_ms=ms_w, brute_ms=ms_b,
                                  walk_paths_per_s=CHAINS / ms_w * 1e3,
                                  brute_paths_per_s=CHAINS / ms_b * 1e3,
                                  bvh_by_default=sc.bvh is not None,
                                  bit_equal=same)
        print(f"[18 depth-2 path trace sweep] {name}: {T} triangles "
              f"(default: {'walk' if sc.bvh is not None else 'sweep'}): "
              f"walk {ms_w:.3f} ms ({CHAINS / ms_w * 1e3:.4e} paths/s), "
              f"brute {ms_b:.3f} ms ({CHAINS / ms_b * 1e3:.4e} paths/s), "
              f"equal {same}")
        need(same, f"tessellate {tess}: walk and sweep differ")
    return out


# ---------------------------------------------------------------- slice 5
CORNELL_XML = os.path.join(ROOT, "tests", "data", "cornell.xml")
XML_SPP = 4096        # -D spp=4096: the file's sampleCount
# phase 23d: the CLI's Kelemen MMLT render's channel means / MC within this
# of the estimator's expectation, and Kelemen / Veach on the same chains
# within half of it (on an H100 the Veach render's channel means lie within
# 0.0035 of MC's, and the expectation up to 0.04 above 1: PERF.md, slice 6)
KELEMEN_TOL = 0.012
SCOPE_SEEDS = 16      # bootstrap seeds for the spread of b (phase 22)
MC_SPP = 64           # samples per pixel of the MC references
FURNACE_PATHS = 1 << 22   # the furnace check's paths (1,024 per pixel)
FURNACE_SIZE = 64
# the 256x256 configurations of slice 5 (cornell_scope), and the one the
# MMLT kernel does not take (the reference's MMLT kernel has no thin lens)
SCOPE = ("kinds", "const", "thinlens", "env64", "env256")
NO_MMLT = ("thinlens",)
# the plain-MC witness of phase 22: the MMLT technique's image against the
# path technique's on env64 at 64x64, from WITNESS_BATCHES x WITNESS_LANES
# samples
# each, in 4x4-pixel blocks; gates on the z-scores of their difference
WITNESS_BATCHES = 64
WITNESS_LANES = 1 << 20
WITNESS_Z_MEAN = 4.0    # |z| of the image means
WITNESS_Z_RMS = 1.5     # rms of the 256 block z-scores (about 1 unbiased)


def scope_scenes():
    """{name: (scene, settings)} of slice 5: the scene file and the 256x256
    configurations."""
    out = {"cornell.xml": cli.load_scene(CORNELL_XML, {"integrator": "drmlt"})}
    for v in SCOPE:
        out[v] = (cornell_scope(SIZE, SIZE, v), None)
    return out


def _thin(scene):
    return float(scene.camera.aperture_radius) > 0


def path_states(scene, pcfg, gen, dev, n):
    """A packed starting state of n chains (every lum > 0) from the path
    kernel."""
    trace = make_path_trace(scene, pcfg, dev)
    D = pcfg.n_dims + pcfg.n_dims % 2
    cand = torch.rand((8 * n, D), generator=gen, device=dev)
    u0 = cand[torch.nonzero(trace(cand).lum > 0)[:n, 0]]
    need(u0.shape[0] == n, "too few valid starting states")
    return MD.pack_chain_state(state_from_splats(u0, trace(u0)))


def furnace_coverage(scene, n, sub=16):
    """The share of each pixel of an n x n film whose camera rays hit the
    furnace's unit sphere, from sub x sub rays per pixel (float64)."""
    cam = scene.camera
    c2w = cam.to_world.double().numpy()
    s = (np.arange(n * sub) + 0.5) / (n * sub)
    X, Y = np.meshgrid(s, s)
    x = (2.0 * X - 1.0) * float(cam.tan_half_fov_x)
    y = (1.0 - 2.0 * Y) * float(cam.tan_half_fov_y)
    d = np.stack([x, y, np.ones_like(x)], -1) @ c2w[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    c = scene.spheres.center[0].double().numpy() - c2w[:3, 3]
    tc = d @ c
    dist2 = (c @ c) - tc * tc
    hit = (tc > 0) & (dist2 <= float(scene.spheres.radius[0]) ** 2)
    return hit.reshape(n, sub, n, sub).mean((1, 3))


def mc_witness(scene, depth, gen, dev, n):
    """Plain-MC images of the path and the MMLT technique on an n x n
    film: {tech: (per-pixel mean luminance, its standard error, the image
    mean, its standard error)}.  A sample adds n^2 lum to its pixel's
    estimate; the errors count the samples' spread over pixels too."""
    pc = PathConfig(max_depth=depth, rr_depth=100)
    bc = BDPTConfig(max_depth=depth)
    N = WITNESS_BATCHES * WITNESS_LANES
    P = n * n
    out = {}
    for tech, trace, dims in (
            ("path", make_path_trace(scene, pc, dev), pc.n_dims),
            ("mmlt", make_mmlt_trace(scene, bc, dev), mmlt_n_dims(bc))):
        s1 = torch.zeros(P, dtype=torch.float64, device=dev)
        s2 = torch.zeros_like(s1)
        for _ in range(WITNESS_BATCHES):
            sp = trace(torch.rand((WITNESS_LANES, dims), generator=gen,
                                  device=dev))
            p = sp.pos[:, 0, :]
            pix = (torch.clamp(torch.floor(p[:, 1] * n), 0, n - 1) * n
                   + torch.clamp(torch.floor(p[:, 0] * n), 0, n - 1)).long()
            lum = sp.lum.double()
            s1.index_add_(0, pix, lum)
            s2.index_add_(0, pix, lum * lum)
        m = s1 * P / N
        se = torch.sqrt(torch.clamp(s2 * P * P / N - m * m, min=0) / N)
        mean = float(s1.sum()) / N
        se_mean = max(float(s2.sum()) / N - mean * mean, 0.0) ** 0.5 / N ** 0.5
        out[tech] = (m.reshape(n, n), se.reshape(n, n), mean, se_mean)
    return out


def slice5(name, dev, gen, report):
    """Phases 19-22: the trace kernels' full scene scope.  Returns the
    kernels-line figures of the full-scope instantiations."""
    out = {}
    scenes = scope_scenes()
    pcfg = PathConfig(max_depth=DEPTH, rr_depth=100)
    # ---- 19. path kernel and both adjoints vs twins on each new scene -------
    report["scope_path_vs_twin"] = {}
    path_err = 0.0
    for sname, (sc, _) in scenes.items():
        cfg = dataclasses.replace(pcfg, thinlens=_thin(sc))
        tables = MT.make_tables(sc, cfg, dev)
        need(tables.full, f"{sname}: not the full-scope instantiation")
        uT = torch.rand((cfg.n_dims, CHAINS), generator=gen, device=dev)
        k = MT.path_trace(tables, uT)
        lane_eq = same_bits(k, MT.path_trace(tables, uT, compact=False))
        torch.cuda.synchronize()
        t = MT.path_trace_reference(tables, uT)
        mx, mean, bad = lane_diff(k, t)
        m_rel = float(((k.double().mean(1) - t.double().mean(1)).abs()
                       / t.double().mean(1).abs()).max())
        row = dict(max_abs=mx, mean_abs=mean, bad_lanes=bad, mean_rel=m_rel,
                   equal_to_lane_kernel=lane_eq)
        need(lane_eq, f"{sname}: the compacting path kernel differs from "
             f"one path per thread")
        adj = []
        for mode, fn, twin in (("rad", MT.path_trace_rad,
                                MT.path_trace_rad_reference),
                               ("alb", MT.path_trace_alb,
                                MT.path_trace_alb_reference)):
            if mode == "alb" and tables.tex_shape is not None:
                adj.append("alb: n/a (bitmap albedo)")
                continue
            kk = fn(tables, uT)
            torch.cuda.synchronize()
            tt = twin(tables, uT)
            same = (kk[:3] == tt[:3]).all(0)
            rows_ok = ((kk[3:] - tt[3:]).abs()
                       <= 1e-5 * tt[3:].abs()).all(0) & same
            row[mode] = dict(rgb_bit_equal=float(same.double().mean()),
                             rows_rtol_1e5=float(rows_ok.double().mean()),
                             finite=bool(torch.isfinite(kk).all()))
            adj.append(f"{mode}: rgb bit-equal "
                       f"{row[mode]['rgb_bit_equal']:.5f}, rows "
                       f"{row[mode]['rows_rtol_1e5']:.5f}")
            need(row[mode]["finite"], f"{sname}/{mode}: non-finite rows")
            need(row[mode]["rgb_bit_equal"] >= 1.0 - MAX_BAD_LANES
                 and row[mode]["rows_rtol_1e5"] >= 1.0 - MAX_BAD_LANES,
                 f"{sname}/{mode}: adjoint differs from its twin")
        report["scope_path_vs_twin"][sname] = row
        print(f"[19 path kernel and adjoints vs twins, full scope] {name}: "
              f"{sname}: {CHAINS} lanes, depth {DEPTH}: lanes differing "
              f"{bad:.5f}, max |d| {mx:.3e}, channel-mean rel {m_rel:.2e}, "
              f"bit-equal to one path per thread {lane_eq}; "
              + "; ".join(adj))
        need(bool(torch.isfinite(k).all()), f"{sname}: non-finite radiance")
        need(bad <= MAX_BAD_LANES, f"{sname}: {bad:.4f} of lanes differ")
        need(m_rel <= MEAN_RTOL, f"{sname}: channel means differ {m_rel}")
        path_err = max(path_err, mx)

    # times at the slice's shapes on the const configuration: the path
    # kernel (depth 8) and the adjoints (depth 6), against twins and bounds
    sc = scenes["const"][0]
    tables = MT.make_tables(sc, pcfg, dev)
    uT = torch.rand((pcfg.n_dims, CHAINS), generator=gen, device=dev)
    work, live = {}, []
    MT.path_trace_reference(tables, uT, work, live)
    wb = warp_bounce_row(live)
    ms = event_ms(lambda: MT.path_trace(tables, uT), runs=20)
    turns = path_turns(tables, uT)
    plain = event_ms(lambda: MT.path_trace_reference(tables, uT), runs=3)
    ext = nbytes(tables.sph, tables.tri_ext, tables.tex)
    bnd = bound(nbytes(uT, tables.tri, tables.mat, tables.em, tables.cam)
                + ext + 3 * CHAINS * 4, work["tri_tests"])
    out["path"] = dict(err=path_err, ms=ms, plain_ms=plain, bnd=bnd)
    gcfg = PathConfig(max_depth=GRAD_DEPTH, rr_depth=GRAD_RR)
    timing = {}
    for mode, fn, twin, sc_name in (
            ("rad", MT.path_trace_rad, MT.path_trace_rad_reference, "const"),
            ("alb", MT.path_trace_alb, MT.path_trace_alb_reference, "kinds")):
        gt = MT.make_tables(scenes[sc_name][0], gcfg, dev)
        uG = torch.rand((gcfg.n_dims, CHAINS), generator=gen, device=dev)
        gwork = {}
        MT.path_trace_reference(gt, uG, gwork)
        K = gt.em.shape[0] if mode == "rad" else gt.mat.shape[0]
        g_ms = event_ms(lambda: fn(gt, uG), runs=20)
        g_plain = event_ms(lambda: twin(gt, uG), runs=3)
        g_bnd = bound(nbytes(uG, gt.tri, gt.mat, gt.em, gt.cam, gt.sph)
                      + (3 + 3 * K) * CHAINS * 4, gwork["tri_tests"])
        timing[mode] = dict(scene=sc_name, ms=g_ms, plain_ms=g_plain,
                            bound_ms=g_bnd[0], bound_by=g_bnd[1])
    report["scope_timing_ms"] = dict(path=dict(
        scene="const", ms=ms, plain_ms=plain, bound_ms=bnd[0],
        bound_by=bnd[1], tri_tests=work["tri_tests"], turns=turns,
        warp_bounces=wb), **timing)
    print(f"[19 timing, full scope] {name}: path_trace_kernel[full] "
          f"{ms:.4f} ms vs twin {plain:.3f} ms ({CHAINS} lanes, depth "
          f"{DEPTH}, const configuration; in turns with one path per thread "
          f"{fmt_turns(turns)}; warp-bounces (twin) {wb}; bound "
          f"{bnd[0]:.4f} ms by {bnd[1]}); "
          + "; ".join(f"path_trace_{m}_kernel[full] {r['ms']:.3f} ms vs twin "
                      f"{r['plain_ms']:.3f} ms ({r['scene']}, depth "
                      f"{GRAD_DEPTH}; bound {r['bound_ms']:.4f} ms)"
                      for m, r in timing.items()))

    # ---- 20. the MMLT kernel vs its twin at depths 1-6 ----------------------
    report["scope_mmlt_vs_twin"] = {}
    mmlt_err = 0.0
    for sname, (sc, _) in scenes.items():
        if sname in NO_MMLT:
            continue
        row = []
        for depth in range(1, MMLT_DEPTH + 1):
            mt = MM.make_mmlt_tables(sc, BDPTConfig(max_depth=depth), dev)
            uM = torch.rand((mt.n_core, CHAINS), generator=gen, device=dev)
            k = MM.mmlt_trace(mt, uM)
            torch.cuda.synchronize()
            work = {}
            t = MM.mmlt_trace_reference(mt, uM, work)
            mx, _, bad = lane_diff(k, t, pos_rows=2)
            ms = event_ms(lambda: MM.mmlt_trace(mt, uM), runs=5)
            bnd = bound(nbytes(uM, mt.tri, mt.mat, mt.em, mt.cam, mt.sph,
                               mt.tri_ext, mt.tex) + 5 * CHAINS * 4,
                        work["tri_tests"], work.get("node_tests", 0))
            report["scope_mmlt_vs_twin"][f"{sname}/{depth}"] = dict(
                max_abs=mx, bad_lanes=bad, ms=ms, bound_ms=bnd[0])
            row.append(f"d{depth} {1 - bad:.5f} {ms:.4f} ms (bound "
                       f"{bnd[0]:.4f})")
            need(bool(torch.isfinite(k).all()), f"{sname}/{depth}: non-finite")
            need(bad <= MAX_BAD_LANES_MMLT,
                 f"MMLT {sname}/{depth}: {bad:.4f} of lanes differ")
            mmlt_err = max(mmlt_err, mx)
        print(f"[20 MMLT kernel vs twin, full scope] {name}: {sname}, "
              f"{CHAINS} lanes (depth, lanes agreeing, kernel ms, bound ms "
              f"from the twin's sweeps): " + ", ".join(row))
    mt6 = MM.make_mmlt_tables(scenes["const"][0],
                              BDPTConfig(max_depth=MMLT_DEPTH), dev)
    uM = torch.rand((mt6.n_core, CHAINS), generator=gen, device=dev)
    mwork = {}
    MM.mmlt_trace_reference(mt6, uM, mwork)
    m_ms = event_ms(lambda: MM.mmlt_trace(mt6, uM), runs=20)
    m_plain = event_ms(lambda: MM.mmlt_trace_reference(mt6, uM), runs=3)
    m_bnd = bound(nbytes(uM, mt6.tri, mt6.mat, mt6.em, mt6.cam, mt6.sph,
                         mt6.tri_ext, mt6.tex) + 5 * CHAINS * 4,
                  mwork["tri_tests"])
    out["mmlt"] = dict(err=mmlt_err, ms=m_ms, plain_ms=m_plain, bnd=m_bnd)
    report["scope_timing_ms"]["mmlt"] = dict(
        scene="const", ms=m_ms, plain_ms=m_plain, bound_ms=m_bnd[0],
        bound_by=m_bnd[1])
    print(f"[20 timing, full scope] {name}: mmlt_trace_kernel[full] "
          f"{m_ms:.3f} ms vs twin {m_plain:.3f} ms ({CHAINS} lanes, depth "
          f"{MMLT_DEPTH}; bound {m_bnd[0]:.4f} ms by {m_bnd[1]})")

    # ---- 21. the chain kernel, both modes, vs its twin ----------------------
    report["scope_chain_vs_twin"] = {}
    cfg_c = DRMLTConfig(type="orbital", n_chains=CHAINS, n_bootstrap=100_000,
                        p_large=0.3, splat_mode="sampled")
    chain_err = {"path": 0.0, "mmlt": 0.0}
    starts = {}
    for sname, (sc, _) in scenes.items():
        pc = dataclasses.replace(pcfg, thinlens=_thin(sc))
        modes = [("path", MT.make_tables(sc, pc, dev),
                  path_states(sc, pc, gen, dev, CHAINS))]
        if sname not in NO_MMLT:
            mtab, mst, _ = slice2_starts(sc, MMLT_DEPTH, gen, dev)
            modes.append(("mmlt", mtab, mst))
        rows = []
        for tech, tab, st0 in modes:
            starts[(sname, tech)] = (tab, st0)
            s4 = st0[:, :C4].contiguous()
            D = s4.shape[0] - 6
            for drtype, mode, given in (("orbital", "sampled", True),
                                        ("mira", "three", False)):
                ccfg = DRMLTConfig(type=drtype, splat_mode=mode, n_chains=C4,
                                   fix_emitter_path=drtype == "mira")
                uni = (torch.rand((2 * MD.n_rand(ccfg, D), C4), generator=gen,
                                  device=dev) if given else None)
                r = compare_chain(tab, ccfg, 2, s4, SIZE, 51, 1, uni)
                tag = (f"{sname}/{tech}/{drtype}/{mode}/"
                       f"{'uniforms' if given else 'philox'}")
                report["scope_chain_vs_twin"][tag] = r
                rows.append(f"{tech} {drtype}/{mode}/"
                            f"{'uniforms' if given else 'philox'} "
                            f"{r['lane_agreement']:.5f}")
                check_chain(tag, r)
                chain_err[tech] = max(chain_err[tech], r["state_max_abs"])
        print(f"[21 chain kernel vs twin, full scope] {name}: {sname}, {C4} "
              f"chains x 2 mutations (lanes agreeing): " + ", ".join(rows))
    # the slice's shape on the const configuration: 65,536 chains x 64
    # mutations, the kernel timed and the twin once (its wall is plain_ms)
    for tech in ("path", "mmlt"):
        tab, st0 = starts[("const", tech)]
        cwork = {}
        r = compare_chain(tab, cfg_c, 64, st0, SIZE, 5, 0, None)
        check_chain(f"const/{tech}/65536x64", r)
        stc = st0.clone()
        film = torch.zeros((SIZE, SIZE, 3), device=dev)
        stats = torch.zeros((6, CHAINS), device=dev)
        c_ms = event_ms(lambda: MD.drmlt_chain_step(tab, cfg_c, 64, stc, film,
                                                    stats, 5, 0), runs=3)
        # the ray-triangle tests of 2 mutations per chain (the twin's count
        # on 4,096 chains), scaled to 64 mutations of every chain
        MD.drmlt_chain_step_reference(
            tab, dataclasses.replace(cfg_c, n_chains=C4), 2,
            st0[:, :C4].contiguous(), torch.zeros((SIZE, SIZE, 3),
                                                  device=dev),
            torch.zeros((6, C4), device=dev), 5, 0, work=cwork)
        tests = cwork["tri_tests"] * (64 // 2) * (CHAINS // C4)
        share = MD.stage2_share(cwork)
        c_bnd = bound(2 * nbytes(stc) + nbytes(film) + 2 * nbytes(stats),
                      tests)
        out[f"chain_{tech}"] = dict(err=max(chain_err[tech],
                                            r["state_max_abs"]), ms=c_ms,
                                    plain_ms=r["twin_s"] * 1e3, bnd=c_bnd)
        report["scope_chain_vs_twin"][f"const/{tech}/65536x64"] = r
        report["scope_timing_ms"][f"chain_{tech}"] = dict(
            scene="const", ms=c_ms, plain_ms=r["twin_s"] * 1e3,
            bound_ms=c_bnd[0], bound_by=c_bnd[1], tri_tests=tests,
            stage2_share=share)
        print(f"[21 chain kernel ({tech}), full scope, {CHAINS} chains x 64 "
              f"mutations] {name}: const: lanes agreeing "
              f"{r['lane_agreement']:.5f}, film rel L1 "
              f"{r['film_rel_l1']:.2e}; kernel {c_ms:.2f} ms vs twin "
              f"{r['twin_s'] * 1e3:.0f} ms per launch, stage-2 share "
              f"{share:.4f}; bound {c_bnd[0]:.4f} ms by {c_bnd[1]}")

    # ---- 22. slice 5's main path: the CLI renders ---------------------------
    report["slice5"] = {}
    # the launches of the CLI renders only: reset before each render, read
    # after it (the MC references and the b seeds launch the path and MMLT
    # kernels too)
    launches5 = dict.fromkeys(build.LAUNCHES, 0)
    renders = []
    for tech in ("path", "mmlt"):
        (sc, xs), load_s = sync_time(lambda: cli.load_scene(
            CORNELL_XML, {"integrator": "drmlt", "technique": tech,
                          "type": "orbital", "spp": str(XML_SPP)}))
        renders.append(("cornell.xml", tech, sc, xs, load_s))
    for v in SCOPE[1:]:
        for tech in ("path", "mmlt"):
            if v in NO_MMLT and tech == "mmlt":
                continue
            xs = cli.RenderSettings(integrator=dict(
                type="drmlt", technique=tech, variant="orbital",
                splatMode="sampled",
                maxDepth=DEPTH if tech == "path" else MMLT_DEPTH),
                width=SIZE, height=SIZE, filter_name="box", spp=256)
            renders.append((v, tech, scenes[v][0], xs, 0.0))
    for sname, tech, sc, xs, load_s in renders:
        # a first call, then the warm call whose wall is the metric; the
        # two images (other seeds) measure the MCMC noise of the shape
        args = argparse.Namespace(chains=CHAINS, spp=None, seed=3)
        build.reset_launches()
        (img0, _), first_wall = sync_time(lambda: cli.render(args, sc, xs,
                                                             dev))
        args.seed = 4
        (img, aux), wall = sync_time(lambda: cli.render(args, sc, xs, dev))
        for k, c in build.LAUNCHES.items():
            launches5[k] += c
        if tech == "mmlt":
            muts = sum(CHAINS * s for s in aux["steps_eff"].values())
        else:
            muts = CHAINS * aux["steps"]
        depth = int(xs.integrator["maxDepth"])
        W, H = xs.width, xs.height
        fc_s = filmlib.make_film_config(W, H, "box")
        rcfg = PathConfig(max_depth=depth, rr_depth=100, thinlens=_thin(sc))
        refs = []
        for seed in (50, 51):
            gen.manual_seed(seed)
            refs.append(filmlib.develop(fc_s, render_pt(
                sc, rcfg, gen, max(W * H * MC_SPP, 1 << 22), fc_s,
                mode="accum"), mode="accum"))
        ref = refs[0]
        mean_rel, block_l1 = mc_compare(img, ref)
        # where the light lands, whatever the scale b (whose own noise the
        # mean's gate covers), against what the noise of two MC and of two
        # MCMC renders predicts for one of each (phase 9's shape check)
        shape = shape_l1(img, ref)
        noise_mc = shape_l1(refs[1], ref)
        noise_mcmc = shape_l1(img0, img)
        shape_expected = ((noise_mc ** 2 + noise_mcmc ** 2) / 2) ** 0.5
        # the gate: about four relative standard deviations of b over
        # bootstrap seeds, measured here
        bs = []
        for s in range(SCOPE_SEEDS):
            gen.manual_seed(2000 + s)
            if tech == "mmlt":
                bcfg = BDPTConfig(max_depth=depth)
                bs.append(float(render_drmlt_mmlt_grouped(
                    sc, bcfg, DRMLTConfig(type="orbital", n_chains=CHAINS),
                    fc_s, gen, 0)[1]["b"]))
            else:
                trace = make_path_trace(sc, rcfg, dev)
                bs.append(float(bootstrap(trace, gen, rcfg.n_dims
                                          + rcfg.n_dims % 2, 100_000,
                                          CHAINS)[1]))
        bs_t = torch.tensor(bs, dtype=torch.float64)
        b_rel_std = float(bs_t.std() / bs_t.mean())
        gate = max(4.0 * b_rel_std, 0.01)
        key = f"{sname}/{tech}"
        report["slice5"][key] = dict(
            wall_s=wall, first_wall_s=first_wall, load_s=load_s,
            mutations=muts,
            mutations_per_s=muts / wall, b=float(aux["b"]),
            b_rel_std=b_rel_std, gate=gate, mean_rel_err=mean_rel,
            block_rel_l1=block_l1, shape_l1=shape, shape_noise_mc=noise_mc,
            shape_noise_mcmc=noise_mcmc, shape_expected=shape_expected,
            size=[W, H], depth=depth,
            image_mean=img.double().mean((0, 1)).tolist(),
            ref_mean=ref.double().mean((0, 1)).tolist())
        print(f"[22 slice 5, {tech} render of {sname}] {name}: {W}x{H}, "
              f"depth {depth}, {muts} mutations, warm {wall:.3f} s "
              f"({muts / wall:.4e} mutations/s, bootstrap included; first "
              f"call {first_wall:.3f} s); b {float(aux['b']):.6f} (rel std "
              f"over {SCOPE_SEEDS} seeds {b_rel_std:.4f}); vs MC mean rel "
              f"{mean_rel:.4f} (gate {gate:.4f}), 16x16-block rel L1 "
              f"{block_l1:.4f}; shape L1 {shape:.4f} against "
              f"{shape_expected:.4f} from the noise of two MC "
              f"({noise_mc:.4f}) and two MCMC ({noise_mcmc:.4f}) renders")
        if sname == "cornell.xml":
            out[f"xml_{tech}"] = dict(ref=ref, gate=gate)
        need(bool(torch.isfinite(img).all()), f"{key}: image not finite")
        need(mean_rel < gate, f"{key}: differs from MC by {mean_rel}")
        need(shape < SHAPE_GATE * shape_expected,
             f"{key}: the light lands elsewhere than in MC ({shape}, the "
             f"noise predicts {shape_expected})")
    report["slice5_launches"] = launches5
    print(f"[22 slice 5 launches, the CLI renders] {name}: {launches5}")
    for k in ("path_trace[full]", "drmlt_path[full]", "mmlt_trace[full]",
              "drmlt_mmlt[full]"):
        need(launches5[k] > 0, f"{k} did not launch on slice 5's path")
    out["launches"] = launches5

    # the plain-MC witness: on env64 the MMLT technique's MCMC noise is high
    # (no light-side strategy for the environment), so its render's gates
    # above are wide; here its unbiasedness is held in plain MC, against the
    # path technique's image
    n = 64
    gen.manual_seed(60)
    w = mc_witness(cornell_scope(n, n, "env64"), MMLT_DEPTH, gen, dev, n)
    (mp, sp_, ap, ep), (mm, sm, am, em) = w["path"], w["mmlt"]
    z_mean = (am - ap) / (ep * ep + em * em) ** 0.5
    blk = lambda x: x.reshape(n // 4, 4, n // 4, 4).sum((1, 3))  # noqa: E731
    z = (blk(mm) - blk(mp)) / torch.sqrt(blk(sp_ ** 2) + blk(sm ** 2))
    z_rms = float(z.pow(2).mean().sqrt())
    report["mc_witness"] = dict(
        scene="env64", size=n, depth=MMLT_DEPTH,
        samples=WITNESS_BATCHES * WITNESS_LANES, mean_path=ap, mean_mmlt=am,
        z_mean=z_mean, block_z_rms=z_rms,
        block_z_max=float(z.abs().max()))
    print(f"[22 plain-MC witness] {name}: env64, {n}x{n}, depth "
          f"{MMLT_DEPTH}, {WITNESS_BATCHES * WITNESS_LANES} samples per "
          f"technique: "
          f"mean luminance path {ap:.5f}, mmlt {am:.5f} (z {z_mean:.3f}, "
          f"gate {WITNESS_Z_MEAN}); "
          f"4x4-block z rms {z_rms:.3f} (gate {WITNESS_Z_RMS}), max |z| "
          f"{float(z.abs().max()):.3f}")
    need(abs(z_mean) < WITNESS_Z_MEAN,
         f"plain MC: the MMLT technique's mean is off by z = {z_mean}")
    need(z_rms < WITNESS_Z_RMS,
         f"plain MC: the MMLT technique's image differs (block z rms {z_rms})")

    # the white furnace: a diffuse sphere (albedo 0.8) in a unit constant
    # environment; each pixel converges to 1 - 0.2 x its sphere coverage
    fsc = furnace_sphere(albedo=0.8, env=1.0)
    n = FURNACE_SIZE
    trace = make_path_trace(fsc, pcfg, dev)
    acc = torch.zeros((3, n * n), dtype=torch.float64, device=dev)
    for _ in range(16):
        u = torch.rand((FURNACE_PATHS // 16, pcfg.n_dims), generator=gen,
                       device=dev)
        v = trace(u).value[:, 0, 0].double()
        pix = (torch.floor(u[:, 1] * n) * n + torch.floor(u[:, 0] * n)).long()
        for i, x in enumerate((torch.ones_like(v), v, v * v)):
            acc[i].index_add_(0, pix, x)
    mean = acc[1] / acc[0]
    # a pixel's value is 1 or 0.8 per sample: its MC noise is 0.2 x the
    # binomial spread of its coverage; 1e-3 more for the coverage's own
    # estimate from 32 x 32 rays per pixel
    cov = torch.tensor(furnace_coverage(fsc, n, sub=32).reshape(-1),
                       device=dev)
    want = 1.0 - 0.2 * cov
    sigma = 0.2 * torch.sqrt(cov * (1.0 - cov) / acc[0])
    dev_pix = (mean - want).abs()
    furnace_ok = bool((dev_pix <= 5.0 * sigma + 1e-3).all())
    fsettings = cli.RenderSettings(integrator=dict(
        type="drmlt", technique="path", variant="orbital",
        splatMode="sampled", maxDepth=DEPTH), width=n, height=n,
        filter_name="box", spp=1024)
    fimg, _ = cli.render(argparse.Namespace(chains=CHAINS, spp=None, seed=4),
                         fsc, fsettings, dev)
    f_rel = float((fimg.double().mean() - want.mean()).abs() / want.mean())
    report["furnace"] = dict(max_abs_dev=float(dev_pix.max()),
                             max_sigma=float(sigma.max()),
                             within_5_sigma=furnace_ok,
                             samples_per_pixel=FURNACE_PATHS / (n * n),
                             drmlt_mean_rel=f_rel)
    print(f"[22 white furnace] {name}: {n}x{n}, {FURNACE_PATHS // (n * n)} "
          f"paths per pixel through the path kernel: every pixel within 5 "
          f"sigma (+1e-3) of 1 - 0.2 coverage: {furnace_ok} (largest |d| "
          f"{float(dev_pix.max()):.2e}, largest sigma "
          f"{float(sigma.max()):.2e}); the DRMLT render's mean rel "
          f"{f_rel:.4f}")
    need(furnace_ok, "the furnace's pixels miss the analytic value")
    need(f_rel < 0.02, f"the furnace's DRMLT mean is off by {f_rel}")

    # a profiled warm render of each technique on the const configuration
    report["slice5_profile"] = {}
    for tech in ("path", "mmlt"):
        xs = cli.RenderSettings(integrator=dict(
            type="drmlt", technique=tech, variant="orbital",
            splatMode="sampled",
            maxDepth=DEPTH if tech == "path" else MMLT_DEPTH),
            width=SIZE, height=SIZE, filter_name="box", spp=256)
        args = argparse.Namespace(chains=CHAINS, spp=None, seed=5)
        sc = scenes["const"][0]
        (_, auxw), warm = sync_time(lambda: cli.render(args, sc, xs, dev))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (_, auxp), prof_wall = sync_time(lambda: cli.render(args, sc, xs,
                                                                dev))
        busy, per = device_profile(prof.events(), prof_wall)
        top = sorted(per.items(), key=lambda kv: -kv[1][0])
        muts = (sum(CHAINS * s for s in auxw["steps_eff"].values())
                if tech == "mmlt" else CHAINS * auxw["steps"])
        report["slice5_profile"][tech] = dict(
            warm_s=warm, mutations=muts, mutations_per_s=muts / warm,
            profile_wall_s=prof_wall, busy_share=busy,
            kernels_ms=[[k, t, c] for k, (t, c) in top])
        print(f"[22 slice 5 profile, {tech}] {name}: const, warm "
              f"{warm:.3f} s ({muts / warm:.4e} mutations/s); device busy "
              f"{busy:.4f} of a {prof_wall:.3f} s render; " + "; ".join(
                  f"{k.split('(')[0][:60]} {t:.3f} ms x{c}"
                  for k, (t, c) in top[:4]))
        need(busy > 0, "the profiler saw no device activity")
    return out


# ---------------------------------------------------------------- slice 6
# phase 23(a): the pssmlt mode's configurations at 4,096 x 2 (type, splat
# mode, uniforms given), the first two on given uniforms, the others on
# Philox
PSS_CASES = (("mira", "three", True), ("green", "sampled", True),
             ("mira", "sampled", False), ("green", "three", False))
# a fresh process running the CLI's main that prints the launch counters
# last (phase 23(d))
CLI_RUN = ("import json, sys; from drmlt_mitsuba_tpu_torch.utils import cli; "
           "from drmlt_mitsuba_tpu_torch.ops import build; "
           "rc = cli.main(sys.argv[1:]); print(json.dumps(build.LAUNCHES)); "
           "sys.exit(rc)")


def kelemen_expected_ratio(trace, n_dims, K, p_large, b, chain_u0, gen, dev,
                           batches=32):
    """Per channel, E[Kelemen image] / E[image] of PSSMLT over the pooled
    MMLT trace, whose chains keep their depth dim u[0] (depth 1 +
    floor(u0 K)).  Kelemen's weights take a large step as uniform over the
    whole primary sample space at density p_large, but a depth k held by a
    share s_k of the chains sees large steps at K s_k p_large, so the
    expected splat at z of depth k is f(z) (I(z)/b + K s_k p_large) /
    (I(z)/b + p_large) (tests/test_torch_pssmlt_bias.py); averaged here
    over batches x CHAINS uniform samples, with the chains' s_k and b."""
    ck = torch.clamp(torch.floor(chain_u0 * K), max=K - 1).long()
    s = torch.bincount(ck, minlength=K).double() / ck.numel()
    num = torch.zeros(3, dtype=torch.float64, device=dev)
    den = torch.zeros_like(num)
    for _ in range(batches):
        u = torch.rand((CHAINS, n_dims), generator=gen, device=dev)
        sp = trace(u)
        ok = torch.isfinite(sp.lum) & (sp.lum >= 0)
        lum = torch.where(ok, sp.lum, 0.0).double()
        f = torch.where(ok[:, None], sp.value.double().sum(1), 0.0)
        k = torch.clamp(torch.floor(u[:, 0] * K), max=K - 1).long()
        r = (lum / b + K * s[k] * p_large) / (lum / b + p_large)
        num += (f * r[:, None]).sum(0)
        den += f.sum(0)
    return num / den


def check_pss(tag, r):
    check_chain(tag, r)
    need(r["stats_kernel"][1] == 0.0 and r["stats_kernel"][3] == 0.0
         and r["stats_twin"][1] == 0.0 and r["stats_twin"][3] == 0.0,
         f"{tag}: stage-2 mass in the pssmlt mode: {r['stats_kernel']}")


def mcmc_vs_mc(tag, img, img0, ref, refb, gate):
    """Phase 9's gates: the channel means within `gate`, and the image's
    shape within SHAPE_GATE x what the noise of two MC (ref, refb) and two
    MCMC (img0, img) renders predicts.  Returns the figures."""
    mean_rel, block_l1 = mc_compare(img, ref)
    shape = shape_l1(img, ref)
    noise_mc, noise_mcmc = shape_l1(refb, ref), shape_l1(img0, img)
    expected = ((noise_mc ** 2 + noise_mcmc ** 2) / 2) ** 0.5
    need(bool(torch.isfinite(img).all()), f"{tag}: image not finite")
    need(mean_rel < gate, f"{tag}: mean differs from MC by {mean_rel} "
         f"(gate {gate})")
    need(shape < SHAPE_GATE * expected, f"{tag}: shape differs from MC by "
         f"{shape}, the noise predicts {expected}")
    return dict(mean_rel_err=mean_rel, block_rel_l1=block_l1, gate=gate,
                shape_l1=shape, shape_noise_mc=noise_mc,
                shape_noise_mcmc=noise_mcmc, shape_expected=expected)


def slice6(name, dev, gen, report, mc_refs, s5):
    """Phase 23: PSSMLT, the chain kernel's pssmlt mode (23a, 23b) and the
    host integrator (23c, 23d).  Returns the kernels-line figures of the
    pssmlt mode."""
    out = {}
    fc = filmlib.make_film_config(SIZE, SIZE, "box")
    pcfg = PathConfig(max_depth=DEPTH, rr_depth=100)
    cornell = cornell_box(SIZE, SIZE)
    const = cornell_scope(SIZE, SIZE, "const")
    # ---- 23a. the pssmlt mode vs its twin -----------------------------------
    report["pssmlt_chain_vs_twin"] = {}
    err = {"path": 0.0, "mmlt": 0.0}
    starts = {}
    for scope, sc in (("box", cornell), ("const", const)):
        groups = [None] + (list(range(1, MMLT_DEPTH + 1)) if scope == "box"
                           else [MMLT_DEPTH])
        for k in groups:
            if k is None:
                tab = MT.make_tables(sc, pcfg, dev)
                st0 = path_states(sc, pcfg, gen, dev, CHAINS)
            else:
                tab, st0, _ = slice2_starts(sc, k, gen, dev)
            tech = "path" if k is None else "mmlt"
            starts[(scope, k)] = (tab, st0)
            s4 = st0[:, :C4].contiguous()
            D = s4.shape[0] - 6
            rows = []
            for drtype, mode, given in PSS_CASES:
                ccfg = DRMLTConfig(type=drtype, splat_mode=mode, n_chains=C4)
                uni = (torch.rand((2 * MD.n_rand(ccfg, D), C4), generator=gen,
                                  device=dev) if given else None)
                r = compare_chain(tab, ccfg, 2, s4, SIZE, 61, 1, uni,
                                  pssmlt=True)
                tag = (f"{scope}/{tech}{k or ''}/{drtype}/{mode}/"
                       f"{'uniforms' if given else 'philox'}")
                report["pssmlt_chain_vs_twin"][tag] = r
                check_pss(tag, r)
                err[tech] = max(err[tech], r["state_max_abs"])
                rows.append(f"{r['lane_agreement']:.5f}")
            print(f"[23a pssmlt chain kernel vs twin] {name}: {scope}, "
                  f"{tech}{'' if k is None else f' k {k}'} (D {D}), {C4} "
                  f"chains x 2 mutations, lanes agreeing (mira/three/"
                  f"uniforms, green/sampled/uniforms, mira/sampled/philox, "
                  f"green/three/philox): " + ", ".join(rows))
    # the main path's shape, Philox: 65,536 chains x 64 mutations; on the
    # box the kernel is timed on the same configuration and state, the
    # twin's wall is plain_ms and its count of ray-triangle tests (the y
    # traces only) the bound's operations
    for scope, k, drtype, mode in (("box", MMLT_DEPTH, "green", "sampled"),
                                   ("box", None, "mira", "three"),
                                   ("const", MMLT_DEPTH, "green", "sampled"),
                                   ("const", None, "mira", "three")):
        tab, st0 = starts[(scope, k)]
        tech = "path" if k is None else "mmlt"
        ccfg = DRMLTConfig(type=drtype, splat_mode=mode, n_chains=CHAINS)
        work = {}
        r = compare_chain(tab, ccfg, 64, st0, SIZE, 5, 0, None, work=work,
                          pssmlt=True)
        tag = f"{scope}/{tech}{k or ''}/{drtype}/{mode}/philox/65536x64"
        report["pssmlt_chain_vs_twin"][tag] = r
        check_pss(tag, r)
        err[tech] = max(err[tech], r["state_max_abs"])
        line = (f"[23a pssmlt chain kernel vs twin, {CHAINS} chains x 64 "
                f"mutations] {name}: {tag}: lanes agreeing "
                f"{r['lane_agreement']:.5f}, film rel L1 "
                f"{r['film_rel_l1']:.2e}, stats {r['stats_kernel']} vs "
                f"{r['stats_twin']}")
        if scope == "box":
            stc = st0.clone()
            film = torch.zeros((SIZE, SIZE, 3), device=dev)
            stats = torch.zeros((6, CHAINS), device=dev)
            ms = event_ms(lambda: MD.drmlt_chain_step(
                tab, ccfg, 64, stc, film, stats, 5, 0, pssmlt=True), runs=5)
            bnd = bound(2 * nbytes(stc) + nbytes(film) + 2 * nbytes(stats),
                        work["tri_tests"])
            out[tech] = dict(ms=ms, plain_ms=r["twin_s"] * 1e3, bnd=bnd,
                             tri_tests=work["tri_tests"])
            line += (f"; kernel {ms:.3f} ms vs twin {r['twin_s'] * 1e3:.0f} "
                     f"ms ({CHAINS * 64 / (ms / 1e3):.4e} mutations/s); "
                     f"bound {bnd[0]:.4f} ms by {bnd[1]}, "
                     f"{work['tri_tests']} ray-triangle tests")
        print(line)
    # like for like against the DRMLT mode (phase 10's configuration:
    # orbital, sampled, k = 6), the two modes in turns
    tab, st0 = starts[("box", MMLT_DEPTH)]
    cfg_o = DRMLTConfig(type="orbital", n_chains=CHAINS, splat_mode="sampled")
    turns = {False: [], True: []}
    for pss in (False, True, True, False):
        stc = st0.clone()
        film = torch.zeros((SIZE, SIZE, 3), device=dev)
        stats = torch.zeros((6, CHAINS), device=dev)
        turns[pss].append(event_ms(lambda: MD.drmlt_chain_step(
            tab, cfg_o, 64, stc, film, stats, 5, 0, pssmlt=pss), runs=3))
    report["pssmlt_timing_ms"] = dict(
        {f"{t}/{'mira/three' if t == 'path' else 'green/sampled'}": v
         for t, v in out.items()},
        mmlt_k6_orbital_sampled=dict(drmlt=turns[False], pssmlt=turns[True]))
    print(f"[23a timing] {name}: chain kernel at k {MMLT_DEPTH}, orbital, "
          f"sampled, {CHAINS} chains x 64 mutations, in turns: DRMLT mode "
          f"{[round(x, 3) for x in turns[False]]} ms, pssmlt mode "
          f"{[round(x, 3) for x in turns[True]]} ms")

    # ---- 23b. the chain kernel's pssmlt mode on the main path ---------------
    launches6 = dict.fromkeys(build.LAUNCHES, 0)

    def count():
        for key, c in build.LAUNCHES.items():
            launches6[key] += c

    n_steps = SIZE * SIZE * 256 // CHAINS
    cfg = DRMLTConfig(type="orbital", n_chains=CHAINS, n_bootstrap=100_000,
                      p_large=0.3, splat_mode="sampled")
    bcfg = BDPTConfig(max_depth=MMLT_DEPTH, light_image=True)
    report["slice6_grouped"] = {}
    for sname, sc in (("cornell", cornell),
                      ("veach", veach_door(SIZE, SIZE))):
        gen.manual_seed(71)
        (img0, _), first = sync_time(lambda: render_drmlt_mmlt_grouped(
            sc, bcfg, cfg, fc, gen, n_steps, pssmlt=True))
        gen.manual_seed(72)
        build.reset_launches()
        (img, aux), wall = sync_time(lambda: render_drmlt_mmlt_grouped(
            sc, bcfg, cfg, fc, gen, n_steps, pssmlt=True))
        count()
        muts = sum(CHAINS * s for s in aux["steps_eff"].values())
        need(all(float(st["a2"]) == 0.0 and float(st["accept2"]) == 0.0
                 for st in aux["stats"].values()),
             f"{sname}: the grouped pssmlt render ran a stage 2")
        row = mcmc_vs_mc(f"grouped pssmlt {sname}", img, img0,
                         *mc_refs[sname], MC_GATE[sname])
        gen.manual_seed(73)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            (_, auxp), prof_wall = sync_time(
                lambda: render_drmlt_mmlt_grouped(sc, bcfg, cfg, fc, gen,
                                                  n_steps, pssmlt=True))
        evs = prof.events()
        busy, per = device_profile(evs, prof_wall)
        chain_ev = sorted((e.time_range.start, e.time_range.elapsed_us())
                          for e in evs if e.device_type == DeviceType.CUDA
                          and "drmlt_chain_kernel" in e.name)
        per_group, i = {}, 0
        for k, n_l in group_launches(auxp).items():
            per_group[k] = [sum(us for _, us in chain_ev[i:i + n_l]) / 1e3,
                            n_l]
            i += n_l
        drmlt_group = report["slice2"][sname]["chain_ms_per_group"]
        row.update(b=float(aux["b"]), wall_s=wall, first_wall_s=first,
                   mutations=muts, mutations_per_s=muts / wall,
                   busy_share=busy, profile_wall_s=prof_wall,
                   chain_ms_per_group=per_group,
                   drmlt_chain_ms_per_group=drmlt_group,
                   steps_per_group=aux["steps_per_group"],
                   accept1={k: float(st["accept1"])
                            for k, st in aux["stats"].items()})
        report["slice6_grouped"][sname] = row
        print(f"[23b grouped pssmlt render] {name}: {sname}: b "
              f"{float(aux['b']):.6f}, warm {wall:.3f} s for {muts} mutations "
              f"({muts / wall:.4e} mutations/s, bootstrap included; first "
              f"call {first:.3f} s); vs MC mean rel {row['mean_rel_err']:.4f} "
              f"(gate {MC_GATE[sname]}), shape L1 {row['shape_l1']:.4f} "
              f"against {row['shape_expected']:.4f}; device busy {busy:.4f}; "
              f"chain kernel ms per group (pssmlt [ms, launches]) "
              + str({k: [round(v[0], 3), v[1]] for k, v in per_group.items()})
              + " vs DRMLT mode (phase 9) "
              + str({k: round(v, 3) for k, v in drmlt_group.items()}))
        need(busy > 0, "the profiler saw no device activity")
    # the MC reference of 23c
    gen.manual_seed(74)
    refb = filmlib.develop(fc, render_pt(cornell, pcfg, gen, SIZE * SIZE * 64,
                                         fc, mode="accum"), mode="accum")

    # ---- 23c. the host PSSMLT integrator over the path kernel ---------------
    report["slice6_host"] = {}
    n_dims = pcfg.n_dims + pcfg.n_dims % 2
    trace = make_path_trace(cornell, pcfg, dev)
    for kelemen in (True, False):
        mcfg = PSSMLTConfig(n_chains=CHAINS, kelemen_style_weights=kelemen)
        gen.manual_seed(81)
        img0, _ = render_pssmlt(trace, mcfg, fc, gen, n_dims, n_steps)
        gen.manual_seed(82)
        build.reset_launches()
        (img, aux), wall = sync_time(lambda: render_pssmlt(
            trace, mcfg, fc, gen, n_dims, n_steps))
        count()
        style = "kelemen" if kelemen else "veach"
        row = mcmc_vs_mc(f"render_pssmlt {style}", img, img0,
                         mc_refs["path"], refb, MC_GATE["path"])
        acc = float(aux["stats"]["accept"].mean())
        need(0.1 < acc < 0.9, f"render_pssmlt {style}: acceptance {acc}")
        muts = CHAINS * n_steps
        row.update(b=float(aux["b"]), wall_s=wall, mutations=muts,
                   mutations_per_s=muts / wall, accept=acc)
        if not kelemen:
            gen.manual_seed(83)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _, prof_wall = sync_time(lambda: render_pssmlt(
                    trace, mcfg, fc, gen, n_dims, n_steps))
            busy, per = device_profile(prof.events(), prof_wall)
            top = sorted(per.items(), key=lambda kv: -kv[1][0])
            # the path kernel's device time per launch in the host loop
            pk = [v for k, v in per.items() if "path_trace_kernel" in k]
            pk_ms = sum(t for t, _ in pk) / max(sum(c for _, c in pk), 1)
            row.update(busy_share=busy, profile_wall_s=prof_wall,
                       kernels_ms=[[k, t, c] for k, (t, c) in top],
                       path_kernel_ms_per_launch=pk_ms)
            need(busy > 0, "the profiler saw no device activity")
        report["slice6_host"][style] = row
        print(f"[23c render_pssmlt, {style} weights] {name}: cornell, depth "
              f"{DEPTH}, {CHAINS} chains x {n_steps} steps: warm {wall:.3f} "
              f"s ({muts / wall:.4e} mutations/s, bootstrap included); "
              f"acceptance {acc:.4f}; vs MC mean rel "
              f"{row['mean_rel_err']:.4f} (gate {MC_GATE['path']}), shape L1 "
              f"{row['shape_l1']:.4f} against {row['shape_expected']:.4f}"
              + ("" if kelemen else
                 f"; device busy {row['busy_share']:.4f} of "
                 f"{row['profile_wall_s']:.3f} s, path_trace_kernel "
                 f"{row['path_kernel_ms_per_launch']:.4f} ms a launch; "
                 + "; ".join(
                     f"{k.split('(')[0][:50]} {t:.3f} ms x{c}"
                     for k, (t, c) in top[:4])))

    # ---- 23d. the CLI: integrator=pssmlt on tests/data/cornell.xml ----------
    # fresh processes: path with the reference's defaults (Kelemen's
    # weights) and the pooled MMLT trace with Veach's, held to phase 22's
    # gates; the pooled trace with Kelemen's weights, the reference CLI's
    # default, is biased by its pinned depth dim, in the reference as in
    # the port (tests/test_torch_pssmlt_bias.py), so it is held to the
    # estimator's expectation instead (below)
    report["slice6_cli"] = {}
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    cli_d, cli_img = {}, {}
    for tech, weights in (("path", "kelemen"), ("mmlt", "veach"),
                          ("mmlt", "kelemen")):
        tag = f"{tech}/{weights}"
        exr = os.path.join(ROOT, "chiprun_out",
                           f"pssmlt_{tech}_{weights}.exr")
        cli_d[tag] = ["integrator=pssmlt", f"technique={tech}",
                      f"spp={XML_SPP}", "kelemenStyleWeights="
                      f"{str(weights == 'kelemen').lower()}"]
        cmd = [sys.executable, "-c", CLI_RUN, CORNELL_XML]
        for kv in cli_d[tag]:
            cmd += ["-D", kv]
        cmd += ["--chains", str(CHAINS), "-s", "5", "-o", exr]
        res, wall = sync_time(lambda: subprocess.run(
            cmd, capture_output=True, text=True, timeout=600, cwd=ROOT))
        need(res.returncode == 0, f"CLI pssmlt {tag}: exit "
             f"{res.returncode}: {res.stderr[-2000:]}")
        lines = res.stdout.strip().splitlines()
        for key, c in json.loads(lines[-1]).items():
            launches6[key] += c
        rate_line = next(ln for ln in lines if "mutations/s" in ln)
        rate = re.search(r"\(([0-9.e+]+) mutations/s", rate_line)
        img = torch.from_numpy(np.ascontiguousarray(
            read_exr(exr)[..., :3])).to(dev)
        ref = s5[f"xml_{tech}"]["ref"]
        gate = s5[f"xml_{tech}"]["gate"]
        mean_rel, block_l1 = mc_compare(img, ref)
        ratio = (img.double().mean((0, 1)) / ref.double().mean((0, 1)))
        report["slice6_cli"][tag] = dict(
            process_wall_s=wall, mutations_per_s=float(rate.group(1)),
            mean_rel_err=mean_rel, block_rel_l1=block_l1, gate=gate,
            channel_ratio_to_mc=ratio.tolist(), stdout=lines[:-1])
        cli_img[tag] = img
        print(f"[23d CLI integrator=pssmlt, {tech}, {weights} weights] "
              f"{name}: cornell.xml, spp {XML_SPP}, {CHAINS} chains, a fresh "
              f"process of {wall:.2f} s: {rate_line}; vs MC mean rel "
              f"{mean_rel:.4f} (phase 22's gate {gate:.4f}), channel means / "
              f"MC {[round(x, 4) for x in ratio.tolist()]}, 16x16-block rel "
              f"L1 {block_l1:.4f}")
        need(bool(torch.isfinite(img).all()), f"CLI pssmlt {tag}: not finite")
        if tag != "mmlt/kelemen":
            need(mean_rel < gate, f"CLI pssmlt {tag}: differs from MC by "
                 f"{mean_rel}")
    # the same two MMLT renders in this process (the same -D list, seed and
    # so chains), for the chains' depth shares and b; the expectation of the
    # Kelemen / Veach ratio from a plain-MC pass of the same pooled trace
    inproc = {}
    for weights in ("kelemen", "veach"):
        d = cli_d[f"mmlt/{weights}"]
        sc, xs = cli.load_scene(CORNELL_XML, dict(kv.split("=", 1)
                                                  for kv in d))
        args = argparse.Namespace(D=d, chains=CHAINS, spp=None, seed=5)
        build.reset_launches()
        inproc[weights] = cli.render(args, sc, xs, dev)
        count()
    icfg = cli.integrator_config(args, xs)
    K, p_large = int(icfg["maxDepth"]), float(icfg.get("pLarge", 0.3))
    aux_k = inproc["kelemen"][1]
    _, _, n_dims = mmlt_masks(BDPTConfig(max_depth=K))
    gen.manual_seed(77)
    expected = kelemen_expected_ratio(
        make_mmlt_trace(sc, BDPTConfig(max_depth=K, light_image=True,
                                       thinlens=_thin(sc)), dev),
        n_dims, K, p_large, aux_k["b"], aux_k["state"].u[:, 0], gen, dev)
    same = (inproc["kelemen"][0].double().mean((0, 1))
            / inproc["veach"][0].double().mean((0, 1)))
    fresh = report["slice6_cli"]["mmlt/kelemen"]
    fresh_ratio = torch.tensor(fresh["channel_ratio_to_mc"],
                               dtype=torch.float64, device=dev)
    img_k = inproc["kelemen"][0]
    fresh_same = float((cli_img["mmlt/kelemen"] - img_k).abs().sum()
                       / img_k.abs().sum())
    depth_share = (torch.bincount(torch.clamp(torch.floor(
        aux_k["state"].u[:, 0] * K), max=K - 1).long(), minlength=K)
        / CHAINS).tolist()
    fresh.update(expected_ratio=expected.tolist(),
                 inprocess_kelemen_over_veach=same.tolist(),
                 fresh_vs_inprocess_rel_l1=fresh_same,
                 depth_share=depth_share, gate=KELEMEN_TOL)
    print(f"[23d Kelemen weights over the pooled MMLT trace] {name}: "
          f"cornell.xml, chains' depth shares "
          f"{[round(x, 4) for x in depth_share]} (K {K}), b "
          f"{float(aux_k['b']):.6f}: the estimator's expected channel "
          f"ratio {[round(x, 4) for x in expected.tolist()]}; in this "
          f"process Kelemen / Veach on the same chains "
          f"{[round(x, 4) for x in same.tolist()]} (gate "
          f"{KELEMEN_TOL / 2}), the fresh process's channel means / MC "
          f"{[round(x, 4) for x in fresh_ratio.tolist()]} (gate "
          f"{KELEMEN_TOL}); fresh vs in-process image rel L1 "
          f"{fresh_same:.2e}")
    need(float((same - expected).abs().max()) < KELEMEN_TOL / 2,
         f"Kelemen / Veach {same.tolist()} is not the estimator's "
         f"{expected.tolist()}")
    need(float((fresh_ratio - expected).abs().max()) < KELEMEN_TOL,
         f"the CLI's Kelemen MMLT render / MC {fresh_ratio.tolist()} is not "
         f"the estimator's {expected.tolist()}")
    # -D averageLuminance reaches the render: with Veach's weights the image
    # scales by it over b, on the same draws
    sc, xs = cli.load_scene(CORNELL_XML, {"integrator": "pssmlt",
                                          "spp": str(XML_SPP)})
    args = argparse.Namespace(D=["kelemenStyleWeights=false"], chains=CHAINS,
                              spp=None, seed=9)
    build.reset_launches()
    img, aux = cli.render(args, sc, xs, dev)
    count()
    b = float(aux["b"])
    args.D.append(f"averageLuminance={2.0 * b!r}")
    build.reset_launches()
    img2, aux2 = cli.render(args, sc, xs, dev)
    count()
    ratio = float((img2.double().sum() / img.double().sum()))
    report["slice6_average_luminance"] = dict(b=b, b_given=float(aux2["b"]),
                                              image_ratio=ratio)
    print(f"[23d -D averageLuminance] {name}: cornell.xml, pssmlt path, "
          f"Veach weights: b {b:.6f}, with averageLuminance={2.0 * b!r} the "
          f"render's b {float(aux2['b']):.6f} and image sum ratio "
          f"{ratio:.6f} (want 2)")
    need(abs(ratio - 2.0) < 1e-4, "averageLuminance did not reach the render")

    report["slice6_launches"] = launches6
    print(f"[23 slice 6 launches, the main path's renders] {name}: "
          f"{launches6}")
    for key in ("drmlt_mmlt_pssmlt", "mmlt_trace",
                "path_trace", "splat_add", "path_trace[full]",
                "mmlt_trace[full]"):
        need(launches6[key] > 0, f"{key} did not launch on slice 6's path")
    out["err"] = err
    out["launches"] = launches6
    return out


# ---------------------------------------------------------------- slice 7
# phase 24: the generic DRMLT step (integrators/drmlt.py) over the trace
# kernels, the acceptance map, the pooled MMLT route, the five other filters
GEN_CHAINS = 16384      # 24a: chains of one step, kernel against twin
FILTERS = ("box", "tent", "gaussian", "mitchell", "catmullrom", "lanczos")
SPLATS = 1 << 20        # 24d: splats per filter, kernel against twin
SPLAT_RTOL = 1e-5       # 24d: per pixel, of the sum of |tap| landing there


def slice7(name, dev, gen, report, mc_refs, s5):
    """Phase 24: the generic DRMLT step and what it unlocks.  Returns the
    launches of the main-path renders of (b)-(d)."""
    fc = filmlib.make_film_config(SIZE, SIZE, "box")
    pcfg = PathConfig(max_depth=DEPTH, rr_depth=100)
    D = pcfg.n_dims + pcfg.n_dims % 2
    cornell = cornell_box(SIZE, SIZE)
    trace = make_path_trace(cornell, pcfg, dev)
    launches7 = dict.fromkeys(build.LAUNCHES, 0)

    def count():
        for key, c in build.LAUNCHES.items():
            launches7[key] += c

    # ---- 24a. one generic step on the card against its twin on the CPU ----
    report["generic_step_vs_twin"] = {}
    twin = make_path_trace(cornell, pcfg, "cpu")
    cand = torch.rand((8 * GEN_CHAINS, D), generator=gen, device=dev)
    u0 = cand[torch.nonzero(trace(cand).lum > 0)[:GEN_CHAINS, 0]]
    need(u0.shape[0] == GEN_CHAINS, "too few valid starting states")
    st_k = state_from_splats(u0, trace(u0))
    st_t = ChainState(*(t.cpu() for t in (st_k.u, st_k.lum, st_k.pos,
                                          st_k.value)))
    frozen = torch.zeros(D, dtype=torch.bool)
    for kind, mixture in (("green", False), ("mira", False),
                          ("orbital", False), ("green", True)):
        cfg = DRMLTConfig(type=kind, n_chains=GEN_CHAINS,
                          acceptance_map=not mixture)
        draws = draw_drmlt_uniforms(gen, GEN_CHAINS, D, kind)
        runs = []
        for tr, st, dv, dr in (
                (trace, st_k, dev, draws),
                (twin, st_t, "cpu", DRMLTUniforms(*(
                    getattr(draws, f.name).cpu()
                    for f in dataclasses.fields(DRMLTUniforms))))):
            carry = (st, filmlib.new_film(fc, dv), filmlib.new_film(fc, dv))
            step = (drmlt_mixture_step_from_uniforms if mixture
                    else drmlt_step_from_uniforms)
            (st2, film, acc), stats = sync_time(lambda: step(
                tr, cfg, fc, frozen.to(dv), carry, dr))[0]
            runs.append((st2, film, acc, stats))
        (sk, fk, ak, tk), (sr, fr, ar, trs) = runs
        ok = (sk.u.cpu() - sr.u).abs().max(1).values <= 2e-5
        share = float(ok.double().mean())
        film_err = float((fk.cpu() - fr).abs().max() / fr.abs().max())
        acc_err = float((ak.cpu() - ar).abs().sum())
        tag = f"{kind}{' mixture' if mixture else ''}"
        report["generic_step_vs_twin"][tag] = dict(
            chains_equal=share, film_err_over_max=film_err,
            accmap_abs_diff=acc_err, a1=[float(tk["a1"]), float(trs["a1"])])
        print(f"[24a generic step vs twin] {name}: {tag}, {GEN_CHAINS} "
              f"chains, depth {DEPTH}: chains with equal state {share:.5f}, "
              f"film max |d| / max {film_err:.2e}, accmap |d| sum "
              f"{acc_err:.1f}, a1 {float(tk['a1']):.5f} vs "
              f"{float(trs['a1']):.5f}")
        need(share >= 0.99, f"generic step {tag}: {share} of chains agree")
        need(film_err <= 5e-3, f"generic step {tag}: film differs {film_err}")

    # ---- 24b. render_drmlt on the box against MC ---------------------------
    n_steps = SIZE * SIZE * 256 // CHAINS
    gen.manual_seed(90)
    refb = filmlib.develop(fc, render_pt(cornell, pcfg, gen, SIZE * SIZE * 64,
                                         fc, mode="accum"), mode="accum")
    report["render_drmlt"] = {}
    for tag, kw in (("green/accmap", dict(type="green",
                                          acceptance_map=True)),
                    ("mira", dict(type="mira")),
                    ("orbital", dict(type="orbital")),
                    ("green/mixture", dict(type="green", use_mixture=True))):
        cfg = DRMLTConfig(n_chains=CHAINS, n_bootstrap=100_000, **kw)
        gen.manual_seed(91)
        img0, _ = render_drmlt(trace, cfg, fc, gen, D, n_steps)
        gen.manual_seed(92)
        build.reset_launches()
        (img, aux), wall = sync_time(lambda: render_drmlt(
            trace, cfg, fc, gen, D, n_steps))
        count()
        row = mcmc_vs_mc(f"render_drmlt {tag}", img, img0, mc_refs["path"],
                         refb, MC_GATE["path"])
        muts = CHAINS * n_steps
        row.update(b=float(aux["b"]), wall_s=wall, mutations=muts,
                   mutations_per_s=muts / wall,
                   a1=float(aux["stats"]["a1"].mean()))
        if not cfg.use_mixture:
            row.update(accept2=float(aux["stats"]["accept2"].mean()))
        if cfg.acceptance_map:
            am = aux["accmap"].double()
            r_sum, g_sum = float(am[..., 0].sum()), float(am[..., 1].sum())
            n1 = int(aux["stats"]["n_accept1"].sum())
            n2 = int(aux["stats"]["n_accept2"].sum())
            row.update(accmap_r=r_sum, accmap_g=g_sum, n_accept1=n1,
                       n_accept2=n2)
            need(r_sum == n1 and g_sum == n2 and n2 > 0,
                 f"accmap R / G sums {r_sum} / {g_sum} are not the accept "
                 f"counts {n1} / {n2}")
        report["render_drmlt"][tag] = row
        print(f"[24b render_drmlt, {tag}] {name}: cornell, depth {DEPTH}, "
              f"{CHAINS} chains x {n_steps} steps: warm {wall:.3f} s "
              f"({muts / wall:.4e} mutations/s, bootstrap included); b "
              f"{row['b']:.6f}; vs MC mean rel {row['mean_rel_err']:.4f} "
              f"(gate {MC_GATE['path']}), shape L1 {row['shape_l1']:.4f} "
              f"against {row['shape_expected']:.4f}"
              + (f"; accmap R {row['accmap_r']:.0f} = accept1 of small steps "
                 f"{row['n_accept1']}, G {row['accmap_g']:.0f} = accept2 "
                 f"{row['n_accept2']}" if cfg.acceptance_map else ""))
    # the generic step beside the chain kernel on one configuration
    cfg_g = DRMLTConfig(type="green", n_chains=CHAINS, n_bootstrap=100_000)
    prof_rows = {}
    for route, fn in (
            ("render_drmlt", lambda: render_drmlt(trace, cfg_g, fc, gen, D,
                                                  n_steps)),
            ("render_drmlt_path", lambda: render_drmlt_path(
                cornell, pcfg, cfg_g, fc, gen, n_steps))):
        gen.manual_seed(93)
        _, wall = sync_time(fn)
        gen.manual_seed(94)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, prof_wall = sync_time(fn)
        busy, per = device_profile(prof.events(), prof_wall)
        top = sorted(per.items(), key=lambda kv: -kv[1][0])
        prof_rows[route] = dict(
            wall_s=wall, mutations_per_s=CHAINS * n_steps / wall,
            busy_share=busy, profile_wall_s=prof_wall,
            ms_per_step=wall / n_steps * 1e3,
            kernels_ms=[[k, t, c] for k, (t, c) in top[:8]])
        need(busy > 0, "the profiler saw no device activity")
    report["generic_vs_chain_kernel"] = prof_rows
    g, c = prof_rows["render_drmlt"], prof_rows["render_drmlt_path"]
    print(f"[24b generic step vs chain kernel] {name}: cornell, green, "
          f"three-state splat, {CHAINS} chains x {n_steps} steps: "
          f"render_drmlt {g['wall_s']:.3f} s ({g['mutations_per_s']:.4e} "
          f"mutations/s, {g['ms_per_step']:.3f} ms a step), device busy "
          f"{g['busy_share']:.4f}; render_drmlt_path {c['wall_s']:.3f} s "
          f"({c['mutations_per_s']:.4e} mutations/s), device busy "
          f"{c['busy_share']:.4f}; generic top kernels " + "; ".join(
              f"{k.split('(')[0][:40]} {t:.3f} ms x{n}"
              for k, t, n in g["kernels_ms"][:4]))

    # ---- 24c. the CLI's pooled and grouped MMLT routes against MC ----------
    report["mmlt_generic_cli"] = {}
    ref_c, _ = mc_refs["cornell"]
    for tag, d in (("pooled/fixEmitterPath",
                    ["grouped=false", "fixEmitterPath=true"]),
                   ("grouped/acceptanceMap", ["acceptanceMap=true"])):
        defs = ["technique=mmlt", f"maxDepth={MMLT_DEPTH}", "variant=orbital",
                "luminanceSamples=100000"] + d
        sc, xs = cli.load_scene("cornell", dict(kv.split("=", 1)
                                                for kv in defs))
        args = argparse.Namespace(D=defs, chains=CHAINS, spp=256, seed=95)
        build.reset_launches()
        (img, aux), wall = sync_time(lambda: cli.render(args, sc, xs, dev))
        count()
        mean_rel, block_l1 = mc_compare(img, ref_c)
        row = dict(wall_s=wall, mutations=aux["mutations"],
                   mutations_per_s=aux["mutations"] / wall,
                   b=float(aux["b"]), mean_rel_err=mean_rel,
                   block_rel_l1=block_l1, gate=MC_GATE["cornell"])
        if aux["accmap"] is not None:
            am = aux["accmap"].double()
            n1 = sum(int(st["n_accept1"].sum())
                     for st in aux["stats"].values())
            row.update(accmap_r=float(am[..., 0].sum()), n_accept1=n1)
            need(row["accmap_r"] == n1 and n1 > 0, f"{tag}: accmap R sum "
                 f"{row['accmap_r']} is not the accept count {n1}")
        report["mmlt_generic_cli"][tag] = row
        print(f"[24c CLI drmlt mmlt {tag}] {name}: cornell, max_depth "
              f"{MMLT_DEPTH}, {CHAINS} chains, spp 256: {wall:.3f} s "
              f"({row['mutations_per_s']:.4e} mutations/s, bootstrap "
              f"included); b {row['b']:.6f}; vs MC mean rel {mean_rel:.4f} "
              f"(gate {MC_GATE['cornell']}), 16x16-block rel L1 "
              f"{block_l1:.4f}")
        need(bool(torch.isfinite(img).all()), f"{tag}: image not finite")
        need(mean_rel < MC_GATE["cornell"], f"CLI mmlt {tag}: differs from "
             f"MC by {mean_rel}")

    # ---- 24d. the splat kernel at every footprint; the gaussian scene ------
    report["splat_filters"] = {}
    for fname in FILTERS:
        fcf = filmlib.make_film_config(SIZE, SIZE, fname)
        r = fcf.filter.radius
        # positions a radius inside the film: no footprint total near 0
        pos = r + torch.rand((SPLATS, 2), generator=gen, device=dev) * (
            SIZE - 2 * r)
        val = torch.rand((SPLATS, 3), generator=gen, device=dev)
        w = torch.rand((SPLATS,), generator=gen, device=dev)
        py, px, vals = filmlib.taps(fcf, pos, val, w, mode="splat")
        film_k = SP.splat_add_(filmlib.new_film(fcf, dev), py, px, vals)
        film_t = SP.splat_add_reference_(filmlib.new_film(fcf, dev), py, px,
                                         vals)
        mag = SP.splat_add_reference_(filmlib.new_film(fcf, dev), py, px,
                                      vals.abs())
        err = float(((film_k - film_t).abs() / mag.clamp(min=1e-30)).max())
        ms = event_ms(lambda: SP.splat_add_(film_k, py, px, vals), runs=5)
        report["splat_filters"][fname] = dict(
            footprint=fcf.filter.footprint, taps=int(py.shape[0]),
            max_rel_err=err, ms=ms)
        print(f"[24d splat kernel, {fname}] {name}: {SPLATS} splats x "
              f"{fcf.filter.footprint}^2 taps: per-pixel |kernel - twin| / "
              f"sum |tap| {err:.2e} (gate {SPLAT_RTOL}); {ms:.4f} ms a launch")
        need(err <= SPLAT_RTOL, f"splat kernel, {fname}: per-pixel error "
             f"{err}")
    xml = os.path.join(ROOT, "chiprun_out", "cornell_gaussian.xml")
    os.makedirs(os.path.dirname(xml), exist_ok=True)
    with open(CORNELL_XML) as f:
        text = f.read()
    need('<rfilter type="box"/>' in text, "cornell.xml has no box rfilter")
    with open(xml, "w") as f:
        f.write(text.replace('<rfilter type="box"/>', ""))
    report["gaussian_xml"] = {}
    for tag, tech, d in (
            ("drmlt path", "path", ["integrator=drmlt"]),
            ("drmlt grouped mmlt", "mmlt",
             ["integrator=drmlt", "technique=mmlt"]),
            ("integrator=path", "path", ["integrator=path"]),
            ("drmlt path twoStage", "path",
             ["integrator=drmlt", "twoStage=true"]),
            ("drmlt path separateDirect", "path",
             ["integrator=drmlt", "separateDirect=true"])):
        defs = d + ["type=orbital", f"spp={XML_SPP}"]
        sc, xs = cli.load_scene(xml, dict(kv.split("=", 1) for kv in defs))
        need(xs.filter_name == "gaussian", f"{xml}: filter {xs.filter_name}")
        args = argparse.Namespace(D=defs, chains=CHAINS, spp=None, seed=96)
        build.reset_launches()
        (img, aux), wall = sync_time(lambda: cli.render(args, sc, xs, dev))
        count()
        ref, gate = s5[f"xml_{tech}"]["ref"], s5[f"xml_{tech}"]["gate"]
        mean_rel, block_l1 = mc_compare(img, ref)
        ratio = (img.double().mean((0, 1)) / ref.double().mean((0, 1)))
        report["gaussian_xml"][tag] = dict(
            wall_s=wall, mean_rel_err=mean_rel, block_rel_l1=block_l1,
            gate=gate, channel_ratio_to_mc=ratio.tolist())
        print(f"[24d cornell.xml, gaussian filter, {tag}] {name}: "
              f"{wall:.3f} s; vs the box-filter MC mean rel {mean_rel:.4f} "
              f"(phase 22's gate {gate:.4f}), channel means / MC "
              f"{[round(x, 4) for x in ratio.tolist()]}")
        need(bool(torch.isfinite(img).all()), f"{tag}: image not finite")
        need(mean_rel < gate, f"gaussian cornell.xml {tag}: differs from MC "
             f"by {mean_rel}")

    report["slice7_launches"] = launches7
    print(f"[24 slice 7 launches, the main path's renders] {name}: "
          f"{launches7}")
    for key in ("path_trace", "mmlt_trace", "splat_add", "path_trace[full]",
                "mmlt_trace[full]"):
        need(launches7[key] > 0, f"{key} did not launch on phase 24's path")
    return launches7


# phase 25: the bidirectional wavefront (integrators/bidir.py) over the
# intersection kernel: BDPT, the wavefront MMLT trace, the thin lens
BDPT_LANES = 65536        # 25a: lanes of trace_bdpt on the box
BDPT_LARGE_LANES = 16384  # 25a: lanes on cornell_large.xml (the walk)
BDPT_DEPTH = 5            # the reference's integrator=bdpt default
BDPT_SPP = 2              # 25c: integrator=bdpt samples a pixel
# 25c: integrator=bdpt against phase 5's MC, two plain unbiased estimators
# (0.0004 apart on the H100).  The phase prints the standard deviation of
# their image means' relative difference as the 16x16 blocks' spread
# predicts it (sqrt(pi / 2) x the blocks' relative L1 over sqrt(256)
# blocks; a heavy tail would hide from it): about 0.0012, so 0.01 fails a
# bias of a percent.  Two render_pt at BDPT's 2 samples a pixel differ by
# 0.0233: the path tracer is far noisier a sample than BDPT, so its spread
# at that count is no basis for this gate.  The MCMC routes keep
# MC_GATE["path"]
BDPT_GATE = 0.01
BDPT_MCMC_SPP = 8         # 25c: MCMC mutations a pixel
LENS_SPP = 64             # 25d: the thin-lens MMLT renders' (a grouped
#                           group whose share of the steps rounds to 0
#                           is skipped, as in the reference)
XML_BDPT_SPP = 64         # 25e: samples a pixel of cornell.xml (64x64)
LENS = dict(aperture_radius=25.0, focus_distance=1073.0)


def bdpt_lanes(k, t):
    """(max |d|, share of lanes above 1e-3 relative, channel-mean rel) of
    Splats k against Splats t (the twin's, or the kernel's), every splat of
    a lane."""
    a, b = k.value.cpu().double(), t.value.cpu().double()
    R = a.shape[0]
    rel = ((a - b).abs() / (b.abs() + 1e-4)).reshape(R, -1).max(1).values
    m_rel = float(((a.mean((0, 1)) - b.mean((0, 1))).abs()
                   / b.mean((0, 1)).abs()).max())
    return float((a - b).abs().max()), float((rel > 1e-3).double().mean()), \
        m_rel


def lens_copy(scene):
    return dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, **{k: torch.tensor(v) for k, v in LENS.items()}))


def slice8(name, dev, gen, report, mc_refs, s5):
    """Phase 25: the bidirectional layer on the card.  Returns the
    main-path launches of (a) and (c)-(e), with the intersection kernel's
    split by mode."""
    from drmlt_mitsuba_tpu_torch.integrators import bidir as BD

    fc = filmlib.make_film_config(SIZE, SIZE, "box")
    launches8 = dict.fromkeys(build.LAUNCHES, 0)
    ix_mode = {"brute": 0, "bvh": 0}

    def count(mode):
        for key, c in build.LAUNCHES.items():
            launches8[key] += c
        ix_mode[mode] += build.LAUNCHES["intersect"]

    # ---- 25a. trace_bdpt on the card against its twin on the CPU ----------
    cfg = BDPTConfig(max_depth=BDPT_DEPTH)
    large, _ = cli.load_scene(LARGE_XML, {})
    cornell = cornell_box(SIZE, SIZE)
    report["bdpt_vs_twin"] = {}
    for tag, scene, R, mode in (("box", cornell, BDPT_LANES, "brute"),
                                ("cornell_large.xml", large,
                                 BDPT_LARGE_LANES, "bvh")):
        tk = BD.make_bidir_tables(scene, cfg, dev)
        need((tk.rays.nodes is None) == (mode == "brute"),
             f"{tag}: the intersection kernel is not in {mode} mode")
        u = torch.rand((R, cfg.n_dims), generator=gen, device=dev)
        BD.trace_bdpt(tk, cfg, u)                 # warm-up
        build.reset_launches()
        sk, wall = sync_time(lambda: BD.trace_bdpt(tk, cfg, u))
        n_ix = build.LAUNCHES["intersect"]
        count(mode)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _, prof_wall = sync_time(lambda: BD.trace_bdpt(tk, cfg, u))
        busy, per = device_profile(prof.events(), prof_wall)
        ix_ms = sum(t for k, (t, _) in per.items() if "intersect" in k
                    or "brute_sweep" in k)
        ms = event_ms(lambda: BD.trace_bdpt(tk, cfg, u), runs=3)
        tt = BD.make_bidir_tables(scene, cfg, "cpu")
        st, twin_s = sync_time(lambda: BD.trace_bdpt(tt, cfg, u.cpu()))
        mx, bad, m_rel = bdpt_lanes(sk, st)
        row = dict(lanes=R, depth=BDPT_DEPTH, splats=cfg.n_splats,
                   max_abs=mx, bad_lanes=bad, mean_rel=m_rel, ms=ms,
                   ms_per_65536=ms * 65536 / R, first_wall_s=wall,
                   busy_share=busy, intersect_device_ms=ix_ms,
                   intersect_launches=n_ix, twin_s=twin_s,
                   top_kernels_ms=[[k, t, c] for k, (t, c) in sorted(
                       per.items(), key=lambda kv: -kv[1][0])[:6]])
        report["bdpt_vs_twin"][tag] = row
        print(f"[25a trace_bdpt vs twin] {name}: {tag}, {R} lanes, depth "
              f"{BDPT_DEPTH}, {cfg.n_splats} splats a lane: max |d| "
              f"{mx:.3e}, lanes differing {bad:.5f}, channel-mean rel "
              f"{m_rel:.2e}; {ms:.3f} ms a call ({ms * 65536 / R:.3f} ms "
              f"per 65,536 samples), device busy {busy:.4f}, intersection "
              f"kernel {n_ix} launches ({mode} mode) and {ix_ms:.3f} ms of "
              f"device time; the twin {twin_s:.1f} s")
        need(bool(torch.isfinite(sk.value).all()), f"{tag}: non-finite")
        need(bad <= MAX_BAD_LANES, f"trace_bdpt {tag}: {bad} of lanes "
             f"differ from the twin")
        need(m_rel <= MEAN_RTOL, f"trace_bdpt {tag}: means differ {m_rel}")
        need(n_ix > 0 and busy > 0, f"{tag}: no intersection launch")

    # ---- 25b. the wavefront MMLT trace against the MMLT kernel ------------
    mcfg = BDPTConfig(max_depth=BDPT_DEPTH)
    u = torch.rand((BDPT_LANES, 1 + mcfg.n_dims), generator=gen, device=dev)
    depth = 1 + torch.randint(0, BDPT_DEPTH, (BDPT_LANES,), generator=gen,
                              device=dev)
    wk = BD.trace_mmlt_wavefront(cornell, mcfg, u, depth)
    kk = BD.trace_mmlt(cornell, mcfg, u, depth)
    mx, bad, m_rel = bdpt_lanes(wk, kk)
    report["mmlt_wavefront_vs_kernel"] = dict(max_abs=mx, bad_lanes=bad,
                                              mean_rel=m_rel)
    print(f"[25b trace_mmlt_wavefront vs the MMLT kernel] {name}: cornell, "
          f"{BDPT_LANES} lanes, depths 1-{BDPT_DEPTH}: max |d| {mx:.3e}, "
          f"lanes differing {bad:.5f}, channel-mean rel {m_rel:.2e}")
    need(bad <= MAX_BAD_LANES_MMLT and m_rel <= MEAN_RTOL,
         f"wavefront MMLT vs kernel: {bad} of lanes, means {m_rel}")

    # ---- 25c. the CLI's BDPT routes on the box against phase 5's MC -------
    report["bdpt_cli"] = {}
    for tag, defs, spp in (
            ("integrator=bdpt", ["integrator=bdpt", f"maxDepth={DEPTH}"],
             BDPT_SPP),
            ("drmlt technique=bdpt", ["integrator=drmlt", "technique=bdpt",
                                      "variant=orbital"], BDPT_MCMC_SPP),
            ("pssmlt technique=bdpt", ["integrator=pssmlt",
                                       "technique=bdpt"], BDPT_MCMC_SPP)):
        sc, xs = cli.load_scene("cornell", dict(kv.split("=", 1)
                                                for kv in defs))
        args = argparse.Namespace(D=defs, chains=CHAINS, spp=spp, seed=97)
        build.reset_launches()
        (img, aux), wall = sync_time(lambda: cli.render(args, sc, xs, dev))
        count("brute")
        mean_rel, block_l1 = mc_compare(img, mc_refs["path"])
        n = aux.get("samples", aux.get("mutations"))
        gate = BDPT_GATE if tag == "integrator=bdpt" else MC_GATE["path"]
        # the image mean's noise, from the spread of its 256 blocks
        noise = block_l1 * (np.pi / 2) ** 0.5 / 16
        row = dict(wall_s=wall, work=n, per_s=n / wall,
                   mean_rel_err=mean_rel, block_rel_l1=block_l1,
                   mean_noise_from_blocks=noise, gate=gate)
        if "b" in aux:
            row["b"] = float(aux["b"])
        report["bdpt_cli"][tag] = row
        print(f"[25c CLI {tag}] {name}: cornell, depth {DEPTH}, spp {spp}: "
              f"{wall:.3f} s ({n / wall:.4e} "
              f"{'samples' if 'samples' in aux else 'mutations'}/s); vs MC "
              f"mean rel {mean_rel:.4f} (gate {gate}; its noise from the "
              f"blocks {noise:.4f}), 16x16-block rel L1 {block_l1:.4f}")
        need(bool(torch.isfinite(img).all()), f"{tag}: image not finite")
        need(mean_rel < gate, f"CLI {tag}: differs from MC by {mean_rel}")

    # ---- 25d. drmlt + mmlt with a thin lens, grouped and pooled -----------
    lens = lens_copy(cornell)
    gen.manual_seed(98)
    ref_l = filmlib.develop(fc, render_pt(
        lens, PathConfig(max_depth=MMLT_DEPTH, rr_depth=100, thinlens=True),
        gen, SIZE * SIZE * 64, fc, mode="accum"), mode="accum")
    report["thinlens_mmlt_cli"] = {}
    for tag, d in (("grouped", []), ("pooled", ["grouped=false"])):
        defs = ["technique=mmlt", f"maxDepth={MMLT_DEPTH}", "variant=orbital",
                "luminanceSamples=100000"] + d
        _, xs = cli.load_scene("cornell", dict(kv.split("=", 1)
                                               for kv in defs))
        args = argparse.Namespace(D=defs, chains=CHAINS, spp=LENS_SPP,
                                  seed=99)
        build.reset_launches()
        (img, aux), wall = sync_time(lambda: cli.render(args, lens, xs, dev))
        need(build.LAUNCHES["mmlt_trace"] + build.LAUNCHES[
            "mmlt_trace[full]"] == 0, f"thin-lens {tag}: the MMLT kernel ran")
        count("brute")
        mean_rel, block_l1 = mc_compare(img, ref_l)
        row = dict(wall_s=wall, mutations=aux["mutations"],
                   mutations_per_s=aux["mutations"] / wall,
                   b=float(aux["b"]), mean_rel_err=mean_rel,
                   block_rel_l1=block_l1, gate=MC_GATE["cornell"])
        report["thinlens_mmlt_cli"][tag] = row
        print(f"[25d CLI drmlt mmlt, thin lens, {tag}] {name}: cornell "
              f"(aperture {LENS['aperture_radius']}, focus "
              f"{LENS['focus_distance']}), max_depth {MMLT_DEPTH}, {CHAINS} "
              f"chains, spp {LENS_SPP}: {wall:.3f} s "
              f"({row['mutations_per_s']:.4e} mutations/s, bootstrap "
              f"included); b {row['b']:.6f}; vs thin-lens MC mean rel "
              f"{mean_rel:.4f} (gate {MC_GATE['cornell']}), 16x16-block rel "
              f"L1 {block_l1:.4f}")
        need(bool(torch.isfinite(img).all()), f"{tag}: image not finite")
        need(mean_rel < MC_GATE["cornell"], f"thin-lens MMLT {tag}: differs "
             f"from MC by {mean_rel}")

    # ---- 25e. tests/data/cornell.xml through integrator=bdpt --------------
    defs = ["integrator=bdpt"]
    sc, xs = cli.load_scene(CORNELL_XML, {"integrator": "bdpt"})
    args = argparse.Namespace(D=defs, chains=CHAINS, spp=XML_BDPT_SPP,
                              seed=100)
    build.reset_launches()
    (img, aux), wall = sync_time(lambda: cli.render(args, sc, xs, dev))
    count("brute" if sc.bvh is None else "bvh")
    ref, gate = s5["xml_path"]["ref"], s5["xml_path"]["gate"]
    mean_rel, block_l1 = mc_compare(img, ref)
    report["bdpt_cornell_xml"] = dict(
        wall_s=wall, samples=aux["samples"], mean_rel_err=mean_rel,
        block_rel_l1=block_l1, gate=gate, size=[xs.width, xs.height])
    print(f"[25e CLI integrator=bdpt, cornell.xml] {name}: "
          f"{xs.width}x{xs.height}, the file's depth "
          f"{xs.integrator['maxDepth']}, {aux['samples']} samples: "
          f"{wall:.3f} s; vs phase 22's MC mean rel {mean_rel:.4f} (gate "
          f"{gate:.4f}), 16x16-block rel L1 {block_l1:.4f}")
    need(bool(torch.isfinite(img).all()), "cornell.xml bdpt: not finite")
    need(mean_rel < gate, f"cornell.xml bdpt: differs from MC by {mean_rel}")

    # ---- 25f. the splat kernel on light-image splats off the film ---------
    # the veach door's camera stands inside the room: light vertices behind
    # it or outside its view give light-image splats off the film
    sp = BD.trace_bdpt(BD.make_bidir_tables(veach_door(SIZE, SIZE), cfg,
                                            dev), cfg,
                       torch.rand((BDPT_LANES, cfg.n_dims), generator=gen,
                                  device=dev))
    pos = sp.pos[:, 1:].reshape(-1, 2)
    val = sp.value[:, 1:].reshape(-1, 3)
    off = ((pos < 0) | (pos >= 1)).any(-1)
    # off the film on every side: the kernel must drop, never clamp
    edge = torch.rand((SPLATS, 2), generator=gen, device=dev) * 3.0 - 1.0
    edge = edge[((edge < 0) | (edge >= 1)).any(-1)]
    all_pos = torch.cat([pos, edge]) * SIZE
    all_val = torch.cat([val, torch.rand((edge.shape[0], 3), generator=gen,
                                         device=dev)])
    py, px, vals = filmlib.taps(fc, all_pos, all_val, mode="splat")
    film_k = SP.splat_add_(filmlib.new_film(fc, dev), py, px, vals)
    film_t = SP.splat_add_reference_(filmlib.new_film(fc, dev), py, px,
                                     vals)
    mag = SP.splat_add_reference_(filmlib.new_film(fc, dev), py, px,
                                  vals.abs())
    err = float(((film_k - film_t).abs() / mag.clamp(min=1e-30)).max())
    py, px, vals = filmlib.taps(fc, edge * SIZE, all_val[-edge.shape[0]:],
                                mode="splat")
    off_sum = float(SP.splat_add_(filmlib.new_film(fc, dev), py, px,
                                  vals).abs().sum())
    report["bdpt_splats_off_film"] = dict(
        light_splats=int(pos.shape[0]), light_off_film=int(off.sum()),
        light_off_film_abs_value=float(val[off].abs().sum()),
        synthetic_off_film=int(edge.shape[0]), max_rel_err=err,
        off_film_sum=off_sum)
    print(f"[25f splat kernel, light-image splats] {name}: "
          f"{pos.shape[0]} light-image splats ({int(off.sum())} off the "
          f"film, |value| sum {float(val[off].abs().sum())}) and "
          f"{edge.shape[0]} splats off the film on every side: per-pixel "
          f"|kernel - twin| / sum |tap| {err:.2e} (gate {SPLAT_RTOL}); the "
          f"off-film splats alone add {off_sum}")
    need(err <= SPLAT_RTOL, f"light-image splats: kernel vs twin {err}")
    need(off_sum == 0.0, f"splats off the film added {off_sum}")
    need(float(val[off].abs().sum()) == 0.0 and int(off.sum()) > 0,
         "no light-image splat off the film, or one carries value")

    report["slice8_launches"] = dict(launches8, intersect_by_mode=ix_mode)
    print(f"[25 slice 8 launches, the main path's runs] {name}: {launches8}; "
          f"intersection kernel by mode {ix_mode}")
    for key in ("intersect", "splat_add"):
        need(launches8[key] > 0, f"{key} did not launch on phase 25's path")
    need(ix_mode["brute"] > 0 and ix_mode["bvh"] > 0,
         f"the intersection kernel missed a mode: {ix_mode}")
    return dict(launches8, intersect_by_mode=ix_mode)


# phase 26: the forward renderers (integrators/misc.py), every sampler of
# render_pt, and the CLI's new routes, flags and outputs
FIELD_SPP = 4             # 26a: samples a pixel of the field renders
FIELD_LARGE_SIDE = 64     # 26a: cornell_large.xml's film (its CPU twin walks
#                           every ray in a host loop: 16,384 rays, as 25a)
MOTION_DX = 20.0          # 26b: the reference test's +x translation
MOTION_TOL = 1e-4         # 26b: pixels; velocities are differences of film
#                           positions, so a last-bit difference of one
#                           scales by the film's width
PTRACER_PATHS = 4 * 65536  # 26c: light paths, in chunks of 65,536
PTRACER_CHUNK = 65536
# 26c: the light tracer against phase 5's MC (both unbiased at depth 8; on
# a 16x16 box on the CPU their means agree within 0.3%); the phase prints
# the image mean's noise from the 16x16 blocks beside it
PTRACER_GATE = 0.02
# 26d: each sampler renders SAMPLER_REPS images of one path a pixel, each
# under its own shifts (its own generator draws).  Randomised QMC errors
# correlate across a render's pixels, so the 16x16 blocks' spread misses
# them (ldsampler gives every pair of dimensions the one (0, 2) point
# set, as the reference does: its image mean moved 5% with its shifts on
# the H100, against 1.2% that the blocks predicted); the spread of the
# replicates' means is the honest standard error.  The gate is four of
# them, and at least SAMPLER_GATE
SAMPLER_REPS = 16
SAMPLER_GATE = 0.01
# 26d: timed 16-spp renders per sampler, one of each sampler a round (one
# ~10 ms host-timed render read 8.6e6-9.0e7 paths/s on a shared host)
SAMPLER_TIMINGS = 5
# 26d: the matrices' indices, start .. start + SAMPLER_ROWS - 1 (past 2^24
# so that the high bits of the index take part)
SAMPLER_START, SAMPLER_ROWS = (1 << 24) + 12345, 65536
# 26e: pssmlt under -t / -r: 64 x 64 x 32 / 256 = 512 steps, two blocks
PSS_FLAG_CHAINS, PSS_FLAG_SPP = 256, 32
# a fresh process running the CLI's main once per argv list of its JSON
# argument, printing the launch counters after each (phase 26e)
CLI_RUNS = ("import json, sys\n"
            "from drmlt_mitsuba_tpu_torch.utils import cli\n"
            "from drmlt_mitsuba_tpu_torch.ops import build\n"
            "for argv in json.loads(sys.argv[1]):\n"
            "    build.reset_launches()\n"
            "    rc = cli.main(argv)\n"
            "    counts = dict(build.LAUNCHES, rc=rc)\n"
            "    print('LAUNCHES ' + json.dumps(counts))\n"
            "    if rc:\n"
            "        sys.exit(rc)\n")


def run_cli(argvs, timeout=600):
    """(per-run launch dicts, stdout lines, wall s) of `argvs` through
    CLI_RUNS in one fresh process."""
    cmd = [sys.executable, "-c", CLI_RUNS, json.dumps(argvs)]
    res, wall = sync_time(lambda: subprocess.run(
        cmd, capture_output=True, text=True, timeout=timeout, cwd=ROOT))
    need(res.returncode == 0, f"CLI runs {argvs}: exit {res.returncode}: "
         f"{res.stderr[-2000:]}")
    lines = res.stdout.splitlines()
    runs = [json.loads(ln[len("LAUNCHES "):]) for ln in lines
            if ln.startswith("LAUNCHES ")]
    need(len(runs) == len(argvs), f"CLI runs: {len(runs)} of {len(argvs)}")
    return runs, lines, wall


def slice9(name, dev, gen, report, mc_refs, s5):
    """Phase 26: the forward renderers, the samplers and the CLI's new
    routes on the card.  Returns the main-path launches of (a)-(e), with
    the intersection kernel's split by mode."""
    from drmlt_mitsuba_tpu_torch.integrators import bidir as BD
    from drmlt_mitsuba_tpu_torch.integrators import misc
    from drmlt_mitsuba_tpu_torch.render import sampler as S
    from drmlt_mitsuba_tpu_torch.scene.types import build_motion

    t_phase = time.perf_counter()
    fc = filmlib.make_film_config(SIZE, SIZE, "box")
    launches9 = dict.fromkeys(build.LAUNCHES, 0)
    ix_mode = {"brute": 0, "bvh": 0}
    cpu_gen = torch.Generator().manual_seed(0)

    def count(mode, counts=None):
        for key, c in (counts or build.LAUNCHES).items():
            if key in launches9:
                launches9[key] += c
        ix_mode[mode] += (counts or build.LAUNCHES)["intersect"]

    # ---- 26a. every field AOV on the card against the CPU's ---------------
    cornell = cornell_box(SIZE, SIZE)
    large, _ = cli.load_scene(LARGE_XML, {})
    cfg1 = BDPTConfig(max_depth=1)
    report["field_vs_twin"] = {}
    for tag, scene, side, mode in (("box", cornell, SIZE, "brute"),
                                   ("cornell_large.xml", large,
                                    FIELD_LARGE_SIDE, "bvh")):
        fcs = filmlib.make_film_config(side, side, "box")
        tk = BD.make_bidir_tables(scene, cfg1, dev)
        tc = BD.make_bidir_tables(scene, cfg1, "cpu")
        need((tk.rays.nodes is None) == (mode == "brute"),
             f"{tag}: the intersection kernel is not in {mode} mode")
        u = torch.rand((side * side * FIELD_SPP, 4), generator=gen,
                       device=dev)
        uc = u.cpu()
        # the CPU's hits once: every kind's call makes the same one
        (uv_c, o_c, d_c, hit_c), twin_s = sync_time(
            lambda: misc.first_hit_fields(tc, fcs, uc))
        # the rays come from PyTorch's elementwise kernels on each device,
        # whose directions differ in the last bit on some lanes: the same
        # triangle everywhere, t within a few ulps
        _, _, d_k, hit_k = misc.first_hit_fields(tk, fcs, u)
        prim_equal = (torch.equal(hit_k.prim.cpu(), hit_c.prim)
                      and torch.equal(hit_k.valid.cpu(), hit_c.valid))
        t_k, ok_t = hit_k.t.cpu(), hit_c.valid
        t_rel = float(((t_k - hit_c.t).abs() / hit_c.t.abs())[ok_t].max()) \
            if ok_t.any() else 0.0
        n_t = int((t_k != hit_c.t).sum())
        d_ulp = float((d_k.cpu() - d_c).abs().max())
        rows = {}
        for kind in misc.FIELD_KINDS:
            build.reset_launches()
            img = misc.render_field(tk, fcs, gen, kind, FIELD_SPP, u=u)
            count(mode)
            real = misc.intersect
            misc.intersect = lambda *a, **kw: hit_c
            try:
                ref = misc.render_field(tc, fcs, cpu_gen, kind, FIELD_SPP,
                                        u=uc)
            finally:
                misc.intersect = real
            # per pixel, of the sum of |value| landing there, over its
            # channels (24d's gate; a channel alone can cancel to ~0, as a
            # position's y on the floor, while its rounding is the others');
            # a position o + t d rounds as its terms do, which near the
            # box's corner at the origin are far larger than it
            mag = misc.field_values(tc, o_c, d_c, hit_c, kind).abs()
            if "position" in kind:
                mag = torch.where(hit_c.valid[:, None], o_c.abs() + (
                    hit_c.t[:, None] * d_c).abs() + (
                    tc.cam[9:12].abs() if kind == "relposition" else 0.0),
                    0.0)
            mag = misc.splat_aov(fcs, uv_c, mag).sum(-1)
            d = (img.cpu() - ref).abs().amax(-1)
            zero = mag == 0
            err = float((d[~zero] / mag[~zero]).max()) if (~zero).any() \
                else 0.0
            ms = event_ms(lambda: misc.render_field(tk, fcs, gen, kind,
                                                    FIELD_SPP, u=u), runs=3)
            rows[kind] = dict(max_rel_err=err, max_abs=float(d.max()),
                              zero_pixels_equal=bool((d[zero] == 0).all()),
                              ms=ms)
            need(bool(torch.isfinite(img).all()), f"{tag} {kind}: not finite")
            need(err <= SPLAT_RTOL and rows[kind]["zero_pixels_equal"],
                 f"field {kind} on {tag}: card vs CPU {err}")
        report["field_vs_twin"][tag] = dict(
            rays=u.shape[0], side=side, spp=FIELD_SPP, same_triangles=
            prim_equal, t_max_rel=t_rel, t_lanes_differing=n_t,
            dir_max_abs_diff=d_ulp, cpu_hits_s=twin_s, kinds=rows)
        print(f"[26a render_field vs CPU] {name}: {tag}, {side}x{side} x "
              f"{FIELD_SPP} spp ({mode} mode): the same triangle on every "
              f"ray {prim_equal}, t on {n_t} rays differing by at most "
              f"{t_rel:.2e} relative (directions {d_ulp:.2e} apart); "
              f"max per-pixel |card - CPU| / sum |value| "
              f"{max(r['max_rel_err'] for r in rows.values()):.2e} (gate "
              f"{SPLAT_RTOL}); ms a render " + ", ".join(
                  f"{k} {r['ms']:.3f}" for k, r in rows.items()))
        need(prim_equal and t_rel <= 1e-6, f"{tag}: the card's first hits "
             f"differ from the CPU's ({prim_equal}, t {t_rel})")

    # ---- 26b. the motion AOV of the translated box ------------------------
    dx = torch.where((cornell.tris.emitter_id < 0)[:, None],
                     torch.tensor([MOTION_DX, 0.0, 0.0]), 0.0)
    moving = dataclasses.replace(cornell, motion=build_motion(
        cornell.tris, dataclasses.replace(cornell.tris,
                                          v0=cornell.tris.v0 + dx)))
    u = torch.rand((SIZE * SIZE, 4), generator=gen, device=dev)
    build.reset_launches()
    vk, wall = sync_time(lambda: misc.render_motion_aov(moving, fc, gen, 1,
                                                        u=u))
    count("brute")
    vc = misc.render_motion_aov(moving, fc, cpu_gen, 1, u=u.cpu())
    mx = float((vk.cpu() - vc).abs().max())
    right = float((vk[..., 0] > 0).float().mean())
    report["motion_vs_twin"] = dict(max_abs_px=mx, wall_s=wall,
                                    share_moving_right=right,
                                    max_speed_px=float(vc.abs().max()))
    print(f"[26b render_motion_aov vs CPU] {name}: box, +{MOTION_DX} x over "
          f"the shutter, {SIZE}x{SIZE} x 1 spp: max |card - CPU| {mx:.2e} px "
          f"(gate {MOTION_TOL}), fastest {float(vc.abs().max()):.3f} px, "
          f"{right:.3f} of pixels moving right; {wall:.3f} s with its "
          f"tables")
    need(mx <= MOTION_TOL and right > 0.5, f"motion AOV: {mx} px, {right}")

    # ---- 26c. the particle tracer against phase 5's MC --------------------
    tb8 = BD.make_bidir_tables(cornell, BDPTConfig(max_depth=DEPTH), dev)
    misc.render_ptracer(tb8, fc, gen, PTRACER_CHUNK, max_depth=DEPTH,
                        chunk=PTRACER_CHUNK)                 # warm-up
    build.reset_launches()
    lt, wall = sync_time(lambda: misc.render_ptracer(
        tb8, fc, gen, PTRACER_PATHS, max_depth=DEPTH, chunk=PTRACER_CHUNK))
    count("brute")
    mean_rel, block_l1 = mc_compare(lt, mc_refs["path"])
    noise = block_l1 * (np.pi / 2) ** 0.5 / 16
    report["ptracer"] = dict(paths=PTRACER_PATHS, wall_s=wall,
                             paths_per_s=PTRACER_PATHS / wall,
                             mean_rel_err=mean_rel, block_rel_l1=block_l1,
                             mean_noise_from_blocks=noise, gate=PTRACER_GATE)
    print(f"[26c render_ptracer vs MC] {name}: box, depth {DEPTH}, "
          f"{PTRACER_PATHS} light paths in chunks of {PTRACER_CHUNK}: "
          f"{wall:.3f} s ({PTRACER_PATHS / wall:.4e} paths/s); vs phase 5's "
          f"MC mean rel {mean_rel:.4f} (gate {PTRACER_GATE}; its noise from "
          f"the blocks {noise:.4f}), 16x16-block rel L1 {block_l1:.4f}")
    need(bool(torch.isfinite(lt).all()), "ptracer: image not finite")
    need(mean_rel < PTRACER_GATE, f"ptracer differs from MC by {mean_rel}")

    # ---- 26d. render_pt under every sampler -------------------------------
    pcfg = PathConfig(max_depth=DEPTH, rr_depth=100, min_depth=1)
    n = SIZE * SIZE
    ref_mean = float(mc_refs["path"].double().mean())
    report["samplers"] = {}
    for kind in S.SAMPLERS:
        render_pt(cornell, pcfg, gen, n, fc, sampler=kind)      # warm-up
        build.reset_launches()

        def reps():
            return [render_pt(cornell, pcfg, gen, n, fc, mode="accum",
                              sampler=kind) for _ in range(SAMPLER_REPS)]

        films = reps()
        count("brute")
        # one image of every replicate's samples (at 1 spp a render leaves
        # pixels without a sample, which develop to 0); each replicate's
        # own estimate of the image mean is its weighted film sum
        img = filmlib.develop(fc, torch.stack(films).sum(0), mode="accum")
        means = torch.stack([f[..., :3].double().sum() / 3.0
                             / f[..., 3].double().sum() for f in films])
        se = float(means.std() / SAMPLER_REPS ** 0.5) / ref_mean
        gate = max(SAMPLER_GATE, 4.0 * se)
        mean_rel, block_l1 = mc_compare(img, mc_refs["path"])
        report["samplers"][kind] = dict(
            paths=n * SAMPLER_REPS, renders=SAMPLER_REPS,
            mean_rel_err=mean_rel, block_rel_l1=block_l1,
            replicate_rel_se=se, gate=gate)
        need(bool(torch.isfinite(img).all()), f"{kind}: image not finite")
        need(mean_rel < gate, f"render_pt under {kind} differs from MC by "
             f"{mean_rel} (gate {gate})")
    # the matrices on the card against the CPU's, on the same indices and
    # shifts (stratified: the same jitter); the CPU's are the reference's
    # bit for bit (tests/test_torch_samplers.py)
    rng = np.random.default_rng(26)
    nd = pcfg.n_dims
    args = dict(
        stratified=lambda i, d: (i, SAMPLER_START + SAMPLER_ROWS, d(
            rng.random((SAMPLER_ROWS, nd), dtype=np.float32))),
        halton=lambda i, d: (i, nd, d(rng.random(nd, dtype=np.float32))),
        hammersley=lambda i, d: (
            i, SAMPLER_START + SAMPLER_ROWS, nd,
            d(rng.random(nd - 1, dtype=np.float32)),
            d(rng.random(nd, dtype=np.float32))),
        sobol=lambda i, d: (i, nd, d(rng.integers(0, 2 ** 32, nd))),
        ldsampler=lambda i, d: (i, nd, d(rng.integers(
            0, 2 ** 32, ((nd + 1) // 2, 2)))))
    funcs = dict(stratified=S.stratified, halton=S.halton,
                 hammersley=S.hammersley, sobol=S.sobol, ldsampler=S.ld02)
    for kind, fn in funcs.items():
        a_cpu = args[kind](
            torch.arange(SAMPLER_START, SAMPLER_START + SAMPLER_ROWS),
            torch.from_numpy)
        a_dev = tuple(x.to(dev) if isinstance(x, torch.Tensor) else x
                      for x in a_cpu)
        m_cpu, m_dev = fn(*a_cpu), fn(*a_dev).cpu()
        differ = int((m_cpu != m_dev).any(-1).sum())
        report["samplers"][kind]["matrix_rows_differing"] = differ
        need(m_dev.shape == (SAMPLER_ROWS, nd) and differ == 0,
             f"{kind}: {differ} of {SAMPLER_ROWS} matrix rows differ from "
             f"the CPU's")
    # paths/s of a SAMPLER_REPS-spp render, in turns over the samplers
    walls = {kind: [] for kind in S.SAMPLERS}
    for _ in range(SAMPLER_TIMINGS):
        for kind in S.SAMPLERS:
            _, wall = sync_time(lambda: render_pt(
                cornell, pcfg, gen, n * SAMPLER_REPS, fc, sampler=kind))
            walls[kind].append(wall)
    for kind, w in walls.items():
        rates = sorted(n * SAMPLER_REPS / x for x in w)
        report["samplers"][kind].update(
            wall_s=w, paths_per_s=float(np.median(rates)),
            paths_per_s_min=rates[0], paths_per_s_max=rates[-1])
    ind = report["samplers"]["independent"]["paths_per_s"]
    print(f"[26d render_pt under each sampler] {name}: box, depth {DEPTH}, "
          f"paths/s of a {SAMPLER_REPS}-spp render (median of "
          f"{SAMPLER_TIMINGS} in turns, min-max); {SAMPLER_REPS} renders "
          f"of 1 spp each against MC; matrices of {SAMPLER_ROWS} rows vs "
          f"the CPU's: " + "; ".join(
              f"{k} {r['paths_per_s']:.4e} paths/s "
              f"({r['paths_per_s_min']:.4e}-{r['paths_per_s_max']:.4e}; "
              f"{r['paths_per_s'] / ind:.3f} of independent's), vs MC "
              f"{r['mean_rel_err']:.4f} (the replicates' standard error "
              f"{r['replicate_rel_se']:.4f}, gate {r['gate']:.4f})"
              + (f", matrix rows differing "
                 f"{r['matrix_rows_differing']}"
                 if "matrix_rows_differing" in r else "")
              for k, r in report["samplers"].items()))

    # ---- 26e. cornell.xml through the CLI's new routes and flags ----------
    out = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    sobol_xml = os.path.join(out, "cornell_sobol.xml")
    with open(CORNELL_XML) as f:
        text = f.read()
    need('<sampler type="independent">' in text, "cornell.xml's sampler")
    with open(sobol_xml, "w") as f:
        f.write(text.replace('<sampler type="independent">',
                             '<sampler type="sobol">'))
    field_npy = os.path.join(out, "cornell_field.npy")
    pss = os.path.join(out, "cornell_pssmlt")
    for p in (field_npy, f"{pss}_t.exr", f"{pss}_r.exr", f"{pss}_r_0.exr",
              f"{pss}_r_1.exr", f"{pss}_r_time.csv"):
        if os.path.exists(p):
            os.remove(p)
    pss_d = ["-D", "integrator=pssmlt", "--chains", str(PSS_FLAG_CHAINS),
             "--spp", str(PSS_FLAG_SPP), "-s", "26"]
    argvs = [[CORNELL_XML, "-D", "integrator=field", "-D", "field=shnormal",
              "--spp", "16", "-s", "26", "-o", field_npy],
             [CORNELL_XML, *pss_d, "-t", "1e-9", "-o", f"{pss}_t.exr"],
             [CORNELL_XML, *pss_d, "-r", "1e-9", "-o", f"{pss}_r.exr"],
             [sobol_xml, "-D", "integrator=path", "--spp", "64", "-s", "26",
              "-o", os.path.join(out, "cornell_sobol.exr")]]
    runs, lines, wall = run_cli(argvs)
    for r in runs:
        count("brute", r)
    field = np.load(field_npy)
    xs_scene, xs = cli.load_scene(CORNELL_XML, {"integrator": "field"})
    g26 = torch.Generator(device=dev).manual_seed(26)
    ref_field = misc.render_field(xs_scene, filmlib.make_film_config(
        xs.width, xs.height, xs.filter_name), g26, "shnormal", 16).cpu()
    field_d = float((torch.from_numpy(field) - ref_field).abs().max())
    with open(f"{pss}_t_stats.txt") as f:
        t_report = f.read()
    with open(f"{pss}_r_time.csv") as f:
        dumps = f.read().splitlines()
    n_blocks = -(-(xs.width * xs.height * PSS_FLAG_SPP // PSS_FLAG_CHAINS)
                 // cli.PSSMLT_BLOCK)
    half = cli.PSSMLT_BLOCK * PSS_FLAG_CHAINS     # one block's mutations
    pss_r = torch.from_numpy(np.ascontiguousarray(
        read_exr(f"{pss}_r.exr")[..., :3])).to(dev)
    ref_x, gate_x = s5["xml_path"]["ref"], s5["xml_path"]["gate"]
    pss_rel, _ = mc_compare(pss_r, ref_x)
    sob = torch.from_numpy(np.ascontiguousarray(read_exr(os.path.join(
        out, "cornell_sobol.exr"))[..., :3])).to(dev)
    sob_rel, sob_l1 = mc_compare(sob, ref_x)
    # -x in another fresh process: it returns before reading the scene
    before = open(field_npy, "rb").read()
    res = subprocess.run([sys.executable, "-m",
                          "drmlt_mitsuba_tpu_torch.utils.cli", CORNELL_XML,
                          "-x", "-o", field_npy], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    skipped = (res.returncode == 0 and "skipping (-x)" in res.stdout
               and open(field_npy, "rb").read() == before)
    report["cli26"] = dict(
        process_wall_s=wall, launches=runs, field_npy_shape=list(field.shape),
        field_vs_in_process_max_abs=field_d,
        timeout_mutations_reported=f"* Mutations: {half}" in t_report,
        refresh_dumps=dumps, pssmlt_r_mean_rel_err=pss_rel,
        sobol_mean_rel_err=sob_rel, sobol_block_rel_l1=sob_l1, gate=gate_x,
        skip_existing=skipped, stdout=lines[-40:])
    print(f"[26e CLI, cornell.xml, a fresh process of {wall:.2f} s] {name}: "
          f"integrator=field -o .npy {list(field.shape)}, max |d| to the "
          f"same render in this process {field_d:.2e}; pssmlt -t 1e-9 "
          f"stopped at one block of {cli.PSSMLT_BLOCK} steps of {n_blocks} "
          f"({half} mutations in its "
          f"report: {report['cli26']['timeout_mutations_reported']}); -r "
          f"1e-9 wrote {len(dumps)} partial images and _time.csv, its image "
          f"vs phase 22's MC mean rel {pss_rel:.4f}; <sampler "
          f"type=\"sobol\"> integrator=path vs MC mean rel {sob_rel:.4f} "
          f"(gate {gate_x:.4f}); -x in a fresh process skipped: {skipped}")
    need(field.shape == (xs.height, xs.width, 3) and np.isfinite(field).all()
         and field_d <= 1e-5, f"CLI field .npy: {field.shape}, {field_d}")
    need(report["cli26"]["timeout_mutations_reported"],
         f"pssmlt -t did not stop after one block: {t_report}")
    need(n_blocks > 1 and len(dumps) == n_blocks
         and all(os.path.exists(f"{pss}_r_{i}.exr") for i in range(n_blocks)),
         f"-r dumps: {dumps} of {n_blocks} blocks")
    need(pss_rel < MC_GATE["path"], f"CLI pssmlt -r: {pss_rel} from MC")
    need(sob_rel < gate_x, f"CLI sobol path render: {sob_rel} from MC")
    need(skipped, f"-x: {res.returncode} {res.stdout[-500:]}")

    report["slice9_launches"] = dict(launches9, intersect_by_mode=ix_mode)
    print(f"[26 slice 9 launches, the main path's runs] {name}: {launches9}; "
          f"intersection kernel by mode {ix_mode}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    for key in ("intersect", "splat_add", "path_trace", "path_trace[full]"):
        need(launches9[key] > 0, f"{key} did not launch on phase 26's path")
    need(ix_mode["brute"] > 0 and ix_mode["bvh"] > 0,
         f"the intersection kernel missed a mode: {ix_mode}")
    return dict(launches9, intersect_by_mode=ix_mode)


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
    # each trace kernel in its two scene-scope instantiations (ILb0E: the
    # subset of slices 1-4, ILb1E: the full scope), the chain kernel's in
    # DRMLT mode (ELb0E) and pssmlt mode (ELb1E) each
    for k in ("path_trace_kernelILb0E", "path_trace_kernelILb1E",
              "path_lane_kernelILb0E", "path_lane_kernelILb1E",
              "mmlt_trace_kernelILb0E", "mmlt_trace_kernelILb1E",
              *(f"drmlt_chain_kernelINS_9{t}ILb{x}EEELb{p}E"
                for t in ("PathTrace", "MmltTrace") for x in (0, 1)
                for p in (0, 1)),
              "splat_add_kernel",
              "path_trace_rad_kernelILb0E", "path_trace_rad_kernelILb1E",
              "path_trace_alb_kernelILb0E", "path_trace_alb_kernelILb1E",
              "path_lane_rad_kernelILb0E", "path_lane_rad_kernelILb1E",
              "path_lane_alb_kernelILb0E", "path_lane_alb_kernelILb1E",
              "intersect_kernel", "brute_sweep_kernelILb0E",
              "brute_sweep_kernelILb1E"):
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
        lane_eq = same_bits(k, MT.path_trace(tables, uT, compact=False))
        torch.cuda.synchronize()
        live = []
        t = MT.path_trace_reference(tables, uT, live=live)
        mx, mean, bad = lane_diff(k, t)
        m_rel = float(((k.double().mean(1) - t.double().mean(1)).abs()
                       / t.double().mean(1).abs()).max())
        wb = warp_bounce_row(live)
        report["path_vs_twin"][tall] = dict(max_abs=mx, mean_abs=mean,
                                            bad_lanes=bad, mean_rel=m_rel,
                                            equal_to_lane_kernel=lane_eq,
                                            warp_bounces=wb)
        print(f"[3 path kernel vs twin] {name}: {tall}: max |d| {mx:.3e}, "
              f"mean |d| {mean:.3e}, lanes differing {bad:.5f}, "
              f"channel-mean rel {m_rel:.2e}; bit-equal to one path per "
              f"thread {lane_eq}; warp-bounces (twin) {wb}")
        need(lane_eq, f"{tall}: the compacting kernel differs from one "
             f"path per thread")
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
        work = {}
        r = compare_chain(tables, ccfg, 2, state0, SIZE, 77, 3, uni,
                          work=work)
        r["stage2_share"] = MD.stage2_share(work)
        tag = f"{drtype}/{mode}/{'uniforms' if given else 'philox'}"
        report["chain_vs_twin"][tag] = r
        print(f"[4 chain kernel vs twin] {name}: {tag}: stage-2 share "
              f"{r['stage2_share']:.4f}, lanes agreeing "
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
    mc_refs = {"path": ref}     # the MC references slice 6 is held to
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
    # the design before compaction, in turns with the kernel (lane, kernel,
    # kernel, lane)
    turns = path_turns(tables, uT)
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
    share_path = MD.stage2_share(path_chain_work)
    report["timing_ms"] = dict(path_trace=ms_path, path_trace_plain=plain_path,
                               path_trace_turns=turns,
                               drmlt_path_n_mut64=ms_chain,
                               drmlt_path_plain_n_mut64=plain_chain,
                               drmlt_path_stage2_share=share_path)
    print(f"[6 timing] {name}: path_trace_kernel {ms_path:.4f} ms vs twin "
          f"{plain_path:.3f} ms ({CHAINS} lanes, depth {DEPTH}; in turns "
          f"with one path per thread {fmt_turns(turns)}; bound "
          f"{bound_path[0]:.4f} ms by {bound_path[1]}, "
          f"{path_work['tri_tests']} ray-triangle tests); "
          f"drmlt_chain_kernel[path] {ms_chain:.3f} ms vs twin "
          f"{plain_chain:.3f} ms, stage-2 share {share_path:.4f} ({CHAINS} "
          f"chains x 64 mutations = "
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
            work = {}
            t = MM.mmlt_trace_reference(mt, uT, work)
            mx, mean, bad = lane_diff(k, t, pos_rows=2)
            m_rel = float(((k[:3].double().mean(1) - t[:3].double().mean(1))
                           .abs() / (t[:3].double().mean(1).abs() + 1e-12))
                          .max())
            ms = event_ms(lambda: MM.mmlt_trace(mt, uT), runs=5)
            bnd = bound(nbytes(uT, mt.tri, mt.mat, mt.em, mt.cam)
                        + 5 * CHAINS * 4, work["tri_tests"])
            report["mmlt_vs_twin"][f"{sname}/{depth}"] = dict(
                max_abs=mx, mean_abs=mean, bad_lanes=bad, mean_rel=m_rel,
                ms=ms, bound_ms=bnd[0], tri_tests=work["tri_tests"])
            row.append(f"d{depth} {1 - bad:.5f} {mx:.1e} {ms:.4f} ms "
                       f"(bound {bnd[0]:.4f})")
            need(bool(torch.isfinite(k).all()), f"{sname}/{depth}: non-finite")
            need(bad <= MAX_BAD_LANES_MMLT,
                 f"MMLT {sname}/{depth}: {bad:.4f} of lanes differ")
            need(m_rel <= MEAN_RTOL, f"MMLT {sname}/{depth}: means {m_rel}")
            mmlt_err = max(mmlt_err, mx)
        print(f"[7 MMLT kernel vs twin] {name}: {sname}, {CHAINS} lanes "
              f"(depth, lanes agreeing, max |d|, kernel ms, bound ms from "
              f"the twin's sweeps): " + ", ".join(row))

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
                    work = {}
                    r = compare_chain(mtab, ccfg, 2, s4, SIZE, 31, 2, uni,
                                      work=work)
                    r["stage2_share"] = MD.stage2_share(work)
                    tag = (f"k{kk}/{drtype}/{mode}/"
                           f"{'uniforms' if given else 'philox'}")
                    report["mmlt_chain_vs_twin"][tag] = r
                    check_chain(tag, r)
                    mmlt_chain_err = max(mmlt_chain_err, r["state_max_abs"])
        rows_k = [(t, r) for t, r in report["mmlt_chain_vs_twin"].items()
                  if t.startswith(f"k{kk}/")]
        agree = min(r["lane_agreement"] for _, r in rows_k)
        print(f"[8 chain kernel, mmlt mode, vs twin] {name}: k {kk} (D "
              f"{Dk}), {C4} chains x 2 mutations, 12 configurations: lowest "
              f"lane agreement {agree:.5f}; stage-2 share " + ", ".join(
                  f"{t.split('/', 1)[1]} {r['stage2_share']:.4f}"
                  for t, r in rows_k))

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
        mc_refs[sname] = (ref2, ref2b)
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
    share_mmlt = MD.stage2_share(mmlt_chain_work)
    report["timing_ms"].update(
        mmlt_trace=ms_mmlt, mmlt_trace_plain=plain_mmlt,
        drmlt_mmlt_k6_n_mut64=ms_mmlt_chain,
        drmlt_mmlt_plain_k6_n_mut64=plain_mmlt_chain,
        drmlt_mmlt_k6_stage2_share=share_mmlt)
    print(f"[10 timing] {name}: mmlt_trace_kernel {ms_mmlt:.3f} ms vs twin "
          f"{plain_mmlt:.3f} ms ({CHAINS} lanes, depth {MMLT_DEPTH}; bound "
          f"{bound_mmlt[0]:.4f} ms by {bound_mmlt[1]}, "
          f"{mmlt_work['tri_tests']} ray-triangle tests); "
          f"drmlt_chain_kernel[mmlt] {ms_mmlt_chain:.3f} ms vs twin "
          f"{plain_mmlt_chain:.3f} ms, stage-2 share {share_mmlt:.4f} "
          f"({CHAINS} chains x 64 mutations at k "
          f"{MMLT_DEPTH} = {CHAINS * 64 / (ms_mmlt_chain / 1e3):.4e} "
          f"mutations/s; bound {bound_mmlt_chain[0]:.4f} ms by "
          f"{bound_mmlt_chain[1]}, {mmlt_chain_work['tri_tests']} "
          f"ray-triangle tests); whole script "
          f"{time.perf_counter() - t_start:.1f} s")

    # ---- 11-14. slice 3 -----------------------------------------------------
    s3 = slice3(name, dev, gen, fc, report)

    # ---- 15-18. slice 4 -----------------------------------------------------
    s4 = slice4(name, dev, gen, fc, report, b,
                report["slice2"]["cornell"]["b"])

    # ---- 19-22. slice 5 -----------------------------------------------------
    s5 = slice5(name, dev, gen, report)

    # ---- 23. slice 6 --------------------------------------------------------
    s6 = slice6(name, dev, gen, report, mc_refs, s5)

    # ---- 24. slice 7 --------------------------------------------------------
    s7 = slice7(name, dev, gen, report, mc_refs, s5)

    # ---- 25. slice 8 --------------------------------------------------------
    s8 = slice8(name, dev, gen, report, mc_refs, s5)

    # ---- 26. slice 9 --------------------------------------------------------
    s9 = slice9(name, dev, gen, report, mc_refs, s5)

    src = "drmlt_mitsuba_tpu_torch/csrc/"
    ref_src = "drmlt_mitsuba_tpu/ops/pallas/"

    def entry(kname, source, replaces, launched, err, ms, plain, bnd,
              library=None):
        return dict(name=kname, route="cuda", source=src + source,
                    replaces=ref_src + replaces, launches=launched,
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd[0],
                    bound_by=bnd[1], library_ms=library)

    # launches: the main path's renders of slices 1-3 and, for the trace and
    # splat kernels, phase 24's (the generic step, the CLI's new routes);
    # the intersection and splat kernels add phase 25's (the bidirectional
    # wavefront and the CLI's BDPT and thin-lens MMLT routes), and the
    # intersection, splat and path kernels phase 26's (the forward
    # renderers, the samplers, the CLI's new routes)
    kernels = [
        entry("path_trace_kernel", "path_trace.cu", "megatrace.py:1555",
              launches["path_trace"] + s7["path_trace"] + s9["path_trace"],
              path_err, ms_path, plain_path, bound_path),
        entry("drmlt_chain_kernel[path]", "drmlt_chain.cu",
              "megadrmlt.py:105", launches["drmlt_path"], chain_err,
              ms_chain, plain_chain, bound_chain),
        entry("mmlt_trace_kernel", "mmlt_trace.cu", "megammlt.py:214",
              launches2["mmlt_trace"] + s7["mmlt_trace"], mmlt_err, ms_mmlt,
              plain_mmlt, bound_mmlt),
        entry("drmlt_chain_kernel[mmlt]", "drmlt_chain.cu",
              "megadrmlt.py:105", launches2["drmlt_mmlt"], mmlt_chain_err,
              ms_mmlt_chain, plain_mmlt_chain, bound_mmlt_chain),
        # library: index_add_ of the taps
        entry("splat_add_kernel", "splat.cu", "splat_kernel.py:79",
              s3["launches"]["splat_add"] + s7["splat_add"]
              + s8["splat_add"] + s9["splat_add"], *s3["splat"]),
        entry("path_trace_rad_kernel", "path_trace_grad.cu",
              "megatrace.py:1798", s3["launches"]["path_trace_rad"],
              *s3["rad"]),
        entry("path_trace_alb_kernel", "path_trace_grad.cu",
              "megatrace.py:1943", s3["launches"]["path_trace_alb"],
              *s3["alb"]),
        # one kernel for the reference's three sweeps: its brute mode for
        # sweep_closest (intersect_kernel.py:104) and sweep_closest_v2
        # (:220), its BVH mode for sweep_clusters (bvh_kernel.py:155)
        *(entry(f"intersect_kernel[{m}]", "intersect.cu", rep,
                s4[f"intersect_{m}"]["launches"]
                + s8["intersect_by_mode"][m] + s9["intersect_by_mode"][m],
                s4[f"intersect_{m}"]["err"],
                s4[f"intersect_{m}"]["ms"], s4[f"intersect_{m}"]["plain_ms"],
                (s4[f"intersect_{m}"]["bound_ms"],
                 s4[f"intersect_{m}"]["bound_by"]))
          for m, rep in (("brute", "intersect_kernel.py:220"),
                         ("bvh", "bvh_kernel.py:155"))),
        # the walk is device code inside every trace kernel: its figures
        # are the path kernel's on the 19,586-triangle scene, its launches
        # the trace kernels' on the large-scene renders
        entry("bvh_walk (bvh.cuh, in every trace kernel)", "bvh.cuh",
              "cluster_sweep.py:327", s4["walk_launches"], s4["walk"]["err"],
              s4["walk"]["ms"], s4["walk"]["plain_ms"],
              (s4["walk"]["bound_ms"], s4["walk"]["bound_by"])),
        # slice 5: the full-scope instantiations on the const configuration
        # (phases 19-21), launched by slice 5's renders (phase 22)
        *(entry(f"{kn}[full]", src_f, rep, s5["launches"][lk + "[full]"]
                + s7[lk + "[full]"] + s9[lk + "[full]"], s5[key]["err"],
                s5[key]["ms"],
                s5[key]["plain_ms"], s5[key]["bnd"])
          for kn, src_f, rep, lk, key in (
              ("path_trace_kernel", "path_trace.cu", "megatrace.py:1555",
               "path_trace", "path"),
              ("drmlt_chain_kernel[path]", "drmlt_chain.cu",
               "megadrmlt.py:105", "drmlt_path", "chain_path"),
              ("mmlt_trace_kernel", "mmlt_trace.cu", "megammlt.py:214",
               "mmlt_trace", "mmlt"),
              ("drmlt_chain_kernel[mmlt]", "drmlt_chain.cu",
               "megadrmlt.py:105", "drmlt_mmlt", "chain_mmlt"))),
        # slice 6: the pssmlt mode (megadrmlt.py:338-350, 408-410) on the
        # 36-triangle box (phase 23a), launched by the grouped renders
        # (23b); its path-mode instantiation is checked in 23a and launched
        # by no main path, so it is not listed
        entry("drmlt_chain_kernel[mmlt,pssmlt]", "drmlt_chain.cu",
              "megadrmlt.py:105", s6["launches"]["drmlt_mmlt_pssmlt"],
              s6["err"]["mmlt"], s6["mmlt"]["ms"], s6["mmlt"]["plain_ms"],
              s6["mmlt"]["bnd"]),
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
