// drmlt_chain_kernel<Trace, Pss>: n_mut whole DRMLT mutations per chain,
// one thread per chain.  The trace body is the first template parameter:
// PathTrace (the unidirectional path technique, path_trace.cuh) or
// MmltTrace (a fixed-depth MMLT group, mmlt_trace.cuh).  Proposals, the
// three acceptance types, the sampled and three-state splats, the stats and
// the Philox / uniforms modes are shared by both.
//
// Replaces the reference's Pallas kernel
// drmlt_mitsuba_tpu/ops/pallas/megadrmlt.py:_mega_drmlt_kernel (:105,
// built by make_mega_drmlt :504) with technique="path" and
// technique="mmlt", each with pssmlt False and True.  Each trace body has
// the two scene-scope instantiations of path_trace.cu (slices 1-4, and the
// full scope), and each of those the two modes, so eight kernels in all;
// the path mode also takes an image environment, which the reference's
// path mode leaves to XLA (megadrmlt.py:474).  Plain twin:
// ops/megadrmlt.py:drmlt_chain_step_reference, which also documents the
// uniform order, the state / film / stats layouts and the acceptance rules
// (megadrmlt.py:264-435).
//
// Pss (the reference's pssmlt=True, megadrmlt.py:338-350, 408-410): stage
// 1 only.  Nothing reads the z proposal (it would only feed an a2 that the
// mode forces to 0), so its uniforms are passed over, not drawn: both modes
// keep the same draw indices, and neither z nor green's reverse path y* is
// built or traced; y is accepted by Metropolis and the splat is Veach's
// two-state expected value, x at 1 - a1 and y at a1 (or one of them picked
// by those weights in the sampled mode).  a2 and accept2 stay 0.
//
// In mmlt mode (megadrmlt.py:158-190, 280-330, 367): the trace reads the
// pinned depth dim u_depth = 1 - 0.5/k before the chain's dims and its
// value is scaled by 1/k; chain dim 0 (the strategy) is frozen on small
// steps in both stages and skipped by mira's q-ratio; with
// fix_emitter_path, stage 2 is the identity on the light-walk dims
// [em_lo, em_hi) unless the chain's current strategy is light tracing.
//
// What bounds it on an H100: the traces (see path_trace.cu and
// mmlt_trace.cu: divergent, latency-bound per-thread work): y for every
// chain, z only for the chains that run stage 2 (y rejected, and the step
// small unless timid), and green's reverse path y* only for those whose z
// carries light.  The TPU kernel traces z and y* on every lane, masked; a
// per-thread branch would save nothing here either, since nearly every warp
// holds some stage-2 chain.  So each block gathers its stage-2 chains into a
// list in shared memory and traces them on its first threads, in full warps
// (the kernel's phases are described above it).  The proposal arithmetic
// is O(D) per mutation and the splat is 1 or 3 atomicAdds of 3 floats.
// With D up to 76 the per-chain arrays x, y_raw and z_raw would spill from
// registers to local memory, so
//   * x lives in the chain state (D+6, C) itself, updated in place,
//   * y_raw and z_raw live in a dim-major global scratch (2D, C),
// and the trace reads its PSS dims from there through a stride (PssView),
// wrapping on the fly; neighbouring threads touch neighbouring floats, and
// at C = 65536 state plus scratch (~62 MB at D = 76, ~30 MB at D = 36)
// mostly stay in the 50 MB L2.  The TPU kernel keeps the same arrays in
// VMEM tiles.
//
// Not carried over from the TPU kernel: the bf16 hi/lo one-hot matmul
// splat and its rec_ref ring buffer (atomicAdd into the film instead), and
// the shape gates n_chains % 2048, H % 8, W % 128.  Stats are kept per
// chain (6, C) and summed by the caller, which keeps them deterministic.
//
// Uniforms come either from an input array (n_mut * n_rand, C) read in the
// twin's order, or from a counter-based Philox4x32-10: draw j of mutation
// m of chain c is word j % 4 of Philox(counter = (c, m, j / 4, 0),
// key = (seed, launch)), kept to its top 23 bits (core/rng.py is the
// twin).
#include "mmlt_trace.cuh"

namespace drmlt {

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0, uint32_t k1) {
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// The uniforms of one chain, drawn in order.
struct Draws {
  const float* uni;   // (n_mut * n_rand, C) or null
  long C;
  int c, n_rand, m, j;
  uint32_t seed, launch;
  uint32_t w[4];

  __device__ void start(int m_) {
    m = m_;
    j = 0;
  }
  // Philox's four words for draws 4b .. 4b + 3
  __device__ void block(int b) {
    w[0] = (uint32_t)c;
    w[1] = (uint32_t)m;
    w[2] = (uint32_t)b;
    w[3] = 0u;
    philox4x32_10(w, seed, launch);
  }
  __device__ float next() {
    float r;
    if (uni) {
      r = uni[((long)m * n_rand + j) * C + c];
    } else {
      if ((j & 3) == 0) block(j >> 2);
      r = (float)(w[j & 3] >> 9) * 1.1920928955078125e-07f;   // 2^-23
    }
    ++j;
    return r;
  }
  // Pass over n draws: the next draw is the one after them.  Its words are
  // drawn here when it falls inside a group of four that the cache does not
  // hold (a draw at a group's start draws its own).
  __device__ void skip(int n) {
    const int last = j - 1;   // the last draw taken (-1: none)
    j += n;
    if (!uni && (j & 3) != 0 && (j >> 2) != (last >> 2)) block(j >> 2);
  }
};

struct ChainArgs {
  float* state;      // (D + 6, C)
  float* scratch;    // (2D, C): y_raw rows, then z_raw rows
  float* film;       // (H, W, 3)
  float* stats;      // (6, C)
  int D, C, H, W, n_mut, drtype, sampled, timid;
  int fix_em;        // mmlt fix_emitter_path: stage 2 keeps [em_lo, em_hi)
  int em_lo, em_hi, k_depth;
  float p_large, s1, s2, log_ratio, sig2, disp;
};

enum { kOrbital = 0, kGreen = 1, kMira = 2 };

__device__ __forceinline__ float metropolis_clamp(float r) {
  return (isfinite(r) && r >= 0.0f) ? fminf(r, 1.0f) : 0.0f;
}

__device__ __forceinline__ float kelemen_sample(float u, float s2, float log_ratio) {
  float sign = u < 0.5f ? 1.0f : -1.0f;
  float x = u < 0.5f ? 2.0f * u : 2.0f * (u - 0.5f);
  return sign * (s2 * expf((1.0f - x) * log_ratio));
}

// -inf outside [s1, s2] (integrators/kernels.py:Kelemen.log_pdf says why)
__device__ __forceinline__ float kelemen_log_pdf(float du, float s1, float s2, float log_ratio) {
  float d = fabsf(du);
  bool ok = d >= s1 && d <= s2;
  float p = 1.0f / (2.0f * fmaxf(d, 1e-20f) * (-log_ratio));
  return logf(ok ? p : 0.0f);
}

// A traced proposal: non-finite or negative lum becomes 0 and the stored
// value is rgb / lum (unit luminance); px, py its film position.
struct Traced {
  float lum, r, g, b, px, py;
};

__device__ __forceinline__ Traced finish(V3 L, float px, float py) {
  float l = lum(L);
  l = (isfinite(l) && l >= 0.0f) ? l : 0.0f;
  float li = l > 0.0f ? 1.0f / fmaxf(l, 1e-30f) : 0.0f;
  return {l, L.x * li, L.y * li, L.z * li, px, py};
}

// The path technique: the film position is PSS dims 0-1.  X: the full
// scene scope (path_trace.cuh).
template <bool X>
struct PathTrace {
  static constexpr bool kMmlt = false;
  TabT<X> tb;
  __device__ Traced operator()(const PssView& v) const {
    return finish(trace_path<X>(tb, v), v(0), v(1));
  }
};

// A depth-k MMLT group: the pinned depth dim precedes the chain's dims,
// and 1/k undoes the kernel's uniform depth pmf.
template <bool X>
struct MmltTrace {
  static constexpr bool kMmlt = true;   // chain dim 0 is the strategy
  TabT<X> tb;
  MmltCfg mc;
  float u_depth, inv_k;

  struct Shifted {
    const PssView& v;
    float u0;
    __device__ float operator()(int j) const { return j == 0 ? u0 : v(j - 1); }
  };

  __device__ Traced operator()(const PssView& v) const {
    const MmltOut r = trace_mmlt<X>(tb, mc, Shifted{v, u_depth});
    return finish(r.value * inv_k, r.px, r.py);
  }
};

// Add rgb * w at pixel (floor(px W), floor(py H)); a position of exactly
// 1.0 after the wrap falls outside the image and is dropped.
__device__ __forceinline__ void splat(const ChainArgs& a, const Traced& s, float w) {
  float xi = floorf(s.px * (float)a.W);
  float yi = floorf(s.py * (float)a.H);
  if (xi >= 0.0f && xi < (float)a.W && yi >= 0.0f && yi < (float)a.H) {
    float* f = a.film + ((long)yi * a.W + (long)xi) * 3;
    atomicAdd(f, s.r * w);
    atomicAdd(f + 1, s.g * w);
    atomicAdd(f + 2, s.b * w);
  }
}

// Threads per block, and the blocks an SM keeps resident: together they
// cap the registers at 65536 / (kChainBlock * kChainMinBlocks) = 128.  Above
// 128 registers an SM holds fewer blocks, and the latency-bound traces lose
// warps to hide it.  A larger block gathers its stage-2 traces from more
// chains, so fewer warps run part-empty, but waits at each barrier for the
// slowest of more y traces: on an H100, 256 threads ran faster than 128 in
// the DRMLT modes, by up to 28% on the full scope, though the subset's path
// mode has gone either way by up to 3% (scripts/chain_kernel_ab.py with a
// copy of csrc/ whose kChainBlock is 128, PERF.md).  The pssmlt mode has no
// barrier, but 256 suits it too: over four A/B runs of its eight
// configurations, 256 was ahead in 29 of 32 comparisons, by up to 1.23%,
// and behind by at most 0.22% in the other three.
constexpr int kChainBlock = 256;
constexpr int kChainMinBlocks = 65536 / (kChainBlock * 128);
constexpr int kChainWarps = kChainBlock / 32;

// A block's stage-2 work list and results, indexed by thread (chain); and
// each chain's y trace during phase 2 and its stats, which would otherwise
// hold twelve registers through the traces (the subset's path
// instantiation spilled at the 128-register cap).
struct Stage2 {
  int list[kChainBlock];     // the threads whose chain has a trace to run
  int warp_n[kChainWarps];   // list entries per warp
  Traced tz[kChainBlock];    // the z traces
  float lum_rev[kChainBlock];  // green: the y* traces' luminance
  Traced ty[kChainBlock];    // the chain's own y trace
  float st[6][kChainBlock];  // a1, a2, accept1, accept2, large, moved
};

// The block's shared memory in DRMLT mode; the pssmlt mode takes none.
__device__ __forceinline__ Stage2& stage2_block() {
  __shared__ Stage2 s;
  return s;
}

// Write the threads of the block whose `flag` holds to s.list[0, n), in
// thread order, and return n: a ballot and a count per warp, and one offset
// per warp.  Every thread of the block calls it; it synchronises the block
// twice.
__device__ __forceinline__ int gather(bool flag, Stage2& s) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const unsigned bal = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) s.warp_n[w] = __popc(bal);
  __syncthreads();
  int off = 0, n = 0;
  for (int i = 0; i < kChainWarps; ++i) {
    const int k = s.warp_n[i];
    off += i < w ? k : 0;
    n += k;
  }
  if (flag) s.list[off + __popc(bal & ((1u << lane) - 1u))] = t;
  __syncthreads();
  return n;
}

// A mutation runs in three phases.  (1) Each thread, for its own chain: every
// uniform in the twin's order, y and z in the scratch, the y trace, stage 1
// and do_second.  (2) The block gathers the chains that run stage 2 into a
// list, and threads 0 .. n-1 trace their z, each reading its chain's column
// of the scratch, so the traces run in full warps rather than on the few
// lanes of each warp whose chain needs one; green then gathers the chains
// whose z carries light and traces their y*.  A chain that skips stage 2 has
// a2 = 0, so its z was never splatted with weight nor selected: its results
// are those of a kernel that traces every z.  (3) Each thread finishes its
// own chain: stage-2 acceptance, splat, select, stats.  Another thread's
// trace reads a chain's scratch (and for y*, its x), which the chain writes
// only in phases 1 and 3, after the barrier that ends phase 2.  A thread
// past the last chain takes part in every barrier and ballot.  The pssmlt
// mode has no stage 2, no barrier and no shared memory.
template <class Trace, bool Pss>
__global__ void __launch_bounds__(kChainBlock, kChainMinBlocks)
    drmlt_chain_kernel(Trace trace, ChainArgs a, const float* __restrict__ uni, int n_rand,
                       uint32_t seed, uint32_t launch) {
  const int t = threadIdx.x;
  const int c = blockIdx.x * blockDim.x + t;
  if (Pss && c >= a.C) return;
  const bool live = Pss || c < a.C;
  const long C = a.C;
  const int D = a.D;
  float* x = a.state + c;            // row d at x[d * C]
  float* yr = a.scratch + c;         // y_raw row d at yr[d * C]
  float* zr = a.scratch + D * C + c; // z_raw row d at zr[d * C]
  // mmlt: chain dim 0 (the strategy) moves on large steps only; a
  // compile-time flag, so the path instantiation carries none of it
  constexpr bool frozen0 = Trace::kMmlt;

  Traced cur{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    cur = {x[D * C],       x[(D + 3) * C], x[(D + 4) * C],
           x[(D + 5) * C], x[(D + 1) * C], x[(D + 2) * C]};
  }
  float st[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};   // pssmlt mode
  if constexpr (!Pss) {
    for (int s = 0; s < 6; ++s) stage2_block().st[s][t] = 0.0f;
  }
  Draws dr{uni, C, c, n_rand, 0, 0, seed, launch, {0u, 0u, 0u, 0u}};

  for (int m = 0; m < a.n_mut; ++m) {
    // ======== phase 1: this thread's chain
    bool large = false, accept1 = false, do_second = false;
    float coin2 = 0.0f, u_sel = 0.0f, a1 = 0.0f;
    Traced ty{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (live) {
      dr.start(m);
      // ---- stage 1: large-step coin, D large-step uniforms, Kelemen steps
      large = dr.next() < a.p_large;
      for (int d = 0; d < D; ++d) yr[d * C] = dr.next();
      if (a.drtype == kOrbital) {
        const int P = D / 2;
        for (int p = 0; p < P; ++p) zr[p * C] = dr.next();   // radius uniforms
        for (int p = 0; p < P; ++p) {
          float u_ang = dr.next();
          if (!large) {
            float r = kelemen_sample(zr[p * C], a.s2, a.log_ratio);
            float ang = u_ang * kTwoPi;
            float du0 = r * cosf(ang), du1 = r * sinf(ang);
            if (frozen0 && p == 0) du0 = 0.0f;
            yr[2 * p * C] = x[2 * p * C] + du0;
            yr[(2 * p + 1) * C] = x[(2 * p + 1) * C] + du1;
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          float u_k = dr.next();
          if (!large) {
            float du = (frozen0 && d == 0) ? 0.0f : kelemen_sample(u_k, a.s2, a.log_ratio);
            yr[d * C] = x[d * C] + du;
          }
        }
      }
      // ---- stage 2: orbital rotates the UNWRAPPED y - x about y by a
      // wrapped-Cauchy angle; green / mira take a small Gaussian step from x.
      // The pssmlt mode never reads z: it passes over z's uniforms.
      if constexpr (Pss) {
        dr.skip(a.drtype == kOrbital ? D / 2 : 2 * D);
      } else if (a.drtype == kOrbital) {
        for (int p = 0; p < D / 2; ++p) {
          float u = dr.next();
          float sign = u < 0.5f ? 1.0f : -1.0f;
          float xx = u < 0.5f ? 2.0f * u : 2.0f * (u - 0.5f);
          float v = cosf(kTwoPi * xx);
          float cth = fminf(fmaxf((v + a.disp) / (1.0f + a.disp * v), -1.0f), 1.0f);
          float sth = sign * sqrtf(fmaxf(1.0f - cth * cth, 0.0f));
          float y0 = yr[2 * p * C], y1 = yr[(2 * p + 1) * C];
          float du0 = y0 - x[2 * p * C];
          float du1 = y1 - x[(2 * p + 1) * C];
          zr[2 * p * C] = y0 - cth * du0 + sth * du1;
          zr[(2 * p + 1) * C] = y1 - sth * du0 - cth * du1;
        }
      } else {
        for (int d = 0; d < D; ++d) zr[d * C] = dr.next();   // Box-Muller u1
        for (int d = 0; d < D; ++d) {
          float u2 = dr.next();
          float r = sqrtf(-2.0f * logf(fmaxf(1.0f - zr[d * C], 1e-38f)));
          zr[d * C] = x[d * C] + r * cosf(kTwoPi * u2) * a.sig2;
        }
      }
      if (!Pss && frozen0) zr[0] = x[0];
      if (!Pss && Trace::kMmlt && a.fix_em) {
        // identity on the light-walk dims unless light tracing (s == k)
        float s_cur = fminf(floorf(x[0] * (float)(a.k_depth + 1)), (float)a.k_depth);
        if (s_cur != (float)a.k_depth) {
          for (int d = a.em_lo; d < a.em_hi; ++d) zr[d * C] = x[d * C];
        }
      }
      const float coin1 = dr.next();
      coin2 = dr.next();
      // the pssmlt mode draws it after its trace: drawn here, it cost that
      // mode's <MmltTrace> 8 B of spills
      if (!Pss && a.sampled) u_sel = dr.next();

      ty = trace(PssView{yr, nullptr, nullptr, C, 1});
      a1 = metropolis_clamp(ty.lum / fmaxf(cur.lum, 1e-30f));
      accept1 = coin1 < a1;
      do_second = !Pss && !accept1 && (a.timid || !large);
    }

    // ======== phase 2: the block's stage-2 traces, in full warps
    Traced tz{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    float lum_rev = 0.0f;
    if constexpr (!Pss) {
      Stage2& sh = stage2_block();
      const long base = (long)blockIdx.x * blockDim.x;
      sh.ty[t] = ty;
      const int n = gather(do_second, sh);
      if (t < n) {
        const int j = sh.list[t];
        sh.tz[j] = trace(PssView{a.scratch + D * C + base + j, nullptr, nullptr, C, 1});
      }
      __syncthreads();
      if (do_second) tz = sh.tz[t];
      if (a.drtype == kGreen) {
        // the reverse path y* = z - (y - x) of the chains whose z carries
        // light (elsewhere a2 is 0 whatever y* gives)
        const bool rev = do_second && tz.lum > 0.0f;
        const int n2 = gather(rev, sh);
        if (t < n2) {
          const int j = sh.list[t];
          sh.lum_rev[j] = trace(PssView{a.scratch + D * C + base + j, a.scratch + base + j,
                                        a.state + base + j, C, 2}).lum;
        }
        __syncthreads();
        if (rev) lum_rev = sh.lum_rev[t];
      }
      ty = sh.ty[t];
    }
    if (!live) continue;

    // ======== phase 3: this thread's chain
    // ---- stage-2 acceptance (a2 = 0 where stage 2 does not run)
    float a2 = 0.0f;
    bool accept2 = false;
    if (do_second) {
      const float lum_ratio = tz.lum / fmaxf(cur.lum, 1e-30f);
      if (a.drtype == kOrbital) {
        if (tz.lum < ty.lum) {
          a2 = 0.0f;
        } else if (tz.lum >= cur.lum) {
          a2 = 1.0f;
        } else {
          float den = cur.lum - ty.lum;
          a2 = metropolis_clamp((tz.lum - ty.lum) / (fabsf(den) > 0.0f ? den : 1.0f));
        }
      } else if (a.drtype == kMira) {
        float a_rev = metropolis_clamp(ty.lum / fmaxf(tz.lum, 1e-30f));
        float lq = 0.0f;
        for (int d = frozen0 ? 1 : 0; d < D; ++d) {
          float y = yr[d * C];
          lq = lq + (kelemen_log_pdf(zr[d * C] - y, a.s1, a.s2, a.log_ratio) -
                     kelemen_log_pdf(x[d * C] - y, a.s1, a.s2, a.log_ratio));
        }
        float q_ratio = large ? 1.0f : expf(lq);
        a2 = metropolis_clamp(lum_ratio * q_ratio * (1.0f - a_rev) / fmaxf(1.0f - a1, 1e-12f));
        if (a_rev >= 1.0f) a2 = 0.0f;
        if (!isfinite(q_ratio)) a2 = 0.0f;
      } else {
        float a_rev = metropolis_clamp(lum_rev / fmaxf(tz.lum, 1e-30f));
        a2 = metropolis_clamp(lum_ratio * (1.0f - a_rev) / fmaxf(1.0f - a1, 1e-12f));
        if (a_rev >= 1.0f) a2 = 0.0f;
      }
      if (!(tz.lum > 0.0f)) a2 = 0.0f;
      accept2 = coin2 < a2;
    }

    // ---- splat: three-state weights (Pss: two), or one state picked by
    // its weight
    const float w_y = a1;
    const float w_z = (1.0f - a1) * a2;
    const float w_x = 1.0f - w_y - w_z;
    if (a.sampled) {
      if (Pss) u_sel = dr.next();
      bool pick_y = u_sel < w_y;
      bool pick_z = !Pss && !pick_y && (u_sel < w_y + w_z);
      // one call per state: passing the picked struct (pick_y ? ty : ...)
      // kept the three in the stack frame (ptxas: 256 bytes against 192)
      if (pick_y) {
        splat(a, ty, 1.0f);
      } else if (pick_z) {
        splat(a, tz, 1.0f);
      } else {
        splat(a, cur, 1.0f);
      }
    } else {
      splat(a, cur, w_x);
      splat(a, ty, w_y);
      // w_z is 0 where stage 2 did not run: nothing to add
      if (do_second) splat(a, tz, w_z);
    }

    // ---- state select: accept1 wins, then accept2
    const bool a2m = accept2 && !accept1;
    if (accept1) {
      for (int d = 0; d < D; ++d) x[d * C] = pss_wrap(yr[d * C]);
      cur = ty;
    } else if (a2m) {
      for (int d = 0; d < D; ++d) x[d * C] = pss_wrap(zr[d * C]);
      cur = tz;
    }
    const float inc[6] = {a1,
                          a2,
                          accept1 ? 1.0f : 0.0f,
                          accept2 ? 1.0f : 0.0f,
                          large ? 1.0f : 0.0f,
                          (accept1 || a2m) ? 1.0f : 0.0f};
    for (int s = 0; s < 6; ++s) {
      if constexpr (Pss) {
        st[s] += inc[s];
      } else {
        stage2_block().st[s][t] += inc[s];
      }
    }
  }

  if (!live) return;
  x[D * C] = cur.lum;
  x[(D + 1) * C] = cur.px;
  x[(D + 2) * C] = cur.py;
  x[(D + 3) * C] = cur.r;
  x[(D + 4) * C] = cur.g;
  x[(D + 5) * C] = cur.b;
  for (int s = 0; s < 6; ++s) {
    if constexpr (Pss) {
      a.stats[s * C + c] += st[s];
    } else {
      a.stats[s * C + c] += stage2_block().st[s][t];
    }
  }
}

template <class Trace>
static int launch_chain(const Trace& trace, const ChainArgs& a, const float* uniforms,
                        int n_rand, uint32_t seed, uint32_t launch, bool pss,
                        cudaStream_t stream) {
  const int block = kChainBlock;
  int grid = (a.C + block - 1) / block;
  if (grid > 0) {
    if (pss) {
      drmlt_chain_kernel<Trace, true>
          <<<grid, block, 0, stream>>>(trace, a, uniforms, n_rand, seed, launch);
    } else {
      drmlt_chain_kernel<Trace, false>
          <<<grid, block, 0, stream>>>(trace, a, uniforms, n_rand, seed, launch);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace drmlt

// technique 0 = path (max/min/rr depth and use_nee of the PathConfig),
// 1 = mmlt (max_depth = the group's k; light_image, eye_dims, light_dims of
// its BDPTConfig); pssmlt != 0 selects the stage-1-only instantiation.
extern "C" int drmlt_chain_launch(const float* tri, int n_tris, const float* mat, int n_mats,
                                  const float* em, int n_ems, const float* cam, const float* node,
                                  const float* rec, int n_nodes,
                                  DRMLT_EXT_PARAMS, int technique,
                                  int max_depth, int min_depth, int rr_depth, int use_nee,
                                  int light_image, int eye_dims, int light_dims, float* state,
                                  float* scratch, int D, int C, float* film, int H, int W,
                                  float* stats, const float* uniforms, int n_rand, int n_mut,
                                  uint32_t seed, uint32_t launch, int drtype, int sampled,
                                  int timid, int fix_emitter_path, int pssmlt, float p_large,
                                  float s1, float s2, float log_ratio, float sig2, float disp,
                                  float u_depth, float inv_k, void* stream) {
  const bool mmlt = technique == 1;
  if (mmlt && (max_depth < 1 || max_depth > drmlt::kMaxMmltDepth)) {
    return (int)cudaErrorInvalidValue;
  }
  drmlt::Tables tb{tri, mat, em, cam, n_tris, n_mats, n_ems,
                   max_depth, min_depth, rr_depth, use_nee};
  drmlt::set_bvh(tb, node, rec, n_nodes);
  const int em_lo = 1 + eye_dims;
  drmlt::ChainArgs a{state, scratch, film, stats, D, C, H, W, n_mut, drtype, sampled, timid,
                     (mmlt && fix_emitter_path) ? 1 : 0, em_lo,
                     em_lo + light_dims, max_depth, p_large, s1, s2, log_ratio, sig2, disp};
  cudaStream_t st = (cudaStream_t)stream;
  const bool pss = pssmlt != 0;
  const drmlt::MmltCfg mc{max_depth, light_image, eye_dims};
  if (full) {
    const drmlt::TablesX tx = drmlt::with_ext(tb, DRMLT_EXT_ARGS);
    if (mmlt) {
      return drmlt::launch_chain(drmlt::MmltTrace<true>{tx, mc, u_depth, inv_k}, a, uniforms,
                                 n_rand, seed, launch, pss, st);
    }
    return drmlt::launch_chain(drmlt::PathTrace<true>{tx}, a, uniforms, n_rand, seed, launch,
                               pss, st);
  }
  if (mmlt) {
    return drmlt::launch_chain(drmlt::MmltTrace<false>{tb, mc, u_depth, inv_k}, a, uniforms,
                               n_rand, seed, launch, pss, st);
  }
  return drmlt::launch_chain(drmlt::PathTrace<false>{tb}, a, uniforms, n_rand, seed, launch,
                             pss, st);
}
