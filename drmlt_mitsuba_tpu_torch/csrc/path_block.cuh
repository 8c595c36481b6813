// The block loop of the compacting path kernels: a block of kPathBlock
// threads runs its paths bounce by bounce, and moves its live paths into
// its lowest warps wherever that frees a warp.  One template over the
// gradient mode: path_trace.cu's path_trace_kernel (kGradNone) and
// path_trace_grad.cu's adjoint kernels (kGradEmit, kGradAlbedo) run it.
//
// After each bounce a block counts its live paths; where moving them into
// the block's lowest threads frees at least one warp, each live path
// writes its state (PathState, 15 words, and its lane) to shared memory at
// its rank and threads 0 .. n-1 read them back, and the warps left without
// a path leave the loop (the block's barriers then count only the warps
// still in it).  A path reads its PSS dims, writes its rgb and finds its
// Jacobian rows through the lane it carries, and every bounce keeps the
// twin's expressions, so the output is bit for bit that of one path per
// thread.
#pragma once
#include "path_trace.cuh"

namespace drmlt {

constexpr int kPathBlock = 256;   // 256 beat 128 on the full scope (PERF.md §6)
constexpr int kPathWarps = kPathBlock / 32;
constexpr int kLaneBlock = 128;   // the one-path-per-thread kernels' block

// A block's paths while they move between threads: the 15 words of a
// PathState and its lane, word-major (a warp's 32 accesses to one word
// fall on 32 banks), and each warp's live count, double-buffered by bounce
// parity so that a bounce's counts are written only after every thread
// has read the last-but-one's.
struct PathSlots {
  float w[16][kPathBlock];
  int warp_n[2][kPathWarps];
};

// Where the Jacobian rows of a block's lanes live: lane l's GradRows start
// at rows + (l - first) and pw + (l - first), with the given stride (a
// column of the block's shared array, first = the block's first lane; or
// of the output and the scratch, first = 0).  Unused without a gradient.
struct GradCols {
  float* rows;
  float* pw;
  long stride;
  int first;
  __device__ __forceinline__ GradRows at(int lane) const {
    return GradRows{rows + (lane - first), pw + (lane - first), stride};
  }
};

__device__ __forceinline__ PssView lane_view(const float* uT, int lane, int R) {
  return PssView{uT + lane, nullptr, nullptr, (long)R, 0};
}

__device__ __forceinline__ void put_rgb(float* out, int R, int lane, V3 L) {
  out[lane] = L.x;
  out[R + lane] = L.y;
  out[2 * (long)R + lane] = L.z;
}

__device__ __forceinline__ void put_state(PathSlots& sh, int k, int lane, const PathState& s) {
  const float v[16] = {s.o.x,  s.o.y,  s.o.z,  s.d.x,        s.d.y,        s.d.z,
                       s.tp.x, s.tp.y, s.tp.z, s.L.x,        s.L.y,        s.L.z,
                       s.prev_pdf, s.eta_scale, s.prev_delta ? 1.0f : 0.0f, __int_as_float(lane)};
  for (int j = 0; j < 16; ++j) sh.w[j][k] = v[j];
}

__device__ __forceinline__ int get_state(const PathSlots& sh, int k, PathState* s) {
  s->o = v3(sh.w[0][k], sh.w[1][k], sh.w[2][k]);
  s->d = v3(sh.w[3][k], sh.w[4][k], sh.w[5][k]);
  s->tp = v3(sh.w[6][k], sh.w[7][k], sh.w[8][k]);
  s->L = v3(sh.w[9][k], sh.w[10][k], sh.w[11][k]);
  s->prev_pdf = sh.w[12][k];
  s->eta_scale = sh.w[13][k];
  s->prev_delta = sh.w[14][k] != 0.0f;
  return __float_as_int(sh.w[15][k]);
}

// Barrier 1 over the block's first n threads (a multiple of 32): the warps
// in the bounce loop; those that have left it do not take part.
__device__ __forceinline__ void bar_warps(int n) {
  asm volatile("bar.sync 1, %0;" ::"r"(n) : "memory");
}

// The paths of this block, lanes blockIdx.x * kPathBlock + [0,
// kPathBlock) below R, each to its end: rgb into out (3, R), in a gradient
// mode the rows into `cols`.  Returns when this thread's warp leaves the
// loop; the caller's code after it runs once every path of the warp's
// block has moved on or ended only after a barrier (__syncthreads).
template <int G, bool X>
__device__ __forceinline__ void path_block(const TabT<X>& tb, const float* __restrict__ uT,
                                           int R, float* __restrict__ out, PathSlots& sh,
                                           const GradCols& cols) {
  const int t = threadIdx.x, wl = t & 31, w = t >> 5;
  int lane = blockIdx.x * kPathBlock + t;
  bool live = lane < R;
  PathState s;
  if (live) s = path_start<X>(tb, lane_view(uT, lane, R));
  int nw = kPathWarps;   // the warps in the loop: threads [0, 32 nw)
  for (int depth = 1; depth <= tb.max_depth; ++depth) {
    GradRows g{};
    if constexpr (G != kGradNone) g = cols.at(lane);
    if (live && !bounces<G, X>(tb, lane_view(uT, lane, R), g, s, depth, depth)) {
      put_rgb(out, R, lane, s.L);
      live = false;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    int* wn = sh.warp_n[depth & 1];
    if (wl == 0) wn[w] = __popc(bal);
    bar_warps(32 * nw);
    int n = 0, off = 0, busy = 0;
    for (int i = 0; i < nw; ++i) {
      const int k = wn[i];
      off += i < w ? k : 0;
      n += k;
      busy += k > 0 ? 1 : 0;
    }
    if (n == 0) return;
    const int nw_c = (n + 31) >> 5;
    if (nw_c < busy) {   // compacting frees at least one warp
      if (live) put_state(sh, off + __popc(bal & ((1u << wl) - 1u)), lane, s);
      bar_warps(32 * nw);
      nw = nw_c;
      if (w >= nw) return;
      live = t < n;
      if (live) lane = get_state(sh, t, &s);
    }
  }
  if (live) put_rgb(out, R, lane, s.L);   // max_depth < 1: no bounce ran
}

}  // namespace drmlt
