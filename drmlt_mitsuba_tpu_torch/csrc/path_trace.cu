// path_trace_kernel: one whole unidirectional path per lane, the paths of
// a block compacted into full warps between bounces.
//
// Replaces the reference's Pallas megakernel
// drmlt_mitsuba_tpu/ops/pallas/megatrace.py:_mega_kernel (:1555, built by
// make_mega_trace :2099), which the bootstrap luminance pass, the initial
// chain state and the host PSSMLT loop run through.  Plain twin:
// ops/megatrace.py:path_trace_reference.
//
// What bounds it on an H100: instruction issue.  Each lane sweeps every
// triangle (or walks the BVH) twice per bounce (closest hit + shadow),
// about 60 FP32 instructions a triangle test, and the reads are a few
// bytes of PSS dims per bounce plus the scene tables, which every thread
// of a warp reads at the same address (a broadcast from L1).  Paths end at
// different depths (escaping through an open side, a black BSDF sample,
// Russian roulette, max_depth), and a warp of one path per thread runs as
// many bounces as its longest path: on the box at depth 8, 2,048 warps of
// 65,536 lanes run 16,384 warp-bounces for 9,823 warps' worth of path
// bounces (ops/megatrace.py:warp_bounces, counted by the twin).
//
// Design: a block of kPathBlock threads runs its paths bounce by bounce.
// After each bounce it counts its live paths; where moving them into the
// block's lowest threads frees at least one warp, each live path writes
// its state (PathState, 16 words with its lane) to shared memory at its
// rank and threads 0 .. n-1 read them back, and the warps left without a
// path leave the loop (the block's barriers then count only the warps
// still in it).  A path reads its PSS dims and writes its rgb through the
// lane it carries, and every bounce keeps the twin's expressions, so the
// output is bit for bit that of one path per thread (`path_lane_kernel`,
// the design before compaction).  A scene with a BVH keeps one path per
// thread: there a bounce's cost varies from warp to warp with the length
// of its walks, and the block's barrier at every bounce cost more than the
// warps that compaction freed (cornell_large.xml at depth 8: 1.30 ms
// against 1.02 ms, PERF.md).
// PSS dims are dim-major (uT is (n_dims, R)); rgb is (3, R).  Two
// instantiations: the scene subset of slices 1-4 (X = false) and the full
// scene scope (X = true: spheres, bitmap albedo, the environment, the thin
// lens, the conductor and null kinds).
#include "path_trace.cuh"

namespace drmlt {

constexpr int kPathBlock = 256;   // 256 beat 128 on the full scope (PERF.md §6)
constexpr int kPathWarps = kPathBlock / 32;
constexpr int kLaneBlock = 128;   // path_lane_kernel's block

// A block's paths while they move between threads: the 15 words of a
// PathState<kGradNone> and its lane, word-major (a warp's 32 accesses to
// one word fall on 32 banks), and each warp's live count, double-buffered
// by bounce parity so that a bounce's counts are written only after every
// thread has read the last-but-one's.
struct PathSlots {
  float w[16][kPathBlock];
  int warp_n[2][kPathWarps];
};

__device__ __forceinline__ PssView lane_view(const float* uT, int lane, int R) {
  return PssView{uT + lane, nullptr, nullptr, (long)R, 0};
}

__device__ __forceinline__ void put_rgb(float* out, int R, int lane, V3 L) {
  out[lane] = L.x;
  out[R + lane] = L.y;
  out[2 * (long)R + lane] = L.z;
}

__device__ __forceinline__ void put_state(PathSlots& sh, int k, int lane,
                                          const PathState<kGradNone>& s) {
  const float v[16] = {s.o.x,  s.o.y,  s.o.z,  s.d.x,        s.d.y,        s.d.z,
                       s.tp.x, s.tp.y, s.tp.z, s.L.x,        s.L.y,        s.L.z,
                       s.prev_pdf, s.eta_scale, s.prev_delta ? 1.0f : 0.0f, __int_as_float(lane)};
  for (int j = 0; j < 16; ++j) sh.w[j][k] = v[j];
}

__device__ __forceinline__ int get_state(const PathSlots& sh, int k, PathState<kGradNone>* s) {
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

template <bool X>
__global__ void __launch_bounds__(kPathBlock)
    path_trace_kernel(TabT<X> tb, const float* __restrict__ uT, int R, float* __restrict__ out) {
  __shared__ PathSlots sh;
  const int t = threadIdx.x, wl = t & 31, w = t >> 5;
  int lane = blockIdx.x * kPathBlock + t;
  bool live = lane < R;
  PathState<kGradNone> s;
  if (live) s = path_start<kGradNone, X>(tb, lane_view(uT, lane, R));
  int nw = kPathWarps;   // the warps in the loop: threads [0, 32 nw)
  for (int depth = 1; depth <= tb.max_depth; ++depth) {
    if (live && !bounces<kGradNone, X>(tb, lane_view(uT, lane, R), GradRows{nullptr, 0}, s,
                                       depth, depth)) {
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

// One path per thread to its end: the kernel before compaction, which
// scenes with a BVH launch, and whose output path_trace_kernel must equal
// bit for bit (the GPU tests, chip_smoke phases 3, 6 and 19,
// scripts/chain_kernel_ab.py).
template <bool X>
__global__ void path_lane_kernel(TabT<X> tb, const float* __restrict__ uT, int R,
                                 float* __restrict__ out) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= R) return;
  put_rgb(out, R, lane, trace_path<X>(tb, lane_view(uT, lane, R)));
}

}  // namespace drmlt

// compact 1 (every caller of the port): path_trace_kernel, or on a scene
// with a BVH path_lane_kernel; 0: path_lane_kernel.
extern "C" int path_trace_launch(const float* tri, int n_tris, const float* mat, int n_mats,
                                 const float* em, int n_ems, const float* cam, const float* node,
                                 const float* rec, int n_nodes, DRMLT_EXT_PARAMS, int max_depth,
                                 int min_depth, int rr_depth, int use_nee, int compact,
                                 const float* uT, int R, float* out, void* stream) {
  drmlt::Tables tb{tri, mat, em, cam, n_tris, n_mats, n_ems,
                   max_depth, min_depth, rr_depth, use_nee};
  drmlt::set_bvh(tb, node, rec, n_nodes);
  compact = compact && n_nodes == 0;
  const int block = compact ? drmlt::kPathBlock : drmlt::kLaneBlock;
  const int grid = (R + block - 1) / block;
  cudaStream_t st = (cudaStream_t)stream;
  if (grid == 0) return (int)cudaGetLastError();
  if (full) {
    const drmlt::TablesX tx = drmlt::with_ext(tb, DRMLT_EXT_ARGS);
    if (compact) {
      drmlt::path_trace_kernel<true><<<grid, block, 0, st>>>(tx, uT, R, out);
    } else {
      drmlt::path_lane_kernel<true><<<grid, block, 0, st>>>(tx, uT, R, out);
    }
  } else if (compact) {
    drmlt::path_trace_kernel<false><<<grid, block, 0, st>>>(tb, uT, R, out);
  } else {
    drmlt::path_lane_kernel<false><<<grid, block, 0, st>>>(tb, uT, R, out);
  }
  return (int)cudaGetLastError();
}
