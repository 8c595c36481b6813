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
// Design: path_block.cuh's block loop: a block of kPathBlock threads runs
// its paths bounce by bounce and moves its live paths into its lowest
// warps wherever that frees a warp, bit for bit one path per thread
// (`path_lane_kernel`, the design before compaction).  A scene with a BVH
// keeps one path per thread: there a bounce's cost varies from warp to
// warp with the length of its walks, and the block's barrier at every
// bounce cost more than the warps that compaction freed
// (cornell_large.xml at depth 8: 1.30 ms against 1.02 ms, PERF.md).
// PSS dims are dim-major (uT is (n_dims, R)); rgb is (3, R).  Two
// instantiations: the scene subset of slices 1-4 (X = false) and the full
// scene scope (X = true: spheres, bitmap albedo, the environment, the thin
// lens, the conductor and null kinds).
#include "path_block.cuh"

namespace drmlt {

template <bool X>
__global__ void __launch_bounds__(kPathBlock)
    path_trace_kernel(TabT<X> tb, const float* __restrict__ uT, int R, float* __restrict__ out) {
  __shared__ PathSlots sh;
  path_block<kGradNone, X>(tb, uT, R, out, sh, GradCols{});
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
