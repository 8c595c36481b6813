// mmlt_trace_kernel: the selected-strategy MMLT trace, one lane per thread.
//
// Replaces the reference's Pallas kernel
// drmlt_mitsuba_tpu/ops/pallas/megammlt.py:_mega_mmlt_kernel (:214, built
// by make_mega_mmlt :939), which the depth-grouped driver runs for every
// group's bootstrap luminance pass and for the chain starts.  Plain twin:
// ops/megammlt.py:mmlt_trace_reference.
//
// What bounds it on an H100: per-thread, divergent, latency-bound work,
// as in path_trace.cu.  Each lane sweeps the triangles (or walks the BVH)
// once per bounce its strategy needs, t - 1 + max(s - 1, 0) <= max_depth
// of them (the eye walk up to its slot t - 1, then the light walk up to
// s - 1, in one loop: mmlt_trace.cuh:walk), plus one shadow ray; the
// strategies and the walks' ends differ per lane, so warps diverge.  The
// per-slot MIS arrays and the four captured vertices live in per-thread
// local memory (L1-resident), not in registers.
//
// Design: one thread per lane, PSS dims read dim-major (uT is (n_core, R),
// neighbouring threads read neighbouring floats), tables indexed directly
// through the read-only cache.  Output (5, R): value r, g, b, then the film
// position x, y, coalesced.  Two instantiations, as path_trace.cu's: the
// scene subset of slices 1-4 and the full scope.
#include "mmlt_trace.cuh"

namespace drmlt {

template <bool X>
__global__ void mmlt_trace_kernel(TabT<X> tb, MmltCfg mc, const float* __restrict__ uT, int R,
                                  float* __restrict__ out) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= R) return;
  const PssView u{uT + lane, nullptr, nullptr, (long)R, 0};
  const MmltOut r = trace_mmlt<X>(tb, mc, u);
  out[lane] = r.value.x;
  out[(long)R + lane] = r.value.y;
  out[2 * (long)R + lane] = r.value.z;
  out[3 * (long)R + lane] = r.px;
  out[4 * (long)R + lane] = r.py;
}

}  // namespace drmlt

extern "C" int mmlt_trace_launch(const float* tri, int n_tris, const float* mat, int n_mats,
                                 const float* em, int n_ems, const float* cam, const float* node,
                                 const float* rec, int n_nodes,
                                 DRMLT_EXT_PARAMS, int max_depth, int light_image, int eye_dims,
                                 const float* uT, int R, float* out, void* stream) {
  if (max_depth < 1 || max_depth > drmlt::kMaxMmltDepth) return (int)cudaErrorInvalidValue;
  drmlt::Tables tb{tri, mat, em, cam, n_tris, n_mats, n_ems, max_depth, 1, 1 << 30, 1};
  drmlt::set_bvh(tb, node, rec, n_nodes);
  drmlt::MmltCfg mc{max_depth, light_image, eye_dims};
  const int block = 128;
  int grid = (R + block - 1) / block;
  cudaStream_t st = (cudaStream_t)stream;
  if (grid > 0 && full) {
    drmlt::mmlt_trace_kernel<true>
        <<<grid, block, 0, st>>>(drmlt::with_ext(tb, DRMLT_EXT_ARGS), mc, uT, R, out);
  } else if (grid > 0) {
    drmlt::mmlt_trace_kernel<false><<<grid, block, 0, st>>>(tb, mc, uT, R, out);
  }
  return (int)cudaGetLastError();
}
