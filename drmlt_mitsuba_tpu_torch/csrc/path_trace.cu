// path_trace_kernel: one whole unidirectional path per thread.
//
// Replaces the reference's Pallas megakernel
// drmlt_mitsuba_tpu/ops/pallas/megatrace.py:_mega_kernel (:1555, built by
// make_mega_trace :2099), which the bootstrap luminance pass and the
// initial chain state run through.  Plain twin:
// ops/megatrace.py:path_trace_reference.
//
// What bounds it on an H100: per-thread, divergent, latency-bound work.
// Each lane sweeps every triangle (or walks the BVH) twice per bounce
// (closest hit + shadow) and paths end at different depths, so warps
// diverge; the reads are a few
// bytes of PSS dims per bounce plus the scene tables, which every thread
// of a warp reads at the same address (a broadcast from L1).  It is bound
// by instruction issue and latency, not by device-memory bandwidth.
//
// Design: one thread per lane (no lane tiles), PSS dims read dim-major
// (uT is (n_dims, R), so neighbouring threads read neighbouring floats),
// tables indexed directly from global memory through the read-only cache,
// and a lane leaves the bounce loop as soon as its path ends.  Output rgb
// is (3, R), coalesced.  Two instantiations: the scene subset of slices 1-4
// (X = false) and the full scene scope (X = true: spheres, bitmap albedo,
// the environment, the thin lens, the conductor and null kinds).
#include "path_trace.cuh"

namespace drmlt {

template <bool X>
__global__ void path_trace_kernel(TabT<X> tb, const float* __restrict__ uT, int R,
                                  float* __restrict__ out) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= R) return;
  PssView u{uT + lane, nullptr, nullptr, (long)R, 0};
  V3 L = trace_path<X>(tb, u);
  out[lane] = L.x;
  out[R + lane] = L.y;
  out[2 * (long)R + lane] = L.z;
}

}  // namespace drmlt

extern "C" int path_trace_launch(const float* tri, int n_tris, const float* mat, int n_mats,
                                 const float* em, int n_ems, const float* cam, const float* box,
                                 const int* link, const int* order, int n_nodes,
                                 DRMLT_EXT_PARAMS, int max_depth, int min_depth, int rr_depth,
                                 int use_nee, const float* uT, int R, float* out, void* stream) {
  drmlt::Tables tb{tri, mat, em, cam, n_tris, n_mats, n_ems,
                   max_depth, min_depth, rr_depth, use_nee};
  drmlt::set_bvh(tb, box, link, order, n_nodes);
  const int block = 128;
  int grid = (R + block - 1) / block;
  cudaStream_t st = (cudaStream_t)stream;
  if (grid > 0 && full) {
    drmlt::path_trace_kernel<true>
        <<<grid, block, 0, st>>>(drmlt::with_ext(tb, DRMLT_EXT_ARGS), uT, R, out);
  } else if (grid > 0) {
    drmlt::path_trace_kernel<false><<<grid, block, 0, st>>>(tb, uT, R, out);
  }
  return (int)cudaGetLastError();
}
