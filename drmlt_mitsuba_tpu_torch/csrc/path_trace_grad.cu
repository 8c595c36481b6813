// path_trace_rad_kernel and path_trace_alb_kernel: the path trace of
// path_trace.cu plus, per lane, the Jacobian rows of its radiance with
// respect to each emitter's radiance or each material's albedo.
//
// Replace the reference's Pallas kernels
// drmlt_mitsuba_tpu/ops/pallas/megatrace.py:_mega_kernel_rad (:1798, built
// by make_mega_trace_rad :1825) and _mega_kernel_alb (:1943, built by
// make_mega_trace_alb :1970), which carry the in-kernel adjoints of
// differentiable rendering: the backward pass is one einsum of these rows
// with the cotangent, no replay.  Plain twins:
// ops/megatrace.py:path_trace_rad_reference / path_trace_alb_reference.
//
// What bounds them on an H100: what bounds path_trace_kernel (divergent,
// latency-bound per-thread traces), plus 3K read-modify-writes of the
// lane's own rows per contribution (K emitters or materials; a path has
// at most two contributions per bounce).
//
// Design: the trace body of path_trace.cuh in its gradient mode, inlined,
// in the two scene-scope instantiations of path_trace.cu.
// Every lane owns one column of the (3 + 3K, R) output (rgb, then its
// rows), dim-major, so a warp's adds are coalesced and need no atomics;
// K is a run-time value, so the rows live there and not in registers.
// In albedo mode a lane keeps the materials of its diffuse-like bounces
// (at most max_depth), not a counter per material.  Russian-roulette
// survival is detached, as in the reference.
#include "path_trace.cuh"

namespace drmlt {

template <int G, bool X>
__device__ __forceinline__ void grad_lane(const TabT<X>& tb, const float* __restrict__ uT, int R,
                                          int n_rows, float* __restrict__ out) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= R) return;
  for (int k = 0; k < n_rows; ++k) out[(3 + (long)k) * R + lane] = 0.0f;
  PssView u{uT + lane, nullptr, nullptr, (long)R, 0};
  V3 L = trace_body<G, X>(tb, u, GradRows{out + 3 * (long)R + lane, (long)R});
  out[lane] = L.x;
  out[R + lane] = L.y;
  out[2 * (long)R + lane] = L.z;
}

// out (3 + 3E, R): rgb, then d rgb / d radiance[e, c] in row 3 + 3e + c
template <bool X>
__global__ void path_trace_rad_kernel(TabT<X> tb, const float* __restrict__ uT, int R,
                                      float* __restrict__ out) {
  grad_lane<kGradEmit, X>(tb, uT, R, 3 * tb.n_ems, out);
}

// out (3 + 3M, R): rgb, then d rgb / d albedo[m, c] in row 3 + 3m + c
template <bool X>
__global__ void path_trace_alb_kernel(TabT<X> tb, const float* __restrict__ uT, int R,
                                      float* __restrict__ out) {
  grad_lane<kGradAlbedo, X>(tb, uT, R, 3 * tb.n_mats, out);
}

}  // namespace drmlt

namespace {

drmlt::Tables tables(const float* tri, int n_tris, const float* mat, int n_mats, const float* em,
                     int n_ems, const float* cam, const float* box, const int* link,
                     const int* order, int n_nodes, int max_depth, int min_depth, int rr_depth,
                     int use_nee) {
  drmlt::Tables tb{tri, mat, em, cam, n_tris, n_mats, n_ems,
                   max_depth, min_depth, rr_depth, use_nee};
  drmlt::set_bvh(tb, box, link, order, n_nodes);
  return tb;
}

}  // namespace

// Each entry point launches the full-scope instantiation when `full`, else
// that of slices 1-4.
extern "C" int path_trace_rad_launch(const float* tri, int n_tris, const float* mat, int n_mats,
                                     const float* em, int n_ems, const float* cam,
                                     const float* box, const int* link, const int* order,
                                     int n_nodes, DRMLT_EXT_PARAMS, int max_depth, int min_depth,
                                     int rr_depth, int use_nee, const float* uT, int R,
                                     float* out, void* stream) {
  const drmlt::Tables tb = tables(tri, n_tris, mat, n_mats, em, n_ems, cam, box, link, order,
                                  n_nodes, max_depth, min_depth, rr_depth, use_nee);
  const int block = 128;
  int grid = (R + block - 1) / block;
  cudaStream_t st = (cudaStream_t)stream;
  if (grid > 0 && full) {
    drmlt::path_trace_rad_kernel<true>
        <<<grid, block, 0, st>>>(drmlt::with_ext(tb, DRMLT_EXT_ARGS), uT, R, out);
  } else if (grid > 0) {
    drmlt::path_trace_rad_kernel<false><<<grid, block, 0, st>>>(tb, uT, R, out);
  }
  return (int)cudaGetLastError();
}

extern "C" int path_trace_alb_launch(const float* tri, int n_tris, const float* mat, int n_mats,
                                     const float* em, int n_ems, const float* cam,
                                     const float* box, const int* link, const int* order,
                                     int n_nodes, DRMLT_EXT_PARAMS, int max_depth, int min_depth,
                                     int rr_depth, int use_nee, const float* uT, int R,
                                     float* out, void* stream) {
  const drmlt::Tables tb = tables(tri, n_tris, mat, n_mats, em, n_ems, cam, box, link, order,
                                  n_nodes, max_depth, min_depth, rr_depth, use_nee);
  const int block = 128;
  int grid = (R + block - 1) / block;
  cudaStream_t st = (cudaStream_t)stream;
  if (grid > 0 && full) {
    drmlt::path_trace_alb_kernel<true>
        <<<grid, block, 0, st>>>(drmlt::with_ext(tb, DRMLT_EXT_ARGS), uT, R, out);
  } else if (grid > 0) {
    drmlt::path_trace_alb_kernel<false><<<grid, block, 0, st>>>(tb, uT, R, out);
  }
  return (int)cudaGetLastError();
}
