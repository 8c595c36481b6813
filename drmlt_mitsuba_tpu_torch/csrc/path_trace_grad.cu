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
// latency-bound per-thread traces, warps idling behind their longest
// path), plus per contribution (at most two a bounce) 3 row updates (emit)
// or 3 for every material on the path (albedo).
//
// Design: the block loop of path_trace_kernel (path_block.cuh) over the
// trace body's gradient mode, so a block's live paths are compacted into
// full warps between bounces; a scene with a BVH launches one path per
// thread (path_lane_rad_kernel / path_lane_alb_kernel), as the path kernel
// does, and so does compact=False on any scene.  In albedo mode a lane
// keeps one power count per material (the reference's form: no list of
// its materials, no dedup per contribution, no depth cap).  In the
// compacting kernel a lane's rows and counts live in the block's dynamic
// shared memory, one column per lane of the block, word-major: they stay
// put when compaction moves the path's state (15 words and the lane),
// every update is a shared-memory add, and the block writes the rows to
// the output once, coalesced, after its last path has ended.  Above
// kGradShmWords words a lane (3K rows + K counts in albedo mode), and in
// the one-path-per-thread kernels, the rows stay in the (3 + 3K, R)
// output and the counts in a (K, R) scratch, zero-filled and updated in
// global memory.  Each row gains a path's contributions in the order the
// path makes them, wherever it lives, so every launch form gives the same
// bits.  Russian-roulette survival is detached, as in the reference.
#include "path_block.cuh"

namespace drmlt {

// Words of shared memory a lane's rows and counts may take: K <= 16
// emitters or K <= 12 materials; at kPathBlock threads 48 KB a block
// beside PathSlots' 16,448 B, which keeps the two blocks an SM that the
// registers allow.
constexpr int kGradShmWords = 48;

template <int G>
__host__ __device__ __forceinline__ int grad_k(const Tables& tb) {
  return G == kGradEmit ? tb.n_ems : tb.n_mats;
}

// The rows in the (3 + 3K, R) output and the counts in the (K, R)
// scratch, lane l's column l.
__device__ __forceinline__ GradCols global_cols(float* out, float* scratch, int R) {
  return GradCols{out + 3 * (long)R, scratch, (long)R, 0};
}

template <int G>
__device__ __forceinline__ void zero_rows(const Tables& tb, const GradRows& g) {
  const int K = grad_k<G>(tb);
  for (int k = 0; k < 3 * K; ++k) g.rows[k * g.stride] = 0.0f;
  if constexpr (G == kGradAlbedo) {
    for (int m = 0; m < K; ++m) g.pw[m * g.stride] = 0.0f;
  }
}

template <int G, bool X>
__device__ __forceinline__ void adjoint_block(const TabT<X>& tb, const float* __restrict__ uT,
                                              int R, float* __restrict__ out, float* scratch,
                                              bool shm) {
  __shared__ PathSlots slots;
  extern __shared__ float grad_sh[];   // shm: (3K [+ K], kPathBlock), word-major
  const int t = threadIdx.x, first = blockIdx.x * kPathBlock, K = grad_k<G>(tb);
  const GradCols cols =
      shm ? GradCols{grad_sh, grad_sh + 3 * K * kPathBlock, (long)kPathBlock, first}
          : global_cols(out, scratch, R);
  if (first + t < R) zero_rows<G>(tb, cols.at(first + t));
  path_block<G, X>(tb, uT, R, out, slots, cols);
  if (shm) {
    __syncthreads();   // every thread of the block, from wherever it left the loop
    if (first + t >= R) return;
    for (int k = 0; k < 3 * K; ++k) {
      out[(3 + (long)k) * R + first + t] = grad_sh[k * kPathBlock + t];
    }
  }
}

// One path per thread (scenes with a BVH): its rows stay in global
// memory.  In shared memory they made cornell_large.xml 1-4% slower than
// here (PERF.md §6), presumably as the carveout shrinks the L1 that
// caches the walk's records.
template <int G, bool X>
__device__ __forceinline__ void adjoint_lane(const TabT<X>& tb, const float* __restrict__ uT,
                                             int R, float* __restrict__ out, float* scratch) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= R) return;
  const GradRows g = global_cols(out, scratch, R).at(lane);
  zero_rows<G>(tb, g);
  put_rgb(out, R, lane, trace_body<G, X>(tb, lane_view(uT, lane, R), g));
}

// out (3 + 3E, R): rgb, then d rgb / d radiance[e, c] in row 3 + 3e + c
template <bool X>
__global__ void __launch_bounds__(kPathBlock)
    path_trace_rad_kernel(TabT<X> tb, const float* __restrict__ uT, int R,
                          float* __restrict__ out, float* scratch, bool shm) {
  adjoint_block<kGradEmit, X>(tb, uT, R, out, scratch, shm);
}

// out (3 + 3M, R): rgb, then d rgb / d albedo[m, c] in row 3 + 3m + c
template <bool X>
__global__ void __launch_bounds__(kPathBlock)
    path_trace_alb_kernel(TabT<X> tb, const float* __restrict__ uT, int R,
                          float* __restrict__ out, float* scratch, bool shm) {
  adjoint_block<kGradAlbedo, X>(tb, uT, R, out, scratch, shm);
}

// One path per thread to its end: scenes with a BVH, and compact=False.
// The compacting kernels equal them bit for bit (the GPU tests, chip_smoke
// phase 12).
template <bool X>
__global__ void path_lane_rad_kernel(TabT<X> tb, const float* __restrict__ uT, int R,
                                     float* __restrict__ out, float* scratch) {
  adjoint_lane<kGradEmit, X>(tb, uT, R, out, scratch);
}

template <bool X>
__global__ void path_lane_alb_kernel(TabT<X> tb, const float* __restrict__ uT, int R,
                                     float* __restrict__ out, float* scratch) {
  adjoint_lane<kGradAlbedo, X>(tb, uT, R, out, scratch);
}

// One launch: the compacting kernel, its rows in shared memory where they
// fit, or one path per thread.
template <int G, bool X>
int launch_scope(const TabT<X>& tb, bool compact, const float* uT, int R, float* out,
                 float* scratch, cudaStream_t st) {
  const int block = compact ? kPathBlock : kLaneBlock;
  const int grid = (R + block - 1) / block;
  if (grid == 0) return (int)cudaGetLastError();
  if (!compact) {
    if constexpr (G == kGradEmit) {
      path_lane_rad_kernel<X><<<grid, block, 0, st>>>(tb, uT, R, out, scratch);
    } else {
      path_lane_alb_kernel<X><<<grid, block, 0, st>>>(tb, uT, R, out, scratch);
    }
    return (int)cudaGetLastError();
  }
  const int K = grad_k<G>(tb);
  const int words = 3 * K + (G == kGradAlbedo ? K : 0);
  const bool shm = words <= kGradShmWords;
  const int dyn = shm ? words * block * (int)sizeof(float) : 0;
  const void* kern = G == kGradEmit ? (const void*)path_trace_rad_kernel<X>
                                    : (const void*)path_trace_alb_kernel<X>;
  if (dyn > 0) {
    const cudaError_t rc =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (rc != cudaSuccess) return (int)rc;
  }
  if constexpr (G == kGradEmit) {
    path_trace_rad_kernel<X><<<grid, block, dyn, st>>>(tb, uT, R, out, scratch, shm);
  } else {
    path_trace_alb_kernel<X><<<grid, block, dyn, st>>>(tb, uT, R, out, scratch, shm);
  }
  return (int)cudaGetLastError();
}

// The entry points' body: the full-scope instantiation when `full`, else
// that of slices 1-4.
template <int G>
int launch_adjoint(const float* tri, int n_tris, const float* mat, int n_mats, const float* em,
                   int n_ems, const float* cam, const float* node, const float* rec, int n_nodes,
                   DRMLT_EXT_PARAMS, int max_depth, int min_depth, int rr_depth, int use_nee,
                   int compact, const float* uT, int R, float* out, float* scratch,
                   void* stream) {
  Tables tb{tri, mat, em, cam, n_tris, n_mats, n_ems, max_depth, min_depth, rr_depth, use_nee};
  set_bvh(tb, node, rec, n_nodes);
  const bool c = compact && n_nodes == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (full) {
    return launch_scope<G, true>(with_ext(tb, DRMLT_EXT_ARGS), c, uT, R, out, scratch, st);
  }
  return launch_scope<G, false>(tb, c, uT, R, out, scratch, st);
}

}  // namespace drmlt

// compact 1 (every caller of the port): the compacting kernel, or on a
// scene with a BVH one path per thread; 0: one path per thread.  scratch:
// (K, R) floats for the albedo kernel's counts one path per thread and
// where they do not fit in shared memory (unused by the radiance kernel).
extern "C" int path_trace_rad_launch(const float* tri, int n_tris, const float* mat, int n_mats,
                                     const float* em, int n_ems, const float* cam,
                                     const float* node, const float* rec,
                                     int n_nodes, DRMLT_EXT_PARAMS, int max_depth, int min_depth,
                                     int rr_depth, int use_nee, int compact, const float* uT,
                                     int R, float* out, float* scratch, void* stream) {
  return drmlt::launch_adjoint<drmlt::kGradEmit>(
      tri, n_tris, mat, n_mats, em, n_ems, cam, node, rec, n_nodes, DRMLT_EXT_ARGS, full,
      max_depth, min_depth, rr_depth, use_nee, compact, uT, R, out, scratch, stream);
}

extern "C" int path_trace_alb_launch(const float* tri, int n_tris, const float* mat, int n_mats,
                                     const float* em, int n_ems, const float* cam,
                                     const float* node, const float* rec,
                                     int n_nodes, DRMLT_EXT_PARAMS, int max_depth, int min_depth,
                                     int rr_depth, int use_nee, int compact, const float* uT,
                                     int R, float* out, float* scratch, void* stream) {
  return drmlt::launch_adjoint<drmlt::kGradAlbedo>(
      tri, n_tris, mat, n_mats, em, n_ems, cam, node, rec, n_nodes, DRMLT_EXT_ARGS, full,
      max_depth, min_depth, rr_depth, use_nee, compact, uT, R, out, scratch, stream);
}
