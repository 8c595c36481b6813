// intersect_kernel: the closest hit (t, triangle id) or the any hit of one
// ray per thread.
//
// Replaces the reference's three Pallas sweeps: the brute Moller-Trumbore
// closest hit drmlt_mitsuba_tpu/ops/pallas/intersect_kernel.py:sweep_closest
// (#1, :104) and sweep_closest_v2 (#2, :220), which compute the same
// function over two table layouts, and the BVH-clustered
// bvh_kernel.py:sweep_clusters (#3, :155).  One kernel serves all three:
// it calls path_trace.cuh:closest_hit / occluded, the trace kernels' own
// functions, which sweep every triangle below BVH_MIN_TRIS (brute mode)
// and walk the BVH of bvh.cuh above it (BVH mode).  Plain twin:
// ops/intersect.py:closest_reference / any_reference.
//
// What bounds it on an H100: the ray-triangle and ray-box tests (FP32
// issue and the latency of dependent table loads), not the 28 bytes a ray
// reads and the 8 it writes.  Design: one thread per ray, rays read as
// (R, 3) rows, no shared memory; the tables are read through the
// read-only cache, where every thread of a warp sweeping the same
// triangle hits one broadcast address.
#include "path_trace.cuh"

namespace drmlt {

__global__ void intersect_kernel(Tables tb, const float* __restrict__ o,
                                 const float* __restrict__ d, const float* __restrict__ tmax,
                                 int R, int any_mode, float* __restrict__ t_out,
                                 void* __restrict__ out) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= R) return;
  const V3 ro = ld3(o + 3 * (long)lane), rd = ld3(d + 3 * (long)lane);
  const float tm = __ldg(tmax + lane);
  if (any_mode) {
    static_cast<uint8_t*>(out)[lane] = occluded(tb, ro, rd, tm) ? 1 : 0;
    return;
  }
  int id;
  const float t = closest_hit(tb, ro, rd, &id);
  const bool ok = id >= 0 && t < tm;
  t_out[lane] = ok ? t : kInf;
  static_cast<int*>(out)[lane] = ok ? id : -1;
}

}  // namespace drmlt

// any_mode 0: t_out (R,) f32 (kInf on a miss) and out (R,) int32 (-1);
// any_mode 1: out (R,) uint8.
extern "C" int intersect_launch(const float* tri, int n_tris, const float* box, const int* link,
                                const int* order, int n_nodes, const float* o, const float* d,
                                const float* tmax, int R, int any_mode, float* t_out, void* out,
                                void* stream) {
  drmlt::Tables tb{tri, nullptr, nullptr, nullptr, n_tris, 0, 0, 0, 0, 0, 0};
  drmlt::set_bvh(tb, box, link, order, n_nodes);
  const int block = 128;
  int grid = (R + block - 1) / block;
  if (grid > 0) {
    drmlt::intersect_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(tb, o, d, tmax, R,
                                                                      any_mode, t_out, out);
  }
  return (int)cudaGetLastError();
}
