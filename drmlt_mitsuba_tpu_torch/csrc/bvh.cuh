// The BVH walk: closest hit and any hit of one ray per thread over the
// scene's binned-SAH BVH (scene/bvh.py), the device functions that
// path_trace.cuh:closest_hit / occluded branch to when the tables carry a
// node table, and so every kernel of the port (path, adjoints, MMLT, both
// modes of the chain kernel) and the intersection kernel (intersect.cu).
// Included by path_trace.cuh after the vector helpers, Tables and tri_hit.
//
// Replaces the reference's clustered traversal inside its megakernels,
// drmlt_mitsuba_tpu/ops/pallas/cluster_sweep.py:closest_sweep_clustered
// (:327) and shadow_sweep_clustered (:371), and the traversal of its
// cluster kernel bvh_kernel.py:sweep_clusters (:155).  Twins:
// ops/intersect.py:walk_closest / walk_any.
//
// What bounds it on an H100: like the sweeps it replaces, per-thread,
// divergent, latency-bound work (dependent loads of nodes and triangles
// through L1 / L2; the tables of a 65,826-triangle scene are ~6 MB, L2
// resident).  Design: one thread per ray walks the depth-first node array
// with skip pointers (a hit inner node goes to idx + 1, a leaf or a missed
// box to skip[idx]): no stack, no shared memory, two 16-byte loads of the
// box and one of the links per node.  A leaf tests its `count` triangles
// through order[first ...], so hit ids are the original triangle ids and
// the triangle, material and emitter tables are not reordered.
//
// Exactness: the walk returns the sweep's (t, id) bit for bit.  A leaf's
// triangles are tested by tri_hit, the sweep's own expressions; a tie in t
// goes to the lower id (the sweep's ordered strict `<`); and a node box is
// padded outward when it is packed (scene/bvh.py:BOX_PAD) and its slab exit
// widened by 1 + 2 gamma(3), so that no box culls a triangle that the
// sweep's rounding accepts.  Not carried over from the TPU: the one-hot
// cluster fetch, the bf16 planes and their near-tie flips.
#pragma once

namespace drmlt {

constexpr float kSlabRobust = 1.0000004f;   // 1 + 2 gamma(3), Ize 2013
constexpr float kDirEps = 1e-12f;

__device__ __forceinline__ float slab_rcp(float d) {
  return 1.0f / (fabsf(d) < kDirEps ? copysignf(kDirEps, d) : d);
}

// Does the ray enter box n at some t in [0, min(exit, cap)]?
__device__ __forceinline__ bool box_hit(const Tables& tb, int n, V3 o, V3 inv, float cap) {
  const float4 lo = __ldg(tb.box + 2 * n), hi = __ldg(tb.box + 2 * n + 1);
  const float tx0 = (lo.x - o.x) * inv.x, tx1 = (hi.x - o.x) * inv.x;
  const float ty0 = (lo.y - o.y) * inv.y, ty1 = (hi.y - o.y) * inv.y;
  const float tz0 = (lo.z - o.z) * inv.z, tz1 = (hi.z - o.z) * inv.z;
  const float tnear =
      fmaxf(fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1)), 0.0f);
  const float tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return tnear <= fminf(tfar * kSlabRobust, cap);
}

// Closest hit by the walk: a box entered beyond the best t so far is
// skipped.
static __device__ __noinline__ float bvh_closest(const Tables& tb, V3 o, V3 d, int* best_id) {
  const V3 inv = v3(slab_rcp(d.x), slab_rcp(d.y), slab_rcp(d.z));
  float best_t = kInf;
  int best = -1;
  int n = 0;
  while (n >= 0) {
    const int4 ln = __ldg(tb.link + n);
    if (box_hit(tb, n, o, inv, best_t)) {
      if (ln.y == 0) {   // inner node: its left child is next
        ++n;
        continue;
      }
      for (int k = 0; k < ln.y; ++k) {
        const int id = __ldg(tb.order + ln.x + k);
        float tt;
        if (tri_hit(tb.tri + id * kTriCols, o, d, &tt) &&
            (tt < best_t || (tt == best_t && id < best))) {
          best_t = tt;
          best = id;
        }
      }
    }
    n = ln.z;
  }
  *best_id = best;
  return best_t;
}

// Any hit with kRayEps < t < tmax by the walk; returns at the first.
static __device__ __noinline__ bool bvh_occluded(const Tables& tb, V3 o, V3 d, float tmax) {
  const V3 inv = v3(slab_rcp(d.x), slab_rcp(d.y), slab_rcp(d.z));
  int n = 0;
  while (n >= 0) {
    const int4 ln = __ldg(tb.link + n);
    if (box_hit(tb, n, o, inv, tmax)) {
      if (ln.y == 0) {
        ++n;
        continue;
      }
      for (int k = 0; k < ln.y; ++k) {
        const int id = __ldg(tb.order + ln.x + k);
        float tt;
        if (tri_hit(tb.tri + id * kTriCols, o, d, &tt) && tt < tmax) return true;
      }
    }
    n = ln.z;
  }
  return false;
}

}  // namespace drmlt
