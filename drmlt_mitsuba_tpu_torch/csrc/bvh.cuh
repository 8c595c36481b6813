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
// divergent, latency-bound work (~50 dependent node steps per ray on a
// 19,586-triangle scene, each a load from L1 / L2 at up to 32 addresses a
// warp; a 65,826-triangle scene's node and triangle records are ~4.3 MB,
// L2 resident).
// Design: one thread per ray walks the depth-first node array with skip
// pointers (a hit inner node goes to idx + 1, a leaf or a missed box to its
// skip): no stack, no shared memory.  A node is one 32-byte record, two
// 16-byte loads of one sector pair: lo.xyz and the skip pointer, hi.xyz and
// the leaf's first record << 4 | its count (0: an inner node), the ints as
// float bits.  A leaf's triangles are contiguous 48-byte records in leaf
// order (v0 and the original triangle id as float bits, e1, e2), three
// 16-byte loads each, so a leaf costs no index load, and hit ids are the
// original ids: the triangle, material and emitter tables are not
// reordered (scene/bvh.py:pack_nodes builds both tables).
//
// Exactness: the walk returns the sweep's (t, id) bit for bit.  A leaf's
// triangles are tested by tri_hit, the sweep's own expressions, on the
// sweep's own bits (the records are copied from the triangle table); a tie
// in t goes to the lower id (the sweep's ordered strict `<`); and a node
// box is padded outward when it is packed (scene/bvh.py:BOX_PAD) and its
// slab exit widened by 1 + 2 gamma(3), so that no box culls a triangle that
// the sweep's rounding accepts.  Not carried over from the TPU: the
// one-hot cluster fetch, the bf16 planes and their near-tie flips.
#pragma once

namespace drmlt {

constexpr float kSlabRobust = 1.0000004f;   // 1 + 2 gamma(3), Ize 2013
constexpr float kDirEps = 1e-12f;

__device__ __forceinline__ float slab_rcp(float d) {
  return 1.0f / (fabsf(d) < kDirEps ? copysignf(kDirEps, d) : d);
}

// Does the ray enter the node box (lo, hi) at some t in [0, min(exit, cap)]?
__device__ __forceinline__ bool box_hit(float4 lo, float4 hi, V3 o, V3 inv, float cap) {
  const float tx0 = (lo.x - o.x) * inv.x, tx1 = (hi.x - o.x) * inv.x;
  const float ty0 = (lo.y - o.y) * inv.y, ty1 = (hi.y - o.y) * inv.y;
  const float tz0 = (lo.z - o.z) * inv.z, tz1 = (hi.z - o.z) * inv.z;
  const float tnear =
      fmaxf(fmaxf(fmaxf(fminf(tx0, tx1), fminf(ty0, ty1)), fminf(tz0, tz1)), 0.0f);
  const float tfar = fminf(fminf(fmaxf(tx0, tx1), fmaxf(ty0, ty1)), fmaxf(tz0, tz1));
  return tnear <= fminf(tfar * kSlabRobust, cap);
}

// Triangle record r of the leaf-ordered table: the hit test, and its
// original id in *id.
__device__ __forceinline__ bool rec_hit(const float4* rec, int r, V3 o, V3 d, float* t_hit,
                                        int* id) {
  const float4 a = __ldg(rec + 3 * r), b = __ldg(rec + 3 * r + 1), c = __ldg(rec + 3 * r + 2);
  *id = __float_as_int(a.w);
  return tri_hit(v3(a.x, a.y, a.z), v3(b.x, b.y, b.z), v3(c.x, c.y, c.z), o, d, t_hit);
}

// Closest hit by the walk: a box entered beyond the best t so far is
// skipped.
static __device__ __noinline__ float bvh_closest(const Tables& tb, V3 o, V3 d, int* best_id) {
  const V3 inv = v3(slab_rcp(d.x), slab_rcp(d.y), slab_rcp(d.z));
  float best_t = kInf;
  int best = -1;
  int n = 0;
  while (n >= 0) {
    const float4 lo = __ldg(tb.node + 2 * n), hi = __ldg(tb.node + 2 * n + 1);
    const int leaf = __float_as_int(hi.w);
    if (box_hit(lo, hi, o, inv, best_t)) {
      if (leaf == 0) {   // inner node: its left child is next
        ++n;
        continue;
      }
      const int first = leaf >> 4, end = first + (leaf & 15);
      for (int r = first; r < end; ++r) {
        float tt;
        int id;
        if (rec_hit(tb.rec, r, o, d, &tt, &id) && (tt < best_t || (tt == best_t && id < best))) {
          best_t = tt;
          best = id;
        }
      }
    }
    n = __float_as_int(lo.w);
  }
  *best_id = best;
  return best_t;
}

// Any hit with kRayEps < t < tmax by the walk; returns at the first.
static __device__ __noinline__ bool bvh_occluded(const Tables& tb, V3 o, V3 d, float tmax) {
  const V3 inv = v3(slab_rcp(d.x), slab_rcp(d.y), slab_rcp(d.z));
  int n = 0;
  while (n >= 0) {
    const float4 lo = __ldg(tb.node + 2 * n), hi = __ldg(tb.node + 2 * n + 1);
    const int leaf = __float_as_int(hi.w);
    if (box_hit(lo, hi, o, inv, tmax)) {
      if (leaf == 0) {
        ++n;
        continue;
      }
      const int first = leaf >> 4, end = first + (leaf & 15);
      for (int r = first; r < end; ++r) {
        float tt;
        int id;
        if (rec_hit(tb.rec, r, o, d, &tt, &id) && tt < tmax) return true;
      }
    }
    n = __float_as_int(lo.w);
  }
  return false;
}

}  // namespace drmlt
