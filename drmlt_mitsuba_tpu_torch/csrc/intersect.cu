// The intersection kernels: the closest hit (t, triangle id) or the any hit
// of a batch of rays.
//
// Replaces the reference's three Pallas sweeps: the brute Moller-Trumbore
// closest hit drmlt_mitsuba_tpu/ops/pallas/intersect_kernel.py:sweep_closest
// (#1, :104) and sweep_closest_v2 (#2, :220), which compute the same
// function over two table layouts, and the BVH-clustered
// bvh_kernel.py:sweep_clusters (#3, :155).  Below BVH_MIN_TRIS the tables
// carry no BVH and intersect_launch runs brute_sweep_kernel (brute mode,
// #1 / #2); above it intersect_kernel, one ray per thread through the
// trace kernels' own path_trace.cuh:closest_hit / occluded, which walk the
// BVH of bvh.cuh (BVH mode, #3).  Plain twin:
// ops/intersect.py:closest_reference / any_reference.
//
// What bounds the brute mode on an H100: instruction issue.  Every ray
// tests every triangle, 56 FP32 instructions a test at tri_hit's
// expressions without contraction (the library is built with
// --fmad=false), and the triangle table stays in L2.  One ray per thread
// spent ~20 more instructions a test on what is the same for every ray:
// the triangle's three loads, the loop counter and its address.  Design,
// after the reference's _sweep_kernel (intersect_kernel.py:30), which
// tests 8 triangles against a whole (8, 1024) tile of rays a step:
// kBruteRPT rays a thread kept in registers (ray k of a thread is
// base + k * kBruteBlock + threadIdx.x, so ray loads and result stores
// stay coalesced); a block stages kBruteTile triangle records (v0, e1, e2:
// the 48 bytes tri_hit reads of a (T, 20) row) in shared memory with
// 16-byte loads, then each thread reads a record with three broadcast
// 16-byte shared loads and tests all its rays against it.  A test is
// tri_hit's, split after b1: where no lane of the warp can still hit the
// triangle (__any_sync), the warp skips the rest, 25 of the test's 56
// FP32 instructions, as most warps do on a small triangle (the split is
// written out in the loop: as a device function it compiled to more
// integer instructions and ran ~10% slower).  Each ray visits the
// triangles in index order with tri_hit's expressions and the strict `<`
// of closest_hit, so t and id are bit for bit those of one ray per thread
// (a tie keeps the lower id).  In any-hit mode a blocked ray's lane is
// masked out of the tests, a warp leaves a tile when all its rays are
// blocked (__all_sync, warp-uniform), and a block stops staging tiles
// when all its rays are (__syncthreads_and).
#include "path_trace.cuh"

namespace drmlt {

// BVH mode: one ray per thread through the trace kernels' functions.
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

constexpr int kBruteBlock = 128;  // threads a block
constexpr int kBruteRPT = 2;      // rays a thread (timed ahead of 1 and 4)
constexpr int kBruteTile = 256;   // triangle records staged a step (12 KB)

// Brute mode: rays [blockIdx.x * kBruteBlock * kBruteRPT, +kBruteBlock *
// kBruteRPT) against every triangle of the (T, 20) table `tri`.  Outputs
// as intersect_kernel's.
template <bool Any>
__global__ void __launch_bounds__(kBruteBlock)
    brute_sweep_kernel(const float* __restrict__ tri, int T, const float* __restrict__ o,
                       const float* __restrict__ d, const float* __restrict__ tmax, int R,
                       float* __restrict__ t_out, void* __restrict__ out) {
  __shared__ float4 tile[3 * kBruteTile];
  const long base = (long)blockIdx.x * (kBruteBlock * kBruteRPT) + threadIdx.x;
  V3 ro[kBruteRPT], rd[kBruteRPT];
  float tm[kBruteRPT], best[kBruteRPT];
  int id[kBruteRPT];
  bool blk[kBruteRPT];
#pragma unroll
  for (int k = 0; k < kBruteRPT; ++k) {
    const long r = base + k * kBruteBlock;
    const bool in = r < R;
    // a ray past R is swept as o = d = 0 (det = 0: no hit) and not stored
    ro[k] = in ? ld3(o + 3 * r) : v3(0.0f, 0.0f, 0.0f);
    rd[k] = in ? ld3(d + 3 * r) : v3(0.0f, 0.0f, 0.0f);
    tm[k] = in ? __ldg(tmax + r) : 0.0f;
    best[k] = kInf;
    id[k] = -1;
    blk[k] = !in;
  }
  const float4* rows = reinterpret_cast<const float4*>(tri);
  for (int t0 = 0; t0 < T; t0 += kBruteTile) {
    bool done = true;
#pragma unroll
    for (int k = 0; k < kBruteRPT; ++k) done = done && blk[k];
    // the previous tile's sweep is over (and, any hit: a block whose rays
    // are all blocked stops)
    if (Any) {
      if (__syncthreads_and(done)) break;
    } else {
      __syncthreads();
    }
    const int n = min(kBruteTile, T - t0);
    // record j's three float4s are the first three of row t0 + j's five
    for (int q = threadIdx.x; q < 3 * n; q += kBruteBlock) {
      const int j = q / 3;
      tile[q] = __ldg(rows + 5 * (long)(t0 + j) + (q - 3 * j));
    }
    __syncthreads();
    // a warp whose rays are all blocked skips the tile (every lane of a
    // warp takes the same branch, so the votes below see the whole warp)
    if (Any && __all_sync(0xffffffffu, done)) continue;
#pragma unroll 2
    for (int j = 0; j < n; ++j) {
      const float4 a = tile[3 * j], b = tile[3 * j + 1], c = tile[3 * j + 2];
      const V3 v0 = v3(a.x, a.y, a.z), e1 = v3(a.w, b.x, b.y), e2 = v3(b.z, b.w, c.x);
      // tri_hit's test (path_trace.cuh), its expressions in its order,
      // split after b1: the warp skips the rest where no lane can still
      // hit the triangle (b1 outside [0, 1]: with b2 >= 0, b1 > 1 rounds to
      // b1 + b2 > 1, so tri_hit misses too) or every lane's ray is blocked
#pragma unroll
      for (int k = 0; k < kBruteRPT; ++k) {
        const V3 p = cross(rd[k], e2);
        const float det = dot(e1, p);
        const bool ok = fabsf(det) > 1e-12f;
        const float inv = 1.0f / (ok ? det : 1.0f);
        const V3 t = ro[k] - v0;
        const float b1 = dot(t, p) * inv;
        const bool pass = (!Any || !blk[k]) && ok && b1 >= 0.0f && b1 <= 1.0f;
        if (__any_sync(0xffffffffu, pass)) {
          const V3 q = cross(t, e1);
          const float b2 = dot(rd[k], q) * inv;
          const float tt = dot(e2, q) * inv;
          const bool hit = pass && b2 >= 0.0f && b1 + b2 <= 1.0f && tt > kRayEps;
          if (Any) {
            blk[k] = blk[k] | (hit && tt < tm[k]);
          } else if (hit && tt < best[k]) {
            best[k] = tt;
            id[k] = t0 + j;
          }
        }
      }
      if (Any) {
        done = true;
#pragma unroll
        for (int k = 0; k < kBruteRPT; ++k) done = done && blk[k];
        if (__all_sync(0xffffffffu, done)) break;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kBruteRPT; ++k) {
    const long r = base + k * kBruteBlock;
    if (r >= R) break;
    if (Any) {
      static_cast<uint8_t*>(out)[r] = blk[k] ? 1 : 0;
    } else {
      const bool ok = id[k] >= 0 && best[k] < tm[k];
      t_out[r] = ok ? best[k] : kInf;
      static_cast<int*>(out)[r] = ok ? id[k] : -1;
    }
  }
}

}  // namespace drmlt

// any_mode 0: t_out (R,) f32 (kInf on a miss) and out (R,) int32 (-1);
// any_mode 1: out (R,) uint8.  n_nodes = 0: brute mode.
extern "C" int intersect_launch(const float* tri, int n_tris, const float* node, const float* rec,
                                int n_nodes, const float* o, const float* d,
                                const float* tmax, int R, int any_mode, float* t_out, void* out,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_nodes == 0) {
    const int per = drmlt::kBruteBlock * drmlt::kBruteRPT;
    const int grid = (R + per - 1) / per;
    if (grid > 0) {
      if (any_mode) {
        drmlt::brute_sweep_kernel<true>
            <<<grid, drmlt::kBruteBlock, 0, s>>>(tri, n_tris, o, d, tmax, R, t_out, out);
      } else {
        drmlt::brute_sweep_kernel<false>
            <<<grid, drmlt::kBruteBlock, 0, s>>>(tri, n_tris, o, d, tmax, R, t_out, out);
      }
    }
    return (int)cudaGetLastError();
  }
  drmlt::Tables tb{tri, nullptr, nullptr, nullptr, n_tris, 0, 0, 0, 0, 0, 0};
  drmlt::set_bvh(tb, node, rec, n_nodes);
  const int block = 128;
  int grid = (R + block - 1) / block;
  if (grid > 0) {
    drmlt::intersect_kernel<<<grid, block, 0, s>>>(tb, o, d, tmax, R, any_mode, t_out, out);
  }
  return (int)cudaGetLastError();
}
