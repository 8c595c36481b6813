// One unidirectional path per thread: the device-side trace shared by
// path_trace.cu (bootstrap / MC trace) and drmlt_chain.cu (chain kernel),
// and the scene functions mmlt_trace.cuh shares with it.
//
// Port of the reference's Pallas trace body
// drmlt_mitsuba_tpu/ops/pallas/megatrace.py:path_trace_tile (:832) on the
// reference megakernels' scene subset: triangles (a brute sweep, or above
// BVH_MIN_TRIS triangles the BVH walk of bvh.cuh), analytic spheres, area
// emitters, a constant or lat-long image environment (NEE by inverting
// its row and column cdfs), bitmap albedo, pinhole or thin-lens camera,
// and the BSDF kinds diffuse / rough diffuse (Oren-Nayar) / mirror /
// smooth dielectric / smooth conductor / rough conductor (GGX) / null.
// The plain-PyTorch twin is ops/megatrace.py:path_trace_reference; every
// expression below keeps the twin's evaluation order, and the library is
// built with --fmad=false, so kernel and twin round alike.
//
// The features beyond slices 1-4 (spheres, textures, the environment, the
// thin lens, the conductor and null kinds) are a compile-time switch, as
// the reference kernel's static kinds / n_sphs / env / tex / thinlens
// arguments are: trace_body<G, X> with X = false is the body of slices 1-4
// (Tables), X = true the full scope (TablesX, whose SceneExt carries the
// extra tables; its run-time fields turn each feature on).  A launch picks
// the instantiation from the scene (ops/megatrace.py:scope_fields).
//
// What is not carried over from the TPU kernel: the one-hot MXU row
// fetches (tables, the texture atlas and the environment are indexed
// directly from global memory, at any size), the bf16 hi / lo planes, the
// Cephes atan / acos (libdevice's acosf / atan2f instead), the SMEM / VMEM
// sweep tiers, the table-size caps and the (8, L) lane tiles.  A lane whose
// path has ended leaves the bounce loop (`break`): the TPU evaluates every
// lane to max_depth under masks.
#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace drmlt {

constexpr float kInf = 3.0e38f;
constexpr float kRayEps = 1e-4f;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kPi2 = 1.57079632679489661923f;      // pi / 2
constexpr float kPi4 = 0.78539816339744830962f;      // pi / 4
constexpr float kTwoPi = 6.28318530717958647692f;

constexpr int kTriCols = 20;   // v0 e1 e2 n0 n1 n2 mat_id erow
constexpr int kMatCols = 18;   // kind albedo eta k rough spec_refl spec_trans
constexpr int kEmCols = 20;    // rad area pmf cdf v0 e1 e2 ng kind

constexpr int kDiffuse = 0;
constexpr int kConductor = 1;
constexpr int kDielectric = 2;
constexpr int kRoughConductor = 3;
constexpr int kMirror = 8;
constexpr int kNull = 9;
constexpr int kRoughDiffuse = 12;

constexpr int kEnvRow = 4;          // emitter kind of an image environment row
constexpr int kSphCols = 8;         // center radius mat_id emitter_id valid pad
constexpr int kTriExtCols = 28;     // kTriCols, uv0 uv1 uv2, pad
constexpr int kEnvConstant = 1;     // SceneExt::env_mode
constexpr int kEnvImage = 2;
constexpr float kDirDist = 1.0e7f;  // an environment shadow ray's length
constexpr float kTwoPiSq = 19.7392088021787172f;   // 2 pi^2
constexpr float kUMax = 0.999999f;  // 1 - 1e-6: the upper clamp of a lat-long u or v

// PSS layout (integrators/layout.py)
constexpr int kSensorDims = 4;
constexpr int kBounceDims = 9;
constexpr int kOffLightPick = 0;
constexpr int kOffLightU = 1;
constexpr int kOffBsdfCmp = 3;
constexpr int kOffBsdfU = 4;
constexpr int kOffRR = 6;

struct Tables {
  const float* tri;   // (T, 20)
  const float* mat;   // (M, 18)
  const float* em;    // (E, 20)
  const float* cam;   // (24,)
  int n_tris, n_mats, n_ems;
  int max_depth, min_depth, rr_depth, use_nee;
  // the BVH's node table (scene/bvh.py:NodeTable); n_nodes = 0: no BVH,
  // every triangle is swept
  const float4* node;  // (N, 2): lo.xyz, skip; hi.xyz, first << 4 | count
  const float4* rec;   // (T, 3): v0.xyz, id; e1; e2, in leaf order
  int n_nodes;
};

// The scene scope beyond slices 1-4 (the full instantiation's tables).
struct SceneExt {
  const float* sph;      // (S, 8)
  int n_sphs;            // 0: no analytic spheres
  const float* tri_ext;  // (T, 28): the triangle's uvs at 20..25
  const float* tex;      // (P * H * W, 4): rgb texels, page-major
  int tex_pages, tex_h, tex_w;   // tex_pages 0: constant albedos only
  const float* env_tab;  // (He * We, 4): rgb, pixel pmf
  const float* env_col;  // (He, We): each row's column cdf
  const float* env_row;  // (He,): the marginal row cdf
  int env_h, env_w;
  int env_mode;          // 0 none, kEnvConstant (cam[16:19]), kEnvImage
  float env_row_pick;    // the environment row's pick pmf
  int thinlens;          // the lens dims u[2:4] move the ray origin
};

struct TablesX : Tables {
  SceneExt x;
};

// The tables of the slices-1-4 instantiation (X = false) or of the full one.
template <bool X>
using TabT = typename std::conditional<X, TablesX, Tables>::type;

// The scene-scope arguments of every entry point, as they arrive from
// ctypes (after the node table); `full` picks the instantiation.
#define DRMLT_EXT_PARAMS                                                                \
  const float *sph, int n_sphs, const float *tri_ext, const float *tex, int tex_pages,  \
      int tex_h, int tex_w, const float *env_tab, const float *env_col,                 \
      const float *env_row, int env_h, int env_w, int env_mode, float env_row_pick,     \
      int thinlens, int full
#define DRMLT_EXT_ARGS                                                                   \
  sph, n_sphs, tri_ext, tex, tex_pages, tex_h, tex_w, env_tab, env_col, env_row, env_h, \
      env_w, env_mode, env_row_pick, thinlens

__host__ inline TablesX with_ext(const Tables& tb, const float* sph, int n_sphs,
                                 const float* tri_ext, const float* tex, int tex_pages, int tex_h,
                                 int tex_w, const float* env_tab, const float* env_col,
                                 const float* env_row, int env_h, int env_w, int env_mode,
                                 float env_row_pick, int thinlens) {
  TablesX t;
  static_cast<Tables&>(t) = tb;
  t.x = SceneExt{sph,     n_sphs,  tri_ext, tex,   tex_pages, tex_h,        tex_w,   env_tab,
                 env_col, env_row, env_h,   env_w, env_mode,  env_row_pick, thinlens};
  return t;
}

// The BVH arguments of every entry point, as they arrive from ctypes.
__host__ __forceinline__ void set_bvh(Tables& tb, const float* node, const float* rec,
                                      int n_nodes) {
  tb.node = reinterpret_cast<const float4*>(node);
  tb.rec = reinterpret_cast<const float4*>(rec);
  tb.n_nodes = n_nodes;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 ld3(const float* p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 normalize(V3 v) {
  float n = sqrtf(fmaxf(dot(v, v), 1e-30f));
  return {v.x / n, v.y / n, v.z / n};
}
__device__ __forceinline__ float lum(V3 c) {
  return 0.212671f * c.x + 0.715160f * c.y + 0.072169f * c.z;
}
__device__ __forceinline__ float mis_power(float a, float b) {
  float a2 = a * a, b2 = b * b, s = a2 + b2;
  return s > 0.0f ? a2 / s : 0.0f;
}
__device__ __forceinline__ float clamp01(float v) { return fminf(fmaxf(v, 0.0f), 1.0f); }
__device__ __forceinline__ float safe_div(float a, float b) {
  return fabsf(b) > 0.0f ? a / b : 0.0f;
}

// Reflective [0, 1] wrap: floor-mod 2 (jnp.mod's sign of the divisor, not
// fmodf's sign of the dividend), then reflect (1, 2] onto [0, 1).
__device__ __forceinline__ float pss_wrap(float y) {
  float t = y - 2.0f * floorf(y * 0.5f);
  return t > 1.0f ? 2.0f - t : t;
}

// Duff et al. 2017 branchless frame (core/frame.py)
struct Frame {
  V3 s, t, n;
};
__device__ __forceinline__ Frame make_frame(V3 n) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + n.z);
  float b = n.x * n.y * a;
  return {v3(1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x),
          v3(b, sign + n.y * n.y * a, -n.y), n};
}
__device__ __forceinline__ V3 to_local(const Frame& f, V3 v) {
  return {dot(v, f.s), dot(v, f.t), dot(v, f.n)};
}
__device__ __forceinline__ V3 to_world(const Frame& f, V3 v) {
  return {v.x * f.s.x + v.y * f.t.x + v.z * f.n.x,
          v.x * f.s.y + v.y * f.t.y + v.z * f.n.y,
          v.x * f.s.z + v.y * f.t.z + v.z * f.n.z};
}

// Shirley-Chiu concentric disk (core/warp.py)
__device__ __forceinline__ void concentric_disk(float u1, float u2, float* px, float* py) {
  float x = 2.0f * u1 - 1.0f;
  float y = 2.0f * u2 - 1.0f;
  bool zero = (x == 0.0f) && (y == 0.0f);
  bool use_x = fabsf(x) > fabsf(y);
  float r = use_x ? x : y;
  float ratio = use_x ? (x != 0.0f ? y / x : 0.0f) : (y != 0.0f ? x / y : 0.0f);
  float phi = use_x ? kPi4 * ratio : kPi2 - kPi4 * ratio;
  if (zero) r = 0.0f;
  *px = r * cosf(phi);
  *py = r * sinf(phi);
}

// concentric disk -> cosine hemisphere (core/warp.py)
__device__ __forceinline__ V3 cosine_hemisphere(float u1, float u2) {
  float px, py;
  concentric_disk(u1, u2, &px, &py);
  return {px, py, sqrtf(fmaxf(1.0f - px * px - py * py, 0.0f))};
}

// Qualitative Oren-Nayar factor (roughdiffuse.cpp "fast" mode; reference
// megatrace.py:_oren_nayar_term); the roughness column is sigma.  Out of
// line: inlined, the branch cost the chain kernel ~2% on scenes where no
// material takes it (scripts/chain_kernel_ab.py, H100).
static __device__ __noinline__ float oren_nayar(V3 wi, V3 wo, float sigma) {
  float s2 = sigma * sigma;
  float a_on = 1.0f - 0.5f * s2 / (s2 + 0.33f);
  float b_on = 0.45f * s2 / (s2 + 0.09f);
  float ci = fabsf(wi.z), co = fabsf(wo.z);
  float sin_i = sqrtf(fmaxf(1.0f - ci * ci, 0.0f));
  float sin_o = sqrtf(fmaxf(1.0f - co * co, 0.0f));
  float denom = fmaxf(sin_i * sin_o, 1e-7f);
  float cos_dphi = fminf(fmaxf((wi.x * wo.x + wi.y * wo.y) / denom, -1.0f), 1.0f);
  float sin_alpha = fmaxf(sin_i, sin_o);
  float tan_beta = fminf(sin_i / fmaxf(ci, 1e-7f), sin_o / fmaxf(co, 1e-7f));
  return a_on + b_on * fmaxf(cos_dphi, 0.0f) * sin_alpha * tan_beta;
}

struct BsdfSample {
  V3 wo, weight;   // local direction; f * |cos| / pdf
  float pdf, eta;  // solid-angle pdf (0 for a delta lobe); IOR crossed
  bool delta;
};

// ---- the full scope's BSDF kinds (megatrace.py:202-278, 1602-1795) ----

// Conductor Fresnel reflectance of one channel, complex IOR e + i k
// (megatrace.py:_fresnel_cond1)
__device__ __forceinline__ float fresnel_cond1(float ci, float e, float k) {
  ci = clamp01(ci);
  const float c2 = ci * ci;
  const float s2 = 1.0f - c2;
  const float e2 = e * e;
  const float k2 = k * k;
  const float t0 = e2 - k2 - s2;
  const float a2b2 = sqrtf(fmaxf(t0 * t0 + 4.0f * e2 * k2, 0.0f));
  const float t1 = a2b2 + c2;
  const float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 0.0f));
  const float t2 = 2.0f * a * ci;
  const float rs = t1 + t2 > 0.0f ? (t1 - t2) / fmaxf(t1 + t2, 1e-30f) : 0.0f;
  const float t3 = c2 * a2b2 + s2 * s2;
  const float t4 = t2 * s2;
  const float rp = rs * (t3 + t4 > 0.0f ? (t3 - t4) / fmaxf(t3 + t4, 1e-30f) : 0.0f);
  return 0.5f * (rp + rs);
}
__device__ __forceinline__ V3 fresnel_cond(float ci, V3 e, V3 k) {
  return {fresnel_cond1(ci, e.x, k.x), fresnel_cond1(ci, e.y, k.y), fresnel_cond1(ci, e.z, k.z)};
}

// GGX (render/microfacet.py): Smith Lambda, G1, height-correlated G2, D
__device__ __forceinline__ float ggx_lambda(float cz, float a) {
  cz = fabsf(cz);
  const float s2 = fmaxf(1.0f - cz * cz, 0.0f);
  const float a2 = a * a;
  return 0.5f * (sqrtf(fmaxf(1.0f + a2 * s2 / fmaxf(cz * cz, 1e-12f), 0.0f)) - 1.0f);
}
__device__ __forceinline__ float ggx_g1(float cz, float a) { return 1.0f / (1.0f + ggx_lambda(cz, a)); }
__device__ __forceinline__ float ggx_g2(float ci, float co, float a) {
  return 1.0f / (1.0f + ggx_lambda(ci, a) + ggx_lambda(co, a));
}
__device__ __forceinline__ float ggx_ndf(float mz, float a) {
  const float a2 = a * a;
  const float c2 = mz * mz;
  const float den = c2 * (a2 - 1.0f) + 1.0f;
  const float d = a2 / fmaxf(kPi * den * den, 1e-12f);
  return mz > 0.0f ? d : 0.0f;
}
// pdf of ggx_sample_vndf in the half-vector measure
__device__ __forceinline__ float ggx_vndf_pdf(V3 wi, V3 m, float a) {
  return ggx_g1(wi.z, a) * fmaxf(dot(wi, m), 0.0f) * ggx_ndf(m.z, a) / fmaxf(fabsf(wi.z), 1e-12f);
}
// Heitz 2018 visible-normal sample around wi (upper hemisphere)
__device__ __forceinline__ V3 ggx_sample_vndf(V3 wi, float a, float u1, float u2) {
  V3 v = v3(a * wi.x, a * wi.y, wi.z);
  const float nv = sqrtf(fmaxf(dot(v, v), 1e-24f));
  v = v3(v.x / nv, v.y / nv, v.z / nv);
  const float lensq = v.x * v.x + v.y * v.y;
  const float nl = sqrtf(fmaxf(lensq, 1e-20f));
  const V3 t1 = lensq > 1e-18f ? v3(-v.y / nl, v.x / nl, 0.0f) : v3(1.0f, 0.0f, 0.0f);
  const V3 t2 = cross(v, t1);
  const float r = sqrtf(fmaxf(u1, 0.0f));
  const float phi = kTwoPi * u2;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float s = 0.5f * (1.0f + v.z);
  p2 = (1.0f - s) * sqrtf(fmaxf(1.0f - p1 * p1, 0.0f)) + s * p2;
  const float p3 = sqrtf(fmaxf(1.0f - p1 * p1 - p2 * p2, 0.0f));
  const V3 n = p1 * t1 + p2 * t2 + p3 * v;
  return normalize(v3(a * n.x, a * n.y, fmaxf(n.z, 1e-6f)));
}

// f * |cos_o| and pdf of the GGX conductor at material row mr; out of
// line, as the other long lobes a scene may not have
static __device__ __noinline__ V3 rough_conductor_eval(const float* mr, V3 wi, V3 wo, float* pdf) {
  const float alpha = __ldg(mr + 10);
  V3 h = normalize(wo + wi);
  h = h * (h.z < 0.0f ? -1.0f : 1.0f);
  const float si = wi.z < 0.0f ? -1.0f : 1.0f;
  const float d = ggx_ndf(h.z, alpha);
  const float g = ggx_g2(wi.z * si, wo.z * si, alpha);
  const V3 f = fresnel_cond(fabsf(dot(wi, h)), ld3(mr + 4), ld3(mr + 7));
  const float denom = 4.0f * fabsf(wi.z);
  const float base = denom > 0.0f ? d * g / fmaxf(denom, 1e-30f) : 0.0f;
  const float m_pdf = ggx_vndf_pdf(wi * si, h, alpha);
  *pdf = m_pdf / fmaxf(4.0f * fabsf(dot(wo, h)), 1e-12f);
  return ld3(mr + 11) * f * base;
}

// A GGX visible-normal sample of the conductor: direction, weight, pdf
static __device__ __noinline__ BsdfSample rough_conductor_sample(const float* mr, V3 wi,
                                                                 float sign_i, float ub1,
                                                                 float ub2) {
  const float alpha = __ldg(mr + 10);
  const V3 wi_u = wi * sign_i;
  const V3 m = ggx_sample_vndf(wi_u, alpha, ub1, ub2);
  const float im = dot(wi_u, m);
  const V3 r = (2.0f * im) * m - wi_u;
  const float m_pdf = ggx_vndf_pdf(wi_u, m, alpha);
  const float pdf = m_pdf / fmaxf(4.0f * fabsf(dot(r, m)), 1e-12f);
  const float g2 = ggx_g2(wi_u.z, r.z, alpha);
  const float g1 = ggx_g1(wi_u.z, alpha);
  const float gw = g1 > 0.0f ? g2 / fmaxf(g1, 1e-20f) : 0.0f;
  const V3 f = fresnel_cond(fabsf(im), ld3(mr + 4), ld3(mr + 7)) * gw;
  const bool ok = r.z > 0.0f;
  return {r * sign_i, ok ? ld3(mr + 11) * f : v3(0.0f, 0.0f, 0.0f), ok ? pdf : 0.0f, 1.0f,
          false};
}

// The delta kinds: mirror and dielectric; X adds the smooth conductor and null.
template <bool X>
__device__ __forceinline__ bool is_delta(int kind) {
  return kind == kMirror || kind == kDielectric || (X && (kind == kConductor || kind == kNull));
}

// f * |cos_o| and the solid-angle pdf of material row mr for local
// directions wi (incident; wi.z is its cosine) and wo; the delta kinds
// evaluate to zero (megatrace.py:_eval_kinds).  X: the full scope, whose
// diffuse lobes take the albedo alb (the row's constant or a texel lookup)
// and which adds the GGX conductor; X = false reads the row's constant.
template <bool X>
__device__ __forceinline__ V3 eval_bsdf(int kind, const float* mr, V3 alb, V3 wi, V3 wo,
                                        float* pdf) {
  const float abs_co = fabsf(wo.z);
  if ((kind == kDiffuse || kind == kRoughDiffuse) && (wi.z * wo.z) > 0.0f) {
    float scale = abs_co / kPi;
    if (kind == kRoughDiffuse) scale = scale * oren_nayar(wi, wo, __ldg(mr + 10));
    *pdf = fmaxf(abs_co, 0.0f) / kPi;
    if constexpr (X) {
      return alb * scale;
    } else {
      return ld3(mr + 1) * scale;
    }
  }
  if constexpr (X) {
    if (kind == kRoughConductor && (wi.z * wo.z) > 0.0f) {
      return rough_conductor_eval(mr, wi, wo, pdf);
    }
  }
  *pdf = 0.0f;
  return v3(0.0f, 0.0f, 0.0f);
}

// Sample an outgoing local direction at material row mr
// (megatrace.py:_sample_kinds): uc picks the dielectric lobe, (ub1, ub2)
// the direction.  X and alb as in eval_bsdf; X adds the smooth and rough
// conductors and the null pass-through.
template <bool X>
__device__ __forceinline__ BsdfSample sample_bsdf(int kind, const float* mr, V3 alb, V3 wi,
                                                  float uc, float ub1, float ub2) {
  BsdfSample s{v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f), 0.0f, 1.0f, false};
  const float cos_i = wi.z;
  const float sign_i = cos_i < 0.0f ? -1.0f : 1.0f;
  if (kind == kDiffuse || kind == kRoughDiffuse) {
    s.wo = cosine_hemisphere(ub1, ub2) * sign_i;
    s.pdf = fmaxf(s.wo.z * sign_i, 0.0f) / kPi;
    if constexpr (X) {
      s.weight = alb;
    } else {
      s.weight = ld3(mr + 1);
    }
    if (kind == kRoughDiffuse) s.weight = s.weight * oren_nayar(wi, s.wo, __ldg(mr + 10));
  } else if (kind == kMirror) {
    s.wo = v3(-wi.x, -wi.y, wi.z);
    s.weight = ld3(mr + 11);
    s.delta = true;
  } else if (kind == kDielectric) {
    // smooth dielectric: reflect with probability F, else refract
    float eta_d = __ldg(mr + 4);
    float eta_it = cos_i > 0.0f ? eta_d : 1.0f / eta_d;
    float ci = fabsf(cos_i);
    float sin2_t = (1.0f - ci * ci) / (eta_it * eta_it);
    float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
    float r_s = safe_div(ci - eta_it * cos_t, ci + eta_it * cos_t);
    float r_p = safe_div(eta_it * ci - cos_t, eta_it * ci + cos_t);
    float f_d = sin2_t >= 1.0f ? 1.0f : 0.5f * (r_s * r_s + r_p * r_p);
    if (uc < f_d) {
      s.wo = v3(-wi.x, -wi.y, wi.z);
      s.weight = ld3(mr + 11);
    } else {
      float eta_ti = cos_i > 0.0f ? 1.0f / eta_d : eta_d;
      s.wo = v3(-wi.x * eta_ti, -wi.y * eta_ti, cos_i > 0.0f ? -cos_t : cos_t);
      s.weight = ld3(mr + 14) * eta_ti * eta_ti;
      s.eta = cos_i > 0.0f ? eta_d : 1.0f / eta_d;
    }
    s.delta = true;
  } else if constexpr (X) {
    if (kind == kConductor) {
      s.wo = v3(-wi.x, -wi.y, wi.z);
      s.weight = ld3(mr + 11) * fresnel_cond(fabsf(wi.z), ld3(mr + 4), ld3(mr + 7));
      s.delta = true;
    } else if (kind == kRoughConductor) {
      s = rough_conductor_sample(mr, wi, sign_i, ub1, ub2);
    } else if (kind == kNull) {
      s.wo = -wi;
      s.weight = v3(1.0f, 1.0f, 1.0f);
      s.delta = true;
    }
  }
  return s;
}

// ---- analytic spheres (megatrace.py:1058-1103) -------------------------

// The hit distance of ray (o, d) against sphere row s: the near root above
// kRayEps, else the far one; false on a miss or an invalid row.
__device__ __forceinline__ bool sphere_t(const float* s, V3 o, V3 d, float* t) {
  const V3 oc = o - ld3(s);
  const float r = __ldg(s + 3);
  const float bq = dot(oc, d);
  const float cq = dot(oc, oc) - r * r;
  const float disc = bq * bq - cq;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float t0 = -bq - sq;
  const float t1 = -bq + sq;
  *t = t0 > kRayEps ? t0 : t1;
  return disc >= 0.0f && __ldg(s + 6) > 0.5f && *t > kRayEps;
}

// The closest sphere nearer than t_best: its distance, its row in *idx
// (left alone when none is nearer)
__device__ __forceinline__ float sphere_closest(const float* sph, int n, V3 o, V3 d, float t_best,
                                                int* idx) {
  for (int i = 0; i < n; ++i) {
    float t;
    if (sphere_t(sph + i * kSphCols, o, d, &t) && t < t_best) {
      t_best = t;
      *idx = i;
    }
  }
  return t_best;
}

__device__ __forceinline__ bool sphere_blocked(const float* sph, int n, V3 o, V3 d, float tmax) {
  for (int i = 0; i < n; ++i) {
    float t;
    if (sphere_t(sph + i * kSphCols, o, d, &t) && t < tmax) return true;
  }
  return false;
}

// ---- bitmap albedo (megatrace.py:tex_albedo_tile, :802) -----------------
static __device__ __noinline__ V3 tex_albedo(const float* tex, int pages, int th, int tw,
                                             float tid, float tu, float tv) {
  const float x = clamp01(tu - floorf(tu)) * (float)(tw - 1);
  const float y = clamp01(tv - floorf(tv)) * (float)(th - 1);
  const float x0 = floorf(x), y0 = floorf(y);
  const float x1 = fminf(x0 + 1.0f, (float)(tw - 1));
  const float y1 = fminf(y0 + 1.0f, (float)(th - 1));
  const float fx = x - x0, fy = y - y0;
  const float page = fminf(fmaxf(tid, 0.0f), (float)(pages - 1)) * (float)(th * tw);
  const float* t00 = tex + 4 * (long)(page + y0 * (float)tw + x0);
  const float* t01 = tex + 4 * (long)(page + y0 * (float)tw + x1);
  const float* t10 = tex + 4 * (long)(page + y1 * (float)tw + x0);
  const float* t11 = tex + 4 * (long)(page + y1 * (float)tw + x1);
  V3 c = ld3(t00) * ((1.0f - fx) * (1.0f - fy));
  c = c + ld3(t01) * (fx * (1.0f - fy));
  c = c + ld3(t10) * ((1.0f - fx) * fy);
  return c + ld3(t11) * (fx * fy);
}

// A material row's albedo: its bitmap page at (tu, tv), else its constant.
__device__ __forceinline__ V3 albedo_x(const TablesX& tb, const float* mr, float tu, float tv) {
  const float tid = __ldg(mr + 17);
  if (tb.x.tex_pages && tid >= 0.0f) {
    return tex_albedo(tb.x.tex, tb.x.tex_pages, tb.x.tex_h, tb.x.tex_w, tid, tu, tv);
  }
  return ld3(mr + 1);
}

// ---- the lat-long environment (render/emitter.py, megatrace.py:1106-1158)

__device__ __forceinline__ void env_dir_uv(V3 d, float* u, float* v) {
  const float theta = acosf(fminf(fmaxf(d.y, -1.0f), 1.0f));
  const float phi = atan2f(d.x, -d.z);
  *u = (phi / kPi + 1.0f) * 0.5f;
  *v = theta / kPi;
}

// bilinear radiance at lat-long (u, v), wrapping in u, clamping in v
static __device__ __noinline__ V3 env_bilinear(const float* tab, int he, int we, float u, float v) {
  const float x = fminf(fmaxf(u, 0.0f), kUMax) * (float)we - 0.5f;
  const float y = fminf(fmaxf(v, 0.0f), kUMax) * (float)he - 0.5f;
  const float x0 = fminf(fmaxf(floorf(x), 0.0f), (float)(we - 1));
  const float y0 = fminf(fmaxf(floorf(y), 0.0f), (float)(he - 1));
  float x1 = x0 + 1.0f;
  if (x1 >= (float)we) x1 -= (float)we;
  const float y1 = fminf(y0 + 1.0f, (float)(he - 1));
  const float fx = clamp01(x - x0), fy = clamp01(y - y0);
  V3 c = ld3(tab + 4 * (long)(y0 * (float)we + x0)) * ((1.0f - fx) * (1.0f - fy));
  c = c + ld3(tab + 4 * (long)(y0 * (float)we + x1)) * (fx * (1.0f - fy));
  c = c + ld3(tab + 4 * (long)(y1 * (float)we + x0)) * ((1.0f - fx) * fy);
  return c + ld3(tab + 4 * (long)(y1 * (float)we + x1)) * (fx * fy);
}

// solid-angle pdf of the environment's importance sampling at (u, v),
// without the row's pick pmf
__device__ __forceinline__ float env_pdf_sa(const float* tab, int he, int we, float u, float v,
                                            float dy) {
  const float xn = fminf(fmaxf(floorf(u * (float)we), 0.0f), (float)(we - 1));
  const float yn = fminf(fmaxf(floorf(v * (float)he), 0.0f), (float)(he - 1));
  const float pmf = __ldg(tab + 4 * (long)(yn * (float)we + xn) + 3);
  const float sin_t = fmaxf(sinf(acosf(fminf(fmaxf(dy, -1.0f), 1.0f))), 1e-6f);
  return pmf * (float)(he * we) / (kTwoPiSq * sin_t);
}

// The count of a[0..n) <= u in a sorted array (searchsorted, side right).
__device__ __forceinline__ int upper_bound(const float* a, int n, float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(a + mid) <= u) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

struct EnvSample {
  V3 dir, rad;
  float pdf;   // solid angle, without the row's pick pmf
};

// Importance-sample the image with (u1, u2): the row cdf, then the row's
// column cdf, each inverted by a binary search, the cdf residuals reused
// as the jitter inside the pixel (emitter.sample_emitter_direct)
static __device__ __noinline__ EnvSample env_sample(const float* tab, const float* col,
                                                    const float* row, int he, int we, float u1,
                                                    float u2) {
  const int y = min(upper_bound(row, he, u1), he - 1);
  const float* cr = col + (long)y * we;
  const int xi = min(upper_bound(cr, we, u2), we - 1);
  const float row_lo = y > 0 ? __ldg(row + y - 1) : 0.0f;
  const float row_hi = __ldg(row + y);
  const float ju = fminf(fmaxf((u1 - row_lo) / fmaxf(row_hi - row_lo, 1e-12f), 0.0f), kUMax);
  const float col_lo = xi > 0 ? __ldg(cr + xi - 1) : 0.0f;
  const float col_hi = __ldg(cr + xi);
  const float jv = fminf(fmaxf((u2 - col_lo) / fmaxf(col_hi - col_lo, 1e-12f), 0.0f), kUMax);
  const float ue = ((float)xi + jv) / (float)we;
  const float ve = ((float)y + ju) / (float)he;
  const float th = ve * kPi;
  const float st = sinf(th);
  const float ph = (ue * 2.0f - 1.0f) * kPi;
  const float pmf = __ldg(tab + 4 * ((long)y * we + xi) + 3);
  return {v3(st * sinf(ph), cosf(th), -st * cosf(ph)), env_bilinear(tab, he, we, ue, ve),
          pmf * (float)(he * we) / (kTwoPiSq * fmaxf(st, 1e-6f))};
}

// Moller-Trumbore test of ray (o, d) against the triangle v0 + (b1 e1 +
// b2 e2): true on a hit with t > kRayEps, its distance in *t_hit.  The
// sweeps below and the BVH walk of bvh.cuh test with these expressions in
// this order, so they round alike (ops/intersect.py:moller_trumbore is the
// twin).
__device__ __forceinline__ bool tri_hit(V3 v0, V3 e1, V3 e2, V3 o, V3 d, float* t_hit) {
  V3 p = cross(d, e2);
  float det = dot(e1, p);
  bool ok = fabsf(det) > 1e-12f;
  float inv = 1.0f / (ok ? det : 1.0f);
  V3 t = o - v0;
  float b1 = dot(t, p) * inv;
  V3 q = cross(t, e1);
  float b2 = dot(d, q) * inv;
  float tt = dot(e2, q) * inv;
  *t_hit = tt;
  return ok && b1 >= 0.0f && b2 >= 0.0f && b1 + b2 <= 1.0f && tt > kRayEps;
}

// v0, e1 and e2 of triangle i from its row of the (T, 20) table: three
// 16-byte loads (a row is 80 bytes, so each starts on a 16-byte boundary;
// the wrappers check the table's alignment) instead of nine scalar ones.
__device__ __forceinline__ bool tri_row_hit(const float* tri, int i, V3 o, V3 d, float* t_hit) {
  const float4* r = reinterpret_cast<const float4*>(tri + i * kTriCols);
  const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
  return tri_hit(v3(a.x, a.y, a.z), v3(a.w, b.x, b.y), v3(b.z, b.w, c.x), o, d, t_hit);
}

}  // namespace drmlt

#include "bvh.cuh"

namespace drmlt {

// Closest hit: the BVH walk when the tables carry one, else a sweep over
// every triangle, whose strict `<` keeps the lower triangle index on a
// tie, as the reference sweep does (the walk breaks ties the same way).
static __device__ float closest_hit(const Tables& tb, V3 o, V3 d, int* best_id) {
  if (tb.n_nodes > 0) return bvh_closest(tb, o, d, best_id);
  float best_t = kInf;
  int best = -1;
  for (int i = 0; i < tb.n_tris; ++i) {
    float tt;
    if (tri_row_hit(tb.tri, i, o, d, &tt) && tt < best_t) {
      best_t = tt;
      best = i;
    }
  }
  *best_id = best;
  return best_t;
}

// Any hit with kRayEps < t < tmax (the walk when the tables carry a BVH).
static __device__ bool occluded(const Tables& tb, V3 o, V3 d, float tmax) {
  if (tb.n_nodes > 0) return bvh_occluded(tb, o, d, tmax);
  for (int i = 0; i < tb.n_tris; ++i) {
    float tt;
    if (tri_row_hit(tb.tri, i, o, d, &tt) && tt < tmax) return true;
  }
  return false;
}

// Primary-sample dims of one lane, read through a pointer and a stride
// (dim j of lane c lives at base[j * stride]).  mode 0 reads a[j];
// mode 1 reads pss_wrap(a[j]) (a chain proposal from its unwrapped form);
// mode 2 reads pss_wrap(a[j] - (b[j] - x[j])) (green's reverse path
// y* = z - (y - x)).
struct PssView {
  const float* a;
  const float* b;
  const float* x;
  long stride;
  int mode;
  __device__ __forceinline__ float operator()(int j) const {
    long k = (long)j * stride;
    if (mode == 0) return a[k];
    if (mode == 1) return pss_wrap(a[k]);
    return pss_wrap(a[k] - (b[k] - x[k]));
  }
};

// Gradient modes of the trace body: none (the path kernel and the chain
// kernel), emitter radiance (path_trace_rad_kernel) or material albedo
// (path_trace_alb_kernel), as the reference's emit_grad / albedo_grad
// (megatrace.py:886-915).
constexpr int kGradNone = 0;
constexpr int kGradEmit = 1;
constexpr int kGradAlbedo = 2;

// A path's Jacobian rows: row k at rows[k * stride], rows 3e+c holding d
// value[c] / d radiance[e, c] (emit) or 3m+c d value[c] / d albedo[m, c]
// (albedo); in albedo mode pw[m * stride] is the power of material m in
// the path so far (its diffuse-like bounces there), as the reference's
// per-material counts.  Where they live is the adjoint kernels' choice
// (path_trace_grad.cu: a column of a block's shared array, or of the
// (3K, R) output and a (K, R) scratch); the no-gradient body never reads
// them.
struct GradRows {
  float* rows;
  float* pw;
  long stride;
  __device__ __forceinline__ void add(int k, float v) const { rows[(long)k * stride] += v; }
};

// Albedo mode: a contribution c is a polynomial in the albedos, with power
// pw_m of material m, so d c / d al_m = c * pw_m / al_m; a black channel
// (al <= 1e-12) gets 0, as in the reference.  Materials not on the path
// (pw_m = 0) are skipped: their rows would gain c * 0.
__device__ __forceinline__ void albedo_rows(const Tables& tb, const GradRows& g, V3 c) {
  const float cc[3] = {c.x, c.y, c.z};
  for (int m = 0; m < tb.n_mats; ++m) {
    const float pw = g.pw[(long)m * g.stride];
    if (pw == 0.0f) continue;
    const float* al = tb.mat + m * kMatCols + 1;
    for (int ch = 0; ch < 3; ++ch) {
      float a = __ldg(al + ch);
      float gm = a > 1e-12f ? pw / fmaxf(a, 1e-12f) : 0.0f;
      g.add(3 * m + ch, cc[ch] * gm);
    }
  }
}

// The camera ray of film position (cx, cy) (already scaled by the tan of
// the half fields of view): a pinhole at cam[9:12], or with a thin lens
// (X only) an origin on the aperture disk from u(2), u(3) and a direction
// through the point of the focus plane (megatrace.py:852-889).
template <bool X>
__device__ __forceinline__ void camera_ray(const TabT<X>& tb, const PssView& u, float cx,
                                           float cy, V3* o, V3* d) {
  const float* cam = tb.cam;
  if constexpr (X) {
    if (tb.x.thinlens) {
      float lx, ly;
      concentric_disk(u(2), u(3), &lx, &ly);
      lx = lx * cam[14];
      ly = ly * cam[14];
      const float f_d = cam[15];
      const V3 dc = v3(cx * f_d - lx, cy * f_d - ly, f_d);
      *d = normalize(v3(dot(ld3(cam), dc), dot(ld3(cam + 3), dc), dot(ld3(cam + 6), dc)));
      *o = v3(cam[0] * lx + cam[1] * ly + cam[9], cam[3] * lx + cam[4] * ly + cam[10],
              cam[6] * lx + cam[7] * ly + cam[11]);
      return;
    }
  }
  V3 dc = v3(cx, cy, 1.0f);
  *d = normalize(v3(dot(ld3(cam), dc), dot(ld3(cam + 3), dc), dot(ld3(cam + 6), dc)));
  *o = ld3(cam + 9);
}

// The state a path carries from one bounce to the next (the ray, the
// throughput, the radiance so far, the previous vertex's BSDF pdf and
// delta flag, the eta scale of Russian roulette): 15 words, in every
// gradient mode (the rows and counts stay where GradRows points).
struct PathState {
  V3 o, d, tp, L;
  float prev_pdf, eta_scale;
  bool prev_delta;
};

// A lane's state before its first bounce: the camera ray.
template <bool X>
__device__ __forceinline__ PathState path_start(const TabT<X>& tb, const PssView& u) {
  const float* cam = tb.cam;
  float cx = (2.0f * u(0) - 1.0f) * cam[12];
  float cy = (1.0f - 2.0f * u(1)) * cam[13];
  PathState s;
  camera_ray<X>(tb, u, cx, cy, &s.o, &s.d);
  s.tp = v3(1.0f, 1.0f, 1.0f);
  s.L = v3(0.0f, 0.0f, 0.0f);
  s.prev_pdf = 0.0f;
  s.prev_delta = true;
  s.eta_scale = 1.0f;
  return s;
}

// Bounces depth .. last of a path, each the closest hit, emission, NEE and
// the BSDF sample, which moves the state to the next ray.  False when the
// path has ended (escaped, dead throughput, Russian roulette or
// max_depth), its radiance then final in s.L.  In a gradient mode it also
// adds the lane's Jacobian rows to g.  trace_body runs every bounce in one
// call; the path kernel one bounce a call.  The loop sits inside this one
// inlined body: with it outside (a call per bounce, however inlined) the
// trace body took 6 more registers and the chain kernel spilled (PERF.md
// §6).
template <int G, bool X>
__device__ __forceinline__ bool bounces(const TabT<X>& tb, const PssView& u, const GradRows& g,
                                        PathState& s, int depth, int last) {
  const float* cam = tb.cam;
  V3& o = s.o;
  V3& d = s.d;
  V3& tp = s.tp;
  V3& L = s.L;
  float& prev_pdf = s.prev_pdf;
  bool& prev_delta = s.prev_delta;
  float& eta_scale = s.eta_scale;

  for (; depth <= last; ++depth) {
    const int base = kSensorDims + (depth - 1) * kBounceDims;
    int id;
    float t_hit = closest_hit(tb, o, d, &id);
    int sph = -1;
    if constexpr (X) {
      if (tb.x.n_sphs) t_hit = sphere_closest(tb.x.sph, tb.x.n_sphs, o, d, t_hit, &sph);
    }
    if (id < 0 && sph < 0) {
      if constexpr (X) {
        // the environment on escape: a constant one has no NEE row and
        // weight 1; an image is MIS'd against its NEE at the previous vertex
        const SceneExt& x = tb.x;
        if (x.env_mode && depth >= tb.min_depth) {
          V3 c;
          if (x.env_mode == kEnvConstant) {
            c = tp * ld3(cam + 16);
          } else {
            float eu, ev, w = 1.0f;
            env_dir_uv(d, &eu, &ev);
            if (tb.use_nee && !prev_delta) {
              w = mis_power(prev_pdf, env_pdf_sa(x.env_tab, x.env_h, x.env_w, eu, ev, d.y) *
                                          x.env_row_pick);
            }
            c = tp * env_bilinear(x.env_tab, x.env_h, x.env_w, eu, ev) * w;
          }
          L = L + c;
          if constexpr (G == kGradAlbedo) albedo_rows(tb, g, c);
        }
      }
      return false;   // escaped
    }

    V3 hp, ng, ns;
    int mat_id, erow;
    float tu = 0.0f, tv = 0.0f;
    bool on_sphere = false;
    if constexpr (X) on_sphere = sph >= 0;
    if (on_sphere) {
      if constexpr (X) {
        // an analytic sphere: ng = ns = (hp - center) / radius
        const float* sr = tb.x.sph + sph * kSphCols;
        hp = o + t_hit * d;
        ng = (hp - ld3(sr)) * (1.0f / fmaxf(__ldg(sr + 3), 1e-20f));
        ns = ng;
        mat_id = (int)__ldg(sr + 4);
        erow = (int)__ldg(sr + 5);
        if (tb.x.tex_pages) {
          tu = acosf(fminf(fmaxf(ng.z, -1.0f), 1.0f)) / kPi;
          tv = atan2f(ng.y, ng.x) / kTwoPi + 0.5f;
        }
      }
    } else {
      const float* av = tb.tri + id * kTriCols;
      V3 e1 = ld3(av + 3), e2 = ld3(av + 6);
      hp = o + t_hit * d;
      V3 p = cross(d, e2);
      float det = dot(e1, p);
      float inv = 1.0f / (fabsf(det) > 1e-12f ? det : 1.0f);
      V3 t = o - ld3(av);
      float b1 = clamp01(dot(t, p) * inv);
      float b2 = clamp01(dot(d, cross(t, e1)) * inv);
      float w0 = 1.0f - b1 - b2;
      ng = normalize(cross(e1, e2));
      ns = normalize(w0 * ld3(av + 9) + b1 * ld3(av + 12) + b2 * ld3(av + 15));
      erow = (int)__ldg(av + 19);
      mat_id = (int)__ldg(av + 18);
      if constexpr (X) {
        if (tb.x.tex_pages) {
          const float* ex = tb.x.tri_ext + id * kTriExtCols;
          tu = w0 * __ldg(ex + 20) + b1 * __ldg(ex + 22) + b2 * __ldg(ex + 24);
          tv = w0 * __ldg(ex + 21) + b1 * __ldg(ex + 23) + b2 * __ldg(ex + 25);
        }
      }
    }

    const float* mr = tb.mat + mat_id * kMatCols;
    const int kind = (int)__ldg(mr);
    V3 alb = v3(0.0f, 0.0f, 0.0f);
    if constexpr (X) alb = albedo_x(tb, mr, tu, tv);

    // ---- emission at the hit, MIS'd against NEE at the previous vertex
    float cos_l = -dot(d, ng);
    if (erow >= 0 && cos_l > 0.0f && depth >= tb.min_depth) {
      const float* er = tb.em + erow * kEmCols;
      float w_bsdf = 1.0f;
      if (tb.use_nee && !prev_delta) {
        float nee_pdf = __ldg(er + 4) * t_hit * t_hit / fmaxf(cos_l * __ldg(er + 3), 1e-30f);
        w_bsdf = mis_power(prev_pdf, nee_pdf);
      }
      L = L + tp * ld3(er) * w_bsdf;
      if constexpr (G == kGradEmit) {
        const V3 t_e = tp * w_bsdf;
        g.add(3 * erow, t_e.x);
        g.add(3 * erow + 1, t_e.y);
        g.add(3 * erow + 2, t_e.z);
      }
      if constexpr (G == kGradAlbedo) albedo_rows(tb, g, tp * ld3(er) * w_bsdf);
    }

    const Frame fr = make_frame(ns);
    const V3 wi = to_local(fr, -d);
    const bool delta_m = is_delta<X>(kind);
    if constexpr (G == kGradAlbedo) {
      // this vertex's albedo enters its NEE term and every later one
      if (kind == kDiffuse || kind == kRoughDiffuse) g.pw[(long)mat_id * g.stride] += 1.0f;
    }

    // ---- NEE: one emitter sample, immediate shadow sweep
    if (tb.use_nee && !delta_m && depth + 1 <= tb.max_depth && depth + 1 >= tb.min_depth) {
      float u_pick = u(base + kOffLightPick);
      float u_l1 = u(base + kOffLightU), u_l2 = u(base + kOffLightU + 1);
      int row = 0;
      for (int e = 0; e < tb.n_ems; ++e) row += (u_pick >= __ldg(tb.em + e * kEmCols + 5)) ? 1 : 0;
      row = min(row, tb.n_ems - 1);
      const float* lr = tb.em + row * kEmCols;
      V3 ldir, l_rad;   // l_rad: an environment sample's (area rows read lr)
      float dist, ds_pdf;
      bool env_row = false;
      if constexpr (X) env_row = tb.x.env_mode == kEnvImage && __ldg(lr + 18) == (float)kEnvRow;
      if (env_row) {
        if constexpr (X) {
          const SceneExt& x = tb.x;
          const EnvSample es =
              env_sample(x.env_tab, x.env_col, x.env_row, x.env_h, x.env_w, u_l1, u_l2);
          ldir = es.dir;
          l_rad = es.rad;
          dist = kDirDist;
          ds_pdf = __ldg(lr + 4) * es.pdf;
        }
      } else {
        float tw = sqrtf(fmaxf(1.0f - u_l1, 0.0f));
        float lb0 = 1.0f - tw;
        float lb1 = tw * u_l2;
        V3 pl = ld3(lr + 6) + lb0 * ld3(lr + 9) + lb1 * ld3(lr + 12);
        V3 tol = pl - hp;
        float dist2 = dot(tol, tol);
        dist = sqrtf(fmaxf(dist2, 1e-20f));
        ldir = v3(tol.x / dist, tol.y / dist, tol.z / dist);
        float lcos = -dot(ldir, ld3(lr + 15));
        float area = __ldg(lr + 3);
        ds_pdf = lcos * area > 0.0f ? __ldg(lr + 4) * dist2 / fmaxf(lcos * area, 1e-30f) : 0.0f;
        if (!(lcos > 1e-7f)) ds_pdf = 0.0f;
      }
      float f_pdf;
      const V3 f = eval_bsdf<X>(kind, mr, alb, wi, to_local(fr, ldir), &f_pdf);
      if (ds_pdf > 0.0f && lum(f) > 0.0f) {
        float eps_sh = kRayEps * fmaxf(t_hit, 1.0f);
        V3 sh_o = hp + ldir * eps_sh;
        float sh_tmax = dist * 0.999f - kRayEps;
        bool blocked = occluded(tb, sh_o, ldir, sh_tmax);
        if constexpr (X) {
          if (!blocked && tb.x.n_sphs) {
            blocked = sphere_blocked(tb.x.sph, tb.x.n_sphs, sh_o, ldir, sh_tmax);
          }
        }
        if (!blocked) {
          float w_nee = mis_power(ds_pdf, f_pdf);
          float inv_pdf = w_nee / fmaxf(ds_pdf, 1e-20f);
          if (env_row) {
            L = L + tp * f * l_rad * inv_pdf;
          } else {
            L = L + tp * f * ld3(lr) * inv_pdf;
          }
          if constexpr (G == kGradEmit) {
            // an environment row's radiance is its image's: no row for it
            if (!env_row) {
              const V3 t_e = tp * f * inv_pdf;
              g.add(3 * row, t_e.x);
              g.add(3 * row + 1, t_e.y);
              g.add(3 * row + 2, t_e.z);
            }
          }
          if constexpr (G == kGradAlbedo) {
            albedo_rows(tb, g, tp * f * (env_row ? l_rad : ld3(lr)) * inv_pdf);
          }
        }
      }
    }

    // ---- BSDF sampling
    const BsdfSample bs = sample_bsdf<X>(kind, mr, alb, wi, u(base + kOffBsdfCmp),
                                         u(base + kOffBsdfU), u(base + kOffBsdfU + 1));
    const V3 sw = bs.wo, bw = bs.weight;
    const float bs_pdf = bs.pdf, bs_eta = bs.eta;
    V3 wo_w = to_world(fr, sw);
    tp = tp * bw;
    eta_scale = eta_scale * bs_eta;
    bool alive = lum(tp) > 0.0f && depth + 1 <= tb.max_depth;

    // ---- Russian roulette
    if (depth >= tb.rr_depth) {
      float q = fminf(fmaxf(fmaxf(tp.x, tp.y), tp.z) * eta_scale * eta_scale, 0.95f);
      bool survive = u(base + kOffRR) < q;
      float inv_q = 1.0f / fmaxf(q, 1e-8f);
      if (survive) tp = tp * inv_q;
      alive = alive && survive;
    }
    if (!alive) return false;

    float eps_n = kRayEps * fmaxf(t_hit, 1.0f);
    o = hp + wo_w * eps_n;
    d = wo_w;
    prev_pdf = bs_pdf;
    prev_delta = delta_m;
  }
  return true;
}

// The path radiance of one lane; in a gradient mode it also adds the
// lane's Jacobian rows to g.  Inlined into each caller: the no-gradient
// instantiation is the body trace_path has always had.  X: the full
// scene scope (TablesX).
template <int G, bool X>
__device__ __forceinline__ V3 trace_body(const TabT<X>& tb, const PssView u, const GradRows g) {
  PathState s = path_start<X>(tb, u);
  bounces<G, X>(tb, u, g, s, 1, tb.max_depth);
  return s.L;
}

// The path radiance of one lane (the path kernel and the chain kernel).
template <bool X>
static __device__ __noinline__ V3 trace_path(const TabT<X>& tb, const PssView u) {
  return trace_body<kGradNone, X>(tb, u, GradRows{});
}

}  // namespace drmlt
