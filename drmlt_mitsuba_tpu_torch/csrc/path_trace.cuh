// One unidirectional path per thread: the device-side trace shared by
// path_trace.cu (bootstrap / MC trace) and drmlt_chain.cu (chain kernel),
// and the scene functions mmlt_trace.cuh shares with it.
//
// Port of the reference's Pallas trace body
// drmlt_mitsuba_tpu/ops/pallas/megatrace.py:path_trace_tile (:832) for the
// port's subset: triangles (brute sweep), area emitters, pinhole camera,
// BSDF kinds diffuse / rough diffuse (Oren-Nayar) / mirror / smooth
// dielectric.  The plain-PyTorch twin is
// ops/megatrace.py:path_trace_reference; every expression below keeps the
// twin's evaluation order, and the library is built with --fmad=false, so
// kernel and twin round alike.
//
// What is not carried over from the TPU kernel: the one-hot MXU row
// fetches (tables are indexed directly), the Cephes atan / acos (unused on
// this subset; libdevice would serve), the SMEM / VMEM sweep tiers and the
// (8, L) lane tiles.  A lane whose path has ended leaves the bounce loop
// (`break`): the TPU evaluates every lane to max_depth under masks.
#pragma once

#include <cstdint>
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
constexpr int kDielectric = 2;
constexpr int kMirror = 8;
constexpr int kRoughDiffuse = 12;

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
};

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

// Shirley-Chiu concentric disk -> cosine hemisphere (core/warp.py)
__device__ __forceinline__ V3 cosine_hemisphere(float u1, float u2) {
  float x = 2.0f * u1 - 1.0f;
  float y = 2.0f * u2 - 1.0f;
  bool zero = (x == 0.0f) && (y == 0.0f);
  bool use_x = fabsf(x) > fabsf(y);
  float r = use_x ? x : y;
  float ratio = use_x ? (x != 0.0f ? y / x : 0.0f) : (y != 0.0f ? x / y : 0.0f);
  float phi = use_x ? kPi4 * ratio : kPi2 - kPi4 * ratio;
  if (zero) r = 0.0f;
  float px = r * cosf(phi), py = r * sinf(phi);
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

__device__ __forceinline__ bool is_delta(int kind) { return kind == kMirror || kind == kDielectric; }

// f * |cos_o| and the solid-angle pdf of material row mr for local
// directions wi (incident; wi.z is its cosine) and wo; the delta kinds
// evaluate to zero (megatrace.py:_eval_kinds).
__device__ __forceinline__ V3 eval_bsdf(int kind, const float* mr, V3 wi, V3 wo, float* pdf) {
  const float abs_co = fabsf(wo.z);
  if ((kind == kDiffuse || kind == kRoughDiffuse) && (wi.z * wo.z) > 0.0f) {
    float scale = abs_co / kPi;
    if (kind == kRoughDiffuse) scale = scale * oren_nayar(wi, wo, __ldg(mr + 10));
    *pdf = fmaxf(abs_co, 0.0f) / kPi;
    return ld3(mr + 1) * scale;
  }
  *pdf = 0.0f;
  return v3(0.0f, 0.0f, 0.0f);
}

struct BsdfSample {
  V3 wo, weight;   // local direction; f * |cos| / pdf
  float pdf, eta;  // solid-angle pdf (0 for a delta lobe); IOR crossed
  bool delta;
};

// Sample an outgoing local direction at material row mr
// (megatrace.py:_sample_kinds): uc picks the dielectric lobe, (ub1, ub2)
// the direction.
__device__ __forceinline__ BsdfSample sample_bsdf(int kind, const float* mr, V3 wi, float uc,
                                                  float ub1, float ub2) {
  BsdfSample s{v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f), 0.0f, 1.0f, false};
  const float cos_i = wi.z;
  const float sign_i = cos_i < 0.0f ? -1.0f : 1.0f;
  if (kind == kDiffuse || kind == kRoughDiffuse) {
    s.wo = cosine_hemisphere(ub1, ub2) * sign_i;
    s.pdf = fmaxf(s.wo.z * sign_i, 0.0f) / kPi;
    s.weight = ld3(mr + 1);
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
  }
  return s;
}

// Closest hit over every triangle (Moller-Trumbore).  The strict `<`
// keeps the lower triangle index on a tie, as the reference sweep does.
static __device__ float closest_hit(const Tables& tb, V3 o, V3 d, int* best_id) {
  float best_t = kInf;
  int best = -1;
  for (int i = 0; i < tb.n_tris; ++i) {
    const float* r = tb.tri + i * kTriCols;
    V3 v0 = ld3(r), e1 = ld3(r + 3), e2 = ld3(r + 6);
    V3 p = cross(d, e2);
    float det = dot(e1, p);
    bool ok = fabsf(det) > 1e-12f;
    float inv = 1.0f / (ok ? det : 1.0f);
    V3 t = o - v0;
    float b1 = dot(t, p) * inv;
    V3 q = cross(t, e1);
    float b2 = dot(d, q) * inv;
    float tt = dot(e2, q) * inv;
    if (ok && b1 >= 0.0f && b2 >= 0.0f && b1 + b2 <= 1.0f && tt > kRayEps && tt < best_t) {
      best_t = tt;
      best = i;
    }
  }
  *best_id = best;
  return best_t;
}

// Any hit with kRayEps < t < tmax.
static __device__ bool occluded(const Tables& tb, V3 o, V3 d, float tmax) {
  for (int i = 0; i < tb.n_tris; ++i) {
    const float* r = tb.tri + i * kTriCols;
    V3 v0 = ld3(r), e1 = ld3(r + 3), e2 = ld3(r + 6);
    V3 p = cross(d, e2);
    float det = dot(e1, p);
    bool ok = fabsf(det) > 1e-12f;
    float inv = 1.0f / (ok ? det : 1.0f);
    V3 t = o - v0;
    float b1 = dot(t, p) * inv;
    V3 q = cross(t, e1);
    float b2 = dot(d, q) * inv;
    float tt = dot(e2, q) * inv;
    if (ok && b1 >= 0.0f && b2 >= 0.0f && b1 + b2 <= 1.0f && tt > kRayEps && tt < tmax) return true;
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
// Diffuse-like bounces a path may take in albedo mode (its max_depth);
// ops/megatrace.py checks the config against it.
constexpr int kMaxGradDepth = 16;

// A lane's Jacobian rows: row k of the lane lives at rows[k * stride]
// (a (3K, R) block, dim-major, so a warp's adds are coalesced).  Rows 3e+c
// hold d value[c] / d radiance[e, c] (emit) or 3m+c d value[c] / d
// albedo[m, c] (albedo).
struct GradRows {
  float* rows;
  long stride;
  __device__ __forceinline__ void add(int k, float v) const { rows[(long)k * stride] += v; }
};

// Albedo mode: a contribution c is a polynomial in the albedos, with power
// pw_m of material m (its diffuse-like bounces on the path so far), so
// d c / d al_m = c * pw_m / al_m; a black channel (al <= 1e-12) gets 0, as
// in the reference.  dl[0..n) are the materials of those bounces.
__device__ __forceinline__ void albedo_rows(const Tables& tb, const GradRows& g, const int* dl,
                                            int n, V3 c) {
  for (int i = 0; i < n; ++i) {
    const int m = dl[i];
    bool seen = false;
    for (int j = 0; j < i; ++j) seen = seen || dl[j] == m;
    if (seen) continue;
    float pw = 0.0f;
    for (int j = i; j < n; ++j) pw += dl[j] == m ? 1.0f : 0.0f;
    const float* al = tb.mat + m * kMatCols + 1;
    const float cc[3] = {c.x, c.y, c.z};
    for (int ch = 0; ch < 3; ++ch) {
      float a = __ldg(al + ch);
      float gm = a > 1e-12f ? pw / fmaxf(a, 1e-12f) : 0.0f;
      g.add(3 * m + ch, cc[ch] * gm);
    }
  }
}

// The path radiance of one lane; in a gradient mode it also adds the
// lane's Jacobian rows to g.  Inlined into each caller: the no-gradient
// instantiation is the body trace_path has always had.
template <int G>
__device__ __forceinline__ V3 trace_body(const Tables& tb, const PssView u, const GradRows g) {
  const float* cam = tb.cam;
  float cx = (2.0f * u(0) - 1.0f) * cam[12];
  float cy = (1.0f - 2.0f * u(1)) * cam[13];
  V3 dc = v3(cx, cy, 1.0f);
  V3 d = normalize(v3(dot(ld3(cam), dc), dot(ld3(cam + 3), dc), dot(ld3(cam + 6), dc)));
  V3 o = ld3(cam + 9);

  V3 tp = v3(1.0f, 1.0f, 1.0f);
  V3 L = v3(0.0f, 0.0f, 0.0f);
  float prev_pdf = 0.0f;
  bool prev_delta = true;
  float eta_scale = 1.0f;
  int dl[G == kGradAlbedo ? kMaxGradDepth : 1];
  int n_dl = 0;

  for (int depth = 1; depth <= tb.max_depth; ++depth) {
    const int base = kSensorDims + (depth - 1) * kBounceDims;
    int id;
    float t_hit = closest_hit(tb, o, d, &id);
    if (id < 0) break;   // escaped: no environment on this subset

    const float* av = tb.tri + id * kTriCols;
    V3 e1 = ld3(av + 3), e2 = ld3(av + 6);
    V3 hp = o + t_hit * d;
    V3 p = cross(d, e2);
    float det = dot(e1, p);
    float inv = 1.0f / (fabsf(det) > 1e-12f ? det : 1.0f);
    V3 t = o - ld3(av);
    float b1 = clamp01(dot(t, p) * inv);
    float b2 = clamp01(dot(d, cross(t, e1)) * inv);
    float w0 = 1.0f - b1 - b2;
    V3 ng = normalize(cross(e1, e2));
    V3 ns = normalize(w0 * ld3(av + 9) + b1 * ld3(av + 12) + b2 * ld3(av + 15));
    int erow = (int)__ldg(av + 19);

    const float* mr = tb.mat + (int)__ldg(av + 18) * kMatCols;
    const int kind = (int)__ldg(mr);

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
      if constexpr (G == kGradAlbedo) albedo_rows(tb, g, dl, n_dl, tp * ld3(er) * w_bsdf);
    }

    const Frame fr = make_frame(ns);
    const V3 wi = to_local(fr, -d);
    const bool delta_m = is_delta(kind);
    if constexpr (G == kGradAlbedo) {
      // this vertex's albedo enters its NEE term and every later one
      if (kind == kDiffuse || kind == kRoughDiffuse) dl[n_dl++] = (int)__ldg(av + 18);
    }

    // ---- NEE: one area-light sample, immediate shadow sweep
    if (tb.use_nee && !delta_m && depth + 1 <= tb.max_depth && depth + 1 >= tb.min_depth) {
      float u_pick = u(base + kOffLightPick);
      float u_l1 = u(base + kOffLightU), u_l2 = u(base + kOffLightU + 1);
      int row = 0;
      for (int e = 0; e < tb.n_ems; ++e) row += (u_pick >= __ldg(tb.em + e * kEmCols + 5)) ? 1 : 0;
      row = min(row, tb.n_ems - 1);
      const float* lr = tb.em + row * kEmCols;
      float tw = sqrtf(fmaxf(1.0f - u_l1, 0.0f));
      float lb0 = 1.0f - tw;
      float lb1 = tw * u_l2;
      V3 pl = ld3(lr + 6) + lb0 * ld3(lr + 9) + lb1 * ld3(lr + 12);
      V3 tol = pl - hp;
      float dist2 = dot(tol, tol);
      float dist = sqrtf(fmaxf(dist2, 1e-20f));
      V3 ldir = v3(tol.x / dist, tol.y / dist, tol.z / dist);
      float lcos = -dot(ldir, ld3(lr + 15));
      float area = __ldg(lr + 3);
      float ds_pdf = lcos * area > 0.0f ? __ldg(lr + 4) * dist2 / fmaxf(lcos * area, 1e-30f) : 0.0f;
      if (!(lcos > 1e-7f)) ds_pdf = 0.0f;
      float f_pdf;
      V3 f = eval_bsdf(kind, mr, wi, to_local(fr, ldir), &f_pdf);
      if (ds_pdf > 0.0f && lum(f) > 0.0f) {
        float eps_sh = kRayEps * fmaxf(t_hit, 1.0f);
        V3 sh_o = hp + ldir * eps_sh;
        float sh_tmax = dist * 0.999f - kRayEps;
        if (!occluded(tb, sh_o, ldir, sh_tmax)) {
          float w_nee = mis_power(ds_pdf, f_pdf);
          float inv_pdf = w_nee / fmaxf(ds_pdf, 1e-20f);
          L = L + tp * f * ld3(lr) * inv_pdf;
          if constexpr (G == kGradEmit) {
            const V3 t_e = tp * f * inv_pdf;
            g.add(3 * row, t_e.x);
            g.add(3 * row + 1, t_e.y);
            g.add(3 * row + 2, t_e.z);
          }
          if constexpr (G == kGradAlbedo) albedo_rows(tb, g, dl, n_dl, tp * f * ld3(lr) * inv_pdf);
        }
      }
    }

    // ---- BSDF sampling
    const BsdfSample bs = sample_bsdf(kind, mr, wi, u(base + kOffBsdfCmp), u(base + kOffBsdfU),
                                      u(base + kOffBsdfU + 1));
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
    if (!alive) break;

    float eps_n = kRayEps * fmaxf(t_hit, 1.0f);
    o = hp + wo_w * eps_n;
    d = wo_w;
    prev_pdf = bs_pdf;
    prev_delta = delta_m;
  }
  return L;
}

// The path radiance of one lane (the path kernel and the chain kernel).
static __device__ __noinline__ V3 trace_path(const Tables& tb, const PssView u) {
  return trace_body<kGradNone>(tb, u, GradRows{nullptr, 0});
}

}  // namespace drmlt
