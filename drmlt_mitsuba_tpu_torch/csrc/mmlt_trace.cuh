// The selected-strategy MMLT trace of one lane per thread: the device-side
// trace shared by mmlt_trace.cu (bootstrap / chain starts) and
// drmlt_chain.cu (the chain kernel's mmlt mode).
//
// Port of the reference's Pallas trace body
// drmlt_mitsuba_tpu/ops/pallas/megammlt.py:mmlt_trace_tile (:242) on the
// reference kernel's scene subset (path_trace.cuh's, less the thin lens,
// which mega_mmlt_eligible excludes there too).  The plain-PyTorch twin is
// ops/megammlt.py:mmlt_trace_reference; the expressions keep its
// evaluation order.  trace_mmlt<X> and walk<X>: X = false is the body of
// slices 1-4, X = true the full scope (spheres, bitmap albedo, the seven
// BSDF kinds; the environment seen by an escaped s = 0 eye walk).
//
// Built from the semantics, not from the TPU tile:
//   * each walk keeps its per-slot pdf_fwd / pdf_rev / delta in small
//     per-thread arrays (a slot is valid iff the walk reached it), which the
//     MIS recursion indexes directly;
//   * the four vertices the strategy selects (ev, ev0 on the eye side, lv,
//     lv0 on the light side) are captured when the walk reaches their
//     slot, not carried through a masked copy at every slot;
//   * materials and emitters are indexed by id (no loop over every row);
//   * each walk stops at its selected slot (ev on the eye side, lv on the
//     light side: nothing reads a slot past it) or at its first miss or
//     absorbed bounce, and the two walks run in one loop, the light walk
//     where the eye walk stopped, so a warp takes at most max_depth
//     bounces, not every slot of one walk and then of the other (the TPU
//     tile walks every slot masked);
//   * the shadow ray and MIS run only for a lane that has a contribution.
#pragma once

#include "path_trace.cuh"

namespace drmlt {

// Largest max_depth the kernel takes (the slot arrays are sized by it).
constexpr int kMaxMmltDepth = 16;

struct MmltCfg {
  int max_depth;     // K: segments of the full path
  int light_image;   // include the t = 1 strategies
  int eye_dims;      // PSS dims of the eye walk; the light walk's follow
};

struct Vertex {
  V3 p, ns, ng, wi, beta;
  int mat;
  bool valid;
};

// The full scope's vertex: its texture coordinates, and whether the walk
// left the scene at its slot (then wi is the escape direction reversed and
// beta the throughput carried out).
struct VertexX : Vertex {
  float tu, tv;
  bool esc;
};

template <bool X>
using VtxT = typename std::conditional<X, VertexX, Vertex>::type;

template <bool X>
__device__ __forceinline__ VtxT<X> vtx(const Vertex& v, float tu = 0.0f, float tv = 0.0f) {
  if constexpr (X) {
    return VertexX{v, tu, tv, false};
  } else {
    return v;
  }
}

struct WalkSlots {
  float pdf_fwd[kMaxMmltDepth + 1];
  float pdf_rev[kMaxMmltDepth + 1];
  bool delta[kMaxMmltDepth + 1];
};

struct MmltOut {
  V3 value;        // scaled by n_strats * max_depth
  float px, py;    // film position
};

__device__ __forceinline__ float sa_to_area(float pdf_sa, V3 from, V3 to, V3 n_to) {
  V3 s = to - from;
  float d2 = fmaxf(dot(s, s), 1e-20f);
  float c = fabsf(dot(s, n_to) * (1.0f / sqrtf(d2)));
  return pdf_sa * c / d2;
}

__device__ __forceinline__ float mis_ratio(float p_num, float p_den) {
  return (p_num > 0.0f ? p_num : 1.0f) / (p_den > 0.0f ? p_den : 1.0f);
}

// What the light walk starts from: the ray leaving the emitter, its
// throughput and direction pdf, the endpoint's point and normal.
struct LightRay {
  V3 o, d, beta, p0, n;
  float pdf_dir;
  bool valid;
};

// Both subpath walks of a lane in one loop: the eye walk from the camera
// (the ray o, d with direction pdf pdf_sa, leaving slot 0 at o with normal
// pn) up to slot ev, then the light walk from *lr up to slot lv; a walk
// whose selected slot is 0 takes no bounce (and *lr is read only where lv
// > 0).  Nothing reads a slot past the selected one (the MIS recursion
// stops at the selected vertices), so each lane takes only the bounces its
// strategy needs, and a warp runs the longest lane's t - 1 + max(s - 1, 0)
// <= max_depth iterations rather than every slot of one walk and then of
// the other.  The eye walk has n_eye slots, the light walk n_eye - 1; slots
// 1.. are surface hits; u(j) reads PSS dim j; the bounce at slot v reads
// dims ubase + 3 (v - 1) + {0, 1, 2} (ubase 4 on the eye side, lubase on
// the light side; the last slot samples no direction and reads zeros); a
// walk also stops at its first miss or absorbed bounce.  Captures: the eye
// walk's slots ev and ev - 1 into cap[0], cap[1] (the emitter row at ev
// into *erow_ev; in the full scope an escape at ev is marked on cap[0]),
// the light walk's lv and lv - 1 into cap[2], cap[3] (ev0 = max(ev - 1, 0),
// lv0 likewise: slot 0 is the caller's); each slot's pdfs and delta into
// ws[0] (eye) and ws[1] (light).  The walked side's state stays in
// registers; the light ray waits in the caller's frame, built before the
// loop (the same work on every lane: at the switch it would run once per
// distinct ev in a warp).  (megammlt.py:287-516)
template <bool X, class U>
static __device__ __noinline__ void walk(const TabT<X>& tb, const U& u, V3 o, V3 d, float pdf_sa,
                                         V3 pn, const LightRay* lr, int n_eye, int lubase, int ev,
                                         int lv, VtxT<X>* cap, int* erow_ev, WalkSlots* ws) {
  bool light = false, act = true;
  int n_slots = n_eye, ubase = 4, sel = ev;
  VtxT<X>* va = cap;   // the side's captures: slot sel, then sel - 1
  WalkSlots* w = ws;
  V3 beta = v3(1.0f, 1.0f, 1.0f), pp = o;
  for (int v = 1;; ++v) {
    if (!act || v > sel) {   // this side is done: on to the light walk, or stop
      if (light || lv == 0) break;
      light = true;
      act = lr->valid;
      n_slots -= 1;
      ubase = lubase;
      sel = lv;
      va += 2;   // va, w held the eye side's cap, ws
      w += 1;
      o = lr->o;
      d = lr->d;
      beta = lr->beta;
      pdf_sa = lr->pdf_dir;
      pp = lr->p0;
      pn = lr->n;
      v = 0;
      continue;
    }
    int id;
    float t_hit = closest_hit(tb, o, d, &id);
    int sph = -1;
    if constexpr (X) {
      if (tb.x.n_sphs) t_hit = sphere_closest(tb.x.sph, tb.x.n_sphs, o, d, t_hit, &sph);
    }
    if (id < 0 && sph < 0) {   // escaped
      if constexpr (X) {
        if (v == sel) {
          va->esc = true;
          va->wi = -d;
          va->beta = beta;
        }
      }
      act = false;
      continue;
    }
    V3 hp = o + t_hit * d;
    V3 ng, ns;
    int mat_id;
    const float* erow_src;   // the hit row's emitter-row column
    float tu = 0.0f, tv = 0.0f;
    bool on_sphere = false;
    if constexpr (X) on_sphere = sph >= 0;
    if (on_sphere) {
      if constexpr (X) {
        const float* sr = tb.x.sph + sph * kSphCols;
        ng = (hp - ld3(sr)) * (1.0f / fmaxf(__ldg(sr + 3), 1e-20f));
        ns = ng;
        mat_id = (int)__ldg(sr + 4);
        erow_src = sr + 5;
        if (tb.x.tex_pages) {
          tu = acosf(fminf(fmaxf(ng.z, -1.0f), 1.0f)) / kPi;
          tv = atan2f(ng.y, ng.x) / kTwoPi + 0.5f;
        }
      }
    } else {
      const float* av = tb.tri + id * kTriCols;
      V3 e1 = ld3(av + 3), e2 = ld3(av + 6);
      V3 p = cross(d, e2);
      float det = dot(e1, p);
      float inv = 1.0f / (fabsf(det) > 1e-12f ? det : 1.0f);
      V3 t = o - ld3(av);
      float b1 = clamp01(dot(t, p) * inv);
      float b2 = clamp01(dot(d, cross(t, e1)) * inv);
      float w0 = 1.0f - b1 - b2;
      ng = normalize(cross(e1, e2));
      ns = normalize(w0 * ld3(av + 9) + b1 * ld3(av + 12) + b2 * ld3(av + 15));
      mat_id = (int)__ldg(av + 18);
      erow_src = av + 19;
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

    // pdf_fwd: the previous direction pdf -> area measure here
    V3 seg = hp - pp;
    float d2 = fmaxf(dot(seg, seg), 1e-20f);
    V3 wseg = seg * (1.0f / sqrtf(d2));
    float cos_to = fabsf(dot(wseg, ng));
    w->pdf_fwd[v] = pdf_sa * cos_to / d2;
    w->delta[v] = is_delta<X>(kind);

    const V3 wiw = -d;
    if (v == sel) {
      *va = vtx<X>(Vertex{hp, ns, ng, wiw, beta, mat_id, true}, tu, tv);
      if (!light) *erow_ev = (int)__ldg(erow_src);
    }
    if (v == sel - 1) va[1] = vtx<X>(Vertex{hp, ns, ng, wiw, beta, mat_id, true}, tu, tv);

    // BSDF sample, and the reverse pdf of slot v - 1
    const Frame fr = make_frame(ns);
    const V3 wi = to_local(fr, wiw);
    float ub0 = 0.0f, ub1 = 0.0f, ub2 = 0.0f;
    if (v < n_slots - 1) {
      const int b = ubase + (v - 1) * 3;
      ub0 = u(b);
      ub1 = u(b + 1);
      ub2 = u(b + 2);
    }
    const BsdfSample bs = sample_bsdf<X>(kind, mr, alb, wi, ub0, ub1, ub2);
    const V3 wow = to_world(fr, bs.wo);
    float rev_sa;
    eval_bsdf<X>(kind, mr, alb, bs.wo, wi, &rev_sa);
    float cos_prev = fabsf(dot(wseg, pn));
    if (bs.delta) rev_sa = 1.0f;
    w->pdf_rev[v - 1] = rev_sa * cos_prev / d2;

    V3 bn = beta * bs.weight;
    if (!light) {   // shading-normal correction of the adjoint (eye) walk
      float num = fabsf(dot(wiw, ns)) * fabsf(dot(wow, ng));
      float den = fabsf(dot(wiw, ng)) * fabsf(dot(wow, ns));
      float corr = den > 0.0f ? num / den : 1.0f;
      bn = bn * corr;
    }
    act = lum(bn) > 0.0f && (bs.pdf > 0.0f || bs.delta);
    float eps_n = kRayEps * fmaxf(t_hit, 1.0f);
    o = hp + wow * eps_n;
    d = wow;
    beta = bn;
    pdf_sa = bs.delta ? 1.0f : bs.pdf;
    pp = hp;
    pn = ns;
  }
}

// The BSDF of a connection endpoint, with the vertex's albedo in the full
// scope.
template <bool X>
__device__ __forceinline__ V3 eval_at(const TabT<X>& tb, const VtxT<X>& v, int kind,
                                      const float* mr, V3 wi, V3 wo, float* pdf) {
  V3 alb = v3(0.0f, 0.0f, 0.0f);
  if constexpr (X) alb = albedo_x(tb, mr, v.tu, v.tv);
  return eval_bsdf<X>(kind, mr, alb, wi, wo, pdf);
}

// The whole selected-strategy trace of one lane: u(0) depth, u(1)
// strategy, then the eye and light walk dims (megammlt.py:262-929).
template <bool X, class U>
static __device__ __noinline__ MmltOut trace_mmlt(const TabT<X>& tb, const MmltCfg& mc,
                                                  const U& u) {
  const int K = mc.max_depth;
  const int n_eye = K + 1, n_light = K;
  const float* cam = tb.cam;

  // ---- technique dims
  const float depth = fminf(floorf(u(0) * (float)K), (float)K - 1.0f) + 1.0f;
  const float n_strats = depth + 1.0f;
  const float s_pick = fminf(floorf(u(1) * n_strats), depth);
  const float t_pick = depth + 1.0f - s_pick;
  const int s = (int)s_pick, t = (int)t_pick;
  const bool case_hit = s == 0, case_lt = t == 1;
  const int ev = min(max(t - 1, 0), n_eye - 1), ev0 = min(max(t - 2, 0), n_eye - 1);
  const int lv = min(max(s - 1, 0), n_light - 1), lv0 = min(max(s - 2, 0), n_light - 1);

  const V3 cam_f = v3(__ldg(cam + 2), __ldg(cam + 5), __ldg(cam + 8));
  const V3 cam_o = ld3(cam + 9);
  const float film_area = 4.0f * __ldg(cam + 12) * __ldg(cam + 13);

  // ---- the eye walk's endpoint: the pinhole camera
  const float ux = u(2), uy = u(3);
  const float x = (2.0f * ux - 1.0f) * __ldg(cam + 12);
  const float y = (1.0f - 2.0f * uy) * __ldg(cam + 13);
  const V3 ed = normalize(v3(__ldg(cam + 0) * x + __ldg(cam + 1) * y + __ldg(cam + 2),
                             __ldg(cam + 3) * x + __ldg(cam + 4) * y + __ldg(cam + 5),
                             __ldg(cam + 6) * x + __ldg(cam + 7) * y + __ldg(cam + 8)));
  const float cos0 = dot(ed, cam_f);
  const float c0 = fmaxf(cos0, 1e-6f);
  const float pdf0 = cos0 > 1e-6f ? 1.0f / (film_area * (c0 * (c0 * c0))) : 0.0f;

  WalkSlots ws[2];   // the eye walk's slots, then the light walk's
  WalkSlots &we = ws[0], &wl = ws[1];
  for (int i = 0; i <= K; ++i) {
    we.pdf_fwd[i] = we.pdf_rev[i] = wl.pdf_fwd[i] = wl.pdf_rev[i] = 0.0f;
    we.delta[i] = wl.delta[i] = false;
  }
  const V3 zero3 = v3(0.0f, 0.0f, 0.0f), one3 = v3(1.0f, 1.0f, 1.0f);
  const VtxT<X> none = vtx<X>(Vertex{zero3, zero3, zero3, zero3, zero3, 0, false});
  const VtxT<X> cam_vtx = vtx<X>(Vertex{cam_o, cam_f, cam_f, -cam_f, one3, 0, true});
  we.pdf_fwd[0] = 1.0f;
  we.delta[0] = true;

  // ---- the light walk's endpoint on an area emitter (pick by power,
  //      uniform point, cosine direction)
  const int lbase = 2 + mc.eye_dims;
  const float u_pick = u(lbase);
  int row = 0;
  for (int e = 0; e < tb.n_ems; ++e) row += (u_pick >= __ldg(tb.em + e * kEmCols + 5)) ? 1 : 0;
  row = min(row, tb.n_ems - 1);
  const float* lr = tb.em + row * kEmCols;
  const V3 l_rad = ld3(lr);
  const float l_area = __ldg(lr + 3), l_pmf = __ldg(lr + 4);
  const V3 lng = ld3(lr + 15);
  const float tw = sqrtf(fmaxf(1.0f - u(lbase + 1), 0.0f));
  const float lb0 = 1.0f - tw;
  const float lb1 = tw * u(lbase + 2);
  const V3 p0 = ld3(lr + 6) + lb0 * ld3(lr + 9) + lb1 * ld3(lr + 12);
  const float pdf_pos = l_pmf / fmaxf(l_area, 1e-20f);
  const bool valid0 = l_pmf > 0.0f && __ldg(lr + 18) == 0.0f;
  const V3 c = cosine_hemisphere(u(lbase + 3), u(lbase + 4));
  const V3 ldir = to_world(make_frame(lng), c);
  const float pdf_dir = fmaxf(c.z, 1e-12f) / kPi;
  const float cos_l0 = fmaxf(c.z, 0.0f);
  const float bscale = cos_l0 / fmaxf(pdf_pos * pdf_dir, 1e-30f);
  const V3 lbeta = valid0 ? l_rad * bscale : zero3;
  const V3 l_end_b = valid0 ? l_rad / fmaxf(pdf_pos, 1e-20f) : zero3;
  const VtxT<X> light_vtx = vtx<X>(Vertex{p0, lng, lng, lng, l_end_b, 0, valid0});
  wl.pdf_fwd[0] = pdf_pos;
  LightRay lray;   // read by the walk only where the light walk takes a bounce
  if (lv > 0) lray = {p0 + ldir * 1e-3f, ldir, lbeta, p0, lng, pdf_dir, valid0};

  // ---- the eye walk, then the light walk; the selected vertices se, se0
  //      (eye side) and sl, sl0 (light side)
  VtxT<X> cap[4] = {ev == 0 ? cam_vtx : none, ev0 == 0 ? cam_vtx : none,
                    lv == 0 ? light_vtx : none, lv0 == 0 ? light_vtx : none};
  const VtxT<X>&se = cap[0], &se0 = cap[1], &sl = cap[2], &sl0 = cap[3];
  int erow_ev = -1;
  walk<X>(tb, u, cam_o, ed, pdf0, cam_f, &lray, n_eye, lbase + 5, ev, lv, cap, &erow_ev, ws);
  we.pdf_rev[0] = 0.0f;

  // ---- s = 0: the selected eye vertex is on an emitter
  V3 he_rad = zero3;
  float he_area = 1.0f, he_pmf = 0.0f;
  if (erow_ev >= 0) {
    const float* er = tb.em + erow_ev * kEmCols;
    he_rad = ld3(er);
    he_area = __ldg(er + 3);
    he_pmf = __ldg(er + 4);
  }
  const bool ok_hit = case_hit && se.valid && erow_ev >= 0 && dot(se.wi, se.ng) > 0.0f;

  // ---- the connection (t = 1 light tracing connects to the camera, ev = 0)
  const V3 dv = se.p - sl.p;
  const float dist2 = dot(dv, dv);
  const float dist = sqrtf(fmaxf(dist2, 1e-20f));
  const V3 wdir = dv / dist;
  const float cos_l = fabsf(dot(wdir, sl.ng));
  const float cos_e = fabsf(dot(wdir, se.ng));
  const float g = cos_l * cos_e / fmaxf(dist2, 1e-20f);
  const bool is_s1 = s == 1;
  const bool front = dot(wdir, sl.ng) > 0.0f;

  const float* mrl = tb.mat + sl.mat * kMatCols;
  const int kind_l = (int)__ldg(mrl);
  const Frame frl = make_frame(sl.ns);
  const V3 wl_loc = to_local(frl, wdir), wi_l_loc = to_local(frl, sl.wi);
  float pdf_l_fwd;
  V3 fl = eval_at<X>(tb, sl, kind_l, mrl, wi_l_loc, wl_loc, &pdf_l_fwd) *
          (1.0f / fmaxf(fabsf(wl_loc.z), 1e-9f));
  if (is_s1) fl = front ? one3 : zero3;   // the emitter's own lobe

  const float* mre = tb.mat + se.mat * kMatCols;
  const int kind_e = (int)__ldg(mre);
  const Frame fre = make_frame(se.ns);
  const V3 we_loc = to_local(fre, -wdir), wi_e_loc = to_local(fre, se.wi);
  float pdf_e_fwd;
  V3 fe = eval_at<X>(tb, se, kind_e, mre, wi_e_loc, we_loc, &pdf_e_fwd) *
          (1.0f / fmaxf(fabsf(we_loc.z), 1e-9f));
  // pinhole sensor importance toward -wdir, and its film position
  const float cosv = -dot(wdir, cam_f);
  const float cv = fmaxf(cosv, 1e-6f);
  const float inv_cosv = 1.0f / cv;
  const float x_cam =
      -(wdir.x * __ldg(cam + 0) + wdir.y * __ldg(cam + 3) + wdir.z * __ldg(cam + 6)) * inv_cosv;
  const float y_cam =
      -(wdir.x * __ldg(cam + 1) + wdir.y * __ldg(cam + 4) + wdir.z * __ldg(cam + 7)) * inv_cosv;
  const float fu = (x_cam / __ldg(cam + 12) + 1.0f) * 0.5f;
  const float fv = (1.0f - y_cam / __ldg(cam + 13)) * 0.5f;
  const bool inside = cosv > 1e-6f && fu >= 0.0f && fu < 1.0f && fv >= 0.0f && fv < 1.0f;
  if (case_lt) {
    const float cv2 = cv * cv;
    const float we_imp = inside ? 1.0f / (film_area * (cv2 * cv2)) : 0.0f;
    fe = v3(we_imp, we_imp, we_imp);
  }
  const V3 cc = sl.beta * fl * fe * se.beta * g;

  const bool l_delta_sel = wl.delta[lv];
  const bool ok_conn = !case_hit && !case_lt && sl.valid && se.valid &&
                       !(!is_s1 && l_delta_sel) && !we.delta[ev] && dist2 > 1e-12f;
  const bool ok_lt = mc.light_image && case_lt && sl.valid && !l_delta_sel && inside &&
                     dist2 > 1e-12f;
  bool ok_c = (ok_conn || ok_lt) && lum(cc) > 0.0f;
  if (ok_c) {
    const float sh_eps = kRayEps * fmaxf(dist, 1.0f);
    ok_c = !occluded(tb, sl.p + wdir * sh_eps, wdir, dist * 0.999f);
    if constexpr (X) {
      if (ok_c && tb.x.n_sphs) {
        ok_c = !sphere_blocked(tb.x.sph, tb.x.n_sphs, sl.p + wdir * sh_eps, wdir, dist * 0.999f);
      }
    }
  }

  V3 val = zero3;
  if (ok_hit || ok_c) {
    // ---- junction pdfs
    float pl_s;
    if (case_hit) {
      pl_s = erow_ev >= 0 ? he_pmf / fmaxf(he_area, 1e-20f) : 0.0f;
    } else if (is_s1) {
      pl_s = sa_to_area(fmaxf(dot(wdir, sl.ng), 0.0f) / kPi, sl.p, se.p, se.ng);
    } else {
      pl_s = sa_to_area(pdf_l_fwd, sl.p, se.p, se.ng);
    }
    float pl_s1 = 0.0f;
    if (t >= 3) {
      if (case_hit) {
        const V3 hw = se0.p - se.p;
        const float hd2 = fmaxf(dot(hw, hw), 1e-20f);
        const float cos_hit_l = fmaxf(dot(hw, se.ng) * (1.0f / sqrtf(hd2)), 0.0f);
        pl_s1 = sa_to_area(cos_hit_l / kPi, se.p, se0.p, se0.ng);
      } else {
        float pdf_e_rev;
        eval_at<X>(tb, se, kind_e, mre, we_loc, wi_e_loc, &pdf_e_rev);
        pl_s1 = sa_to_area(pdf_e_rev, se.p, se0.p, se0.ng);
      }
    }
    float pe_t;
    if (case_lt) {
      pe_t = sa_to_area(cosv > 1e-6f ? 1.0f / (film_area * (cv * (cv * cv))) : 0.0f, se.p, sl.p,
                        sl.ng);
    } else {
      pe_t = sa_to_area(pdf_e_fwd, se.p, sl.p, sl.ng);
    }
    float pe_t1 = 0.0f;
    if (s >= 2) {
      float pdf_l_rev;
      eval_at<X>(tb, sl, kind_l, mrl, wl_loc, wi_l_loc, &pdf_l_rev);
      pe_t1 = sa_to_area(pdf_l_rev, sl.p, sl0.p, sl0.ng);
    }

    // ---- balance-heuristic MIS: the ratio recursion over the slots
    float sum_ri = 0.0f;
    float ri = 1.0f;
    for (int i = s - 1; i >= 0; --i) {
      const float pe_i = i == s - 1 ? pe_t : (i == s - 2 ? pe_t1 : wl.pdf_rev[i]);
      ri = ri * mis_ratio(pe_i, wl.pdf_fwd[i]);
      const bool d_lo = i >= 2 ? wl.delta[i - 1] : false;
      if (!(d_lo || wl.delta[i])) sum_ri = sum_ri + ri;
    }
    float rj = 1.0f;
    for (int j = t - 1; j >= 1; --j) {
      const float pl_j = j == t - 1 ? pl_s : (j == t - 2 ? pl_s1 : we.pdf_rev[j]);
      rj = rj * mis_ratio(pl_j, we.pdf_fwd[j]);
      const bool d_hi = j >= 2 ? we.delta[j - 1] : false;
      if (!(we.delta[j] || d_hi) && (mc.light_image || j != 1)) sum_ri = sum_ri + rj;
    }
    const float w_mis = 1.0f / (1.0f + sum_ri);
    if (ok_hit) val = se.beta * he_rad * w_mis;
    if (ok_c) val = val + cc * w_mis;
  }
  if constexpr (X) {
    // the environment seen by an s = 0 eye walk that escaped, at MIS
    // weight 1 (megammlt.py:883-930)
    const SceneExt& x = tb.x;
    if (x.env_mode && case_hit && se.esc) {
      V3 e;
      if (x.env_mode == kEnvConstant) {
        e = ld3(cam + 16);
      } else {
        float eu, ev_u;
        env_dir_uv(-se.wi, &eu, &ev_u);
        e = env_bilinear(x.env_tab, x.env_h, x.env_w, eu, ev_u);
      }
      val = val + se.beta * e;
    }
  }
  return {val * (n_strats * (float)K), case_lt ? fu : ux, case_lt ? fv : uy};
}

}  // namespace drmlt
