"""n_mut whole DRMLT mutations per chain in one launch, for the path and the
MMLT technique: the chain kernel and its plain twin.

`drmlt_chain_step` launches `csrc/drmlt_chain.cu:drmlt_chain_kernel`, the
port of the reference's Pallas kernel `megadrmlt.py:_mega_drmlt_kernel`
with technique="path" (the tables are a megatrace.TraceTables) or
technique="mmlt" (a fixed-depth group's megammlt.MmltTables), in DRMLT
mode or in its pssmlt mode.  `drmlt_chain_step_reference` is the same loop
in plain PyTorch; the wrapper takes it only for tensors on the CPU.

Per mutation and chain (megadrmlt.py:264-435): a large-step coin and D
large-step uniforms; the stage-1 proposal y (Kelemen, pairwise for
orbital); the stage-2 proposal z (orbital: the wrapped-Cauchy rotation of
the *unwrapped* y - x about y; green / mira: a small Gaussian step from x);
the y trace; the z trace of the chains that run stage 2 (`do_second`: y
rejected, and the step small unless timid_after_large) and green's reverse
trace y* = z - (y - x) of those whose z carries light, each gathered into
one batch as the kernel gathers them into full warps (zeros elsewhere:
their a2 is 0 whatever z would give); the per-type acceptance; a
three-state or sampled splat into the film; and the state select.  The
twin's `work` counts the chains each trace ran on (y_lanes, z_lanes,
y_rev_lanes) beside the ray-triangle tests.

pssmlt mode (megadrmlt.py:338-350, 408-410): stage 1 only, PSSMLT as a
control inside the same kernel.  z is drawn (the uniforms are those of
DRMLT mode) but neither z nor y* is traced; y is accepted by Metropolis;
the splat is Veach's two-state expected value (pssmlt_proc.cpp:204-225),
x at 1 - a1 and y at a1, or in the sampled mode y with probability a1,
else x.  a2 and accept2 are 0.

MMLT mode (megadrmlt.py:158-190, 280-330, 367): the trace reads the pinned
depth dim u_depth = 1 - 0.5/k before the chain's dims, and its value is
scaled by 1/k; chain dim 0 (the strategy) is frozen on small steps in both
stages and skipped by mira's q-ratio; with fix_emitter_path, stage 2 is
the identity on the light-walk dims [1 + eye_dims, 1 + eye_dims +
light_dims) unless the chain's strategy is light tracing (s == k).  The
splat position is the trace's (the light-image projection for t = 1).

Uniforms.  Each mutation draws n_rand uniforms per chain in this order:
large coin, D u_large, the stage-1 draws (orbital: D/2 radii then D/2
angles; green / mira: D), the stage-2 draws (orbital: D/2 angles; green /
mira: D then D Box-Muller pairs), coin1, coin2, and u_sel for the sampled
splat.  n_rand = 3 + D + 3*(D/2) for orbital, 3 + 4D otherwise, plus 1 for
"sampled".  With `uniforms` given ((n_mut*n_rand, C), mutation-major) both
kernel and twin read them in that order; otherwise both draw the same
Philox stream (core/rng.py).

Layouts.  Chain state (D+6, C) dim-major: D PSS rows, lum, pos x, pos y,
value r g b (value has unit luminance).  Film (H, W, 3), updated in place.
Stats (6, C) per chain, accumulated in place: a1, a2, accept1, accept2,
large, moved.
"""
from __future__ import annotations

import math

import torch

from drmlt_mitsuba_tpu_torch.core.rng import philox_uniforms, pss_wrap
from drmlt_mitsuba_tpu_torch.integrators import kernels
from drmlt_mitsuba_tpu_torch.integrators.mcmc import (
    ChainState, metropolis_clamp,
)
from drmlt_mitsuba_tpu_torch.ops import build, megammlt, megatrace


def n_rand(cfg, n_dims: int) -> int:
    """Uniforms per chain and mutation for DRMLTConfig cfg."""
    D = n_dims
    n = 3 + D + 3 * (D // 2) if cfg.type == "orbital" else 3 + 4 * D
    return n + (1 if cfg.splat_mode == "sampled" else 0)


def stage1_kernel(cfg) -> kernels.Kelemen:
    """The stage-1 (bold) proposal: orbital scales Kelemen's radii."""
    if cfg.type == "orbital":
        return kernels.Kelemen(cfg.s1 * cfg.kelemen_scale,
                               cfg.s2 * cfg.kelemen_scale)
    return kernels.Kelemen(cfg.s1, cfg.s2)


def chain_dims(tables) -> int:
    """PSS dims of a chain the trace reads (before even padding)."""
    if tables.technique == "mmlt":
        return tables.n_core - 1          # the depth dim is pinned
    return tables.n_dims


def _n_dims(state) -> int:
    D = state.shape[0] - 6
    if D % 2:
        raise ValueError("the chain kernel needs an even PSS dimension")
    return D


def pack_chain_state(state: ChainState) -> torch.Tensor:
    """ChainState -> (D+6, C) dim-major."""
    return torch.cat([state.u.T, state.lum[None], state.pos[:, 0, :].T,
                      state.value[:, 0, :].T]).contiguous()


def unpack_chain_state(arr, n_dims: int) -> ChainState:
    D = n_dims
    C = arr.shape[1]
    return ChainState(u=arr[:D].T, lum=arr[D],
                      pos=arr[D + 1:D + 3].T.reshape(C, 1, 2),
                      value=arr[D + 3:D + 6].T.reshape(C, 1, 3))


# ---------------------------------------------------------------- twin
def _trace(tables, v, work):
    """(lum, rgb / lum, px, py) of dim-major chain vectors v (D, C);
    non-finite or negative lum becomes 0, as in the kernel."""
    if tables.technique == "mmlt":
        k = tables.max_depth
        u0 = torch.full((1, v.shape[1]), 1.0 - 0.5 / k, device=v.device)
        out = megammlt.mmlt_trace_reference(tables, torch.cat([u0, v]),
                                            work)
        rgb, px, py = out[0:3] * (1.0 / k), out[3], out[4]
    else:
        rgb = megatrace.path_trace_reference(tables, v, work)
        px, py = v[0], v[1]
    lum = 0.212671 * rgb[0] + 0.715160 * rgb[1] + 0.072169 * rgb[2]
    lum = torch.where(torch.isfinite(lum) & (lum >= 0), lum, 0.0)
    li = torch.where(lum > 0, 1.0 / torch.clamp(lum, min=1e-30), 0.0)
    return lum, rgb * li, px, py


def _trace_lanes(tables, v, lanes, work, kind):
    """_trace of the chains where the bool (C,) `lanes` holds (every chain
    for None), gathered into one batch as the kernel gathers a block's
    stage-2 traces into full warps, and zeros elsewhere.  With a dict
    `work`, adds the traced chains to work[kind + "_lanes"]."""
    C = v.shape[1]
    idx = None if lanes is None else torch.nonzero(lanes)[:, 0]
    if work is not None:
        key = kind + "_lanes"
        work[key] = work.get(key, 0) + (C if idx is None else idx.numel())
    if idx is None:
        return _trace(tables, v, work)
    lum = torch.zeros(C, device=v.device)
    rgb = torch.zeros((3, C), device=v.device)
    px, py = torch.zeros_like(lum), torch.zeros_like(lum)
    if idx.numel():
        lum[idx], rgb[:, idx], px[idx], py[idx] = _trace(tables, v[:, idx],
                                                         work)
    return lum, rgb, px, py


def stage2_share(work) -> float:
    """The share of mutations whose z was traced, from a twin's `work`."""
    return work.get("z_lanes", 0) / max(work.get("y_lanes", 0), 1)


def _splat(film, px, py, rgb, w):
    """Add rgb * w at pixel (floor(px W), floor(py H)); positions outside
    [0, 1) (exactly 1.0 after the wrap) are dropped."""
    H, W = film.shape[0], film.shape[1]
    xi = torch.floor(px * W)
    yi = torch.floor(py * H)
    ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    flat = (torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1))
    vals = torch.where(ok[:, None], (rgb * w).T, 0.0)
    film.view(-1, 3).index_put_((flat.to(torch.int64),), vals,
                                accumulate=True)


def drmlt_chain_step_reference(tables, cfg, n_mut: int, state, film, stats,
                               seed: int, launch: int, uniforms=None,
                               work=None, pssmlt: bool = False):
    """Plain-PyTorch twin of drmlt_chain_kernel (see the module docstring).
    Updates state, film and stats in place and returns them.  With a dict
    `work`, adds the kernel's ray-triangle tests to it."""
    D = _n_dims(state)
    C = state.shape[1]
    nr = n_rand(cfg, D)
    kel = stage1_kernel(cfg)
    wc = kernels.WrappedCauchy(cfg.rho)
    sig2 = cfg.scale_second * cfg.sigma
    frozen0 = tables.technique == "mmlt"
    fix_em = frozen0 and cfg.fix_emitter_path
    if fix_em:
        k = tables.max_depth
        em_lo = 1 + tables.eye_dims
        em_hi = em_lo + tables.light_dims
    x = state[:D].clone()
    lum_x = state[D].clone()
    px_x, py_x = state[D + 1].clone(), state[D + 2].clone()
    v_x = state[D + 3:D + 6].clone()
    st = torch.zeros((6, C), device=state.device)

    for m in range(n_mut):
        if uniforms is not None:
            U = uniforms[m * nr:(m + 1) * nr]
        else:
            U = philox_uniforms(seed, launch, m, nr, C, state.device)
        large = U[0] < cfg.p_large
        u_large = U[1:1 + D]
        j = 1 + D
        if cfg.type == "orbital":
            P = D // 2
            d = kel.sample(U[j:j + P, :, None])
            ang = U[j + P:j + 2 * P] * (2.0 * math.pi)
            j += 2 * P
            du0 = d * torch.cos(ang)
            if frozen0:
                du0[0] = 0.0
            y_raw = torch.empty_like(x)
            y_raw[0::2] = x[0::2] + du0
            y_raw[1::2] = x[1::2] + d * torch.sin(ang)
        else:
            du = kel.sample(U[j:j + D, :, None])
            if frozen0:
                du[0] = 0.0
            y_raw = x + du
            j += D
        y_raw = torch.where(large[None], u_large, y_raw)
        y = pss_wrap(y_raw)

        if cfg.type == "orbital":
            cth, sth = wc.cos_sin(U[j:j + D // 2])
            j += D // 2
            du0 = y_raw[0::2] - x[0::2]
            du1 = y_raw[1::2] - x[1::2]
            z_raw = torch.empty_like(x)
            z_raw[0::2] = y_raw[0::2] - cth * du0 + sth * du1
            z_raw[1::2] = y_raw[1::2] - sth * du0 - cth * du1
        else:
            g = kernels.Gaussian(sig2).sample(
                torch.stack([U[j:j + D], U[j + D:j + 2 * D]], -1))
            j += 2 * D
            z_raw = x + g
        if frozen0:
            z_raw[0] = x[0]
        if fix_em:
            s_cur = torch.clamp(torch.floor(x[0] * (k + 1)), max=float(k))
            z_raw[em_lo:em_hi] = torch.where(s_cur == k, z_raw[em_lo:em_hi],
                                             x[em_lo:em_hi])
        z = pss_wrap(z_raw)
        coin1, coin2 = U[j], U[j + 1]
        j += 2

        lum_y, v_y, px_y, py_y = _trace_lanes(tables, y, None, work, "y")
        a1 = metropolis_clamp(lum_y / torch.clamp(lum_x, min=1e-30))
        accept1 = coin1 < a1
        if pssmlt:
            # stage 1 only: neither z nor y* is traced, a2 = 0, and z (a
            # stand-in: x) is never splatted with weight nor selected
            a2 = torch.zeros_like(a1)
            accept2 = torch.zeros_like(accept1)
            z, lum_z, v_z, px_z, py_z = x, lum_x, v_x, px_x, py_x
        else:
            do_second = ~accept1
            if not cfg.timid_after_large:
                do_second = do_second & ~large
            lum_z, v_z, px_z, py_z = _trace_lanes(tables, z, do_second, work,
                                                  "z")
            a2, accept2 = _stage2(tables, cfg, kel, work, large, do_second,
                                  a1, coin2, x, y_raw, z_raw, lum_x, lum_y,
                                  lum_z)

        w_y = a1
        w_z = (1.0 - a1) * a2
        w_x = 1.0 - w_y - w_z
        if cfg.splat_mode == "sampled":
            u_sel = U[j]
            pick_y = u_sel < w_y
            pick_z = ~pick_y & (u_sel < w_y + w_z)

            def sel(ay, az, ax):
                return torch.where(pick_y, ay, torch.where(pick_z, az, ax))

            _splat(film, sel(px_y, px_z, px_x), sel(py_y, py_z, py_x),
                   sel(v_y, v_z, v_x), torch.ones_like(w_x))
        else:
            _splat(film, px_x, py_x, v_x, w_x)
            _splat(film, px_y, py_y, v_y, w_y)
            if not pssmlt:
                _splat(film, px_z, py_z, v_z, w_z)

        a1m = accept1
        a2m = accept2 & ~accept1

        def pick(ay, az, ax):
            return torch.where(a1m, ay, torch.where(a2m, az, ax))

        x = pick(y, z, x)
        lum_x = pick(lum_y, lum_z, lum_x)
        px_x = pick(px_y, px_z, px_x)
        py_x = pick(py_y, py_z, py_x)
        v_x = pick(v_y, v_z, v_x)
        st = st + torch.stack([a1, a2, accept1.float(), accept2.float(),
                               large.float(), (a1m | a2m).float()])

    state[:D] = x
    state[D] = lum_x
    state[D + 1] = px_x
    state[D + 2] = py_x
    state[D + 3:D + 6] = v_x
    stats += st
    return state, film, stats


def _stage2(tables, cfg, kel, work, large, do_second, a1, coin2, x, y_raw,
            z_raw, lum_x, lum_y, lum_z):
    """(a2, accept2) of the delayed-rejection stage, per type; lum_z is 0
    where do_second does not hold (z was not traced there)."""
    frozen0 = tables.technique == "mmlt"
    lum_ratio = lum_z / torch.clamp(lum_x, min=1e-30)
    if cfg.type == "orbital":
        num = lum_z - lum_y
        den = lum_x - lum_y
        a2 = torch.where(
            lum_z < lum_y, 0.0,
            torch.where(lum_z >= lum_x, 1.0, metropolis_clamp(
                num / torch.where(torch.abs(den) > 0, den, 1.0))))
    elif cfg.type == "mira":
        a_rev = metropolis_clamp(lum_y / torch.clamp(lum_z, min=1e-30))
        lq = torch.zeros_like(lum_x)
        for dd in range(1 if frozen0 else 0, x.shape[0]):
            lq = lq + (kel.log_pdf(z_raw[dd] - y_raw[dd])
                       - kel.log_pdf(x[dd] - y_raw[dd]))
        q_ratio = torch.where(large, 1.0, torch.exp(lq))
        a2 = metropolis_clamp(lum_ratio * q_ratio * (1.0 - a_rev)
                              / torch.clamp(1.0 - a1, min=1e-12))
        a2 = torch.where(a_rev >= 1.0, 0.0, a2)
        a2 = torch.where(torch.isfinite(q_ratio), a2, 0.0)
    else:
        lum_rev = _trace_lanes(tables, pss_wrap(z_raw - (y_raw - x)),
                               do_second & (lum_z > 0), work, "y_rev")[0]
        a_rev = metropolis_clamp(lum_rev / torch.clamp(lum_z, min=1e-30))
        a2 = metropolis_clamp(lum_ratio * (1.0 - a_rev)
                              / torch.clamp(1.0 - a1, min=1e-12))
        a2 = torch.where(a_rev >= 1.0, 0.0, a2)
    a2 = torch.where(lum_z > 0, a2, 0.0)
    a2 = torch.where(do_second, a2, 0.0)
    return a2, (coin2 < a2) & do_second


# ---------------------------------------------------------------- kernel
_DRTYPE_CODE = {"orbital": 0, "green": 1, "mira": 2}


def _check(tables, cfg, n_mut, state, film, stats, uniforms):
    D, C = _n_dims(state), state.shape[1]
    dev = tables.device
    if tuple(stats.shape) != (6, C):
        raise ValueError(f"stats shape {tuple(stats.shape)}, want {(6, C)}")
    if film.dim() != 3 or film.shape[2] != 3:
        raise ValueError(f"film shape {tuple(film.shape)}, want (H, W, 3)")
    if D < chain_dims(tables):
        raise ValueError(f"chain has {D} dims, the {tables.technique} "
                         f"config reads {chain_dims(tables)}")
    ts = [state, film, stats] + ([uniforms] if uniforms is not None else [])
    for t in ts:
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("chain tensors must be contiguous float32")
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, tables on {dev}")
    want = (n_mut * n_rand(cfg, D), C)
    if uniforms is not None and tuple(uniforms.shape) != want:
        raise ValueError(f"uniforms shape {tuple(uniforms.shape)}, want "
                         f"{want}")


def _technique_args(tables):
    """(technique code, max/min/rr depth, use_nee, light_image, eye_dims,
    light_dims) and (u_depth, 1/k) as drmlt_chain_launch takes them."""
    if tables.technique == "mmlt":
        k = tables.max_depth
        megammlt.check_depth(k)
        return ((1, k, 1, 0, 1, int(tables.light_image), tables.eye_dims,
                 tables.light_dims), (1.0 - 0.5 / k, 1.0 / k))
    return ((0, tables.max_depth, tables.min_depth, tables.rr_depth,
             int(tables.use_nee), 0, 0, 0), (0.0, 0.0))


def drmlt_chain_step(tables, cfg, n_mut: int, state, film, stats, seed: int,
                     launch: int, uniforms=None, pssmlt: bool = False):
    """Run n_mut mutations of every chain under DRMLTConfig cfg, with the
    technique of `tables` (megatrace.TraceTables: path; megammlt.MmltTables:
    a fixed-depth MMLT group), as DRMLT or, with pssmlt, as stage-1-only
    PSSMLT.  Updates state (D+6, C), film (H, W, 3) and stats (6, C) in
    place and returns them.

    CUDA tensors launch drmlt_chain_kernel (one thread per chain); CPU
    tensors run drmlt_chain_step_reference."""
    _check(tables, cfg, n_mut, state, film, stats, uniforms)
    if state.device.type == "cpu":
        return drmlt_chain_step_reference(tables, cfg, n_mut, state, film,
                                          stats, seed, launch, uniforms,
                                          pssmlt=pssmlt)
    if state.device.type != "cuda":
        raise NotImplementedError(f"no chain kernel for {state.device}")
    D, C = _n_dims(state), state.shape[1]
    kel = stage1_kernel(cfg)
    tech, (u_depth, inv_k) = _technique_args(tables)
    scratch = torch.empty((2 * D, C), dtype=torch.float32,
                          device=state.device)
    lib = build.load()
    stream = torch.cuda.current_stream(state.device).cuda_stream
    rc = lib.drmlt_chain_launch(
        *megatrace.scene_args(tables), *tech, state.data_ptr(),
        scratch.data_ptr(), D, C, film.data_ptr(), film.shape[0],
        film.shape[1], stats.data_ptr(),
        uniforms.data_ptr() if uniforms is not None else None,
        n_rand(cfg, D), n_mut, seed & 0xFFFFFFFF, launch & 0xFFFFFFFF,
        _DRTYPE_CODE[cfg.type], int(cfg.splat_mode == "sampled"),
        int(cfg.timid_after_large), int(cfg.fix_emitter_path), int(pssmlt),
        cfg.p_large, kel.s1, kel.s2, kel.log_ratio,
        cfg.scale_second * cfg.sigma,
        kernels.WrappedCauchy(cfg.rho).dispersion, u_depth, inv_k, stream)
    build.check(rc, "drmlt_chain_kernel")
    name = "drmlt_" + tables.technique + ("_pssmlt" if pssmlt else "")
    build.LAUNCHES[build.scope_key(name, tables)] += 1
    return state, film, stats
