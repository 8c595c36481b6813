"""The port's bidirectional layer (integrators/bidir.py: the subpath walks,
the (s, t) strategies with their MIS weights, BDPT, the dense and the
wavefront MMLT traces, the pdf helpers) vs the JAX reference's XLA
functions of the same names, lane for lane on identical PSS vectors.

The reference is compiled once for the module, at max_depth 3 on the 32x32
Cornell box with its mirror tall box (Dirac vertices in the walks and the
MIS recursion): eye_subpath, light_subpath, trace_bdpt with mis=True,
mis=False and only=(s, t) for one strategy of each case, trace_mmlt_dense
over per-lane depths 1-3 and the pdf helpers, in one program, which
traces the two walks and the strategies once (shared_subpaths) (the thin
lens is held to it in test_torch_bidir_lens.py; the port-only checks are
in test_torch_bidir_mmlt.py).  The port runs its CPU twins (the
intersection kernel's plain sweeps).  Tolerances, no looser than the
scene-scope files' (tests/test_torch_scene_scope.py): at most R/500 lanes
with a relative error above 1e-3, the means of the other lanes to 5e-3,
film positions of the lit lanes to 1e-5; the subpath SoAs are compared on
the slots the reference's walk made valid, and their flags and ids
exactly.
"""
import contextlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.integrators import bidir as JB
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu.scene import builders as jax_builders
from drmlt_mitsuba_tpu_torch.integrators import bidir as B
from drmlt_mitsuba_tpu_torch.integrators import misc
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene import builders

torch.set_num_threads(1)

R = 1024
DEPTH = 3
ONLY = {"s0": (0, 3), "conn": (1, 2), "t1": (2, 1)}


def _close(want, got, rel_tol=1e-3):
    """The lane allowance on (R, ...) values."""
    want = np.asarray(want, np.float64).reshape(R, -1)
    got = np.asarray(got, np.float64).reshape(R, -1)
    rel = np.abs(want - got) / (np.abs(want) + 1e-4)
    bad = (rel > rel_tol).any(-1)
    assert bad.sum() <= R // 500, f"{bad.sum()} lanes diverge"
    np.testing.assert_allclose(got[~bad].mean(0), want[~bad].mean(0),
                               rtol=5e-3, atol=1e-6)
    return bad


def _splats(want, got):
    """Splats lane for lane: values, and the positions of lit splats."""
    va, vb = np.asarray(want.value), got.value.numpy()
    assert vb.shape == va.shape
    bad = _close(va, vb)
    lit = (np.abs(va) > 1e-7).any(-1) & ~bad[:, None]
    assert lit.sum() >= 5       # lanes that carry light
    np.testing.assert_allclose(got.pos.numpy()[lit], np.asarray(want.pos)[lit],
                               atol=1e-5)
    np.testing.assert_allclose(got.lum.numpy(), np.asarray(want.lum),
                               rtol=1e-3, atol=1e-5)


@contextlib.contextmanager
def shared_subpaths(jscene, jcfg, b):
    """Trace the reference's two walks of the BDPT vectors b (R, n_dims),
    and its strategies over them, once.  Its traces called in this context
    (trace_bdpt, trace_mmlt_dense, trace_mmlt: each walks these same
    slices of its vectors) read the walks through the module's names, and
    `_strategies` gives the terms of its first pass with the same `mis`;
    only=(s, t) keeps the (s, t) term of that pass, which is what the
    reference's only= evaluates (it skips the other strategies and weighs
    the kept one as the full pass does).  A jitted reference so pays one
    walk's and one pass's tracing."""
    E, uv = JB.eye_subpath(jscene, jcfg, b[:, :jcfg.eye_dims])
    L = JB.light_subpath(jscene, jcfg, b[:, jcfg.eye_dims:])
    strategies, passes = JB._strategies, {}

    def once(scene, cfg, L_, E_, uv_, mis=True, only=None):
        if mis not in passes:
            passes[mis] = list(strategies(scene, cfg, L_, E_, uv_, mis))
        return [x for x in passes[mis] if only in (None, x[:2])]

    with mock.patch.multiple(JB, eye_subpath=lambda *a: (E, uv),
                             light_subpath=lambda *a: L, _strategies=once):
        yield E, uv, L


@pytest.fixture(scope="module")
def box():
    box_kw = dict(tall_box_material="mirror")
    jscene = jax_builders.cornell_box(32, 32, **box_kw)
    jcfg = JB.BDPTConfig(max_depth=DEPTH)
    cfg = B.BDPTConfig(max_depth=DEPTH)
    rng = np.random.default_rng(5)
    # column 0 is the MMLT strategy dim, the rest the BDPT layout
    u = rng.random((R, 1 + cfg.n_dims), dtype=np.float32)
    depth = (1 + rng.integers(0, DEPTH, R)).astype(np.int32)
    # the pdf helpers' inputs, on a box whose materials have every
    # non-Dirac lobe: diffuse, Oren-Nayar, the GGX conductor
    kinds = dict(tall_box_material="orennayar",
                 sphere_material="roughconductor")
    jkinds = jax_builders.cornell_box(8, 8, **kinds)

    def unit(n):
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    h = dict(mat=rng.integers(0, 6, R).astype(np.int32), wi=unit(R),
             wo=unit(R), ns=unit(R),
             p=rng.uniform(0, 556, (2, R, 3)).astype(np.float32))
    # wi and wo on the same side of ns where a lobe can be nonzero
    h["wo"] = np.where((np.sum(h["wi"] * h["ns"], -1) * np.sum(
        h["wo"] * h["ns"], -1) < 0)[:, None], -h["wo"], h["wo"])

    @jax.jit
    def reference(x, d, hx):
        b = x[:, 1:]
        f, pdf = JB._bsdf_eval_pdf(jkinds, hx["mat"], hx["wi"], hx["wo"],
                                   hx["ns"])
        with shared_subpaths(jscene, jcfg, b) as (E, uv, L):
            out = dict(E=E, uv=uv, L=L, mis=JB.trace_bdpt(jscene, jcfg, b),
                       nomis=JB.trace_bdpt(jscene, jcfg, b, mis=False),
                       dense=JB.trace_mmlt_dense(jscene, jcfg, x, d),
                       f=f, pdf=pdf,
                       pdf_rev=JB._bsdf_pdf_sa(jkinds, hx["mat"], hx["wo"],
                                               hx["wi"], hx["ns"]),
                       area=JB._sa_to_area(pdf, hx["p"][0], hx["p"][1],
                                           hx["ns"]))
            for k, o in ONLY.items():
                out[k] = JB.trace_bdpt(jscene, jcfg, b, only=o)
        return out

    scene = builders.cornell_box(32, 32, **box_kw)
    return dict(ref=reference(jnp.asarray(u), jnp.asarray(depth),
                              {k: jnp.asarray(v) for k, v in h.items()}),
                u=torch.from_numpy(u), depth=torch.from_numpy(depth),
                cfg=cfg, tables=B.make_bidir_tables(scene, cfg, "cpu"),
                h={k: torch.from_numpy(v) for k, v in h.items()},
                kinds=B.make_bidir_tables(builders.cornell_box(8, 8, **kinds),
                                          cfg, "cpu"))


FIELDS = ("p", "ns", "ng", "wi", "beta", "pdf_fwd", "pdf_rev", "uv")


def _soa(want, got, n_slots):
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    np.testing.assert_array_equal(got.escaped.numpy(),
                                  np.asarray(want.escaped))
    assert got.p.shape[1] == n_slots and valid[:, 1:].mean() > 0.3
    for name in ("delta", "mat_id", "emitter_id"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy()[valid],
            np.asarray(getattr(want, name))[valid], err_msg=name)
    for name in FIELDS:
        a = np.asarray(getattr(want, name))
        b = getattr(got, name).numpy()
        m = valid if a.ndim == 2 else valid[..., None]
        _close(np.where(m, a, 0.0), np.where(m, b, 0.0))
    # the escaped slots carry the throughput and the escape direction
    esc = np.asarray(want.escaped)[..., None]
    for name in ("beta", "wi"):
        _close(np.where(esc, np.asarray(getattr(want, name)), 0.0),
               np.where(esc, getattr(got, name).numpy(), 0.0))


def test_eye_subpath_matches_reference(box):
    cfg, u = box["cfg"], box["u"][:, 1:]
    E, uv = B.eye_subpath(box["tables"], cfg, u[:, :cfg.eye_dims])
    _soa(box["ref"]["E"], E, cfg.n_eye)
    assert E.escaped.any()         # the open side of the box
    np.testing.assert_array_equal(uv.numpy(), np.asarray(box["ref"]["uv"]))


def test_light_subpath_matches_reference(box):
    cfg, u = box["cfg"], box["u"][:, 1:]
    L = B.light_subpath(box["tables"], cfg, u[:, cfg.eye_dims:])
    _soa(box["ref"]["L"], L, cfg.n_light)


@pytest.mark.parametrize("mis", [True, False], ids=["mis", "no-mis"])
def test_trace_bdpt_matches_reference(box, mis):
    """The pixel splat and the n_light light-image splats, S = 1 + n_light;
    the MIS-weighted sum is below the unweighted one's.  Without MIS, the
    port's particle tracer (integrators/misc.py:render_ptracer, one chunk
    of R) on the same vectors equals, to float32 rounding, the reference's
    own ptracer steps (drmlt_mitsuba_tpu/integrators/misc.py:42-61) over
    the reference's no-MIS splats: slot 0 zeroed, positions times (W, H)
    into a splat-mode film, developed at W H / R."""
    cfg = box["cfg"]
    got = B.trace_bdpt(box["tables"], cfg, box["u"][:, 1:], mis=mis)
    assert got.value.shape == (R, cfg.n_splats, 3) == (R, 1 + DEPTH, 3)
    _splats(box["ref"]["mis" if mis else "nomis"], got)
    if not mis:
        mis_sum = B.trace_bdpt(box["tables"], cfg,
                               box["u"][:, 1:]).value.sum()
        assert float(mis_sum) < float(got.value.sum())
        ref, W, H = box["ref"]["nomis"], 32, 32
        jfc = jfilm.make_film_config(W, H, "box")
        jf = jfilm.splat(jfc, jfilm.new_film(jfc),
                         ref.pos.reshape(-1, 2) * jnp.asarray([W, H],
                                                              jnp.float32),
                         ref.value.at[:, 0].set(0.0).reshape(-1, 3),
                         mode="splat")
        want = np.asarray(jfilm.develop(jfc, jf, mode="splat",
                                        scale=W * H / R))
        img = misc.render_ptracer(
            box["tables"], filmlib.make_film_config(W, H, "box"),
            torch.Generator(), R, max_depth=DEPTH, chunk=R,
            u=box["u"][:, 1:])
        assert (want.sum(-1) > 0).mean() > 0.3
        np.testing.assert_allclose(img.numpy(), want, rtol=1e-5, atol=1e-6)


def test_pdf_helpers_match_reference(box):
    """_bsdf_eval_pdf, _bsdf_pdf_sa (the reverse direction) and
    _sa_to_area on random directions and frames over every material of a
    box with diffuse, Oren-Nayar and GGX-conductor lobes, held to the
    reference's helpers (not to the kernels' device functions)."""
    h, ref, tb = box["h"], box["ref"], box["kinds"]
    assert tb.kinds == {0, 3, 12}
    f, pdf = B._bsdf_eval_pdf(tb, h["mat"], h["wi"], h["wo"], h["ns"])
    _close(ref["f"], f.numpy())
    _close(ref["pdf"], pdf.numpy())
    assert (pdf.numpy() > 0).mean() > 0.5
    _close(ref["pdf_rev"], B._bsdf_pdf_sa(tb, h["mat"], h["wo"], h["wi"],
                                          h["ns"]).numpy())
    _close(ref["area"], B._sa_to_area(pdf, h["p"][0], h["p"][1],
                                      h["ns"]).numpy())


@pytest.mark.parametrize("case", list(ONLY))
def test_single_strategy_matches_reference(box, case):
    """only=(s, t), one of each case: the eye path on the emitter (s = 0),
    a connection with its shadow ray, light tracing onto the film (t = 1,
    its splat in the s-th light image)."""
    s, t = ONLY[case]
    got = B.trace_bdpt(box["tables"], box["cfg"], box["u"][:, 1:],
                       only=(s, t))
    _splats(box["ref"][case], got)
    nonzero = (got.value.abs().sum(-1) > 0).any(0).tolist()
    assert nonzero == [t > 1] + [t == 1 and k == s
                                 for k in range(1, DEPTH + 1)]


def test_mmlt_dense_and_wavefront_match_reference(box):
    """trace_mmlt_dense against the reference's, and the wavefront's
    per-lane gathered strategy against both (the reference pins its XLA
    trace_mmlt to its dense oracle the same way)."""
    args = (box["tables"], box["cfg"], box["u"], box["depth"])
    dense = B.trace_mmlt_dense(*args)
    _splats(box["ref"]["dense"], dense)
    wave = B.trace_mmlt_wavefront(*args)
    _splats(box["ref"]["dense"], wave)
    _close(dense.value.numpy(), wave.value.numpy())
    # the strategy is selected per lane: every case is in the batch
    s = torch.clamp((box["u"][:, 0] * (box["depth"] + 1)).long(),
                    max=DEPTH)
    assert set(s.tolist()) == {0, 1, 2, 3}
