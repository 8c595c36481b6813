"""Every emitter kind of the path wavefront (render/emitter.py:
EmitterRows, sample_emitter_direct, pdf_emitter_direct, eval_emitter,
eval_env, env_pdf_dir) against the reference's render/emitter.py on
identical points and uniforms: triangle area rows, point, spot (its cone
falloff), directional, collimated (lit from the beam's origin, as the
reference's sample_emitter_direct does) and the image environment; the
port's copy of scene/sunsky.py against the reference's.  Emissive analytic
spheres go through the wavefront in test_torch_surface_trace.py.

Tolerance: relative 1e-4 (floor 1e-3) per lane, at most R/500 lanes
above it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.render import emitter as je
from drmlt_mitsuba_tpu.scene import sunsky as jsun
from drmlt_mitsuba_tpu.scene import types as jst
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu_torch.ops.megatrace import pack_mega_tables_torch
from drmlt_mitsuba_tpu_torch.render import emitter as em
from drmlt_mitsuba_tpu_torch.scene import sunsky
from drmlt_mitsuba_tpu_torch.scene import types as st
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box, sky_image
from test_torch_scene import jax_leaves

torch.set_num_threads(1)

R = 4000
RTOL, FLOOR = 1e-4, 1e-3
KW = dict(
    point_pos=np.asarray([[278.0, 450.0, 200.0], [100.0, 300.0, 100.0]],
                         np.float32),
    point_intensity=np.asarray([[2e4, 1.8e4, 1.5e4], [5e3, 5e3, 9e3]],
                               np.float32),
    directional=[(np.asarray([0.3, -1.0, 0.4], np.float32),
                  np.asarray([0.5, 0.45, 0.4], np.float32))],
    spots=[(np.asarray([60.0, 500.0, 120.0], np.float32),
            np.asarray([6e4, 5e4, 4e4], np.float32),
            np.asarray([0.25, -0.9, 0.3], np.float32), 25.0)],
    env_image=sky_image(16, 32))
BEAM = [(np.asarray([50.0, 273.0, 279.0], np.float32),
         np.asarray([1.0, 0.0, 0.0], np.float32),
         np.asarray([2e5, 2e5, 2e5], np.float32))]


def _scenes(**extra):
    """(port scene, reference scene) of the Cornell box with the emitters
    of KW (and `extra`) in both packages."""
    sc, jsc = cornell_box(16, 16), jax_cornell(16, 16)
    rad = np.asarray(jsc.emitters.radiance)
    e = st.build_emitters(sc.tris, rad, **KW, **extra)
    je_ = jst.build_emitters(jsc.tris, rad, **KW, **extra)
    return (dataclasses.replace(sc, emitters=e), jsc.replace(emitters=je_))


def _check(name, ref, got):
    ref = np.asarray(ref).reshape(R, -1)
    got = got.numpy().reshape(R, -1)
    assert np.isfinite(got).all(), name
    err = (np.abs(ref - got) / np.maximum(np.abs(ref), FLOOR)).max(1)
    assert (err > RTOL).sum() <= R // 500, f"{name}: max {err.max()}"


@pytest.fixture(scope="module")
def case():
    sc, jsc = _scenes(collimated=BEAM)
    rng = np.random.default_rng(5)
    p = (rng.random((R, 3)) * [556, 556, 556]).astype(np.float32)
    u3 = rng.random((R, 3), dtype=np.float32)
    rows = em.emitter_table_rows(sc, pack_mega_tables_torch(sc))
    return dict(sc=sc, jsc=jsc, p=p, u3=u3, rows=rows)


def test_build_emitters_equals_reference():
    sc, jsc = _scenes(collimated=BEAM)
    ref = jax_leaves(jsc)
    for f in dataclasses.fields(sc.emitters):
        v = getattr(sc.emitters, f.name)
        np.testing.assert_array_equal(v.numpy(), np.asarray(
            ref[f"emitters.{f.name}"]), err_msg=f.name)
    assert sc.emitters.kind.tolist()[-6:] == [1, 1, 2, 4, 3, 5]


def test_direct_sampling_matches_reference(case):
    ref = jax.jit(lambda p, u: je.sample_emitter_direct(case["jsc"], p, u))(
        case["p"], case["u3"])
    got = em.sample_emitter_direct(case["rows"], torch.from_numpy(case["p"]),
                                   torch.from_numpy(case["u3"]))
    for f in ("d", "dist", "radiance", "pdf"):
        _check(f, getattr(ref, f), getattr(got, f))
    np.testing.assert_array_equal(got.delta.numpy(), np.asarray(ref.delta))
    # every kind was drawn, and the spot's cone cuts some samples off
    kinds = case["rows"].kind[(torch.from_numpy(case["u3"][:, :1])
                               >= case["rows"].cdf[None]).sum(-1).clamp(
        max=case["rows"].kind.shape[0] - 1)]
    assert set(kinds.tolist()) == {0, 1, 2, 3, 4, 5}
    assert float(got.radiance[kinds == 3].abs().sum(-1).eq(0).float()
                 .mean()) > 0.2


def test_hit_pdf_emission_and_environment_match_reference(case):
    rng = np.random.default_rng(6)
    jsc, rows = case["jsc"], case["rows"]
    erow = rng.integers(-1, rows.kind.shape[0], R).astype(np.int32)
    hp = (rng.random((R, 3)) * 556).astype(np.float32)
    v = rng.normal(size=(R, 3)).astype(np.float32)
    n = v / np.linalg.norm(v, axis=1, keepdims=True)
    v = rng.normal(size=(R, 3)).astype(np.float32)
    d = v / np.linalg.norm(v, axis=1, keepdims=True)
    ref = jax.jit(lambda p, r, hp, n, d: (
        je.pdf_emitter_direct(jsc, p, r, hp, n), je.eval_emitter(jsc, r, d, n),
        je.eval_env(jsc, d), je.env_pdf_dir(jsc, d)))(case["p"], erow, hp, n,
                                                      d)
    T = torch.from_numpy
    got = (em.pdf_emitter_direct(rows, T(case["p"]), T(erow), T(hp), T(n)),
           em.eval_emitter(rows, T(erow), T(d), T(n)),
           em.eval_env(rows, T(d)), em.env_pdf_dir(rows, T(d)))
    for name, r, g in zip(("pdf", "emission", "env", "env_pdf"), ref, got):
        _check(name, r, g)
    assert float(got[0].max()) > 0 and float(got[1].max()) > 0


def test_bake_sky_matches_reference():
    for kw in (dict(turbidity=3.0, height=16),
               dict(turbidity=5.0, sun_dir=(0.3, 0.5, -0.2), height=8,
                    with_sky=False, sun_scale=0.5),
               dict(turbidity=2.5, height=8, with_sun=False, sky_scale=2.0,
                    ground_albedo=0.3)):
        np.testing.assert_array_equal(sunsky.bake_sky(**kw),
                                      jsun.bake_sky(**kw))
    args = dict(year=2012, month=3, day=20, hour=9.5, latitude=48.1,
                longitude=11.6, timezone=1.0)
    np.testing.assert_array_equal(sunsky.sun_direction_from_time(**args),
                                  jsun.sun_direction_from_time(**args))
