"""The path wavefront's BSDF (render/bsdf.py: eval_bsdf_table,
sample_bsdf_table, is_delta_table) against the reference's render/bsdf.py
on every surface kind the port adds (plastic, rough plastic, thin and
rough dielectric, phong, ward, difftrans, hk), the kernels' seven and the
mask, coating and mixture wrappers, on identical numpy-seeded directions
and uniforms: eval and is_delta here, sample in
test_torch_surface_sample.py, the chi-square test of the sampling in
test_torch_surface_chi2.py.

The reference's eval and sample are each jitted once (one per file), on
one table holding every row.  Tolerance: relative 1e-4 (floor 1e-3) per
lane; at most R/500 lanes in all, over every kind together, may exceed
it, where a last-bit difference flips a branch (a Fresnel pick, a
horizon test).
"""
import functools

import jax
import numpy as np
import torch

from drmlt_mitsuba_tpu.render import bsdf as jb
from drmlt_mitsuba_tpu.scene import types as jst
from drmlt_mitsuba_tpu_torch.ops.megatrace import pack_mat_table
from drmlt_mitsuba_tpu_torch.render import bsdf
from drmlt_mitsuba_tpu_torch.scene import types as st

torch.set_num_threads(1)

CU = dict(eta=(0.2, 0.92, 1.1), k=(3.9, 2.45, 2.14))
MATS = {
    "diffuse": dict(kind=0, albedo=(0.6, 0.5, 0.4)),
    "plastic": dict(kind=4, albedo=(0.3, 0.6, 0.2), eta=1.5),
    "roughplastic": dict(kind=5, albedo=(0.3, 0.6, 0.2), eta=1.5,
                         roughness=0.1),
    "thindielectric": dict(kind=6, eta=1.5),
    "roughdielectric": dict(kind=7, eta=1.5, roughness=0.2),
    "phong": dict(kind=10, albedo=(0.3, 0.3, 0.3), spec_refl=(0.4,) * 3,
                  roughness=0.3),
    "ward": dict(kind=11, albedo=(0.3, 0.3, 0.3), spec_refl=(0.2,) * 3,
                 roughness=0.2),
    "difftrans": dict(kind=13, albedo=(0.5, 0.5, 0.5)),
    "hk": dict(kind=14, spec_refl=(2.0, 1.5, 1.0), spec_trans=(0.05,) * 3,
               roughness=1.0, k=(0.3, 0.0, 0.0)),
    "roughconductor": dict(kind=3, roughness=0.2, **CU),
    "roughdiffuse": dict(kind=12, roughness=0.5),
    "dielectric": dict(kind=2, eta=1.5),
    "conductor": dict(kind=1, **CU),
    "mirror": dict(kind=8),
    "null": dict(kind=9),
    "mask": dict(kind=0, albedo=(0.5, 0.5, 0.5), opacity=(0.5, 0.4, 0.6)),
    # a two-link mixture chain: 0.6 diffuse, then 0.25 rough conductor
    # (row 9), then 0.15 phong (row 5)
    "mixture": dict(kind=0, albedo=(0.7, 0.2, 0.2), mix_other=18,
                    mix_weight=0.4),
    "coating": dict(kind=1, coat_eta=1.5, coat_sigma_a=(0.1, 0.2, 0.3),
                    **CU),
    "link": dict(kind=3, roughness=0.2, mix_other=5, mix_weight=0.375,
                 **CU),
}
NAMES = list(MATS)
R = 8000
RTOL, FLOOR = 1e-4, 1e-3


def _port_table(mats):
    pt = st.make_material_table(mats)
    return bsdf.material_table_rows(pt, pack_mat_table(pt))


def _tables(mats):
    return jst.make_material_table(mats), _port_table(mats)


@functools.lru_cache(maxsize=None)
def case():
    """One table of every row and R lanes over it: the numpy inputs and
    both packages' tables (the reference's eval and sample are jitted by
    the tests that compare them, one compile each)."""
    jt, tab = _tables(list(MATS.values()))
    rng = np.random.default_rng(11)

    def dirs(n):
        v = rng.normal(size=(n, 3))
        return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(
            np.float32)

    mid = (np.arange(R) % len(MATS)).astype(np.int32)
    wi, wo = dirs(R), dirs(R)
    u3 = rng.random((R, 3), dtype=np.float32)
    alb = np.asarray(jt.albedo)[mid]
    T = torch.from_numpy
    return dict(jt=jt, tab=tab, mid=mid, np=(mid, alb, wi), wo=wo, u3=u3,
                args=(T(mid), T(alb), T(wi)))


def _check(name, ref, got, mid):
    """At most R/500 lanes in all may exceed the tolerance."""
    ref = np.asarray(ref).reshape(R, -1)
    got = got.numpy().reshape(R, -1)
    assert np.isfinite(got).all(), name
    err = (np.abs(ref - got) / np.maximum(np.abs(ref), FLOOR)).max(1)
    bad = {m: int((err[mid == i] > RTOL).sum())
           for i, m in enumerate(NAMES)}
    assert sum(bad.values()) <= R // 500, (
        f"{name}: {bad}, max {err.max()}")


def test_eval_matches_reference():
    c = case()
    ref = jax.jit(lambda *a: jb.eval_bsdf(c["jt"], *a))(*c["np"], c["wo"])
    val, pdf = bsdf.eval_bsdf_table(c["tab"], *c["args"],
                                    torch.from_numpy(c["wo"]))
    _check("value", ref[0], val, c["mid"])
    _check("pdf", ref[1], pdf, c["mid"])
    # every lobe is evaluated somewhere
    for i, m in enumerate(NAMES):
        if m not in ("thindielectric", "dielectric", "conductor", "mirror",
                     "null", "coating"):
            assert float(pdf[torch.from_numpy(c["mid"] == i)].max()) > 0, m


def test_is_delta_matches_reference():
    c = case()
    ref = jax.jit(lambda m: jb.is_delta_kind(c["jt"], m))(c["mid"])
    got = bsdf.is_delta_table(c["tab"], c["args"][0]).numpy()
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert set(bsdf.SUPPORTED_KINDS) < set(bsdf.TABLE_KINDS)
