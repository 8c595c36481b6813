"""The port's trace twins on the reference megakernels' whole scene scope:
analytic spheres, the conductor / rough-conductor / null kinds, bitmap
albedo, constant and image environments, the thin lens.

One 64x64 Cornell-box scene per feature group, built by the JAX package
and carried into the port leaf for leaf (scene_from_arrays):
  kinds   : a rough-conductor analytic sphere, a gold conductor tall box,
            a null short box (rays pass through it);
  texture : a checkerboard albedo page on the back wall, and a constant
            environment the open box lets in;
  image   : a lat-long image environment (its emitter row, CDF NEE) and
            the rough-conductor sphere;
  thinlens: the kinds scene seen through a thin lens (path only: the
            reference's MMLT kernel has no thin lens either).
`path_trace_reference` is held to the XLA `trace_paths` (and, in
test_torch_scene_scope_mmlt.py, `mmlt_trace_reference` to the XLA
`trace_mmlt`), with the allowances the
reference grants its own kernel against them (tests/test_megatrace.py:
58-243): lanes with a relative error above 1e-3 at most R/500 on the
sphere, thin-lens and constant-environment scenes; above 2e-3 at most
R/50 on the textured and image-environment scenes (texel and pixel
boundaries round differently), channel means to rtol 1e-2 there.  The
chain twin is held to the reference's step loop on identical uniforms in
test_torch_scene_scope_chain.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scene import _subset, jax_leaves

from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.integrators.path import trace_paths as jax_trace
from drmlt_mitsuba_tpu.scene import types as jst
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.path import trace_paths
from drmlt_mitsuba_tpu_torch.ops import megammlt as MM
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT
from drmlt_mitsuba_tpu_torch.scene.convert import scene_from_arrays

torch.set_num_threads(1)

R = 1024
SIZE = 64
ENV_RGB = (0.4, 0.5, 0.7)
# the allowances per scene: (relative error, lanes allowed above it,
# channel-mean rtol)
TOL = {"kinds": (1e-3, R // 500, 5e-3), "texture": (2e-3, R // 50, 1e-2),
       "image": (2e-3, R // 50, 1e-2), "thinlens": (1e-3, R // 500, 5e-3)}


def jax_scene(name):
    """The feature scene `name` built with the JAX package."""
    sc = jax_cornell(SIZE, SIZE, tall_box_material="mirror",
                     sphere_material="roughconductor")
    m, t, em = sc.materials, sc.tris, sc.emitters
    if name in ("kinds", "thinlens", "image"):
        # tall box: a gold conductor; short box (triangles 12-23): null
        kind = np.asarray(m.kind).copy()
        kind[4] = jst.BSDF_CONDUCTOR
        eta, k = np.asarray(m.eta).copy(), np.asarray(m.k).copy()
        eta[4], k[4] = (0.143, 0.375, 1.442), (3.983, 2.386, 1.603)
        mats = [jnp.asarray(kind), jnp.asarray(eta), jnp.asarray(k)]
        mid = np.asarray(t.mat_id).copy()
        if name != "image":
            kind = np.concatenate([kind, [jst.BSDF_NULL]]).astype(np.int32)
            mid[12:24] = len(kind) - 1
            mats = [jnp.asarray(kind)] + [
                jnp.concatenate([jnp.asarray(a), jnp.asarray(a[:1])])
                for a in (eta, k)]
            m = m.replace(**{f.name: jnp.concatenate(
                [getattr(m, f.name), getattr(m, f.name)[:1]])
                for f in dataclasses.fields(m)
                if f.name in ("albedo", "roughness", "spec_refl",
                              "spec_trans", "tex_id", "two_sided")})
        m = m.replace(kind=mats[0], eta=mats[1], k=mats[2],
                      kinds_present=tuple(sorted(set(
                          int(x) for x in np.asarray(mats[0])))))
        t = t.replace(mat_id=jnp.asarray(mid))
    if name == "texture":
        # a checkerboard page on the back wall (triangles 4-5), uv in [0, 1]
        yy, xx = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
        page = np.where((((xx // 4) + (yy // 4)) % 2)[..., None] == 0,
                        (0.8, 0.2, 0.1), (0.1, 0.3, 0.8)).astype(np.float32)
        tex_id = np.asarray(m.tex_id).copy()
        tex_id[0] = 0          # the white material: walls, ceiling, floor
        m = m.replace(tex_id=jnp.asarray(tex_id))
        uv = np.zeros((t.v0.shape[0], 3, 2), np.float32)
        uv[:, 1] = (1.0, 0.0)
        uv[:, 2] = (0.3, 1.0)
        t = t.replace(uv0=jnp.asarray(uv[:, 0]), uv1=jnp.asarray(uv[:, 1]),
                      uv2=jnp.asarray(uv[:, 2]))
        em = em.replace(env_radiance=jnp.asarray(ENV_RGB, jnp.float32))
        sc = sc.replace(textures=jst.TextureAtlas(
            data=jnp.asarray(page[None])))
    if name == "image":
        img = np.random.default_rng(3).random((8, 16, 3)).astype(np.float32)
        img[2:4, 4:7] *= 20.0            # a bright patch to importance-sample
        # the triangles' emitter ids are the builder's area rows already
        em = jst.build_emitters(t, np.asarray(em.radiance), env_image=img)
    if name == "thinlens":
        sc = sc.replace(camera=sc.camera.replace(
            aperture_radius=jnp.float32(25.0),
            focus_distance=jnp.float32(800.0)))
    return sc.replace(materials=m, tris=t, emitters=em)


def port_scene(jscene):
    """The same scene in the port, from the JAX scene's leaves."""
    arrays = _subset(jax_leaves(jscene))
    if jscene.textures is not None:
        arrays["textures.data"] = np.asarray(jscene.textures.data)
    return scene_from_arrays(arrays)


def _check(va, vb, name, lit=0.2):
    """The scene's lane allowance; the channel means of the lanes within
    it to 5e-3 (a lane that flips at an edge, say a thin-lens ray grazing
    the light, is a firefly the means cannot absorb), and on the textured
    and image scenes the means of every lane to 1e-2 as well."""
    rel_tol, n_bad, mean_rtol = TOL[name]
    rel = np.abs(va - vb) / (np.abs(va) + 1e-3)
    bad = (rel > rel_tol).any(-1)
    assert bad.sum() <= n_bad, f"{name}: {bad.sum()} lanes diverge"
    np.testing.assert_allclose(vb[~bad].mean(0), va[~bad].mean(0),
                               rtol=5e-3, atol=1e-5)
    if mean_rtol > 5e-3:
        np.testing.assert_allclose(vb.mean(0), va.mean(0), rtol=mean_rtol,
                                   atol=1e-5)
    assert (va.sum(-1) > 0).mean() > lit     # the scene is lit


@pytest.mark.parametrize("name", ["kinds", "texture", "image", "thinlens"])
def test_path_twin_matches_trace_paths(name):
    jscene = jax_scene(name)
    thin = name == "thinlens"
    kw = dict(max_depth=4, rr_depth=3, thinlens=thin)
    cfg = PathConfig(**kw)
    u = np.random.default_rng(11).random((R, cfg.n_dims), dtype=np.float32)
    ref = jax.jit(lambda x: jax_trace(jscene, JPathConfig(**kw), x))(
        jnp.asarray(u))
    scene = port_scene(jscene)
    tables = MT.make_tables(scene, cfg, "cpu")
    assert tables.full
    got = trace_paths(scene, cfg, torch.from_numpy(u))
    _check(np.asarray(ref.value[:, 0, :]), got.value[:, 0, :].numpy(), name)



def test_unported_features_raise_naming_themselves():
    """What the kernels still do not cover raises NotImplementedError
    naming it: motion, a lens without the lens dims, the MMLT kernel with
    a thin lens, emissive analytic spheres, point emitters."""
    scene = port_scene(jax_scene("kinds"))
    assert MT.mega_eligible(scene, PathConfig(max_depth=3))
    assert not MT.mega_eligible(scene, PathConfig(max_depth=3, motion=True))
    with pytest.raises(NotImplementedError, match="motion"):
        MT.require_mega_scope(scene, PathConfig(max_depth=3, motion=True))
    lens = port_scene(jax_scene("thinlens"))
    assert MT.mega_eligible(lens, PathConfig(thinlens=True))
    assert not MT.mega_eligible(lens, PathConfig())
    with pytest.raises(NotImplementedError, match="thinlens=True"):
        MT.require_mega_scope(lens, PathConfig())
    with pytest.raises(NotImplementedError, match="thin-lens"):
        MM.mega_mmlt_eligible(lens, BDPTConfig(max_depth=3))
    # the bidirectional config takes the lens; the MMLT kernel does not
    with pytest.raises(NotImplementedError, match="thin-lens"):
        MM.make_mmlt_tables(lens, BDPTConfig(max_depth=3, thinlens=True),
                            "cpu")
    glowing = dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, emitter_id=torch.zeros_like(scene.spheres.emitter_id)))
    with pytest.raises(NotImplementedError, match="emissive analytic"):
        MT.make_tables(glowing, PathConfig(max_depth=3), "cpu")
    point = dataclasses.replace(scene, emitters=dataclasses.replace(
        scene.emitters, kind=torch.ones_like(scene.emitters.kind)))
    with pytest.raises(NotImplementedError, match="point"):
        MM.make_mmlt_tables(point, BDPTConfig(max_depth=3), "cpu")
    # the scope flag: slices 1-4's scenes keep their instantiation
    from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box
    assert not MT.make_tables(cornell_box(8, 8), PathConfig(max_depth=2),
                              "cpu").full
