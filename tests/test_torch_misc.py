"""The port's forward renderers (integrators/misc.py) against the JAX
package's: the nine field AOVs and the motion AOV on the reference's own
uniforms (jax.random.uniform on its key, passed as `u`) on a 16x16 box,
the particle tracer against the path tracer, and the multichannel render
against its channels rendered one at a time.

Every first hit is the reference's (primindex and shapeindex are equal),
so the images agree to float32 rounding: rtol 1e-5, atol 1e-6, and atol
1e-3 (scene units, the box is 556 wide) for the positions, whose
camera-ray directions round differently (the reference normalises the
focus-plane point through its thin-lens form even for a pinhole).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.integrators import misc as jmisc
from drmlt_mitsuba_tpu.render import film as jfilm
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu.scene.types import build_motion as jax_build_motion
from drmlt_mitsuba_tpu.scene.types import prepare_scene as jax_prepare
from drmlt_mitsuba_tpu_torch.integrators import misc
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.path import render_pt
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene import types as st
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box
from drmlt_mitsuba_tpu_torch.scene.convert import scene_from_arrays
from test_torch_scene import _subset, jax_leaves

torch.set_num_threads(1)

SIZE, SPP = 16, 4
KEY = jax.random.PRNGKey(1)
GROUPS = {"geometry": ("position", "relposition", "distance"),
          "normals": ("geonormal", "shnormal", "uv"),
          "ids": ("albedo", "primindex", "shapeindex")}
MOTION = ("dv0", "de1", "de2", "dn0", "dn1", "dn2")


def _u(key):
    """The reference's uniforms of _first_hit_fields (misc.py:79)."""
    return torch.from_numpy(np.array(jax.random.uniform(
        key, (SIZE * SIZE * SPP, 4))))


@pytest.fixture(scope="module")
def box():
    return (jax_prepare(jax_cornell(SIZE, SIZE)),
            jfilm.make_film_config(SIZE, SIZE, "box"), cornell_box(SIZE, SIZE),
            filmlib.make_film_config(SIZE, SIZE, "box"))


@pytest.fixture(scope="module")
def field_refs(box):
    """Every kind of the reference's render_field, one jitted program."""
    js, jfc = box[:2]
    out = jax.jit(lambda k: [jmisc.render_field(js, jfc, k, kind, SPP)
                             for kind in jmisc.FIELD_KINDS])(KEY)
    return dict(zip(jmisc.FIELD_KINDS, (np.asarray(o) for o in out)))


@pytest.mark.parametrize("group", list(GROUPS))
def test_field_matches_reference(box, field_refs, group):
    sc, fc = box[2:]
    u = _u(KEY)
    for kind in GROUPS[group]:
        got = misc.render_field(sc, fc, torch.Generator(), kind, SPP,
                                u=u).numpy()
        atol = 1e-3 if "position" in kind else 1e-6
        np.testing.assert_allclose(got, field_refs[kind][..., :3],
                                   rtol=1e-5, atol=atol, err_msg=kind)
        # the box's meshes carry no texture coordinates
        assert np.abs(got).max() > 0 or kind == "uv", kind
    with pytest.raises(ValueError, match="unknown field"):
        misc.render_field(sc, fc, torch.Generator(), "nope")


def _translated(tris, dx):
    """The reference test's motion: every non-emissive triangle +dx."""
    return dataclasses.replace(tris, v0=tris.v0 + dx)


@pytest.mark.parametrize("moving", [False, True], ids=["static", "plus_x"])
def test_motion_aov_matches_reference(box, moving):
    """A static box gives zeros; the +20 x translation of the reference's
    test_motion_aov, built by the port's build_motion (equal to the
    reference's) and carried from the reference scene by
    scene_from_arrays, gives the reference's image."""
    js, jfc, sc, fc = box
    key = jax.random.PRNGKey(2)
    u = _u(key)
    if not moving:
        got = misc.render_motion_aov(sc, fc, torch.Generator(), SPP, u=u)
        assert float(got.abs().max()) == 0.0
        return
    dx = jnp.where((js.tris.emitter_id < 0)[:, None],
                   jnp.asarray([20.0, 0.0, 0.0]), 0.0)
    jmo = jax_build_motion(js.tris, js.tris.replace(v0=js.tris.v0 + dx))
    ref = np.asarray(jax.jit(lambda k, m: jmisc.render_motion_aov(
        js.replace(motion=m), jfc, k, SPP))(key, jmo))
    mo = st.build_motion(sc.tris, _translated(
        sc.tris, torch.from_numpy(np.asarray(dx))))
    arrays = _subset(jax_leaves(js))
    arrays.update({f"motion.{f}": np.asarray(getattr(jmo, f)) for f in MOTION})
    conv = scene_from_arrays(arrays)
    for f in MOTION:
        np.testing.assert_array_equal(getattr(mo, f).numpy(),
                                      np.asarray(getattr(jmo, f)), err_msg=f)
        assert torch.equal(getattr(conv.motion, f), getattr(mo, f)), f
    got = misc.render_motion_aov(conv, fc, torch.Generator(), SPP, u=u)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert (got[..., 0] > 0).float().mean() > 0.5
    assert float(got[..., 2].abs().max()) == 0.0
    lights = _translated(sc.tris, torch.tensor([0.0, 0.0, 5.0]))
    with pytest.raises(ValueError, match="moving emissive"):
        st.build_motion(sc.tris, lights)


def test_ptracer_mean_matches_the_path_tracer(box):
    """The reference's gate (tests/test_misc_integrators.py:18-38): the
    light tracer's image mean within 5% of the path tracer's, rows
    coarsely.  The path tracer draws its paths with the sobol sampler: the
    independent one's image mean spreads +-3% over seeds at this budget
    (the light, seen directly, lands in a few pixels), the sobol one's
    0.3%."""
    sc, fc = box[2:]
    lt = misc.render_ptracer(sc, fc, torch.Generator().manual_seed(0),
                             1 << 13, max_depth=4)
    film = render_pt(sc, PathConfig(max_depth=4, rr_depth=100),
                     torch.Generator().manual_seed(1), SIZE * SIZE * 128, fc,
                     mode="accum", sampler="sobol")
    pt = filmlib.develop(fc, film, mode="accum")
    ratio = float(lt.mean() / pt.mean())
    assert abs(ratio - 1.0) < 0.05, (float(lt.mean()), float(pt.mean()))
    rows = (lt.mean((1, 2)) - pt.mean((1, 2))).abs().max() / pt.mean()
    assert float(rows) < 0.6
    assert lt.shape == (SIZE, SIZE, 3) and bool(torch.isfinite(lt).all())


def test_multichannel_equals_its_channels_one_at_a_time(box):
    sc, fc = box[2:]
    chans = ("radiance", "shnormal", "albedo", "distance")
    out = misc.render_multichannel(sc, fc, torch.Generator().manual_seed(5),
                                   channels=chans, spp=2, radiance_spp=2,
                                   max_depth=3)
    g = torch.Generator().manual_seed(5)
    film = render_pt(sc, PathConfig(max_depth=3, rr_depth=100), g,
                     SIZE * SIZE * 2, fc, mode="accum")
    planes = [filmlib.develop(fc, film, mode="accum")]
    planes += [misc.render_field(sc, fc, g, ch, 2) for ch in chans[1:]]
    assert out.shape == (SIZE, SIZE, 12)
    assert torch.equal(out, torch.cat(planes, -1))
