"""The port's bidirectional layer against itself, with no JAX compile:
the wavefront MMLT trace (integrators/bidir.py:trace_mmlt_wavefront) vs
the MMLT kernel's plain twin (ops/megammlt.py) lane for lane, the PSS
layout and scope of BDPTConfig vs the reference's, and light-image splats
off the film.  Tolerances as in test_torch_bidir.py (at most R/500 lanes
above 1e-3 relative, the other lanes' means to 5e-3, film positions of lit
lanes to 1e-5).
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_bidir import _close

from drmlt_mitsuba_tpu.integrators import bidir as JB
from drmlt_mitsuba_tpu_torch.integrators import bidir as B
from drmlt_mitsuba_tpu_torch.integrators.mmlt import (
    make_mmlt_trace, mmlt_n_dims,
)
from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.ops import megammlt as MM
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene import builders
from drmlt_mitsuba_tpu_torch.scene import types as st

torch.set_num_threads(1)

R = 1024
DEPTH = 3


def sky_box(**kw):
    """The 32x32 Cornell box lit also by a 16x32 lat-long sky, whose
    environment row is picked for some light subpaths."""
    sc = builders.cornell_box(32, 32, **kw)
    em = st.build_emitters(sc.tris, sc.emitters.radiance.numpy(),
                           env_image=builders.sky_image(16, 32))
    st.set_emitter_rows(sc.tris, em)
    return dataclasses.replace(sc, emitters=em)


def test_wavefront_matches_the_mmlt_kernel_twin():
    """Port against port, no JAX: on a pinhole box the wavefront MMLT trace
    equals the MMLT kernel's twin (make_mmlt_trace's kernel route) over
    the pooled depths 1-5, lane for lane (the kernel's value carries the
    depth pmf's factor 5): on the diffuse box, and on the mirror box under
    a sky, where the eye walks' escapes read the environment at weight 1
    and the light subpaths that pick its row are invalid."""
    for scene in (builders.cornell_box(32, 32),
                  sky_box(tall_box_material="mirror")):
        cfg = B.BDPTConfig(max_depth=5)
        u = torch.from_numpy(np.random.default_rng(3).random(
            (R, mmlt_n_dims(cfg)), dtype=np.float32))
        n0 = build.LAUNCHES["mmlt_trace"]
        kern = make_mmlt_trace(scene, cfg, "cpu")(u)
        assert build.LAUNCHES["mmlt_trace"] == n0    # the twin on the CPU
        depth = 1 + torch.clamp((u[:, 0] * 5).long(), max=4)
        wave = B.trace_mmlt_wavefront(scene, cfg, u[:, 1:], depth)
        _close(kern.value[:, 0].numpy(), 5.0 * wave.value[:, 0].numpy())
        lit = kern.value[:, 0].abs().sum(-1) > 1e-7
        np.testing.assert_allclose(wave.pos[lit].numpy(),
                                   kern.pos[lit].numpy(), atol=1e-5)
    # under the sky, the lanes whose light walk picked its row start none
    L = B.light_subpath(scene, cfg, u[:, 1 + cfg.eye_dims:])
    assert (~L.valid[:, 0]).any() and L.valid[:, 0].any()


def test_config_layout_and_scope():
    """The PSS layout of the reference (the thin lens's 2 eye dims
    included), its splat count, and what stays outside the scope: media,
    point emitters, and the MMLT kernel with a thin lens."""
    for k in range(1, 7):
        for li in (True, False):
            for tl in (True, False):
                a = B.BDPTConfig(max_depth=k, light_image=li, thinlens=tl)
                b = JB.BDPTConfig(max_depth=k, light_image=li, thinlens=tl)
                assert (a.eye_dims, a.light_dims, a.n_dims, a.n_eye,
                        a.n_light, a.n_splats) == (
                    b.eye_dims, b.light_dims, b.n_dims, b.n_eye, b.n_light,
                    b.n_splats)
    with pytest.raises(NotImplementedError, match="media"):
        B.BDPTConfig(medium=True)
    scene = builders.cornell_box(8, 8)
    point = dataclasses.replace(scene, emitters=dataclasses.replace(
        scene.emitters, kind=torch.ones_like(scene.emitters.kind)))
    with pytest.raises(NotImplementedError, match="point"):
        B.make_bidir_tables(point, B.BDPTConfig(max_depth=2), "cpu")
    lens = dataclasses.replace(scene, camera=dataclasses.replace(
        scene.camera, aperture_radius=torch.tensor(25.0)))
    with pytest.raises(NotImplementedError, match="thin-lens"):
        MM.make_mmlt_tables(lens, B.BDPTConfig(max_depth=2, thinlens=True),
                            "cpu")
    with pytest.raises(NotImplementedError, match="lens aperture"):
        B.make_bidir_tables(lens, B.BDPTConfig(max_depth=2), "cpu")


def test_light_image_splats_off_the_film_are_dropped():
    """A light-image splat whose connection misses the film carries zero
    value at a position outside [0, 1) (the veach door's camera stands
    inside the room, so light vertices behind it give such splats):
    film.splat drops it, and any other splat off the film, never clamping
    it onto an edge pixel."""
    cfg = B.BDPTConfig(max_depth=DEPTH)
    u = torch.from_numpy(np.random.default_rng(4).random(
        (512, cfg.n_dims), dtype=np.float32))
    sp = B.trace_bdpt(builders.veach_door(16, 16), cfg, u)
    pos, val = sp.pos[:, 1:].reshape(-1, 2), sp.value[:, 1:].reshape(-1, 3)
    off = ((pos < 0) | (pos >= 1)).any(-1)
    assert off.sum() > 50 and float(val[off].abs().sum()) == 0.0
    assert bool(torch.isfinite(pos).all())
    fc = filmlib.make_film_config(16, 16, "box")
    scale = torch.tensor([16.0, 16.0])
    film = filmlib.splat(fc, filmlib.new_film(fc, "cpu"), pos[off] * scale,
                         torch.ones_like(val[off]), mode="splat")
    assert float(film.abs().sum()) == 0.0
    # off the film on each side, and one splat on it at the right edge
    edge = torch.tensor([[-0.25, 0.5], [1.0, 0.5], [0.5, -1e-3],
                         [0.5, 1.0], [0.999, 0.5]])
    film = filmlib.splat(fc, filmlib.new_film(fc, "cpu"), edge * scale,
                         torch.ones((5, 3)), mode="splat")
    assert float(film.sum()) == 4.0 and float(film[8, 15, 0]) == 1.0
