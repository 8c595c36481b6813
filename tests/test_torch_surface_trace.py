"""The path wavefront (integrators/path.py:trace_paths_wavefront) against
the reference's XLA trace_paths on tests/data/surfaces.xml.

The surfaces scene holds every surface BSDF kind and wrapper the port adds
and a point and a spot light beside the area light.  Both packages load
the file (their loaders agree leaf for leaf: test_torch_surface_scene.py),
its analytic phong sphere is made emissive in both (it carries the area
light's first emitter row: its hits emit and weigh against NEE by that
row; the loaders tessellate an emissive sphere), and both trace the same
1,024 numpy-seeded u at depth 3 with NEE and Russian roulette from depth
2; the reference is jitted once, the scene an argument.  Tolerance: a lane
agrees when every channel is within 1e-3 relative (floor 1e-3) of the
reference; at most R/500 lanes may not (ROADMAP.md queue 3's expected
divergences: last-bit ties of t, texel flips), and the channel means
agree to 1e-3.
"""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import torch

from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.integrators.path import trace_paths as jax_trace
from drmlt_mitsuba_tpu.scene.xml import load_scene_xml as jax_load_xml
from drmlt_mitsuba_tpu_torch.integrators import path as P
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT
from drmlt_mitsuba_tpu_torch.scene.types import EMITTER_AREA
from drmlt_mitsuba_tpu_torch.scene.xml import load_scene_xml
from test_torch_surface_scene import SURFACES

torch.set_num_threads(1)

R = 1024
LANE_RTOL, FLOOR, MEAN_RTOL = 1e-3, 1e-3, 1e-3


def compare(ref, got, n=R):
    """(lanes differing, channel-mean relative error) of (n, 3) values."""
    err = (np.abs(ref - got) / np.maximum(np.abs(ref), FLOOR)).max(1)
    m_rel = float((np.abs(ref.mean(0) - got.mean(0))
                   / np.abs(ref.mean(0))).max())
    return int((err > LANE_RTOL).sum()), m_rel


def test_wavefront_matches_reference_on_surfaces():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sc, _ = load_scene_xml(SURFACES, {"res": "32"})
        jsc, _ = jax_load_xml(SURFACES, {"res": "32"})
    assert sc.spheres.emitter_id.tolist() == [-1]
    assert int(sc.emitters.kind[0]) == EMITTER_AREA
    plain = sc
    sc = dataclasses.replace(sc, spheres=dataclasses.replace(
        sc.spheres, emitter_id=torch.zeros_like(sc.spheres.emitter_id)))
    jsc = jsc.replace(spheres=jsc.spheres.replace(
        emitter_id=jnp.zeros_like(jsc.spheres.emitter_id)))
    cfg = PathConfig(max_depth=3, rr_depth=2)
    jcfg = JPathConfig(max_depth=3, rr_depth=2)
    u = np.random.default_rng(3).random((R, cfg.n_dims), dtype=np.float32)
    # the scene as an argument, not a constant: ~2 s less of XLA compile
    ref = np.asarray(jax.jit(lambda s, u: jax_trace(s, jcfg, u).value)(
        jsc, u))
    assert not MT.mega_eligible(sc, cfg)
    sp = P.trace_paths_wavefront(sc, cfg, torch.from_numpy(u))
    got = sp.value[:, 0].numpy()
    assert np.isfinite(got).all() and (got.sum(1) > 0).mean() > 0.5
    bad, m_rel = compare(ref[:, 0], got)
    assert bad <= R // 500 and m_rel <= MEAN_RTOL, (bad, m_rel)
    np.testing.assert_array_equal(sp.pos.numpy(), u[:, None, :2])
    # make_path_trace takes the wavefront here, with the same result
    got2 = P.make_path_trace(sc, cfg, "cpu")(torch.from_numpy(u))
    assert torch.equal(got2.value, sp.value)
    # the sphere's emission reaches camera paths
    dark = P.trace_paths_wavefront(plain, cfg, torch.from_numpy(u)).value
    assert (got.sum(1) > 1.01 * dark[:, 0].numpy().sum(1)).sum() >= 10

