"""Asset-scale scenes through the port: the path and MMLT twins walking the
BVH against the JAX package's XLA traces (which sweep every triangle),
and a tiny CLI render of tests/data/large/cornell_large.xml on the CPU.

Tolerances are the small-scene tests' own (test_torch_path_trace.py and
test_torch_mmlt.py): the path twin per lane to rtol 1e-4 (1e-3 floor) on
at least 99% of lanes and channel means to 5e-3; the MMLT twin at most
R/250 lanes above 1e-3 relative, means to 5e-3.  A lane may diverge
where a near tie at a shared edge of the tessellated walls goes to the
neighbouring triangle under XLA's rounding (test_torch_bvh.py).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from drmlt_mitsuba_tpu.integrators.bidir import BDPTConfig as JBDPTConfig
from drmlt_mitsuba_tpu.integrators.layout import PathConfig as JPathConfig
from drmlt_mitsuba_tpu.integrators.mmlt import make_mmlt_trace as jax_mmlt
from drmlt_mitsuba_tpu.integrators.path import trace_paths as jax_trace
from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.mmlt import (
    make_mmlt_trace, mmlt_n_dims,
)
from drmlt_mitsuba_tpu_torch.integrators.path import trace_paths
from drmlt_mitsuba_tpu_torch.ops import megatrace as MT
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box
from drmlt_mitsuba_tpu_torch.scene.types import prepare_scene
from drmlt_mitsuba_tpu_torch.utils import cli
from drmlt_mitsuba_tpu.utils.exr import read_exr
from test_torch_xml import DATA, LARGE, large_scenes

torch.set_num_threads(1)


def test_path_twin_walks_bvh_and_matches_trace_paths():
    """256 lanes at depth 3 on the XML scene (19,586 triangles)."""
    (scene, _), (jscene, _) = large_scenes()
    scene = prepare_scene(scene)
    cfg = PathConfig(max_depth=3, rr_depth=100)
    tables = MT.make_tables(scene, cfg, "cpu")
    assert tables.nodes is not None          # the twin walks the BVH
    u = np.random.default_rng(11).random((256, cfg.n_dims), dtype=np.float32)
    jcfg = JPathConfig(max_depth=3, rr_depth=100)
    ref = jax.jit(lambda x: jax_trace(jscene, jcfg, x))(jnp.asarray(u))
    got = trace_paths(scene, cfg, torch.from_numpy(u))
    va = np.asarray(ref.value[:, 0, :])
    vb = got.value[:, 0, :].numpy()
    rel = np.abs(va - vb) / (np.abs(va) + 1e-3)
    assert (rel > 1e-4).any(-1).mean() <= 0.01
    np.testing.assert_allclose(vb.mean(0), va.mean(0), rtol=5e-3)
    assert (va.sum(-1) > 0).mean() > 0.3
    np.testing.assert_array_equal(got.pos.numpy(), np.asarray(ref.pos))


def test_mmlt_twin_walks_bvh_and_matches_trace_mmlt():
    """cornell_box(32, 32, tessellate=12): 4,898 triangles, over
    BVH_MIN_TRIS; depth 3 with the light image."""
    R = 512
    jcfg = JBDPTConfig(max_depth=3, light_image=True)
    cfg = BDPTConfig(max_depth=3, light_image=True)
    scene = cornell_box(32, 32, tessellate=12)
    assert scene.tris.v0.shape[0] == 4898
    u = np.random.default_rng(12).random((R, mmlt_n_dims(cfg)),
                                         dtype=np.float32)
    ref = jax.jit(jax_mmlt(jax_cornell(32, 32, tessellate=12), jcfg,
                           force_xla=True))(jnp.asarray(u))
    got = make_mmlt_trace(scene, cfg, "cpu")(torch.from_numpy(u))
    va, vb = np.asarray(ref.value[:, 0]), got.value[:, 0].numpy()
    rel = np.abs(va - vb) / (np.abs(va) + 1e-4)
    assert (rel > 1e-3).any(-1).sum() <= R // 250
    np.testing.assert_allclose(vb.mean(0), va.mean(0), rtol=5e-3, atol=1e-5)
    assert (np.abs(va) > 1e-7).any(-1).sum() >= 5


def test_cli_renders_the_xml_scene(tmp_path, capsys):
    """The CLI on the CPU twins renders cornell_large.xml (its default
    technique, the grouped MMLT) and writes an EXR.  Tiny: the file's
    integrator depth cut to 2, 1,000 luminance samples and a 32x32 film,
    in a copy that names the meshes by absolute path."""
    text = open(LARGE).read()
    for a, b in (('name="maxDepth" value="6"/>', 'name="maxDepth" value="2"/>'
                  '<integer name="luminanceSamples" value="1000"/>'),
                 ('name="width" value="256"', 'name="width" value="32"'),
                 ('name="height" value="256"', 'name="height" value="32"')):
        assert a in text
        text = text.replace(a, b)
    for mesh in ("white", "red", "green", "light"):
        text = text.replace(f'value="{mesh}.obj"',
                            f'value="{os.path.join(DATA, mesh)}.obj"')
    xml = tmp_path / "cornell_large_tiny.xml"
    xml.write_text(text)
    out = tmp_path / "large.exr"
    rc = cli.main([str(xml), "-D", "integrator=drmlt", "-D", "spp=1",
                   "--chains", "1024", "--device", "cpu", "-o", str(out)])
    assert rc == 0
    img = read_exr(str(out))
    assert img.shape == (32, 32, 3)
    assert np.all(np.isfinite(img)) and img.mean() > 0
    assert "19586 triangles, BVH of" in capsys.readouterr().out
