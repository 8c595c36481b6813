"""The port's scene loaders against the JAX package's: OBJ, scene XML and
the tessellated Cornell builder.

Every array must be equal to the reference's (the same parse, the same
float64 transform products rounded once, the same welding and emitter
rows), except where stated: the XML scene equals cornell_box(tessellate=24)
only to the 6 decimals of its OBJ text (rtol 1e-4; the reference's own
tests/test_cli.py holds it to the same order).
"""
import dataclasses
import functools
import os

import jax.numpy as jnp  # noqa: F401  (both frameworks in one process)
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.scene.builders import cornell_box as jax_cornell
from drmlt_mitsuba_tpu.scene.mesh_io import load_obj as jax_load_obj
from drmlt_mitsuba_tpu.scene.xml import load_scene_xml as jax_load_xml
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box
from drmlt_mitsuba_tpu_torch.scene.mesh_io import load_mesh_ex, load_obj
from drmlt_mitsuba_tpu_torch.scene.xml import load_scene_xml
from test_torch_scene import jax_leaves, port_leaves

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "large")
LARGE = os.path.join(DATA, "cornell_large.xml")


def _assert_scenes_equal(got, want):
    """Every leaf of the port's Scene equals the reference's (dtype and
    value; the reference's other leaves hold features not ported)."""
    g, w = port_leaves(got), jax_leaves(want)
    assert g.keys() <= w.keys()
    for k, v in g.items():
        if isinstance(v, torch.Tensor):
            assert v.numpy().dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(v.numpy(), np.asarray(w[k]),
                                          err_msg=k)
        else:
            assert v == w[k], k


@functools.lru_cache(maxsize=None)
def large_scenes():
    """cornell_large.xml through both loaders, ((scene, settings),
    (jscene, jsettings)), loaded once a process: test_torch_bvh.py and
    test_torch_large_scene.py compare against the same two loads."""
    return load_scene_xml(LARGE), jax_load_xml(LARGE)


@pytest.fixture(scope="module")
def large():
    return large_scenes()


def test_load_obj_equals_reference():
    for name in ("white", "red", "green", "light"):
        path = os.path.join(DATA, f"{name}.obj")
        got, want = load_obj(path), jax_load_obj(path)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unsupported mesh format"):
        load_mesh_ex("mesh.stl")


def test_large_scene_equals_reference(large):
    (scene, settings), (jscene, jsettings) = large
    _assert_scenes_equal(scene, jscene)
    assert scene.tris.v0.shape[0] == 19586
    assert dataclasses.asdict(settings) == {
        k: v for k, v in dataclasses.asdict(jsettings).items()
        if k in ("integrator", "width", "height", "filter_name", "spp",
                 "sampler")}
    # <integrator type="$integrator"> is left to -D: unsubstituted in both
    assert settings.integrator["type"] == "$integrator"
    sub, jsub = (load_scene_xml(LARGE, {"integrator": "drmlt", "spp": "4"}),
                 jax_load_xml(LARGE, {"integrator": "drmlt", "spp": "4"}))
    assert sub[1].integrator == jsub[1].integrator
    assert sub[1].integrator["type"] == "drmlt"
    assert sub[1].spp == jsub[1].spp == 4


SYNTH = """<?xml version="1.0"?>
<scene version="0.6.0">
  <default name="rough" value="0.3"/>
  <default name="w" value="64"/>
  <integrator type="drmlt">
    <integer name="maxDepth" value="4"/>
    <string name="technique" value="path"/>
  </integrator>
  <sensor type="perspective">
    <float name="fov" value="45"/>
    <string name="fovAxis" value="y"/>
    <transform name="toWorld">
      <lookat origin="0.5, 1.5, -4" target="0, 0.8, 0" up="0, 1, 0"/>
    </transform>
    <sampler type="independent"><integer name="sampleCount" value="8"/></sampler>
    <film type="hdrfilm">
      <integer name="width" value="$w"/>
      <integer name="height" value="48"/>
      <rfilter type="tent"/>
    </film>
  </sensor>
  <bsdf type="twosided" id="wall">
    <bsdf type="diffuse"><rgb name="reflectance" value="0.7, 0.6, 0.5"/></bsdf>
  </bsdf>
  <bsdf type="roughdiffuse" id="rough">
    <srgb name="reflectance" value="0.4"/>
    <float name="alpha" value="$rough"/>
  </bsdf>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale x="3" y="3" z="1"/>
      <rotate x="1" angle="-90"/>
    </transform>
    <ref id="wall"/>
  </shape>
  <shape type="cube">
    <transform name="toWorld">
      <scale value="0.4"/>
      <rotate y="1" angle="27.5"/>
      <translate x="0.2" y="0.4" z="0.3"/>
    </transform>
    <ref id="rough"/>
  </shape>
  <shape type="cube">
    <transform name="toWorld">
      <matrix value="0.3 0 0 -0.6  0 0.5 0.1 0.5  0 0 0.3 0.2  0 0 0 1"/>
    </transform>
    <bsdf type="dielectric">
      <string name="intIOR" value="water"/>
      <float name="extIOR" value="1.0"/>
    </bsdf>
  </shape>
  <shape type="rectangle">
    <transform name="toWorld">
      <scale value="0.25"/>
      <rotate x="1" angle="90"/>
      <translate y="2"/>
    </transform>
    <emitter type="area"><rgb name="radiance" value="12, 11, 9"/></emitter>
  </shape>
</scene>
"""


def test_synthetic_xml_equals_reference(tmp_path):
    path = tmp_path / "synth.xml"
    path.write_text(SYNTH)
    for defaults in ({}, {"rough": "0.55", "w": "80"}):
        (scene, settings) = load_scene_xml(str(path), defaults)
        (jscene, jsettings) = jax_load_xml(str(path), defaults)
        _assert_scenes_equal(scene, jscene)
        for k in ("integrator", "width", "height", "filter_name", "spp"):
            assert getattr(settings, k) == getattr(jsettings, k), k
    assert settings.width == 80 and settings.filter_name == "tent"
    assert float(scene.materials.roughness[1]) == pytest.approx(0.55)


@pytest.mark.parametrize("element, name", [
    ('<bsdf type="irawan" id="m"/>', "irawan"),
    ('<shape type="heightfield"><float name="scale" value="1"/></shape>',
     "heightfield"),
    ('<medium type="homogeneous"/>', "medium"),
    ('<shape type="rectangle"><bsdf type="diffuse"><texture '
     'type="bitmap"><string name="filename" value="a.png"/></texture>'
     '</bsdf></shape>', "bitmap"),
])
def test_unported_element_raises_naming_it(tmp_path, element, name):
    path = tmp_path / "bad.xml"
    path.write_text(f'<scene version="0.6.0">{element}</scene>')
    with pytest.raises(NotImplementedError, match=name):
        load_scene_xml(str(path))


def test_tessellated_cornell_equals_reference_and_the_xml(large):
    scene = cornell_box(256, 256, tessellate=24)
    jscene = jax_cornell(256, 256, tessellate=24)
    _assert_scenes_equal(scene, jscene)
    assert scene.tris.v0.shape[0] == 19586
    xml_scene = large[0][0]

    # the same triangles in another order (the XML groups them by mesh),
    # each with the same albedo (the XML's tall box is the white material,
    # the builder's fifth material has the same albedo) and emission
    def by_centroid(sc):
        c = (sc.tris.v0 + (sc.tris.e1 + sc.tris.e2) / 3).double().numpy()
        return np.lexsort(np.round(c, 2).T[::-1])

    oa, ob = by_centroid(scene), by_centroid(xml_scene)
    for f in ("v0", "e1", "e2", "n0", "n1", "n2"):
        np.testing.assert_allclose(getattr(xml_scene.tris, f).numpy()[ob],
                                   getattr(scene.tris, f).numpy()[oa],
                                   rtol=1e-4, atol=1e-5, err_msg=f)
    alb = scene.materials.albedo[scene.tris.mat_id.long()].numpy()
    xalb = xml_scene.materials.albedo[xml_scene.tris.mat_id.long()].numpy()
    np.testing.assert_array_equal(xalb[ob], alb[oa])
    np.testing.assert_array_equal(xml_scene.tris.emitter_id.numpy()[ob] >= 0,
                                  scene.tris.emitter_id.numpy()[oa] >= 0)
    np.testing.assert_allclose(scene.camera.to_world.numpy(),
                               xml_scene.camera.to_world.numpy(), rtol=1e-6)
