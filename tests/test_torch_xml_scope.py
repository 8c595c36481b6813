"""The port's scene-XML loader on the kernels' full scene scope against
the JAX package's loader, leaf for leaf: tests/data/cornell.xml (its
rough-conductor analytic sphere), and a scene with a thin-lens sensor,
constant and EXR environment emitters, checkerboard and grid textures,
conductor / null bsdfs and analytic and emissive (tessellated) spheres.
What stays unported raises naming itself: bitmap textures and non-EXR
environment maps (the reference decodes them with PIL).  Last, the CLI
renders tests/data/cornell.xml in both techniques on the CPU (tiny).
"""
import os
import warnings

import jax.numpy as jnp  # noqa: F401  (both frameworks in one process)
import numpy as np
import pytest
import torch
from test_torch_xml import _assert_scenes_equal

from drmlt_mitsuba_tpu.scene.xml import load_scene_xml as jax_load_xml
from drmlt_mitsuba_tpu_torch.scene.xml import load_scene_xml
from drmlt_mitsuba_tpu_torch.utils import cli
from drmlt_mitsuba_tpu_torch.utils.exr import read_exr, write_exr

torch.set_num_threads(1)

CORNELL = os.path.join(os.path.dirname(__file__), "data", "cornell.xml")

FEATURES = """<scene version="0.6.0">
  <default name="ap" value="25"/>
  <sensor type="thinlens">
    <float name="apertureRadius" value="$ap"/>
    <float name="focusDistance" value="800"/>
    <float name="fov" value="45"/>
    <transform name="toWorld">
      <lookat origin="278, 273, -800" target="278, 273, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm"><integer name="width" value="48"/>
      <integer name="height" value="32"/><rfilter type="box"/></film>
  </sensor>
  <bsdf type="diffuse" id="chk">
    <texture name="reflectance" type="checkerboard">
      <rgb name="color0" value="0.8, 0.1, 0.1"/>
      <float name="uscale" value="4"/><float name="vscale" value="2"/>
    </texture>
  </bsdf>
  <bsdf type="conductor" id="au"><string name="material" value="Au"/></bsdf>
  <bsdf type="roughconductor" id="cr">
    <string name="material" value="Cr"/><float name="alpha" value="0.3"/>
  </bsdf>
  <bsdf type="twosided" id="nul"><bsdf type="null"/></bsdf>
  <shape type="rectangle"><ref id="chk"/>
    <transform name="toWorld"><scale value="278"/>
      <translate x="278" y="278" z="556"/></transform>
  </shape>
  <shape type="rectangle">
    <bsdf type="diffuse"><texture type="gridtexture">
      <float name="lineWidth" value="0.05"/></texture></bsdf>
  </shape>
  <shape type="sphere"><point name="center" x="100" y="90" z="300"/>
    <float name="radius" value="90"/><ref id="au"/></shape>
  <shape type="sphere"><transform name="toWorld"><scale value="60"/>
    <translate x="400" y="60" z="200"/></transform><ref id="cr"/></shape>
  <shape type="sphere"><ref id="nul"/></shape>
  <shape type="sphere"><point name="center" x="278" y="500" z="278"/>
    <float name="radius" value="20"/>
    <emitter type="area"><rgb name="radiance" value="40, 35, 30"/></emitter>
  </shape>
  <emitter type="constant"><rgb name="radiance" value="0.4, 0.5, 0.7"/>
  </emitter>
  <emitter type="envmap"><string name="filename" value="sky.exr"/>
    <float name="scale" value="2"/></emitter>
</scene>
"""


def _load_both(path, defaults):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return load_scene_xml(path, defaults), jax_load_xml(path, defaults)


def _equal(got, want):
    (scene, settings), (jscene, jsettings) = got, want
    _assert_scenes_equal(scene, jscene)
    if jscene.textures is None:
        assert scene.textures is None
    else:
        np.testing.assert_array_equal(scene.textures.data.numpy(),
                                      np.asarray(jscene.textures.data))
    for k in ("integrator", "width", "height", "filter_name", "spp"):
        assert getattr(settings, k) == getattr(jsettings, k), k


@pytest.mark.parametrize("defaults", [
    {"integrator": "drmlt"},
    {"integrator": "drmlt", "technique": "mmlt", "type": "orbital",
     "spp": "4096"}], ids=["file", "mmlt-4096"])
def test_cornell_xml_equals_reference(defaults):
    got = load_scene_xml(CORNELL, defaults)
    _equal(got, jax_load_xml(CORNELL, defaults))
    scene = got[0]
    assert scene.spheres.valid.tolist() == [True]
    assert scene.materials.kind.tolist()[3] == 3          # roughconductor
    assert got[1].spp == int(defaults.get("spp", 16))


def test_feature_xml_equals_reference(tmp_path):
    img = np.random.default_rng(4).random((8, 16, 3)).astype(np.float32)
    write_exr(str(tmp_path / "sky.exr"), img, half=False, compression="zip")
    path = tmp_path / "features.xml"
    path.write_text(FEATURES)
    for defaults in ({}, {"ap": "0"}):
        got, want = _load_both(str(path), defaults)
        _equal(got, want)
    scene = load_scene_xml(str(path))[0]
    assert float(scene.camera.aperture_radius) == 25.0
    assert scene.spheres.valid.shape == (3,)              # one tessellated
    assert scene.textures.data.shape == (2, 256, 256, 3)
    assert scene.emitters.env_image is not None
    np.testing.assert_allclose(scene.emitters.env_image.numpy(), 2 * img,
                               rtol=1e-6)
    assert scene.emitters.kind.tolist()[-1] == 4
    assert sorted(set(scene.materials.kind.tolist())) == [0, 1, 3, 9]


def test_missing_envmap_and_refusals(tmp_path):
    """A missing envmap warns and becomes a unit constant environment in
    both loaders; bitmap textures and PNG maps raise naming themselves."""
    path = tmp_path / "missing.xml"
    path.write_text('<scene version="0.6.0"><shape type="rectangle"/>'
                    '<emitter type="envmap"><string name="filename" '
                    'value="nope.exr"/><float name="scale" value="3"/>'
                    '</emitter></scene>')
    with pytest.warns(UserWarning, match="not found"):
        got = load_scene_xml(str(path))
    _equal(got, _load_both(str(path), {})[1])
    assert got[0].emitters.env_radiance.tolist() == [3.0, 3.0, 3.0]
    for body, name in (
            ('<shape type="rectangle"><bsdf type="diffuse"><texture '
             'type="bitmap"><string name="filename" value="a.png"/>'
             '</texture></bsdf></shape>', "bitmap"),
            ('<shape type="rectangle"/><emitter type="envmap"><string '
             'name="filename" value="sky.png"/></emitter>', "sky.png")):
        (tmp_path / "sky.png").write_bytes(b"")
        bad = tmp_path / "bad.xml"
        bad.write_text(f'<scene version="0.6.0">{body}</scene>')
        with pytest.raises(NotImplementedError, match=name):
            load_scene_xml(str(bad))
    # a scene of spheres only keeps one degenerate triangle, as the
    # reference's loader does
    only = tmp_path / "only.xml"
    only.write_text('<scene version="0.6.0"><shape type="sphere"/>'
                    '</scene>')
    _equal(load_scene_xml(str(only)), jax_load_xml(str(only)))


def test_cli_renders_cornell_xml_on_the_cpu(tmp_path, capsys):
    """Both techniques through the CLI, tiny (the twins on the CPU)."""
    for tech in ("path", "mmlt"):
        out = tmp_path / f"{tech}.exr"
        rc = cli.main([CORNELL, "-D", "integrator=drmlt", "-D",
                       f"technique={tech}", "-D", "type=orbital",
                       "-D", "luminanceSamples=1000",
                       "--chains", "256", "--spp", "1", "-s", "2",
                       "--device", "cpu", "-o", str(out)])
        assert rc == 0
        img = read_exr(str(out))
        assert img.shape == (64, 64, 3)
        assert np.all(np.isfinite(img)) and img.mean() > 0
    assert "b = " in capsys.readouterr().out
