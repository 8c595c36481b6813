"""Every sensor (render/sensor.py:sample_ray, the path wavefront's camera)
against the reference's: orthographic, telecentric, spherical, the
radiance, fluence and irradiance meters and perspective_rdist's radial
distortion, each through both XML loaders (leaf for leaf) and both
sample_ray's on the same uniforms (rtol 1e-5); the wavefront renders it.
"""
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.render.sensor import sample_ray as jax_sample_ray
from drmlt_mitsuba_tpu_torch.integrators import path as P
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from test_torch_xml_scope import _equal, _load_both

torch.set_num_threads(1)


SENSOR = """<scene version="0.6.0">
  <sensor type="{kind}">
    <float name="fov" value="50"/>
    <float name="apertureRadius" value="0.3"/>
    <float name="focusDistance" value="4"/>
    <string name="kc" value="0.2, -0.05"/>
    <transform name="toWorld">
      <scale value="{scale}"/>
      <lookat origin="0.5, 1, -5" target="0, 0.5, 0" up="0, 1, 0"/>
    </transform>
    <film type="hdrfilm"><integer name="width" value="8"/>
      <integer name="height" value="6"/></film>
  </sensor>
  <shape type="cube"/>
  <emitter type="constant"/>
</scene>"""


@pytest.mark.parametrize("kind", ["perspective_rdist", "orthographic",
                                  "telecentric", "spherical",
                                  "radiancemeter", "fluencemeter",
                                  "irradiancemeter"])
def test_sensors_equal_reference(kind, tmp_path):
    """Each sensor through both loaders (leaf for leaf) and the rays of
    both sample_ray's on the same uniforms; the wavefront renders it."""
    path = tmp_path / "sensor.xml"
    path.write_text(SENSOR.format(kind=kind, scale=1 if kind in (
        "perspective_rdist", "spherical") else 3))
    got, want = _load_both(str(path), {})
    _equal(got, want)
    cam, jcam = got[0].camera, want[0].camera
    assert cam.kind == jcam.kind and cam.rdist == jcam.rdist
    u = np.random.default_rng(2).random((256, 4), dtype=np.float32)
    lens = kind == "telecentric"
    ro, rd = jax_sample_ray(jcam, u[:, :2], u[:, 2:] if lens else None)
    o, d = P.sample_ray(cam, torch.from_numpy(u[:, :2]),
                      torch.from_numpy(u[:, 2:]) if lens else None)
    np.testing.assert_allclose(o.numpy(), np.asarray(ro), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(d.numpy(), np.asarray(rd), rtol=1e-5,
                               atol=1e-5)
    cfg = PathConfig(max_depth=2, thinlens=kind == "perspective_rdist")
    img = P.trace_paths_wavefront(got[0], cfg,
                                  torch.rand((64, cfg.n_dims)))
    assert torch.isfinite(img.value).all() and float(img.value.sum()) > 0
