"""The surface scene scope through both loaders: tests/data/surfaces.xml
and tests/data/daylight.xml, PLY (ASCII and binary, with vertex colours)
and Mitsuba `.serialized` meshes written here, and the XML wrappers,
textures and shapes the port adds (mask, blendbsdf by reference,
normalmap, roughcoating, wireframe, scale and vertexcolors textures,
shapegroup / instance, disk, cylinder, collimated and sun emitters), each
loaded by the port's loader and the reference's and compared leaf for
leaf; and what stays refused, each refusal naming its feature.
"""
import dataclasses
import os
import struct
import warnings
import zlib

import jax.numpy as jnp  # noqa: F401  (both frameworks in one process)
import numpy as np
import pytest
import torch

from drmlt_mitsuba_tpu.scene import mesh_io as jmesh
from drmlt_mitsuba_tpu.scene import types as jst
from drmlt_mitsuba_tpu_torch.integrators import bidir as BD
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.path import (
    make_path_trace, make_path_trace_diff,
)
from drmlt_mitsuba_tpu_torch.scene import mesh_io
from drmlt_mitsuba_tpu_torch.scene import types as st
from drmlt_mitsuba_tpu_torch.scene.xml import load_scene_xml
from test_torch_xml_scope import _equal, _load_both

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SURFACES = os.path.join(DATA, "surfaces.xml")
DAYLIGHT = os.path.join(DATA, "daylight.xml")


def _equal_vcolors(got, want):
    if want.vcolors is None:
        assert got.vcolors is None
    else:
        np.testing.assert_array_equal(got.vcolors.numpy(),
                                      np.asarray(want.vcolors))


@pytest.mark.parametrize("path", [SURFACES, DAYLIGHT],
                         ids=["surfaces", "daylight"])
def test_scene_files_equal_reference(path):
    got, want = _load_both(path, {})
    _equal(got, want)
    sc = got[0]
    if path == SURFACES:
        assert set(sc.materials.kind.tolist()) == {0, 1, 3, 4, 5, 6, 7, 10,
                                                   11, 13, 14}
        assert sc.materials.has_mask and sc.materials.has_mixture
        assert sc.materials.has_coating and sc.materials.has_normalmap
        assert set(sc.emitters.kind.tolist()) == {0, 1, 3}
        assert got[1].width == 256
    else:
        assert set(sc.emitters.kind.tolist()) == {2, 4}
        assert sc.emitters.env_image.shape == (64, 128, 3)


def _mesh():
    v = np.asarray([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5,
                                                                 1]],
                   np.float32) * 100
    n = np.tile(np.asarray([[0, 0, 1]], np.float32), (5, 1))
    uv = v[:, :2] / 100
    col = np.linspace(0, 1, 15, dtype=np.float32).reshape(5, 3)
    faces = [[0, 1, 2, 3], [0, 1, 4], [1, 2, 4]]
    return v, n, uv, col, faces


def write_ply(path, binary):
    v, n, uv, col, faces = _mesh()
    head = ["ply", "format " + ("binary_little_endian 1.0" if binary
                                else "ascii 1.0"),
            f"element vertex {len(v)}"]
    head += [f"property float {c}" for c in ("x", "y", "z", "nx", "ny", "nz",
                                             "u", "v")]
    head += [f"property uchar {c}" for c in ("red", "green", "blue")]
    head += [f"element face {len(faces)}",
             "property list uchar int vertex_indices", "end_header"]
    c8 = (col * 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        for i in range(len(v)):
            if binary:
                f.write(struct.pack("<8f3B", *v[i], *n[i], *uv[i], *c8[i]))
            else:
                f.write((" ".join(f"{x:g}" for x in (*v[i], *n[i], *uv[i]))
                         + " " + " ".join(str(x) for x in c8[i]) + "\n")
                        .encode())
        for fc in faces:
            if binary:
                f.write(struct.pack(f"<B{len(fc)}i", len(fc), *fc))
            else:
                f.write((" ".join(str(x) for x in [len(fc), *fc]) + "\n")
                        .encode())


def write_serialized(path):
    """Two shapes (format versions 3 and 4), the second with normals,
    uvs and colours."""
    v, n, uv, col, _ = _mesh()
    tri = np.asarray([[0, 1, 2], [0, 2, 3], [0, 1, 4]], np.uint32)
    blobs = []
    for version, flags, arrays in (
            (3, 0x1000, (v,)),
            (4, 0x1000 | 0x1 | 0x2 | 0x8, (v, n, uv, col))):
        body = struct.pack("<I", flags)
        if version == 4:
            body += b"mesh\x00"
        body += struct.pack("<QQ", len(v), len(tri))
        body += b"".join(a.astype("<f4").tobytes() for a in arrays)
        body += tri.astype("<u4").tobytes()
        blobs.append(struct.pack("<HH", 0x041C, version)
                     + zlib.compress(body))
    offsets, out = [], b""
    for b in blobs:
        offsets.append(len(out))
        out += b
    out += struct.pack(f"<{len(offsets)}Q", *offsets)
    out += struct.pack("<I", len(offsets))
    with open(path, "wb") as f:
        f.write(out)


def test_ply_and_serialized_meshes_equal_reference(tmp_path):
    for name, binary in (("a.ply", False), ("b.ply", True)):
        p = str(tmp_path / name)
        write_ply(p, binary)
        got, want = mesh_io.load_mesh_ex(p), jmesh.load_mesh_ex(p)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[4] is not None and got[1].shape == (4, 3)
    p = str(tmp_path / "c.serialized")
    write_serialized(p)
    for idx in (0, 1):
        got, want = mesh_io.load_mesh_ex(p, idx), jmesh.load_mesh_ex(p, idx)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
    assert got[2] is not None and got[4] is not None


WRAPPERS = """<scene version="0.6.0">
  <bsdf type="roughplastic" id="rp"><float name="alpha" value="0.2"/></bsdf>
  <bsdf type="blendbsdf" id="blend">
    <float name="weight" value="0.3"/>
    <ref id="rp"/>
    <bsdf type="ward"><float name="alpha" value="0.3"/></bsdf>
  </bsdf>
  <shape type="ply">
    <string name="filename" value="a.ply"/>
    <bsdf type="diffuse"><texture type="vertexcolors"/></bsdf>
  </shape>
  <shape type="serialized">
    <string name="filename" value="c.serialized"/>
    <integer name="shapeIndex" value="1"/>
    <transform name="toWorld"><translate x="200"/></transform>
    <bsdf type="mask"><rgb name="opacity" value="0.3, 0.5, 0.7"/>
      <bsdf type="normalmap">
        <texture type="wireframe"><float name="lineWidth" value="0.05"/>
        </texture>
        <bsdf type="roughcoating"><float name="intIOR" value="1.6"/>
          <bsdf type="roughdiffuse"/></bsdf>
      </bsdf>
    </bsdf>
  </shape>
  <shape type="shapegroup" id="g">
    <shape type="cube"><ref id="blend"/></shape>
    <shape type="ply"><string name="filename" value="b.ply"/></shape>
  </shape>
  <shape type="instance"><ref id="g"/>
    <transform name="toWorld"><scale value="20"/></transform></shape>
  <shape type="instance"><ref id="g"/>
    <transform name="toWorld"><translate y="300"/></transform></shape>
  <shape type="disk"><bsdf type="diffuse"><texture type="scale">
    <float name="scale" value="0.5"/><texture type="checkerboard"/>
  </texture></bsdf></shape>
  <shape type="cylinder"><float name="radius" value="3"/>
    <point name="p1" x="0" y="10" z="0"/></shape>
  <emitter type="collimated"><rgb name="power" value="10"/>
    <transform name="toWorld"><translate x="5"/></transform></emitter>
  <emitter type="sun"><integer name="resolution" value="64"/></emitter>
  <emitter type="spot"><rgb name="intensity" value="100"/></emitter>
</scene>"""


def test_wrappers_textures_and_instances_equal_reference(tmp_path):
    write_ply(str(tmp_path / "a.ply"), False)
    write_ply(str(tmp_path / "b.ply"), True)
    write_serialized(str(tmp_path / "c.serialized"))
    path = tmp_path / "wrappers.xml"
    path.write_text(WRAPPERS)
    got, want = _load_both(str(path), {})
    _equal(got, want)
    _equal_vcolors(got[0], want[0])
    mt = got[0].materials
    assert got[0].vcolors is not None and int(mt.tex_id.min()) == -2
    assert mt.has_mask and mt.has_mixture and mt.has_coating
    assert mt.has_normalmap
    assert st.EMITTER_COLLIMATED in got[0].emitters.kind.tolist()


def test_material_table_equals_reference():
    mats = [dict(kind=0), dict(kind=4, eta=1.5, opacity=(0.5, 0.5, 0.5)),
            dict(kind=3, mix_other=0, mix_weight=0.25, coat_eta=1.4,
                 coat_sigma_a=(0.1, 0.2, 0.3)),
            dict(kind=10, mix_other=2, mix_weight=0.5, normal_tex=0)]
    got, want = st.make_material_table(mats), jst.make_material_table(mats)
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f.name)
        else:
            assert a == b, f.name
    assert got.mix_depth == 2
    with pytest.raises(NotImplementedError, match="interior_medium"):
        st.make_material_table([dict(kind=0, interior_medium=0)])


REFUSED = [
    ('<medium type="homogeneous"/>', "medium"),
    ('<shape type="obj"><subsurface type="dipole"/></shape>', "subsurface"),
    ('<shape type="hair"/>', "hair"),
    ('<bsdf type="irawan"/>', "irawan"),
    ('<shape type="heightfield"/>', "heightfield"),
    ('<shape type="deformable"/>', "deformable"),
    ('<shape type="rectangle"><bsdf type="diffuse"><texture type="bitmap">'
     '<string name="filename" value="a.png"/></texture></bsdf></shape>',
     "bitmap"),
]


def test_remaining_refusals_name_their_feature(tmp_path):
    """What the slice leaves out raises NotImplementedError naming it: the
    XML elements of media, subsurface, hair, woven cloth, heightfields,
    deformable (moving) shapes and bitmaps; motion and the other cameras
    in the wavefront; the bidirectional and MMLT layers and gradients over
    the wavefront's scope."""
    for body, name in REFUSED:
        p = tmp_path / "bad.xml"
        p.write_text(f'<scene version="0.6.0">{body}</scene>')
        with pytest.raises(NotImplementedError, match=name):
            load_scene_xml(str(p))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sc, _ = load_scene_xml(SURFACES, {"res": "8"})
    with pytest.raises(NotImplementedError, match="motion"):
        make_path_trace(sc, PathConfig(max_depth=2, motion=True), "cpu")
    for fn in (lambda: BD.make_bidir_tables(sc, BD.BDPTConfig(max_depth=2),
                                            "cpu"),
               lambda: make_path_trace_diff(sc, PathConfig(max_depth=2),
                                            "cpu")):
        with pytest.raises(NotImplementedError, match=r"BSDF kinds \[4, 5"):
            fn()
    with pytest.raises(NotImplementedError, match="emitter kinds"):
        BD.make_bidir_tables(sc, BD.BDPTConfig(max_depth=2), "cpu")

