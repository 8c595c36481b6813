"""Procedural test scenes (counterpart of drmlt_mitsuba_tpu/scene/builders.py).

`cornell_box` builds the same arrays as the reference builder, leaf for
leaf, for the tall-box materials slice 1 renders.
"""
from __future__ import annotations

import numpy as np

from drmlt_mitsuba_tpu_torch.core import transform
from drmlt_mitsuba_tpu_torch.scene import types as st


def _quad(p0, p1, p2, p3):
    """Two triangles for quad p0-p1-p2-p3 (ccw)."""
    return [p0, p1, p2], [p0, p2, p3]


def _box(pmin, pmax):
    """12 triangles of an axis-aligned box."""
    x0, y0, z0 = pmin
    x1, y1, z1 = pmax
    quads = [
        ([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1]),  # bottom
        ([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0]),  # top
        ([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]),  # back(+z)
        ([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0]),  # front(-z)
        ([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0]),  # left
        ([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1]),  # right
    ]
    tris = []
    for q in quads:
        tris.extend(_quad(*q))
    return tris


def _rotate_y(pts, angle_deg, center):
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return (np.asarray(pts) - center) @ r.T + center


TALL_BOX_MATERIALS = {
    "diffuse": dict(kind=st.BSDF_DIFFUSE, albedo=(0.725, 0.71, 0.68)),
    "mirror": dict(kind=st.BSDF_MIRROR, albedo=(0.9, 0.9, 0.9)),
    "glass": dict(kind=st.BSDF_DIELECTRIC, eta=(1.5, 1.5, 1.5)),
}


def cornell_box(width: int = 128, height: int = 128,
                light_radiance=(18.4, 15.6, 8.0),
                tall_box_material: str = "diffuse") -> st.Scene:
    """The classic Cornell box (556-unit box, camera on -z looking in):
    36 triangles, 5 materials, one area light of two triangles.
    tall_box_material: "diffuse" | "mirror" | "glass"."""
    if tall_box_material not in TALL_BOX_MATERIALS:
        raise NotImplementedError(
            f"tall-box material {tall_box_material!r} not yet ported "
            f"(have {sorted(TALL_BOX_MATERIALS)})")
    verts: list = []
    faces: list = []
    mat_ids: list = []
    emit_ids: list = []

    def add_tri(tri, mat, emit=-1):
        base = len(verts)
        verts.extend(tri)
        faces.append([base, base + 1, base + 2])
        mat_ids.append(mat)
        emit_ids.append(emit)

    white, red, green, light_m, tall_m = 0, 1, 2, 3, 4
    s = 556.0
    for t in _quad([0, 0, 0], [0, 0, s], [s, 0, s], [s, 0, 0]):     # floor
        add_tri(t, white)
    for t in _quad([0, s, 0], [s, s, 0], [s, s, s], [0, s, s]):     # ceiling
        add_tri(t, white)
    for t in _quad([0, 0, s], [0, s, s], [s, s, s], [s, 0, s]):     # back
        add_tri(t, white)
    for t in _quad([0, 0, 0], [0, s, 0], [0, s, s], [0, 0, s]):     # left
        add_tri(t, red)
    for t in _quad([s, 0, 0], [s, 0, s], [s, s, s], [s, s, 0]):     # right
        add_tri(t, green)
    # light: 130x105 patch slightly below the ceiling, normal down (-y)
    lx0, lx1, lz0, lz1, ly = 213.0, 343.0, 227.0, 332.0, s - 0.5
    for t in _quad([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1],
                   [lx0, ly, lz1]):
        add_tri(t, light_m, emit=0)
    for t in _box([0, 0, 0], [166, 165, 166]):                       # short
        add_tri(_rotate_y(t, -17.0, np.array([83, 0, 83]))
                + np.array([130, 0, 65]), white)
    for t in _box([0, 0, 0], [166, 330, 166]):                       # tall
        add_tri(_rotate_y(t, 107.0, np.array([83, 0, 83]))
                + np.array([265, 0, 296]), tall_m)

    mats = [
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.725, 0.71, 0.68)),   # white
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.63, 0.065, 0.05)),   # red
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.14, 0.45, 0.091)),   # green
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.78, 0.78, 0.78)),    # light
        TALL_BOX_MATERIALS[tall_box_material],                     # tall box
    ]
    tris = st.build_triangles(
        np.asarray(verts, np.float32), np.asarray(faces, np.int32),
        np.asarray(mat_ids, np.int32), np.asarray(emit_ids, np.int32))
    emitters = st.build_emitters(tris, np.asarray([light_radiance],
                                                  np.float32))
    # per-triangle emitter ids become emitter-table rows
    area_rows = np.nonzero(emitters.kind.numpy() == st.EMITTER_AREA)[0]
    row_of_tri = np.full(len(faces), -1, np.int32)
    row_of_tri[emitters.tri_idx.numpy()[area_rows]] = area_rows.astype(
        np.int32)
    tris.emitter_id = st._t(row_of_tri)

    cam = st.make_camera(
        transform.look_at([278, 273, -800], [278, 273, 0], [0, 1, 0]),
        fov_x_deg=39.3077, aspect=width / height)
    return st.Scene(tris=tris, spheres=st.empty_spheres(),
                    materials=st.make_material_table(mats),
                    emitters=emitters, camera=cam)
