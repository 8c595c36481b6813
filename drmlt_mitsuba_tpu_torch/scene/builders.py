"""Procedural test scenes (counterpart of drmlt_mitsuba_tpu/scene/builders.py).

`cornell_box` and `veach_door` build the same arrays as the reference
builders, leaf for leaf (the Cornell box for the tall-box materials the
port renders).
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


def _tessellate(tris, n):
    """Each triangle cut into n^2 congruent ones (the reference's
    large-scene geometry: the same radiometry, n^2 times the triangles)."""
    out = []
    for tri in tris:
        p0, p1, p2 = (np.asarray(v, np.float64) for v in tri)
        e1 = (p1 - p0) / n
        e2 = (p2 - p0) / n
        for i in range(n):
            for j in range(n - i):
                a = p0 + i * e1 + j * e2
                out.append([a, a + e1, a + e2])
                if i + j < n - 1:
                    out.append([a + e1, a + e1 + e2, a + e2])
    return out


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
                tall_box_material: str = "diffuse",
                tessellate: int = 1) -> st.Scene:
    """The classic Cornell box (556-unit box, camera on -z looking in):
    36 triangles, 5 materials, one area light of two triangles.
    tall_box_material: "diffuse" | "mirror" | "glass".  tessellate = n cuts
    every non-emissive triangle into n^2 (34 n^2 + 2 triangles; 13, 24 and
    44 give the reference benchmark's 5,748, 19,586 and 65,826)."""
    if tall_box_material not in TALL_BOX_MATERIALS:
        raise NotImplementedError(
            f"tall-box material {tall_box_material!r} not yet ported "
            f"(have {sorted(TALL_BOX_MATERIALS)})")
    verts: list = []
    faces: list = []
    mat_ids: list = []
    emit_ids: list = []

    def add_tri(tri, mat, emit=-1):
        # emitters stay untessellated: one emitter row per light triangle
        tess = tessellate if (tessellate > 1 and emit < 0) else 1
        for t in (_tessellate([tri], tess) if tess > 1 else [tri]):
            base = len(verts)
            verts.extend(t)
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
    st.set_emitter_rows(tris, emitters)

    cam = st.make_camera(
        transform.look_at([278, 273, -800], [278, 273, 0], [0, 1, 0]),
        fov_x_deg=39.3077, aspect=width / height)
    return st.Scene(tris=tris, spheres=st.empty_spheres(),
                    materials=st.make_material_table(mats),
                    emitters=emitters, camera=cam)


def veach_door(width: int = 128, height: int = 128,
               door_angle_deg: float = 12.0,
               light_radiance=(60.0, 55.0, 45.0)) -> st.Scene:
    """Procedural stand-in for the veach-door scene: two rooms joined by a
    slightly open door, the light in the far room, so the camera room is
    lit almost entirely through the door gap (24 triangles; the door is
    rough diffuse, Oren-Nayar sigma 0.35)."""
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

    def add_quad(p0, p1, p2, p3, mat, emit=-1):
        for t in _quad(p0, p1, p2, p3):
            add_tri(t, mat, emit)

    white, red, wood, light_m = 0, 1, 2, 3
    X, Y, Z = 10.0, 5.0, 10.0        # total footprint; divider at x=5
    dx = 5.0
    dz0, dz1 = 4.0, 6.0              # doorway span in z
    dh = 4.0                         # doorway height

    # outer shell (normals inward)
    add_quad([0, 0, 0], [0, 0, Z], [X, 0, Z], [X, 0, 0], white)        # floor
    add_quad([0, Y, 0], [X, Y, 0], [X, Y, Z], [0, Y, Z], white)        # ceil
    add_quad([0, 0, Z], [0, Y, Z], [X, Y, Z], [X, 0, Z], white)        # back
    add_quad([X, 0, 0], [X, Y, 0], [0, Y, 0], [0, 0, 0], white)        # front
    add_quad([0, 0, 0], [0, Y, 0], [0, Y, Z], [0, 0, Z], red)          # left
    add_quad([X, 0, 0], [X, 0, Z], [X, Y, Z], [X, Y, 0], white)        # right

    # divider wall at x=dx with a doorway (two-sided white)
    def divider(z0, z1, y0, y1):
        add_quad([dx, y0, z0], [dx, y1, z0], [dx, y1, z1], [dx, y0, z1],
                 white)

    divider(0.0, dz0, 0.0, Y)        # solid section z < doorway
    divider(dz1, Z, 0.0, Y)          # solid section z > doorway
    divider(dz0, dz1, dh, Y)         # lintel above the door

    # door panel: hinge at (dx, *, dz0), swings into the camera room
    a = np.deg2rad(door_angle_deg)
    dirv = np.array([-np.sin(a), 0.0, np.cos(a)])
    p0 = np.array([dx, 0.0, dz0])
    p1 = p0 + dirv * (dz1 - dz0)
    add_quad(list(p0), list(p0 + [0, dh, 0]),
             list(p1 + [0, dh, 0]), list(p1), wood)
    add_quad(list(p1), list(p1 + [0, dh, 0]),
             list(p0 + [0, dh, 0]), list(p0), wood)

    # light panel on the far-room ceiling
    lx0, lx1, lz0, lz1 = 7.0, 8.5, 4.0, 6.0
    ly = Y - 0.01
    add_quad([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1], [lx0, ly, lz1],
             light_m, emit=0)

    mats = [
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.73, 0.71, 0.68)),
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.61, 0.10, 0.08)),
        dict(kind=st.BSDF_ROUGH_DIFFUSE, albedo=(0.44, 0.27, 0.14),
             roughness=0.35),
        dict(kind=st.BSDF_DIFFUSE, albedo=(0.78, 0.78, 0.78)),
    ]
    tris = st.build_triangles(
        np.asarray(verts, np.float32), np.asarray(faces, np.int32),
        np.asarray(mat_ids, np.int32), np.asarray(emit_ids, np.int32))
    emitters = st.build_emitters(tris, np.asarray([light_radiance],
                                                  np.float32))
    st.set_emitter_rows(tris, emitters)
    cam = st.make_camera(
        transform.look_at([1.2, 2.2, 1.5], [dx, 2.0, dz0 + 1.0], [0, 1, 0]),
        fov_x_deg=55.0, aspect=width / height)
    return st.Scene(tris=tris, spheres=st.empty_spheres(),
                    materials=st.make_material_table(mats),
                    emitters=emitters, camera=cam)
