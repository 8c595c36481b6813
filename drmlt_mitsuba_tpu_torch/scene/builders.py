"""Procedural test scenes (counterpart of drmlt_mitsuba_tpu/scene/builders.py).

`cornell_box`, `veach_door` and `furnace_sphere` build the same arrays as
the reference builders, leaf for leaf (the Cornell box for the tall-box and
sphere materials the port renders).  `cornell_scope` dresses the Cornell
box in the features of the trace kernels' full scene scope (textures, an
environment, a thin lens, the conductor and null kinds).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
    "roughconductor": dict(kind=st.BSDF_ROUGH_CONDUCTOR, roughness=0.15,
                           eta=(0.2, 0.92, 1.1), k=(3.9, 2.45, 2.14)),
    "orennayar": dict(kind=st.BSDF_ROUGH_DIFFUSE,
                      albedo=(0.725, 0.71, 0.68), roughness=0.4),
}


def cornell_box(width: int = 128, height: int = 128,
                light_radiance=(18.4, 15.6, 8.0),
                tall_box_material: str = "diffuse",
                sphere_material: str | None = None,
                tessellate: int = 1) -> st.Scene:
    """The classic Cornell box (556-unit box, camera on -z looking in):
    36 triangles, 5 materials, one area light of two triangles.
    tall_box_material: "diffuse" | "mirror" | "glass" | "roughconductor" |
    "orennayar".  sphere_material (the same choices) adds the analytic
    sphere of tests/data/cornell.xml (center (400, 90, 300), radius 90)
    with a sixth material.  tessellate = n cuts every non-emissive triangle
    into n^2 (34 n^2 + 2 triangles; 13, 24 and 44 give the reference
    benchmark's 5,748, 19,586 and 65,826)."""
    for m in (tall_box_material, sphere_material):
        if m is not None and m not in TALL_BOX_MATERIALS:
            raise NotImplementedError(
                f"Cornell-box material {m!r} not yet ported (have "
                f"{sorted(TALL_BOX_MATERIALS)})")
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
    spheres = st.empty_spheres()
    if sphere_material is not None:
        mats.append(TALL_BOX_MATERIALS[sphere_material])          # sphere
        spheres = st.make_spheres([[400.0, 90.0, 300.0]], [90.0],
                                  [len(mats) - 1])
    tris = st.build_triangles(
        np.asarray(verts, np.float32), np.asarray(faces, np.int32),
        np.asarray(mat_ids, np.int32), np.asarray(emit_ids, np.int32))
    emitters = st.build_emitters(tris, np.asarray([light_radiance],
                                                  np.float32))
    st.set_emitter_rows(tris, emitters)

    cam = st.make_camera(
        transform.look_at([278, 273, -800], [278, 273, 0], [0, 1, 0]),
        fov_x_deg=39.3077, aspect=width / height)
    return st.Scene(tris=tris, spheres=spheres,
                    materials=st.make_material_table(mats),
                    emitters=emitters, camera=cam)


def furnace_sphere(albedo=0.8, env=1.0) -> st.Scene:
    """A diffuse unit sphere in a constant environment, the analytic
    'white furnace' oracle: a pixel converges to env where it sees past the
    sphere and to albedo * env where it sees the sphere (one convex
    diffuse bounce, then escape).  One invalid, degenerate triangle keeps
    the triangle table non-empty."""
    tris = st.build_triangles(
        np.zeros((3, 3), np.float32)
        + np.array([[0, 0, 0], [1e-5, 0, 0], [0, 1e-5, 0]]),
        np.array([[0, 1, 2]], np.int32), np.zeros(1, np.int32),
        np.full(1, -1, np.int32))
    tris.valid = torch.zeros(1, dtype=torch.bool)
    spheres = st.make_spheres([[0.0, 0.0, 3.0]], [1.0], [0])
    emitters = st.build_emitters(tris, np.zeros((1, 3), np.float32),
                                 env_radiance=(env, env, env))
    mats = st.make_material_table(
        [dict(kind=st.BSDF_DIFFUSE, albedo=(albedo, albedo, albedo))])
    cam = st.make_camera(
        transform.look_at([0, 0, 0], [0, 0, 1], [0, 1, 0]), 60.0, 1.0)
    return st.Scene(tris=tris, spheres=spheres, materials=mats,
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


def sky_image(he: int, we: int) -> np.ndarray:
    """A lat-long sky (he, we, 3), Y up: a blue gradient above, a dim
    ground below, and a small warm sun in front of the Cornell box's
    opening (toward its camera, -z) that shines in; a little noise from a
    seed."""
    rng = np.random.default_rng(he * 1000 + we)
    th = (np.arange(he) + 0.5) / he * np.pi
    ph = ((np.arange(we) + 0.5) / we * 2.0 - 1.0) * np.pi
    T, P = np.meshgrid(th, ph, indexing="ij")
    d = np.stack([np.sin(T) * np.sin(P), np.cos(T), -np.sin(T) * np.cos(P)],
                 -1)
    up = d[..., 1:2]
    img = np.where(up > 0, np.array([0.3, 0.45, 0.8]) * (0.4 + 0.6 * up),
                   np.array([0.15, 0.12, 0.1]))
    sun = np.array([0.25, 0.35, -0.9])
    sun = sun / np.linalg.norm(sun)
    img = img + (d @ sun > 0.995)[..., None] * np.array([60.0, 52.0, 40.0])
    return (img * (1.0 + 0.05 * rng.random((he, we, 1)))).astype(np.float32)


def _append_material(mt, **kw):
    """The material table with one more row (make_material_table's
    defaults for what kw leaves out)."""
    row = st.make_material_table([kw])
    if any(getattr(t, f) for t in (mt, row) for f in (
            "has_mask", "has_mixture", "has_coating", "has_normalmap")):
        raise ValueError("_append_material joins tables without modifiers")
    return dataclasses.replace(mt, **{
        f.name: torch.cat([getattr(mt, f.name), getattr(row, f.name)])
        for f in dataclasses.fields(mt)
        if isinstance(getattr(mt, f.name), torch.Tensor)
        and getattr(row, f.name) is not None},
        kinds_present=tuple(sorted(set(mt.kinds_present)
                                   | set(row.kinds_present))))


SCOPE_ENV = (0.4, 0.5, 0.7)


def cornell_scope(width: int, height: int, variant: str) -> st.Scene:
    """The Cornell box on the trace kernels' full scene scope: a rough
    conductor tall box and the rough-conductor sphere of
    tests/data/cornell.xml, the back wall a 256x256 checkerboard page
    (uvs from its world x, y), lit by the ceiling light and
      const   : a constant environment SCOPE_ENV the open box lets in;
      thinlens: the same through a thin lens (aperture 25, focus 800);
      env64 / env256: a 64x128 / 256x512 lat-long image environment
                (sky_image) instead;
      kinds   : no texture and no environment, the tall box a gold
                conductor and the short box null (rays pass through it)."""
    sc = cornell_box(width, height, tall_box_material="roughconductor",
                     sphere_material="roughconductor")
    t, mt = sc.tris, sc.materials
    if variant == "kinds":
        mt.kind[4] = st.BSDF_CONDUCTOR
        mt.eta[4] = torch.tensor([0.143, 0.375, 1.442])
        mt.k[4] = torch.tensor([3.983, 2.386, 1.603])
        mt = _append_material(mt, kind=st.BSDF_NULL)
        t.mat_id[12:24] = mt.kind.shape[0] - 1      # the short box
        return dataclasses.replace(sc, materials=mt)
    yy, xx = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    page = np.where((((xx * 16 // 256) + (yy * 16 // 256)) % 2)[..., None]
                    == 0, (0.75, 0.72, 0.65), (0.2, 0.25, 0.55))
    mt = _append_material(mt, kind=st.BSDF_DIFFUSE, tex_id=0)
    t.mat_id[4:6] = mt.kind.shape[0] - 1            # the back wall
    for k, p in (("uv0", t.v0), ("uv1", t.v0 + t.e1), ("uv2", t.v0 + t.e2)):
        getattr(t, k)[4:6] = p[4:6, 0:2] / 556.0
    sc = dataclasses.replace(sc, materials=mt, textures=st.TextureAtlas(
        data=torch.tensor(page, dtype=torch.float32)[None]))
    if variant in ("env64", "env256"):
        he = 64 if variant == "env64" else 256
        em = st.build_emitters(t, sc.emitters.radiance.numpy(),
                               env_image=sky_image(he, 2 * he))
        st.set_emitter_rows(t, em)
        return dataclasses.replace(sc, emitters=em)
    sc = dataclasses.replace(sc, emitters=dataclasses.replace(
        sc.emitters, env_radiance=torch.tensor(SCOPE_ENV)))
    if variant == "thinlens":
        sc = dataclasses.replace(sc, camera=dataclasses.replace(
            sc.camera, aperture_radius=torch.tensor(25.0),
            focus_distance=torch.tensor(800.0)))
    elif variant != "const":
        raise ValueError(f"no Cornell scope variant {variant!r}")
    return sc
