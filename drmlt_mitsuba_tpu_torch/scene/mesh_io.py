"""Triangle-mesh loaders (counterpart of drmlt_mitsuba_tpu/scene/mesh_io.py).

The port reads Wavefront OBJ; PLY and Mitsuba `.serialized` raise
NotImplementedError naming the format.  Host-side numpy; a mesh is
(vertices (V, 3) f32, faces (F, 3) i32, normals (V, 3) | None,
uvs (V, 2) | None).
"""
from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Wavefront OBJ (v / vt / vn / f; polygons fan-triangulated).

    Per-corner normals and uvs are welded to per-vertex ones by splitting
    vertices on distinct (v, vt, vn) triples, like the reference loader
    (mesh_io.py:19)."""
    vs, vts, vns = [], [], []
    corners = []   # one list of (vi, ti, ni) per face
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("v "):
                vs.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("vt "):
                t = [float(x) for x in line.split()[1:3]]
                vts.append(t if len(t) == 2 else t + [0.0])
            elif line.startswith("vn "):
                vns.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                face = []
                for tok in line.split()[1:]:
                    parts = tok.split("/")
                    vi = int(parts[0])
                    ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                    ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                    face.append((vi, ti, ni))
                corners.append(face)

    vs = np.asarray(vs, np.float32)
    vts = np.asarray(vts, np.float32) if vts else None
    vns = np.asarray(vns, np.float32) if vns else None

    def resolve(idx, n):   # 1-based, negative counts from the end
        return idx - 1 if idx > 0 else n + idx

    key_to_new: dict = {}
    new_v, new_n, new_t = [], [], []
    faces = []

    def corner_index(c):
        vi = resolve(c[0], len(vs))
        ti = resolve(c[1], len(vts) if vts is not None else 0) if c[1] else -1
        ni = resolve(c[2], len(vns) if vns is not None else 0) if c[2] else -1
        key = (vi, ti, ni)
        if key not in key_to_new:
            key_to_new[key] = len(new_v)
            new_v.append(vs[vi])
            new_t.append(vts[ti] if ti >= 0 and vts is not None else (0, 0))
            new_n.append(vns[ni] if ni >= 0 and vns is not None
                         else (0, 0, 0))
        return key_to_new[key]

    for face in corners:
        idx = [corner_index(c) for c in face]
        for k in range(1, len(idx) - 1):
            faces.append([idx[0], idx[k], idx[k + 1]])

    v = np.asarray(new_v, np.float32)
    f = np.asarray(faces, np.int32)
    n = np.asarray(new_n, np.float32) if vns is not None else None
    t = np.asarray(new_t, np.float32)[:, :2] if vts is not None else None
    if n is not None and not np.any(np.abs(n).sum(-1) > 0):
        n = None
    return v, f, n, t


def load_mesh_ex(path: str, shape_index: int = 0):
    """(v, f, n, uv, vertex colours) of a mesh file; OBJ carries no vertex
    colours (None).  PLY and serialized are not ported yet."""
    p = path.lower()
    for ext, name in ((".ply", "PLY"), (".serialized", "serialized")):
        if p.endswith(ext):
            raise NotImplementedError(
                f"{name} meshes are not yet ported (OBJ only): {path}")
    if p.endswith(".obj"):
        return load_obj(path) + (None,)
    raise ValueError(f"unsupported mesh format: {path}")
