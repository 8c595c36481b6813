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
    with open(path, "r", errors="replace") as fh:
        lines = fh.read().splitlines()

    def floats(prefix, n):   # the first n numbers of each `prefix` line
        rows = [ln.split()[1:n + 1] for ln in lines if ln.startswith(prefix)]
        return np.array(rows, np.float64).astype(np.float32) if rows else None

    vs = floats("v ", 3)
    vns = floats("vn ", 3)
    vts = [[float(x) for x in ln.split()[1:3]] for ln in lines
           if ln.startswith("vt ")]
    vts = (np.asarray([t if len(t) == 2 else t + [0.0] for t in vts],
                      np.float32) if vts else None)
    faces = [ln.split()[1:] for ln in lines if ln.startswith("f ")]
    sizes = [len(toks) for toks in faces]
    # (vi, ti, ni) of every face corner, 0 where absent
    parts = [(tok.split("/") + ["", ""])[:3] for toks in faces for tok in toks]
    corners = np.array([[p or "0" for p in c] for c in parts]
                       ).reshape(-1, 3).astype(np.int64)
    if vs is None:
        vs = np.zeros((0, 3), np.float32)

    def resolve(idx, n):   # 1-based, negative counts from the end; 0: none
        return np.where(idx > 0, idx - 1, np.where(idx < 0, n + idx, -1))

    c = corners
    keys = np.stack([
        resolve(c[:, 0], len(vs)),
        resolve(c[:, 1], len(vts)) if vts is not None else np.full(len(c), -1),
        resolve(c[:, 2], len(vns)) if vns is not None else np.full(len(c), -1),
    ], 1)
    # one vertex per distinct (v, vt, vn), numbered in order of first use
    _, first, inv = np.unique(keys, axis=0, return_index=True,
                              return_inverse=True)
    rank = np.empty(len(first), np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(first))
    corner_vertex = rank[inv.reshape(-1)]
    uniq = keys[np.sort(first)]

    # fan triangulation: face corners (0, k, k + 1), k = 1 .. n - 2
    sizes = np.asarray(sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    n_tri = np.maximum(sizes - 2, 0)
    base = np.repeat(starts, n_tri)
    k = np.arange(n_tri.sum()) - np.repeat(np.cumsum(n_tri) - n_tri, n_tri) + 1
    f = corner_vertex[np.stack([base, base + k, base + k + 1], 1)]
    f = f.reshape(-1, 3).astype(np.int32)

    v = vs[uniq[:, 0]]
    n = t = None
    if vns is not None:
        n = np.where((uniq[:, 2] >= 0)[:, None], vns[np.maximum(uniq[:, 2], 0)],
                     np.float32(0)).astype(np.float32)
        if not np.any(np.abs(n).sum(-1) > 0):
            n = None
    if vts is not None:
        t = np.where((uniq[:, 1] >= 0)[:, None], vts[np.maximum(uniq[:, 1], 0)],
                     np.float32(0)).astype(np.float32)[:, :2]
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
