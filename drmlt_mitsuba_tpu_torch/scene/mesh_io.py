"""Triangle-mesh loaders (counterpart of drmlt_mitsuba_tpu/scene/mesh_io.py):
Wavefront OBJ, PLY (ASCII and binary, with vertex colours) and Mitsuba
`.serialized`.  Host-side numpy; a mesh is (vertices (V, 3) f32, faces
(F, 3) i32, normals (V, 3) | None, uvs (V, 2) | None).
"""
from __future__ import annotations

import struct
import zlib

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


# ---------------------------------------------------------------------------
# PLY
# ---------------------------------------------------------------------------

_PLY_TYPES = {
    "char": ("i1", 1), "int8": ("i1", 1),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
}


def load_ply(path: str, want_colors: bool = False):
    """PLY, ascii or binary little/big endian; vertex props x/y/z/nx/ny/nz/
    u/v(or s/t), face vertex_indices lists."""
    with open(path, "rb") as f:
        data = f.read()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end:]

    fmt = "ascii"
    # (name, count, [(prop_name, type) or ('list', ct, t, name)])
    elements = []
    for line in header:
        tok = line.split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append(("list", tok[2], tok[3], tok[4]))
            else:
                elements[-1][2].append((tok[2], tok[1]))  # (name, type)

    verts = norms = uvs = vcolors = None
    faces = []

    if fmt == "ascii":
        lines = body.decode("ascii", errors="replace").split("\n")
        li = 0
        for name, count, props in elements:
            if name == "vertex":
                rows = np.asarray(
                    [lines[li + i].split() for i in range(count)], np.float64
                )
                li += count
                cols = [p[0] for p in props]
                verts, norms, uvs, vcolors = _extract_vertex_cols(rows,
                                                                   cols)
            elif name == "face":
                for i in range(count):
                    tok = [int(x) for x in lines[li + i].split()]
                    n = tok[0]
                    for k in range(1, n - 1):
                        faces.append([tok[1], tok[1 + k], tok[2 + k]])
                li += count
            else:
                li += count
    else:
        bo = "<" if "little" in fmt else ">"
        off = 0
        for name, count, props in elements:
            if name == "vertex" and all(p[0] != "list" for p in props):
                dt = np.dtype([(p[0], bo + _PLY_TYPES[p[1]][0])
                               for p in props])
                arr = np.frombuffer(body, dt, count=count, offset=off)
                off += dt.itemsize * count
                cols = [p[0] for p in props]
                rows = np.stack(
                    [arr[c].astype(np.float64) for c in cols], axis=1
                )
                verts, norms, uvs, vcolors = _extract_vertex_cols(rows,
                                                                   cols)
            elif name == "face":
                for _ in range(count):
                    (ct, it) = (props[0][1], props[0][2])
                    ct_np, ct_sz = _PLY_TYPES[ct]
                    it_np, it_sz = _PLY_TYPES[it]
                    n = int(np.frombuffer(body, bo + ct_np, 1, off)[0])
                    off += ct_sz
                    idx = np.frombuffer(body, bo + it_np, n,
                                        off).astype(np.int64)
                    off += it_sz * n
                    for k in range(1, n - 1):
                        faces.append([idx[0], idx[k], idx[k + 1]])
            else:
                raise ValueError(f"unsupported PLY element {name}")

    out = (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
           None if norms is None else np.asarray(norms, np.float32),
           None if uvs is None else np.asarray(uvs, np.float32))
    if want_colors:
        return out + (None if vcolors is None
                      else np.asarray(vcolors, np.float32),)
    return out


def _extract_vertex_cols(rows, cols):
    def col(*names):
        for n in names:
            if n in cols:
                return rows[:, cols.index(n)]
        return None

    verts = np.stack([col("x"), col("y"), col("z")], axis=1)
    nx = col("nx")
    norms = (np.stack([col("nx"), col("ny"), col("nz")], axis=1)
             if nx is not None else None)
    u = col("u", "s", "texture_u")
    uvs = (np.stack([u, col("v", "t", "texture_v")], axis=1)
           if u is not None else None)
    r = col("red", "r", "diffuse_red")
    colors = None
    if r is not None:
        colors = np.stack([r, col("green", "g", "diffuse_green"),
                           col("blue", "b", "diffuse_blue")], axis=1)
        if colors.max() > 1.5:   # uchar-encoded 0-255 colors
            colors = colors / 255.0
    return verts, norms, uvs, colors


# ---------------------------------------------------------------------------
# Mitsuba .serialized (ref: src/librender/trimesh.cpp:34-36,98-104,206-260)
# ---------------------------------------------------------------------------

_MTS_HEADER = 0x041C
_E_HAS_NORMALS = 0x0001
_E_HAS_TEXCOORDS = 0x0002
_E_HAS_COLORS = 0x0008
_E_FACE_NORMALS = 0x0010
_E_SINGLE = 0x1000
_E_DOUBLE = 0x2000


def load_serialized(path: str, shape_index: int = 0,
                    want_colors: bool = False):
    """Mitsuba 0.x .serialized mesh container (zlib-deflated per shape;
    trailing uint64 offset table + uint32 count)."""
    with open(path, "rb") as f:
        data = f.read()
    (count,) = struct.unpack_from("<I", data, len(data) - 4)
    offsets = struct.unpack_from(
        f"<{count}Q", data, len(data) - 4 - 8 * count
    )
    pos = offsets[shape_index]
    magic, version = struct.unpack_from("<HH", data, pos)
    assert magic == _MTS_HEADER, "not a Mitsuba serialized mesh"
    # each shape is an independent zlib stream; stop at its end
    stream = zlib.decompressobj().decompress(data[pos + 4:])

    off = 0
    (flags,) = struct.unpack_from("<I", stream, off); off += 4
    if version == 0x0004:
        e = stream.index(b"\x00", off)
        off = e + 1   # mesh name
    vcount, tcount = struct.unpack_from("<QQ", stream, off); off += 16

    ftype = np.float64 if (flags & _E_DOUBLE) else np.float32
    fsize = 8 if (flags & _E_DOUBLE) else 4

    def take(n):
        nonlocal off
        arr = np.frombuffer(stream, ftype, count=n, offset=off)
        off += n * fsize
        return arr.astype(np.float32)

    verts = take(vcount * 3).reshape(vcount, 3)
    norms = (take(vcount * 3).reshape(vcount, 3)
             if flags & _E_HAS_NORMALS else None)
    uvs = (take(vcount * 2).reshape(vcount, 2)
           if flags & _E_HAS_TEXCOORDS else None)
    vcolors = (take(vcount * 3).reshape(vcount, 3)
               if flags & _E_HAS_COLORS else None)
    faces = np.frombuffer(stream, np.uint32, count=tcount * 3,
                          offset=off).reshape(tcount, 3).astype(np.int32)
    if flags & _E_FACE_NORMALS:
        norms = None
    if want_colors:
        return verts, faces, norms, uvs, vcolors
    return verts, faces, norms, uvs


def load_mesh_ex(path: str, shape_index: int = 0):
    """(v, f, n, uv, vertex colours or None) of a mesh file (OBJ carries
    no vertex colours)."""
    p = path.lower()
    if p.endswith(".ply"):
        return load_ply(path, want_colors=True)
    if p.endswith(".serialized"):
        return load_serialized(path, shape_index, want_colors=True)
    return load_mesh(path, shape_index) + (None,)


def load_mesh(path: str, shape_index: int = 0):
    """(v, f, n, uv) of an OBJ, PLY or serialized mesh file."""
    p = path.lower()
    if p.endswith(".obj"):
        return load_obj(path)
    if p.endswith(".ply"):
        return load_ply(path)
    if p.endswith(".serialized"):
        return load_serialized(path, shape_index)
    raise ValueError(f"unsupported mesh format: {path}")
