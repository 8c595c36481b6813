"""Carry a reference scene into the port.

`scene_from_arrays` takes the reference `Scene`'s leaves as numpy arrays,
keyed by dotted field name ("tris.v0", "materials.kind", "camera.to_world",
...), and builds the port's `Scene`.  It is how a scene built or loaded by
the JAX package reaches the port without the port importing JAX: the caller
flattens the reference scene with numpy and hands the dict across.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from drmlt_mitsuba_tpu_torch.scene import types as st

_GROUPS = {
    "tris": st.TriangleSoA,
    "spheres": st.SphereSoA,
    "materials": st.MaterialTable,
    "emitters": st.EmitterTable,
    "camera": st.Camera,
    "textures": st.TextureAtlas,
    "motion": st.TriangleMotion,
}
# groups and fields a scene may leave out (None)
_OPTIONAL = {"textures", "motion"}


def _optional(cls, name) -> bool:
    f = {x.name: x for x in dataclasses.fields(cls)}[name]
    return f.default is None


def scene_from_arrays(arrays: dict[str, np.ndarray]) -> st.Scene:
    """Build a port Scene from {"group.field": ndarray}.

    Keys outside the port's subset (media, modifier tables, per-vertex
    colors, ...) raise NotImplementedError naming them; missing keys of
    the subset raise KeyError, except the optional ones (the texture atlas,
    the triangle motion, an image environment's tables), which may be
    absent or None."""
    known = {f"{g}.{f.name}" for g, cls in _GROUPS.items()
             for f in dataclasses.fields(cls)}
    extra = sorted(k for k, v in arrays.items()
                   if k not in known and v is not None)
    if extra:
        raise NotImplementedError(f"scene fields not yet ported: {extra}")
    kind = int(np.asarray(arrays.get("camera.kind", st.CAMERA_PERSPECTIVE)))
    if kind != st.CAMERA_PERSPECTIVE:
        raise NotImplementedError(f"camera kind {kind} not yet ported")
    parts = {}
    for g, cls in _GROUPS.items():
        if g in _OPTIONAL and all(arrays.get(f"{g}.{f.name}") is None
                                  for f in dataclasses.fields(cls)):
            parts[g] = None
            continue
        kw = {}
        for f in dataclasses.fields(cls):
            if g == "camera" and f.name == "kind":
                continue
            key = f"{g}.{f.name}"
            if _optional(cls, f.name) and arrays.get(key) is None:
                kw[f.name] = None
            else:
                kw[f.name] = st._t(arrays[key])
        parts[g] = cls(**kw)
    return st.Scene(**parts)


def replace_leaves(scene: st.Scene, leaves: dict) -> st.Scene:
    """A copy of `scene` with the given leaves, keyed by dotted field name
    ("materials.albedo", "tris.v0", ...), replaced; the other leaves are
    shared.  This is how live tensors that require grad enter the tables
    (ops/megatrace.py:pack_mega_tables_torch)."""
    groups: dict[str, dict] = {}
    for key, value in leaves.items():
        g, _, f = key.partition(".")
        if (g not in _GROUPS or getattr(scene, g) is None
                or f not in {x.name for x in dataclasses.fields(_GROUPS[g])}):
            raise KeyError(f"no scene leaf {key!r}")
        groups.setdefault(g, {})[f] = value
    return dataclasses.replace(scene, **{
        g: dataclasses.replace(getattr(scene, g), **kw)
        for g, kw in groups.items()})
