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
}


def scene_from_arrays(arrays: dict[str, np.ndarray]) -> st.Scene:
    """Build a port Scene from {"group.field": ndarray}.

    Keys outside slice 1's subset (textures, media, env maps, modifier
    tables, ...) raise NotImplementedError naming them; missing keys of the
    subset raise KeyError."""
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
        kw = {}
        for f in dataclasses.fields(cls):
            if g == "camera" and f.name == "kind":
                continue
            kw[f.name] = st._t(arrays[f"{g}.{f.name}"])
        parts[g] = cls(**kw)
    return st.Scene(**parts)
