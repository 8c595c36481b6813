"""Flat binary scene dump for native/cpu_oracle.cpp, the repo's
independent scalar C++ renderer (counterpart of
drmlt_mitsuba_tpu/utils/scene_dump.py): the port's Scene writes the same
bytes as the reference's dump of the same scene, so the oracle checks the
port's scenes too.

Format (little-endian):
  u32 magic 0x4452544F, u32 version=2
  u32 T (tris), u32 M (materials), u32 E (area-emitter rows), u32 W, u32 H
  u32 S (spheres)
  f32[16] cam_to_world (row major), f32 tan_half_fov_x, f32 tan_half_fov_y
  M × material: i32 kind, f32[3] albedo, f32[3] eta, f32[3] k,
                f32 roughness, i32 two_sided
  T × triangle: f32[3] v0, f32[3] e1, f32[3] e2, f32[3] n0 n1 n2,
                i32 mat_id, i32 emitter_row (-1 = none)
  E × emitter row: i32 tri_idx, f32[3] radiance, f32 area, f32 pmf
  S × sphere: f32[3] center, f32 radius, i32 mat_id
"""
from __future__ import annotations

import struct as _st

import numpy as np
import torch


def _np(x):
    """A leaf as a host numpy array (tensors on any device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


MAGIC = 0x4452544F


def dump_scene(scene, film_cfg, path: str):
    """Write `scene` and the film's size to `path` in the format above."""
    tris = scene.tris
    em = scene.emitters
    mats = scene.materials
    valid = _np(tris.valid)
    idx = np.nonzero(valid)[0]

    kind = _np(em.kind)
    area_rows = np.nonzero(kind == 0)[0]
    row_of_tri = {int(_np(em.tri_idx)[r]): ri
                  for ri, r in enumerate(area_rows)}

    sph = getattr(scene, "spheres", None)
    sph_rows = []
    if sph is not None:
        sv = _np(sph.valid)
        sc_c = _np(sph.center).astype(np.float32)
        sc_r = _np(sph.radius).astype(np.float32)
        sc_m = _np(sph.mat_id)
        sph_rows = [(sc_c[i], float(sc_r[i]), int(sc_m[i]))
                    for i in np.nonzero(sv)[0]]

    with open(path, "wb") as f:
        f.write(_st.pack("<IIIIIII", MAGIC, 2, len(idx),
                         int(_np(mats.kind).shape[0]),
                         len(area_rows), film_cfg.width, film_cfg.height))
        f.write(_st.pack("<I", len(sph_rows)))
        cam = scene.camera
        f.write(_np(cam.to_world).astype(np.float32).reshape(16).tobytes())
        f.write(_st.pack("<ff", float(cam.tan_half_fov_x),
                         float(cam.tan_half_fov_y)))
        ak = _np(mats.kind)
        aalb = _np(mats.albedo).astype(np.float32)
        aeta = _np(mats.eta).astype(np.float32)
        akk = _np(mats.k).astype(np.float32)
        arough = _np(mats.roughness).astype(np.float32)
        atwo = _np(mats.two_sided)
        for m in range(ak.shape[0]):
            f.write(_st.pack("<i", int(ak[m])))
            f.write(aalb[m].tobytes())
            f.write(aeta[m].tobytes())
            f.write(akk[m].tobytes())
            f.write(_st.pack("<fi", float(arough[m]), int(atwo[m])))
        v0 = _np(tris.v0).astype(np.float32)
        e1 = _np(tris.e1).astype(np.float32)
        e2 = _np(tris.e2).astype(np.float32)
        n0 = _np(tris.n0).astype(np.float32)
        n1 = _np(tris.n1).astype(np.float32)
        n2 = _np(tris.n2).astype(np.float32)
        mid = _np(tris.mat_id)
        for t in idx:
            for arr in (v0, e1, e2, n0, n1, n2):
                f.write(arr[t].tobytes())
            f.write(_st.pack("<ii", int(mid[t]),
                             row_of_tri.get(int(t), -1)))
        erad = _np(em.radiance).astype(np.float32)
        earea = _np(em.area).astype(np.float32)
        epmf = _np(em.pmf).astype(np.float32)
        etri = _np(em.tri_idx)
        # remap emitter tri indices into the valid-compacted ordering
        pos_of = {int(t): i for i, t in enumerate(idx)}
        for r in area_rows:
            f.write(_st.pack("<i", pos_of.get(int(etri[r]), -1)))
            f.write(erad[r].tobytes())
            f.write(_st.pack("<ff", float(earea[r]), float(epmf[r])))
        for c, rr, mi in sph_rows:
            f.write(_np(c).astype(np.float32).tobytes())
            f.write(_st.pack("<fi", rr, mi))
