"""Flat SoA scene representation (counterpart of
drmlt_mitsuba_tpu/scene/types.py), as dataclasses of torch tensors.

The port carries the reference megakernels' scene subset: a triangle soup,
analytic spheres, a material table without modifier wrappers (its albedo
constant or from a bitmap page of the texture atlas), area emitters plus a
constant or lat-long image environment, and a perspective camera (pinhole
or thin lens).  Field names
and enum values are the reference's, so `scene/convert.py` can carry a
reference scene across leaf for leaf.  Above BVH_MIN_TRIS triangles
`prepare_scene` attaches a BVH (scene/bvh.py), which every kernel walks
instead of sweeping all triangles.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# BSDF kind enum (MaterialTable.kind); same numbering as the reference
BSDF_DIFFUSE = 0
BSDF_CONDUCTOR = 1
BSDF_DIELECTRIC = 2
BSDF_ROUGH_CONDUCTOR = 3
BSDF_PLASTIC = 4
BSDF_ROUGH_PLASTIC = 5
BSDF_THIN_DIELECTRIC = 6
BSDF_ROUGH_DIELECTRIC = 7
BSDF_MIRROR = 8
BSDF_NULL = 9
BSDF_PHONG = 10
BSDF_WARD = 11
BSDF_ROUGH_DIFFUSE = 12
BSDF_DIFFTRANS = 13
BSDF_HK = 14
BSDF_IRAWAN = 15

EMITTER_AREA = 0
EMITTER_ENV = 4          # lat-long image environment

CAMERA_PERSPECTIVE = 0

# Above this many triangles the kernels walk a BVH instead of sweeping every
# triangle (the reference's megakernels switch to their clustered traversal
# at the same count, megatrace.py:2111); one constant for every kernel.
BVH_MIN_TRIS = 4096


def _t(a, dtype=None):
    """numpy -> torch (a C-ordered copy), keeping the numpy dtype unless
    one is given."""
    return torch.from_numpy(np.array(a, dtype=dtype, order="C", copy=True))


@dataclasses.dataclass
class TriangleSoA:
    """Triangle soup: p = v0 + b1*e1 + b2*e2."""
    v0: torch.Tensor          # (T, 3)
    e1: torch.Tensor          # (T, 3)
    e2: torch.Tensor          # (T, 3)
    n0: torch.Tensor          # (T, 3) per-vertex shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor         # (T, 2)
    uv1: torch.Tensor
    uv2: torch.Tensor
    mat_id: torch.Tensor      # (T,) int32
    emitter_id: torch.Tensor  # (T,) int32 emitter-table row, -1 = none
    valid: torch.Tensor       # (T,) bool


@dataclasses.dataclass
class SphereSoA:
    center: torch.Tensor      # (S, 3)
    radius: torch.Tensor      # (S,)
    mat_id: torch.Tensor      # (S,) int32
    emitter_id: torch.Tensor  # (S,) int32
    valid: torch.Tensor       # (S,) bool


@dataclasses.dataclass
class MaterialTable:
    kind: torch.Tensor        # (M,) int32
    albedo: torch.Tensor      # (M, 3)
    eta: torch.Tensor         # (M, 3) real IOR (dielectric: channel 0)
    k: torch.Tensor           # (M, 3) imaginary IOR
    roughness: torch.Tensor   # (M,)
    spec_refl: torch.Tensor   # (M, 3)
    spec_trans: torch.Tensor  # (M, 3)
    tex_id: torch.Tensor      # (M,) int32, -1 = constant albedo
    two_sided: torch.Tensor   # (M,) bool


@dataclasses.dataclass
class TextureAtlas:
    """Bitmap albedo pages, (N, H, W, 3) float32; a material's tex_id
    names its page (-1: constant albedo)."""
    data: torch.Tensor


@dataclasses.dataclass
class EmitterTable:
    """Power-weighted emitter rows (area triangles, and one row for an
    image environment) plus a constant environment radiance; an image
    environment carries its lat-long image and sampling tables."""
    kind: torch.Tensor        # (E,) int32
    tri_idx: torch.Tensor     # (E,) int32
    radiance: torch.Tensor    # (E, 3)
    area: torch.Tensor        # (E,)
    pos: torch.Tensor         # (E, 3)
    aux: torch.Tensor         # (E, 4)
    pmf: torch.Tensor         # (E,)
    cdf: torch.Tensor         # (E,) inclusive
    env_radiance: torch.Tensor  # (3,)
    env_image: torch.Tensor | None = None    # (He, We, 3)
    env_row_cdf: torch.Tensor | None = None  # (He,) marginal row cdf
    env_col_cdf: torch.Tensor | None = None  # (He, We) per-row column cdf
    env_pmf: torch.Tensor | None = None      # (He, We) pixel pmf


@dataclasses.dataclass
class Camera:
    to_world: torch.Tensor         # (4, 4)
    tan_half_fov_x: torch.Tensor   # scalar
    tan_half_fov_y: torch.Tensor   # scalar
    aperture_radius: torch.Tensor  # scalar
    focus_distance: torch.Tensor   # scalar
    kind: int = CAMERA_PERSPECTIVE


@dataclasses.dataclass
class BVH:
    """Binned-SAH BVH over the triangles (scene/bvh.py), flattened depth
    first (the reference's layout, types.py:186-198): an inner node's left
    child `first` is the next node; a leaf holds the triangles
    order[first : first + count].  `skip` is the escape pointer of a
    stackless walk (-1 past the last node)."""
    nodes_min: torch.Tensor   # (N, 3)
    nodes_max: torch.Tensor   # (N, 3)
    first: torch.Tensor       # (N,) int32 first prim (leaf) or left child
    count: torch.Tensor       # (N,) int32 prim count (0 = inner)
    skip: torch.Tensor        # (N,) int32
    order: torch.Tensor       # (T,) int32 triangle ids in leaf order


@dataclasses.dataclass
class TriangleMotion:
    """Linear per-triangle motion over the shutter interval (the
    reference's TriangleMotion, types.py:203): keyframe(shutter close) -
    keyframe(shutter open) in TriangleSoA's layout, so the geometry at
    shutter time t in [0, 1] is v0 + t dv0 and so on.  Only the motion AOV
    (integrators/misc.py:render_motion_aov) reads it: every trace renders
    the scene at shutter open, as the reference's do without
    settings.motion."""
    dv0: torch.Tensor     # (T, 3)
    de1: torch.Tensor     # (T, 3)
    de2: torch.Tensor     # (T, 3)
    dn0: torch.Tensor     # (T, 3) shading-normal deltas
    dn1: torch.Tensor     # (T, 3)
    dn2: torch.Tensor     # (T, 3)


@dataclasses.dataclass
class Scene:
    tris: TriangleSoA
    spheres: SphereSoA
    materials: MaterialTable
    emitters: EmitterTable
    camera: Camera
    bvh: BVH | None = None
    textures: TextureAtlas | None = None
    motion: TriangleMotion | None = None     # None: a static scene


def prepare_scene(scene: Scene) -> Scene:
    """The scene with a BVH attached when it has more than BVH_MIN_TRIS
    triangles and none yet (counterpart of the reference's prepare_scene,
    types.py:303, whose TPU table tiers are not carried over)."""
    if scene.bvh is not None or scene.tris.v0.shape[0] <= BVH_MIN_TRIS:
        return scene
    from drmlt_mitsuba_tpu_torch.scene.bvh import build_bvh

    t = scene.tris
    bvh = build_bvh(t.v0.detach().cpu().numpy(), t.e1.detach().cpu().numpy(),
                    t.e2.detach().cpu().numpy())
    return dataclasses.replace(scene, bvh=bvh)


def make_material_table(mats: list[dict]) -> MaterialTable:
    """MaterialTable from a list of parameter dicts (host-side)."""
    unsupported = {"opacity", "mix_other", "mix_weight", "coat_eta",
                   "coat_sigma_a", "interior_medium", "normal_tex"}
    for d in mats:
        bad = unsupported & set(d)
        if bad:
            raise NotImplementedError(
                f"material modifiers not yet ported: {sorted(bad)}")
    m = len(mats)

    def field(name, default, shape):
        out = np.zeros((m,) + shape, dtype=np.float32)
        for i, d in enumerate(mats):
            out[i] = np.broadcast_to(np.asarray(d.get(name, default),
                                                np.float32), shape)
        return _t(out)

    return MaterialTable(
        kind=_t([d["kind"] for d in mats], np.int32),
        albedo=field("albedo", 0.5, (3,)),
        eta=field("eta", 1.5, (3,)),
        k=field("k", 0.0, (3,)),
        roughness=field("roughness", 0.1, ()),
        spec_refl=field("spec_refl", 1.0, (3,)),
        spec_trans=field("spec_trans", 1.0, (3,)),
        tex_id=_t([d.get("tex_id", -1) for d in mats], np.int32),
        two_sided=_t([bool(d.get("two_sided", True)) for d in mats], bool),
    )


def build_triangles(vertices, faces, mat_id, emitter_id, normals=None,
                    uvs=None) -> TriangleSoA:
    """Host-side constructor from an indexed mesh."""
    v = np.asarray(vertices, np.float32)
    f = np.asarray(faces, np.int32)
    p0, p1, p2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    gn = np.cross(e1, e2)
    gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
    if normals is None:
        n0 = n1 = n2 = gn
    else:
        n = np.asarray(normals, np.float32)
        n0, n1, n2 = n[f[:, 0]], n[f[:, 1]], n[f[:, 2]]
    if uvs is None:
        uv0 = uv1 = uv2 = np.zeros((len(f), 2), np.float32)
    else:
        uv = np.asarray(uvs, np.float32)
        uv0, uv1, uv2 = uv[f[:, 0]], uv[f[:, 1]], uv[f[:, 2]]
    return TriangleSoA(
        v0=_t(p0), e1=_t(e1), e2=_t(e2), n0=_t(n0), n1=_t(n1), n2=_t(n2),
        uv0=_t(uv0), uv1=_t(uv1), uv2=_t(uv2),
        mat_id=_t(mat_id, np.int32), emitter_id=_t(emitter_id, np.int32),
        valid=torch.ones(len(f), dtype=torch.bool),
    )


def empty_spheres() -> SphereSoA:
    """A single invalid sphere (the reference keeps the table non-empty)."""
    return SphereSoA(
        center=torch.zeros((1, 3), dtype=torch.float32),
        radius=torch.full((1,), -1.0, dtype=torch.float32),
        mat_id=torch.zeros((1,), dtype=torch.int32),
        emitter_id=torch.full((1,), -1, dtype=torch.int32),
        valid=torch.zeros((1,), dtype=torch.bool),
    )


_LUM_W = np.array([0.212671, 0.715160, 0.072169], np.float32)


def build_emitters(tris: TriangleSoA, radiance_by_emitter,
                   env_radiance=(0.0, 0.0, 0.0), env_image=None,
                   scene_radius: float = 1000.0) -> EmitterTable:
    """One power-weighted area row per emissive triangle (pick ∝ power,
    then uniform barycentric), and for a lat-long `env_image` (He, We, 3)
    one environment row with its sampling tables (pixel pmf ∝ luminance x
    sin theta), as in the reference's build_emitters (types.py:480)."""
    kinds, tri_rows, rads, areas, power = [], [], [], [], []
    eid = tris.emitter_id.numpy()
    e1s, e2s = tris.e1.numpy(), tris.e2.numpy()
    rad_tab = np.asarray(radiance_by_emitter, np.float32)
    for i in np.nonzero(eid >= 0)[0]:
        area = 0.5 * float(np.linalg.norm(np.cross(e1s[i], e2s[i])))
        rad = rad_tab[eid[i]]
        kinds.append(EMITTER_AREA)
        tri_rows.append(int(i))
        rads.append(rad)
        areas.append(area)
        power.append(max(float(rad @ _LUM_W) * area * np.pi, 1e-12))
    if env_image is not None:
        img = np.asarray(env_image, np.float32)
        kinds.append(EMITTER_ENV)
        tri_rows.append(0)
        rads.append(img.mean(axis=(0, 1)))
        areas.append(0.0)
        mean_lum = float((img @ _LUM_W).mean())
        power.append(max(mean_lum * np.pi * scene_radius ** 2, 1e-12))
    if not kinds:   # keep shapes static: one dummy zero-power area row
        kinds, tri_rows, areas, power = [EMITTER_AREA], [0], [0.0], [1.0]
        rads = [np.zeros(3, np.float32)]
    E = len(kinds)
    power = np.asarray(power, np.float32)
    pmf = power / power.sum()
    cdf = np.cumsum(pmf).astype(np.float32)
    cdf[-1] = 1.0
    env = {}
    if env_image is not None:
        he, we = img.shape[:2]
        theta = (np.arange(he) + 0.5) / he * np.pi
        w = np.maximum((img @ _LUM_W) * np.sin(theta)[:, None], 1e-12)
        px = w / w.sum()
        row_p = px.sum(axis=1)
        row_cdf = np.cumsum(row_p)
        row_cdf[-1] = 1.0
        col_cdf = np.cumsum(px / row_p[:, None], axis=1)
        col_cdf[:, -1] = 1.0
        env = dict(env_image=_t(img), env_row_cdf=_t(row_cdf, np.float32),
                   env_col_cdf=_t(col_cdf, np.float32),
                   env_pmf=_t(px, np.float32))
    return EmitterTable(
        kind=_t(kinds, np.int32), tri_idx=_t(tri_rows, np.int32),
        radiance=_t(np.stack(rads)), area=_t(areas, np.float32),
        pos=torch.zeros((E, 3), dtype=torch.float32),
        aux=torch.zeros((E, 4), dtype=torch.float32),
        pmf=_t(pmf), cdf=_t(cdf),
        env_radiance=_t(env_radiance, np.float32), **env,
    )


def make_spheres(centers, radii, mat_ids) -> SphereSoA:
    """Valid, non-emissive analytic spheres (emissive spheres are
    tessellated into triangles, as in the reference's loader)."""
    n = len(radii)
    return SphereSoA(
        center=_t(np.asarray(centers, np.float32).reshape(n, 3)),
        radius=_t(radii, np.float32), mat_id=_t(mat_ids, np.int32),
        emitter_id=torch.full((n,), -1, dtype=torch.int32),
        valid=torch.ones((n,), dtype=torch.bool))


def set_emitter_rows(tris: TriangleSoA, emitters: EmitterTable):
    """Per-triangle emitter ids become emitter-table rows (-1 = not
    emissive), as the reference's builders and XML loader rewrite them."""
    area_rows = np.nonzero(emitters.kind.numpy() == EMITTER_AREA)[0]
    row_of_tri = np.full(tris.v0.shape[0], -1, np.int32)
    row_of_tri[emitters.tri_idx.numpy()[area_rows]] = area_rows.astype(
        np.int32)
    # a scene without emissive triangles keeps its dummy row unhit
    row_of_tri[tris.emitter_id.numpy() < 0] = -1
    tris.emitter_id = _t(row_of_tri)


def make_camera(to_world, fov_x_deg: float, aspect: float,
                aperture_radius: float = 0.0,
                focus_distance: float = 1.0) -> Camera:
    """Perspective camera from a (4, 4) camera-to-world transform."""
    tan_x = float(np.tan(np.deg2rad(fov_x_deg) / 2.0))
    f32 = torch.float32
    return Camera(
        to_world=torch.as_tensor(to_world, dtype=f32),
        tan_half_fov_x=torch.tensor(tan_x, dtype=f32),
        tan_half_fov_y=torch.tensor(tan_x / aspect, dtype=f32),
        aperture_radius=torch.tensor(aperture_radius, dtype=f32),
        focus_distance=torch.tensor(focus_distance, dtype=f32),
    )


def build_motion(tris0: TriangleSoA, tris1: TriangleSoA) -> TriangleMotion:
    """Per-triangle linear motion from two keyframe SoAs of one topology
    (the reference's build_motion, types.py:401).  A moving emissive
    triangle raises ValueError: light sampling reads the emitters at
    shutter open."""
    def delta(name):
        return (getattr(tris1, name).detach().cpu()
                - getattr(tris0, name).detach().cpu()).to(torch.float32)

    dv0 = delta("v0")
    moving = dv0.abs().amax(-1) > 0
    if bool((moving & (tris0.emitter_id.cpu() >= 0)).any()):
        raise ValueError("moving emissive triangles are not supported "
                         "(NEE samples lights at shutter open)")
    return TriangleMotion(dv0=dv0, de1=delta("e1"), de2=delta("e2"),
                          dn0=delta("n0"), dn1=delta("n1"), dn2=delta("n2"))
