"""Mitsuba 0.6 scene-XML loader for the port's scene subset (counterpart
of drmlt_mitsuba_tpu/scene/xml.py).

`load_scene_xml(path, defaults)` parses the reference's XML dialect, named
plugins with typed properties and `$key` substitution (the CLI's `-D
key=value`), into the port's `Scene` and a `RenderSettings` record with
the integrator, sampler and film configuration.  It reads what the ported
kernels render:

  top level : <default>, <integrator>, <sensor type="perspective"> or
              "thinlens" (fov, fovAxis, apertureRadius, focusDistance,
              toWorld; <sampler> sampleCount; <film type="hdrfilm">
              width, height, <rfilter>), <bsdf>, <shape>, <emitter>
  bsdfs     : diffuse, roughdiffuse, dielectric, conductor, roughconductor
              (eta / k or a `material` preset), null, and the twosided
              wrapper; shapes may <ref> a bsdf by id; a <texture> child
              (checkerboard, gridtexture) becomes a 256x256 page of the
              texture atlas
  shapes    : obj, rectangle, cube, sphere (analytic; tessellated when it
              carries an area emitter), each with an optional <emitter
              type="area">, and a <transform> of translate / rotate /
              scale / matrix / lookat
  emitters  : constant, envmap (an EXR file; a missing file warns and
              becomes a constant unit environment, as in the reference)

Any other element raises NotImplementedError naming its tag and type; so
do bitmap textures and non-EXR environment maps, which the reference
decodes and resizes with PIL.
Every array equals the reference loader's on the same file, leaf for
leaf: the same float64 transform products rounded once, the same vertex
welding and emitter rows.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
import xml.etree.ElementTree as ET

import numpy as np

from drmlt_mitsuba_tpu_torch.core import transform as tf
from drmlt_mitsuba_tpu_torch.scene import types as st
from drmlt_mitsuba_tpu_torch.scene.mesh_io import load_mesh_ex
from drmlt_mitsuba_tpu_torch.utils.exr import read_exr

# conductor IOR presets (eta, k) as RGB (the reference loader's, from the
# reference's data/ior/*.spd tables collapsed to sRGB primaries)
CONDUCTORS = {
    "cu": ((0.200, 0.924, 1.102), (3.912, 2.448, 2.138)),
    "au": ((0.143, 0.375, 1.442), (3.983, 2.386, 1.603)),
    "ag": ((0.155, 0.116, 0.138), (4.818, 3.122, 2.146)),
    "al": ((1.345, 0.965, 0.617), (7.475, 6.400, 5.303)),
    "cr": ((4.361, 2.910, 1.651), (5.196, 4.222, 3.746)),
    "ni": ((2.361, 1.663, 1.468), (4.498, 3.051, 2.344)),
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
}

# dielectric IOR presets (the reference's src/bsdfs/ior.h)
IORS = {
    "vacuum": 1.0, "air": 1.000277, "water": 1.3330, "ethanol": 1.361,
    "diamond": 2.419, "glass": 1.5046, "bk7": 1.5046, "pyrex": 1.470,
    "acrylic glass": 1.49, "polypropylene": 1.49, "pet": 1.575,
    "water ice": 1.31, "fused quartz": 1.458, "sodium chloride": 1.544,
    "amber": 1.55, "sapphire": 1.77, "bromine": 1.661,
}

_FILTERS = {"box": "box", "tent": "tent", "gaussian": "gaussian",
            "mitchell": "mitchell", "catmullrom": "catmullrom",
            "lanczos": "lanczos", "lanczossinc": "lanczos"}
_BSDF_KINDS = {"diffuse": st.BSDF_DIFFUSE,
               "roughdiffuse": st.BSDF_ROUGH_DIFFUSE,
               "dielectric": st.BSDF_DIELECTRIC,
               "conductor": st.BSDF_CONDUCTOR,
               "roughconductor": st.BSDF_ROUGH_CONDUCTOR,
               "null": st.BSDF_NULL}
TEX_SIZE = 256   # atlas page width and height
_PROPERTY_TAGS = ("integer", "float", "boolean", "string", "rgb", "srgb",
                  "spectrum", "point", "vector")


@dataclasses.dataclass
class RenderSettings:
    integrator: dict
    width: int = 256
    height: int = 256
    filter_name: str = "gaussian"
    spp: int = 32
    sampler: str = "independent"


def _unported(node, where=""):
    kind = node.get("type")
    what = f"<{node.tag}" + (f" type={kind!r}" if kind else "") + ">"
    raise NotImplementedError(
        f"scene XML element {what}{where} is not yet ported")


def _subst(text, defaults):
    if text is None:
        return text
    for k, v in defaults.items():
        text = text.replace(f"${k}", str(v))
    return text


def _parse_color(val):
    parts = [float(x) for x in val.replace(",", " ").split()]
    if len(parts) == 1:
        return np.full(3, parts[0], np.float32)
    return np.asarray(parts[:3], np.float32)


def _props(node, defaults):
    """Typed child properties of a plugin element."""
    out = {}
    for c in node:
        name = _subst(c.get("name"), defaults)
        val = _subst(c.get("value"), defaults)
        if c.tag == "integer":
            out[name] = int(float(val))
        elif c.tag == "float":
            out[name] = float(val)
        elif c.tag == "boolean":
            out[name] = val.lower() == "true"
        elif c.tag == "string":
            out[name] = val
        elif c.tag in ("rgb", "srgb", "spectrum"):
            out[name] = _parse_color(val)
        elif c.tag in ("point", "vector"):
            out[name] = np.array(
                [float(_subst(c.get(a), defaults) or 0) for a in "xyz"],
                np.float32)
    return out


def _look_at(origin, target, up):
    """The <lookat> matrix as the reference loader computes it: in the
    float32 of the parsed points (core/transform.py:look_at works in
    float64)."""
    d = target - origin
    d = d / np.linalg.norm(d)
    left = np.cross(up / np.linalg.norm(up), d)
    left /= np.linalg.norm(left)
    new_up = np.cross(d, left)
    t = np.eye(4)
    t[:3, 0], t[:3, 1], t[:3, 2], t[:3, 3] = left, new_up, d, origin
    return t


def _parse_transform(node, defaults):
    """The product of a <transform>'s elements, in float64, rounded once."""
    m = np.eye(4, dtype=np.float64)
    for c in node:
        def g(a, d="0"):
            return float(_subst(c.get(a), defaults) or d)

        tag = c.tag.lower()
        if tag == "translate":
            t = tf.translate([g("x"), g("y"), g("z")])
        elif tag == "scale":
            if c.get("value") is not None:
                t = tf.scale(float(_subst(c.get("value"), defaults)))
            else:
                t = tf.scale([g("x", "1"), g("y", "1"), g("z", "1")])
        elif tag == "rotate":
            t = tf.rotate([g("x"), g("y"), g("z")],
                              float(_subst(c.get("angle"), defaults)))
        elif tag == "matrix":
            t = tf.matrix([float(x) for x in
                               _subst(c.get("value"), defaults).split()])
        elif tag == "lookat":   # the reference writes both spellings
            t = _look_at(_parse_color(_subst(c.get("origin"), defaults)),
                         _parse_color(_subst(c.get("target"), defaults)),
                         _parse_color(_subst(c.get("up", "0, 1, 0"),
                                             defaults)))
        else:
            _unported(c, " in <transform>")
        m = t @ m
    return m.astype(np.float32)


def _resolve_ior(val):
    if isinstance(val, str):
        return IORS.get(val.lower(), 1.5046)
    return float(val)


def _check_children(node, allowed, where):
    for c in node:
        if c.tag not in allowed:
            _unported(c, where)


def _parse_texture(node, defaults, textures):
    """Bake a <texture> into a TEX_SIZE x TEX_SIZE atlas page (the
    reference loader's pages, xml.py:188-240); returns its index."""
    ttype = _subst(node.get("type"), defaults)
    props = _props(node, defaults)
    size = TEX_SIZE
    c0 = props.get("color0", np.full(3, 0.4, np.float32))
    c1 = props.get("color1", np.full(3, 0.2, np.float32))
    if ttype == "checkerboard":
        us = max(1, int(round(float(props.get("uscale", 1.0)))))
        vs = max(1, int(round(float(props.get("vscale", 1.0)))))
        yy, xx = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        cell = ((xx * 2 * us // size) + (yy * 2 * vs // size)) % 2
        page = np.where(cell[..., None] == 0, c0, c1).astype(np.float32)
    elif ttype == "gridtexture":
        lw = float(props.get("lineWidth", 0.01))
        us = max(1e-6, float(props.get("uscale", 1.0)))
        vs = max(1e-6, float(props.get("vscale", 1.0)))
        uu = (np.arange(size) + 0.5) / size * us % 1.0
        vv = (np.arange(size) + 0.5) / size * vs % 1.0
        on_u = (uu < lw) | (uu > 1.0 - lw)
        on_v = (vv < lw) | (vv > 1.0 - lw)
        line = on_u[None, :] | on_v[:, None]
        page = np.where(line[..., None], c1, c0).astype(np.float32)
    elif ttype == "bitmap":
        raise NotImplementedError(
            "scene XML <texture type='bitmap'> is not ported: the reference "
            "decodes and resizes it with PIL, which the port does not use")
    else:
        _unported(node)
    textures.append(page)
    return len(textures) - 1


def _parse_bsdf(node, defaults, materials, textures):
    """Append a <bsdf>'s material row; returns its index."""
    btype = _subst(node.get("type"), defaults)
    props = {}
    tex_id = -1
    while True:
        _check_children(node, _PROPERTY_TAGS + ("bsdf", "texture"),
                        f" in <bsdf type={btype!r}>")
        props.update(_props(node, defaults))
        tex = node.find("texture")
        if tex is not None and tex_id < 0:
            tex_id = _parse_texture(tex, defaults, textures)
        if btype != "twosided":
            break
        inner = node.find("bsdf")
        if inner is None:
            break
        node = inner
        btype = _subst(node.get("type"), defaults)
    kind = _BSDF_KINDS.get(btype)
    if kind is None:
        _unported(node)
    mat = dict(kind=kind, two_sided=True, tex_id=tex_id)
    refl = props.get("reflectance", props.get("diffuseReflectance"))
    if refl is not None:
        mat["albedo"] = refl
    if "specularReflectance" in props:
        mat["spec_refl"] = props["specularReflectance"]
    if "specularTransmittance" in props:
        mat["spec_trans"] = props["specularTransmittance"]
    if kind in (st.BSDF_CONDUCTOR, st.BSDF_ROUGH_CONDUCTOR):
        eta, k = CONDUCTORS.get(str(props.get("material", "cu")).lower(),
                                CONDUCTORS["cu"])
        mat["eta"] = props.get("eta", np.asarray(eta, np.float32))
        mat["k"] = props.get("k", np.asarray(k, np.float32))
    if kind == st.BSDF_DIELECTRIC:
        int_ior = _resolve_ior(props.get("intIOR", 1.5046))
        ext_ior = _resolve_ior(props.get("extIOR", 1.000277))
        mat["eta"] = np.full(3, int_ior / ext_ior, np.float32)
    if "alpha" in props:
        mat["roughness"] = float(np.mean(props["alpha"]))
    materials.append(mat)
    return len(materials) - 1


def _unit_rect():
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return v, f, None, uv


def _unit_cube():
    corners = np.array(
        [[x, y, z] for z in (-1, 1) for y in (-1, 1) for x in (-1, 1)],
        np.float32)
    quads = [(0, 2, 3, 1), (4, 5, 7, 6),   # z-, z+
             (0, 1, 5, 4), (2, 6, 7, 3),   # y-, y+
             (0, 4, 6, 2), (1, 3, 7, 5)]   # x-, x+
    faces = []
    for q in quads:
        faces.append([q[0], q[1], q[2]])
        faces.append([q[0], q[2], q[3]])
    return corners, np.asarray(faces, np.int32), None, None


def _apply_transform(m, v, n):
    v2 = v @ m[:3, :3].T + m[:3, 3]
    n2 = None
    if n is not None:
        n2 = n @ np.linalg.inv(m[:3, :3])
        n2 = n2 / np.maximum(np.linalg.norm(n2, axis=-1, keepdims=True),
                             1e-20)
    return v2.astype(np.float32), n2


def _parse_sensor(sensor, defaults, settings):
    """(to_world, horizontal fov in degrees, aperture radius, focus
    distance) of a perspective or thin-lens sensor (a perspective sensor
    with an apertureRadius is a thin lens, as in the reference loader); the
    film and sampler fill `settings`."""
    stype = _subst(sensor.get("type"), defaults)
    if stype not in ("perspective", "thinlens"):
        _unported(sensor)
    _check_children(sensor, _PROPERTY_TAGS + ("transform", "film",
                                              "sampler"), " in <sensor>")
    sprops = _props(sensor, defaults)
    aperture = float(sprops.get("apertureRadius", 0.0))
    focus = float(sprops.get("focusDistance", 1.0))
    fov = float(sprops.get("fov", 39.3077))
    fov_axis = sprops.get("fovAxis", "x")
    to_world = np.eye(4, dtype=np.float32)
    tnode = sensor.find("transform")
    if tnode is not None:
        to_world = _parse_transform(tnode, defaults)
    film = sensor.find("film")
    if film is not None:
        if _subst(film.get("type"), defaults) != "hdrfilm":
            _unported(film)
        _check_children(film, _PROPERTY_TAGS + ("rfilter",), " in <film>")
        fprops = _props(film, defaults)
        settings.width = int(fprops.get("width", 256))
        settings.height = int(fprops.get("height", 256))
        rf = film.find("rfilter")
        if rf is not None:
            settings.filter_name = _FILTERS.get(rf.get("type"), "gaussian")
    samp = sensor.find("sampler")
    if samp is not None:
        settings.sampler = samp.get("type", "independent")
        settings.spp = int(_props(samp, defaults).get("sampleCount", 32))
    if fov_axis == "y":
        aspect0 = settings.width / settings.height
        fov = np.rad2deg(2 * np.arctan(np.tan(np.deg2rad(fov) / 2) * aspect0))
    return to_world, fov, aperture, focus


def _unit_sphere_mesh(n_theta=12, n_phi=24):
    """UV-sphere triangulation (unit radius, origin center) with smooth
    per-vertex normals: an emissive sphere becomes triangles, because the
    emitter table holds triangle rows only (the reference loader's
    xml.py:510)."""
    th = np.linspace(0.0, np.pi, n_theta + 1)
    ph = np.linspace(0.0, 2.0 * np.pi, n_phi, endpoint=False)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    v = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                  np.cos(tt)], -1).reshape(-1, 3).astype(np.float32)
    idx = np.arange((n_theta + 1) * n_phi).reshape(n_theta + 1, n_phi)
    faces = []
    for i in range(n_theta):
        a, b = idx[i], idx[i + 1]
        an, bn = np.roll(a, -1), np.roll(b, -1)
        if i > 0:                       # skip the degenerate pole strip
            faces.append(np.stack([a, b, an], -1))
        if i < n_theta - 1:
            faces.append(np.stack([an, b, bn], -1))
    f = np.concatenate(faces).astype(np.int32)
    uv = np.stack([pp / (2.0 * np.pi), 1.0 - tt / np.pi], -1).reshape(-1, 2)
    return v, f, v.copy(), uv.astype(np.float32)


def _parse_shape(sh, defaults, base, materials, mat_by_id, textures,
                 spheres):
    """(v, f, n, uv, material row, area radiance or None) of a <shape>; an
    analytic sphere goes to `spheres` as (center, radius, material row)
    and returns None."""
    stype = _subst(sh.get("type"), defaults)
    if stype not in ("obj", "rectangle", "cube", "sphere"):
        _unported(sh)
    _check_children(sh, _PROPERTY_TAGS + ("transform", "ref", "bsdf",
                                          "emitter"),
                    f" in <shape type={stype!r}>")
    props = _props(sh, defaults)
    tnode = sh.find("transform")
    m = (_parse_transform(tnode, defaults) if tnode is not None
         else np.eye(4, dtype=np.float32))
    ref = sh.find("ref")
    if ref is not None and ref.get("id") in mat_by_id:
        mat_idx = mat_by_id[ref.get("id")]
    elif sh.find("bsdf") is not None:
        mat_idx = _parse_bsdf(sh.find("bsdf"), defaults, materials,
                              textures)
    else:
        materials.append(dict(kind=st.BSDF_DIFFUSE))
        mat_idx = len(materials) - 1
    radiance = None
    em = sh.find("emitter")
    if em is not None:
        if em.get("type") != "area":
            _unported(em, " in <shape>")
        radiance = _props(em, defaults).get("radiance",
                                            np.ones(3, np.float32))
    if stype == "obj":
        fname = props.get("filename")
        fpath = fname if os.path.isabs(fname) else os.path.join(base, fname)
        v, f, n, uv, _ = load_mesh_ex(fpath, props.get("shapeIndex", 0))
        if props.get("faceNormals"):
            n = None
    elif stype == "sphere":
        center = props.get("center", np.zeros(3, np.float32))
        radius = float(props.get("radius", 1.0))
        center = (m[:3, :3] @ center + m[:3, 3]).astype(np.float32)
        radius = radius * float(np.linalg.norm(m[:3, 0]))
        if radiance is None:
            spheres.append((center, radius, mat_idx))
            return None
        v, f, n, uv = _unit_sphere_mesh()
        return ((v * radius + center).astype(np.float32), f, n, uv, mat_idx,
                radiance)
    elif stype == "rectangle":
        v, f, n, uv = _unit_rect()
    else:
        v, f, n, uv = _unit_cube()
    v, n = _apply_transform(m, v, n)
    return v, f, n, uv, mat_idx, radiance


def _parse_emitter(em, defaults, base, env):
    """A top-level <emitter>: a constant or an image (EXR) environment,
    into env = {"radiance": (3,), "image": (He, We, 3) or None}."""
    etype = _subst(em.get("type"), defaults)
    _check_children(em, _PROPERTY_TAGS + ("transform",),
                    f" in <emitter type={etype!r}>")
    props = _props(em, defaults)
    if etype == "constant":
        env["radiance"] = props.get("radiance", np.ones(3, np.float32))
    elif etype == "envmap":
        fname = props.get("filename")
        fpath = fname if os.path.isabs(fname) else os.path.join(base, fname)
        if not os.path.exists(fpath):
            warnings.warn(f"envmap {fname!r} not found; using a constant "
                          "unit environment")
            env["radiance"] = np.maximum(
                env["radiance"],
                np.full(3, float(props.get("scale", 1.0)), np.float32))
            return
        if not fname.lower().endswith(".exr"):
            raise NotImplementedError(
                f"scene XML <emitter type='envmap'> {fname!r} is not ported: "
                "the reference decodes a non-EXR map with PIL, which the "
                "port does not use")
        env["image"] = (read_exr(fpath)[..., :3]
                        * float(props.get("scale", 1.0)))
    else:
        _unported(em)


def load_scene_xml(path: str, defaults: dict | None = None):
    """Load a Mitsuba scene XML -> (Scene, RenderSettings)."""
    defaults = dict(defaults or {})
    base = os.path.dirname(os.path.abspath(path))
    root = ET.parse(path).getroot()
    for d in root.findall("default"):
        defaults.setdefault(d.get("name"), d.get("value"))
    _check_children(root, ("default", "integrator", "sensor", "bsdf",
                           "shape", "emitter"), "")

    materials: list = []
    mat_by_id: dict = {}
    textures: list = []
    spheres: list = []
    for b in root.findall("bsdf"):
        idx = _parse_bsdf(b, defaults, materials, textures)
        if b.get("id"):
            mat_by_id[b.get("id")] = idx
    meshes = [m for m in (_parse_shape(sh, defaults, base, materials,
                                       mat_by_id, textures, spheres)
                          for sh in root.findall("shape")) if m is not None]
    env = dict(radiance=np.zeros(3, np.float32), image=None)
    for em in root.findall("emitter"):
        _parse_emitter(em, defaults, base, env)

    settings = RenderSettings(integrator=dict(type="path"))
    to_world, fov = np.eye(4, dtype=np.float32), 39.3077
    aperture, focus = 0.0, 1.0
    sensor = root.find("sensor")
    if sensor is not None:
        to_world, fov, aperture, focus = _parse_sensor(sensor, defaults,
                                                       settings)
    integrator = root.find("integrator")
    if integrator is not None:
        props_i = _props(integrator, defaults)
        # a property named "type" (the drmlt variant) must not shadow the
        # plugin name
        if "type" in props_i:
            props_i["variant"] = props_i.pop("type")
        icfg = dict(type=_subst(integrator.get("type", "path"), defaults))
        icfg.update(props_i)
        settings.integrator = icfg

    # ---- the SoA scene ---------------------------------------------------
    if not meshes:
        if not spheres:
            raise NotImplementedError(f"{path}: a scene without shapes")
        # the reference keeps the triangle table non-empty with one
        # degenerate triangle
        if not materials:
            materials.append(dict(kind=st.BSDF_DIFFUSE))
        meshes = [(np.zeros((3, 3), np.float32),
                   np.asarray([[0, 1, 2]], np.int32), None, None, 0, None)]
    all_f, all_mat, all_emid, emitter_rads = [], [], [], []
    voff = 0
    for v, f, _, _, mat_idx, radiance in meshes:
        all_f.append(np.asarray(f) + voff)
        all_mat.append(np.full(len(f), mat_idx, np.int32))
        if radiance is not None:
            emitter_rads.append(radiance)
            all_emid.append(np.full(len(f), len(emitter_rads) - 1, np.int32))
        else:
            all_emid.append(np.full(len(f), -1, np.int32))
        voff += len(v)
    verts = np.concatenate([m[0] for m in meshes])
    faces = np.concatenate(all_f)
    normals = None
    if any(m[2] is not None for m in meshes):
        normals = np.concatenate([n if n is not None else np.zeros_like(v)
                                  for v, _, n, *_ in meshes])
    uvs = None
    if any(m[3] is not None for m in meshes):
        uvs = np.concatenate([
            uv if uv is not None else np.zeros((len(v), 2), np.float32)
            for v, _, _, uv, *_ in meshes])

    tris = st.build_triangles(verts, faces, np.concatenate(all_mat),
                              np.concatenate(all_emid), normals=None,
                              uvs=uvs)
    if normals is not None:
        # zero shading normals fall back to the geometric one, per corner
        gn = np.cross(tris.e1.numpy(), tris.e2.numpy())
        gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)

        def pick(nv):
            out = nv.copy()
            bad = np.abs(nv).sum(-1) < 1e-8
            out[bad] = gn[bad]
            return st._t(out)

        tris.n0 = pick(normals[faces[:, 0]])
        tris.n1 = pick(normals[faces[:, 1]])
        tris.n2 = pick(normals[faces[:, 2]])

    rad_table = (np.stack(emitter_rads) if emitter_rads
                 else np.zeros((1, 3), np.float32))
    emitters = st.build_emitters(tris, rad_table, env_radiance=env["radiance"],
                                 env_image=env["image"])
    st.set_emitter_rows(tris, emitters)

    camera = st.make_camera(to_world, fov, settings.width / settings.height,
                            aperture, focus)
    scene = st.Scene(tris=tris,
                     spheres=(st.make_spheres(*zip(*spheres)) if spheres
                              else st.empty_spheres()),
                     materials=st.make_material_table(materials),
                     emitters=emitters, camera=camera,
                     textures=(st.TextureAtlas(data=st._t(np.stack(textures)))
                               if textures else None))
    return scene, settings
