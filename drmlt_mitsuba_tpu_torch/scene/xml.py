"""Mitsuba 0.6 scene-XML loader for the port's surface scope (counterpart
of drmlt_mitsuba_tpu/scene/xml.py).

`load_scene_xml(path, defaults)` parses the reference's XML dialect, named
plugins with typed properties and `$key` substitution (the CLI's `-D
key=value`), into the port's `Scene` and a `RenderSettings` record with
the integrator, sampler and film configuration.  It reads:

  top level : <default>, <integrator>, <sensor> (perspective, thinlens,
              perspective_rdist, orthographic, telecentric, spherical,
              radiancemeter, fluencemeter, irradiancemeter; fov, fovAxis,
              apertureRadius, focusDistance, kc, toWorld; <sampler>
              sampleCount; <film type="hdrfilm"> width, height,
              <rfilter>), <bsdf>, <shape>, <emitter>
  bsdfs     : diffuse, roughdiffuse, dielectric, thindielectric,
              roughdielectric, conductor, roughconductor (eta / k or a
              `material` preset), plastic, roughplastic, phong, ward,
              difftrans, hk, mirror, null, and the wrappers twosided,
              mask, coating / roughcoating (smooth, as in the reference),
              mixturebsdf / blendbsdf (chains of two-way rows) and
              bumpmap / normalmap (baked to a normal page); shapes may
              <ref> a bsdf by id; a <texture> child (checkerboard,
              gridtexture, wireframe, scale, vertexcolors) becomes a
              256x256 page of the texture atlas (vertexcolors: the mesh's
              per-vertex colors)
  shapes    : obj, ply, serialized, rectangle, cube, disk, cylinder,
              sphere (analytic; tessellated when it carries an area
              emitter), shapegroup and instance, each with an optional
              <emitter type="area">, and a <transform> of translate /
              rotate / scale / matrix / lookat
  emitters  : constant, envmap (an EXR file; a missing file warns and
              becomes a constant unit environment, as in the reference),
              point, spot, directional, collimated, and sun / sky /
              sunsky baked to an image environment (scene/sunsky.py)

Any other element raises NotImplementedError naming its tag and type:
media, subsurface, hair, heightfield, deformable shapes, irawan, the
other films; so do bitmap textures and non-EXR environment
maps, which the reference decodes and resizes with PIL.
Every array equals the reference loader's on the same file, leaf for
leaf: the same float64 transform products rounded once, the same vertex
welding, material rows and emitter rows.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
import xml.etree.ElementTree as ET

import numpy as np

from drmlt_mitsuba_tpu_torch.core import transform as tf
from drmlt_mitsuba_tpu_torch.scene import types as st
from drmlt_mitsuba_tpu_torch.scene.mesh_io import load_mesh, load_mesh_ex
from drmlt_mitsuba_tpu_torch.scene.sunsky import (
    bake_sky, sun_direction_from_time,
)
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
               "conductor": st.BSDF_CONDUCTOR,
               "roughconductor": st.BSDF_ROUGH_CONDUCTOR,
               "dielectric": st.BSDF_DIELECTRIC,
               "thindielectric": st.BSDF_THIN_DIELECTRIC,
               "roughdielectric": st.BSDF_ROUGH_DIELECTRIC,
               "plastic": st.BSDF_PLASTIC,
               "roughplastic": st.BSDF_ROUGH_PLASTIC,
               "phong": st.BSDF_PHONG,
               "ward": st.BSDF_WARD,
               "difftrans": st.BSDF_DIFFTRANS,
               "hk": st.BSDF_HK,
               "null": st.BSDF_NULL,
               "mirror": st.BSDF_MIRROR}
_WRAPPERS = ("twosided", "mask", "bumpmap", "normalmap", "coating",
             "roughcoating", "mixturebsdf", "blendbsdf")
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


def _parse_texture(node, defaults, ctx):
    """Bake a <texture> into a TEX_SIZE x TEX_SIZE atlas page (the
    reference loader's pages, xml.py:188-270); returns its index, or -2
    for vertexcolors (the albedo then reads the mesh's vertex colors)."""
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
    elif ttype in ("gridtexture", "wireframe"):
        lw = float(props.get("lineWidth", 0.01))
        if ttype == "gridtexture":
            us = max(1e-6, float(props.get("uscale", 1.0)))
            vs = max(1e-6, float(props.get("vscale", 1.0)))
            fill, ink = c0, c1
        else:   # edges of the uv square and its diagonal
            us = vs = 1.0
            fill = props.get("interiorColor", np.full(3, 0.5, np.float32))
            ink = props.get("edgeColor", np.full(3, 0.1, np.float32))
        uu = (np.arange(size) + 0.5) / size * us % 1.0
        vv = (np.arange(size) + 0.5) / size * vs % 1.0
        on_u = (uu < lw) | (uu > 1.0 - lw)
        on_v = (vv < lw) | (vv > 1.0 - lw)
        line = on_u[None, :] | on_v[:, None]
        if ttype == "wireframe":
            line = line | (np.abs(uu[None, :] + vv[:, None] - 1.0) < lw)
        page = np.where(line[..., None], ink, fill).astype(np.float32)
    elif ttype == "scale":
        sc = np.asarray(props.get("scale", 1.0), np.float32) * np.ones(3)
        inner = node.find("texture")
        if inner is not None:
            tid = _parse_texture(inner, defaults, ctx)
            ctx["textures"][tid] = (ctx["textures"][tid] * sc).astype(
                np.float32)
            return tid
        base_v = np.asarray(props.get("value", 1.0), np.float32) * np.ones(3)
        page = np.broadcast_to(base_v * sc, (size, size, 3)).astype(
            np.float32).copy()
    elif ttype == "vertexcolors":
        ctx["want_vcolors"] = True
        return -2
    elif ttype == "bitmap":
        raise NotImplementedError(
            "scene XML <texture type='bitmap'> is not ported: the reference "
            "decodes and resizes it with PIL, which the port does not use")
    else:
        _unported(node)
    ctx["textures"].append(page)
    return len(ctx["textures"]) - 1


def _parse_bsdf(node, defaults, ctx):
    """Append a <bsdf>'s material rows; returns the index of its row.  The
    wrappers become the row's modifier columns (the reference loader's
    xml.py:273-450, row for row)."""
    btype = _subst(node.get("type"), defaults)
    props = _props(node, defaults)
    tex_id = -1
    tex = node.find("texture")
    if tex is not None:
        tex_id = _parse_texture(tex, defaults, ctx)
    mods: dict = {}
    while btype in _WRAPPERS:
        _check_children(node, _PROPERTY_TAGS + ("bsdf", "texture", "ref"),
                        f" in <bsdf type={btype!r}>")
        node_props = _props(node, defaults)
        if btype == "mask":
            op = np.broadcast_to(np.asarray(node_props.get("opacity", 0.5),
                                            np.float32), (3,))
            mods["opacity"] = mods.get("opacity", np.ones(3, np.float32)) * op
        elif btype in ("coating", "roughcoating"):
            ii = _resolve_ior(node_props.get("intIOR", 1.5046))
            ee = _resolve_ior(node_props.get("extIOR", 1.000277))
            mods["coat_eta"] = float(ii / ee)
            sa = np.asarray(node_props.get("sigmaA", 0.0), np.float32)
            mods["coat_sigma_a"] = np.broadcast_to(
                sa * float(node_props.get("thickness", 1.0)), (3,)).copy()
            if btype == "roughcoating":
                warnings.warn("roughcoating treated as a smooth coating")
        elif btype in ("bumpmap", "normalmap"):
            tnode = node.find("texture")
            if tnode is None:
                warnings.warn(f"{btype} without a texture child; ignored")
            else:
                tid = _parse_texture(tnode, defaults, ctx)
                if btype == "bumpmap":
                    ctx["textures"][tid] = _bump_to_normals(
                        ctx["textures"][tid],
                        float(node_props.get("scale", 1.0)))
                mods["normal_tex"] = tid
        elif btype in ("mixturebsdf", "blendbsdf"):
            kids = [("bsdf", c) if c.tag == "bsdf" else ("ref", c.get("id"))
                    for c in node if c.tag in ("bsdf", "ref")]
            if btype == "blendbsdf":
                w = float(np.mean(node_props.get("weight", 0.5)))
                weights = [1.0 - w, w]
            else:
                ws = str(node_props.get("weights", "")).replace(",", " ")
                weights = [float(x) for x in ws.split()]
            weights += [1.0] * (len(kids) - len(weights))
            if len(kids) >= 2:
                total = sum(weights[: len(kids)]) or 1.0
                mods["mix_other"] = _parse_mixture_rest(
                    kids[1:], weights[1:len(kids)], defaults, ctx)
                mods["mix_weight"] = sum(weights[1:len(kids)]) / total
            if kids and kids[0][0] == "ref":
                # the first component by reference: the modifiers go on a
                # private copy of the referenced row
                i0 = ctx["mat_by_id"].get(kids[0][1])
                mat = (dict(ctx["materials"][i0]) if i0 is not None
                       else dict(kind=st.BSDF_DIFFUSE))
                mat.update(mods)
                ctx["materials"].append(mat)
                return len(ctx["materials"]) - 1
        inner = node.find("bsdf")
        if inner is None:
            break
        node = inner
        btype = _subst(node.get("type"), defaults)
        props.update(_props(node, defaults))
        if tex_id < 0:
            tex = node.find("texture")
            if tex is not None:
                tex_id = _parse_texture(tex, defaults, ctx)
    kind = _BSDF_KINDS.get(btype)
    if kind is None:
        _unported(node)
    _check_children(node, _PROPERTY_TAGS + ("texture", "phase"),
                    f" in <bsdf type={btype!r}>")
    mat = dict(kind=kind, two_sided=True, tex_id=tex_id)
    refl = props.get("reflectance", props.get("diffuseReflectance"))
    if kind == st.BSDF_DIFFTRANS:
        refl = props.get("transmittance", refl)
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
    if kind in (st.BSDF_DIELECTRIC, st.BSDF_THIN_DIELECTRIC,
                st.BSDF_ROUGH_DIELECTRIC, st.BSDF_PLASTIC,
                st.BSDF_ROUGH_PLASTIC):
        int_ior = _resolve_ior(props.get("intIOR", 1.5046))
        ext_ior = _resolve_ior(props.get("extIOR", 1.000277))
        mat["eta"] = np.full(3, int_ior / ext_ior, np.float32)
    if "alpha" in props:
        mat["roughness"] = float(np.mean(props["alpha"]))
    elif "exponent" in props:   # a Phong exponent as a roughness
        mat["roughness"] = float(np.sqrt(
            2.0 / (2.0 + np.mean(props["exponent"]))))
    if kind == st.BSDF_HK:
        # the slab: spec_refl = sigmaS, spec_trans = sigmaA, roughness =
        # thickness, k[0] = the HG phase's g
        mat["spec_refl"] = props.get("sigmaS", np.full(3, 2.0, np.float32))
        mat["spec_trans"] = props.get("sigmaA", np.full(3, 0.05, np.float32))
        mat["roughness"] = float(props.get("thickness", 1.0))
        g_hk = 0.0
        ph = node.find("phase")
        if ph is not None:
            g_hk = float(_props(ph, defaults).get("g", 0.0))
        mat["k"] = np.asarray([g_hk, 0.0, 0.0], np.float32)
    mat.update(mods)
    ctx["materials"].append(mat)
    return len(ctx["materials"]) - 1


def _bump_to_normals(page, scale):
    """A height page (its channel mean times scale) as a tangent-space
    normal page encoded (n + 1) / 2, by central differences."""
    h = page.mean(-1) * scale
    sz = h.shape[0]
    dhdu = (np.roll(h, -1, 1) - np.roll(h, 1, 1)) * sz * 0.5
    dhdv = (np.roll(h, -1, 0) - np.roll(h, 1, 0)) * sz * 0.5
    n = np.stack([-dhdu, -dhdv, np.ones_like(h)], -1)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    return ((n + 1.0) * 0.5).astype(np.float32)


def _parse_mixture_rest(kids, weights, defaults, ctx):
    """Mixture components 1..N-1 as a chain of two-way rows, the link
    weights renormalised (the reference's _parse_mixture_rest)."""
    def row_for(kid):
        tag, v = kid
        if tag == "ref":
            idx = ctx["mat_by_id"].get(v)
            if idx is not None:
                return idx
            warnings.warn(f"mixture ref '{v}' unknown; using diffuse")
            ctx["materials"].append(dict(kind=st.BSDF_DIFFUSE))
            return len(ctx["materials"]) - 1
        return _parse_bsdf(v, defaults, ctx)

    idx = row_for(kids[-1])
    acc = weights[-1]
    for kid, w in zip(reversed(kids[:-1]), reversed(weights[:-1])):
        m = dict(ctx["materials"][row_for(kid)])   # a private copy a link
        if m.get("mix_other", -1) >= 0:
            warnings.warn("mixture component is itself a mixture; its own "
                          "blend is overridden by the chain link")
        m["mix_other"] = idx
        m["mix_weight"] = acc / max(acc + w, 1e-9)
        ctx["materials"].append(m)
        idx = len(ctx["materials"]) - 1
        acc += w
    return idx


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


_SENSORS = {"perspective": st.CAMERA_PERSPECTIVE,
            "thinlens": st.CAMERA_PERSPECTIVE,
            "perspective_rdist": st.CAMERA_PERSPECTIVE,
            "orthographic": st.CAMERA_ORTHOGRAPHIC,
            "spherical": st.CAMERA_SPHERICAL,
            "radiancemeter": st.CAMERA_RADIANCEMETER,
            "telecentric": st.CAMERA_TELECENTRIC,
            "fluencemeter": st.CAMERA_FLUENCEMETER,
            "irradiancemeter": st.CAMERA_IRRADIANCEMETER}


def _parse_sensor(sensor, defaults, settings):
    """(to_world, horizontal fov in degrees, aperture radius, focus
    distance, camera kind, radial distortion kc or None) of a <sensor> (a
    perspective sensor with an apertureRadius is a thin lens, as in the
    reference loader); the film and sampler fill `settings`."""
    stype = _subst(sensor.get("type"), defaults)
    if stype not in _SENSORS:
        _unported(sensor)
    _check_children(sensor, _PROPERTY_TAGS + ("transform", "film",
                                              "sampler"), " in <sensor>")
    sprops = _props(sensor, defaults)
    kc = None
    if stype == "perspective_rdist":
        kcs = str(sprops.get("kc", "0, 0")).replace(",", " ").split()
        kc = [float(v) for v in (kcs + ["0", "0"])[:2]]
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
    return to_world, fov, aperture, focus, _SENSORS[stype], kc


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


def _shape_material(sh, defaults, ctx):
    ref = sh.find("ref")
    if ref is not None and ref.get("id") in ctx["mat_by_id"]:
        return ctx["mat_by_id"][ref.get("id")]
    if sh.find("bsdf") is not None:
        return _parse_bsdf(sh.find("bsdf"), defaults, ctx)
    ctx["materials"].append(dict(kind=st.BSDF_DIFFUSE))
    return len(ctx["materials"]) - 1


def _area_radiance(sh, defaults):
    em = sh.find("emitter")
    if em is None:
        return None
    if em.get("type") != "area":
        _unported(em, " in <shape>")
    return _props(em, defaults).get("radiance", np.ones(3, np.float32))


def _mesh_file(props, base, loader):
    fname = props.get("filename")
    fpath = fname if os.path.isabs(fname) else os.path.join(base, fname)
    return loader(fpath, props.get("shapeIndex", 0))


def _disk():
    nseg = 32
    ang = np.linspace(0, 2 * np.pi, nseg, endpoint=False)
    v = np.concatenate([np.zeros((1, 3), np.float32), np.stack(
        [np.cos(ang), np.sin(ang), np.zeros(nseg)], 1).astype(np.float32)])
    f = np.asarray([[0, 1 + i, 1 + (i + 1) % nseg] for i in range(nseg)],
                   np.int32)
    return v, f


def _cylinder(props):
    p0 = props.get("p0", np.asarray([0, 0, 0], np.float32))
    p1 = props.get("p1", np.asarray([0, 0, 1], np.float32))
    radius = float(props.get("radius", 1.0))
    nseg = 32
    axis = np.asarray(p1, np.float64) - np.asarray(p0, np.float64)
    axis = axis / max(np.linalg.norm(axis), 1e-9)
    ref_v = (np.array([1.0, 0, 0]) if abs(axis[0]) < 0.9
             else np.array([0, 1.0, 0]))
    t1 = np.cross(axis, ref_v)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(axis, t1)
    ang = np.linspace(0, 2 * np.pi, nseg, endpoint=False)
    ring = (np.outer(np.cos(ang), t1) + np.outer(np.sin(ang), t2)) * radius
    v = np.concatenate([np.asarray(p0) + ring,
                        np.asarray(p1) + ring]).astype(np.float32)
    f = []
    for i in range(nseg):
        j = (i + 1) % nseg
        f.append([i, j, nseg + j])
        f.append([i, nseg + j, nseg + i])
    return v, np.asarray(f, np.int32)


_SHAPES = ("obj", "ply", "serialized", "rectangle", "cube", "disk",
           "cylinder", "sphere", "shapegroup", "instance")


def _parse_shape(sh, defaults, base, ctx, meshes, spheres, vcolors):
    """Append a <shape>'s meshes (v, f, n, uv, material row, area radiance
    or None) to `meshes` (a mesh file's vertex colors to `vcolors` under
    its mesh index), or an analytic sphere (center, radius, material row)
    to `spheres`; a shapegroup is kept for its instances.  The material
    rows come in the reference loader's order (xml.py:732, 772-1036)."""
    stype = _subst(sh.get("type"), defaults)
    if stype not in _SHAPES:
        _unported(sh)
    _check_children(sh, _PROPERTY_TAGS + ("transform", "ref", "bsdf",
                                          "emitter", "shape"),
                    f" in <shape type={stype!r}>")
    props = _props(sh, defaults)
    tnode = sh.find("transform")
    m = (_parse_transform(tnode, defaults) if tnode is not None
         else np.eye(4, dtype=np.float32))
    mat_idx = _shape_material(sh, defaults, ctx)
    radiance = _area_radiance(sh, defaults)
    if stype in ("obj", "ply", "serialized"):
        v, f, n, uv, vcol = _mesh_file(props, base, load_mesh_ex)
        if props.get("faceNormals"):
            n = None
        v, n = _apply_transform(m, v, n)
        if vcol is not None:
            vcolors[len(meshes)] = vcol
        meshes.append((v, f, n, uv, mat_idx, radiance))
    elif stype in ("rectangle", "cube"):
        v, f, n, uv = _unit_rect() if stype == "rectangle" else _unit_cube()
        v, n = _apply_transform(m, v, n)
        meshes.append((v, f, n, uv, mat_idx, radiance))
    elif stype in ("disk", "cylinder"):
        v, f = _disk() if stype == "disk" else _cylinder(props)
        v, _ = _apply_transform(m, v, None)
        meshes.append((v, f, None, None, mat_idx, radiance))
    elif stype == "shapegroup":
        ctx["groups"][sh.get("id")] = sh.findall("shape")
    elif stype == "instance":
        gref = sh.find("ref")
        for child in ctx["groups"].get(
                gref.get("id") if gref is not None else None, []):
            cstype = _subst(child.get("type"), defaults)
            if cstype not in ("obj", "ply", "serialized", "rectangle",
                              "cube"):
                _unported(child, " in a <shape type='shapegroup'>")
            cprops = _props(child, defaults)
            cmat = _shape_material(child, defaults, ctx)
            crad = _area_radiance(child, defaults)
            ctnode = child.find("transform")
            cm = (_parse_transform(ctnode, defaults) if ctnode is not None
                  else np.eye(4, dtype=np.float32))
            if cstype == "rectangle":
                v, f, n, uv = _unit_rect()
            elif cstype == "cube":
                v, f, n, uv = _unit_cube()
            else:
                v, f, n, uv = _mesh_file(cprops, base, load_mesh)
            v, n = _apply_transform((m @ cm).astype(np.float32), v, n)
            meshes.append((v, f, n, uv, cmat, crad))
    else:
        center = props.get("center", np.zeros(3, np.float32))
        radius = float(props.get("radius", 1.0))
        center = (m[:3, :3] @ center + m[:3, 3]).astype(np.float32)
        radius = radius * float(np.linalg.norm(m[:3, 0]))
        if radiance is None:
            spheres.append((center, radius, mat_idx))
        else:
            v, f, n, uv = _unit_sphere_mesh()
            meshes.append(((v * radius + center).astype(np.float32), f, n,
                           uv, mat_idx, radiance))


def _parse_emitter(em, defaults, base, env):
    """A top-level <emitter>: a constant or an image (EXR) environment,
    the baked daylight, or a point, spot, directional or collimated
    light, into env (radiance, image, points, spots, directionals,
    collimated)."""
    etype = _subst(em.get("type"), defaults)
    _check_children(em, _PROPERTY_TAGS + ("transform",),
                    f" in <emitter type={etype!r}>")
    props = _props(em, defaults)
    tnode = em.find("transform")
    m = _parse_transform(tnode, defaults) if tnode is not None else None
    if etype == "constant":
        env["radiance"] = props.get("radiance", np.ones(3, np.float32))
    elif etype in ("point", "spot"):
        pos = props.get("position", np.zeros(3, np.float32))
        axis = np.asarray([0, 0, 1], np.float32)
        if m is not None:
            pos = m[:3, :3] @ pos + m[:3, 3]
            axis = m[:3, :3] @ axis
        inten = props.get("intensity", np.ones(3, np.float32))
        if etype == "spot":
            env["spots"].append(
                (pos, inten, axis, float(props.get("cutoffAngle", 20.0))))
        else:
            env["points"].append((pos, inten))
    elif etype == "collimated":
        d = np.asarray([0, 0, 1], np.float32)
        p = np.zeros(3, np.float32)
        if m is not None:
            d = m[:3, :3] @ d
            p = m[:3, :3] @ p + m[:3, 3]
        env["collimated"].append(
            (p, d, props.get("power", np.ones(3, np.float32))))
    elif etype == "directional":
        d = props.get("direction", np.asarray([0, 0, 1], np.float32))
        if m is not None:
            d = m[:3, :3] @ np.asarray([0, 0, 1], np.float32)
        env["directionals"].append(
            (d, props.get("irradiance", np.ones(3, np.float32))))
    elif etype in ("sky", "sun", "sunsky"):
        sd = props.get("sunDirection")
        if sd is None:
            sd = sun_direction_from_time(
                year=int(props.get("year", 2010)),
                month=int(props.get("month", 7)),
                day=int(props.get("day", 10)),
                hour=float(props.get("hour", 15.0)),
                latitude=float(props.get("latitude", 35.6894)),
                longitude=float(props.get("longitude", 139.6917)),
                timezone=float(props.get("timezone", 9.0)))
        scale = float(props.get("scale", 1.0))
        baked = bake_sky(
            turbidity=float(props.get("turbidity", 3.0)), sun_dir=sd,
            height=int(props.get("resolution", 512)) // 4,
            with_sky=etype != "sun", with_sun=etype != "sky",
            sky_scale=float(props.get("skyScale", 1.0)) * scale,
            sun_scale=float(props.get("sunScale", 1.0)) * scale,
            ground_albedo=float(np.mean(np.asarray(
                props.get("albedo", 0.15), np.float32))))
        env["image"] = baked if env["image"] is None else env["image"] + baked
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

    ctx = dict(materials=[], mat_by_id={}, textures=[], groups={})
    spheres: list = []
    meshes: list = []
    mesh_vcolors: dict = {}
    for b in root.findall("bsdf"):
        idx = _parse_bsdf(b, defaults, ctx)
        if b.get("id"):
            ctx["mat_by_id"][b.get("id")] = idx
    for sh in root.findall("shape"):
        _parse_shape(sh, defaults, base, ctx, meshes, spheres, mesh_vcolors)
    env = dict(radiance=np.zeros(3, np.float32), image=None, points=[],
               spots=[], directionals=[], collimated=[])
    for em in root.findall("emitter"):
        _parse_emitter(em, defaults, base, env)
    materials, textures = ctx["materials"], ctx["textures"]

    settings = RenderSettings(integrator=dict(type="path"))
    to_world, fov = np.eye(4, dtype=np.float32), 39.3077
    aperture, focus, kind, kc = 0.0, 1.0, st.CAMERA_PERSPECTIVE, None
    sensor = root.find("sensor")
    if sensor is not None:
        to_world, fov, aperture, focus, kind, kc = _parse_sensor(
            sensor, defaults, settings)
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

    vcolors = None
    if ctx.get("want_vcolors") and mesh_vcolors:
        vc = np.concatenate([
            mesh_vcolors.get(i, np.full((len(mv[0]), 3), 0.5, np.float32))
            for i, mv in enumerate(meshes)])
        vcolors = st._t(np.stack([vc[faces[:, 0]], vc[faces[:, 1]],
                                  vc[faces[:, 2]]], axis=1).astype(
                                      np.float32))
    rad_table = (np.stack(emitter_rads) if emitter_rads
                 else np.zeros((1, 3), np.float32))
    pts = env["points"]
    emitters = st.build_emitters(
        tris, rad_table, env_radiance=env["radiance"],
        point_pos=np.stack([p for p, _ in pts]) if pts else None,
        point_intensity=np.stack([i for _, i in pts]) if pts else None,
        directional=env["directionals"] or None, spots=env["spots"] or None,
        collimated=env["collimated"] or None, env_image=env["image"])
    st.set_emitter_rows(tris, emitters)

    camera = st.make_camera(
        to_world, fov if kind == st.CAMERA_PERSPECTIVE else 1.0,
        settings.width / settings.height, aperture, focus, kind=kind, kc=kc)
    scene = st.Scene(tris=tris,
                     spheres=(st.make_spheres(*zip(*spheres)) if spheres
                              else st.empty_spheres()),
                     materials=st.make_material_table(materials),
                     emitters=emitters, camera=camera,
                     textures=(st.TextureAtlas(data=st._t(np.stack(textures)))
                               if textures else None),
                     vcolors=vcolors)
    return scene, settings
