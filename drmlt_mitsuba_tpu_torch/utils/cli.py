"""Renderer CLI for the port (counterpart of drmlt_mitsuba_tpu/utils/cli.py:
integrator=drmlt and integrator=pssmlt over the path, MMLT and BDPT
techniques, the Monte-Carlo integrators path, volpath, volpath_simple,
direct and bdpt under any sampler, and the forward renderers ptracer,
field, multichannel and motion).

    python -m drmlt_mitsuba_tpu_torch.utils.cli \\
        tests/data/large/cornell_large.xml -D integrator=drmlt \\
        --chains 65536 -o cornell_large.exr
    python -m drmlt_mitsuba_tpu_torch.utils.cli cornell -D variant=orbital \\
        -D tallBox=glass --chains 65536 --spp 256 -s 0 -o cornell.exr
    python -m drmlt_mitsuba_tpu_torch.utils.cli veach -D technique=mmlt \\
        -D variant=orbital -D maxDepth=6 --chains 65536 --spp 256 -o veach.exr
    python -m drmlt_mitsuba_tpu_torch.utils.cli tests/data/cornell.xml \\
        -D integrator=pssmlt -D technique=mmlt --chains 65536 --spp 4096 \\
        -t 60 -r 10 -o cornell_pssmlt.exr
    python -m drmlt_mitsuba_tpu_torch.utils.cli tests/data/cornell.xml \\
        -D integrator=field -D field=albedo -o cornell_albedo.npy

The scene argument is a Mitsuba scene XML (scene/xml.py reads the ported
subset; `-D key=value` substitutes `$key`, and the film size, filter,
sampler, sampleCount and the integrator's properties come from the file; a
file without <integrator> renders as integrator=path) or a built-in name:
`cornell` (the 256x256 Cornell box, tall box `-D
tallBox=diffuse|mirror|glass`) or `veach` (the 256x256 veach-door scene),
whose integrator properties are the `-D` keys.  As in the reference CLI
(cli.py:134-140), every `-D` pair is also an integrator option unless the
file's integrator has that key (the file wins), and the integrator reads
the keys the reference reads:

  * integrator=path|volpath|volpath_simple|direct: render_pt in accum mode
    under the file's <sampler> (cli.py:150-163);
  * integrator=ptracer (maxDepth 5), field (field = shnormal),
    multichannel (channels = radiance,shnormal,distance,albedo) and motion
    (integrators/misc.py; cli.py:165-196);
  * integrator=bdpt: W H spp samples of integrators/bidir.py:trace_bdpt in
    chunks of 8,192, every splat (the pixel's and the light image's) into
    a splat-mode film (cli.py:197-225);
  * integrator=drmlt, technique=path (cli.py:369-409) or technique=mmlt
    through the depth-grouped driver (cli.py:314-367), with
    acceptanceMap, useMixture and any reconstruction filter;
  * the reference's generic MCMC loop (cli.py:60-108, 413-600) for
    integrator=pssmlt, for drmlt with technique=bdpt, and for drmlt with
    twoStage, separateDirect, acceptanceMap or useMixture over the path
    technique or with grouped=false over the pooled MMLT trace: n_steps =
    W H spp / chains run in blocks of min(256, n_steps), so the steps run
    and the develop scale count whole blocks.  `-t` stops it between
    blocks and `-r` writes <out>_<part>.exr and <out>_time.csv there; the
    clock starts before the render, bootstrap included.

A scene with a thin lens renders MMLT through the bidirectional wavefront
(integrators/bidir.py:trace_mmlt_wavefront), grouped and pooled: the MMLT
kernel excludes the lens, as the reference's does.

main writes the image as EXR (a multichannel render's channels as EXR
layers) or .npy, <out>_stats.txt with the generic loop's acceptance
report (empty elsewhere, as in the reference), and with acceptanceMap
<out>_acceptance.exr whenever the reference does, pssmlt's all-zero map
included.  What the port does not render yet raises, naming it: erpt,
mlt and PNG output; an unknown technique exits, as in the reference
(cli.py:108).
"""
from __future__ import annotations

import argparse
import csv
import logging
import os
import sys
import time

import numpy as np
import torch

from drmlt_mitsuba_tpu_torch.core.logger import (
    LOGGER, dump_config, setup_logging,
)
from drmlt_mitsuba_tpu_torch.core.rng import uniform
from drmlt_mitsuba_tpu_torch.core.stats import Statistics
from drmlt_mitsuba_tpu_torch.integrators.bidir import (
    BDPTConfig, make_bdpt_trace,
)
from drmlt_mitsuba_tpu_torch.integrators.drmlt import (
    DRMLTConfig, render_drmlt, render_drmlt_path,
)
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.misc import (
    render_field, render_motion_aov, render_multichannel, render_ptracer,
)
from drmlt_mitsuba_tpu_torch.integrators.mmlt import (
    make_mmlt_trace, mmlt_emitter_mask, mmlt_lt_mask_fn, mmlt_masks,
)
from drmlt_mitsuba_tpu_torch.integrators.mmlt_grouped import (
    render_drmlt_mmlt_grouped,
)
from drmlt_mitsuba_tpu_torch.integrators.path import (
    make_path_trace, render_pt,
)
from drmlt_mitsuba_tpu_torch.integrators.pssmlt import (
    PSSMLTConfig, render_pssmlt,
)
from drmlt_mitsuba_tpu_torch.integrators.twostage import (
    apply_importance_to_image, luminance_pass, with_importance_map,
)
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box, veach_door
from drmlt_mitsuba_tpu_torch.scene.types import prepare_scene
from drmlt_mitsuba_tpu_torch.scene.xml import RenderSettings, load_scene_xml
from drmlt_mitsuba_tpu_torch.utils.exr import write_exr

SIZE = 256      # film width and height of the built-in scenes
BUILTIN_SPP = 16
PSSMLT_BLOCK = 256   # the reference CLI's step block (cli.py:542)
KEYS = ("integrator", "technique", "variant", "pLarge", "sigma",
        "scaleSecond", "timidAfterLarge", "luminanceSamples", "splatMode",
        "maxDepth", "minDepth", "tallBox", "lightImage", "fixEmitterPath",
        "equalChains", "grouped", "chains", "averageLuminance",
        "kelemenStyleMutation", "kelemenStyleWeights", "mutationSizeLow",
        "mutationSizeHigh", "pLens", "pCaustic", "lensSigma", "causticDims",
        "acceptanceMap", "useMixture", "twoStage", "separateDirect",
        "directSamples", "field", "channels")
# the sampling integrators, rendered by render_pt in accum mode
PT_TYPES = ("path", "volpath", "volpath_simple", "direct")
# the forward renderers of integrators/misc.py
MISC_TYPES = ("ptracer", "field", "multichannel", "motion")
BDPT_CHUNK = 8192    # samples per trace_bdpt call of integrator=bdpt
PTRACER_CHUNK = 8192  # and of render_ptracer


def _pbool(v, default=False):
    """A `-D key=false` string as a bool (bool("false") is truthy)."""
    if v is None:
        return default
    if isinstance(v, bool):
        return v
    return v.strip().lower() in ("true", "1", "yes", "on")


def load_scene(name: str, defs: dict):
    """(Scene with its BVH attached above BVH_MIN_TRIS triangles,
    RenderSettings) of a scene XML or a built-in name."""
    if name.endswith(".xml"):
        scene, settings = load_scene_xml(name, defs)
        return prepare_scene(scene), settings
    unknown = sorted(set(defs) - set(KEYS))
    if unknown:
        raise SystemExit(f"unknown -D keys {unknown}; known: {list(KEYS)}")
    settings = RenderSettings(
        integrator={"type": "drmlt", **{k: v for k, v in defs.items()
                                        if k != "integrator"}},
        width=SIZE, height=SIZE, filter_name="box", spp=BUILTIN_SPP)
    if "integrator" in defs:
        settings.integrator["type"] = defs["integrator"]
    if name == "veach":
        return veach_door(SIZE, SIZE), settings
    if name != "cornell":
        raise SystemExit(f"unknown built-in scene {name!r} (have: cornell, "
                         f"veach) and not a .xml file")
    return cornell_box(SIZE, SIZE, tall_box_material=defs.get(
        "tallBox", "diffuse")), settings


def _thinlens(scene) -> bool:
    """True when the camera has a lens (aperture > 0): the traces then read
    the lens dims (the reference CLI's cli.py:42)."""
    return float(scene.camera.aperture_radius) > 0.0


def integrator_config(args, settings: RenderSettings) -> dict:
    """The integrator's options: the scene's, and every `-D key=value` of
    args.D the scene's integrator has no key for (cli.py:134-140)."""
    icfg = dict(settings.integrator)
    for kv in getattr(args, "D", None) or []:
        k, _, v = kv.partition("=")
        icfg.setdefault(k, v)
    return icfg


def render(args, scene, settings: RenderSettings, device):
    """(image (H, W, 3), aux) of the integrator `settings` and args.D name.

    aux["mutations"] counts the mutations run (aux["samples"] the paths of
    a sampling integrator), aux["accmap"] is the (H, W, 4) acceptance map
    that main writes as <out>_acceptance.exr, or None, and
    aux["statistics"] the report (core/stats.py) main writes as
    <out>_stats.txt: the generic loop's acceptance rates, empty elsewhere.
    Routes, as in the reference CLI:
      * path | volpath | volpath_simple | direct: `_render_pt`;
      * ptracer | field | multichannel | motion: `_render_misc`;
      * bdpt: `_render_bdpt`;
      * drmlt over mmlt, grouped (the default) and neither twoStage nor
        separateDirect set: the depth-grouped driver (cli.py:314-367),
        whose groups run the generic step under acceptanceMap, useMixture,
        a filter other than box or a thin lens;
      * drmlt over path with none of acceptanceMap, useMixture, twoStage
        and separateDirect: render_drmlt_path (cli.py:369-409; a filter
        other than box sends it to render_drmlt);
      * everything else, pssmlt and technique=bdpt included:
        `_render_mcmc`, the one route `args.timeout` (-t) and
        `args.refresh` (-r) act on, as in the reference.
    Every boolean key is read as a bool, so `-D twoStage=false` is false;
    the reference tests twoStage, separateDirect (cli.py:317-318, 372-373)
    and the acceptance map's film (cli.py:539) by the raw string, so
    there "false" also sends a render to its generic loop, an estimator of
    the same image."""
    t_start = time.time()
    icfg = integrator_config(args, settings)
    itype = icfg.get("type")
    W, H = settings.width, settings.height
    fc = filmlib.make_film_config(W, H, settings.filter_name)
    spp = args.spp if args.spp is not None else settings.spp
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    dump_config(logging.getLogger(LOGGER), itype, icfg)
    img, aux = _route(args, icfg, itype, scene, settings, fc, gen, spp,
                      t_start)
    aux.setdefault("statistics", Statistics())
    return img, aux


def _route(args, icfg, itype, scene, settings, fc, gen, spp, t_start):
    """The integrator's render (see `render`)."""
    W, H = fc.width, fc.height
    if itype in PT_TYPES:
        return _render_pt(icfg, itype, scene, settings.sampler, fc, gen, spp)
    if itype in MISC_TYPES:
        return _render_misc(icfg, itype, scene, fc, gen, spp)
    if itype == "bdpt":
        return _render_bdpt(icfg, scene, fc, gen, spp)
    if itype not in ("drmlt", "pssmlt"):
        raise NotImplementedError(
            f"integrator {itype!r} not yet ported (drmlt, pssmlt, bdpt, "
            f"{', '.join(PT_TYPES + MISC_TYPES)})")
    technique = icfg.get("technique", "path")
    if technique not in ("path", "mmlt", "bdpt"):
        raise SystemExit(f"unknown technique '{technique}'")
    n_chains = int(icfg.get("chains", args.chains))
    avg_lum = float(icfg.get("averageLuminance", -1))
    avg_lum = avg_lum if avg_lum > 0 else None
    n_steps = max(1, W * H * spp // n_chains)
    staged = (_pbool(icfg.get("twoStage"))
              or _pbool(icfg.get("separateDirect")))
    if (itype == "drmlt" and technique == "mmlt"
            and _pbool(icfg.get("grouped"), True) and not staged):
        bcfg = BDPTConfig(max_depth=int(icfg.get("maxDepth", 5)),
                          light_image=_pbool(icfg.get("lightImage"), True),
                          thinlens=_thinlens(scene))
        img, aux = render_drmlt_mmlt_grouped(
            scene, bcfg, _drmlt_config(icfg, n_chains, grouped=True), fc,
            gen, n_steps, average_luminance=avg_lum,
            min_group=max(64, min(1024, n_chains // 4)),
            equal_chains=_pbool(icfg.get("equalChains"), True))
        aux["mutations"] = sum(aux["sizes"][k - 1] * s
                               for k, s in aux["steps_eff"].items())
        return img, aux
    if (itype == "drmlt" and technique == "path" and not staged
            and not _pbool(icfg.get("acceptanceMap"))
            and not _pbool(icfg.get("useMixture"))):
        md = int(icfg.get("maxDepth", 8))
        pcfg = PathConfig(max_depth=md if md > 0 else 12, rr_depth=100,
                          min_depth=int(icfg.get("minDepth", 1)),
                          thinlens=_thinlens(scene))
        img, aux = render_drmlt_path(scene, pcfg,
                                     _drmlt_config(icfg, n_chains), fc, gen,
                                     n_steps, average_luminance=avg_lum)
        aux["mutations"] = n_chains * aux["steps"]
        aux["accmap"] = None
        return img, aux
    block = max(1, min(PSSMLT_BLOCK, n_steps))
    img, aux = _render_mcmc(icfg, itype, technique, scene, fc, gen,
                            n_chains, -(-n_steps // block) * block, avg_lum,
                            _block_hook(args, t_start, block))
    aux["mutations"] = n_chains * aux["steps"]
    aux["statistics"] = Statistics()
    aux["statistics"].record_mcmc(aux["stats"], n_chains)
    return img, aux


def _drmlt_config(icfg, n_chains: int, grouped: bool = False):
    """The DRMLT options the grouped and the path driver read (cli.py:
    336-355, 382-398): the grouped one also takes acceptanceMap,
    useMixture and fixEmitterPath."""
    extra = {}
    if grouped:
        extra = dict(
            acceptance_map=_pbool(icfg.get("acceptanceMap"), False),
            use_mixture=_pbool(icfg.get("useMixture"), False),
            fix_emitter_path=_pbool(icfg.get("fixEmitterPath"), False))
    return DRMLTConfig(
        type=icfg.get("variant", "green"),
        n_chains=n_chains,
        p_large=float(icfg.get("pLarge", 0.3)),
        sigma=float(icfg.get("sigma", 1 / 64)),
        scale_second=float(icfg.get("scaleSecond", 0.1)),
        timid_after_large=_pbool(icfg.get("timidAfterLarge"), False),
        n_bootstrap=int(icfg.get("luminanceSamples", 100_000)),
        splat_mode=icfg.get("splatMode", "sampled"), **extra)


def _render_pt(icfg, itype, scene, sampler, fc, gen, spp):
    """integrator=path|volpath|volpath_simple|direct (cli.py:150-163):
    W H spp paths of render_pt under the sampler (an unknown one raises
    ValueError) in accum mode at maxDepth (2 for direct), no Russian
    roulette (rr_depth 100), developed in accum mode."""
    depth = 2 if itype == "direct" else int(icfg.get("maxDepth", 8))
    pcfg = PathConfig(max_depth=max(1, depth), rr_depth=100,
                      thinlens=_thinlens(scene))
    n = fc.width * fc.height * spp
    film = render_pt(scene, pcfg, gen, n, fc, mode="accum", sampler=sampler)
    return (filmlib.develop(fc, film, mode="accum"),
            dict(samples=n, accmap=None))


def _render_misc(icfg, itype, scene, fc, gen, spp):
    """integrator=ptracer|field|multichannel|motion (cli.py:165-196), with
    the reference's keys and defaults: ptracer W H spp light paths at
    maxDepth (5); field the `field` AOV (shnormal); multichannel the
    comma-separated `channels` (radiance,shnormal,distance,albedo), the
    radiance pass at spp paths a pixel; field and motion at spp samples a
    pixel (spp at least 1)."""
    spp = max(1, spp)
    n = fc.npixels * spp
    aux = dict(samples=n, accmap=None)
    if itype == "ptracer":
        img = render_ptracer(scene, fc, gen, n,
                             max_depth=max(1, int(icfg.get("maxDepth", 5))),
                             chunk=PTRACER_CHUNK)
        aux["samples"] = max(1, n // PTRACER_CHUNK) * PTRACER_CHUNK
    elif itype == "field":
        img = render_field(scene, fc, gen, icfg.get("field", "shnormal"),
                           spp=spp)
    elif itype == "multichannel":
        chans = tuple(icfg.get("channels",
                               "radiance,shnormal,distance,albedo").split(","))
        img = render_multichannel(scene, fc, gen, channels=chans,
                                  radiance_spp=spp)
        aux["layers"] = chans
    else:
        img = render_motion_aov(scene, fc, gen, spp=spp)
    return img, aux


def _render_bdpt(icfg, scene, fc, gen, spp):
    """integrator=bdpt (cli.py:197-225): W H spp samples of trace_bdpt at
    maxDepth (5), lightImage, in n_chunks = max(1, W H spp // 8192) chunks
    of 8,192; every splat goes into a splat-mode film, developed with
    scale W H / (n_chunks 8192)."""
    bcfg = BDPTConfig(max_depth=int(icfg.get("maxDepth", 5)),
                      light_image=_pbool(icfg.get("lightImage"), True),
                      thinlens=_thinlens(scene))
    trace = make_bdpt_trace(scene, bcfg, gen.device)
    W, H = fc.width, fc.height
    n_chunks = max(1, W * H * spp // BDPT_CHUNK)
    scale = torch.tensor([W, H], dtype=torch.float32, device=gen.device)
    film = filmlib.new_film(fc, gen.device)
    for _ in range(n_chunks):
        sp = trace(uniform((BDPT_CHUNK, bcfg.n_dims), gen))
        film = filmlib.splat(fc, film, sp.pos.reshape(-1, 2) * scale,
                             sp.value.reshape(-1, 3), mode="splat")
    n = n_chunks * BDPT_CHUNK
    return (filmlib.develop(fc, film, mode="splat", scale=W * H / n),
            dict(samples=n, accmap=None))


def _block_hook(args, t_start, block):
    """The generic loop's per-step hook for -t / -r (cli.py:567-579), or
    None without them.  It acts only after each block of `block` steps:
    past `args.timeout` seconds since t_start the render stops; else,
    `args.refresh` seconds after the last dump (or the loop's first step,
    where the reference counts from the loop's start), main's partial
    image goes to <out>_<part>.exr and the dump times to
    <out>_time.csv."""
    timeout = getattr(args, "timeout", 0) or 0
    refresh = getattr(args, "refresh", 0) or 0
    if not timeout and not refresh:
        return None
    log = logging.getLogger(LOGGER)
    dumps = dict(times=[])      # "last": the last dump or the first step

    def hook(done, develop):
        dumps.setdefault("last", time.time())
        if done % block:
            return False
        if timeout and time.time() - t_start > timeout:
            log.info("timeout reached after %d steps", done)
            return True
        if refresh and time.time() - dumps["last"] > refresh:
            write_partial(args.output, develop(), len(dumps["times"]),
                          time.time() - t_start, dumps["times"])
            dumps["last"] = time.time()
        return False

    return hook


def write_partial(output, img, part, elapsed, times):
    """<base>_<part>.exr of a partial image, and <base>_time.csv rewritten
    with every dump's (part, seconds) (cli.py:616-626)."""
    base, _ = os.path.splitext(output)
    write_exr(f"{base}_{part}.exr", img.cpu().numpy())
    times.append((part, elapsed))
    with open(f"{base}_time.csv", "w", newline="") as f:
        csv.writer(f).writerows(times)


def _render_mcmc(icfg, itype, technique, scene, fc, gen, n_chains, n_steps,
                 avg_lum, on_step=None):
    """The reference CLI's generic MCMC loop (cli.py:60-108 build_trace,
    413-600): pssmlt, or drmlt through the generic step, over the path,
    the pooled MMLT trace (its depth dim pinned, its strategy dim frozen,
    fixEmitterPath's masks) or trace_bdpt (1 + n_light splats a sample,
    nothing frozen or pinned), no Russian roulette (rr_depth 100), an even
    PSS dimension; n_steps comes in whole blocks (`_route`).

    separateDirect (path only): a render_pt pass at depth 2 with
    directSamples (16) paths a pixel, added at develop, and the MCMC trace
    at min_depth 3 (cli.py:416-428).  twoStage: a 1/16-resolution box
    render_pt at 64 paths a pixel gives the importance map; the trace's
    splats are divided by it, the image multiplied back, and Kelemen's
    weights are off (cli.py:430-444, 466).  The reference's loop runs
    drmlt_step whatever useMixture says (cli.py:520-524), and so does
    this one.  With acceptanceMap the aux carries the map, pssmlt's the
    zero film the reference allocates and no step splats into (cli.py:
    539).  `on_step(done, develop)` runs after each step (see
    `_block_hook`); its partial images carry the importance map and the
    direct pass, as the final image does."""
    dev = gen.device
    md = int(icfg.get("maxDepth", 8))
    md = md if md > 0 else 12
    frozen = pinned = None
    extras = {}
    if technique == "mmlt":
        bcfg = BDPTConfig(max_depth=md,
                          light_image=_pbool(icfg.get("lightImage"), True),
                          thinlens=_thinlens(scene))
        frozen, pinned, n_dims = mmlt_masks(bcfg, device=dev)
        trace = make_mmlt_trace(scene, bcfg, dev)
        extras = dict(emitter_mask=mmlt_emitter_mask(bcfg, n_dims, dev),
                      lt_mask_fn=mmlt_lt_mask_fn(bcfg))
    elif technique == "bdpt":
        bcfg = BDPTConfig(max_depth=md,
                          light_image=_pbool(icfg.get("lightImage"), True),
                          thinlens=_thinlens(scene))
        n_dims = bcfg.n_dims + bcfg.n_dims % 2
        trace = make_bdpt_trace(scene, bcfg, dev)
    else:
        pcfg = PathConfig(max_depth=md, rr_depth=100,
                          min_depth=int(icfg.get("minDepth", 1)),
                          thinlens=_thinlens(scene))
        n_dims = pcfg.n_dims + pcfg.n_dims % 2
        trace = make_path_trace(scene, pcfg, dev)
    W, H = fc.width, fc.height
    direct_img = None
    if _pbool(icfg.get("separateDirect")) and technique == "path":
        dfilm = render_pt(scene, PathConfig(max_depth=2, rr_depth=100), gen,
                          W * H * int(icfg.get("directSamples", 16)), fc,
                          mode="accum")
        direct_img = filmlib.develop(fc, dfilm, mode="accum")
        trace = make_path_trace(scene, PathConfig(
            max_depth=int(icfg.get("maxDepth", 8)), rr_depth=100,
            min_depth=3), dev)
    imap = None
    if _pbool(icfg.get("twoStage")):
        def lowres(w, h):
            fc2 = filmlib.make_film_config(w, h, "box")
            f2 = render_pt(scene, PathConfig(
                max_depth=int(icfg.get("maxDepth", 8)), rr_depth=100), gen,
                w * h * 64, fc2, mode="accum")
            return filmlib.develop(fc2, f2, mode="accum")

        imap = luminance_pass(lowres, fc)
        trace = with_importance_map(trace, imap)

    def finish(img):
        if imap is not None:
            img = apply_importance_to_image(img, imap)
        if direct_img is not None:
            img = img + direct_img
        return img

    hook = None if on_step is None else (
        lambda done, develop: on_step(done, lambda: finish(develop())))
    n_boot = int(icfg.get("luminanceSamples", 100_000))
    if itype == "pssmlt":
        mcfg = PSSMLTConfig(
            n_chains=n_chains,
            p_large=float(icfg.get("pLarge", 0.3)),
            kelemen_style_mutation=_pbool(icfg.get("kelemenStyleMutation"),
                                          True),
            kelemen_style_weights=_pbool(icfg.get("kelemenStyleWeights"),
                                         True) and imap is None,
            mutation_size_low=float(icfg.get("mutationSizeLow", 1 / 1024)),
            mutation_size_high=float(icfg.get("mutationSizeHigh", 1 / 64)),
            sigma=float(icfg.get("sigma", 1 / 64)),
            n_bootstrap=n_boot,
            p_lens=float(icfg.get("pLens", 0.0)),
            p_caustic=float(icfg.get("pCaustic", 0.0)),
            lens_sigma=float(icfg.get("lensSigma", 1 / 16)),
            caustic_dims=int(icfg.get("causticDims", 7)),
        )
        img, aux = render_pssmlt(trace, mcfg, fc, gen, n_dims, n_steps,
                                 average_luminance=avg_lum,
                                 pinned_mask=pinned, on_step=hook)
    else:
        variant = icfg.get("variant", "green")
        if variant not in ("green", "mira", "orbital"):
            logging.getLogger(__name__).warning(
                "unknown drmlt type '%s', using green", variant)
            variant = "green"
        dcfg = DRMLTConfig(
            type=variant,
            n_chains=n_chains,
            p_large=float(icfg.get("pLarge", 0.3)),
            sigma=float(icfg.get("sigma", 1 / 64)),
            scale_second=float(icfg.get("scaleSecond", 0.1)),
            timid_after_large=_pbool(icfg.get("timidAfterLarge"), False),
            acceptance_map=_pbool(icfg.get("acceptanceMap"), False),
            fix_emitter_path=_pbool(icfg.get("fixEmitterPath"), False),
            n_bootstrap=n_boot,
        )
        img, aux = render_drmlt(trace, dcfg, fc, gen, n_dims, n_steps,
                                frozen_mask=frozen, average_luminance=avg_lum,
                                pinned_mask=pinned, on_step=hook, **extras)
    img = finish(img)
    if _pbool(icfg.get("acceptanceMap")) and aux.get("accmap") is None:
        aux["accmap"] = filmlib.new_film(fc, dev)
    aux.setdefault("accmap", None)
    return img, aux


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="drmlt-torch",
        description="DRMLT, PSSMLT, BDPT and forward renderers (path, MMLT "
                    "and BDPT techniques) on PyTorch + CUDA")
    ap.add_argument("scene", help="Mitsuba scene XML, or a built-in scene "
                                  "name (cornell, veach)")
    ap.add_argument("-D", action="append", default=[], metavar="key=value",
                    help="$key substitution in a scene XML; for a built-in "
                         "scene an integrator parameter (" + ", ".join(KEYS)
                         + ")")
    ap.add_argument("-o", "--output", default=None,
                    help="output image: .exr (default) or .npy")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="no log output on stdout")
    ap.add_argument("-L", "--log-level", default="info",
                    help="log level (debug, info, warning, error)")
    ap.add_argument("-r", "--refresh", type=float, default=0,
                    help="write partial images every N seconds, with "
                         "<out>_time.csv (the generic MCMC loop)")
    ap.add_argument("-t", "--timeout", type=float, default=0,
                    help="stop the generic MCMC loop after N seconds")
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("-x", "--skip-existing", action="store_true",
                    help="do nothing when the output exists")
    ap.add_argument("-z", "--no-progress", action="store_true",
                    help="accepted for the reference's flag; the port "
                         "prints no progress bar")
    ap.add_argument("--chains", type=int, default=16384,
                    help="MCMC chains (an integrator's `chains` wins)")
    ap.add_argument("--spp", type=int, default=None,
                    help="mutations per pixel (default: the file's "
                         f"sampleCount; {BUILTIN_SPP} for a built-in scene)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain twins)")
    args = ap.parse_args(argv)
    args.output = args.output or os.path.splitext(args.scene)[0] + ".exr"
    if args.skip_existing and os.path.exists(args.output):
        print(f"{args.output} exists, skipping (-x)")
        return 0
    if args.output.endswith(".png"):
        raise NotImplementedError("PNG output not yet ported (it needs PIL): "
                                  "write .exr or .npy")
    log = setup_logging(args.log_level, quiet=args.quiet)
    defs = dict(kv.split("=", 1) for kv in args.D)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    scene, settings = load_scene(args.scene, defs)
    log.info("scene: %d triangles%s, %dx%d film", scene.tris.v0.shape[0],
             f", BVH of {scene.bvh.count.shape[0]} nodes"
             if scene.bvh is not None else "", settings.width,
             settings.height)
    t0 = time.time()
    img, aux = render(args, scene, settings, device)
    img = img.cpu().numpy()
    dt = time.time() - t0
    if "samples" in aux:
        n = aux["samples"]
        log.info("%d paths in %.2f s on %s (%.4e paths/s)", n, dt, device,
                 n / dt)
    else:
        muts = aux["mutations"]
        log.info("b = %.6f, %d mutations in %.2f s on %s (%.4e mutations/s, "
                 "bootstrap included)", float(aux["b"]), muts, dt, device,
                 muts / dt)
        if "steps_per_group" in aux:
            log.info("b_k %s, steps per depth group %s, chains %s",
                     aux["b_k"], aux["steps_per_group"], aux["sizes"])
        else:
            st = {k: float(v.float().mean()) for k, v in aux["stats"].items()}
            log.info("%d steps; stats %s", aux["steps"], st)
    if not np.all(np.isfinite(img)):
        raise SystemExit("render produced non-finite pixels")
    if args.output.endswith(".npy"):
        np.save(args.output, img)
    else:
        write_exr(args.output, img, layers=aux.get("layers"))
    log.info("wrote %s", args.output)
    base, _ = os.path.splitext(args.output)
    if aux["accmap"] is not None:
        write_exr(f"{base}_acceptance.exr", aux["accmap"][..., :3].cpu()
                  .numpy())
        log.info("wrote %s_acceptance.exr", base)
    report = aux["statistics"].report()
    with open(f"{base}_stats.txt", "w") as f:
        f.write(report + "\n")
    print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
