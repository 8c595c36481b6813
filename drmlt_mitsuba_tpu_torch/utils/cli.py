"""Renderer CLI for the port (counterpart of drmlt_mitsuba_tpu/utils/cli.py,
integrator=drmlt and integrator=pssmlt over the path and the MMLT
technique).

    python -m drmlt_mitsuba_tpu_torch.utils.cli \\
        tests/data/large/cornell_large.xml -D integrator=drmlt \\
        --chains 65536 -o cornell_large.exr
    python -m drmlt_mitsuba_tpu_torch.utils.cli cornell -D variant=orbital \\
        -D tallBox=glass --chains 65536 --spp 256 -s 0 -o cornell.exr
    python -m drmlt_mitsuba_tpu_torch.utils.cli veach -D technique=mmlt \\
        -D variant=orbital -D maxDepth=6 --chains 65536 --spp 256 -o veach.exr
    python -m drmlt_mitsuba_tpu_torch.utils.cli tests/data/cornell.xml \\
        -D integrator=pssmlt -D technique=mmlt --chains 65536 --spp 4096

The scene argument is a Mitsuba scene XML (scene/xml.py reads the ported
subset; `-D key=value` substitutes `$key`, and the film size, filter,
sampleCount and the integrator's properties come from the file) or a
built-in name: `cornell` (the 256x256 Cornell box, tall box `-D
tallBox=diffuse|mirror|glass`) or `veach` (the 256x256 veach-door scene),
whose integrator properties are the `-D` keys.  As in the reference CLI
(cli.py:134-140), every `-D` pair is also an integrator option unless the
file's integrator has that key (the file wins), and the integrator reads
the keys the reference reads:

  * integrator=drmlt, technique=path (cli.py:369-409) or technique=mmlt
    through the depth-grouped driver (cli.py:314-367);
  * integrator=pssmlt, technique=path or mmlt (the pooled MMLT trace with
    its pinned depth dim), through integrators/pssmlt.py (cli.py:60-108,
    445-478, 540-595): n_steps = W H spp / chains run in blocks of
    min(256, n_steps), so the steps run and the develop scale count whole
    blocks.

Keys the reference reads that the port does not honour yet raise, naming
the key: acceptanceMap, useMixture (drmlt), twoStage, separateDirect, and
grouped=false (drmlt over mmlt).  The chain kernel splats with a box filter
only: another filter raises.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from drmlt_mitsuba_tpu_torch.integrators.drmlt import (
    DRMLTConfig, render_drmlt_path,
)
from drmlt_mitsuba_tpu_torch.integrators.bidir import BDPTConfig
from drmlt_mitsuba_tpu_torch.integrators.layout import PathConfig
from drmlt_mitsuba_tpu_torch.integrators.mmlt import (
    make_mmlt_trace, mmlt_masks,
)
from drmlt_mitsuba_tpu_torch.integrators.mmlt_grouped import (
    render_drmlt_mmlt_grouped,
)
from drmlt_mitsuba_tpu_torch.integrators.path import make_path_trace
from drmlt_mitsuba_tpu_torch.integrators.pssmlt import (
    PSSMLTConfig, render_pssmlt,
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
        "acceptanceMap", "useMixture", "twoStage", "separateDirect")
# read by the reference for these integrators, not honoured by the port yet
UNPORTED = {"acceptanceMap": ("drmlt", "pssmlt"), "useMixture": ("drmlt",),
            "twoStage": ("drmlt", "pssmlt"),
            "separateDirect": ("drmlt", "pssmlt")}


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
    """(image (H, W, 3), aux) of the integrator `settings` and args.D name;
    aux["mutations"] counts the mutations run."""
    icfg = integrator_config(args, settings)
    itype = icfg.get("type")
    if itype not in ("drmlt", "pssmlt"):
        raise NotImplementedError(
            f"integrator {itype!r} not yet ported (drmlt, pssmlt; a scene "
            f"file may leave it to -D integrator=drmlt)")
    for key, types in UNPORTED.items():
        if itype in types and _pbool(icfg.get(key)):
            raise NotImplementedError(
                f"{key}: not yet ported (integrator {itype})")
    if settings.filter_name != "box":
        raise NotImplementedError(
            f"film filter {settings.filter_name!r} not yet ported: the chain "
            f"kernel splats with a box filter only")
    technique = icfg.get("technique", "path")
    if technique not in ("path", "mmlt"):
        raise NotImplementedError(
            f"technique {technique!r} not yet ported (path, mmlt)")
    if (itype == "drmlt" and technique == "mmlt"
            and not _pbool(icfg.get("grouped"), True)):
        raise NotImplementedError(
            "grouped=false: the pooled MMLT driver is not ported")
    n_chains = int(icfg.get("chains", args.chains))
    avg_lum = float(icfg.get("averageLuminance", -1))
    avg_lum = avg_lum if avg_lum > 0 else None
    W, H = settings.width, settings.height
    fc = filmlib.make_film_config(W, H, "box")
    spp = args.spp if args.spp is not None else settings.spp
    n_steps = max(1, W * H * spp // n_chains)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    if itype == "pssmlt":
        img, aux = _render_pssmlt(icfg, scene, fc, gen, n_chains, n_steps,
                                  avg_lum)
        aux["mutations"] = n_chains * aux["steps"]
        return img, aux
    cfg = DRMLTConfig(
        type=icfg.get("variant", "green"),
        n_chains=n_chains,
        p_large=float(icfg.get("pLarge", 0.3)),
        sigma=float(icfg.get("sigma", 1 / 64)),
        scale_second=float(icfg.get("scaleSecond", 0.1)),
        timid_after_large=_pbool(icfg.get("timidAfterLarge"), False),
        fix_emitter_path=_pbool(icfg.get("fixEmitterPath"), False),
        n_bootstrap=int(icfg.get("luminanceSamples", 100_000)),
        splat_mode=icfg.get("splatMode", "sampled"),
    )
    if technique == "mmlt":
        bcfg = BDPTConfig(max_depth=int(icfg.get("maxDepth", 5)),
                          light_image=_pbool(icfg.get("lightImage"), True),
                          thinlens=_thinlens(scene))
        img, aux = render_drmlt_mmlt_grouped(
            scene, bcfg, cfg, fc, gen, n_steps, average_luminance=avg_lum,
            min_group=max(64, min(1024, n_chains // 4)),
            equal_chains=_pbool(icfg.get("equalChains"), True))
        aux["mutations"] = sum(aux["sizes"][k - 1] * s
                               for k, s in aux["steps_eff"].items())
        return img, aux
    md = int(icfg.get("maxDepth", 8))
    pcfg = PathConfig(max_depth=md if md > 0 else 12, rr_depth=100,
                      min_depth=int(icfg.get("minDepth", 1)),
                      thinlens=_thinlens(scene))
    img, aux = render_drmlt_path(scene, pcfg, cfg, fc, gen, n_steps,
                                 average_luminance=avg_lum)
    aux["mutations"] = n_chains * aux["steps"]
    return img, aux


def _render_pssmlt(icfg, scene, fc, gen, n_chains, n_steps, avg_lum):
    """integrator=pssmlt over the path or the pooled MMLT trace
    (cli.py:60-108 build_trace, 445-478, 540-595): no Russian roulette
    inside MCMC (rr_depth 100), an even PSS dimension, and the steps of
    whole blocks of min(256, n_steps)."""
    md = int(icfg.get("maxDepth", 8))
    md = md if md > 0 else 12
    pinned = None
    if icfg.get("technique", "path") == "mmlt":
        bcfg = BDPTConfig(max_depth=md,
                          light_image=_pbool(icfg.get("lightImage"), True),
                          thinlens=_thinlens(scene))
        _, pinned, n_dims = mmlt_masks(bcfg, device=gen.device)
        trace = make_mmlt_trace(scene, bcfg, gen.device)
    else:
        pcfg = PathConfig(max_depth=md, rr_depth=100,
                          min_depth=int(icfg.get("minDepth", 1)),
                          thinlens=_thinlens(scene))
        n_dims = pcfg.n_dims + pcfg.n_dims % 2
        trace = make_path_trace(scene, pcfg, gen.device)
    mcfg = PSSMLTConfig(
        n_chains=n_chains,
        p_large=float(icfg.get("pLarge", 0.3)),
        kelemen_style_mutation=_pbool(icfg.get("kelemenStyleMutation"),
                                      True),
        kelemen_style_weights=_pbool(icfg.get("kelemenStyleWeights"), True),
        mutation_size_low=float(icfg.get("mutationSizeLow", 1 / 1024)),
        mutation_size_high=float(icfg.get("mutationSizeHigh", 1 / 64)),
        sigma=float(icfg.get("sigma", 1 / 64)),
        n_bootstrap=int(icfg.get("luminanceSamples", 100_000)),
        p_lens=float(icfg.get("pLens", 0.0)),
        p_caustic=float(icfg.get("pCaustic", 0.0)),
        lens_sigma=float(icfg.get("lensSigma", 1 / 16)),
        caustic_dims=int(icfg.get("causticDims", 7)),
    )
    block = max(1, min(PSSMLT_BLOCK, n_steps))
    done = -(-n_steps // block) * block
    return render_pssmlt(trace, mcfg, fc, gen, n_dims, done,
                         average_luminance=avg_lum, pinned_mask=pinned)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="drmlt-torch",
        description="DRMLT and PSSMLT renderer (path and MMLT techniques) on "
                    "PyTorch + CUDA")
    ap.add_argument("scene", help="Mitsuba scene XML, or a built-in scene "
                                  "name (cornell, veach)")
    ap.add_argument("-D", action="append", default=[], metavar="key=value",
                    help="$key substitution in a scene XML; for a built-in "
                         "scene an integrator parameter (" + ", ".join(KEYS)
                         + ")")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("--chains", type=int, default=16384,
                    help="MCMC chains (an integrator's `chains` wins)")
    ap.add_argument("--spp", type=int, default=None,
                    help="mutations per pixel (default: the file's "
                         f"sampleCount; {BUILTIN_SPP} for a built-in scene)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain twins)")
    args = ap.parse_args(argv)
    defs = dict(kv.split("=", 1) for kv in args.D)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    output = args.output or args.scene.rsplit(".", 1)[0] + ".exr"

    scene, settings = load_scene(args.scene, defs)
    print(f"scene: {scene.tris.v0.shape[0]} triangles"
          + (f", BVH of {scene.bvh.count.shape[0]} nodes"
             if scene.bvh is not None else "")
          + f", {settings.width}x{settings.height} film")
    t0 = time.time()
    img, aux = render(args, scene, settings, device)
    img = img.cpu().numpy()
    dt = time.time() - t0
    muts = aux["mutations"]
    print(f"b = {float(aux['b']):.6f}, {muts} mutations in {dt:.2f} s on "
          f"{device} ({muts / dt:.4e} mutations/s, bootstrap included)")
    if "steps_per_group" in aux:
        print(f"b_k {aux['b_k']}, steps per depth group "
              f"{aux['steps_per_group']}, chains {aux['sizes']}")
    else:
        st = {k: float(v.float().mean()) for k, v in aux["stats"].items()}
        print(f"{aux['steps']} steps; stats {st}")
    if not np.all(np.isfinite(img)):
        raise SystemExit("render produced non-finite pixels")
    write_exr(output, img)
    print(f"wrote {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
