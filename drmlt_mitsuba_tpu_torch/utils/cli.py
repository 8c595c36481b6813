"""Renderer CLI for the port (counterpart of drmlt_mitsuba_tpu/utils/cli.py,
integrator=drmlt over the path and the MMLT technique).

    python -m drmlt_mitsuba_tpu_torch.utils.cli \\
        tests/data/large/cornell_large.xml -D integrator=drmlt \\
        --chains 65536 -o cornell_large.exr
    python -m drmlt_mitsuba_tpu_torch.utils.cli cornell -D variant=orbital \\
        -D tallBox=glass --chains 65536 --spp 256 -s 0 -o cornell.exr
    python -m drmlt_mitsuba_tpu_torch.utils.cli veach -D technique=mmlt \\
        -D variant=orbital -D maxDepth=6 --chains 65536 --spp 256 -o veach.exr

    python -m drmlt_mitsuba_tpu_torch.utils.cli tests/data/cornell.xml \
        -D integrator=drmlt -D technique=mmlt --chains 65536 --spp 4096

The scene argument is a Mitsuba scene XML (scene/xml.py reads the ported
subset; `-D key=value` substitutes `$key`, and the film size, filter,
sampleCount and the integrator's properties come from the file, as in the
reference CLI, cli.py:667-672) or a built-in name: `cornell` (the 256x256
Cornell box, tall box `-D tallBox=diffuse|mirror|glass`) or `veach` (the
256x256 veach-door scene), whose integrator properties are the `-D` keys.
Those are the ones the reference CLI reads for integrator=drmlt with
technique=path (cli.py:380-403) and with technique=mmlt through the
depth-grouped driver (cli.py:314-367), with its defaults.  The chain
kernel splats with a box filter only: another filter raises.
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
from drmlt_mitsuba_tpu_torch.integrators.mmlt_grouped import (
    render_drmlt_mmlt_grouped,
)
from drmlt_mitsuba_tpu_torch.render import film as filmlib
from drmlt_mitsuba_tpu_torch.scene.builders import cornell_box, veach_door
from drmlt_mitsuba_tpu_torch.scene.types import prepare_scene
from drmlt_mitsuba_tpu_torch.scene.xml import RenderSettings, load_scene_xml
from drmlt_mitsuba_tpu_torch.utils.exr import write_exr

SIZE = 256      # film width and height of the built-in scenes
BUILTIN_SPP = 16
KEYS = ("integrator", "technique", "variant", "pLarge", "sigma",
        "scaleSecond", "timidAfterLarge", "luminanceSamples", "splatMode",
        "maxDepth", "minDepth", "tallBox", "lightImage", "fixEmitterPath",
        "equalChains", "grouped")


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


def render(args, scene, settings: RenderSettings, device):
    defs = settings.integrator
    if defs.get("type") != "drmlt":
        raise NotImplementedError(
            f"integrator {defs.get('type')!r} not yet ported (drmlt only; "
            f"a scene file may leave it to -D integrator=drmlt)")
    if settings.filter_name != "box":
        raise NotImplementedError(
            f"film filter {settings.filter_name!r} not yet ported: the chain "
            f"kernel splats with a box filter only")
    technique = defs.get("technique", "path")
    if technique not in ("path", "mmlt"):
        raise NotImplementedError(
            f"technique {technique!r} not yet ported (path, mmlt)")
    if technique == "mmlt" and not _pbool(defs.get("grouped"), True):
        raise NotImplementedError(
            "the pooled MMLT driver (-D grouped=false) is not ported")
    cfg = DRMLTConfig(
        type=defs.get("variant", "green"),
        n_chains=args.chains,
        p_large=float(defs.get("pLarge", 0.3)),
        sigma=float(defs.get("sigma", 1 / 64)),
        scale_second=float(defs.get("scaleSecond", 0.1)),
        timid_after_large=_pbool(defs.get("timidAfterLarge"), False),
        fix_emitter_path=_pbool(defs.get("fixEmitterPath"), False),
        n_bootstrap=int(defs.get("luminanceSamples", 100_000)),
        splat_mode=defs.get("splatMode", "sampled"),
    )
    W, H = settings.width, settings.height
    fc = filmlib.make_film_config(W, H, "box")
    spp = args.spp if args.spp is not None else settings.spp
    n_steps = max(1, W * H * spp // args.chains)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    if technique == "mmlt":
        bcfg = BDPTConfig(max_depth=int(defs.get("maxDepth", 5)),
                          light_image=_pbool(defs.get("lightImage"), True),
                          thinlens=_thinlens(scene))
        return render_drmlt_mmlt_grouped(
            scene, bcfg, cfg, fc, gen, n_steps,
            min_group=max(64, min(1024, args.chains // 4)),
            equal_chains=_pbool(defs.get("equalChains"), True))
    md = int(defs.get("maxDepth", 8))
    pcfg = PathConfig(max_depth=md if md > 0 else 12, rr_depth=100,
                      min_depth=int(defs.get("minDepth", 1)),
                      thinlens=_thinlens(scene))
    return render_drmlt_path(scene, pcfg, cfg, fc, gen, n_steps)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="drmlt-torch",
        description="DRMLT renderer (path and MMLT techniques) on PyTorch + "
                    "CUDA")
    ap.add_argument("scene", help="Mitsuba scene XML, or a built-in scene "
                                  "name (cornell, veach)")
    ap.add_argument("-D", action="append", default=[], metavar="key=value",
                    help="$key substitution in a scene XML; for a built-in "
                         "scene an integrator parameter (" + ", ".join(KEYS)
                         + ")")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("--chains", type=int, default=16384,
                    help="MCMC chains")
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
    if "steps_per_group" in aux:
        print(f"b = {float(aux['b']):.6f}, b_k {aux['b_k']}, steps per "
              f"depth group {aux['steps_per_group']} x {args.chains} chains "
              f"in {dt:.2f} s on {device}")
    else:
        st = {k: float(v) for k, v in aux["stats"].items()}
        print(f"b = {float(aux['b']):.6f}, {aux['steps']} steps x "
              f"{args.chains} chains in {dt:.2f} s on {device}; stats {st}")
    if not np.all(np.isfinite(img)):
        raise SystemExit("render produced non-finite pixels")
    write_exr(output, img)
    print(f"wrote {output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
