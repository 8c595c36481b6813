"""Renderer CLI for the port (counterpart of drmlt_mitsuba_tpu/utils/cli.py,
integrator=drmlt over the path and the MMLT technique).

    python -m drmlt_mitsuba_tpu_torch.utils.cli cornell -D variant=orbital \\
        -D tallBox=glass --chains 65536 --spp 256 -s 0 -o cornell.exr
    python -m drmlt_mitsuba_tpu_torch.utils.cli veach -D technique=mmlt \\
        -D variant=orbital -D maxDepth=6 --chains 65536 --spp 256 -o veach.exr

The scene argument is a built-in name: `cornell` (the 256x256 Cornell
box, tall box `-D tallBox=diffuse|mirror|glass`) or `veach` (the 256x256
veach-door scene); scene XML is not ported yet.  The `-D` keys are the
ones the reference CLI reads for integrator=drmlt with technique=path
(cli.py:380-403) and with technique=mmlt through the depth-grouped driver
(cli.py:314-367), with its defaults.
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
from drmlt_mitsuba_tpu_torch.utils.exr import write_exr

SIZE = 256
KEYS = ("integrator", "technique", "variant", "pLarge", "sigma",
        "scaleSecond", "timidAfterLarge", "luminanceSamples", "splatMode",
        "maxDepth", "minDepth", "tallBox", "lightImage", "fixEmitterPath",
        "equalChains", "grouped")


def _pbool(v, default=False):
    """A `-D key=false` string as a bool (bool("false") is truthy)."""
    if v is None:
        return default
    return v.strip().lower() in ("true", "1", "yes", "on")


def load_scene(name: str, defs: dict):
    if name.endswith(".xml"):
        raise NotImplementedError("XML loader not yet ported")
    if name == "veach":
        return veach_door(SIZE, SIZE)
    if name != "cornell":
        raise SystemExit(f"unknown built-in scene {name!r} (have: cornell, "
                         f"veach)")
    return cornell_box(SIZE, SIZE, tall_box_material=defs.get("tallBox",
                                                              "diffuse"))


def render(args, defs: dict, device):
    if defs.get("integrator", "drmlt") != "drmlt":
        raise NotImplementedError(
            f"integrator {defs['integrator']!r} not yet ported (drmlt only)")
    technique = defs.get("technique", "path")
    if technique not in ("path", "mmlt"):
        raise NotImplementedError(
            f"technique {technique!r} not yet ported (path, mmlt)")
    if technique == "mmlt" and not _pbool(defs.get("grouped"), True):
        raise NotImplementedError(
            "the pooled MMLT driver (-D grouped=false) is not ported")
    scene = load_scene(args.scene, defs)
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
    fc = filmlib.make_film_config(SIZE, SIZE, "box")
    n_steps = max(1, SIZE * SIZE * args.spp // args.chains)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    if technique == "mmlt":
        bcfg = BDPTConfig(max_depth=int(defs.get("maxDepth", 5)),
                          light_image=_pbool(defs.get("lightImage"), True))
        return render_drmlt_mmlt_grouped(
            scene, bcfg, cfg, fc, gen, n_steps,
            min_group=max(64, min(1024, args.chains // 4)),
            equal_chains=_pbool(defs.get("equalChains"), True))
    md = int(defs.get("maxDepth", 8))
    pcfg = PathConfig(max_depth=md if md > 0 else 12, rr_depth=100,
                      min_depth=int(defs.get("minDepth", 1)))
    return render_drmlt_path(scene, pcfg, cfg, fc, gen, n_steps)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="drmlt-torch",
        description="DRMLT renderer (path and MMLT techniques) on PyTorch + "
                    "CUDA")
    ap.add_argument("scene", help="built-in scene name (cornell, veach)")
    ap.add_argument("-D", action="append", default=[], metavar="key=value",
                    help="integrator parameter (" + ", ".join(KEYS) + ")")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("--chains", type=int, default=16384,
                    help="MCMC chains")
    ap.add_argument("--spp", type=int, default=16,
                    help="mutations per pixel")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain twins)")
    args = ap.parse_args(argv)
    defs = dict(kv.split("=", 1) for kv in args.D)
    unknown = sorted(set(defs) - set(KEYS))
    if unknown:
        raise SystemExit(f"unknown -D keys {unknown}; known: {list(KEYS)}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")
    output = args.output or args.scene.rsplit(".", 1)[0] + ".exr"

    t0 = time.time()
    img, aux = render(args, defs, device)
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
