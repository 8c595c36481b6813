"""Image tools of the equal-time comparisons (counterpart of
drmlt_mitsuba_tpu/utils/imgtools.py; the reference's tonemap, addimages
and the EXR averaging):

    python -m drmlt_mitsuba_tpu_torch.utils.imgtools avg a.exr b.exr -o m.exr
    python -m drmlt_mitsuba_tpu_torch.utils.imgtools add a.exr b.exr -o s.exr
    python -m drmlt_mitsuba_tpu_torch.utils.imgtools tonemap a.exr -o a.npy
    python -m drmlt_mitsuba_tpu_torch.utils.imgtools rmse a.exr ref.exr

tonemap writes the 8-bit sRGB image as a (H, W, 3) uint8 .npy; PNG needs
PIL and raises.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from drmlt_mitsuba_tpu_torch.utils.exr import read_exr, write_exr


def cmd_avg(args):
    out = np.mean(np.stack([read_exr(p) for p in args.inputs]), axis=0)
    write_exr(args.output, out)
    print(f"averaged {len(args.inputs)} images -> {args.output}")


def cmd_add(args):
    a = read_exr(args.inputs[0]) * args.weight_a
    b = read_exr(args.inputs[1]) * args.weight_b
    write_exr(args.output, a + b)
    print(f"wrote {args.output}")


def tonemap(img, exposure: float = 0.0, reinhard: bool = False):
    """8-bit sRGB (uint8) of a linear image at 2^exposure, optionally
    through Reinhard's x / (1 + x)."""
    img = img * (2.0 ** exposure)
    if reinhard:
        img = img / (1.0 + img)
    img = np.clip(img, 0.0, 1.0)
    srgb = np.where(img <= 0.0031308, img * 12.92,
                    1.055 * np.maximum(img, 1e-8) ** (1 / 2.4) - 0.055)
    return (srgb * 255).astype(np.uint8)


def cmd_tonemap(args):
    if args.output.endswith(".png"):
        raise NotImplementedError("PNG output not yet ported (it needs PIL): "
                                  "write .npy")
    np.save(args.output, tonemap(read_exr(args.inputs[0]), args.exposure,
                                 args.reinhard))
    print(f"wrote {args.output}")


def cmd_rmse(args):
    a = read_exr(args.inputs[0])
    b = read_exr(args.inputs[1])
    rmse = float(np.sqrt(np.mean((a - b) ** 2)))
    rel = rmse / max(float(np.abs(b).mean()), 1e-9)
    print(f"rmse={rmse:.6f} relative={rel:.4f}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="drmlt-img")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("avg", help="average a stack of EXRs")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", required=True)
    p.set_defaults(fn=cmd_avg)
    p = sub.add_parser("add", help="weighted sum of two EXRs")
    p.add_argument("inputs", nargs=2)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--weight-a", type=float, default=1.0)
    p.add_argument("--weight-b", type=float, default=1.0)
    p.set_defaults(fn=cmd_add)
    p = sub.add_parser("tonemap", help="EXR -> 8-bit sRGB (.npy), exposure")
    p.add_argument("inputs", nargs=1)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-e", "--exposure", type=float, default=0.0)
    p.add_argument("--reinhard", action="store_true")
    p.set_defaults(fn=cmd_tonemap)
    p = sub.add_parser("rmse", help="RMSE between two EXRs")
    p.add_argument("inputs", nargs=2)
    p.set_defaults(fn=cmd_rmse)
    args = ap.parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
