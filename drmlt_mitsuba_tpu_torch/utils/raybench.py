"""Ray-throughput benchmark (counterpart of drmlt_mitsuba_tpu/utils/raybench.py):
prints MRays/s of the intersection kernel's closest-hit query on the
reference's procedurally tessellated bumpy sphere, and the mode it ran in
(`bvh` above BVH_MIN_TRIS triangles, else `brute`).

    python -m drmlt_mitsuba_tpu_torch.utils.raybench --tris 20000 --rays 1048576
    python -m drmlt_mitsuba_tpu_torch.utils.raybench --tris 4000
    python -m drmlt_mitsuba_tpu_torch.utils.raybench --tris 20000 --rays 4096 \\
        --iters 1 --device cpu

Rays: origins uniform in [-3, 3]^3 from numpy's default_rng(0), as the
reference's; directions are normalised Gaussians from the same generator
(the reference draws them with jax.random, which the port does not use).
On a CUDA device the time is CUDA events around `iters` launches after a
warm-up; on the CPU (the plain twin) a host clock.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from drmlt_mitsuba_tpu_torch.ops import intersect as ix
from drmlt_mitsuba_tpu_torch.scene import types as st


def bumpy_sphere(n_tris: int) -> st.Scene:
    """The reference raybench's mesh: a bumpy sphere shell of about
    n_tris triangles (2 nu (nu - 1), nu = max(8, sqrt(n_tris / 2)))."""
    nu = max(8, int(np.sqrt(n_tris / 2)))
    th = np.linspace(1e-3, np.pi - 1e-3, nu)
    ph = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    TH, PH = np.meshgrid(th, ph, indexing="ij")
    r = 1.0 + 0.1 * np.sin(5 * TH) * np.cos(7 * PH)
    V = np.stack([r * np.sin(TH) * np.cos(PH), r * np.sin(TH) * np.sin(PH),
                  r * np.cos(TH)], -1).reshape(-1, 3).astype(np.float32)
    F = []
    for i in range(nu - 1):
        for j in range(nu):
            a, b = i * nu + j, i * nu + (j + 1) % nu
            c, d = (i + 1) * nu + j, (i + 1) * nu + (j + 1) % nu
            F.append([a, b, d])
            F.append([a, d, c])
    F = np.asarray(F, np.int32)
    tris = st.build_triangles(V, F, np.zeros(len(F), np.int32),
                              np.full(len(F), -1, np.int32))
    return st.Scene(
        tris=tris, spheres=st.empty_spheres(),
        materials=st.make_material_table([dict(kind=st.BSDF_DIFFUSE)]),
        emitters=st.build_emitters(tris, np.zeros((1, 3), np.float32)),
        camera=st.make_camera(np.eye(4, dtype=np.float32), 60.0, 1.0))


def rays(n: int, device, seed: int = 0):
    """(o, d) (n, 3) float32 on `device`."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="drmlt-torch-raybench")
    ap.add_argument("--tris", type=int, default=20000)
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernel) or cpu (its plain twin)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available")

    scene = st.prepare_scene(bumpy_sphere(args.tris))
    tables = ix.make_ray_tables(scene, device)
    mode = "bvh" if tables.nodes is not None else "brute"
    o, d = rays(args.rays, device)
    t, _ = ix.closest(tables, o, d)        # warm-up (and the build)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.iters):
            t, _ = ix.closest(tables, o, d)
        end.record()
        torch.cuda.synchronize()
        dt = start.elapsed_time(end) / 1e3 / args.iters
        where = torch.cuda.get_device_name(device)
    else:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            t, _ = ix.closest(tables, o, d)
        dt = (time.perf_counter() - t0) / args.iters
        where = "cpu (plain twin)"
    hit = float((t < ix.INF).float().mean())
    print(f"{scene.tris.v0.shape[0]} tris, {args.rays} rays, mode={mode} on "
          f"{where}: {dt * 1e3:.3f} ms -> {args.rays / dt / 1e6:.1f} "
          f"MRays/s ({hit:.3f} of rays hit)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
