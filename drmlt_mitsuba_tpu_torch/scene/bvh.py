"""BVH build (counterpart of drmlt_mitsuba_tpu/scene/bvh.py): the port's
copy of the native binned-SAH builder, csrc/bvh_builder.cpp, compiled
with g++ into build/ at first use and called through ctypes.

There is no median-split fallback: a missing compiler or a failed build
raises.  `pack_nodes` turns the tree into the node tables the kernels and
the plain walk of ops/intersect.py read.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from drmlt_mitsuba_tpu_torch.ops import build
from drmlt_mitsuba_tpu_torch.scene.types import BVH

# triangles per leaf
MAX_LEAF = 4
# node boxes are padded outward by this fraction of the scene's largest
# coordinate magnitude, so that a box holds every point at which the
# Moller-Trumbore test may accept one of its triangles (rounding puts an
# accepted hit a few ulp of the coordinates outside the triangle, more at
# grazing angles) and the walk culls no triangle that the sweep hits
BOX_PAD = 1e-3

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build.build_host("bvh_builder")))
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.drmlt_build_bvh.restype = ctypes.c_int
        lib.drmlt_build_bvh.argtypes = [fp, fp, fp, ctypes.c_int,
                                        ctypes.c_int, fp, fp, ip, ip, ip, ip,
                                        ctypes.c_int]
        _lib = lib
    return _lib


def build_bvh(v0, e1, e2, max_leaf: int = MAX_LEAF) -> BVH:
    """Binned-SAH BVH of the triangles v0 + (b1 e1 + b2 e2), as numpy
    (T, 3) float32 arrays; the layout of the reference's build_bvh_native
    (bvh.py:61), with the primitive order in `BVH.order`."""
    lib = _load()
    n = len(v0)
    v0, e1, e2 = (np.ascontiguousarray(a, np.float32) for a in (v0, e1, e2))
    max_nodes = max(4, 2 * n)
    nmin = np.zeros((max_nodes, 3), np.float32)
    nmax = np.zeros((max_nodes, 3), np.float32)
    first = np.zeros(max_nodes, np.int32)
    count = np.zeros(max_nodes, np.int32)
    skip = np.zeros(max_nodes, np.int32)
    order = np.zeros(n, np.int32)

    def fp(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    def ip(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))

    n_nodes = lib.drmlt_build_bvh(fp(v0), fp(e1), fp(e2), n, max_leaf,
                                  fp(nmin), fp(nmax), ip(first), ip(count),
                                  ip(skip), ip(order), max_nodes)
    if n_nodes < 0:
        raise RuntimeError(f"BVH build failed on {n} triangles")
    t = torch.from_numpy
    return BVH(nodes_min=t(nmin[:n_nodes].copy()),
               nodes_max=t(nmax[:n_nodes].copy()),
               first=t(first[:n_nodes].copy()),
               count=t(count[:n_nodes].copy()),
               skip=t(skip[:n_nodes].copy()), order=t(order))


@dataclasses.dataclass(frozen=True)
class NodeTable:
    """The BVH as the kernels read it.  box (N, 8) f32: lo.xyz, 0, hi.xyz,
    0 (two 16-byte loads), padded by BOX_PAD; link (N, 4) int32: first,
    count, skip, 0 (one 16-byte load); order (T,) int32."""
    box: torch.Tensor
    link: torch.Tensor
    order: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.box.shape[0]


def pack_nodes(bvh: BVH, device) -> NodeTable:
    lo, hi = bvh.nodes_min.float(), bvh.nodes_max.float()
    pad = BOX_PAD * float(torch.maximum(lo.abs().max(), hi.abs().max()))
    N = lo.shape[0]
    z = torch.zeros((N, 1), dtype=torch.float32)
    box = torch.cat([lo - pad, z, hi + pad, z], 1)
    link = torch.stack([bvh.first, bvh.count, bvh.skip,
                        torch.zeros_like(bvh.skip)], 1).to(torch.int32)
    return NodeTable(box=box.to(device).contiguous(),
                     link=link.to(device).contiguous(),
                     order=bvh.order.to(device=device,
                                        dtype=torch.int32).contiguous())
