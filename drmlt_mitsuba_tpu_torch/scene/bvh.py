"""BVH build (counterpart of drmlt_mitsuba_tpu/scene/bvh.py): the port's
copy of the native binned-SAH builder, csrc/bvh_builder.cpp, compiled
with g++ into build/ at first use and called through ctypes.

There is no median-split fallback: a missing compiler or a failed build
raises.  `pack_nodes` turns the tree and the triangle table into the node
and triangle records the kernels and the plain walk of ops/intersect.py
read.
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


# a leaf node's triangle count lives in the low bits of its record's last
# word, the index of its first triangle record above them
LEAF_BITS = 4


@dataclasses.dataclass(frozen=True)
class NodeTable:
    """The BVH as the kernels read it (csrc/bvh.cuh).  node (N, 8) f32, one
    32-byte record a node: lo.xyz, skip, hi.xyz, first << LEAF_BITS |
    count (0 for an inner node, whose left child is the next node), the
    ints as float bits, the box padded by BOX_PAD.  rec (T, 12) f32, the
    triangles in leaf order (a leaf's records are first ... first + count
    - 1): v0.xyz and the original triangle id as float bits, e1.xyz, 0,
    e2.xyz, 0, the bits of the triangle table's columns."""
    node: torch.Tensor
    rec: torch.Tensor

    @property
    def n_nodes(self) -> int:
        return self.node.shape[0]

    def unpack(self):
        """(first, count, skip, order), int32 on the table's device, as
        `BVH` holds them (an inner node's first is its left child)."""
        w = self.node.view(torch.int32)
        leaf = w[:, 7]
        count = leaf & ((1 << LEAF_BITS) - 1)
        nxt = torch.arange(1, w.shape[0] + 1, dtype=torch.int32,
                           device=w.device)
        first = torch.where(count > 0, leaf >> LEAF_BITS, nxt)
        return first, count, w[:, 3].clone(), self.rec.view(torch.int32)[:, 3]


def pack_nodes(bvh: BVH, tri: torch.Tensor) -> NodeTable:
    """The node and triangle records of `bvh` over the (T, 20) triangle
    table `tri` (ops/intersect.py:pack_tri_table), on tri's device.  Built
    on integer views, so every float keeps its bits."""
    lo, hi = bvh.nodes_min.float(), bvh.nodes_max.float()
    pad = BOX_PAD * float(torch.maximum(lo.abs().max(), hi.abs().max()))
    count = bvh.count.to(torch.int32)
    T = bvh.order.shape[0]
    if int(count.max()) >= 1 << LEAF_BITS or T >= 1 << (31 - LEAF_BITS):
        raise ValueError(f"a leaf of {int(count.max())} triangles or {T} "
                         f"triangles do not fit a node record")
    leaf = torch.where(count > 0, (bvh.first.to(torch.int32) << LEAF_BITS)
                       | count, 0)
    node = torch.cat([(lo - pad).view(torch.int32),
                      bvh.skip.to(torch.int32)[:, None],
                      (hi + pad).view(torch.int32), leaf[:, None]], 1)
    order = bvh.order.to(device=tri.device, dtype=torch.int32)
    rows = tri.detach()[order.long()].view(torch.int32)
    z = torch.zeros((T, 1), dtype=torch.int32, device=tri.device)
    rec = torch.cat([rows[:, 0:3], order[:, None], rows[:, 3:6], z,
                     rows[:, 6:9], z], 1)
    return NodeTable(node=node.to(tri.device).view(torch.float32)
                     .contiguous(),
                     rec=rec.view(torch.float32).contiguous())
