"""drmlt_mitsuba_tpu_torch — the DRMLT renderer on PyTorch and CUDA.

A second implementation of `drmlt_mitsuba_tpu` (JAX/Pallas, the reference)
for one NVIDIA H100.  Plain tensor code is PyTorch; every Pallas kernel on
the ported path is a hand-written CUDA C++ kernel for sm_90a under `csrc/`,
built with nvcc at first use (`ops/build.py`) and bound through ctypes.

The layout mirrors the reference (`core/ scene/ render/ ops/ integrators/
utils/`) so each module has an obvious counterpart.  This package imports
torch and numpy only: never jax, never `drmlt_mitsuba_tpu`.

Slice 1 covers the DRMLT path-technique render
(`integrators.drmlt.render_drmlt_path`), slice 2 the depth-grouped DRMLT
render over the MMLT technique
(`integrators.mmlt_grouped.render_drmlt_mmlt_grouped`), slice 3
differentiable rendering, and slice 4 asset-scale scenes: the Mitsuba XML
and OBJ loaders (`scene.xml`, `scene.mesh_io`), a binned-SAH BVH
(`scene.bvh`) that every kernel walks above `scene.types.BVH_MIN_TRIS`
triangles, and the ray-intersection kernel (`ops.intersect`,
`utils.raybench`).  All on triangle scenes with area emitters and diffuse
/ rough diffuse / mirror / dielectric materials.
"""

__version__ = "0.1.0"
