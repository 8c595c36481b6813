"""Build and load the CUDA kernels of `csrc/`.

Each `.cu` source is compiled with its own nvcc process, all started
together, into an object file (about half the wall of one nvcc command over
every source; scripts/chain_kernel_ab.py times both); the objects are then
linked into one shared library with a plain C interface, loaded with
ctypes (no PyTorch headers, so a build takes seconds).  The library's file name carries a hash of the
sources and flags; it lives under `build/` at the repository root, which
git ignores.  ptxas's register / spill / shared-memory report of the build
is kept beside it.

`build_host` compiles the host-side BVH builder (csrc/bvh_builder.cpp)
with g++ the same way.  There is no fallback: a missing nvcc or g++, a
failed build or a launch the CUDA runtime refuses raises.  `LAUNCHES`
counts, per kernel (the chain kernel per technique and mode, the trace
kernels' full-scope instantiations under "<name>[full]"), the launches the
wrappers made; a wrapper adds one exactly where it launches its kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # no a*b+c contraction: the plain PyTorch twins round every product
    # and sum separately, and hit tests near triangle edges and acceptance
    # coins near a threshold flip on the last bit
    "--fmad=false",
]

FULL = "[full]"   # the key suffix of a full-scope instantiation's count


def scope_key(name: str, tables) -> str:
    """The LAUNCHES key of kernel `name` launched on `tables`."""
    return name + (FULL if tables.full else "")


LAUNCHES = {"path_trace": 0, "drmlt_path": 0, "mmlt_trace": 0,
            "drmlt_mmlt": 0, "drmlt_path_pssmlt": 0, "drmlt_mmlt_pssmlt": 0,
            "splat_add": 0, "path_trace_rad": 0, "path_trace_alb": 0,
            "intersect": 0}
# the full-scope instantiations of the trace kernels count apart
# (ops/megatrace.py:scope_fields)
LAUNCHES.update({k + FULL: 0 for k in ("path_trace", "drmlt_path",
                                       "mmlt_trace", "drmlt_mmlt",
                                       "drmlt_path_pssmlt",
                                       "drmlt_mmlt_pssmlt",
                                       "path_trace_rad", "path_trace_alb")})

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint32
_F = ctypes.c_float

# C signatures of the entry points (csrc/*.cu, extern "C")
_SCENE = [
    _P, _I, _P, _I, _P, _I, _P,                # tri, T, mat, M, em, E, cam
    _P, _P, _P, _I,                            # node box, link, order, N
    _P, _I, _P,                                # sph, S, tri_ext
    _P, _I, _I, _I,                            # tex, pages, height, width
    _P, _P, _P, _I, _I,                        # env_tab, env_col, env_row,
    #                                            He, We
    _I, _F, _I, _I,                            # env_mode, env_row_pick,
    #                                            thinlens, full
]
_PATH_TRACE = [
    *_SCENE,
    _I, _I, _I, _I,                            # max/min/rr depth, use_nee
    _P, _I, _P, _P,                            # uT, R, out, stream
]
_SIGNATURES = {
    "path_trace_launch": _PATH_TRACE,
    "path_trace_rad_launch": _PATH_TRACE,
    "path_trace_alb_launch": _PATH_TRACE,
    "splat_add_launch": [
        _P, _I, _I, _P, _P, _P, _I, _P,        # film, H, W, py, px, vals,
        #                                        N, stream
    ],
    "mmlt_trace_launch": [
        *_SCENE,
        _I, _I, _I,                            # max_depth, light_image,
        #                                        eye_dims
        _P, _I, _P, _P,                        # uT, R, out, stream
    ],
    "drmlt_chain_launch": [
        *_SCENE,
        _I,                                    # technique (0 path, 1 mmlt)
        _I, _I, _I, _I,                        # max/min/rr depth, use_nee
        _I, _I, _I,                            # light_image, eye_dims,
        #                                        light_dims
        _P, _P, _I, _I,                        # state, scratch, D, C
        _P, _I, _I, _P,                        # film, H, W, stats
        _P, _I, _I, _U, _U,                    # uniforms, n_rand, n_mut,
        #                                        seed, launch
        _I, _I, _I, _I, _I,                    # drtype, sampled, timid,
        #                                        fix_emitter_path, pssmlt
        _F, _F, _F, _F, _F, _F,                # p_large, s1, s2, log_ratio,
        #                                        sigma2, dispersion
        _F, _F,                                # u_depth, 1/k (mmlt)
        _P,                                    # stream
    ],
    "intersect_launch": [
        _P, _I, _P, _P, _P, _I,                # tri, T, node box, link,
        #                                        order, N
        _P, _P, _P, _I, _I,                    # o, d, tmax, R, any_mode
        _P, _P, _P,                            # t_out, out, stream
    ],
}

_lib = None
build_info: dict = {}


def _sources():
    return sorted(list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")))


def _nvcc() -> str:
    cand = shutil.which("nvcc")
    if cand is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        if not os.path.exists(cand):
            raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                               "/usr/local/cuda): cannot build the kernels")
    return cand


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libdrmlt_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/ into the hashed library unless it already exists: one
    nvcc per source, run in parallel, then one link."""
    out = library_path()
    log = out.with_suffix(".ptxas.txt")
    if out.exists():
        build_info.update(path=str(out), seconds=0.0, cached=True,
                          ptxas=log.read_text() if log.exists() else "")
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.time()
    procs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    report = []
    failed = []
    for cmd, obj, proc in procs:
        text = proc.communicate()[0]
        report.append(text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{text}")
    objs = [str(obj) for _, obj, _ in procs]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp), *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            failed.append(f"nvcc link failed ({res.returncode}):\n"
                          f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, out)
    text = "".join(report)
    log.write_text(text)
    build_info.update(path=str(out), seconds=time.time() - t0, cached=False,
                      ptxas=text)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, kernel: str):
    """Raise on a non-zero cudaError_t returned by an entry point."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA error {rc} at launch")


HOST_FLAGS = [
    "-std=c++17", "-O2", "-shared", "-fPIC",
    # the same tree on every machine: no -march=native, no contraction
    "-ffp-contract=off",
]


def build_host(name: str) -> Path:
    """Compile the host library csrc/<name>.cpp with g++ into
    build/torch_kernels/lib<name>_<hash>.so unless it exists (no fallback:
    a missing g++ or a failed build raises)."""
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode() + src.read_bytes())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: cannot build {src.name}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([gxx, *HOST_FLAGS, "-o", str(tmp), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed ({res.returncode}) on {src}:\n"
                           f"{res.stdout}\n{res.stderr}")
    os.replace(tmp, out)
    return out


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
