// splat_add_kernel: scatter-add of N filter taps into an (H, W, 4) film.
//
// Replaces the reference's Pallas kernel
// drmlt_mitsuba_tpu/ops/pallas/splat_kernel.py:_splat_kernel / splat_add
// (:40, :79), which film.splat dispatches to for films up to 2^22 bytes
// (render_pt, the image loss of inverse rendering).  Plain twin: the exact
// f32 scatter `index_put_(..., accumulate=True)` in ops/splat.py
// (the reference's film.py:102-105), not the TPU kernel's bf16 hi/lo
// one-hot matmuls, which existed only to put a scatter on the MXU.
//
// What bounds it on an H100: bytes.  Each tap reads two int32 indices and
// four floats (24 bytes) and adds four floats into the film; a 256x256
// film is 1 MiB and stays in the 50 MB L2, so the atomics resolve there.  Taps of
// one pixel collide (a dark image concentrates light in few pixels), and
// colliding atomics serialise in L2; that, not HBM, is what a hot pixel
// costs.
//
// Design: one thread per tap and one 16-byte vector reduction per tap
// (Hopper's atomicAdd(float4*, float4): one L2 reduction of four floats,
// where four scalar atomicAdds take four; its return value is unused), so
// the film's base must be 16-byte aligned (ops/splat.py checks it).  A tap
// outside the film is dropped, as the reference's one-hot rows drop it and
// as the twin does.  The order of the adds is not fixed, so sums differ
// from the twin's in the last bits; callers compare with a tolerance.  The
// backward (a gather g[py, px]) is plain PyTorch, as the reference
// computes it outside its kernel too.
#include <cuda_runtime.h>

namespace drmlt {

__global__ void splat_add_kernel(float* __restrict__ film, int H, int W,
                                 const int* __restrict__ py,
                                 const int* __restrict__ px,
                                 const float* __restrict__ vals, int N) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int y = py[i], x = px[i];
  if ((unsigned)y >= (unsigned)H || (unsigned)x >= (unsigned)W) return;
  const float4 v = reinterpret_cast<const float4*>(vals)[i];
  atomicAdd(reinterpret_cast<float4*>(film) + ((size_t)y * W + x), v);
}

}  // namespace drmlt

extern "C" int splat_add_launch(float* film, int H, int W, const int* py,
                                const int* px, const float* vals, int N,
                                void* stream) {
  const int block = 256;
  int grid = (N + block - 1) / block;
  if (grid > 0) {
    drmlt::splat_add_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        film, H, W, py, px, vals, N);
  }
  return (int)cudaGetLastError();
}
