// One Jacobi sweep of the 4-point Dirichlet stencil over an (H, W) f32
// block, in one read and one write of the block.
//
// Replaces: smi_tpu/kernels/stencil.py::_sweep_kernel (driven by
// fused_sweep). There the grid walks row stripes in order and carries the
// previous stripe and its last row in VMEM scratch, because each stripe's
// vertical neighbours live in the adjacent stripes; horizontal neighbours
// come from a lane roll patched with the halo columns.
//
// Bound on the H100: device-memory bytes. A sweep reads each cell once and
// writes it once (8 B/cell) against 4 floating-point operations per cell,
// 0.5 flop/B, far below the card's ~20 flop/B balance point. At 8192^2 the
// bound is 537 MB / 3.35 TB/s = 0.16 ms.
//
// Design: CUDA blocks run in parallel and in no order, so nothing is
// carried between them. Each thread owns one output cell and reads its
// four neighbours straight from the block; neighbouring threads share
// those reads through L1/L2, so device memory sees about one read per
// cell. At the block's edge the neighbour comes from the 1-deep halo slab
// instead. The Dirichlet mask is recomputed from global coordinates
// (row0, col0, gh, gw), as the TPU kernel does from its scalar prefetch.
//
// Arithmetic: 0.25f * (((up + down) + left) + right) in f32, built with
// -fmad=false and without fast math, so every cell is bit-identical to the
// serial numpy reference.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

__global__ void sweep_kernel(const float* __restrict__ x,
                             const float* __restrict__ top,     // (1, W)
                             const float* __restrict__ bottom,  // (1, W)
                             const float* __restrict__ lcol,    // (H, 1)
                             const float* __restrict__ rcol,    // (H, 1)
                             float* __restrict__ out, int h, int w,
                             int row0, int col0, int gh, int gw) {
  const int c = blockIdx.x * kBlockX + threadIdx.x;
  const int r = blockIdx.y * kBlockY + threadIdx.y;
  if (r >= h || c >= w) return;
  const size_t i = static_cast<size_t>(r) * w + c;
  const float center = x[i];
  const int gr = row0 + r;
  const int gc = col0 + c;
  if (gr == 0 || gr == gh - 1 || gc == 0 || gc == gw - 1) {
    out[i] = center;  // Dirichlet: the global boundary holds its value
    return;
  }
  const float up = r > 0 ? x[i - w] : top[c];
  const float down = r < h - 1 ? x[i + w] : bottom[c];
  const float left = c > 0 ? x[i - 1] : lcol[r];
  const float right = c < w - 1 ? x[i + 1] : rcol[r];
  out[i] = 0.25f * (((up + down) + left) + right);
}

}  // namespace

extern "C" int smi_stencil_sweep(const float* x, const float* top,
                                 const float* bottom, const float* lcol,
                                 const float* rcol, float* out, int h, int w,
                                 int row0, int col0, int gh, int gw,
                                 void* stream) {
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  sweep_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, top, bottom, lcol, rcol, out, h, w, row0, col0, gh, gw);
  return static_cast<int>(cudaGetLastError());
}
