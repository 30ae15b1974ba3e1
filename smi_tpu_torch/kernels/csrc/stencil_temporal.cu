// k Jacobi sweeps of the 4-point Dirichlet stencil per memory pass
// (temporal blocking) over an (H, W) f32 block with k-deep,
// corner-complete halo slabs.
//
// Replaces both smi_tpu/kernels/stencil_temporal.py::_tiled_kernel
// (column tiles, driven by _temporal_pass_ext_tiled; the planner's choice
// for wide blocks such as 8192x8192) and ::_temporal_kernel (full-width
// stripes, driven by _temporal_pass_ext; its choice for narrow blocks such
// as 4096x2048). Those kernels walk a sequential grid and carry the working
// tile from one step to the next, keep the state in a 128-lane padded
// layout, and shrink the swept region in 8-row bands: all three follow the
// TPU's sequential grid, lane tiling and sublanes, and none is kept here.
//
// Bound on the H100: one pass reads each cell and writes it once (8 B per
// cell, whatever k is), and does 4 floating-point operations per cell and
// sweep. At 8192^2 and k=16 that is 537 MB (0.16 ms at 3.35 TB/s) against
// 4.3 GFLOP (0.064 ms at 67 TFLOP/s f32), so the pass is bound by bytes.
// What limits this simple kernel in practice is shared-memory traffic and
// the recomputed apron: each sweep reads 5 and writes 1 shared word per
// cell, over a region 1.5x the tile at 64x64 and k=16.
//
// Design: each CUDA block owns a TH x TW output tile. It reads its
// (TH+2k) x (TW+2k) window into shared memory once, straight from the
// block and the four halo slabs (the source is chosen by index; no padded
// copy is made), and sweeps k times between two shared buffers. Sweep s
// computes the window minus its outer s+1 rings, so after k sweeps the
// centre tile is exact. The block writes back only that tile, to a second
// device buffer: neighbouring blocks read each other's aprons, so the pass
// cannot write in place. Windows above 48 KB opt in to the larger dynamic
// shared memory with cudaFuncSetAttribute (up to 227 KB a block).
//
// Arithmetic: 0.25f * (((up + down) + left) + right) in f32 and the
// Dirichlet mask from global coordinates (row0, col0, gh, gw) at every
// sweep, built with -fmad=false and without fast math, so the result is
// bit-identical to k serial sweeps of the numpy reference. Window cells
// outside the global grid hold whatever the halo slabs carry (zeros at
// the domain edge) and are read only by boundary cells, which hold.

#include <cuda_runtime.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 16;

__global__ void temporal_kernel(const float* __restrict__ x,
                                const float* __restrict__ top,     // (k, W+2k)
                                const float* __restrict__ bottom,  // (k, W+2k)
                                const float* __restrict__ lcol,    // (H, k)
                                const float* __restrict__ rcol,    // (H, k)
                                float* __restrict__ out, int h, int w,
                                int row0, int col0, int gh, int gw, int k,
                                int th, int tw) {
  extern __shared__ float smem[];
  const int rows = th + 2 * k;
  const int cols = tw + 2 * k;
  float* a = smem;
  float* b = smem + rows * cols;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int r0 = blockIdx.y * th - k;  // block-relative origin of the window
  const int c0 = blockIdx.x * tw - k;
  const int ext_w = w + 2 * k;

  // ---- load the window: block interior, or the halo slab it falls in ----
  for (int wr = ty; wr < rows; wr += kBlockY) {
    const int r = r0 + wr;
    for (int wc = tx; wc < cols; wc += kBlockX) {
      const int c = c0 + wc;
      float v = 0.0f;  // beyond a ragged edge: never reaches the output
      if (r < 0) {
        if (c < w + k) v = top[static_cast<size_t>(r + k) * ext_w + c + k];
      } else if (r >= h) {
        if (r < h + k && c < w + k)
          v = bottom[static_cast<size_t>(r - h) * ext_w + c + k];
      } else if (c < 0) {
        v = lcol[static_cast<size_t>(r) * k + c + k];
      } else if (c >= w) {
        if (c < w + k) v = rcol[static_cast<size_t>(r) * k + c - w];
      } else {
        v = x[static_cast<size_t>(r) * w + c];
      }
      a[wr * cols + wc] = v;
    }
  }

  // ---- k sweeps in shared memory; the valid region shrinks one ring ----
  for (int s = 0; s < k; ++s) {
    __syncthreads();
    const int lo = s + 1;
    const int row_hi = rows - s - 1;
    const int col_hi = cols - s - 1;
    for (int wr = lo + ty; wr < row_hi; wr += kBlockY) {
      const int gr = row0 + r0 + wr;
      const bool row_edge = gr == 0 || gr == gh - 1;
      const float* src = a + wr * cols;
      float* dst = b + wr * cols;
      for (int wc = lo + tx; wc < col_hi; wc += kBlockX) {
        const int gc = col0 + c0 + wc;
        const float center = src[wc];
        if (row_edge || gc == 0 || gc == gw - 1) {
          dst[wc] = center;
        } else {
          dst[wc] = 0.25f * (((src[wc - cols] + src[wc + cols]) +
                              src[wc - 1]) + src[wc + 1]);
        }
      }
    }
    float* t = a;
    a = b;
    b = t;
  }
  __syncthreads();

  // ---- write back the centre tile only ----
  for (int wr = k + ty; wr < k + th; wr += kBlockY) {
    const int r = r0 + wr;
    if (r >= h) break;
    for (int wc = k + tx; wc < k + tw; wc += kBlockX) {
      const int c = c0 + wc;
      if (c < w) out[static_cast<size_t>(r) * w + c] = a[wr * cols + wc];
    }
  }
}

}  // namespace

extern "C" int smi_stencil_temporal(const float* x, const float* top,
                                    const float* bottom, const float* lcol,
                                    const float* rcol, float* out, int h,
                                    int w, int row0, int col0, int gh, int gw,
                                    int depth, int tile_h, int tile_w,
                                    void* stream) {
  const size_t smem = 2 * sizeof(float) *
                      static_cast<size_t>(tile_h + 2 * depth) *
                      static_cast<size_t>(tile_w + 2 * depth);
  cudaError_t err = cudaFuncSetAttribute(
      temporal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + tile_w - 1) / tile_w, (h + tile_h - 1) / tile_h);
  temporal_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      x, top, bottom, lcol, rcol, out, h, w, row0, col0, gh, gw, depth,
      tile_h, tile_w);
  return static_cast<int>(cudaGetLastError());
}
