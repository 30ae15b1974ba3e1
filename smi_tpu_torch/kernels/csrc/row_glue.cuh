// Pieces shared by the row-wise glue kernels (attn_glue.cu and
// residual_norm.cu): the exact bf16 widening and the round-to-nearest
// packing of two values a 32-bit word, the warp's butterfly sum, and the
// block-order sum of a fixed grid's partial weight gradients.
//
// The weight gradients of a glue kernel's norms are summed without
// atomics: its backward runs a fixed grid (``_build.fixed_grid``: a set
// number of blocks an SM, whatever the row count above it) whose blocks
// stride over the rows, each block writing one partial a column; then
// weight_grad_kernel sums the partials in block order. The rows and the
// order of every sum are fixed by the row count, so a step repeats bit
// for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// the two bf16 values of w (the first in the low half), widened: exact,
// a bf16's bits are the high half of the f32
__device__ __forceinline__ void widen_bf16x2(uint32_t w, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

// a and b rounded to bf16, a in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  return bf16_bits(a) | (bf16_bits(b) << 16);
}

// the sum over the warp, the same bits in every lane
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(kFull, v, off);
  }
  return v;
}

constexpr int kSumWarps = 8;

// dw[col] = sum of partial[i * columns + col] over the blocks i: a block
// 32 columns, its warps each a strided share of the blocks, then the
// warps' sums in warp order
__global__ void __launch_bounds__(32 * kSumWarps)
    weight_grad_kernel(const float* __restrict__ partial, int blocks,
                       int columns, float* __restrict__ dw) {
  __shared__ float part[kSumWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float t = 0.0f;
  if (col < columns) {
    for (int i = warp; i < blocks; i += kSumWarps) {
      t += partial[static_cast<long long>(i) * columns + col];
    }
  }
  part[warp][lane] = t;
  __syncthreads();
  if (warp != 0 || col >= columns) return;
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kSumWarps; ++w) total += part[w][lane];
  dw[col] = total;
}

// weight_grad_kernel over (blocks, columns) partials on stream st; the
// launch's CUDA status
int sum_weight_grads(const float* partial, int blocks, int columns,
                     float* dw, cudaStream_t st) {
  weight_grad_kernel<<<(columns + 31) / 32, 32 * kSumWarps, 0, st>>>(
      partial, blocks, columns, dw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
