// A chain of `length` dependent whole-array steps on each of `chains`
// independent f32 arrays, every step between two shared-memory buffers:
// a rotation by one along the lanes (dim 1) or the sublanes (dim 0), or
// an add of 1.0 (the harness floor).
//
// Replaces: smi_tpu/benchmarks/surface.py::roll_chain_points, its inner
// `kernel` (surface.py:562). There the whole array sits in VMEM for all R
// steps and each step is one `pltpu.roll` (or one `v + 1.0`), so the
// R-difference of two chain lengths prices the rotation port alone. The
// Hopper counterpart of that access is the one the port's stencil kernels
// make for a neighbour: a shifted read from one shared buffer and a write
// to the other, with one barrier a step (stencil_temporal.cu).
//
// Bound on the H100: shared-memory bandwidth. A step reads each element
// once and writes it once, 8 B an element, against 128 B per clock per SM
// (32 banks of 4 B). At 512x2048 and R=4096 that is 34.4 GB of shared
// traffic, about 1.0 ms over 132 SMs at 1.98 GHz; device memory sees the
// 4 MiB array once each way (0.0025 ms at 3.35 TB/s).
//
// Design: each CUDA block owns a tile of every chain in which the rolled
// axis is whole, so a step needs nothing from another block: whole rows
// for `lane` and `add`, a band of whole columns for `sublane`. The
// wrapper picks the tile so that a block holds about 8192 elements (128
// blocks cover the timed 1,048,576). The block loads its tiles into
// shared memory once, runs the steps between two buffers with one
// __syncthreads a step, and writes back once. A thread owns up to kPer
// elements; their source indices, wrap included, are computed once before
// the step loop, so a step is a load, a store (and an add) per element.
// With two chains the block advances both under the same barrier. The
// tile keeps the array's row-major layout, so a lane step reads the word
// beside it and a sublane step the word one tile row up, as the stencil's
// horizontal and vertical neighbours do; both are free of bank conflicts
// at the timed shapes (a warp reads 32 distinct banks). The `add` body
// goes through the same buffers and barrier and reads its own index, so
// roll minus add isolates the shifted address. Tiles above 48 KB opt in
// to the larger dynamic shared memory with cudaFuncSetAttribute.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChains = 4;
constexpr int kPer = 16;           // elements a thread owns at most
constexpr int kMaxThreads = 1024;  // so a block holds at most 16384
constexpr int kLane = 0;
constexpr int kSublane = 1;
constexpr int kAdd = 2;

struct Chains {
  const float* in[kMaxChains];
  float* out[kMaxChains];
};

// tile_rows x tile_cols is the plan's tile of one chain; the block's own
// tile may be smaller at the ragged end of the axis that is cut.
template <int BODY>
__global__ void __launch_bounds__(kMaxThreads)
    roll_chain_kernel(Chains ch, int chains, int rows, int cols, int length,
                      int tile_rows, int tile_cols) {
  extern __shared__ float smem[];
  int row0 = 0, col0 = 0, th = rows, tw = cols;
  if (BODY == kSublane) {
    col0 = blockIdx.x * tile_cols;
    tw = min(tile_cols, cols - col0);
  } else {
    row0 = blockIdx.x * tile_rows;
    th = min(tile_rows, rows - row0);
  }
  const int per_chain = th * tw;
  const int n = chains * per_chain;
  float* a = smem;
  float* b = smem + chains * tile_rows * tile_cols;

  // ---- load, and each element's source index, wrap included ----------
  int src[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    src[k] = e;
    if (e < n) {
      const int c = e / per_chain;
      const int i = e - c * per_chain;
      const int r = i / tw;
      const int q = i - r * tw;
      if (BODY == kLane) {
        src[k] = c * per_chain + r * tw + (q == 0 ? tw - 1 : q - 1);
      } else if (BODY == kSublane) {
        src[k] = c * per_chain + (r == 0 ? th - 1 : r - 1) * tw + q;
      }
      a[e] = ch.in[c][static_cast<size_t>(row0 + r) * cols + col0 + q];
    }
  }
  __syncthreads();

  // ---- the chain: one read and one write per element, one barrier ----
  float* s = a;
  float* d = b;
  for (int step = 0; step < length; ++step) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * blockDim.x;
      if (e < n) {
        float v = s[src[k]];
        if (BODY == kAdd) v = v + 1.0f;
        d[e] = v;
      }
    }
    __syncthreads();
    float* t = s;
    s = d;
    d = t;
  }

  // ---- write back ------------------------------------------------------
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * blockDim.x;
    if (e < n) {
      const int c = e / per_chain;
      const int i = e - c * per_chain;
      const int r = i / tw;
      const int q = i - r * tw;
      ch.out[c][static_cast<size_t>(row0 + r) * cols + col0 + q] = s[e];
    }
  }
}

template <int BODY>
int launch(const Chains& ch, int chains, int rows, int cols, int length,
           int tile_rows, int tile_cols, cudaStream_t stream) {
  const int tile = chains * tile_rows * tile_cols;
  const int threads = ((tile + kPer - 1) / kPer + 31) / 32 * 32;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(tile) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      roll_chain_kernel<BODY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = BODY == kSublane
                         ? (cols + tile_cols - 1) / tile_cols
                         : (rows + tile_rows - 1) / tile_rows;
  roll_chain_kernel<BODY><<<blocks, threads, smem, stream>>>(
      ch, chains, rows, cols, length, tile_rows, tile_cols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ins/outs: host arrays of `chains` device pointers, each a contiguous
// (rows, cols) f32 array; body 0 lane, 1 sublane, 2 add. The tile is the
// wrapper's plan (roll.py::plan).
extern "C" int smi_roll_chain(const void* const* ins, void* const* outs,
                              int chains, int rows, int cols, int length,
                              int body, int tile_rows, int tile_cols,
                              void* stream) {
  if (chains < 1 || chains > kMaxChains || rows < 1 || cols < 1 ||
      length < 0 || tile_rows < 1 || tile_cols < 1 ||
      (body == kSublane ? tile_rows != rows : tile_cols != cols))
    return static_cast<int>(cudaErrorInvalidValue);
  Chains ch{};
  for (int c = 0; c < chains; ++c) {
    ch.in[c] = static_cast<const float*>(ins[c]);
    ch.out[c] = static_cast<float*>(outs[c]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (body) {
    case kLane:
      return launch<kLane>(ch, chains, rows, cols, length, tile_rows,
                           tile_cols, s);
    case kSublane:
      return launch<kSublane>(ch, chains, rows, cols, length, tile_rows,
                              tile_cols, s);
    case kAdd:
      return launch<kAdd>(ch, chains, rows, cols, length, tile_rows,
                          tile_cols, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
