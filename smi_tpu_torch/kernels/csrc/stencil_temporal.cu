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
// cell, whatever k is): at 8192^2 and k=16, 537 MB, 0.1609 ms at 3.35
// TB/s. Its 4.3 G cell-sweeps are 4 f32 instructions each at -fmad=false
// (no FMA to fold them into): 0.128 ms at 33.5 T instructions/s (132 SMs x
// 128 lanes x 1.98 GHz). So a pass is near both floors at once, and only
// if the apron stays small and the neighbour exchange costs well under one
// instruction a cell and sweep. The first form swept a shrinking
// 2-D window in shared memory: six shared-memory words a cell and sweep
// over 1.54x the output at k=16 (2.29x at k=32) and a block barrier a
// sweep, 15x the bound.
//
// Design: the row wavefront of stencil_wavefront.cuh. A block owns a
// column band of `tile_w` output columns and a stripe of `tile_h` output
// rows; its window is the band plus k columns each side, W = threads x C
// columns, and it streams down the stripe plus k rows above and below, so
// the apron costs (band + 2k)/band in columns and (stripe + 2k)/stripe in
// rows, once. At k = 8, 16 and 32 each thread keeps every level's last two
// rows of its C = 4, 4 or 2 columns in registers (no shared-memory word on
// the sweep path; 2/C shuffles a cell and sweep, one block barrier a row
// step); other depths run the generic loop with the levels in shared
// memory. Input rows arrive through a 4-deep cp.async ring in shared
// memory, each thread copying its own columns straight from the block or
// the halo slab they fall in (no padded copy is made; past the slabs it
// zero-fills), so a thread reads only what it copied and needs no barrier
// for it. Level k goes straight to the second device buffer: neighbouring
// blocks read each other's aprons, so the pass cannot write in place. The
// plan (stencil_temporal.py) cuts stripes of at most 128 rows: on the card
// several waves of such blocks beat one wave of long ones, apron and all.
//
// Arithmetic: 0.25f * (((up + down) + left) + right) in f32 and the
// Dirichlet mask from global coordinates (row0, col0, gh, gw) at every
// sweep, built with -fmad=false and without fast math, so the result is
// bit-identical to k serial sweeps of the numpy reference. Window cells
// outside the global grid hold whatever the halo slabs carry (zeros at the
// domain edge) and are read only by boundary cells, which hold.

#include <cuda_runtime.h>

#include <cstdint>

#include "stencil_wavefront.cuh"

namespace {

using wavefront::Keep;
using wavefront::columns;
using wavefront::Window;

constexpr int kMaxThreads = 256;
constexpr int kPrefetch = 4;  // input rows in flight a block (power of 2)

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   wavefront::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

struct Args {
  const float* x;
  const float* top;     // (k, w + 2k)
  const float* bottom;  // (k, w + 2k)
  const float* lcol;    // (h, k)
  const float* rcol;    // (h, k)
  float* out;
  int h, w, row0, col0, gh, gw, k, stripe, band;
};

// Rows from the block and its halo slabs by cp.async into a ring of
// kPrefetch rows; level k straight to `out`. `a` is the kernel's
// __grid_constant__ parameter, read in place.
template <int C>
struct TemporalIO {
  const Args& a;
  float* ring;  // [kPrefetch][width]
  int width;
  int r0, c0;   // block row and column of window cell (0, 0)
  int rows, j0;
  // the thread's columns of a block row r (0 <= r < h) start at
  // src + r * stride, all in one of the block, `lcol` or `rcol`; a null
  // src: they straddle two, or lie past the slabs
  const float* src;
  int stride;

  __device__ __forceinline__ void columns_source() {
    const int c = c0 + j0;  // the thread's first block column
    const int k = a.k;
    src = nullptr;
    stride = 0;
    if (c >= 0 && c + C <= a.w) {
      src = a.x + c;
      stride = a.w;
    } else if (c >= -k && c + C <= 0) {
      src = a.lcol + (c + k);
      stride = k;
    } else if (c >= a.w && c + C <= a.w + k) {
      src = a.rcol + (c - a.w);
      stride = k;
    }
  }

  // Where block cell (r, c) is read from, and 4, or 0 past the slabs.
  __device__ __forceinline__ int source(int r, int c,
                                        const float*& from) const {
    const int k = a.k;
    const size_t ext = static_cast<size_t>(a.w) + 2 * k;
    from = a.x;
    if (r < -k || r >= a.h + k || c < -k || c >= a.w + k) return 0;
    if (r < 0) {
      from = a.top + static_cast<size_t>(r + k) * ext + (c + k);
    } else if (r >= a.h) {
      from = a.bottom + static_cast<size_t>(r - a.h) * ext + (c + k);
    } else if (c < 0) {
      from = a.lcol + static_cast<size_t>(r) * k + (c + k);
    } else if (c >= a.w) {
      from = a.rcol + static_cast<size_t>(r) * k + (c - a.w);
    } else {
      from = a.x + static_cast<size_t>(r) * a.w + c;
    }
    return 4;
  }

  __device__ __forceinline__ void issue(int t) {
    float* dst = ring + (t & (kPrefetch - 1)) * width + j0;
    const int r = r0 + t;
    if (src != nullptr && r >= 0 && r < a.h) {
      const float* from = src + static_cast<size_t>(r) * stride;
#pragma unroll
      for (int c = 0; c < C; ++c) cp_async4(dst + c, from + c, 4);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* from;
        const int bytes = source(r, c0 + j0 + c, from);
        cp_async4(dst + c, from, bytes);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ __forceinline__ void begin() {
    columns_source();
    for (int t = 0; t < kPrefetch - 1; ++t) issue(t);
  }

  __device__ __forceinline__ void step(int t) { issue(t + kPrefetch - 1); }

  __device__ __forceinline__ void fetch(int t, float (&v)[C]) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPrefetch - 1)
                 : "memory");
    const float* from = ring + (t & (kPrefetch - 1)) * width + j0;
    if constexpr (C % 4 == 0) {
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        const float4 q = *reinterpret_cast<const float4*>(from + c);
        v[c] = q.x;
        v[c + 1] = q.y;
        v[c + 2] = q.z;
        v[c + 3] = q.w;
      }
    } else if constexpr (C == 2) {
      const float2 q = *reinterpret_cast<const float2*>(from);
      v[0] = q.x;
      v[1] = q.y;
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) v[c] = from[c];
    }
  }

  __device__ __forceinline__ void store(int o, int, const float (&v)[C]) {
    if (o < 0 || o >= rows) return;
    float* dst = a.out + static_cast<size_t>(r0 + a.k + o) * a.w + c0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      if (j >= a.k && j < a.k + a.band && c0 + j < a.w) dst[j] = v[c];
    }
  }

  __device__ __forceinline__ void end(int) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
};

// K = 8, 16, 32 with C = columns(K) columns a thread (levels in
// registers), or K = 0: any depth, one column a thread (levels in shared
// memory).
template <int K>
__global__ void __launch_bounds__(kMaxThreads, 1)
    temporal_kernel(const __grid_constant__ Args a) {
  constexpr int C = columns(K);
  extern __shared__ __align__(16) float smem[];
  const int width = blockDim.x * C;
  const int s0 = blockIdx.y * a.stripe;  // first output row of the block
  const int b0 = blockIdx.x * a.band;    // first output column
  const Window win{a.k, min(a.stripe, a.h - s0), a.row0 + s0 - a.k,
                   a.col0 + b0 - a.k, a.gh, a.gw};
  TemporalIO<C> io{a,      smem,     width, s0 - a.k, b0 - a.k,
                   win.rows, static_cast<int>(threadIdx.x) * C};
  float* scratch = smem + kPrefetch * width;
  const Keep none{nullptr, nullptr, 0};  // f32 holds read the centre
  if constexpr (K == 0) {
    wavefront::run_shared<false>(io, win, scratch, none);
  } else {
    wavefront::run_registers<K, C, false>(io, win, scratch, none);
  }
}

template <int K>
size_t smem_bytes(int k, int threads) {
  const int width = threads * columns(K);
  const int scratch = K == 0 ? wavefront::level_floats(k, width)
                             : wavefront::edge_floats<K>(threads / 32);
  return sizeof(float) * (kPrefetch * width + scratch);
}

// Set the kernel's shared memory, then launch it, or only report the
// blocks an SM holds at once (`blocks_per_sm` not null).
template <int K>
int launch(const Args& a, int threads, cudaStream_t stream,
           int* blocks_per_sm = nullptr) {
  const size_t smem = smem_bytes<K>(a.k, threads);
  cudaError_t err = cudaFuncSetAttribute(
      temporal_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_per_sm != nullptr) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, temporal_kernel<K>, threads, smem));
  }
  const dim3 grid((a.w + a.band - 1) / a.band,
                  (a.h + a.stripe - 1) / a.stripe);
  temporal_kernel<K><<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const Args& a, void* stream, int* blocks_per_sm) {
  const int k = a.k;
  const int cols = columns(k == 8 || k == 16 || k == 32 ? k : 0);
  const int threads = (a.band + 2 * k + 32 * cols - 1) / (32 * cols) * 32;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 8:
      return launch<8>(a, threads, s, blocks_per_sm);
    case 16:
      return launch<16>(a, threads, s, blocks_per_sm);
    case 32:
      return launch<32>(a, threads, s, blocks_per_sm);
    default:
      return launch<0>(a, threads, s, blocks_per_sm);
  }
}

}  // namespace

// tile_h and tile_w are the stripe (output rows a block) and the band
// (output columns a block); the block has ceil((band + 2k) / C) threads,
// rounded up to a warp, C = columns(depth) (4, 4, 2 at depth 8, 16, 32; 1
// at any other).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a plan it cannot run.
extern "C" int smi_stencil_temporal(const float* x, const float* top,
                                    const float* bottom, const float* lcol,
                                    const float* rcol, float* out, int h,
                                    int w, int row0, int col0, int gh, int gw,
                                    int depth, int tile_h, int tile_w,
                                    void* stream) {
  const int k = depth;
  if (h < 1 || w < 1 || k < 1 || k > h || k > w || tile_h < 1 ||
      tile_w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x, top, bottom, lcol, rcol, out, h, w, row0, col0, gh, gw, k,
               tile_h, tile_w};
  return dispatch(a, stream, nullptr);
}

// The blocks of a `tile_w`-column band at `depth` an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a CUDA error.
extern "C" int smi_stencil_temporal_blocks_per_sm(int depth, int tile_w) {
  if (depth < 1 || tile_w < 1) return -static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.k = depth;
  a.band = tile_w;
  int blocks = 0;
  const int status = dispatch(a, nullptr, &blocks);
  return status != 0 ? -status : blocks;
}
