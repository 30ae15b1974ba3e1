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
// rows; its window is the band plus k columns each side (a warp of C
// columns at a time), and it streams down the stripe plus k rows above
// and below, so the apron costs (band + 2k)/band in columns and
// (stripe + 2k)/stripe in rows, once. At k = 8, 16 and 32 the levels live
// in registers (no shared-memory word on the sweep path; 2/C shuffles a
// cell and sweep, one block barrier a row step), split among P level
// groups of warps in the depth's form (form(): P, C and the launch bound
// that caps the registers); other depths run the generic loop with the
// levels in shared memory. Input rows arrive through a 4-deep cp.async
// ring in shared memory, each thread of the first group copying its own
// columns (16 bytes at a time where they are aligned) straight from the
// block or the halo slab they fall in (no padded copy is made; past the
// slabs it zero-fills), so a thread reads only what it copied and needs
// no barrier for it. The last group writes level k straight to the second
// device buffer, a 16-byte store a thread where its columns all lie in
// the band: neighbouring blocks read each other's aprons, so the pass
// cannot write in place. The plan (stencil_temporal.py) cuts the stripes
// so that the blocks fill whole waves of the card (SMs x blocks an SM),
// the last one nearly full; the outer bands launch first (their
// held-column warps take longer), so the last wave is of plain blocks.
//
// Registers and warps an SM (H100 SXM, ptxas figures): k = 16 runs two
// groups of 8 levels (64 floats of state a thread, 125 registers, blocks
// of 8 warps, 2 an SM: 16 warps); k = 8 one group (119 registers, blocks
// of 4 warps, 4 an SM: 16 warps); k = 32 four groups of 8 levels (128
// registers, blocks of 16 warps, 1 an SM). Every level of k = 16 in one
// thread needs 218 registers, which leave an SM 8 warps, too few to keep
// its issue rate up. More groups are slower: a warp's step then does
// fewer levels while its own work (the input or the output, the edges,
// the hold test) stays. What bounds the kernel is instruction issue:
// about 5.4 instructions a cell and sweep in the levels and 2.8 more from
// each step's own work, over a swept area 1.31x the output at k = 16.
//
// Arithmetic: 0.25f * (((up + down) + left) + right) in f32 and the
// Dirichlet mask from global coordinates (row0, col0, gh, gw) at every
// sweep, built with -fmad=false and without fast math, so the result is
// bit-identical to k serial sweeps of the numpy reference. Window cells
// outside the global grid hold whatever the halo slabs carry (zeros at the
// domain edge) and are read only by boundary cells, which hold.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "stencil_wavefront.cuh"

namespace {

using wavefront::Keep;
using wavefront::Window;

constexpr int kPrefetch = 4;  // input rows in flight a block (power of 2)

// The shape of temporal_kernel<K>: level groups, columns a thread, and
// its launch bound (threads a block at most; blocks an SM holds at
// least, which caps ptxas's registers). K = 0 is the generic loop.
struct Form {
  int groups, columns, max_threads, min_blocks;
};

__host__ __device__ constexpr Form form(int K) {
  return K == 8    ? Form{1, 4, 128, 4}
         : K == 16 ? Form{2, 4, 256, 2}
         : K == 32 ? Form{4, 4, 512, 1}
                   : Form{1, 1, 256, 1};
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   wavefront::smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// Four floats, both sides 16-byte aligned, past L1.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   wavefront::smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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
// __grid_constant__ parameter, read in place. What does not change from
// row to row (where the thread's columns come from, which of them it
// writes) is worked out once.
template <int C>
struct TemporalIO {
  const Args& a;
  float* slots;  // the thread's columns of ring slot 0: [kPrefetch][width]
  int width;
  int r0, c0;    // block row and column of window cell (0, 0)
  int rows, j0;
  // the thread's columns of block row r, 0 <= r < h, start at next +
  // (r - r0 - t) * stride when window row t is the next issued, all in one
  // of the block, `lcol` or `rcol` and (C a multiple of 4) every 4 of them
  // 16-byte aligned: then fast_r0 is r0; else (they straddle two, lie
  // past the slabs or are misaligned) it is far below any row
  int fast_r0;
  int stride;
  const float* next;
  // output row o of the thread's columns starts at out + o * a.w; bit c
  // of `writes`: column c lies in the band and the block
  float* out;
  int writes;
  bool wide_out;

  __device__ __forceinline__ TemporalIO(const Args& args, float* ring,
                                        int width_, int r0_, int c0_,
                                        int rows_, int j0_)
      : a(args), slots(ring + j0_), width(width_), r0(r0_), c0(c0_),
        rows(rows_), j0(j0_) {
    const int c = c0 + j0;  // the thread's first block column
    const int k = a.k;
    const float* src = nullptr;
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
    const bool fast = src != nullptr &&
                      (C % 4 != 0 || (aligned16(src) && stride % 4 == 0));
    fast_r0 = fast ? r0 : -(1 << 30);
    next = src + static_cast<ptrdiff_t>(r0) * stride;
    writes = 0;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int j = j0 + i;
      if (j >= k && j < k + a.band && c0 + j < a.w) writes |= 1 << i;
    }
    out = a.out + (static_cast<ptrdiff_t>(r0 + k) * a.w + c);
    wide_out = C % 4 == 0 && writes == (1 << C) - 1 && aligned16(out) &&
               a.w % 4 == 0;
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

  // Window row t into its ring slot (rows come in order).
  __device__ __forceinline__ void issue(int t) {
    float* dst = slots + (t & (kPrefetch - 1)) * width;
    const float* from = next;
    next += stride;
    if (static_cast<unsigned>(fast_r0 + t) < static_cast<unsigned>(a.h)) {
      if constexpr (C % 4 == 0) {
#pragma unroll
        for (int c = 0; c < C; c += 4) cp_async16(dst + c, from + c);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) cp_async4(dst + c, from + c, 4);
      }
    } else {
      // the apron rows and the aprons of the outer bands: rare
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* from;
        const int bytes = source(r0 + t, c0 + j0 + c, from);
        cp_async4(dst + c, from, bytes);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  __device__ __forceinline__ void begin() {
    for (int t = 0; t < kPrefetch - 1; ++t) issue(t);
  }

  __device__ __forceinline__ void step(int t) { issue(t + kPrefetch - 1); }

  __device__ __forceinline__ void fetch(int t, float (&v)[C]) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kPrefetch - 1)
                 : "memory");
    wavefront::load_row<C>(slots + (t & (kPrefetch - 1)) * width, v);
  }

  __device__ __forceinline__ void store(int o, int, const float (&v)[C]) {
    if (static_cast<unsigned>(o) >= static_cast<unsigned>(rows)) return;
    float* dst = out + static_cast<size_t>(o) * a.w;
    if (wide_out) {
      wavefront::store_row<C>(dst, v);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (writes >> c & 1) dst[c] = v[c];
      }
    }
  }

  __device__ __forceinline__ void end(int) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
};

// One block's window: its band and stripe swept at depth K (0: any) with
// C columns a thread in P level groups; the first group's threads read
// the input, the last group's write level k.
template <int K, int C, int P>
__device__ __forceinline__ void sweep_window(const Args& a, float* smem) {
  const int group_threads = blockDim.x / P;
  const int width = group_threads * C;
  // the grid is (stripes, bands), and the outer bands come first: they
  // hold the global boundary's columns where the block reaches it, and a
  // warp that holds one takes longer, so their blocks run early and the
  // last wave is of plain ones
  const int last = gridDim.y - 1;
  const int band = blockIdx.y == 1 ? last : blockIdx.y == 0 ? 0
                                                            : blockIdx.y - 1;
  const int s0 = blockIdx.x * a.stripe;  // first output row of the block
  const int b0 = band * a.band;          // first output column
  const Window win{a.k, min(a.stripe, a.h - s0), a.row0 + s0 - a.k,
                   a.col0 + b0 - a.k, a.gh, a.gw};
  TemporalIO<C> io(a, smem, width, s0 - a.k, b0 - a.k, win.rows,
                   static_cast<int>(threadIdx.x) % group_threads * C);
  float* scratch = smem + kPrefetch * width;
  const Keep none{nullptr, nullptr, 0};  // f32 holds read the centre
  if constexpr (K == 0) {
    wavefront::run_shared<false>(io, win, scratch, none);
  } else {
    wavefront::run_registers<K, C, P, false>(io, win, scratch, none);
  }
}

// K = 8, 16, 32 in their form (levels in registers), or K = 0: any
// depth, one column a thread (levels in shared memory).
template <int K>
__global__ void __launch_bounds__(form(K).max_threads, form(K).min_blocks)
    temporal_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  sweep_window<K, form(K).columns, form(K).groups>(a, smem);
}

// Threads of a block of form f for a `band`-column band at depth k: each
// group a warp of columns at a time over the window (band + 2k columns).
int block_threads(const Form& f, int k, int band) {
  const int per_warp = 32 * f.columns;
  return f.groups * ((band + 2 * k + per_warp - 1) / per_warp * 32);
}

size_t smem_bytes(const Form& f, bool registers, int k, int threads) {
  const int group_threads = threads / f.groups;
  const int width = group_threads * f.columns;
  const int scratch =
      registers ? wavefront::edge_floats(k, group_threads / 32) +
                      wavefront::hand_floats(f.groups, width)
                : wavefront::level_floats(k, width);
  return sizeof(float) * (kPrefetch * width + scratch);
}

// Set `kernel`'s shared memory, then launch it, or only report the
// blocks an SM holds at once (`blocks_per_sm` not null).
int launch(void (*kernel)(Args), const Form& f, bool registers,
           const Args& a, cudaStream_t stream, int* blocks_per_sm) {
  const int threads = block_threads(f, a.k, a.band);
  if (threads > f.max_threads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_bytes(f, registers, a.k, threads);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_per_sm != nullptr) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, threads, smem));
  }
  const dim3 grid((a.h + a.stripe - 1) / a.stripe,
                  (a.w + a.band - 1) / a.band);
  kernel<<<grid, threads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch(const Args& a, cudaStream_t stream, int* blocks_per_sm) {
  return launch(temporal_kernel<K>, form(K), K != 0, a, stream,
                blocks_per_sm);
}

int dispatch(const Args& a, void* stream, int* blocks_per_sm) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.k) {
    case 8:
      return launch<8>(a, s, blocks_per_sm);
    case 16:
      return launch<16>(a, s, blocks_per_sm);
    case 32:
      return launch<32>(a, s, blocks_per_sm);
    default:
      return launch<0>(a, s, blocks_per_sm);
  }
}

}  // namespace

// tile_h and tile_w are the stripe (output rows a block) and the band
// (output columns a block); the block has P groups of ceil((band + 2k) /
// C) threads, each rounded up to a warp, in the depth's form (P, C):
// (1, 4), (2, 4), (4, 4) at depth 8, 16, 32; (1, 1) at any other.
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
