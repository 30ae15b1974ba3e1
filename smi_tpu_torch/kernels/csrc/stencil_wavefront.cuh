// The sweep body of the k-sweep Jacobi kernels (stencil_temporal.cu and
// stencil_pipeline.cu): k sweeps of the 4-point Dirichlet stencil carried
// down a column window on a row wavefront.
//
// A block owns a window of W columns (an output band plus a k-column apron
// on each side) and walks down its rows one at a time. Level 0 of window
// row t is the input; level s of row t-s (sweep s) is produced at the same
// step t, since level s-1 then holds rows t-s-1, t-s and t-s+1. Each cell
// is read from the input once, goes through every level on chip and leaves
// once, as level k; the row apron is 2k rows a stripe, not a ring a sweep.
//
// Two forms:
//  * run_registers<K, C>: a thread owns C adjacent columns and keeps, for
//    each level below K, the last two rows of them in registers (2·K·C
//    floats: C = columns(K) = 4, 4, 2 at K = 8, 16, 32, so at most 128).
//    Up, down and the inner left/right neighbours are registers. The edge columns cross threads:
//    by __shfl_up_sync/__shfl_down_sync inside a warp, and for lanes 0 and
//    31 through a small shared-memory slab per warp. A level's horizontal
//    neighbours are its centre row, which the previous step produced, so
//    one block barrier a row step (not a sweep) publishes every level's
//    edges at once (two parities). Per cell and sweep: 4 f32 operations,
//    2/C shuffles and 2/C selects.
//  * run_shared: any depth, one column a thread, each level's last three
//    rows in shared memory (five shared-memory words a cell and sweep):
//    the generic loop for depths the register form has no instance for.
//
// Arithmetic: 0.25f * (((up + down) + left) + right) in f32, each level at
// -fmad=false, so a level is bit-identical to one serial sweep. The
// Dirichlet mask is the global one (rows and columns 0 and g-1) at every
// level; a row step takes the masked levels only where it reaches a held
// row, or in a warp that holds a boundary column (a branch the warp takes
// as one). Cells beyond the global grid are averaged like any other:
// only boundary cells read them, and those hold. Garbage (the unwritten
// first levels, zero-filled rows and columns past the input) spreads one
// cell a level, so after k levels it has not reached the band.
//
// bf16 neighbours (the pipeline's mixed form): each value is rounded once
// when it is produced and kept only in that form, which every later use
// reads as a neighbour. Its f32 form is needed only as the output (level k,
// written before rounding) and as a held boundary value, which equals the
// cell's input value: the block keeps the input's f32 values of the global
// boundary rows and columns it holds (Keep) and holds from those.
//
// An IO class supplies the rows and takes the results:
//   begin()                  before the first step;
//   step(t)                  after step t's barrier (prefetch, copies);
//   fetch(t, float (&)[C])   the thread's C input values of window row t;
//   store(o, t, const float (&)[C])  level k of output row o (window row
//                            k + o), produced at step t;
//   end(t)                   after the last step t.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wavefront {

constexpr unsigned kFull = 0xffffffffu;
// rows of a boundary column's input kept for bf16 holds (> depth + 1)
constexpr int kKeepRing = 128;
// row steps unrolled together in run_registers (padding steps past the
// window load zeros and store nothing)
constexpr int kStepUnroll = 2;

// A block's window: its cell (i, j) is global cell (g_row + i, g_col + j);
// output rows are window rows k .. k + rows - 1.
struct Window {
  int k;
  int rows;
  int g_row, g_col;
  int gh, gw;
};

// Input f32 values of the boundary cells a block holds (bf16 only):
// rows[0][j], rows[1][j] the window's cells on global rows 0 and gh-1;
// cols[s][i % kKeepRing] window row i of global column 0 (s = 0) or gw-1
// (s = 1). Each entry is written and read by the one thread that owns it.
struct Keep {
  float* rows;  // [2][W]
  float* cols;  // [2][kKeepRing]
  int width;    // W
};

// Columns a thread owns at depth K (0: the generic loop).
__host__ __device__ constexpr int columns(int K) {
  return K == 32 ? 2 : K == 0 ? 1 : 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool kBf16>
__device__ __forceinline__ float neighbour_form(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

__device__ __forceinline__ bool on_edge(int g, int n) {
  return g == 0 || g == n - 1;
}

// Keep the f32 input values of the boundary cells among a thread's C
// columns of window row t (bf16 holds read them back).
template <int C>
__device__ __forceinline__ void keep_inputs(const Keep& keep,
                                            const Window& win, int t, int j0,
                                            int colmask, const float* v) {
  const int g = win.g_row + t;
  if (on_edge(g, win.gh)) {
    float* row = keep.rows + (g == 0 ? 0 : keep.width) + j0;
#pragma unroll
    for (int c = 0; c < C; ++c) row[c] = v[c];
  }
  if (colmask) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (colmask >> c & 1) {
        const int side = win.g_col + j0 + c == 0 ? 0 : 1;
        keep.cols[side * kKeepRing + (t & (kKeepRing - 1))] = v[c];
      }
    }
  }
}

// The input values of a held row (global row g) and of a held column
// (window row i), from the Keep (bf16).
__device__ __forceinline__ float kept_row(const Keep& keep, int g, int j) {
  return keep.rows[(g == 0 ? 0 : keep.width) + j];
}

__device__ __forceinline__ float kept_col(const Keep& keep,
                                          const Window& win, int i, int j) {
  const int side = win.g_col + j == 0 ? 0 : 1;
  return keep.cols[side * kKeepRing + (i & (kKeepRing - 1))];
}

// Bit c set where the thread's column c lies on global column 0 or gw-1.
template <int C>
__device__ __forceinline__ int column_mask(const Window& win, int j0) {
  int mask = 0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (on_edge(win.g_col + j0 + c, win.gw)) mask |= 1 << c;
  }
  return mask;
}

// Shared memory of run_registers' edge slabs, in floats.
template <int K>
__host__ __device__ constexpr int edge_floats(int warps) {
  return 2 * (warps + 2) * 2 * K;
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// Whether a row step whose levels compute window rows [ts - depth, ts)
// reaches a held row (global row 0 or gh - 1): the same for the block.
__device__ __forceinline__ bool holds_rows(const Window& win, int ts,
                                           int depth) {
  const int top = -win.g_row;             // window row of global row 0
  const int bottom = win.gh - 1 - win.g_row;
  return (top >= ts - depth && top < ts) ||
         (bottom >= ts - depth && bottom < ts);
}

// K sweeps (win.k == K) with C columns a thread, levels in registers;
// `edges` holds edge_floats<K>(warps) floats.
template <int K, int C, bool kBf16, class IO>
__device__ __forceinline__ void run_registers(IO& io, const Window& win,
                                              float* edges,
                                              const Keep& keep) {
  static_assert(K % 4 == 0, "edges move four levels at a time");
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = blockDim.x >> 5;
  const int j0 = tid * C;
  // edges[parity][warp + 1][side][K]: side 0 the warp's column 0, side 1
  // its last; warps -1 and `warps` are zero slabs past the window
  const int parity_stride = (warps + 2) * 2 * K;
  for (int i = tid; i < 2 * parity_stride; i += blockDim.x) edges[i] = 0.0f;
  // lane 0 reads the left warp's side 1, lane 31 the right warp's side 0;
  // the other lanes read lane 0's words (a broadcast)
  const int in_off = lane == 31 ? (warp + 2) * 2 * K : warp * 2 * K + K;
  const int out_off = (warp + 1) * 2 * K + (lane == 31 ? K : 0);
  const int colmask = column_mask<C>(win, j0);
  // the warp holds a boundary column: it takes the masked levels at every
  // step, as one (no shuffle ever runs in a divergent branch)
  const bool column_warp = __any_sync(kFull, colmask != 0);

  float up[K][C], ce[K][C];
#pragma unroll
  for (int l = 0; l < K; ++l) {
#pragma unroll
    for (int c = 0; c < C; ++c) up[l][c] = ce[l][c] = 0.0f;
  }

  // The K levels of step ts: d is level 0 of window row ts on entry and
  // level K of row ts - K on exit (n32, before bf16 rounding). kHold:
  // the global boundary's cells keep their value.
  auto levels = [&](auto hold, int ts, float(&d)[C], float(&n32)[C]) {
    constexpr bool kHold = decltype(hold)::value;
    // the other warps' edges of every level's centre row, written at
    // step ts-1 with parity (ts-1)&1
    const float4* ein = reinterpret_cast<const float4*>(
        edges + ((ts + 1) & 1) * parity_stride + in_off);
    float4 e4;
#pragma unroll
    for (int l = 0; l < K; ++l) {
      if (l % 4 == 0) e4 = ein[l / 4];
      const float e = l % 4 == 0   ? e4.x
                      : l % 4 == 1 ? e4.y
                      : l % 4 == 2 ? e4.z
                                   : e4.w;
      float from_left = __shfl_up_sync(kFull, ce[l][C - 1], 1);
      float from_right = __shfl_down_sync(kFull, ce[l][0], 1);
      if (lane == 0) from_left = e;
      if (lane == 31) from_right = e;
      // level l+1 of window row ts-l-1
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float left = c > 0 ? ce[l][c - 1] : from_left;
        const float right = c < C - 1 ? ce[l][c + 1] : from_right;
        n32[c] = 0.25f * (((up[l][c] + d[c]) + left) + right);
      }
      if constexpr (kHold) {
        const int i = ts - l - 1;
        const int g = win.g_row + i;
        if (on_edge(g, win.gh)) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            n32[c] = kBf16 ? kept_row(keep, g, j0 + c) : ce[l][c];
          }
        } else if (column_warp) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float held =
                kBf16 ? kept_col(keep, win, i, j0 + c) : ce[l][c];
            n32[c] = (colmask >> c & 1) ? held : n32[c];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        up[l][c] = ce[l][c];
        ce[l][c] = d[c];
        d[c] = neighbour_form<kBf16>(n32[c]);
      }
    }
  };

  const int steps = win.rows + 2 * K;
  io.begin();
  int t = 0;
  for (; t < steps; t += kStepUnroll) {
#pragma unroll
    for (int u = 0; u < kStepUnroll; ++u) {
      const int ts = t + u;
      __syncthreads();
      io.step(ts);
      float d[C];
      io.fetch(ts, d);
      if constexpr (kBf16) keep_inputs<C>(keep, win, ts, j0, colmask, d);
#pragma unroll
      for (int c = 0; c < C; ++c) d[c] = neighbour_form<kBf16>(d[c]);
      float n32[C];
      if (column_warp || holds_rows(win, ts, K)) {
        levels(Flag<true>{}, ts, d, n32);
      } else {
        levels(Flag<false>{}, ts, d, n32);
      }
      // n32: level K of window row ts-K, output row ts-2K
      io.store(ts - 2 * K, ts, n32);
      if (lane == 0 || lane == 31) {
        float4* eout = reinterpret_cast<float4*>(
            edges + (ts & 1) * parity_stride + out_off);
#pragma unroll
        for (int l = 0; l < K; l += 4) {
          eout[l / 4] = lane == 0
                            ? make_float4(ce[l][0], ce[l + 1][0],
                                          ce[l + 2][0], ce[l + 3][0])
                            : make_float4(ce[l][C - 1], ce[l + 1][C - 1],
                                          ce[l + 2][C - 1], ce[l + 3][C - 1]);
        }
      }
    }
  }
  io.end(t - 1);
}

// Shared memory of run_shared: three rows of each level, padded by a
// column on each side.
__host__ __device__ constexpr int level_floats(int k, int width) {
  return 3 * k * (width + 2);
}

// Any depth, one column a thread (W = blockDim.x), levels in shared memory
// (`levels`: level_floats(k, W) floats).
template <bool kBf16, class IO>
__device__ __forceinline__ void run_shared(IO& io, const Window& win,
                                           float* levels,
                                           const Keep& keep) {
  const int j = threadIdx.x;
  const int width = blockDim.x;
  const int pitch = width + 2;
  const int k = win.k;
  for (int i = j; i < level_floats(k, width); i += width) levels[i] = 0.0f;
  const int colmask = column_mask<1>(win, j);
  const int steps = win.rows + 2 * k;
  io.begin();
  for (int t = 0; t < steps; ++t) {
    __syncthreads();
    io.step(t);
    float v[1];
    io.fetch(t, v);
    if constexpr (kBf16) keep_inputs<1>(keep, win, t, j, colmask, v);
    float d = neighbour_form<kBf16>(v[0]);
    float n32[1] = {d};
    const bool hold = colmask || holds_rows(win, t, k);
    // level l's rows live in slots (row mod 3): d is row t-l
    int slot = t % 3;
    for (int l = 0; l < k; ++l) {
      float* rows = levels + l * 3 * pitch + 1 + j;
      float* fresh = rows + slot * pitch;
      const float* centre = rows + (slot == 0 ? 2 : slot - 1) * pitch;
      const float* above = rows + (slot == 2 ? 0 : slot + 1) * pitch;
      n32[0] = 0.25f * (((above[0] + d) + centre[-1]) + centre[1]);
      if (hold) {
        const int i = t - l - 1;
        const int g = win.g_row + i;
        if (on_edge(g, win.gh)) {
          n32[0] = kBf16 ? kept_row(keep, g, j) : centre[0];
        } else if (colmask) {
          n32[0] = kBf16 ? kept_col(keep, win, i, j) : centre[0];
        }
      }
      fresh[0] = d;
      d = neighbour_form<kBf16>(n32[0]);
      slot = slot == 0 ? 2 : slot - 1;
    }
    io.store(t - 2 * k, t, n32);
  }
  io.end(steps - 1);
}

}  // namespace wavefront
