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
//  * run_registers<K, C, P>: P level groups of warps, each covering the
//    window with C adjacent columns a thread; group g carries levels
//    [g·K/P, (g+1)·K/P) and keeps, for each, the last two rows of its
//    columns in registers (2·(K/P)·C floats a thread). Up, down and the
//    inner left/right neighbours are registers. The edge columns cross
//    threads: by __shfl_up_sync/__shfl_down_sync inside a warp, and for
//    lanes 0 and 31 through a small shared-memory slab per warp of the
//    group. A level's horizontal neighbours are its centre row, which the
//    previous step produced, so one block barrier a row step (not a sweep)
//    publishes every level's edges at once (two parities). Between groups
//    a hand-off slab of two parities carries a row: group g-1 writes its
//    last level's row at step ts, group g reads it at step ts+1, each
//    thread the columns its partner wrote, after the same barrier. So
//    group g runs g steps behind group 0, and a window takes
//    rows + 2K + P - 1 steps. Group 0 alone reads the input, the last
//    group alone writes level K. Per cell and sweep: 4 f32 operations,
//    2/C shuffles and 2/C selects; a row a step crosses each seam.
//    Splitting the levels frees registers for more warps an SM (every
//    level in one thread, 2·K·C floats, needs 218 registers at K = 16,
//    C = 4: 8 warps an SM); it also divides each warp's work between two
//    barriers by P while the step's own work (the input, the output, the
//    edges, the hold test) stays, so a group carries at least 8 levels
//    where it can.
//  * run_shared: any depth, one column a thread, each level's last three
//    rows in shared memory (five shared-memory words a cell and sweep):
//    the generic loop for depths the register form has no instance for.
//
// Arithmetic: 0.25f * (((up + down) + left) + right) in f32, each level at
// -fmad=false, so a level is bit-identical to one serial sweep. The
// Dirichlet mask is the global one (rows and columns 0 and g-1) at every
// level; a group's row step takes the masked levels only where its levels
// reach a held row, or only the held columns in a warp that holds one (a
// branch the warp takes as one), else none. Cells beyond the global grid
// are averaged like any other:
// only boundary cells read them, and those hold. Garbage (the unwritten
// first levels, zero-filled rows and columns past the input) spreads one
// cell a level, so after k levels it has not reached the band.
//
// bf16 neighbours (the pipeline's mixed form, one level group only): each
// value is rounded once when it is produced and kept only in that form,
// which every later use reads as a neighbour. Its f32 form is needed only as the output (level k,
// written before rounding) and as a held boundary value, which equals the
// cell's input value: the block keeps the input's f32 values of the global
// boundary rows and columns it holds (Keep) and holds from those.
//
// An IO class supplies the rows and takes the results:
//   begin()                  before the first step (the first group);
//   step(t)                  after step t's barrier (prefetch, copies; the
//                            first group);
//   fetch(t, float (&)[C])   the thread's C input values of window row t
//                            (the first group);
//   store(o, t, const float (&)[C])  level k of output row o (window row
//                            k + o), produced at step t (the last group);
//   end(t)                   after the last step t (every thread).

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

// Columns a thread owns in the one-group form at depth K, as the
// pipeline kernel runs it (0: the generic loop).
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

// A thread's C adjacent values of a shared-memory row, in the widest
// accesses C allows.
template <int C>
__device__ __forceinline__ void load_row(const float* from, float (&v)[C]) {
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

template <int C>
__device__ __forceinline__ void store_row(float* to, const float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      *reinterpret_cast<float4*>(to + c) =
          make_float4(v[c], v[c + 1], v[c + 2], v[c + 3]);
    }
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(to) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) to[c] = v[c];
  }
}

// Shared memory of run_registers' edge slabs, in floats: two parities of
// a slab for each warp of a level group and one each side of the window,
// each side of a warp holding the group's K / groups levels (the same
// total for any number of groups).
__host__ __device__ constexpr int edge_floats(int depth, int group_warps) {
  return 2 * (group_warps + 2) * 2 * depth;
}

// Shared memory of run_registers' hand-off slabs, in floats: two parities
// of a window row for each seam between level groups.
__host__ __device__ constexpr int hand_floats(int groups, int width) {
  return 2 * (groups - 1) * width;
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
  return static_cast<unsigned>(ts - top - 1) < static_cast<unsigned>(depth) ||
         static_cast<unsigned>(ts - bottom - 1) < static_cast<unsigned>(depth);
}

// K sweeps (win.k == K) with C columns a thread, levels in registers, in
// P level groups of blockDim.x / P threads, each covering the window;
// `scratch` holds edge_floats(K, blockDim.x / P / 32) +
// hand_floats(P, blockDim.x / P * C) floats. P = 1: one group carries
// every level.
template <int K, int C, int P, bool kBf16, class IO>
__device__ __forceinline__ void run_registers(IO& io, const Window& win,
                                              float* scratch,
                                              const Keep& keep) {
  static_assert(K % (4 * P) == 0, "edges move four levels at a time");
  static_assert(P == 1 || !kBf16,
                "a bf16 hold reads input values only the first group keeps");
  constexpr int L = K / P;  // levels a group carries
  const int tid = threadIdx.x;
  const int group_threads = blockDim.x / P;
  // warp-uniform: a group is whole warps
  const int group = P == 1 ? 0 : tid / group_threads;
  const int gtid = tid - group * group_threads;
  const int lane = tid & 31;
  const int warp = gtid >> 5;
  const int warps = group_threads >> 5;
  const int width = group_threads * C;
  const int j0 = gtid * C;
  const int lo = group * L;  // the group's first level
  // edges[parity][group][warp + 1][side][L]: side 0 the warp's column 0,
  // side 1 its last; warps -1 and `warps` are zero slabs past the window
  const int group_stride = (warps + 2) * 2 * L;
  const int parity_stride = P * group_stride;
  float* edges = scratch;
  // hand[parity][seam][width]: level lo + L of a window row, from the
  // group before a seam to the one after it
  float* hand = scratch + 2 * parity_stride;
  const int zeroed = 2 * parity_stride + hand_floats(P, width);
  for (int i = tid; i < zeroed; i += blockDim.x) scratch[i] = 0.0f;
  // lane 0 reads the left warp's side 1, lane 31 the right warp's side 0;
  // the other lanes read lane 0's words (a broadcast)
  const int in_off = group * group_stride +
                     (lane == 31 ? (warp + 2) * 2 * L : warp * 2 * L + L);
  const int out_off =
      group * group_stride + (warp + 1) * 2 * L + (lane == 31 ? L : 0);
  const bool publishes = lane == 0 || lane == 31;
  const int colmask = column_mask<C>(win, j0);
  // the warp holds a boundary column: it takes the held-column levels at
  // every step, as one (no shuffle ever runs in a divergent branch)
  const bool column_warp = __any_sync(kFull, colmask != 0);
  // level lo + l at the group's step tg computes global row 0 where
  // tg - l == hold_top, row gh - 1 where tg - l == hold_bottom
  const int hold_top = lo + 1 - win.g_row;
  const int hold_bottom = lo + win.gh - win.g_row;

  float up[L][C], ce[L][C];
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int c = 0; c < C; ++c) up[l][c] = ce[l][c] = 0.0f;
  }

  // The group's levels at its step tg (the block's step ts less the
  // group): d is level lo of window row tg - lo on entry and level lo + L
  // of row tg - lo - L on exit (n32, before bf16 rounding). The global
  // boundary's cells keep their value: kRows, on held rows and columns;
  // kCols, on held columns alone (a warp that holds one, on a step that
  // reaches no held row).
  auto levels = [&](auto rows, auto cols, int ts, int tg, float(&d)[C],
                    float(&n32)[C]) {
    constexpr bool kRows = decltype(rows)::value;
    constexpr bool kCols = decltype(cols)::value;
    // the other warps' edges of every level's centre row, written at
    // step ts-1 with parity (ts-1)&1
    const float4* edge_in = reinterpret_cast<const float4*>(
        edges + ((ts + 1) & 1) * parity_stride + in_off);
    float4 e4;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      if (l % 4 == 0) e4 = edge_in[l / 4];
      const float e = l % 4 == 0   ? e4.x
                      : l % 4 == 1 ? e4.y
                      : l % 4 == 2 ? e4.z
                                   : e4.w;
      float from_left = __shfl_up_sync(kFull, ce[l][C - 1], 1);
      float from_right = __shfl_down_sync(kFull, ce[l][0], 1);
      if (lane == 0) from_left = e;
      if (lane == 31) from_right = e;
      // level lo+l+1 of window row tg-lo-l-1
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float left = c > 0 ? ce[l][c - 1] : from_left;
        const float right = c < C - 1 ? ce[l][c + 1] : from_right;
        n32[c] = 0.25f * (((up[l][c] + d[c]) + left) + right);
      }
      const int i = tg - lo - l - 1;
      if constexpr (kRows) {
        if (tg - l == hold_top || tg - l == hold_bottom) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            n32[c] = kBf16 ? kept_row(keep, win.g_row + i, j0 + c) : ce[l][c];
          }
        } else if (column_warp) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float held =
                kBf16 ? kept_col(keep, win, i, j0 + c) : ce[l][c];
            n32[c] = (colmask >> c & 1) ? held : n32[c];
          }
        }
      } else if constexpr (kCols) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float held = kBf16 ? kept_col(keep, win, i, j0 + c) : ce[l][c];
          n32[c] = (colmask >> c & 1) ? held : n32[c];
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

  // group g runs g steps behind group 0: the last group's level K of
  // window row r comes K + P - 1 steps after row r's input
  const int steps = win.rows + 2 * K + P - 1;
  if (group == 0) io.begin();
  int t = 0;
  for (; t < steps; t += kStepUnroll) {
#pragma unroll
    for (int u = 0; u < kStepUnroll; ++u) {
      const int ts = t + u;
      const int tg = ts - group;
      __syncthreads();
      float d[C];
      if (group == 0) {
        io.step(ts);
        io.fetch(ts, d);
        if constexpr (kBf16) keep_inputs<C>(keep, win, ts, j0, colmask, d);
#pragma unroll
        for (int c = 0; c < C; ++c) d[c] = neighbour_form<kBf16>(d[c]);
      } else {
        // level lo of window row tg - lo, handed over at step ts - 1
        load_row<C>(hand + ((ts + 1) & 1) * (P - 1) * width +
                        (group - 1) * width + j0,
                    d);
      }
      float n32[C];
      if (static_cast<unsigned>(tg - hold_top) < static_cast<unsigned>(L) ||
          static_cast<unsigned>(tg - hold_bottom) < static_cast<unsigned>(L)) {
        levels(Flag<true>{}, Flag<true>{}, ts, tg, d, n32);
      } else if (column_warp) {
        levels(Flag<false>{}, Flag<true>{}, ts, tg, d, n32);
      } else {
        levels(Flag<false>{}, Flag<false>{}, ts, tg, d, n32);
      }
      if (group == P - 1) {
        // n32: level K of window row tg-K, output row tg-2K
        io.store(tg - 2 * K, ts, n32);
      } else {
        store_row<C>(hand + (ts & 1) * (P - 1) * width + group * width + j0,
                     d);
      }
      // lane 0 publishes its column 0, lane 31 its last (selects and
      // predicated stores: no branch)
      float4* eout = reinterpret_cast<float4*>(
          edges + (ts & 1) * parity_stride + out_off);
#pragma unroll
      for (int l = 0; l < L; l += 4) {
        const float4 e = make_float4(
            lane == 0 ? ce[l][0] : ce[l][C - 1],
            lane == 0 ? ce[l + 1][0] : ce[l + 1][C - 1],
            lane == 0 ? ce[l + 2][0] : ce[l + 2][C - 1],
            lane == 0 ? ce[l + 3][0] : ce[l + 3][C - 1]);
        if (publishes) eout[l / 4] = e;
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
