// Flash-attention backward (FlashAttention-2) for the ring-attention
// schedule: two kernels, one per gradient orientation, in two dtypes.
//
// Replaces: smi_tpu/kernels/flash.py::_bwd_dq_kernel (driven by
// flash_block_backward_dq: dq of one K/V block) and
// smi_tpu/kernels/flash.py::_bwd_dkdv_kernel (driven by
// flash_block_backward_dkdv: dk and dv of one K/V block from this rank's
// queries, the GQA group reduced in the kernel). Both recompute the
// probabilities from the forward's saved row statistics, so nothing
// quadratic is stored:
//   P  = exp(Q K^T * scale - m) * linv   (0 where masked)
//   dP = dO V^T,  dS = P o (dP - delta)
//   dQ = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO
// with linv = 1 / l (rows that no key reached map to 1) and
// delta = rowsum(dO o O), both formed by the caller.
//
// Layouts are the JAX package's: q and dout (H, Sq, D), k and v
// (H_kv, Sk, D) in f32 or bf16; m, linv, delta (H, 1, Sq) f32 rows; dq
// (H, Sq, D) f32; dk and dv (H_kv, Sk, D) f32. Query head hh reads K/V
// head hh / (H / H_kv). Causality and the sliding window come from global
// positions q_off + i and k_off + j.
//
// Bound on the H100: operations. dq does 6*D operations per live
// query-key pair (Q K^T, dO V^T, dS K), dkdv 8*D (K Q^T, V dO^T, P^T dO,
// dS^T Q); at S=8192, H=8, D=128 causal that is 206 and 275 GFLOP: 0.21
// and 0.28 ms at the 989 TFLOP/s of dense bf16 on the tensor cores, 3.1
// and 4.1 ms at the 67 TFLOP/s of f32 on the CUDA cores (full f32, no
// TF32: the reference runs HIGHEST).
//
// Design, bf16 (FlashAttention-3 in shape, the forward's vocabulary): a
// block of 384 threads is one producer warp (its warpgroup gives its
// registers to the others by setmaxnreg) and two consumer warpgroups.
// The producer issues TMA loads through 3-D tensor maps (D, S, heads) in
// 128-byte-swizzled boxes of 64 columns, so a ragged tile fills with
// zeros inside its head; streamed tiles go through a two-stage ring with
// a "full" and an "empty" mbarrier a stage.
// - dq: a block owns 128 query rows of one head (64 a consumer
//   warpgroup). Q and dO load once; K and V tiles of BK keys stream. S =
//   Q K^T and dP = dO V^T are wgmma with both operands in shared memory
//   (K-major), issued together; P forms in the accumulator registers while
//   dP is in flight; dS = P o (dP - delta) is packed to bf16 (K's dtype)
//   before the fence, and dq += dS K is wgmma with A from registers and K
//   read MN-major (the transpose bit), as the forward reads V.
// - dkdv: a block owns 128 keys of one K/V head (64 a consumer
//   warpgroup); K and V load once. For each query head of the group, only
//   the live query tiles stream, Q and dO with their m * log2(e), linv and
//   delta (the producer warp writes those rows into the stage and arrives
//   on its full barrier: 1 + 32 arrivals). S^T = K Q^T and dP^T = V dO^T
//   are wgmma from shared memory; P^T (dout's dtype) and dS^T (q's) pack
//   to bf16 in registers; dV += P^T dO and dK += dS^T Q are wgmma with dO
//   and Q read MN-major. The statistics are per column of the
//   accumulator, so they are read from shared memory. dK and dV stay in
//   registers across the whole group: no atomics, the same bits on every
//   run. Where 128-key blocks would leave most SMs idle (a GQA ring's
//   short blocks: twice the blocks still fit one wave), the caller asks
//   for the 64-key form: both consumer warpgroups take the same 64 keys
//   and one half each of a 2x taller query tile, and the second adds its
//   dK and dV to the first's through shared memory after the loop, in a
//   fixed order.
// - D=256: dq key tiles of 32; dkdv query tiles of 32 (64 in the
//   64-key form) and the output columns split in halves over gridDim.y,
//   each block recomputing the full-D scores.
// - Q and K may be wider than V and dO (DQK, DV): bf16 takes (192, 128),
//   DeepSeek-V3's latent attention, where dq is 192 wide (wgmma
//   m64n192k16 over three boxes) and dkdv keeps dK (192 columns) and dV
//   (128) whole in registers, on query tiles of 32 (the 128-key form
//   only: its blocks fill the card at every shape the model runs). Per
//   live pair dq does 4*DQK + 2*DV operations, dkdv 4*DQK + 4*DV.
//
// Design, f32 (no wgmma form; TF32 would miss the 2e-5 bar): the
// forward's register-tiled FFMA. 256 threads; thread (ty, tx) holds the
// rows ty + 16 i of each score tile at columns tx + 16 j and of its
// accumulators at the float4 columns 64 g + 4 tx; operands are float4s
// from shared rows padded by 16 bytes, broadcast across the 16 threads
// of a row. dq: 128 query rows a block (64 at D=256), K and V tiles of
// 32 keys, dP = dO V^T first so that the next V loads by cp.async during
// Q K^T and dS K, and the next K during the next dO V^T. dkdv: 128 keys
// a block (32 at D=256, where K and V are twice as wide), query tiles of
// 32 rows, P^T and dS^T staged in shared memory for the two
// accumulations; dK += dS^T Q comes first, so the next Q and its
// statistics load during dV += P^T dO, and the next dO during the next
// K Q^T.
//
// Both: p is ex2.approx of one FMA with log2(e) folded into the scale and
// m; a tile body is compiled with and without the mask, and only a tile
// that straddles the diagonal, the window's edge or a ragged end
// evaluates it. Masked entries are set to 0 by a select, never by
// multiplying: a row with no live key has m = NEG_INF and exp(S - m) =
// +inf there, and inf * 0 is NaN. A zero-filled row past the ragged end
// gives s = 0, not a masked score, so the select covers rows and keys
// past their ends too. A block with no live pair writes exact zeros.
// dq blocks of the last query rows, which walk the most key tiles under
// causality, are issued first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr uint64_t kWaitNs = 10ull * 1000 * 1000 * 1000;  // then trap

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* m;
  const float* linv;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  int h, h_kv, s_q, s_k;
  int q_off, k_off;
  int causal, window;  // window 0: none
  float scale;
};

// ------------------------------------------------------------- shared --

// dq block b owns query rows [q0, q0 + bq) of head hh; under causality
// the last query tiles (the most key tiles each) come first.
__device__ __forceinline__ void block_at(const Params& p, int bq, int& hh,
                                         int& q0) {
  const int n_qt = (p.s_q + bq - 1) / bq;
  hh = blockIdx.x % p.h;
  int qt = blockIdx.x / p.h;
  if (p.causal) qt = n_qt - 1 - qt;
  q0 = qt * bq;
}

// The key tiles [kt0, kt0 + n * bk) that hold a live key for one of the
// rows [q_first, q_first + rows) (global positions), in local key indices.
__device__ __forceinline__ int live_key_tiles(const Params& p,
                                              long long q_first, int rows,
                                              int bk, long long& kt0) {
  long long lo = 0, hi = p.s_k;
  if (p.causal) hi = min(hi, q_first + rows - p.k_off);
  if (p.window > 0) lo = max(lo, q_first - (p.window - 1) - p.k_off);
  kt0 = lo / bk * bk;
  return lo < hi ? static_cast<int>((hi - kt0 + bk - 1) / bk) : 0;
}

// The query tiles [qt0, qt0 + n * bq) that hold a live query for one of
// the keys [k_first, k_first + keys) (global positions), in local query
// indices.
__device__ __forceinline__ int live_query_tiles(const Params& p,
                                                long long k_first, int keys,
                                                int bq, long long& qt0) {
  long long lo = 0, hi = p.s_q;
  if (p.causal) lo = max(lo, k_first - p.q_off);
  if (p.window > 0) hi = min(hi, k_first + keys - 1 + p.window - p.q_off);
  qt0 = lo / bq * bq;
  return lo < hi && keys > 0 ? static_cast<int>((hi - qt0 + bq - 1) / bq)
                             : 0;
}

// Whether no pair of queries [qg, qg + nq) and keys [kg, kg + nk) (global
// positions) is live.
__device__ __forceinline__ bool span_dead(const Params& p, long long qg,
                                          int nq, long long kg, int nk) {
  if (nq <= 0 || nk <= 0) return true;
  if (p.causal && kg > qg + nq - 1) return true;
  return p.window > 0 && kg + nk - 1 < qg - (p.window - 1);
}

// Whether every pair of that span is live by position (the caller checks
// the ragged ends).
__device__ __forceinline__ bool span_full(const Params& p, long long qg,
                                          int nq, long long kg, int nk) {
  bool full = true;
  if (p.causal) full = kg + nk - 1 <= qg;
  if (p.window > 0) full = full && kg >= qg + nq - 1 - (p.window - 1);
  return full;
}

// The mask of one tile in 32-bit positions relative to its first query
// (global qg) and first key (global kg): key j is dead for query i past
// either ragged end, in the query's causal future or before its window.
struct TileMask {
  int diag;         // kg - qg, clamped
  int rows, keys;   // queries and keys left before the ends, clamped
  int causal, window;

  __device__ __forceinline__ bool dead(int i, int j) const {
    const int rel = diag + j - i;
    bool d = i >= rows || j >= keys;
    if (causal) d = d || rel > 0;
    if (window > 0) d = d || rel < 1 - window;
    return d;
  }
};

// Clamped so that i, j < 1024 cannot overflow; a clamped distance
// decides every comparison as the exact one would.
__device__ __forceinline__ TileMask tile_mask(const Params& p, long long qg,
                                              long long rows, long long kg,
                                              long long keys) {
  constexpr long long kFar = (1ll << 31) - 2048;
  return TileMask{static_cast<int>(max(-kFar, min(kFar, kg - qg))),
                  static_cast<int>(max(-1ll, min(4096ll, rows))),
                  static_cast<int>(max(-1ll, min(4096ll, keys))), p.causal,
                  p.window};
}

// 2^x by the special-function unit: exact 0 at -inf, about 2^-22
// relative error elsewhere
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// P of one score s: exp(s * scale - m) * linv, with scale_log2 = scale *
// log2(e) and ml = m * log2(e)
__device__ __forceinline__ float prob(float s, float scale_log2, float ml,
                                      float linv) {
  return fast_exp2(fmaf(s, scale_log2, -ml)) * linv;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --------------------------------------------------------------- bf16 --

__device__ __forceinline__ void barrier_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void barrier_expect(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void barrier_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait for the phase of `parity` to complete; trap after kWaitNs rather
// than hang the card.
__device__ __forceinline__ void barrier_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = now_ns();
    } else if (now_ns() - start > kWaitNs) {
      __trap();
    }
  }
}

// One box of a 3-D tensor map (`map`: the address of a __grid_constant__
// CUtensorMap) at (c0, c1, c2), innermost first.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t descriptor(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving an accumulator's reads or writes across
// the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}

// wgmma m64nNk16, f32 += bf16 x bf16. wgmma_ss: A and B from shared
// memory, both K-major; wgmma_rs: A from registers (the m16n8k16 A
// fragment of each warp's 16 rows), B from shared memory MN-major.
// The accumulator d[j][e] of a thread is that of mma.sync m16n8 tile j:
// rows warp*16 + lane/4 (e = 0, 1) and + 8 (e = 2, 3), columns
// j*8 + 2*(lane%4) + (e & 1).
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[24][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95 "
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
        "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
        "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
        "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
        "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
        "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
        "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
        "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
        "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Issue s (64 x N) = A B^T over all D columns: A's 64 rows and B's N
// rows both K-major, in boxes of 64 columns a_box and b_box bytes apart;
// D/16 steps of k16, 32 bytes apart inside a 128-byte row.
template <int D, int NT>
__device__ __forceinline__ void issue_dots(float (&s)[NT][4],
                                           const unsigned char* A,
                                           uint32_t a_box,
                                           const unsigned char* B,
                                           uint32_t b_box) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc / 4, w = (kc % 4) * 32;
    wgmma_ss(s, descriptor(A + c * a_box + w, 16, 1024),
             descriptor(B + c * b_box + w, 16, 1024), 1);
  }
}

// Issue o (64 x N) += A B: A the packed bf16 fragments of K/16 steps of
// k16, B (K x N) MN-major: its rows kk*16.. at B + kk*16*128, its N
// columns in boxes of 64, b_box bytes apart.
template <int KS, int NT>
__device__ __forceinline__ void issue_products(float (&o)[NT][4],
                                               const uint32_t (&a)[KS][4],
                                               const unsigned char* B,
                                               uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    wgmma_rs(o, a[kk], descriptor(B + kk * 16 * 128, b_box, 1024));
  }
}

// The m16n8k16 A fragment of score tiles 2kk and 2kk + 1
template <int NT>
__device__ __forceinline__ void pack_fragment(const float (&x)[NT][4],
                                              int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
  a[1] = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
  a[2] = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
  a[3] = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
}

template <int DQK, int DV>
struct DqBf16 {
  static constexpr int kThreads = 384;  // two consumer warpgroups, one producer
  static constexpr int BQ = 128;        // 64 query rows per consumer warpgroup
  static constexpr int BK = DQK == 256 ? 32 : 64;  // keys per tile
  static constexpr int kStages = 2;
  static constexpr int NT = BK / 8;     // score accumulator tiles
  static constexpr int DT = DQK / 8;    // dq accumulator tiles
  static constexpr int kQKChunks = DQK / 64;  // boxes of 64 columns (128 bytes)
  static constexpr int kVChunks = DV / 64;
  static constexpr uint32_t kQBytes = BQ * DQK * 2;   // Q
  static constexpr uint32_t kOBytes = BQ * DV * 2;    // dO
  static constexpr uint32_t kKBytes = BK * DQK * 2;   // one K tile
  static constexpr uint32_t kVBytes = BK * DV * 2;    // one V tile
  static constexpr uint32_t kStageBytes = kKBytes + kVBytes;
  static constexpr uint32_t kBarOffset = kQBytes + kOBytes + kStages * kStageBytes;
  // 1024: slack to align the base to the swizzle's 1024-byte period
  static constexpr size_t kSmem = 1024 + kBarOffset + 64;
};

// One (64, BK) tile into this warpgroup's dq. Qw/dOw: the warpgroup's
// 64 rows of Q and dO; Ks/Vs: the stage's tiles. ml, li, dl: the rows'
// m * log2(e), linv and delta.
template <int DQK, int DV, bool kMask>
__device__ __forceinline__ void dq_tile_bf16(
    const unsigned char* Qw, const unsigned char* dOw,
    const unsigned char* Ks, const unsigned char* Vs,
    float (&o)[DqBf16<DQK, DV>::DT][4], const float (&ml)[2],
    const float (&li)[2], const float (&dl)[2], float scale_log2,
    const TileMask& mask, int warp, int lane) {
  using L = DqBf16<DQK, DV>;
  const int g = lane >> 2, t = lane & 3;
  float s[L::NT][4], dp[L::NT][4];
#pragma unroll
  for (int j = 0; j < L::NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  }
  fence_operands(s);
  fence_operands(dp);
  wgmma_fence();
  issue_dots<DQK>(s, Qw, L::BQ * 128, Ks, L::BK * 128);
  wgmma_commit();
  issue_dots<DV>(dp, dOw, L::BQ * 128, Vs, L::BK * 128);
  wgmma_commit();
  wgmma_wait<1>();
  fence_operands(s);
#pragma unroll
  for (int j = 0; j < L::NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = prob(s[j][e], scale_log2, ml[e >> 1], li[e >> 1]);
      if (kMask &&
          mask.dead(warp * 16 + g + 8 * (e >> 1), j * 8 + 2 * t + (e & 1))) {
        x = 0.f;
      }
      s[j][e] = x;
    }
  }
  wgmma_wait<0>();
  fence_operands(dp);
  // dS, rounded to K's dtype, packed whole before the fence
#pragma unroll
  for (int j = 0; j < L::NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[j][e] = s[j][e] * (dp[j][e] - dl[e >> 1]);
  }
  uint32_t a[L::BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < L::BK / 16; ++kk) pack_fragment(dp, kk, a[kk]);
  fence_operands(o);
  wgmma_fence();
  issue_products(o, a, Ks, L::BK * 128);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(o);
}

template <int DQK, int DV>
__global__ void __launch_bounds__(384, 1)
    flash_dq_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = DqBf16<DQK, DV>;
  constexpr int kChunks =
      L::kQKChunks > L::kVChunks ? L::kQKChunks : L::kVChunks;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + L::kQBytes;
  unsigned char* stages = dOs + L::kOBytes;
  uint64_t* rows_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full = rows_full + 1;
  uint64_t* empty = full + L::kStages;

  int hh, q0;
  block_at(p, L::BQ, hh, q0);
  const int kvh = hh / (p.h / p.h_kv);
  long long kt0;
  const int n_tiles = live_key_tiles(p, (long long)p.q_off + q0,
                                     min(L::BQ, p.s_q - q0), L::BK, kt0);

  if (threadIdx.x == 0) {
    barrier_init(rows_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      barrier_init(&full[s], 1);
      barrier_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && n_tiles > 0) {
      barrier_expect(rows_full, L::kQBytes + L::kOBytes);
      for (int c = 0; c < kChunks; ++c) {
        if (c < L::kQKChunks) {
          tma_load(Qs + c * L::BQ * 128, &tq, rows_full, c * 64, q0, hh);
        }
        if (c < L::kVChunks) {
          tma_load(dOs + c * L::BQ * 128, &tdo, rows_full, c * 64, q0, hh);
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % L::kStages;
        if (i >= L::kStages) {
          barrier_wait(&empty[stage], (i / L::kStages - 1) & 1);
        }
        unsigned char* Kb = stages + stage * L::kStageBytes;
        unsigned char* Vb = Kb + L::kKBytes;
        const int kt = static_cast<int>(kt0) + i * L::BK;
        barrier_expect(&full[stage], L::kStageBytes);
        for (int c = 0; c < kChunks; ++c) {
          if (c < L::kQKChunks) {
            tma_load(Kb + c * L::BK * 128, &tk, &full[stage], c * 64, kt,
                     kvh);
          }
          if (c < L::kVChunks) {
            tma_load(Vb + c * L::BK * 128, &tv, &full[stage], c * 64, kt,
                     kvh);
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + wg * 64;  // the warpgroup's first row
    const int rows_left = p.s_q - r0;
    const long long wq_first = (long long)p.q_off + r0;
    const size_t row0 = size_t(hh) * p.s_q;  // (hh, 0) of the rows and dq
    const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};
    const float scale_log2 = p.scale * kLog2e;

    float ml[2], li[2], dl[2], o[L::DT][4];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const bool here = rows[hr] < p.s_q;
      ml[hr] = here ? p.m[row0 + rows[hr]] * kLog2e : 0.f;
      li[hr] = here ? p.linv[row0 + rows[hr]] : 0.f;
      dl[hr] = here ? p.delta[row0 + rows[hr]] : 0.f;
#pragma unroll
      for (int dt = 0; dt < L::DT; ++dt) {
        o[dt][2 * hr] = o[dt][2 * hr + 1] = 0.f;
      }
    }

    if (n_tiles > 0) barrier_wait(rows_full, 0);
    const unsigned char* Qw = Qs + wg * 64 * 128;
    const unsigned char* dOw = dOs + wg * 64 * 128;
    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % L::kStages;
      const long long kt = kt0 + (long long)i * L::BK;
      const long long kg = p.k_off + kt;
      const int keys = static_cast<int>(min((long long)L::BK, p.s_k - kt));
      barrier_wait(&full[stage], (i / L::kStages) & 1);
      if (!span_dead(p, wq_first, min(64, rows_left), kg, keys)) {
        const unsigned char* Kb = stages + stage * L::kStageBytes;
        const TileMask mask = tile_mask(p, wq_first, rows_left, kg, p.s_k - kt);
        if (rows_left >= 64 && keys == L::BK &&
            span_full(p, wq_first, 64, kg, L::BK)) {
          dq_tile_bf16<DQK, DV, false>(Qw, dOw, Kb, Kb + L::kKBytes, o, ml,
                                       li, dl, scale_log2, mask, warp, lane);
        } else {
          dq_tile_bf16<DQK, DV, true>(Qw, dOw, Kb, Kb + L::kKBytes, o, ml,
                                      li, dl, scale_log2, mask, warp, lane);
        }
      }
      __syncwarp();
      if (lane == 0) barrier_arrive(&empty[stage]);
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (rows[hr] >= p.s_q) continue;
      float* a = p.dq + (row0 + rows[hr]) * DQK + 2 * t;
#pragma unroll
      for (int dt = 0; dt < L::DT; ++dt) {
        *reinterpret_cast<float2*>(a + dt * 8) =
            make_float2(o[dt][2 * hr] * p.scale, o[dt][2 * hr + 1] * p.scale);
      }
    }
  }
}

// kSplit: the 64-key form, both consumer warpgroups on the block's 64
// keys, each on one half of a query tile twice as tall. At DQK = 256 the
// output columns are split in halves over gridDim.y (kColSplit). At
// (DQK, DV) = (192, 128) a warpgroup takes query tiles of 32: dK (192
// columns) and dV (128) stay in 160 registers a thread across the loop.
template <int DQK, int DV, bool kSplit>
struct DkdvBf16 {
  static constexpr int kThreads = 384;
  // queries a warpgroup a tile
  static constexpr int QN = DQK == 256 || DQK != DV ? 32 : 64;
  static constexpr int KB = kSplit ? 64 : 128;   // keys a block
  static constexpr int QT = kSplit ? 2 * QN : QN;  // query rows a tile
  static constexpr int kColSplit = DQK == 256 ? 2 : 1;
  static constexpr int DOK = DQK / kColSplit;  // dK columns a block
  static constexpr int DOV = DV / kColSplit;   // dV columns a block
  static constexpr int kStages = 2;
  static constexpr int NT = QN / 8;    // score accumulator tiles
  static constexpr int DTK = DOK / 8;  // dK accumulator tiles
  static constexpr int DTV = DOV / 8;  // dV accumulator tiles
  static constexpr int kQKChunks = DQK / 64;
  static constexpr int kVChunks = DV / 64;
  static constexpr uint32_t kKBytes = KB * DQK * 2;  // K
  static constexpr uint32_t kVBytes = KB * DV * 2;   // V
  static constexpr uint32_t kQBytes = QT * DQK * 2;  // one Q tile
  static constexpr uint32_t kOBytes = QT * DV * 2;   // one dO tile
  static constexpr uint32_t kStageBytes = kQBytes + kOBytes;
  static constexpr uint32_t kStatOffset =
      kKBytes + kVBytes + kStages * kStageBytes;
  static constexpr int kStatFloats = 3 * QT;  // m * log2(e), linv, delta
  static constexpr uint32_t kBarOffset =
      kStatOffset + kStages * kStatFloats * 4;
  static constexpr size_t kSmem = 1024 + kBarOffset + 64;
};

// One (64 keys, QN queries) tile into this warpgroup's dK and dV. Kw/Vw:
// the warpgroup's 64 keys (boxes KB rows apart); Qw/dOw: its QN rows of
// the stage's tiles (boxes QT rows apart); st: the stage's statistics
// from its first row; c0k/c0v: the block's first dK and dV columns.
template <int DQK, int DV, bool kSplit, bool kMask>
__device__ __forceinline__ void dkdv_tile_bf16(
    const unsigned char* Kw, const unsigned char* Vw,
    const unsigned char* Qw, const unsigned char* dOw, const float* st,
    float (&dk)[DkdvBf16<DQK, DV, kSplit>::DTK][4],
    float (&dv)[DkdvBf16<DQK, DV, kSplit>::DTV][4], float scale_log2,
    int c0k, int c0v, const TileMask& mask, int warp, int lane) {
  using L = DkdvBf16<DQK, DV, kSplit>;
  const int g = lane >> 2, t = lane & 3;
  float s[L::NT][4], dp[L::NT][4];
#pragma unroll
  for (int j = 0; j < L::NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
  }
  fence_operands(s);
  fence_operands(dp);
  wgmma_fence();
  issue_dots<DQK>(s, Kw, L::KB * 128, Qw, L::QT * 128);
  wgmma_commit();
  issue_dots<DV>(dp, Vw, L::KB * 128, dOw, L::QT * 128);
  wgmma_commit();
  wgmma_wait<1>();
  fence_operands(s);
  // P^T: row = key, column = query; the statistics are the column's
#pragma unroll
  for (int j = 0; j < L::NT; ++j) {
    const int col = j * 8 + 2 * t;
    const float2 ml = *reinterpret_cast<const float2*>(st + col);
    const float2 li = *reinterpret_cast<const float2*>(st + L::QT + col);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = prob(s[j][e], scale_log2, (e & 1) ? ml.y : ml.x,
                     (e & 1) ? li.y : li.x);
      if (kMask && mask.dead(col + (e & 1), warp * 16 + g + 8 * (e >> 1))) {
        x = 0.f;
      }
      s[j][e] = x;
    }
  }
  wgmma_wait<0>();
  fence_operands(dp);
  // P^T rounded to dout's dtype, dS^T to q's, packed before the fence
  uint32_t ap[L::QN / 16][4], as[L::QN / 16][4];
#pragma unroll
  for (int j = 0; j < L::NT; ++j) {
    const float2 dl =
        *reinterpret_cast<const float2*>(st + 2 * L::QT + j * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dp[j][e] = s[j][e] * (dp[j][e] - ((e & 1) ? dl.y : dl.x));
    }
  }
#pragma unroll
  for (int kk = 0; kk < L::QN / 16; ++kk) {
    pack_fragment(s, kk, ap[kk]);
    pack_fragment(dp, kk, as[kk]);
  }
  // the first output boxes
  const uint32_t cbk = (c0k / 64) * L::QT * 128;
  const uint32_t cbv = (c0v / 64) * L::QT * 128;
  fence_operands(dv);
  fence_operands(dk);
  wgmma_fence();
  issue_products(dv, ap, dOw + cbv, L::QT * 128);
  issue_products(dk, as, Qw + cbk, L::QT * 128);
  wgmma_commit();
  wgmma_wait<0>();
  fence_operands(dv);
  fence_operands(dk);
}

template <int DQK, int DV, bool kSplit>
__global__ void __launch_bounds__(384, 1)
    flash_dkdv_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tdo,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = DkdvBf16<DQK, DV, kSplit>;
  constexpr int kChunks =
      L::kQKChunks > L::kVChunks ? L::kQKChunks : L::kVChunks;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + L::kKBytes;
  unsigned char* stages = Vs + L::kVBytes;
  float* stats = reinterpret_cast<float*>(smem + L::kStatOffset);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::kStages;

  const int kvh = blockIdx.x % p.h_kv;
  const int k0 = (blockIdx.x / p.h_kv) * L::KB;
  const int c0k = blockIdx.y * L::DOK, c0v = blockIdx.y * L::DOV;
  const int group = p.h / p.h_kv;
  long long qt0;
  const int n_qt = live_query_tiles(p, (long long)p.k_off + k0,
                                    min(L::KB, p.s_k - k0), L::QT, qt0);
  const int n_tiles = group * n_qt;

  if (threadIdx.x == 0) {
    barrier_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      barrier_init(&full[s], 33);  // the expect_tx and the 32 lanes' rows
      barrier_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: lane 0 of its first warp issues every load; the warp
    // writes each tile's statistics
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 288 && n_tiles > 0) {
      if (lane == 0) {
        barrier_expect(kv_full, L::kKBytes + L::kVBytes);
        for (int c = 0; c < kChunks; ++c) {
          if (c < L::kQKChunks) {
            tma_load(Ks + c * L::KB * 128, &tk, kv_full, c * 64, k0, kvh);
          }
          if (c < L::kVChunks) {
            tma_load(Vs + c * L::KB * 128, &tv, kv_full, c * 64, k0, kvh);
          }
        }
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % L::kStages;
        if (i >= L::kStages) {
          barrier_wait(&empty[stage], (i / L::kStages - 1) & 1);
        }
        const int hh = kvh * group + i / n_qt;
        const int qt = static_cast<int>(qt0) + (i % n_qt) * L::QT;
        if (lane == 0) {
          unsigned char* Qb = stages + stage * L::kStageBytes;
          unsigned char* dOb = Qb + L::kQBytes;
          barrier_expect(&full[stage], L::kStageBytes);
          for (int c = 0; c < kChunks; ++c) {
            if (c < L::kQKChunks) {
              tma_load(Qb + c * L::QT * 128, &tq, &full[stage], c * 64, qt,
                       hh);
            }
            if (c < L::kVChunks) {
              tma_load(dOb + c * L::QT * 128, &tdo, &full[stage], c * 64, qt,
                       hh);
            }
          }
        }
        float* st = stats + stage * L::kStatFloats;
        const size_t row0 = size_t(hh) * p.s_q + qt;
        for (int r = lane; r < L::QT; r += 32) {
          const bool here = qt + r < p.s_q;
          st[r] = here ? p.m[row0 + r] * kLog2e : 0.f;
          st[L::QT + r] = here ? p.linv[row0 + r] : 0.f;
          st[2 * L::QT + r] = here ? p.delta[row0 + r] : 0.f;
        }
        barrier_arrive(&full[stage]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    // the warpgroup's keys (local) and its rows of each query tile
    const int wk0 = kSplit ? k0 : k0 + wg * 64;
    const int q_row0 = kSplit ? wg * L::QN : 0;
    const int wkeys = min(64, p.s_k - wk0);
    const long long kg = (long long)p.k_off + wk0;
    const float scale_log2 = p.scale * kLog2e;

    float dk[L::DTK][4], dv[L::DTV][4];
#pragma unroll
    for (int dt = 0; dt < L::DTK; ++dt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[dt][e] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < L::DTV; ++dt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[dt][e] = 0.f;
    }

    if (n_tiles > 0) barrier_wait(kv_full, 0);
    const unsigned char* Kw = Ks + (wk0 - k0) * 128;
    const unsigned char* Vw = Vs + (wk0 - k0) * 128;
    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % L::kStages;
      const long long wqt = qt0 + (long long)(i % n_qt) * L::QT + q_row0;
      const long long qg = p.q_off + wqt;
      const long long rows_left = p.s_q - wqt;
      const int nq = static_cast<int>(min((long long)L::QN, rows_left));
      barrier_wait(&full[stage], (i / L::kStages) & 1);
      if (!span_dead(p, qg, nq, kg, wkeys)) {
        const unsigned char* Qw =
            stages + stage * L::kStageBytes + q_row0 * 128;
        const unsigned char* dOw = Qw + L::kQBytes;
        const float* st = stats + stage * L::kStatFloats + q_row0;
        const TileMask mask = tile_mask(p, qg, rows_left, kg, p.s_k - wk0);
        if (nq == L::QN && wkeys == 64 && span_full(p, qg, L::QN, kg, 64)) {
          dkdv_tile_bf16<DQK, DV, kSplit, false>(Kw, Vw, Qw, dOw, st, dk, dv,
                                                 scale_log2, c0k, c0v, mask,
                                                 warp, lane);
        } else {
          dkdv_tile_bf16<DQK, DV, kSplit, true>(Kw, Vw, Qw, dOw, st, dk, dv,
                                                scale_log2, c0k, c0v, mask,
                                                warp, lane);
        }
      }
      __syncwarp();
      if (lane == 0) barrier_arrive(&empty[stage]);
    }

    if constexpr (kSplit) {
      // the second warpgroup's sums into the first's, in a fixed order,
      // through the stage buffers (every load has landed and been read
      // once both warpgroups pass the first barrier)
      float* red = reinterpret_cast<float*>(stages);
      const int lt = threadIdx.x % 128;
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (wg == 1) {
#pragma unroll
        for (int dt = 0; dt < L::DTK; ++dt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) red[(dt * 4 + e) * 128 + lt] = dk[dt][e];
        }
#pragma unroll
        for (int dt = 0; dt < L::DTV; ++dt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            red[((L::DTK + dt) * 4 + e) * 128 + lt] = dv[dt][e];
          }
        }
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (wg == 1) return;
#pragma unroll
      for (int dt = 0; dt < L::DTK; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dk[dt][e] += red[(dt * 4 + e) * 128 + lt];
      }
#pragma unroll
      for (int dt = 0; dt < L::DTV; ++dt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dv[dt][e] += red[((L::DTK + dt) * 4 + e) * 128 + lt];
        }
      }
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int key = wk0 + warp * 16 + g + 8 * hr;
      if (key >= p.s_k) continue;
      const size_t r = size_t(kvh) * p.s_k + key;
      float* a = p.dk + r * DQK + c0k + 2 * t;
      float* b = p.dv + r * DV + c0v + 2 * t;
#pragma unroll
      for (int dt = 0; dt < L::DTK; ++dt) {
        *reinterpret_cast<float2*>(a + dt * 8) =
            make_float2(dk[dt][2 * hr] * p.scale,
                        dk[dt][2 * hr + 1] * p.scale);
      }
#pragma unroll
      for (int dt = 0; dt < L::DTV; ++dt) {
        *reinterpret_cast<float2*>(b + dt * 8) =
            make_float2(dv[dt][2 * hr], dv[dt][2 * hr + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- f32 --

constexpr int kF32Threads = 256;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [0, rows) of D floats from src (row stride D) into dst (row
// stride LD); rows at or past `avail` fill with zeros and read nothing
template <int D, int LD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long avail, int rows) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += kF32Threads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool valid = r < avail;
    cp_async16(dst + r * LD + c, valid ? src + size_t(r) * D + c : src,
               valid);
  }
}

// s[i][j] = A row (ty + 16 i) . B row (tx + 16 j) over D (row stride LD)
template <int D, int LD, int RM, int CN>
__device__ __forceinline__ void f32_dots(const float* A, const float* B,
                                         float (&s)[RM][CN], int ty,
                                         int tx) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
#pragma unroll
    for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[RM], b[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        float x = s[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        s[i][j] = x;
      }
    }
  }
}

// o[i][g] += sum over k < NK of P[ty + 16 i][k] * B[k][64 g + 4 tx ..]:
// P of row stride PLD, B of row stride LD from its first output column
template <int NK, int LD, int PLD, int RM, int OG>
__device__ __forceinline__ void f32_products(const float* P, const float* B,
                                             float (&o)[RM][OG][4], int ty,
                                             int tx) {
#pragma unroll 2
  for (int kk = 0; kk < NK; kk += 4) {
    float4 pa[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      pa[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * PLD + kk);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 vb[OG];
#pragma unroll
      for (int g = 0; g < OG; ++g) {
        vb[g] = *reinterpret_cast<const float4*>(B + (kk + u) * LD + 64 * g +
                                                 4 * tx);
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float pu = u == 0 ? pa[i].x
                         : u == 1 ? pa[i].y
                         : u == 2 ? pa[i].z
                                  : pa[i].w;
#pragma unroll
        for (int g = 0; g < OG; ++g) {
          o[i][g][0] = fmaf(pu, vb[g].x, o[i][g][0]);
          o[i][g][1] = fmaf(pu, vb[g].y, o[i][g][1]);
          o[i][g][2] = fmaf(pu, vb[g].z, o[i][g][2]);
          o[i][g][3] = fmaf(pu, vb[g].w, o[i][g][3]);
        }
      }
    }
  }
}

template <int D>
struct DqF32 {
  static constexpr int BQ = D == 256 ? 64 : 128;  // query rows a block
  static constexpr int BK = 32;                   // keys a tile
  static constexpr int LD = D + 4;    // Q/dO/K/V row stride (floats)
  // dS row stride: a warp's two half-warps (two rows) 16 banks apart
  static constexpr int PLD = BK + 16;
  static constexpr int RM = BQ / 16;  // rows a thread: ty + 16 i
  static constexpr int CN = BK / 16;  // keys a thread: tx + 16 j
  static constexpr int OG = D / 64;   // dq float4 groups: 64 g + 4 tx
  static constexpr size_t kRowsFloats = size_t(BQ) * LD;
  static constexpr size_t kTileFloats = size_t(BK) * LD;
  static constexpr size_t kSmem =
      4 * (2 * kRowsFloats + 2 * kTileFloats + size_t(BQ) * PLD);
};

// dS of one tile into Ps: P from the scores s, dS = P (dP - delta)
template <int D, bool kMask>
__device__ __forceinline__ void dq_scores_f32(
    const float (&s)[DqF32<D>::RM][DqF32<D>::CN],
    const float (&dp)[DqF32<D>::RM][DqF32<D>::CN], float* Ps,
    const float (&ml)[DqF32<D>::RM], const float (&li)[DqF32<D>::RM],
    const float (&dl)[DqF32<D>::RM], float scale_log2, const TileMask& mask,
    int ty, int tx) {
  using L = DqF32<D>;
#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
#pragma unroll
    for (int j = 0; j < L::CN; ++j) {
      float x = prob(s[i][j], scale_log2, ml[i], li[i]);
      if (kMask && mask.dead(ty + 16 * i, tx + 16 * j)) x = 0.f;
      Ps[(ty + 16 * i) * L::PLD + tx + 16 * j] = x * (dp[i][j] - dl[i]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256, 1)
    flash_dq_f32_kernel(const Params p) {
  using L = DqF32<D>;
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;
  float* dOs = Qs + L::kRowsFloats;
  float* Ks = dOs + L::kRowsFloats;
  float* Vs = Ks + L::kTileFloats;
  float* Ps = Vs + L::kTileFloats;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  int hh, q0;
  block_at(p, L::BQ, hh, q0);
  const int kvh = hh / (p.h / p.h_kv);
  const int rows_here = min(L::BQ, p.s_q - q0);
  const size_t row0 = size_t(hh) * p.s_q;  // (hh, 0) of the rows and dq
  const float* q = static_cast<const float*>(p.q) + (row0 + q0) * D;
  const float* dout = static_cast<const float*>(p.dout) + (row0 + q0) * D;
  const float* k = static_cast<const float*>(p.k) + size_t(kvh) * p.s_k * D;
  const float* v = static_cast<const float*>(p.v) + size_t(kvh) * p.s_k * D;
  const long long q_first = (long long)p.q_off + q0;
  const float scale_log2 = p.scale * kLog2e;

  float ml[L::RM], li[L::RM], dl[L::RM], o[L::RM][L::OG][4];
#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool here = row < p.s_q;
    ml[i] = here ? p.m[row0 + row] * kLog2e : 0.f;
    li[i] = here ? p.linv[row0 + row] : 0.f;
    dl[i] = here ? p.delta[row0 + row] : 0.f;
#pragma unroll
    for (int g = 0; g < L::OG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][g][e] = 0.f;
    }
  }

  long long kt0;
  const int n_tiles = live_key_tiles(p, q_first, rows_here, L::BK, kt0);
  if (n_tiles > 0) {
    // groups in order: Q, dO with V_0; K_0; then V_i+1 and K_i+1 per tile
    load_rows<D, L::LD>(Qs, q, rows_here, L::BQ);
    load_rows<D, L::LD>(dOs, dout, rows_here, L::BQ);
    load_rows<D, L::LD>(Vs, v + kt0 * D, p.s_k - kt0, L::BK);
    cp_async_commit();
    load_rows<D, L::LD>(Ks, k + kt0 * D, p.s_k - kt0, L::BK);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const long long kt = kt0 + (long long)it * L::BK;
    const long long next = kt + L::BK;
    const bool more = it + 1 < n_tiles;
    cp_async_wait<1>();  // V_it (K_it may still be in flight)
    __syncthreads();
    float dp[L::RM][L::CN], s[L::RM][L::CN];
    f32_dots<D, L::LD>(dOs, Vs, dp, ty, tx);
    __syncthreads();  // Vs free: the next V streams in during Q K^T, dS K
    if (more) {
      load_rows<D, L::LD>(Vs, v + next * D, p.s_k - next, L::BK);
      cp_async_commit();
      cp_async_wait<1>();  // K_it
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    f32_dots<D, L::LD>(Qs, Ks, s, ty, tx);
    const long long kg = p.k_off + kt;
    const TileMask mask = tile_mask(p, q_first, p.s_q - q0, kg, p.s_k - kt);
    if (rows_here == L::BQ && next <= p.s_k &&
        span_full(p, q_first, L::BQ, kg, L::BK)) {
      dq_scores_f32<D, false>(s, dp, Ps, ml, li, dl, scale_log2, mask, ty,
                              tx);
    } else {
      dq_scores_f32<D, true>(s, dp, Ps, ml, li, dl, scale_log2, mask, ty, tx);
    }
    __syncthreads();
    f32_products<L::BK, L::LD, L::PLD>(Ps, Ks, o, ty, tx);
    __syncthreads();  // Ks and Ps free: the next K streams in during dO V^T
    if (more) {
      load_rows<D, L::LD>(Ks, k + next * D, p.s_k - next, L::BK);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.s_q) continue;
#pragma unroll
    for (int g = 0; g < L::OG; ++g) {
      *reinterpret_cast<float4*>(p.dq + (row0 + row) * D + 64 * g + 4 * tx) =
          make_float4(o[i][g][0] * p.scale, o[i][g][1] * p.scale,
                      o[i][g][2] * p.scale, o[i][g][3] * p.scale);
    }
  }
}

template <int D>
struct DkdvF32 {
  static constexpr int KB = D == 256 ? 32 : 128;  // keys a block
  static constexpr int QT = 32;                   // query rows a tile
  static constexpr int DO = D < 128 ? D : 128;    // output columns a block
  static constexpr int LD = D + 4;
  static constexpr int PLD = QT + 16;  // P^T and dS^T row stride
  static constexpr int RM = KB / 16;   // keys a thread: ty + 16 i
  static constexpr int CN = QT / 16;   // queries a thread: tx + 16 j
  static constexpr int OG = DO / 64;   // dK/dV float4 groups: 64 g + 4 tx
  static constexpr size_t kKVFloats = size_t(KB) * LD;
  static constexpr size_t kTileFloats = size_t(QT) * LD;
  // K, V, one Q and one dO tile, m/linv/delta of its rows, P^T, dS^T
  static constexpr size_t kSmem =
      4 * (2 * kKVFloats + 2 * kTileFloats + 3 * QT + 2 * size_t(KB) * PLD);
};

// P^T and dS^T of one tile into Pt and dSt: row = key, column = query
template <int D, bool kMask>
__device__ __forceinline__ void dkdv_scores_f32(
    const float (&s)[DkdvF32<D>::RM][DkdvF32<D>::CN],
    const float (&dp)[DkdvF32<D>::RM][DkdvF32<D>::CN], const float* st,
    float* Pt, float* dSt, float scale_log2, const TileMask& mask, int ty,
    int tx) {
  using L = DkdvF32<D>;
#pragma unroll
  for (int j = 0; j < L::CN; ++j) {
    const int col = tx + 16 * j;
    const float ml = st[col] * kLog2e, li = st[L::QT + col],
                dl = st[2 * L::QT + col];
#pragma unroll
    for (int i = 0; i < L::RM; ++i) {
      float x = prob(s[i][j], scale_log2, ml, li);
      if (kMask && mask.dead(col, ty + 16 * i)) x = 0.f;
      Pt[(ty + 16 * i) * L::PLD + col] = x;
      dSt[(ty + 16 * i) * L::PLD + col] = x * (dp[i][j] - dl);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256, 1)
    flash_dkdv_f32_kernel(const Params p) {
  using L = DkdvF32<D>;
  extern __shared__ __align__(16) float smf[];
  float* Ks = smf;
  float* Vs = Ks + L::kKVFloats;
  float* Qs = Vs + L::kKVFloats;
  float* dOs = Qs + L::kTileFloats;
  float* st = dOs + L::kTileFloats;
  float* Pt = st + 3 * L::QT;
  float* dSt = Pt + L::KB * L::PLD;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  const int kvh = blockIdx.x % p.h_kv;
  const int k0 = (blockIdx.x / p.h_kv) * L::KB;
  const int c0 = blockIdx.y * L::DO;
  const int group = p.h / p.h_kv;
  const int keys_here = min(L::KB, p.s_k - k0);
  const long long k_first = (long long)p.k_off + k0;
  const float scale_log2 = p.scale * kLog2e;
  long long qt0;
  const int n_qt = live_query_tiles(p, k_first, keys_here, L::QT, qt0);
  const int n_tiles = group * n_qt;

  // tile i: rows [qt, qt + QT) of query head kvh * group + i / n_qt,
  // from row0 = (that head, qt) of q, dout and the statistics
  auto tile_rows = [&](int i, long long& qt) {
    qt = qt0 + (long long)(i % n_qt) * L::QT;
    return size_t(kvh * group + i / n_qt) * p.s_q + qt;
  };
  // Q and the statistics of tile i; dO of tile i
  auto load_q = [&](int i) {
    long long qt;
    const size_t row0 = tile_rows(i, qt);
    load_rows<D, L::LD>(Qs, static_cast<const float*>(p.q) + row0 * D,
                        p.s_q - qt, L::QT);
    for (int r = threadIdx.x; r < 3 * L::QT; r += kF32Threads) {
      const int which = r / L::QT, rr = r % L::QT;
      const float* src = which == 0 ? p.m : which == 1 ? p.linv : p.delta;
      const bool valid = qt + rr < p.s_q;
      cp_async4(st + r, valid ? src + row0 + rr : src, valid);
    }
    cp_async_commit();
  };
  auto load_dout = [&](int i) {
    long long qt;
    const size_t row0 = tile_rows(i, qt);
    load_rows<D, L::LD>(dOs, static_cast<const float*>(p.dout) + row0 * D,
                        p.s_q - qt, L::QT);
    cp_async_commit();
  };

  float dk[L::RM][L::OG][4], dv[L::RM][L::OG][4];
#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
#pragma unroll
    for (int g = 0; g < L::OG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[i][g][e] = dv[i][g][e] = 0.f;
    }
  }

  if (n_tiles > 0) {
    // groups in order: K, V with Q_0; dO_0; then per tile Q_i+1 during
    // dV += P^T dO and dO_i+1 during the next K Q^T
    const size_t key0 = size_t(kvh) * p.s_k + k0;
    load_rows<D, L::LD>(Ks, static_cast<const float*>(p.k) + key0 * D,
                        keys_here, L::KB);
    load_rows<D, L::LD>(Vs, static_cast<const float*>(p.v) + key0 * D,
                        keys_here, L::KB);
    load_q(0);
    load_dout(0);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const bool more = i + 1 < n_tiles;
    long long qt;
    tile_rows(i, qt);
    const long long qg = p.q_off + qt;
    cp_async_wait<1>();  // Q_i (dO_i may still be in flight)
    __syncthreads();
    float s[L::RM][L::CN], dp[L::RM][L::CN];
    f32_dots<D, L::LD>(Ks, Qs, s, ty, tx);
    cp_async_wait<0>();  // dO_i
    __syncthreads();
    f32_dots<D, L::LD>(Vs, dOs, dp, ty, tx);
    const TileMask mask = tile_mask(p, qg, p.s_q - qt, k_first, keys_here);
    if (keys_here == L::KB && qt + L::QT <= p.s_q &&
        span_full(p, qg, L::QT, k_first, L::KB)) {
      dkdv_scores_f32<D, false>(s, dp, st, Pt, dSt, scale_log2, mask, ty,
                                tx);
    } else {
      dkdv_scores_f32<D, true>(s, dp, st, Pt, dSt, scale_log2, mask, ty, tx);
    }
    __syncthreads();
    f32_products<L::QT, L::LD, L::PLD>(dSt, Qs + c0, dk, ty, tx);
    __syncthreads();  // Qs and the statistics free
    if (more) load_q(i + 1);
    f32_products<L::QT, L::LD, L::PLD>(Pt, dOs + c0, dv, ty, tx);
    __syncthreads();  // dOs, Pt and dSt free
    if (more) load_dout(i + 1);
  }

#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= p.s_k) continue;
    const size_t r = size_t(kvh) * p.s_k + key;
#pragma unroll
    for (int g = 0; g < L::OG; ++g) {
      const int c = c0 + 64 * g + 4 * tx;
      *reinterpret_cast<float4*>(p.dk + r * D + c) =
          make_float4(dk[i][g][0] * p.scale, dk[i][g][1] * p.scale,
                      dk[i][g][2] * p.scale, dk[i][g][3] * p.scale);
      *reinterpret_cast<float4*>(p.dv + r * D + c) =
          make_float4(dv[i][g][0], dv[i][g][1], dv[i][g][2], dv[i][g][3]);
    }
  }
}

// --------------------------------------------------------------- host --

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API symbol; the library links only
// the runtime, so it is looked up in the driver the runtime has loaded
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A (heads, rows, d) bf16 tensor as a 3-D map (d, rows, heads), cut into
// boxes of 64 columns (128 bytes, swizzled) by box_rows rows of one head:
// rows past the head's end fill with zeros. 0, or minus the CUresult.
int encode(CUtensorMap* map, const void* base, int d, int rows, int heads,
           int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows) * d * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

// The four maps of a bf16 launch: q and dout in boxes of q_rows rows, k
// and v in boxes of k_rows rows; q and k d_qk wide, dout and v d_v.
int encode_all(CUtensorMap (&maps)[4], const Params& p, int d_qk, int d_v,
               int q_rows, int k_rows) {
  int err = encode(&maps[0], p.q, d_qk, p.s_q, p.h, q_rows);
  if (err == 0) err = encode(&maps[1], p.dout, d_v, p.s_q, p.h, q_rows);
  if (err == 0) err = encode(&maps[2], p.k, d_qk, p.s_k, p.h_kv, k_rows);
  if (err == 0) err = encode(&maps[3], p.v, d_v, p.s_k, p.h_kv, k_rows);
  return err;
}

template <typename Kernel, typename... Args>
int launch_with(Kernel kernel, dim3 grid, int threads, size_t smem,
                cudaStream_t stream, const Args&... args) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(attr);
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int blocks(int n, int tile) { return (n + tile - 1) / tile; }

// block_q, block_k: the tile plan the caller assumed, checked here. dq:
// query rows a block, keys a tile; dkdv: query rows a tile, keys a block
// (bf16 takes either of its two forms where DQK = DV, the 128-key form
// alone at (192, 128)).
template <int DQK, int DV>
int launch_dq_bf16(const Params& p, int block_q, int block_k,
                   cudaStream_t s) {
  using L = DqBf16<DQK, DV>;
  if (block_q != L::BQ || block_k != L::BK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap m[4];
  const int err = encode_all(m, p, DQK, DV, L::BQ, L::BK);
  if (err != 0) return err;
  return launch_with(flash_dq_bf16_kernel<DQK, DV>,
                     dim3(blocks(p.s_q, L::BQ) * p.h), L::kThreads, L::kSmem,
                     s, m[0], m[1], m[2], m[3], p);
}

template <int D>
int launch_dq(const Params& p, bool bf16, int block_q, int block_k,
              cudaStream_t s) {
  if (bf16) return launch_dq_bf16<D, D>(p, block_q, block_k, s);
  using L = DqF32<D>;
  if (block_q != L::BQ || block_k != L::BK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_with(flash_dq_f32_kernel<D>,
                     dim3(blocks(p.s_q, L::BQ) * p.h), kF32Threads,
                     L::kSmem, s, p);
}

template <int DQK, int DV, bool kSplit>
int launch_dkdv_form(const Params& p, cudaStream_t s) {
  using L = DkdvBf16<DQK, DV, kSplit>;
  CUtensorMap m[4];
  const int err = encode_all(m, p, DQK, DV, L::QT, L::KB);
  if (err != 0) return err;
  return launch_with(flash_dkdv_bf16_kernel<DQK, DV, kSplit>,
                     dim3(blocks(p.s_k, L::KB) * p.h_kv, L::kColSplit),
                     L::kThreads, L::kSmem, s, m[0], m[1], m[2], m[3], p);
}

template <int DQK, int DV>
int launch_dkdv_bf16(const Params& p, int block_q, int block_k,
                     cudaStream_t s) {
  using N = DkdvBf16<DQK, DV, false>;
  if (block_q == N::QT && block_k == N::KB) {
    return launch_dkdv_form<DQK, DV, false>(p, s);
  }
  if constexpr (DQK == DV) {
    using S = DkdvBf16<DQK, DV, true>;
    if (block_q == S::QT && block_k == S::KB) {
      return launch_dkdv_form<DQK, DV, true>(p, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_dkdv(const Params& p, bool bf16, int block_q, int block_k,
                cudaStream_t s) {
  if (bf16) return launch_dkdv_bf16<D, D>(p, block_q, block_k, s);
  using L = DkdvF32<D>;
  if (block_q != L::QT || block_k != L::KB) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_with(flash_dkdv_f32_kernel<D>,
                     dim3(blocks(p.s_k, L::KB) * p.h_kv, D / L::DO),
                     kF32Threads, L::kSmem, s, p);
}

// dtype 0: f32, 1: bf16; head dims (d, d_v): d = d_v in 64, 128 and
// 256, and in bf16 (192, 128)
template <bool kDq>
int dispatch(const Params& p, int dtype, int d, int d_v, int block_q,
             int block_k, void* stream) {
  if (p.s_q < 1 || p.s_k < 1 || p.h_kv < 1 || p.h % p.h_kv != 0 ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = dtype == 1;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bf16 && d == 192 && d_v == 128) {
    return kDq ? launch_dq_bf16<192, 128>(p, block_q, block_k, s)
               : launch_dkdv_bf16<192, 128>(p, block_q, block_k, s);
  }
  if (d != d_v) return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 64:
      return kDq ? launch_dq<64>(p, bf16, block_q, block_k, s)
                 : launch_dkdv<64>(p, bf16, block_q, block_k, s);
    case 128:
      return kDq ? launch_dq<128>(p, bf16, block_q, block_k, s)
                 : launch_dkdv<128>(p, bf16, block_q, block_k, s);
    case 256:
      return kDq ? launch_dq<256>(p, bf16, block_q, block_k, s)
                 : launch_dkdv<256>(p, bf16, block_q, block_k, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both return cudaGetLastError() after the launch, cudaErrorInvalidValue
// for a plan or shape the kernel does not take, or minus the CUresult of
// a tensor map it could not encode.
extern "C" int smi_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* m,
                                const float* linv, const float* delta,
                                float* dq, int dtype, int h, int h_kv,
                                int s_q, int s_k, int d, int d_v, int q_off,
                                int k_off, int causal, int window,
                                float scale, int block_q, int block_k,
                                void* stream) {
  const Params p{q,  k,       v,       dout, m,     linv,  delta,
                 dq, nullptr, nullptr, h,    h_kv,  s_q,   s_k,
                 q_off, k_off, causal, window, scale};
  return dispatch<true>(p, dtype, d, d_v, block_q, block_k, stream);
}

extern "C" int smi_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* m,
                                  const float* linv, const float* delta,
                                  float* dk, float* dv, int dtype, int h,
                                  int h_kv, int s_q, int s_k, int d, int d_v,
                                  int q_off, int k_off, int causal,
                                  int window, float scale, int block_q,
                                  int block_k, void* stream) {
  const Params p{q,       k,  v,  dout, m,    linv, delta,
                 nullptr, dk, dv, h,    h_kv, s_q,  s_k,
                 q_off,   k_off, causal, window, scale};
  return dispatch<false>(p, dtype, d, d_v, block_q, block_k, stream);
}
