// Flash-attention forward for the ring-attention schedule: two entry
// points, one tile body a dtype.
//
// Replaces: smi_tpu/kernels/flash.py::_flash_fused_kernel (driven by
// flash_attend_fused: the whole K/V extent in one launch, fresh state,
// normalised output) and smi_tpu/kernels/flash.py::_flash_kernel (driven
// by flash_block_attend: fold one K/V block into the carried (m, l, acc),
// one launch per ring step). Both TPU kernels share _attend_tile; here
// both entries share the tile body of their dtype (bf16_tile; f32_scores
// and f32_fold) and differ only in how the state comes in and goes out.
//
// Layouts are the JAX package's: q (H, Sq, D), k/v (H_kv, Sk, D) in f32
// or bf16, m/l (H, 1, Sq) f32 rows, acc (H, Sq, D) f32, out (H, Sq, D) in
// q's dtype. Query head hh reads K/V head hh / (H / H_kv): grouped K/V are
// never repeated in memory. Causality and the sliding window come from
// global positions q_off + i and k_off + j.
//
// Bound on the H100: operations, at every shape the ring path runs.
// Forward attention does 4*D operations per live query-key pair (QK^T
// and PV) against a few bytes per query row; at S=8192, H=8, D=128
// causal that is 137.5 GFLOP: 0.14 ms at the 989 TFLOP/s of dense bf16
// on the tensor cores, 2.05 ms at the 67 TFLOP/s of f32 on the CUDA
// cores (f32 stays full f32: the reference runs HIGHEST, so no TF32).
//
// Design, bf16 (FlashAttention-3 in shape, without its intra-warpgroup
// overlap): a block of 384 threads owns 128 query rows of one head. One
// producer warp issues TMA loads: Q once, then K and V tiles of BK keys
// through a two-stage ring in 128-byte-swizzled shared memory, each
// stage with a "full" mbarrier (the tile's bytes expected) and an
// "empty" one the consumers arrive on. Two consumer warpgroups of 64
// rows each run S = Q K^T as wgmma m64nBKk16 with both operands in
// shared memory (K-major), the online softmax on the accumulator
// registers (a warp's slice of a wgmma accumulator is the m16n8 layout:
// quad shuffles give the row max and sum), and O += P V as wgmma with P
// rounded to bf16 in registers (as the reference rounds it to V's dtype)
// and V read MN-major (the transpose bit). setmaxnreg moves registers
// from the producer to the consumers. The tensor maps are 3-D (D, S,
// heads), so a ragged tile fills with zeros inside its head, never from
// the next head's rows.
//
// Design, f32 (no wgmma form; TF32 would miss the 2e-5 bar):
// register-tiled FFMA. 256 threads own 128 query rows; thread (ty, tx)
// holds an 8-row slice (rows ty + 16 i) of S and of O, S at columns
// tx + 16 j and O at the float4 columns 64 g + 4 tx. Operands come as
// float4s from shared rows, broadcast across the 16 threads of a row, so
// a warp does about 3 FMAs per byte of shared memory it reads (a
// broadcast counted once), against 0.4-0.5 in the m16n8 layout it
// replaces; the CUDA cores need 1. K and V load by cp.async, each into
// its own buffer: the next K streams in during the softmax and P V, the
// next V during Q K^T.
//
// Head dims: Q and K share one (DQK), V and the output have their own
// (DV). f32 and bf16 take DQK = DV in 64, 128 and 256; bf16 also takes
// (DQK, DV) = (192, 128), DeepSeek-V3's latent attention (MLA: 128 dims
// without positions and 64 rotated ones against 128-wide values). That
// form is the D=128 design with 12 k16 steps in Q K^T: 128-key tiles, two
// stages of a 192-wide K and a 128-wide V tile (214 KB of shared memory).
//
// Both: p is ex2.approx of one FMA with log2(e) folded in, m kept in
// scaled-score units (the backward reads m and 1/l as the JAX package
// defines them); a tile body is compiled with and without the mask, so
// only a tile that needs it evaluates it. Masked scores become -inf, so
// p = exp2(-inf) = 0 exactly: a row with no live key keeps (m, l, acc) =
// (NEG_INF, 0, 0) whatever the tiling, and a row with no live key in this
// block keeps its carried state exactly (alpha = exp2(0) = 1, nothing
// added). A block walks only the key tiles that hold a live key for one
// of its rows; one wholly in the causal future or outside the window runs
// no tile and passes the carry through bit for bit. Only tiles that
// straddle the diagonal, the window edge or the ragged end of the keys
// take the masked body. Under causality the blocks of the last query
// rows, which walk the most tiles, are issued first.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX package
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint64_t kWaitNs = 10ull * 1000 * 1000 * 1000;  // then trap

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* m_in;    // carried only
  const float* l_in;
  const float* acc_in;
  void* out;            // fused: (H, Sq, D) in q's dtype; carried: acc f32
  float* m_out;
  float* l_out;
  int h, h_kv, s_q, s_k;
  int q_off, k_off;
  int causal, window;   // window 0: none
  float scale;
};

// ------------------------------------------------------------- shared --

// Block b owns query rows [q0, q0 + bq) of head hh; under causality the
// last query tiles (the most key tiles each) come first.
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
__device__ __forceinline__ int live_tiles(const Params& p, long long q_first,
                                          int rows, int bk, long long& kt0) {
  long long lo = 0, hi = p.s_k;
  if (p.causal) hi = min(hi, q_first + rows - p.k_off);
  if (p.window > 0) lo = max(lo, q_first - (p.window - 1) - p.k_off);
  kt0 = lo / bk * bk;
  return lo < hi ? static_cast<int>((hi - kt0 + bk - 1) / bk) : 0;
}

// Whether the tile at kt holds no live key for rows [q_first, +rows).
__device__ __forceinline__ bool tile_dead(const Params& p, long long kt,
                                          int bk, long long q_first,
                                          int rows) {
  if (rows <= 0) return true;
  if (p.causal && p.k_off + kt > q_first + rows - 1) return true;
  return p.window > 0 && p.k_off + kt + bk - 1 < q_first - (p.window - 1);
}

// Whether every (row, key) of the tile at kt is live for rows
// [q_first, q_first + rows): no mask to evaluate.
__device__ __forceinline__ bool tile_full(const Params& p, long long kt,
                                          int bk, long long q_first,
                                          int rows) {
  bool full = kt + bk <= p.s_k;
  if (p.causal) full = full && p.k_off + kt + bk - 1 <= q_first;
  if (p.window > 0) {
    full = full && p.k_off + kt >= q_first + rows - 1 - (p.window - 1);
  }
  return full;
}

// The mask of one tile in 32-bit positions relative to its first row
// (global q_first) and first key (local kt): key j is dead for row i
// past the keys' end, in the row's causal future or before its window.
struct TileMask {
  int diag;    // k_off + kt - q_first, clamped: key position - query's
  int ragged;  // s_k - kt, clamped: keys left
  int causal, window;

  __device__ __forceinline__ bool dead(int i, int j) const {
    const int rel = diag + j - i;
    bool d = j >= ragged;
    if (causal) d = d || rel > 0;
    if (window > 0) d = d || rel < 1 - window;
    return d;
  }
};

// Clamped so that i, j < 1024 cannot overflow; a clamped distance
// decides every comparison as the exact one would.
__device__ __forceinline__ TileMask tile_mask(const Params& p, long long kt,
                                              long long q_first) {
  constexpr long long kFar = (1ll << 31) - 2048;
  const long long diag = p.k_off + kt - q_first;
  const long long ragged = p.s_k - kt;
  return TileMask{static_cast<int>(max(-kFar, min(kFar, diag))),
                  static_cast<int>(max(-1ll, min(4096ll, ragged))), p.causal,
                  p.window};
}

// 2^x by the special-function unit: exact 0 at -inf, about 2^-22
// relative error elsewhere
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One row's online-softmax step on its scaled, masked scores (already
// reduced to the row max `mx` across the threads that share the row):
// the new m and the rescale alpha of the old state. alpha is exactly 1
// where the max did not move (the subtraction comes first).
__device__ __forceinline__ float rescale(float& m, float mx) {
  const float m_new = fmaxf(m, mx);  // finite: m starts at NEG_INF
  const float alpha = exp2f((m - m_new) * kLog2e);
  m = m_new;
  return alpha;
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

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
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

__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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

template <int DQK, int DV>
struct Bf16Plan {
  static constexpr int kThreads = 384;  // two consumer warpgroups, one producer
  static constexpr int BQ = 128;        // 64 query rows per consumer warpgroup
  static constexpr int BK = DQK == 256 ? 64 : 128;  // keys per tile
  static constexpr int kStages = 2;
  static constexpr int NT = BK / 8;     // score accumulator tiles
  static constexpr int DT = DV / 8;     // output accumulator tiles
  static constexpr int kBox = 64;       // a box row: 64 bf16, 128 bytes
  static constexpr int kQKChunks = DQK / kBox;  // boxes of a Q or K row
  static constexpr int kVChunks = DV / kBox;    // boxes of a V row
  static constexpr uint32_t kQBytes = BQ * DQK * 2;
  static constexpr uint32_t kKBytes = BK * DQK * 2;  // one K tile
  static constexpr uint32_t kVBytes = BK * DV * 2;   // one V tile
  static constexpr uint32_t kStageBytes = kKBytes + kVBytes;
  static constexpr uint32_t kBarOffset = kQBytes + kStages * kStageBytes;
  // 1024: slack to align the base to the swizzle's 1024-byte period
  static constexpr size_t kSmem = 1024 + kBarOffset + 64;
};

// Fold one (64, BK) tile into this warpgroup's state. Qw: the
// warpgroup's 64 rows of the Q tile; Ks/Vs: the stage's K and V tiles,
// kQKChunks and kVChunks boxes of (rows x 128 bytes).
template <int DQK, int DV, bool kMask>
__device__ __forceinline__ void bf16_tile(
    const unsigned char* Qw, const unsigned char* Ks,
    const unsigned char* Vs, float (&o)[Bf16Plan<DQK, DV>::DT][4],
    float (&m)[2], float (&l)[2], float scale, const TileMask& mask,
    int warp, int lane) {
  using L = Bf16Plan<DQK, DV>;
  const int g = lane >> 2, t = lane & 3;
  float s[L::NT][4];
#pragma unroll
  for (int j = 0; j < L::NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;

  // S = Q K^T: DQK/16 steps of k16, 32 bytes apart inside a 128-byte row
  fence_operands(s);
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < DQK / 16; ++kc) {
    const int c = kc / 4, w = (kc % 4) * 32;
    wgmma_ss(s, descriptor(Qw + c * L::BQ * 128 + w, 16, 1024),
             descriptor(Ks + c * L::BK * 128 + w, 16, 1024), 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(s);

#pragma unroll
  for (int j = 0; j < L::NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale;
      if (kMask &&
          mask.dead(warp * 16 + g + 8 * (e >> 1), j * 8 + 2 * t + (e & 1))) {
        x = -CUDART_INF_F;
      }
      s[j][e] = x;
    }
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
      mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float alpha = rescale(m[hr], mx);
    const float mc = m[hr] * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
#pragma unroll
      for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
        const float pe = fast_exp2(fmaf(s[j][e], kLog2e, -mc));  // 0 if masked
        s[j][e] = pe;
        sum += pe;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[hr] = l[hr] * alpha + sum;
#pragma unroll
    for (int dt = 0; dt < L::DT; ++dt) {
      o[dt][2 * hr] *= alpha;
      o[dt][2 * hr + 1] *= alpha;
    }
  }

  // O += P V: BK/16 steps of k16 (16 keys, 2048 bytes of each V box);
  // N = DV spans kVChunks boxes BK * 128 bytes apart. P is packed whole
  // before the fence, so no register of a wgmma's A is written between
  // the issues.
  uint32_t a[L::BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < L::BK / 16; ++kk) {
    a[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    a[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    a[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
  fence_operands(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < L::BK / 16; ++kk) {
    wgmma_rs(o, a[kk], descriptor(Vs + kk * 16 * 128, L::BK * 128, 1024));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_operands(o);
}

template <int DQK, int DV, bool kCarried>
__global__ void __launch_bounds__(384, 1)
    flash_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const Params p) {
  using L = Bf16Plan<DQK, DV>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = smem;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;

  int hh, q0;
  block_at(p, L::BQ, hh, q0);
  const int kvh = hh / (p.h / p.h_kv);
  const long long q_first = (long long)p.q_off + q0;
  long long kt0;
  const int n_tiles =
      live_tiles(p, q_first, min(L::BQ, p.s_q - q0), L::BK, kt0);

  if (threadIdx.x == 0) {
    barrier_init(q_full, 1);
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
    // producer: one thread issues every load; the warpgroup gives its
    // registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 256 && n_tiles > 0) {
      barrier_expect(q_full, L::kQBytes);
      for (int c = 0; c < L::kQKChunks; ++c) {
        tma_load(Qs + c * L::BQ * 128, &tq, q_full, c * L::kBox, q0, hh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int stage = i % L::kStages;
        if (i >= L::kStages) {
          barrier_wait(&empty[stage], (i / L::kStages - 1) & 1);
        }
        unsigned char* Kb = smem + L::kQBytes + stage * L::kStageBytes;
        unsigned char* Vb = Kb + L::kKBytes;
        const int kt = static_cast<int>(kt0) + i * L::BK;
        barrier_expect(&full[stage], L::kStageBytes);
        for (int c = 0; c < L::kQKChunks; ++c) {
          tma_load(Kb + c * L::BK * 128, &tk, &full[stage], c * L::kBox, kt,
                   kvh);
        }
        for (int c = 0; c < L::kVChunks; ++c) {
          tma_load(Vb + c * L::BK * 128, &tv, &full[stage], c * L::kBox, kt,
                   kvh);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + wg * 64;  // the warpgroup's first row
    const int wg_rows = min(64, p.s_q - r0);
    const long long wq_first = (long long)p.q_off + r0;
    const size_t row0 = size_t(hh) * p.s_q;  // (hh, 0) of m/l/acc/out
    const int rows[2] = {r0 + warp * 16 + g, r0 + warp * 16 + g + 8};

    float m[2], l[2], o[L::DT][4];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      m[hr] = kNegInf;
      l[hr] = 0.f;
#pragma unroll
      for (int dt = 0; dt < L::DT; ++dt) {
        o[dt][2 * hr] = o[dt][2 * hr + 1] = 0.f;
      }
      if (kCarried && rows[hr] < p.s_q) {
        const size_t r = row0 + rows[hr];
        m[hr] = p.m_in[r];
        l[hr] = p.l_in[r];
        const float* a = p.acc_in + r * DV + 2 * t;
#pragma unroll
        for (int dt = 0; dt < L::DT; ++dt) {
          const float2 x = *reinterpret_cast<const float2*>(a + dt * 8);
          o[dt][2 * hr] = x.x;
          o[dt][2 * hr + 1] = x.y;
        }
      }
    }

    if (n_tiles > 0) barrier_wait(q_full, 0);
    const unsigned char* Qw = Qs + wg * 64 * 128;
    for (int i = 0; i < n_tiles; ++i) {
      const int stage = i % L::kStages;
      const long long kt = kt0 + (long long)i * L::BK;
      barrier_wait(&full[stage], (i / L::kStages) & 1);
      if (!tile_dead(p, kt, L::BK, wq_first, wg_rows)) {
        const unsigned char* Kb = smem + L::kQBytes + stage * L::kStageBytes;
        const TileMask mask = tile_mask(p, kt, wq_first);
        if (tile_full(p, kt, L::BK, wq_first, 64)) {
          bf16_tile<DQK, DV, false>(Qw, Kb, Kb + L::kKBytes, o, m, l,
                                    p.scale, mask, warp, lane);
        } else {
          bf16_tile<DQK, DV, true>(Qw, Kb, Kb + L::kKBytes, o, m, l,
                                   p.scale, mask, warp, lane);
        }
      }
      __syncwarp();
      if (lane == 0) barrier_arrive(&empty[stage]);
    }

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      if (rows[hr] >= p.s_q) continue;
      const size_t r = row0 + rows[hr];
      if (t == 0) {
        p.m_out[r] = m[hr];
        p.l_out[r] = l[hr];
      }
      if constexpr (kCarried) {
        float* a = static_cast<float*>(p.out) + r * DV + 2 * t;
#pragma unroll
        for (int dt = 0; dt < L::DT; ++dt) {
          *reinterpret_cast<float2*>(a + dt * 8) =
              make_float2(o[dt][2 * hr], o[dt][2 * hr + 1]);
        }
      } else {
        const float safe_l = l[hr] == 0.f ? 1.f : l[hr];
        __nv_bfloat16* out =
            static_cast<__nv_bfloat16*>(p.out) + r * DV + 2 * t;
#pragma unroll
        for (int dt = 0; dt < L::DT; ++dt) {
          *reinterpret_cast<__nv_bfloat162*>(out + dt * 8) =
              __floats2bfloat162_rn(o[dt][2 * hr] / safe_l,
                                    o[dt][2 * hr + 1] / safe_l);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- f32 --

template <int D>
struct F32Plan {
  static constexpr int kThreads = 256;
  static constexpr int BQ = 128;
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per tile
  static constexpr int LD = D + 4;    // Q/K/V row stride (floats)
  // P row stride: a warp's two half-warps (two rows) 16 banks apart
  static constexpr int PLD = BK + 16;
  static constexpr int RM = BQ / 16;  // rows a thread: ty + 16 i
  static constexpr int CN = BK / 16;  // score columns a thread: tx + 16 j
  static constexpr int OG = D / 64;   // output float4 groups: 64 g + 4 tx
  static constexpr size_t kQFloats = size_t(BQ) * LD;
  static constexpr size_t kKVFloats = size_t(BK) * LD;
  static constexpr size_t kSmem =
      4 * (kQFloats + 2 * kKVFloats + size_t(BQ) * PLD);
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
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
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          long long avail, int rows) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += F32Plan<D>::kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool valid = r < avail;
    cp_async16(dst + r * F32Plan<D>::LD + c,
               valid ? src + size_t(r) * D + c : src, valid);
  }
}

// s = Q K^T for the rows ty + 16 i and keys tx + 16 j of the tile
// (unscaled)
template <int D>
__device__ __forceinline__ void f32_scores(
    const float* Qs, const float* Ks,
    float (&s)[F32Plan<D>::RM][F32Plan<D>::CN], int ty, int tx) {
  using L = F32Plan<D>;
#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
#pragma unroll
    for (int j = 0; j < L::CN; ++j) s[i][j] = 0.f;
  }
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[L::RM], b[L::CN];
#pragma unroll
    for (int i = 0; i < L::RM; ++i) {
      a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * L::LD + d);
    }
#pragma unroll
    for (int j = 0; j < L::CN; ++j) {
      b[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * L::LD + d);
    }
#pragma unroll
    for (int i = 0; i < L::RM; ++i) {
#pragma unroll
      for (int j = 0; j < L::CN; ++j) {
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

// Fold the tile's scores into the state of thread (ty, tx): the online
// softmax across the 16 threads of each row, P into shared memory, then
// (once V has landed: `more` says the next K is in flight behind it)
// O += P V.
template <int D, bool kMask>
__device__ __forceinline__ void f32_fold(
    float (&s)[F32Plan<D>::RM][F32Plan<D>::CN], const float* Vs, float* Ps,
    float (&o)[F32Plan<D>::RM][F32Plan<D>::OG][4],
    float (&m)[F32Plan<D>::RM], float (&l)[F32Plan<D>::RM], float scale,
    const TileMask& mask, int ty, int tx, bool more) {
  using L = F32Plan<D>;
#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < L::CN; ++j) {
      float x = s[i][j] * scale;
      if (kMask && mask.dead(ty + 16 * i, tx + 16 * j)) x = -CUDART_INF_F;
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int w = 1; w < 16; w *= 2) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    }
    const float alpha = rescale(m[i], mx);
    const float mc = m[i] * kLog2e;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < L::CN; ++j) {
      const float pe = fast_exp2(fmaf(s[i][j], kLog2e, -mc));  // 0 if masked
      Ps[(ty + 16 * i) * L::PLD + tx + 16 * j] = pe;
      sum += pe;
    }
#pragma unroll
    for (int w = 1; w < 16; w *= 2) {
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    }
    l[i] = l[i] * alpha + sum;
#pragma unroll
    for (int g = 0; g < L::OG; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][g][e] *= alpha;
    }
  }

  // V (and every thread's P) in shared memory
  if (more) {
    cp_async_wait<1>();  // the next K may still be in flight
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();
#pragma unroll 2
  for (int kk = 0; kk < L::BK; kk += 4) {
    float4 pa[L::RM];
#pragma unroll
    for (int i = 0; i < L::RM; ++i) {
      pa[i] = *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * L::PLD +
                                               kk);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 vb[L::OG];
#pragma unroll
      for (int g = 0; g < L::OG; ++g) {
        vb[g] = *reinterpret_cast<const float4*>(Vs + (kk + u) * L::LD +
                                                 64 * g + 4 * tx);
      }
#pragma unroll
      for (int i = 0; i < L::RM; ++i) {
        const float pu = u == 0 ? pa[i].x
                         : u == 1 ? pa[i].y
                         : u == 2 ? pa[i].z
                                  : pa[i].w;
#pragma unroll
        for (int g = 0; g < L::OG; ++g) {
          o[i][g][0] = fmaf(pu, vb[g].x, o[i][g][0]);
          o[i][g][1] = fmaf(pu, vb[g].y, o[i][g][1]);
          o[i][g][2] = fmaf(pu, vb[g].z, o[i][g][2]);
          o[i][g][3] = fmaf(pu, vb[g].w, o[i][g][3]);
        }
      }
    }
  }
}

template <int D, bool kCarried>
__global__ void __launch_bounds__(256, 1) flash_f32_kernel(const Params p) {
  using L = F32Plan<D>;
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;
  float* Ks = Qs + L::kQFloats;
  float* Vs = Ks + L::kKVFloats;
  float* Ps = Vs + L::kKVFloats;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  int hh, q0;
  block_at(p, L::BQ, hh, q0);
  const int kvh = hh / (p.h / p.h_kv);
  const int rows_here = min(L::BQ, p.s_q - q0);
  const float* q =
      static_cast<const float*>(p.q) + (size_t(hh) * p.s_q + q0) * D;
  const float* k = static_cast<const float*>(p.k) + size_t(kvh) * p.s_k * D;
  const float* v = static_cast<const float*>(p.v) + size_t(kvh) * p.s_k * D;
  const size_t row0 = size_t(hh) * p.s_q;  // (hh, 0) of m/l/acc/out
  const long long q_first = (long long)p.q_off + q0;

  float m[L::RM], l[L::RM], o[L::RM][L::OG][4];
#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    const int row = q0 + ty + 16 * i;
#pragma unroll
    for (int g = 0; g < L::OG; ++g) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kCarried && row < p.s_q) {
        x = *reinterpret_cast<const float4*>(p.acc_in + (row0 + row) * D +
                                             64 * g + 4 * tx);
      }
      o[i][g][0] = x.x;
      o[i][g][1] = x.y;
      o[i][g][2] = x.z;
      o[i][g][3] = x.w;
    }
    if (kCarried && row < p.s_q) {
      m[i] = p.m_in[row0 + row];
      l[i] = p.l_in[row0 + row];
    }
  }

  long long kt0;
  const int n_tiles = live_tiles(p, q_first, rows_here, L::BK, kt0);
  if (n_tiles > 0) {
    // groups in order: Q with K_0, V_0, then K_i+1 and V_i+1 per tile
    load_rows<D>(Qs, q, rows_here, L::BQ);
    load_rows<D>(Ks, k + kt0 * D, p.s_k - kt0, L::BK);
    cp_async_commit();
    load_rows<D>(Vs, v + kt0 * D, p.s_k - kt0, L::BK);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const long long kt = kt0 + (long long)it * L::BK;
    const long long next = kt + L::BK;
    const bool more = it + 1 < n_tiles;
    cp_async_wait<1>();  // K_it (V_it may still be in flight)
    __syncthreads();
    float s[L::RM][L::CN];
    f32_scores<D>(Qs, Ks, s, ty, tx);
    __syncthreads();  // Ks free: the next K streams in during the fold
    if (more) {
      load_rows<D>(Ks, k + next * D, p.s_k - next, L::BK);
      cp_async_commit();
    }
    const TileMask mask = tile_mask(p, kt, q_first);
    if (tile_full(p, kt, L::BK, q_first, L::BQ)) {
      f32_fold<D, false>(s, Vs, Ps, o, m, l, p.scale, mask, ty, tx, more);
    } else {
      f32_fold<D, true>(s, Vs, Ps, o, m, l, p.scale, mask, ty, tx, more);
    }
    __syncthreads();  // Vs and Ps free: the next V streams in during S
    if (more) {
      load_rows<D>(Vs, v + next * D, p.s_k - next, L::BK);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.s_q) continue;
    const size_t r = row0 + row;
    if (tx == 0) {
      p.m_out[r] = m[i];
      p.l_out[r] = l[i];
    }
#pragma unroll
    for (int g = 0; g < L::OG; ++g) {
      float4 x = make_float4(o[i][g][0], o[i][g][1], o[i][g][2], o[i][g][3]);
      if constexpr (!kCarried) {
        const float safe_l = l[i] == 0.f ? 1.f : l[i];
        x = make_float4(x.x / safe_l, x.y / safe_l, x.z / safe_l,
                        x.w / safe_l);
      }
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + r * D +
                                 64 * g + 4 * tx) = x;
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

// the grid: one block a (query tile, head)
dim3 grid_of(const Params& p, int bq) {
  return dim3(static_cast<unsigned>((p.s_q + bq - 1) / bq) * p.h);
}

template <int DQK, int DV, bool kCarried>
int launch_bf16(const Params& p, int block_q, int block_k,
                cudaStream_t stream) {
  using L = Bf16Plan<DQK, DV>;
  if (block_q != L::BQ || block_k != L::BK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, p.q, DQK, p.s_q, p.h, L::BQ);
  if (err == 0) err = encode(&tk, p.k, DQK, p.s_k, p.h_kv, L::BK);
  if (err == 0) err = encode(&tv, p.v, DV, p.s_k, p.h_kv, L::BK);
  if (err != 0) return err;
  auto kernel = flash_bf16_kernel<DQK, DV, kCarried>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (attr != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(attr);
  }
  kernel<<<grid_of(p, L::BQ), L::kThreads, L::kSmem, stream>>>(tq, tk, tv,
                                                               p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool kCarried>
int launch_f32(const Params& p, int block_q, int block_k,
               cudaStream_t stream) {
  using L = F32Plan<D>;
  if (block_q != L::BQ || block_k != L::BK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_f32_kernel<D, kCarried>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (attr != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(attr);
  }
  kernel<<<grid_of(p, L::BQ), L::kThreads, L::kSmem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: f32, 1: bf16; head dims (d, d_v): d = d_v in 64, 128 and
// 256, and in bf16 (192, 128)
template <bool kCarried>
int dispatch(const Params& p, int dtype, int d, int d_v, int block_q,
             int block_k, void* stream) {
  if (p.s_q < 1 || p.s_k < 1 || p.h_kv < 1 || p.h % p.h_kv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && d == 192 && d_v == 128) {
    return launch_bf16<192, 128, kCarried>(p, block_q, block_k, s);
  }
  if (d != d_v) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) {
    switch (d) {
      case 64: return launch_f32<64, kCarried>(p, block_q, block_k, s);
      case 128: return launch_f32<128, kCarried>(p, block_q, block_k, s);
      case 256: return launch_f32<256, kCarried>(p, block_q, block_k, s);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 64: return launch_bf16<64, 64, kCarried>(p, block_q, block_k, s);
      case 128:
        return launch_bf16<128, 128, kCarried>(p, block_q, block_k, s);
      case 256:
        return launch_bf16<256, 256, kCarried>(p, block_q, block_k, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Both return cudaGetLastError() after the launch, cudaErrorInvalidValue
// for a plan or shape the kernel does not take, or minus the CUresult of
// a tensor map it could not encode.
extern "C" int smi_flash_fused(const void* q, const void* k, const void* v,
                               void* out, float* m_out, float* l_out,
                               int dtype, int h, int h_kv, int s_q, int s_k,
                               int d, int d_v, int q_off, int k_off,
                               int causal, int window, float scale,
                               int block_q, int block_k, void* stream) {
  const Params p{q, k, v, nullptr, nullptr, nullptr, out, m_out, l_out,
                 h, h_kv, s_q, s_k, q_off, k_off, causal, window, scale};
  return dispatch<false>(p, dtype, d, d_v, block_q, block_k, stream);
}

extern "C" int smi_flash_block(const void* q, const void* k, const void* v,
                               const float* m_in, const float* l_in,
                               const float* acc_in, float* m_out,
                               float* l_out, float* acc_out, int dtype, int h,
                               int h_kv, int s_q, int s_k, int d, int d_v,
                               int q_off, int k_off, int causal, int window,
                               float scale, int block_q, int block_k,
                               void* stream) {
  const Params p{q, k, v, m_in, l_in, acc_in, acc_out, m_out, l_out,
                 h, h_kv, s_q, s_k, q_off, k_off, causal, window, scale};
  return dispatch<true>(p, dtype, d, d_v, block_q, block_k, stream);
}
