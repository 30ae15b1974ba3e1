// Flash-attention backward (FlashAttention-2) for the ring-attention
// schedule: two kernels, one per gradient orientation.
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
// dS^T Q); at S=8192, H=8, D=128 causal that is 206 and 275 GFLOP: 3.1
// and 4.1 ms at the 67 TFLOP/s of f32 outside the tensor cores (full f32,
// as the reference runs HIGHEST), 0.21 and 0.28 ms at the 989 TFLOP/s
// dense bf16 rate.
//
// Design. Both kernels use the register layout of mma.sync m16n8
// accumulators that flash_fwd.cu uses: a warp owns 16 rows, and each
// thread holds two rows of every 8-column tile. bf16 runs every product
// on the tensor cores (mma.sync.m16n8k16, f32 accumulation) and rounds
// dS (dq, dK) and P^T (dV) to bf16 before their products, where the
// reference rounds them to the operands' dtype. f32 runs them as f32 FMAs
// on the CUDA cores through the same layout, with the left operand staged
// in a per-warp shared buffer.
//
// - dq: a block owns 64 query rows of one head (4 warps), holds its Q and
//   dO tiles and its three statistics in registers, and walks only the
//   key tiles that hold a live key for some of its rows. Blocks start
//   from the last query tile, so the longest causal blocks run first.
// - dkdv: a block owns 64 keys of one K/V head and walks the group's
//   H/H_kv query heads and, for each, only the live 32-row query tiles
//   (from the causal edge to the window's end). dK and dV stay in the
//   block's registers across the whole group: no atomics, no per-query-
//   head output, the same bits on every run.
//
// Registers: a warp's dK and dV for 16 keys are 2 x 16 x 128 f32 at
// D=128, 128 registers a thread; the 32-row query tile keeps the score
// tiles at 16 each. Wider heads (D=256) split the output columns into
// 128-wide halves over gridDim.z, each block recomputing the full-D
// scores. Masked entries are set to 0 by a select, never by multiplying:
// a row with no live key has m = NEG_INF and exp(S - m) = +inf there, and
// inf * 0 is NaN. A block with no live pair writes exact zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // dq: query rows a block owns; dkdv: keys
constexpr int kTileQ = 32;     // dkdv: query rows per tile

template <typename T>
struct TileOf;
template <>
struct TileOf<float> {
  static constexpr int kBlockK = 32;  // dq: key rows per tile
  static constexpr int kPad = 4;      // row pad in elements: 16 bytes
};
template <>
struct TileOf<__nv_bfloat16> {
  static constexpr int kBlockK = 64;
  static constexpr int kPad = 8;
};

// The shared-memory plans; smi_tpu_torch/kernels/flash.py::bwd_smem_bytes
// computes the same sums.
template <typename T, int D>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int LD = D + TileOf<T>::kPad;  // tile row stride
  static constexpr int DO = D < 128 ? D : 128;    // output columns a block
  static constexpr int DT = DO / 8;               // accumulator tiles
  static constexpr int BK = TileOf<T>::kBlockK;
  static constexpr size_t kRowsBytes = size_t(kRows) * LD * sizeof(T);
  static constexpr size_t kKBytes = size_t(BK) * LD * sizeof(T);
  static constexpr size_t kQBytes = size_t(kTileQ) * LD * sizeof(T);
  static constexpr size_t kStatBytes = size_t(3) * kTileQ * 4;
  // f32 only: each warp's 16 x (n + 4) staging buffer for the left
  // operand, n = BK (dq) or kTileQ (dkdv)
  static constexpr size_t kDqStage = kF32 ? size_t(4) * 16 * (BK + 4) * 4 : 0;
  static constexpr size_t kDkdvStage =
      kF32 ? size_t(4) * 16 * (kTileQ + 4) * 4 : 0;
  // dq: Q, dO (64 rows), K, V (BK rows), staging
  static constexpr size_t kDqSmem = 2 * kRowsBytes + 2 * kKBytes + kDqStage;
  // dkdv: K, V (64 rows), Q, dO (32 rows), m/linv/delta rows, staging
  static constexpr size_t kDkdvSmem =
      2 * kRowsBytes + 2 * kQBytes + kStatBytes + kDkdvStage;
};

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

// rows [0, rows) of D elements from src (row stride D) into dst (row
// stride LD), zeros past `avail`
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long avail,
                                          int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  constexpr int LD = Layout<T, D>::LD;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < avail) {
      val = *reinterpret_cast<const uint4*>(src + size_t(r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return uint32_t(__bfloat16_as_ushort(lo)) |
         (uint32_t(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_bf16(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Accumulator layout (that of mma.sync m16n8): in tile j, lane holds
// rows g = lane/4 (elements 0, 1) and g + 8 (elements 2, 3) of its warp's
// 16, columns j*8 + 2*(lane%4) + {0, 1}.

// s (16 x NB) = A B^T over all D columns: A is this warp's 16 rows, B the
// tile's NB rows, both of row stride LD
template <typename T, int D, int NB>
__device__ __forceinline__ void dot_tile(const T* A, const T* B,
                                         float (&s)[NB / 8][4], int lane) {
  constexpr int LD = Layout<T, D>::LD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  }
  if constexpr (Layout<T, D>::kF32) {
    const float* a0p = A + g * LD;
    const float* a1p = a0p + 8 * LD;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(a0p + d);
      const float4 b = *reinterpret_cast<const float4*>(a1p + d);
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 kk = *reinterpret_cast<const float4*>(
              B + (j * 8 + 2 * t + e) * LD + d);
          float x = s[j][e], y = s[j][2 + e];
          x = fmaf(a.x, kk.x, x); y = fmaf(b.x, kk.x, y);
          x = fmaf(a.y, kk.y, x); y = fmaf(b.y, kk.y, y);
          x = fmaf(a.z, kk.z, x); y = fmaf(b.z, kk.z, y);
          x = fmaf(a.w, kk.w, x); y = fmaf(b.w, kk.w, y);
          s[j][e] = x;
          s[j][2 + e] = y;
        }
      }
    }
  } else {
    const __nv_bfloat16* qa = A + g * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a0 = ld32(qa + kk * 16);
      const uint32_t a1 = ld32(qa + 8 * LD + kk * 16);
      const uint32_t a2 = ld32(qa + kk * 16 + 8);
      const uint32_t a3 = ld32(qa + 8 * LD + kk * 16 + 8);
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
        const __nv_bfloat16* kb = B + (j * 8 + g) * LD + kk * 16 + 2 * t;
        mma_bf16(s[j], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
      }
    }
  }
}

// o (16 x DO) += P B, P (16 x NB) in the score registers, B the tile's NB
// rows from the block's first output column (row stride LD). bf16 rounds
// P to bf16 first; f32 stages P in this warp's buffer Pw.
template <typename T, int D, int NB>
__device__ __forceinline__ void accumulate(const float (&p)[NB / 8][4],
                                           const T* B, float* Pw,
                                           float (&o)[Layout<T, D>::DT][4],
                                           int lane) {
  using L = Layout<T, D>;
  constexpr int LD = L::LD;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (L::kF32) {
    constexpr int PLD = NB + 4;
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Pw[(g + 8 * (e >> 1)) * PLD + j * 8 + 2 * t + (e & 1)] = p[j][e];
      }
    }
    __syncwarp();
    const float* p0 = Pw + g * PLD;
    const float* p1 = p0 + 8 * PLD;
    for (int kk = 0; kk < NB; kk += 4) {
      const float4 pa4 = *reinterpret_cast<const float4*>(p0 + kk);
      const float4 pb4 = *reinterpret_cast<const float4*>(p1 + kk);
      const float pa[4] = {pa4.x, pa4.y, pa4.z, pa4.w};
      const float pb[4] = {pb4.x, pb4.y, pb4.z, pb4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* brow = B + (kk + u) * LD + 2 * t;
#pragma unroll
        for (int dt = 0; dt < L::DT; ++dt) {
          const float2 bb = *reinterpret_cast<const float2*>(brow + dt * 8);
          o[dt][0] = fmaf(pa[u], bb.x, o[dt][0]);
          o[dt][1] = fmaf(pa[u], bb.y, o[dt][1]);
          o[dt][2] = fmaf(pb[u], bb.x, o[dt][2]);
          o[dt][3] = fmaf(pb[u], bb.y, o[dt][3]);
        }
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int kk = 0; kk < NB / 16; ++kk) {
      const uint32_t a0 = pack_f32(p[2 * kk][0], p[2 * kk][1]);
      const uint32_t a1 = pack_f32(p[2 * kk][2], p[2 * kk][3]);
      const uint32_t a2 = pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      const uint32_t a3 = pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      const __nv_bfloat16* bb = B + (kk * 16 + 2 * t) * LD + g;
#pragma unroll
      for (int dt = 0; dt < L::DT; ++dt) {
        const __nv_bfloat16* c = bb + dt * 8;
        const uint32_t b0 = pack_bf16(c[0], c[LD]);
        const uint32_t b1 = pack_bf16(c[8 * LD], c[9 * LD]);
        mma_bf16(o[dt], a0, a1, a2, a3, b0, b1);
      }
    }
  }
}

// whether the key at global position kp is masked for the query at qp
__device__ __forceinline__ bool masked(const Params& p, long long qp,
                                       long long kp) {
  return (p.causal && kp > qp) ||
         (p.window > 0 && kp < qp - (p.window - 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const Params p) {
  using L = Layout<T, D>;
  constexpr int NT = L::BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = reinterpret_cast<T*>(smem + L::kRowsBytes);
  T* Ks = reinterpret_cast<T*>(smem + 2 * L::kRowsBytes);
  T* Vs = reinterpret_cast<T*>(smem + 2 * L::kRowsBytes + L::kKBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Pw = reinterpret_cast<float*>(smem + 2 * L::kRowsBytes +
                                       2 * L::kKBytes) +
              warp * 16 * (L::BK + 4);

  const int hh = blockIdx.y;
  const int kvh = hh / (p.h / p.h_kv);
  // the last query tile first: under causality it walks the most keys
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int c0 = blockIdx.z * L::DO;
  const int rows_here = min(kRows, p.s_q - q0);
  const T* q = static_cast<const T*>(p.q) + (size_t(hh) * p.s_q + q0) * D;
  const T* dout =
      static_cast<const T*>(p.dout) + (size_t(hh) * p.s_q + q0) * D;
  const T* k = static_cast<const T*>(p.k) + size_t(kvh) * p.s_k * D;
  const T* v = static_cast<const T*>(p.v) + size_t(kvh) * p.s_k * D;
  const size_t row0 = size_t(hh) * p.s_q;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  float mr[2], lr[2], dr[2], o[L::DT][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const bool here = rows[hr] < p.s_q;
    mr[hr] = here ? p.m[row0 + rows[hr]] : 0.f;
    lr[hr] = here ? p.linv[row0 + rows[hr]] : 0.f;
    dr[hr] = here ? p.delta[row0 + rows[hr]] : 0.f;
#pragma unroll
    for (int dt = 0; dt < L::DT; ++dt) o[dt][2 * hr] = o[dt][2 * hr + 1] = 0.f;
  }

  // the live key span of this block's rows, in local key indices
  const long long q_first = (long long)p.q_off + q0;
  const long long q_last = q_first + rows_here - 1;
  long long lo = 0, hi = p.s_k;
  if (p.causal) hi = min(hi, q_last - p.k_off + 1);
  if (p.window > 0) lo = max(lo, q_first - (p.window - 1) - p.k_off);

  if (lo < hi) {
    load_rows<T, D>(Qs, q, rows_here, kRows);
    load_rows<T, D>(dOs, dout, rows_here, kRows);
    for (long long kt = lo / L::BK * L::BK; kt < hi; kt += L::BK) {
      __syncthreads();  // the previous tile's K/V reads are done
      load_rows<T, D>(Ks, k + kt * D, p.s_k - kt, L::BK);
      load_rows<T, D>(Vs, v + kt * D, p.s_k - kt, L::BK);
      __syncthreads();
      // every (row, key) of the tile live: no mask to evaluate
      bool full = kt + L::BK <= p.s_k;
      if (p.causal) full = full && p.k_off + kt + L::BK - 1 <= q_first;
      if (p.window > 0) {
        full = full && p.k_off + kt >= q_first + kRows - 1 - (p.window - 1);
      }
      float s[NT][4], dp[NT][4];
      dot_tile<T, D, L::BK>(Qs + warp * 16 * L::LD, Ks, s, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float pe = expf(s[j][e] * p.scale - mr[e >> 1]) * lr[e >> 1];
          if (!full) {
            const long long col = kt + j * 8 + 2 * t + (e & 1);
            const long long qp = q_first + warp * 16 + g + 8 * (e >> 1);
            if (col >= p.s_k || masked(p, qp, p.k_off + col)) pe = 0.f;
          }
          s[j][e] = pe;
        }
      }
      dot_tile<T, D, L::BK>(dOs + warp * 16 * L::LD, Vs, dp, lane);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          dp[j][e] = s[j][e] * (dp[j][e] - dr[e >> 1]);  // dS
        }
      }
      accumulate<T, D, L::BK>(dp, Ks + c0, Pw, o, lane);
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (rows[hr] >= p.s_q) continue;
    float* a = p.dq + (row0 + rows[hr]) * D + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < L::DT; ++dt) {
      *reinterpret_cast<float2*>(a + dt * 8) =
          make_float2(o[dt][2 * hr] * p.scale, o[dt][2 * hr + 1] * p.scale);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const Params p) {
  using L = Layout<T, D>;
  constexpr int NT = kTileQ / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + L::kRowsBytes);
  T* Qs = reinterpret_cast<T*>(smem + 2 * L::kRowsBytes);
  T* dOs = reinterpret_cast<T*>(smem + 2 * L::kRowsBytes + L::kQBytes);
  float* Ms =
      reinterpret_cast<float*>(smem + 2 * L::kRowsBytes + 2 * L::kQBytes);
  float* Ls = Ms + kTileQ;
  float* Ds = Ls + kTileQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Pw = reinterpret_cast<float*>(smem + 2 * L::kRowsBytes +
                                       2 * L::kQBytes + L::kStatBytes) +
              warp * 16 * (kTileQ + 4);

  const int kvh = blockIdx.y;
  const int group = p.h / p.h_kv;
  const int k0 = blockIdx.x * kRows;
  const int c0 = blockIdx.z * L::DO;
  const int keys_here = min(kRows, p.s_k - k0);
  const size_t key0 = size_t(kvh) * p.s_k + k0;  // (kvh, k0) of k/v/dk/dv
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  float dk[L::DT][4], dv[L::DT][4];
#pragma unroll
  for (int dt = 0; dt < L::DT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;
  }

  // the live query span of this block's keys, in local query indices
  const long long k_first = (long long)p.k_off + k0;
  const long long k_last = k_first + keys_here - 1;
  long long lo = 0, hi = p.s_q;
  if (p.causal) lo = max(lo, k_first - p.q_off);
  if (p.window > 0) hi = min(hi, k_last + p.window - p.q_off);

  if (lo < hi) {
    load_rows<T, D>(Ks, static_cast<const T*>(p.k) + key0 * D, keys_here,
                    kRows);
    load_rows<T, D>(Vs, static_cast<const T*>(p.v) + key0 * D, keys_here,
                    kRows);
    for (int j = 0; j < group; ++j) {
      const size_t row0 = size_t(kvh * group + j) * p.s_q;  // (hh, 0)
      const T* q = static_cast<const T*>(p.q) + row0 * D;
      const T* dout = static_cast<const T*>(p.dout) + row0 * D;
      for (long long qt = lo / kTileQ * kTileQ; qt < hi; qt += kTileQ) {
        __syncthreads();  // the previous tile's reads are done
        load_rows<T, D>(Qs, q + qt * D, p.s_q - qt, kTileQ);
        load_rows<T, D>(dOs, dout + qt * D, p.s_q - qt, kTileQ);
        if (threadIdx.x < kTileQ) {
          const long long i = qt + threadIdx.x;
          const bool here = i < p.s_q;
          Ms[threadIdx.x] = here ? p.m[row0 + i] : 0.f;
          Ls[threadIdx.x] = here ? p.linv[row0 + i] : 0.f;
          Ds[threadIdx.x] = here ? p.delta[row0 + i] : 0.f;
        }
        __syncthreads();
        // every (key, query) of the tile live: no mask to evaluate
        bool full = k0 + kRows <= p.s_k && qt + kTileQ <= p.s_q;
        if (p.causal) full = full && p.q_off + qt >= k_first + kRows - 1;
        if (p.window > 0) {
          full = full &&
                 p.q_off + qt + kTileQ - 1 <= k_first + (p.window - 1);
        }
        float st[NT][4], dpt[NT][4];
        dot_tile<T, D, kTileQ>(Ks + warp * 16 * L::LD, Qs, st, lane);
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = jj * 8 + 2 * t + (e & 1);
            float pe = expf(st[jj][e] * p.scale - Ms[col]) * Ls[col];
            if (!full) {
              const long long ql = qt + col;
              const int key = keys[e >> 1];
              if (ql >= p.s_q || key >= p.s_k ||
                  masked(p, p.q_off + ql, p.k_off + (long long)key)) {
                pe = 0.f;
              }
            }
            st[jj][e] = pe;  // P^T
          }
        }
        accumulate<T, D, kTileQ>(st, dOs + c0, Pw, dv, lane);
        dot_tile<T, D, kTileQ>(Vs + warp * 16 * L::LD, dOs, dpt, lane);
#pragma unroll
        for (int jj = 0; jj < NT; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = jj * 8 + 2 * t + (e & 1);
            dpt[jj][e] = st[jj][e] * (dpt[jj][e] - Ds[col]);  // dS^T
          }
        }
        accumulate<T, D, kTileQ>(dpt, Qs + c0, Pw, dk, lane);
      }
    }
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (keys[hr] >= p.s_k) continue;
    const size_t r = size_t(kvh) * p.s_k + keys[hr];
    float* a = p.dk + r * D + c0 + 2 * t;
    float* b = p.dv + r * D + c0 + 2 * t;
#pragma unroll
    for (int dt = 0; dt < L::DT; ++dt) {
      *reinterpret_cast<float2*>(a + dt * 8) =
          make_float2(dk[dt][2 * hr] * p.scale, dk[dt][2 * hr + 1] * p.scale);
      *reinterpret_cast<float2*>(b + dt * 8) =
          make_float2(dv[dt][2 * hr], dv[dt][2 * hr + 1]);
    }
  }
}

template <typename Kernel>
int launch_with(Kernel kernel, size_t smem, dim3 grid, const Params& p,
                void* stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// block_q, block_k: the tile plan the caller assumed, checked here.
// dq: 64 query rows a block, BK keys a tile; dkdv: 32 query rows a tile,
// 64 keys a block.
template <typename T, int D, bool kDq>
int launch(const Params& p, int block_q, int block_k, void* stream) {
  using L = Layout<T, D>;
  const dim3 grid(((kDq ? p.s_q : p.s_k) + kRows - 1) / kRows,
                  kDq ? p.h : p.h_kv, D / L::DO);
  if constexpr (kDq) {
    if (block_q != kRows || block_k != L::BK) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_with(flash_bwd_dq_kernel<T, D>, L::kDqSmem, grid, p,
                       stream);
  } else {
    if (block_q != kTileQ || block_k != kRows) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_with(flash_bwd_dkdv_kernel<T, D>, L::kDkdvSmem, grid, p,
                       stream);
  }
}

// dtype 0: f32, 1: bf16; head dims 64, 128 and 256
template <bool kDq>
int dispatch(const Params& p, int dtype, int d, int block_q, int block_k,
             void* stream) {
  if (p.s_q < 1 || p.s_k < 1 || p.h_kv < 1 || p.h % p.h_kv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    switch (d) {
      case 64: return launch<float, 64, kDq>(p, block_q, block_k, stream);
      case 128: return launch<float, 128, kDq>(p, block_q, block_k, stream);
      case 256: return launch<float, 256, kDq>(p, block_q, block_k, stream);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 64:
        return launch<__nv_bfloat16, 64, kDq>(p, block_q, block_k, stream);
      case 128:
        return launch<__nv_bfloat16, 128, kDq>(p, block_q, block_k, stream);
      case 256:
        return launch<__nv_bfloat16, 256, kDq>(p, block_q, block_k, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int smi_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* m,
                                const float* linv, const float* delta,
                                float* dq, int dtype, int h, int h_kv,
                                int s_q, int s_k, int d, int q_off, int k_off,
                                int causal, int window, float scale,
                                int block_q, int block_k, void* stream) {
  const Params p{q,  k,       v,       dout, m,     linv,  delta,
                 dq, nullptr, nullptr, h,    h_kv,  s_q,   s_k,
                 q_off, k_off, causal, window, scale};
  return dispatch<true>(p, dtype, d, block_q, block_k, stream);
}

extern "C" int smi_flash_bwd_dkdv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* m,
                                  const float* linv, const float* delta,
                                  float* dk, float* dv, int dtype, int h,
                                  int h_kv, int s_q, int s_k, int d,
                                  int q_off, int k_off, int causal,
                                  int window, float scale, int block_q,
                                  int block_k, void* stream) {
  const Params p{q,       k,  v,  dout, m,    linv, delta,
                 nullptr, dk, dv, h,    h_kv, s_q,  s_k,
                 q_off,   k_off, causal, window, scale};
  return dispatch<false>(p, dtype, d, block_q, block_k, stream);
}
