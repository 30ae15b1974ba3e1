// Flash-attention forward for the ring-attention schedule: one kernel
// body, two entry points.
//
// Replaces: smi_tpu/kernels/flash.py::_flash_fused_kernel (driven by
// flash_attend_fused: the whole K/V extent in one launch, fresh state,
// normalised output) and smi_tpu/kernels/flash.py::_flash_kernel (driven
// by flash_block_attend: fold one K/V block into the carried (m, l, acc),
// one launch per ring step). Both TPU kernels share _attend_tile; here
// both entries share attend_tile below and differ only in how the state
// comes in and goes out.
//
// Layouts are the JAX package's: q (H, Sq, D), k/v (H_kv, Sk, D) in f32
// or bf16, m/l (H, 1, Sq) f32 rows, acc (H, Sq, D) f32, out (H, Sq, D) in
// q's dtype. Query head hh reads K/V head hh / (H / H_kv): grouped K/V are
// never repeated in memory. Causality and the sliding window come from
// global positions q_off + i and k_off + j.
//
// Bound on the H100: operations, at every shape the ring path runs.
// Forward attention does 4*D operations per live query-key pair (QK^T
// and PV) against a few bytes per query row; at S=8192, H=8, D=128 causal
// that is 137.5 GFLOP: 2.05 ms at the 67 TFLOP/s of f32 outside the
// tensor cores (f32 must stay full f32: the reference runs HIGHEST, so no
// TF32), 0.14 ms at the 989 TFLOP/s dense bf16 rate.
//
// Design: a block owns 64 query rows of one head (4 warps, 16 rows
// each) and walks only the key tiles that hold a live key for some of its
// rows, so a block wholly in the causal future or outside the window
// runs no tile and passes the carry through bit for bit. Each tile: Q,
// K and V in shared memory; S = Q K^T into registers laid out as the
// m16n8 accumulators of mma.sync (each thread holds two rows); the
// online softmax on those registers with quad shuffles; then O += P V on
// registers of the same layout, so the per-row rescale is a register
// multiply. bf16 runs both products on the tensor cores
// (mma.sync.m16n8k16, f32 accumulation, P rounded to bf16 as the
// reference rounds it to V's dtype). f32 runs them as f32 FMAs on the
// CUDA cores through the same register layout, with P staged in a
// per-warp shared buffer.
//
// Masked scores become -inf inside the kernel, so p = exp(-inf - m) = 0
// exactly: a row with no live key keeps (m, l, acc) = (NEG_INF, 0, 0)
// whatever the tiling, and a row with no live key in this block keeps its
// carried state exactly (alpha = exp(0) = 1, nothing added). Only tiles
// that straddle the diagonal, the window edge or the ragged end of the
// keys evaluate the mask. Loads are plain synchronous 16-byte copies:
// wgmma, TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBlockQ = 64;    // 16 query rows per warp
constexpr float kNegInf = -1e30f;  // NEG_INF of the JAX package

template <typename T>
struct TileOf;
template <>
struct TileOf<float> {
  static constexpr int kBlockK = 32;
  static constexpr int kPad = 4;  // row pad in elements: 16 bytes
};
template <>
struct TileOf<__nv_bfloat16> {
  static constexpr int kBlockK = 64;
  static constexpr int kPad = 8;
};

// The shared-memory plan; smi_tpu_torch/kernels/flash.py::smem_bytes
// computes the same sum.
template <typename T, int D>
struct Layout {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int BK = TileOf<T>::kBlockK;
  static constexpr int LD = D + TileOf<T>::kPad;  // Q/K/V row stride
  static constexpr int NT = BK / 8;  // score accumulator tiles per warp
  static constexpr int DT = D / 8;   // output accumulator tiles per warp
  static constexpr int PLD = BK + 4;  // f32 P row stride
  static constexpr size_t kQBytes = size_t(kBlockQ) * LD * sizeof(T);
  static constexpr size_t kKVBytes = size_t(BK) * LD * sizeof(T);
  static constexpr size_t kPBytes = kF32 ? size_t(4) * 16 * PLD * 4 : 0;
  static constexpr size_t kSmem = kQBytes + 2 * kKVBytes + kPBytes;
};

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

// rows [0, rows) of D elements from src (row stride D) into dst (row
// stride LD), zeros past `avail` so masked keys never meet garbage
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

// s = Q K^T for this warp's 16 rows and the tile's BK keys (unscaled)
template <typename T, int D>
__device__ __forceinline__ void scores(const T* Qs, const T* Ks,
                                       float (&s)[Layout<T, D>::NT][4],
                                       int warp, int lane) {
  using L = Layout<T, D>;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < L::NT; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  }
  if constexpr (L::kF32) {
    const float* q0 = Qs + (warp * 16 + g) * L::LD;
    const float* q1 = q0 + 8 * L::LD;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float4 a = *reinterpret_cast<const float4*>(q0 + d);
      const float4 b = *reinterpret_cast<const float4*>(q1 + d);
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 kk = *reinterpret_cast<const float4*>(
              Ks + (j * 8 + 2 * t + e) * L::LD + d);
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
    const __nv_bfloat16* qa = Qs + (warp * 16 + g) * L::LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t a0 = ld32(qa + kk * 16);
      const uint32_t a1 = ld32(qa + 8 * L::LD + kk * 16);
      const uint32_t a2 = ld32(qa + kk * 16 + 8);
      const uint32_t a3 = ld32(qa + 8 * L::LD + kk * 16 + 8);
#pragma unroll
      for (int j = 0; j < L::NT; ++j) {
        const __nv_bfloat16* kb = Ks + (j * 8 + g) * L::LD + kk * 16 + 2 * t;
        mma_bf16(s[j], a0, a1, a2, a3, ld32(kb), ld32(kb + 8));
      }
    }
  }
}

// o += P V, P in the score registers (already exponentiated)
template <typename T, int D>
__device__ __forceinline__ void accumulate_pv(
    const float (&s)[Layout<T, D>::NT][4], const T* Vs, float* Pw,
    float (&o)[Layout<T, D>::DT][4], int lane) {
  using L = Layout<T, D>;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (L::kF32) {
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Pw[(g + 8 * (e >> 1)) * L::PLD + j * 8 + 2 * t + (e & 1)] = s[j][e];
      }
    }
    __syncwarp();
    const float* p0 = Pw + g * L::PLD;
    const float* p1 = p0 + 8 * L::PLD;
    for (int kk = 0; kk < L::BK; kk += 4) {
      const float4 pa4 = *reinterpret_cast<const float4*>(p0 + kk);
      const float4 pb4 = *reinterpret_cast<const float4*>(p1 + kk);
      const float pa[4] = {pa4.x, pa4.y, pa4.z, pa4.w};
      const float pb[4] = {pb4.x, pb4.y, pb4.z, pb4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = Vs + (kk + u) * L::LD + 2 * t;
#pragma unroll
        for (int dt = 0; dt < L::DT; ++dt) {
          const float2 vv = *reinterpret_cast<const float2*>(vrow + dt * 8);
          o[dt][0] = fmaf(pa[u], vv.x, o[dt][0]);
          o[dt][1] = fmaf(pa[u], vv.y, o[dt][1]);
          o[dt][2] = fmaf(pb[u], vv.x, o[dt][2]);
          o[dt][3] = fmaf(pb[u], vv.y, o[dt][3]);
        }
      }
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int kk = 0; kk < L::BK / 16; ++kk) {
      const uint32_t a0 = pack_f32(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_f32(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vb = Vs + (kk * 16 + 2 * t) * L::LD + g;
#pragma unroll
      for (int dt = 0; dt < L::DT; ++dt) {
        const __nv_bfloat16* c = vb + dt * 8;
        const uint32_t b0 = pack_bf16(c[0], c[L::LD]);
        const uint32_t b1 = pack_bf16(c[8 * L::LD], c[9 * L::LD]);
        mma_bf16(o[dt], a0, a1, a2, a3, b0, b1);
      }
    }
  }
}

// Fold one (64, BK) score tile into the online-softmax state: scale,
// mask to -inf where dead, rescale by the new row max, exponentiate, and
// add P V. The body both entries share (the TPU kernels' _attend_tile).
template <typename T, int D>
__device__ __forceinline__ void attend_tile(
    const T* Qs, const T* Ks, const T* Vs, float* Pw,
    float (&o)[Layout<T, D>::DT][4], float (&m)[2], float (&l)[2],
    const Params& p, long long q_first, long long kt, bool apply_mask,
    int warp, int lane) {
  using L = Layout<T, D>;
  const int g = lane >> 2, t = lane & 3;
  float s[L::NT][4];
  scores<T, D>(Qs, Ks, s, warp, lane);
#pragma unroll
  for (int j = 0; j < L::NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * p.scale;
      if (apply_mask) {
        const long long col = kt + j * 8 + 2 * t + (e & 1);
        const long long qp = q_first + warp * 16 + g + 8 * (e >> 1);
        const long long kp = p.k_off + col;
        bool dead = col >= p.s_k;
        if (p.causal) dead = dead || kp > qp;
        if (p.window > 0) dead = dead || kp < qp - (p.window - 1);
        if (dead) x = -CUDART_INF_F;
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
    const float m_new = fmaxf(m[hr], mx);  // finite: m starts at NEG_INF
    const float alpha = expf(m[hr] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < L::NT; ++j) {
#pragma unroll
      for (int e = 2 * hr; e < 2 * hr + 2; ++e) {
        const float pe = expf(s[j][e] - m_new);  // 0 where masked
        s[j][e] = pe;
        sum += pe;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[hr] = l[hr] * alpha + sum;
    m[hr] = m_new;
#pragma unroll
    for (int dt = 0; dt < L::DT; ++dt) {
      o[dt][2 * hr] *= alpha;
      o[dt][2 * hr + 1] *= alpha;
    }
  }
  accumulate_pv<T, D>(s, Vs, Pw, o, lane);
}

template <typename T, int D, bool kCarried>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  using L = Layout<T, D>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = reinterpret_cast<T*>(smem + L::kQBytes);
  T* Vs = reinterpret_cast<T*>(smem + L::kQBytes + L::kKVBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* Pw = reinterpret_cast<float*>(smem + L::kQBytes + 2 * L::kKVBytes) +
              warp * 16 * L::PLD;

  const int hh = blockIdx.y;
  const int kvh = hh / (p.h / p.h_kv);
  const int q0 = blockIdx.x * kBlockQ;
  const int rows_here = min(kBlockQ, p.s_q - q0);
  const T* q = static_cast<const T*>(p.q) + (size_t(hh) * p.s_q + q0) * D;
  const T* k = static_cast<const T*>(p.k) + size_t(kvh) * p.s_k * D;
  const T* v = static_cast<const T*>(p.v) + size_t(kvh) * p.s_k * D;
  const size_t row0 = size_t(hh) * p.s_q;  // (hh, 0) of m/l/acc/out
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  float m[2], l[2], o[L::DT][4];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    m[hr] = kNegInf;
    l[hr] = 0.f;
#pragma unroll
    for (int dt = 0; dt < L::DT; ++dt) o[dt][2 * hr] = o[dt][2 * hr + 1] = 0.f;
    if (kCarried && rows[hr] < p.s_q) {
      const size_t r = row0 + rows[hr];
      m[hr] = p.m_in[r];
      l[hr] = p.l_in[r];
      const float* a = p.acc_in + r * D + 2 * t;
#pragma unroll
      for (int dt = 0; dt < L::DT; ++dt) {
        const float2 x = *reinterpret_cast<const float2*>(a + dt * 8);
        o[dt][2 * hr] = x.x;
        o[dt][2 * hr + 1] = x.y;
      }
    }
  }

  // the live key span of this block's rows, in local key indices
  const long long q_first = (long long)p.q_off + q0;
  const long long q_last = q_first + rows_here - 1;
  long long lo = 0, hi = p.s_k;
  if (p.causal) hi = min(hi, q_last - p.k_off + 1);
  if (p.window > 0) lo = max(lo, q_first - (p.window - 1) - p.k_off);

  if (lo < hi) {
    load_rows<T, D>(Qs, q, rows_here, kBlockQ);
    for (long long kt = lo / L::BK * L::BK; kt < hi; kt += L::BK) {
      __syncthreads();  // the previous tile's K/V reads are done
      load_rows<T, D>(Ks, k + kt * D, p.s_k - kt, L::BK);
      load_rows<T, D>(Vs, v + kt * D, p.s_k - kt, L::BK);
      __syncthreads();
      // every (row, key) of the tile live: no mask to evaluate
      bool full = kt + L::BK <= p.s_k;
      if (p.causal) full = full && p.k_off + kt + L::BK - 1 <= q_first;
      if (p.window > 0) {
        full = full && p.k_off + kt >= q_first + kBlockQ - 1 - (p.window - 1);
      }
      attend_tile<T, D>(Qs, Ks, Vs, Pw, o, m, l, p, q_first, kt, !full, warp,
                        lane);
    }
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
      float* a = static_cast<float*>(p.out) + r * D + 2 * t;
#pragma unroll
      for (int dt = 0; dt < L::DT; ++dt) {
        *reinterpret_cast<float2*>(a + dt * 8) =
            make_float2(o[dt][2 * hr], o[dt][2 * hr + 1]);
      }
    } else {
      const float safe_l = l[hr] == 0.f ? 1.f : l[hr];
      T* out = static_cast<T*>(p.out) + r * D + 2 * t;
#pragma unroll
      for (int dt = 0; dt < L::DT; ++dt) {
        const float x = o[dt][2 * hr] / safe_l;
        const float y = o[dt][2 * hr + 1] / safe_l;
        if constexpr (L::kF32) {
          *reinterpret_cast<float2*>(out + dt * 8) = make_float2(x, y);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + dt * 8) =
              __floats2bfloat162_rn(x, y);
        }
      }
    }
  }
}

template <typename T, int D, bool kCarried>
int launch(const Params& p, int block_q, int block_k, void* stream) {
  using L = Layout<T, D>;
  if (block_q != kBlockQ || block_k != L::BK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_kernel<T, D, kCarried>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  const dim3 grid((p.s_q + kBlockQ - 1) / kBlockQ, p.h);
  kernel<<<grid, kThreads, L::kSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: f32, 1: bf16; head dims 64, 128 and 256
template <bool kCarried>
int dispatch(const Params& p, int dtype, int d, int block_q, int block_k,
             void* stream) {
  if (p.s_q < 1 || p.s_k < 1 || p.h_kv < 1 || p.h % p.h_kv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    switch (d) {
      case 64: return launch<float, 64, kCarried>(p, block_q, block_k, stream);
      case 128: return launch<float, 128, kCarried>(p, block_q, block_k, stream);
      case 256: return launch<float, 256, kCarried>(p, block_q, block_k, stream);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 64:
        return launch<__nv_bfloat16, 64, kCarried>(p, block_q, block_k, stream);
      case 128:
        return launch<__nv_bfloat16, 128, kCarried>(p, block_q, block_k, stream);
      case 256:
        return launch<__nv_bfloat16, 256, kCarried>(p, block_q, block_k, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int smi_flash_fused(const void* q, const void* k, const void* v,
                               void* out, float* m_out, float* l_out,
                               int dtype, int h, int h_kv, int s_q, int s_k,
                               int d, int q_off, int k_off, int causal,
                               int window, float scale, int block_q,
                               int block_k, void* stream) {
  const Params p{q, k, v, nullptr, nullptr, nullptr, out, m_out, l_out,
                 h, h_kv, s_q, s_k, q_off, k_off, causal, window, scale};
  return dispatch<false>(p, dtype, d, block_q, block_k, stream);
}

extern "C" int smi_flash_block(const void* q, const void* k, const void* v,
                               const float* m_in, const float* l_in,
                               const float* acc_in, float* m_out,
                               float* l_out, float* acc_out, int dtype, int h,
                               int h_kv, int s_q, int s_k, int d, int q_off,
                               int k_off, int causal, int window, float scale,
                               int block_q, int block_k, void* stream) {
  const Params p{q, k, v, m_in, l_in, acc_in, acc_out, m_out, l_out,
                 h, h_kv, s_q, s_k, q_off, k_off, causal, window, scale};
  return dispatch<true>(p, dtype, d, block_q, block_k, stream);
}
