// The afmoe attention sublayer's elementwise glue, fused: the prologue
// (QK norm, rotary positions and the bf16 fold between the wqkv product
// and the flash kernels) and the epilogue (the sigmoid gate between the
// flash kernels and the wo product), each with its backward.
//
// Replaces no TPU kernel: the JAX package has no afmoe block. The port's
// models/transformer.py::block_shard ran this glue as some 25 f32 torch
// passes a layer (widen the bf16 products, copy the strided heads, norm,
// rotate, round, transpose, widen the flash output, gate, round again),
// ~9 GB of device traffic a windowed layer at 2 x 8192 tokens.
//
// Bound on the H100: device-memory bytes. A few operations per element
// against the card's ~20 flop/B balance point. Each kernel reads each
// bf16 operand once and writes each bf16 result once, in the layout its
// consumer reads: the prologue reads the bf16 wqkv product (B*S,
// (H+2KV)*D) and writes q (B*H, S, D), k and v (B*KV, S, D), head-major
// with the heads of one batch adjacent (index b*H + h, so the GQA map
// hh / (H/KV) holds); the epilogue reads the flash output where it lies,
// head-major, and the bf16 gate product (B*S, H*D), and writes the wo
// product's input (B*S, H*D). At B=2, S=8192, H=32, KV=4, D=128 that is
// 336 MB for the prologue and 403 MB for the epilogue (0.10 and 0.12 ms).
//
// Design: one warp a (token, head) row of D = 32*E values, E a lane, in
// one vector load. The row's sum of squares is a butterfly of shuffles
// (every lane ends with the same bits); the rotation's partner half is
// 16 lanes away (shfl_xor 16). Math is f32 in registers; each output is
// rounded to bf16 once, where the unfused composition rounds it. The
// rotary tables are (S, D) f32 with equal halves (built by the same torch
// expressions the unfused path uses), read at the lane's own column.
//
// Arithmetic: built with -fmad=false and without fast math, in the
// unfused composition's operand order: the norm (x * rstd) * w with rstd
// = rsqrtf(mean(x^2) + eps), as torch's CUDA RMSNorm takes it (the sum
// of squares in another order: the result may differ from torch's by an
// ulp, which bf16 rounding mostly hides); the rotation x*cos + rot*sin;
// sigmoid 1 / (1 + expf(-g)) and its backward (d * (1 - s)) * s as
// torch's CUDA kernels compute them. The RMSNorm backward is the closed
// form dx = rstd * g*w - x * (rstd^3 * sum(g*w*x) / D).
//
// No atomics: the weight gradients of the QK norms are summed per warp
// over a fixed set of rows, the warps of a block in order into one
// partial a block, and the partials in order by row_glue.cuh's
// weight_grad_kernel, so a step repeats bit for bit.

#include "row_glue.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// E bf16 values a lane, in one load
template <int E> struct Bits;
template <> struct Bits<2> { using T = uint32_t; };
template <> struct Bits<4> { using T = uint2; };
template <> struct Bits<8> { using T = uint4; };

template <int E>
__device__ __forceinline__ void load_row(const uint16_t* p, float (&x)[E]) {
  const typename Bits<E>::T raw =
      *reinterpret_cast<const typename Bits<E>::T*>(p);
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < E / 2; ++i) widen_bf16x2(w[i], x + 2 * i);
}

template <int E>
__device__ __forceinline__ void store_row(uint16_t* p, const float (&x)[E]) {
  typename Bits<E>::T raw;
  uint32_t* w = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
  for (int i = 0; i < E / 2; ++i) w[i] = pack_bf16x2(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<typename Bits<E>::T*>(p) = raw;
}

// rsqrt(mean(x^2) + eps) of the warp's row
template <int E>
__device__ __forceinline__ float row_rstd(const float (&x)[E], float eps) {
  float ss = 0.0f;
#pragma unroll
  for (int i = 0; i < E; ++i) ss += x[i] * x[i];
  return rsqrtf(warp_sum(ss) / (32 * E) + eps);
}

struct Row {
  int head, s, b;
};

__device__ __forceinline__ Row decode(long long row, int width, int seq) {
  const long long token = row / width;
  return {static_cast<int>(row - token * width),
          static_cast<int>(token % seq), static_cast<int>(token / seq)};
}

struct Prologue {
  const uint16_t* qkv;  // (B*S, (H + 2*KV) * D) bf16
  const float* q_w;     // (D,) the q_norm weight
  const float* k_w;     // (D,) the k_norm weight
  const float* cos;     // (S, D) f32, halves equal; null: no rotation
  const float* sin;
  uint16_t* q;          // (B*H, S, D) bf16
  uint16_t* k;          // (B*KV, S, D)
  uint16_t* v;          // (B*KV, S, D)
  int batch, seq, heads, kv_heads;
  float eps;
};

// the head-major row of (b, s, head), in q, k or v by the head's kind
template <typename T>
__device__ __forceinline__ T* head_row(T* q, T* k, T* v, const Row& r,
                                       int seq, int heads, int kv_heads,
                                       int d) {
  if (r.head < heads) {
    return q + (static_cast<long long>(r.b * heads + r.head) * seq + r.s) * d;
  }
  T* base = r.head < heads + kv_heads ? k : v;
  const int j = r.head < heads + kv_heads ? r.head - heads
                                          : r.head - heads - kv_heads;
  return base + (static_cast<long long>(r.b * kv_heads + j) * seq + r.s) * d;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_prologue_kernel(const Prologue p) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31;
  const int width = p.heads + 2 * p.kv_heads;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(p.batch) * p.seq * width) return;
  const Row r = decode(row, width, p.seq);
  float x[E];
  load_row<E>(p.qkv + row * D + lane * E, x);
  if (r.head < p.heads + p.kv_heads) {  // a query or key head: norm it
    const float* w = r.head < p.heads ? p.q_w : p.k_w;
    const float rstd = row_rstd<E>(x, p.eps);
#pragma unroll
    for (int i = 0; i < E; ++i) x[i] = x[i] * rstd * w[lane * E + i];
    if (p.cos != nullptr) {
      // out_j = x_j cos_j + rot_j sin_j, rot = (-x[D/2:], x[:D/2])
      const float* c = p.cos + static_cast<long long>(r.s) * D + lane * E;
      const float* sn = p.sin + static_cast<long long>(r.s) * D + lane * E;
      float rot[E];
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float partner = __shfl_xor_sync(kFull, x[i], 16);
        rot[i] = lane < 16 ? -partner : partner;
      }
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = x[i] * c[i] + rot[i] * sn[i];
    }
  }
  store_row<E>(head_row(p.q, p.k, p.v, r, p.seq, p.heads, p.kv_heads, D) +
                   lane * E,
               x);
}

struct PrologueBwd {
  const uint16_t* qkv;  // the forward's input, bf16
  const float* q_w;
  const float* k_w;
  const float* cos;     // null: no rotation
  const float* sin;
  const uint16_t* dq;   // (B*H, S, D) bf16
  const uint16_t* dk;   // (B*KV, S, D)
  const uint16_t* dv;
  uint16_t* dqkv;       // (B*S, (H + 2*KV) * D) bf16
  float* partial;       // (gridDim.x, 2, D): each block's d q_norm, d k_norm
  int batch, seq, heads, kv_heads;
  float eps;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_prologue_bwd_kernel(const PrologueBwd p) {
  constexpr int E = D / 32;
  __shared__ float sums[kWarps][2 * D];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int width = p.heads + 2 * p.kv_heads;
  const long long rows = static_cast<long long>(p.batch) * p.seq * width;
  float dwq[E], dwk[E];
#pragma unroll
  for (int i = 0; i < E; ++i) dwq[i] = dwk[i] = 0.0f;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
       row < rows; row += static_cast<long long>(gridDim.x) * kWarps) {
    const Row r = decode(row, width, p.seq);
    float g[E];
    load_row<E>(head_row(p.dq, p.dk, p.dv, r, p.seq, p.heads, p.kv_heads, D) +
                    lane * E,
                g);
    uint16_t* out = p.dqkv + row * D + lane * E;
    if (r.head >= p.heads + p.kv_heads) {  // a value head: moved as it is
      store_row<E>(out, g);
      continue;
    }
    const bool is_q = r.head < p.heads;
    if (p.cos != nullptr) {
      // d x_j = g_j cos_j + (j < D/2 ? g_{j+D/2} : -g_{j-D/2}) sin_j
      const float* c = p.cos + static_cast<long long>(r.s) * D + lane * E;
      const float* sn = p.sin + static_cast<long long>(r.s) * D + lane * E;
      float turned[E];
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const float t = __shfl_xor_sync(kFull, g[i], 16) * sn[i];
        turned[i] = lane < 16 ? t : -t;
      }
#pragma unroll
      for (int i = 0; i < E; ++i) g[i] = g[i] * c[i] + turned[i];
    }
    float x[E];
    load_row<E>(p.qkv + row * D + lane * E, x);
    const float rstd = row_rstd<E>(x, p.eps);
    const float* w = is_q ? p.q_w : p.k_w;
    float gw[E];
    float dot = 0.0f;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float dw = g[i] * (x[i] * rstd);
      if (is_q) {
        dwq[i] += dw;
      } else {
        dwk[i] += dw;
      }
      gw[i] = g[i] * w[lane * E + i];
      dot += gw[i] * x[i];
    }
    const float coef = rstd * rstd * rstd * warp_sum(dot) / D;
    float dx[E];
#pragma unroll
    for (int i = 0; i < E; ++i) dx[i] = rstd * gw[i] - x[i] * coef;
    store_row<E>(out, dx);
  }
#pragma unroll
  for (int i = 0; i < E; ++i) {
    sums[warp][lane * E + i] = dwq[i];
    sums[warp][D + lane * E + i] = dwk[i];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < 2 * D; col += kThreads) {
    float t = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += sums[w][col];
    p.partial[static_cast<long long>(blockIdx.x) * 2 * D + col] = t;
  }
}

struct Epilogue {
  const uint16_t* attn;  // (B*H, S, D) bf16, the flash output
  const uint16_t* gate;  // (B*S, H*D) bf16, the gate product
  const uint16_t* dout;  // (B*S, H*D) bf16 (backward)
  uint16_t* out;         // forward: (B*S, H*D); backward: d attn (B*H, S, D)
  uint16_t* dgate;       // (B*S, H*D) (backward)
  int batch, seq, heads;
};

__device__ __forceinline__ float sigmoid(float g) {
  return 1.0f / (1.0f + expf(-g));
}

// rows in token order, (b*S + s)*H + h: the gate's and the output's row
// index; the flash output's row is (b*H + h)*S + s
__device__ __forceinline__ long long attn_row(long long row, int seq,
                                              int heads) {
  const long long token = row / heads;
  const int h = static_cast<int>(row - token * heads);
  const int s = static_cast<int>(token % seq);
  const int b = static_cast<int>(token / seq);
  return static_cast<long long>(b * heads + h) * seq + s;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_epilogue_kernel(const Epilogue p) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(p.batch) * p.seq * p.heads) return;
  float a[E], g[E];
  load_row<E>(p.attn + attn_row(row, p.seq, p.heads) * D + lane * E, a);
  load_row<E>(p.gate + row * D + lane * E, g);
#pragma unroll
  for (int i = 0; i < E; ++i) a[i] = a[i] * sigmoid(g[i]);
  store_row<E>(p.out + row * D + lane * E, a);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    attn_epilogue_bwd_kernel(const Epilogue p) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= static_cast<long long>(p.batch) * p.seq * p.heads) return;
  const long long arow = attn_row(row, p.seq, p.heads);
  float a[E], g[E], d[E];
  load_row<E>(p.attn + arow * D + lane * E, a);
  load_row<E>(p.gate + row * D + lane * E, g);
  load_row<E>(p.dout + row * D + lane * E, d);
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float s = sigmoid(g[i]);
    g[i] = d[i] * a[i] * (1.0f - s) * s;  // d gate
    a[i] = d[i] * s;                      // d attn
  }
  store_row<E>(p.out + arow * D + lane * E, a);
  store_row<E>(p.dgate + row * D + lane * E, g);
}

unsigned rows_blocks(long long rows) {
  return static_cast<unsigned>((rows + kWarps - 1) / kWarps);
}

}  // namespace

#define SMI_GLUE_DISPATCH(KERNEL, GRID, ...)                              \
  switch (head_dim) {                                                     \
    case 64: KERNEL<64><<<GRID, kThreads, 0, st>>>(__VA_ARGS__); break;   \
    case 128: KERNEL<128><<<GRID, kThreads, 0, st>>>(__VA_ARGS__); break; \
    case 256: KERNEL<256><<<GRID, kThreads, 0, st>>>(__VA_ARGS__); break; \
    default: return static_cast<int>(cudaErrorInvalidValue);              \
  }

extern "C" int smi_attn_prologue(const void* qkv, const float* q_w,
                                 const float* k_w, const float* cos,
                                 const float* sin, void* q, void* k, void* v,
                                 int batch, int seq, int heads, int kv_heads,
                                 int head_dim, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Prologue p{static_cast<const uint16_t*>(qkv), q_w, k_w, cos, sin,
                   static_cast<uint16_t*>(q), static_cast<uint16_t*>(k),
                   static_cast<uint16_t*>(v), batch, seq, heads, kv_heads,
                   eps};
  const unsigned grid = rows_blocks(static_cast<long long>(batch) * seq *
                                    (heads + 2 * kv_heads));
  SMI_GLUE_DISPATCH(attn_prologue_kernel, grid, p)
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smi_attn_prologue_bwd(
    const void* qkv, const float* q_w, const float* k_w, const float* cos,
    const float* sin, const void* dq, const void* dk, const void* dv,
    void* dqkv, float* partial, float* dw, int batch, int seq, int heads,
    int kv_heads, int head_dim, int blocks, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PrologueBwd p{static_cast<const uint16_t*>(qkv),
                      q_w, k_w, cos, sin,
                      static_cast<const uint16_t*>(dq),
                      static_cast<const uint16_t*>(dk),
                      static_cast<const uint16_t*>(dv),
                      static_cast<uint16_t*>(dqkv), partial, batch, seq,
                      heads, kv_heads, eps};
  SMI_GLUE_DISPATCH(attn_prologue_bwd_kernel, blocks, p)
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // dw: (2, D), d q_norm then d k_norm
  return sum_weight_grads(partial, blocks, 2 * head_dim, dw, st);
}

extern "C" int smi_attn_epilogue(const void* attn, const void* gate,
                                 void* out, int batch, int seq, int heads,
                                 int head_dim, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epilogue p{static_cast<const uint16_t*>(attn),
                   static_cast<const uint16_t*>(gate), nullptr,
                   static_cast<uint16_t*>(out), nullptr, batch, seq, heads};
  const unsigned grid = rows_blocks(static_cast<long long>(batch) * seq * heads);
  SMI_GLUE_DISPATCH(attn_epilogue_kernel, grid, p)
  return static_cast<int>(cudaGetLastError());
}

extern "C" int smi_attn_epilogue_bwd(const void* attn, const void* gate,
                                     const void* dout, void* dattn,
                                     void* dgate, int batch, int seq,
                                     int heads, int head_dim, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Epilogue p{static_cast<const uint16_t*>(attn),
                   static_cast<const uint16_t*>(gate),
                   static_cast<const uint16_t*>(dout),
                   static_cast<uint16_t*>(dattn),
                   static_cast<uint16_t*>(dgate), batch, seq, heads};
  const unsigned grid = rows_blocks(static_cast<long long>(batch) * seq * heads);
  SMI_GLUE_DISPATCH(attn_epilogue_bwd_kernel, grid, p)
  return static_cast<int>(cudaGetLastError());
}
