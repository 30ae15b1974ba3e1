// The afmoe block's residual junctions, fused: the sandwich RMSNorms, the
// residual adds and the casts around them, one kernel a junction each
// way, in three forms of one template:
//
//   entry   xn = bf16(rms(x) * w), x passed on      the block's start; the
//                                                   final norm of the head
//   middle  h = x + rms(out) * w_post,              after the attention's
//           yn = rms(h) * w_pre (bf16 or f32)       wo product (bf16)
//   exit    x_out = h + rms(out) * w               after the MLP (f32)
//
// Replaces no TPU kernel: the JAX package has no afmoe block. The port's
// models/transformer.py::block_shard ran each junction as plain torch
// passes over (T, E) f32 activations (widen the bf16 product, RMSNorm,
// add, RMSNorm, round to bf16): five kernels and ~1.1 GB for the middle
// junction alone at T = 16,384, E = 2,048.
//
// Bound on the H100: device-memory bytes. A few operations per element
// against the card's ~20 flop/B balance point. Each form reads each
// operand once and writes each result once: the middle reads x (f32) and
// out (bf16) and writes h (f32) and yn, 0.40 GB at the cell's shape
// (0.12 ms at 3.35 TB/s); its backward reads dh, d yn, x and out and
// writes dx (f32) and d out (bf16), 0.60 GB; the entry's backward reads
// d xn, x and the middle's dx and writes dx, 0.47 GB.
//
// Design: a warp group (128 threads) a row, each thread 8 adjacent
// columns a span of 1024 (one 16-byte load of bf16, two of f32), two
// spans a row (E <= 2048, Trinity-Mini's width; a thread past the row's
// end holds zeros). The
// row's sums are shuffles within each warp, then the four warps' sums
// added in warp order through shared memory, so every thread holds the
// same bits. Math is f32 in registers; a value is rounded to bf16 only
// where the plain composition rounds it (xn, a dense layer's yn, d out of
// the bf16 product). Each forward writes its rows' 1/rms (a float a row
// and norm) for the backward, which recomputes h from x and out in the
// forward's operand order, so it keeps no f32 copy of a normed tensor.
// The entry passes x on to the middle (a view: nothing is written), so
// its backward sums both of x's gradients, the middle's and the norm's,
// in one pass.
//
// Arithmetic: built with -fmad=false and without fast math, in torch's
// order: the norm (x * rstd) * w with rstd = rsqrtf(sum(x^2) / E + eps)
// (the sum in another order than torch's: results may differ by an ulp).
// The RMSNorm backward is the closed form dx = rstd * g*w - x * (rstd^3 *
// sum(g*w*x) / E); the middle's residual gradient dh is added to its
// pre-norm term before the post-norm's backward reads it.
//
// No atomics: the backward runs a fixed grid whose blocks stride over the
// rows, each thread summing its columns' weight gradients in registers;
// one partial a block, summed in block order by row_glue.cuh's
// weight_grad_kernel, so a step repeats bit for bit.

#include "row_glue.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;                 // adjacent columns a thread a span
constexpr int kSpan = kThreads * kChunk;  // columns a span: 1024
constexpr int kSpans = 2;                 // spans a row: widths up to 2048

enum Form { kEntry = 0, kMiddle = 1, kExit = 2 };

__device__ __forceinline__ void load8(const float* p, float (&v)[kChunk]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const uint16_t* p, float (&v)[kChunk]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  widen_bf16x2(raw.x, v);
  widen_bf16x2(raw.y, v + 2);
  widen_bf16x2(raw.z, v + 4);
  widen_bf16x2(raw.w, v + 6);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kChunk]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(uint16_t* p, const float (&v)[kChunk]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// a thread's share of a row: its columns c * kSpan + 8 * threadIdx.x + i
struct Row {
  float v[kSpans][kChunk];
};

__device__ __forceinline__ bool live(int c, int width) {
  return c * kSpan + static_cast<int>(threadIdx.x) * kChunk < width;
}

template <typename T>
__device__ __forceinline__ void load_row(const T* base, int width, Row& r) {
#pragma unroll
  for (int c = 0; c < kSpans; ++c) {
    if (live(c, width)) {
      load8(base + c * kSpan + threadIdx.x * kChunk, r.v[c]);
    } else {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) r.v[c][i] = 0.0f;
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_row(T* base, int width, const Row& r) {
#pragma unroll
  for (int c = 0; c < kSpans; ++c) {
    if (live(c, width)) store8(base + c * kSpan + threadIdx.x * kChunk,
                                  r.v[c]);
  }
}

// the weight of column (c, i), 0 past the row's end
__device__ __forceinline__ float weight(const float* w, int c, int i,
                                        int width) {
  const int col = c * kSpan + threadIdx.x * kChunk + i;
  return col < width ? w[col] : 0.0f;
}

// the sum of v over the warp group, the warps' sums in warp order: the
// same bits in every thread
__device__ __forceinline__ float group_sum(float v, float* slots) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += slots[w];
  __syncthreads();  // the slots are free for the next sum
  return t;
}

// rsqrt(mean(r^2) + eps) of the group's row
__device__ __forceinline__ float row_rstd(const Row& r, int width, float eps,
                                          float* slots) {
  float ss = 0.0f;
#pragma unroll
  for (int c = 0; c < kSpans; ++c) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) ss += r.v[c][i] * r.v[c][i];
  }
  return rsqrtf(group_sum(ss, slots) / width + eps);
}

struct Fwd {
  const float* x;    // (rows, width) f32: x (entry, middle) or h (exit)
  const void* out;   // the sublayer's output: bf16 (middle), f32 (exit)
  const float* w0;   // (width,) input_norm (entry) or the post-norm
  const float* w1;   // (width,) pre_mlp_norm (middle)
  void* y0;          // xn bf16 (entry), h f32 (middle), x_out f32 (exit)
  void* y1;          // yn (middle): bf16 or f32
  float* rstd;       // (norms, rows): each norm's 1/rms a row
  int rows, width;
  float eps;
};

template <int FORM, bool YN_BF16>
__global__ void __launch_bounds__(kThreads)
    residual_norm_kernel(const Fwd p) {
  __shared__ float slots[kWarps];
  const long long row = blockIdx.x;
  const long long at = row * p.width;
  Row a;
  load_row(p.x + at, p.width, a);
  if (FORM == kEntry) {
    const float r = row_rstd(a, p.width, p.eps, slots);
#pragma unroll
    for (int c = 0; c < kSpans; ++c) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        a.v[c][i] = a.v[c][i] * r * weight(p.w0, c, i, p.width);
      }
    }
    store_row(static_cast<uint16_t*>(p.y0) + at, p.width, a);
    if (threadIdx.x == 0) p.rstd[row] = r;
    return;
  }
  Row o;
  if (FORM == kMiddle) {
    load_row(static_cast<const uint16_t*>(p.out) + at, p.width, o);
  } else {
    load_row(static_cast<const float*>(p.out) + at, p.width, o);
  }
  const float r0 = row_rstd(o, p.width, p.eps, slots);
#pragma unroll
  for (int c = 0; c < kSpans; ++c) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      a.v[c][i] = a.v[c][i] + o.v[c][i] * r0 * weight(p.w0, c, i, p.width);
    }
  }
  store_row(static_cast<float*>(p.y0) + at, p.width, a);
  if (threadIdx.x == 0) p.rstd[row] = r0;
  if (FORM != kMiddle) return;
  const float r1 = row_rstd(a, p.width, p.eps, slots);
#pragma unroll
  for (int c = 0; c < kSpans; ++c) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      a.v[c][i] = a.v[c][i] * r1 * weight(p.w1, c, i, p.width);
    }
  }
  if (YN_BF16) {
    store_row(static_cast<uint16_t*>(p.y1) + at, p.width, a);
  } else {
    store_row(static_cast<float*>(p.y1) + at, p.width, a);
  }
  if (threadIdx.x == 0) p.rstd[p.rows + row] = r1;
}

struct Bwd {
  const float* x;     // the forward's x (entry, middle)
  const void* out;    // the forward's out: bf16 (middle), f32 (exit)
  const float* w0;
  const float* w1;
  const float* rstd;  // the forward's (norms, rows)
  const float* dres;  // f32: the gradient of the stream passed on, x
                      // (entry; null: none), h (middle) or x_out (exit)
  const void* dy;     // d xn bf16 (entry), d yn (middle): bf16 or f32
  float* dx;          // (rows, width) f32 (entry, middle)
  void* dout;         // d out: bf16 (middle), f32 (exit)
  float* partial;     // (gridDim.x, norms, width): each block's d w
  int rows, width;
};

// d rms: rstd * gw - v * (rstd^3 * dot / width) into gw, where gw = g*w
// and dot = sum(gw * v) over the row
__device__ __forceinline__ void norm_grad(Row& gw, const Row& v,
                                          float r, float dot, int width) {
  const float coef = r * r * r * dot / width;
#pragma unroll
  for (int c = 0; c < kSpans; ++c) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      gw.v[c][i] = r * gw.v[c][i] - v.v[c][i] * coef;
    }
  }
}

// gw = g * w, dw += g * (v * r), and the group's sum(gw * v)
__device__ __forceinline__ float weigh(Row& g, const Row& v, float r,
                                       const float* w, Row& dw, int width,
                                       float* slots) {
  float dot = 0.0f;
#pragma unroll
  for (int c = 0; c < kSpans; ++c) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      dw.v[c][i] += g.v[c][i] * (v.v[c][i] * r);
      g.v[c][i] = g.v[c][i] * weight(w, c, i, width);
      dot += g.v[c][i] * v.v[c][i];
    }
  }
  return group_sum(dot, slots);
}

// g = dres + g: the residual stream's gradient joins the norm's (none
// where dres is null: the stream is not read past the junction)
__device__ __forceinline__ void add_residual(const float* dres, long long at,
                                             int width, Row& g) {
  if (dres == nullptr) return;
  Row res;
  load_row(dres + at, width, res);
#pragma unroll
  for (int c = 0; c < kSpans; ++c) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) g.v[c][i] = res.v[c][i] + g.v[c][i];
  }
}

template <int FORM, bool YN_BF16>
__global__ void __launch_bounds__(kThreads, 4)
    residual_norm_bwd_kernel(const Bwd p) {
  constexpr int kNorms = FORM == kMiddle ? 2 : 1;
  __shared__ float slots[kWarps];
  Row dw[kNorms];
#pragma unroll
  for (int k = 0; k < kNorms; ++k) {
#pragma unroll
    for (int c = 0; c < kSpans; ++c) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) dw[k].v[c][i] = 0.0f;
    }
  }
  for (long long row = blockIdx.x; row < p.rows; row += gridDim.x) {
    const long long at = row * p.width;
    const float r0 = p.rstd[row];
    Row g;
    if (FORM == kEntry) {
      Row a;
      load_row(static_cast<const uint16_t*>(p.dy) + at, p.width, g);
      load_row(p.x + at, p.width, a);
      const float dot = weigh(g, a, r0, p.w0, dw[0], p.width, slots);
      norm_grad(g, a, r0, dot, p.width);
      add_residual(p.dres, at, p.width, g);
      store_row(p.dx + at, p.width, g);
      continue;
    }
    Row o;
    if (FORM == kMiddle) {
      load_row(static_cast<const uint16_t*>(p.out) + at, p.width, o);
      // h as the forward computed it, then the pre-norm's backward
      Row h;
      load_row(p.x + at, p.width, h);
#pragma unroll
      for (int c = 0; c < kSpans; ++c) {
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          h.v[c][i] = h.v[c][i] +
                      o.v[c][i] * r0 * weight(p.w0, c, i, p.width);
        }
      }
      const float r1 = p.rstd[p.rows + row];
      if (YN_BF16) {
        load_row(static_cast<const uint16_t*>(p.dy) + at, p.width, g);
      } else {
        load_row(static_cast<const float*>(p.dy) + at, p.width, g);
      }
      const float dot = weigh(g, h, r1, p.w1, dw[1], p.width, slots);
      norm_grad(g, h, r1, dot, p.width);
      add_residual(p.dres, at, p.width, g);
      store_row(p.dx + at, p.width, g);
    } else {
      load_row(static_cast<const float*>(p.out) + at, p.width, o);
      load_row(p.dres + at, p.width, g);
    }
    // the post-norm's backward: d out from the residual's gradient g
    const float dot = weigh(g, o, r0, p.w0, dw[0], p.width, slots);
    norm_grad(g, o, r0, dot, p.width);
    if (FORM == kMiddle) {
      store_row(static_cast<uint16_t*>(p.dout) + at, p.width, g);
    } else {
      store_row(static_cast<float*>(p.dout) + at, p.width, g);
    }
  }
#pragma unroll
  for (int k = 0; k < kNorms; ++k) {
    store_row(p.partial +
                  (static_cast<long long>(blockIdx.x) * kNorms + k) * p.width,
              p.width, dw[k]);
  }
}

}  // namespace

// one instance a form and yn dtype; a width not a multiple of 8 or
// above two spans has none
#define SMI_RESIDUAL_DISPATCH(KERNEL, GRID, ARGS)                          \
  if (width % kChunk != 0 || width > kSpans * kSpan) {                   \
    return static_cast<int>(cudaErrorInvalidValue);                      \
  }                                                                      \
  switch (form * 2 + (yn_bf16 ? 1 : 0)) {                                \
    case kEntry * 2 + 1:                                                 \
      KERNEL<kEntry, true><<<GRID, kThreads, 0, st>>>(ARGS); break;      \
    case kMiddle * 2:                                                    \
      KERNEL<kMiddle, false><<<GRID, kThreads, 0, st>>>(ARGS); break;    \
    case kMiddle * 2 + 1:                                                \
      KERNEL<kMiddle, true><<<GRID, kThreads, 0, st>>>(ARGS); break;     \
    case kExit * 2:                                                      \
      KERNEL<kExit, false><<<GRID, kThreads, 0, st>>>(ARGS); break;      \
    default: return static_cast<int>(cudaErrorInvalidValue);             \
  }

// form: 0 entry, 1 middle, 2 exit; yn_bf16: the entry's xn and the
// middle's yn are bf16 (the entry's always is; the exit has no yn)
extern "C" int smi_residual_norm(const float* x, const void* out,
                                 const float* w0, const float* w1, void* y0,
                                 void* y1, float* rstd, int form, int yn_bf16,
                                 int rows, int width, float eps,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Fwd p{x, out, w0, w1, y0, y1, rstd, rows, width, eps};
  const unsigned grid = static_cast<unsigned>(rows);
  SMI_RESIDUAL_DISPATCH(residual_norm_kernel, grid, p)
  return static_cast<int>(cudaGetLastError());
}

// blocks: the backward's fixed grid; partial: (blocks, norms, width) f32
// scratch; dw: (norms, width) f32, the norm weights' gradients
extern "C" int smi_residual_norm_bwd(
    const float* x, const void* out, const float* w0, const float* w1,
    const float* rstd, const float* dres, const void* dy, float* dx,
    void* dout, float* partial, float* dw, int form, int yn_bf16, int rows,
    int width, int blocks, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bwd p{x, out, w0, w1, rstd, dres, dy, dx, dout, partial, rows,
              width};
  SMI_RESIDUAL_DISPATCH(residual_norm_bwd_kernel, blocks, p)
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return sum_weight_grads(partial, blocks, (form == kMiddle ? 2 : 1) * width,
                          dw, st);
}
