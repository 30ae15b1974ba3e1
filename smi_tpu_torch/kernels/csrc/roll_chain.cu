// A chain of `length` dependent whole-array steps on each of `chains`
// independent f32 arrays, every step in registers: a rotation by one
// along the lanes (dim 1) or the sublanes (dim 0), or an add of 1.0 (the
// harness floor).
//
// Replaces: smi_tpu/benchmarks/surface.py::roll_chain_points, its inner
// `kernel` (surface.py:562). There the whole array sits in VMEM for all R
// steps and each step is one `pltpu.roll` on each vreg (a cross-lane
// rotate on the XLU and a select at the vreg's edge), or one `v + 1.0`,
// so the R-difference of two chain lengths prices the rotation alone.
// The Hopper counterpart of that access is the one the port's stencil
// kernels make for a horizontal neighbour (stencil_wavefront.cuh): a warp
// shuffle and a select, in registers.
//
// Bound on the H100: device memory sees each array once each way (4 MiB
// in and out at 512x2048, 0.0025 ms at 3.35 TB/s); the add chain does
// 4.3 G adds at 512x2048, R=4096 (0.0641 ms at 67 TFLOP/s, a rate that
// counts an FMA as two operations; adds alone run at half of it, 0.128
// ms). The probe's own ceiling is the warp shuffle: every element moves
// by one shuffle a step, and an SM returns 32 shuffle results a clock
// (CUDA C Programming Guide, throughput table, compute capability 9.0),
// so 512x2048 at R=4096 needs 4.295e9 / (32 x 132 x 1.98e9) s = 0.5135 ms.
//
// Design: one warp owns one whole line of one chain (a row for `lane`
// and `add`, a column for `sublane`), so a step needs nothing from
// another warp: no shared memory and no barrier. Lane l holds element
// 32 k + l of the line in register k, k < K (the lanes of a TPU vreg
// along a row); K is a template parameter, the least power of two that
// holds the line, at most kMaxRegs. A rotation step is, for every
// register, t_k = shfl(r_k, lane - 1) and then
// r_k = lane == 0 ? t_{k-1} : t_k: lane 0 takes lane 31 of the register
// below, and lane 0 of register 0 takes the last element (t_{K-1} when
// the line fills its K registers; else one more shuffle, of the register
// that holds element n - 1, chosen by selects over the upper half). A
// line of up to 64 registers issues all its shuffles before its selects;
// a longer one walks down, each r_k overwritten after its shuffle. The
// `add` step adds 1.0 to every register in the same loop. The step loop
// is not unrolled, and each step issues one data-moving instruction an
// element (a SHFL, or an FADD), so no step folds into another. `lane`
// and `sublane` are the same kernel on other strides: a sublane line is
// a column, read and written once with a stride of a row; the
// R-difference cancels that. Padding registers of a short line rotate
// along unused.
//
// Each chain's lines go to warps of their own rather than one warp
// holding a line of every chain: the card has 528 warp schedulers and a
// lone warp issues a shuffle only every 5-6 clocks. 256 warps of 128
// registers (the shuffles of a warp holding a row of both chains at
// 256x2048 x2) took 1.5523 ms at R=4096 against 0.7428 for 512 warps of
// 64 (lane; probes/roll_chain_layouts.py, NVIDIA H100 80GB HBM3, 700 W).
// Blocks are 4 warps; 1, 2 or 4 gave the same times.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChains = 4;
constexpr int kMaxRegs = 128;   // K at most: the data registers a thread
constexpr int kMaxWarps = 4;    // warps a block
// lines of at most this many registers shuffle every register of a step
// before its selects (lane at 512x2048, R=4096: 0.7408 against 0.8245 ms
// for the walk, NVIDIA H100 80GB HBM3, 700 W); a longer line walks down,
// a shuffle and a select at a time: two copies of it would not fit a
// thread's 255 registers
constexpr int kShufflesFirst = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLane = 0;
constexpr int kSublane = 1;
constexpr int kAdd = 2;

struct Chains {
  const float* in[kMaxChains];
  float* out[kMaxChains];
};

// One rotation step of a line: every element to the next slot, lane 0
// of register 0 taking `wrap` (on a whole line, t_{K-1} in its place).
template <int K, bool WHOLE>
__device__ __forceinline__ void rotate(float (&r)[K], int src, bool first,
                                       float wrap) {
  if constexpr (K <= kShufflesFirst) {
    float t[K];
#pragma unroll
    for (int k = 0; k < K; ++k) t[k] = __shfl_sync(kFull, r[k], src);
#pragma unroll
    for (int k = K - 1; k > 0; --k) r[k] = first ? t[k - 1] : t[k];
    r[0] = first ? (WHOLE ? t[K - 1] : wrap) : t[0];
  } else {
    // from the top down, each register overwritten after its shuffle
    const float top = __shfl_sync(kFull, r[K - 1], src);
    float above = top;
#pragma unroll
    for (int k = K - 1; k > 0; --k) {
      const float below = __shfl_sync(kFull, r[k - 1], src);
      r[k] = first ? below : above;
      above = below;
    }
    r[0] = first ? (WHOLE ? top : wrap) : above;
  }
}

// A warp a line of a chain: warp w takes line w % lines of chain
// w / lines, and element e of line i lies at
// i * line_stride + e * elem_stride, e < n <= 32 K.
template <bool ROTATE, int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
    roll_chain_kernel(Chains ch, int chains, int lines, int n, int length,
                      int line_stride, int elem_stride) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp >= chains * lines) return;  // the whole warp
  const int chain = warp / lines;
  const float* in = ch.in[0];
  float* out = ch.out[0];
#pragma unroll
  for (int c = 1; c < kMaxChains; ++c) {
    if (c == chain) {
      in = ch.in[c];
      out = ch.out[c];
    }
  }
  const size_t base =
      static_cast<size_t>(warp - chain * lines) * line_stride;

  float r[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = 32 * k + lane;
    r[k] = e < n ? in[base + static_cast<size_t>(e) * elem_stride] : 0.0f;
  }

  if constexpr (ROTATE) {
    const int src = (lane + 31) & 31;
    const bool first = lane == 0;
    if (n == 32 * K) {
      // ---- whole registers: the wrap is t_{K-1} at lane 0 -------------
#pragma unroll 1
      for (int step = 0; step < length; ++step)
        rotate<K, true>(r, src, first, 0.0f);
    } else {
      // ---- a short line: element n - 1 is lane q of register last, in
      // the upper half (K is the least power of two that holds n) ----
      const int last = (n - 1) >> 5;
      const int q = (n - 1) & 31;
#pragma unroll 1
      for (int step = 0; step < length; ++step) {
        float tail = r[K / 2];
#pragma unroll
        for (int k = K / 2 + 1; k < K; ++k) tail = k == last ? r[k] : tail;
        rotate<K, false>(r, src, first, __shfl_sync(kFull, tail, q));
      }
    }
  } else {
#pragma unroll 1
    for (int step = 0; step < length; ++step) {
#pragma unroll
      for (int k = 0; k < K; ++k) r[k] = r[k] + 1.0f;
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int e = 32 * k + lane;
    if (e < n) out[base + static_cast<size_t>(e) * elem_stride] = r[k];
  }
}

struct Launch {
  Chains ch;
  int chains, lines, n, length, line_stride, elem_stride, warps;
  cudaStream_t stream;
};

template <bool ROTATE, int K>
int launch(const Launch& a) {
  const int blocks = (a.chains * a.lines + a.warps - 1) / a.warps;
  roll_chain_kernel<ROTATE, K><<<blocks, a.warps * 32, 0, a.stream>>>(
      a.ch, a.chains, a.lines, a.n, a.length, a.line_stride,
      a.elem_stride);
  return static_cast<int>(cudaGetLastError());
}

// The instance of K == regs, for K = 1, 2, 4, ... kMaxRegs.
template <bool ROTATE, int K>
int by_regs(int regs, const Launch& a) {
  if constexpr (K > kMaxRegs) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (regs == K) return launch<ROTATE, K>(a);
    return by_regs<ROTATE, 2 * K>(regs, a);
  }
}

}  // namespace

// ins/outs: host arrays of `chains` device pointers, each a contiguous
// (rows, cols) f32 array; body 0 lane, 1 sublane, 2 add. The plan is the
// wrapper's (roll.py::plan): `regs` registers a line (the least power
// of two whose 32 regs hold the rolled axis, at most kMaxRegs) and
// `warps` warps a block, one warp a line of a chain.
extern "C" int smi_roll_chain(const void* const* ins, void* const* outs,
                              int chains, int rows, int cols, int length,
                              int body, int regs, int warps, void* stream) {
  if (chains < 1 || chains > kMaxChains || rows < 1 || cols < 1 ||
      length < 0 || body < kLane || body > kAdd || warps < 1 ||
      warps > kMaxWarps || regs < 1 || (regs & (regs - 1)) != 0 ||
      regs > kMaxRegs)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool sublane = body == kSublane;
  Launch a{};
  for (int c = 0; c < chains; ++c) {
    a.ch.in[c] = static_cast<const float*>(ins[c]);
    a.ch.out[c] = static_cast<float*>(outs[c]);
  }
  a.chains = chains;
  a.n = sublane ? rows : cols;
  a.lines = sublane ? cols : rows;
  a.line_stride = sublane ? 1 : cols;
  a.elem_stride = sublane ? cols : 1;
  a.length = length;
  a.warps = warps;
  a.stream = static_cast<cudaStream_t>(stream);
  if (a.n > 32 * regs || (regs > 1 && a.n <= 16 * regs))
    return static_cast<int>(cudaErrorInvalidValue);
  return body == kAdd ? by_regs<false, 1>(regs, a)
                      : by_regs<true, 1>(regs, a);
}
