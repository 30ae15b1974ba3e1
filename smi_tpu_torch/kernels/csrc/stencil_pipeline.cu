// k Jacobi sweeps of the 4-point Dirichlet stencil per memory pass over an
// extended f32 state, streamed through shared memory by the Tensor Memory
// Accelerator (TMA) on a ring of mbarrier-tracked slots.
//
// Replaces smi_tpu/kernels/stencil_pipeline.py::_pipeline_kernel (driven
// by _pipeline_pass_ext). There one TPU core walks full-width row stripes
// of the (H+2k, W+256) extended state in HBM through a 3-slot VMEM
// rotation: the DMA fetch of stripe i+1, the k sweeps of stripe i and the
// DMA write-back of stripe i-1 are in flight at once, each copy against
// its own semaphore slot; buffering=1 is the synchronous control. Its
// bf16 variant (_sweep_trapezoid_mixed) rounds the four neighbours to
// bf16 and keeps the state and the sum in f32.
//
// Bound on the H100: one pass reads each cell and writes it once (8 B per
// cell, whatever k is) and does 4 floating-point operations per cell and
// sweep. At 8192^2 and k=16 that is 537 MB (0.16 ms at 3.35 TB/s) against
// 4.3 GFLOP (0.064 ms at 67 TFLOP/s f32), so the pass is bound by bytes.
// The windows overlap by their aprons: the rows and columns fetched again
// come from L2, not device memory, and are swept again in shared memory.
// Three slots and a sweep buffer must fit 227 KB, so the windows are small:
// at k=16 the plan is a 64x96 tile in a 96x128 window, 2.0 window cells per
// output cell (the temporal kernel's 64x64 tile in 96x96: 2.25); at k=8,
// 64x160 (1.375); at k=32, 64x32 (6.0). Sweeping those windows, five
// shared-memory reads and one write per cell and sweep, costs more than
// the copies that the ring overlaps.
//
// Design: the extended state is (H+2k, W+2k): the block in the interior,
// its corner-complete halos in the border, so each window copy carries
// its own aprons (the halo refresh fused into the stream). The block is
// cut into column bands of `band` output columns and row stripes of
// `stripe` rows; a window is one band of one stripe plus a k-deep apron
// on every side, (stripe+2k) x (band+2k) floats, at most 256 on each edge
// (the TMA box). The TPU kernel walks every stripe on one core; here the
// band-major sequence of windows is split evenly over one grid of as many
// blocks as the card holds at once, and each block walks its run of
// windows (down a band, then on to the next) through a ring in dynamic
// shared memory: three slots (one with buffering=1), an mbarrier each,
// and one sweep buffer. Thread 0 is the producer: it fetches window i+1
// into slot (i+1)%3 with one cp.async.bulk.tensor.2d against that slot's
// barrier (expect_tx of the window's bytes), after cp.async.bulk.wait_group
// .read has confirmed that the store of window i-2, the slot's last user,
// has read it. All threads wait on slot i%3's barrier at parity (i/3)&1
// and sweep: sweep s computes the window minus its outer s+1 rings,
// alternating between the slot and the sweep buffer (k is even), so the
// last sweep reads the buffer and writes the centre stripe x band tile
// densely into the slot. After fence.proxy.async.shared::cta and a block
// barrier, thread 0 stores that tile with a TMA bulk-group store and goes
// on: the store of window i drains while window i+1 is swept and window
// i+2 is fetched. buffering=1 runs the same code with one slot and waits
// for each store to land before the next fetch. A barrier wait that spins
// for seconds traps (a lost transaction fails the launch; it cannot hang
// the card). Out-of-bounds box cells of a ragged last band load as zeros
// and are never stored: the store map covers only the interior.
//
// Arithmetic: 0.25f * (((up + down) + left) + right) in f32 and the
// Dirichlet mask from global coordinates (row0, col0, gh, gw) at every
// sweep; bf16 rounds each neighbour with __float2bfloat16_rn and widens
// it with __bfloat162float, keeping the centre and the sum in f32. Built
// with -fmad=false and without fast math, so f32 is bit-identical to k
// serial sweeps of the numpy reference and bf16 to its plain version.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 32;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kMaxSlots = 3;
constexpr int kSlotAlign = 128;
constexpr uint64_t kWaitNs = 10ull * 1000 * 1000 * 1000;  // 10 s

struct Plan {
  int row0, col0, gh, gw;  // the block's origin in the global grid
  int k, stripe, band;
  int stripes;           // h / stripe
  int windows;           // bands * stripes
  int slots;             // 1 or kMaxSlots
  int slot_floats;       // one window, rounded up to kSlotAlign bytes
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void barrier_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(1)
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

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

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

// `map`: the generic address of a __grid_constant__ CUtensorMap parameter
__device__ __forceinline__ void tma_load(float* dst, uint64_t map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(smem_addr(bar)), "r"(col),
      "r"(row)
      : "memory");
}

__device__ __forceinline__ void tma_store(uint64_t map, const float* src,
                                          int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(map),
      "r"(smem_addr(src)), "r"(col), "r"(row)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <bool kBf16>
__device__ __forceinline__ float neighbour(float v) {
  if constexpr (kBf16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// k sweeps of one (rows x cols) window whose cell (0, 0) is global
// (g_r0, g_c0): between `a` (the slot, holding the window) and `b` (the
// sweep buffer); the last sweep writes the centre densely into `a`.
template <bool kBf16>
__device__ void sweep_window(float* a, float* b, const Plan& p, int g_r0,
                             int g_c0) {
  const int rows = p.stripe + 2 * p.k;
  const int cols = p.band + 2 * p.k;
  float* src = a;
  float* dst = b;
  for (int s = 0; s < p.k; ++s) {
    const bool last = s == p.k - 1;
    const int lo = s + 1;
    const int row_hi = rows - s - 1;
    const int col_hi = cols - s - 1;
    for (int r = lo + threadIdx.y; r < row_hi; r += kBlockY) {
      const int gr = g_r0 + r;
      const bool row_edge = gr == 0 || gr == p.gh - 1;
      const float* in = src + r * cols;
      // the last sweep's cells are exactly the centre tile, packed
      float* out = last ? a + (r - p.k) * p.band : dst + r * cols;
      const int shift = last ? p.k : 0;
      for (int c = lo + threadIdx.x; c < col_hi; c += kBlockX) {
        const int gc = g_c0 + c;
        const float center = in[c];
        if (row_edge || gc == 0 || gc == p.gw - 1) {
          out[c - shift] = center;
        } else {
          out[c - shift] = 0.25f * (((neighbour<kBf16>(in[c - cols]) +
                              neighbour<kBf16>(in[c + cols])) +
                             neighbour<kBf16>(in[c - 1])) +
                            neighbour<kBf16>(in[c + 1]));
        }
      }
    }
    if (!last) __syncthreads();
    float* t = src;
    src = dst;
    dst = t;
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
    pipeline_kernel(const __grid_constant__ CUtensorMap load_map,
                    const __grid_constant__ CUtensorMap store_map,
                    const Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad = (kSlotAlign - (smem_addr(smem_raw) % kSlotAlign)) %
                       kSlotAlign;
  float* slots = reinterpret_cast<float*>(smem_raw + pad);
  float* sweep_buf = slots + p.slots * p.slot_floats;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sweep_buf + p.slot_floats);
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  const uint64_t load_desc = reinterpret_cast<uint64_t>(&load_map);
  const uint64_t store_desc = reinterpret_cast<uint64_t>(&store_map);
  const uint32_t window_bytes =
      4u * (p.stripe + 2 * p.k) * (p.band + 2 * p.k);

  // this block's run of windows [first, first + n) of the band-major order
  const int first = static_cast<int>(
      static_cast<long long>(blockIdx.x) * p.windows / gridDim.x);
  const int n = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * p.windows / gridDim.x) - first;

  // window i's top-left cell in the extended state; the centre tile's in
  // the block (its interior) has the same coordinates
  auto origin = [&](int i, int& col, int& row) {
    const int j = first + i;
    col = (j / p.stripes) * p.band;
    row = (j % p.stripes) * p.stripe;
  };
  auto fetch = [&](int i) {
    int col, row;
    origin(i, col, row);
    const int s = i % p.slots;
    barrier_expect(&bars[s], window_bytes);
    tma_load(slots + s * p.slot_floats, load_desc, &bars[s], col, row);
  };

  if (tid == 0) {
    for (int s = 0; s < p.slots; ++s) barrier_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    fetch(0);
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    const int s = i % p.slots;
    if (p.slots > 1 && tid == 0 && i + 1 < n) {
      // slot (i+1)%3 last held window i-2: its store must have read it
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      fetch(i + 1);
    }
    barrier_wait(&bars[s], (i / p.slots) & 1);
    int col, row;
    origin(i, col, row);
    float* slot = slots + s * p.slot_floats;
    sweep_window<kBf16>(slot, sweep_buf, p, p.row0 + row - p.k,
                        p.col0 + col - p.k);
    // the threads' shared-memory writes, before the async proxy reads them
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      tma_store(store_desc, slot, col, row);
      if (p.slots == 1) {
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
        if (i + 1 < n) fetch(i + 1);
      }
    }
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

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

// A row-major (rows x cols) f32 map with rows `row_bytes` apart, cut into
// (box_rows x box_cols) boxes; 0, or minus the CUresult of a failure.
int encode(CUtensorMap* map, const float* base, int cols, int rows,
           int row_bytes, int box_cols, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -static_cast<int>(r);
}

}  // namespace

// ext and out are (h + 2*depth, w + 2*depth) f32; the kernel reads ext and
// writes out's interior. Returns cudaGetLastError() after the launch,
// cudaErrorInvalidValue for a plan it cannot run, or minus the CUresult of
// a tensor map it could not encode.
extern "C" int smi_stencil_pipeline(const float* ext, float* out, int h,
                                    int w, int row0, int col0, int gh,
                                    int gw, int depth, int stripe, int band,
                                    int bf16, int buffering, void* stream) {
  const int k = depth;
  const int rows = stripe + 2 * k;
  const int cols = band + 2 * k;
  if (k < 2 || k % 2 || stripe < k || h % stripe || band < 1 ||
      rows > 256 || cols > 256 || (cols * 4) % 16 || ((w + 2 * k) * 4) % 16 ||
      (buffering != 1 && buffering != kMaxSlots)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ext_w = w + 2 * k;
  CUtensorMap load_map, store_map;
  int status = encode(&load_map, ext, ext_w, h + 2 * k, ext_w * 4, cols,
                      rows);
  if (status != 0) return status;
  status = encode(&store_map, out + static_cast<size_t>(k) * ext_w + k, w, h,
                  ext_w * 4, band, stripe);
  if (status != 0) return status;

  Plan p;
  p.row0 = row0;
  p.col0 = col0;
  p.gh = gh;
  p.gw = gw;
  p.k = k;
  p.stripe = stripe;
  p.band = band;
  p.stripes = h / stripe;
  p.windows = (w + band - 1) / band * p.stripes;
  p.slots = buffering;
  const int slot_bytes =
      (4 * rows * cols + kSlotAlign - 1) / kSlotAlign * kSlotAlign;
  p.slot_floats = slot_bytes / 4;
  const size_t smem = static_cast<size_t>(buffering + 1) * slot_bytes +
                      kSlotAlign + 8 * kMaxSlots;

  auto kernel = bf16 ? pipeline_kernel<true> : pipeline_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = std::min(p.windows, sms * std::max(per_sm, 1));
  kernel<<<grid, dim3(kBlockX, kBlockY), smem,
           static_cast<cudaStream_t>(stream)>>>(load_map, store_map, p);
  return static_cast<int>(cudaGetLastError());
}
