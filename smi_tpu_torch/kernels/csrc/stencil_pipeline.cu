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
// cell, whatever k is): at 8192^2 and k=16, 537 MB, 0.1609 ms at 3.35
// TB/s. Its 4.3 G cell-sweeps are 4 f32 instructions each at -fmad=false:
// 0.128 ms at 33.5 T instructions/s. The first form swept each
// window k times in shared memory, five reads and one write a cell and
// sweep, over windows 2.0x the output at k=16 (6.0x at k=32) that three
// slots and a sweep buffer left room for: 20x the bound, 96-97 % of it
// in the sweeps.
//
// Design: the extended state is (H+2k, W+2k): the block in the interior,
// its corner-complete halos in the border, so each copy carries its own
// aprons (the halo refresh fused into the stream). A CUDA block owns a
// column band of `band` output columns and a run of whole stripes of
// `stripe` rows; its window is the band plus k columns each side and it
// runs the row wavefront of stencil_wavefront.cuh down its rows plus k
// above and below (at k = 8, 16 and 32 every level in registers, other
// depths the generic loop). It keeps the one-group form, each thread
// carrying every level: a bf16 hold reads the input value that the thread
// which read the input kept (Keep), and a level split would put the
// reader and the holds of later levels in different threads. Thread 0 is the producer: each slot of the
// ring (three, or one with buffering=1) takes a chunk of `stripe` rows of
// the window, one cp.async.bulk.tensor.2d a 256-column box against that
// slot's mbarrier (expect_tx of the chunk's bytes), issued when the step
// barrier shows that every thread has left the chunk the slot last held;
// the threads wait on a chunk's barrier at its first row, at parity
// (chunk / slots) & 1, and read their own columns of each row from the
// slot. Level k goes to one of two staging buffers of `stripe` rows;
// once a buffer is full, each thread fences its writes for the async
// proxy (fence.proxy.async.shared::cta) and, after the next step barrier,
// thread 0 stores it with TMA bulk-group stores (boxes of at most 256
// columns) and goes on, waiting (cp.async.bulk.wait_group.read) only
// before a buffer is written again. buffering=1 runs the same code with
// one slot and waits for each store to land. The C entry cuts each band's
// stripes into runs of at most 128 rows, more where that fills the card
// better (shorter runs beat one wave of long ones on the card). A
// barrier wait that spins for seconds traps (a lost transaction fails the
// launch; it cannot hang the card). Out-of-bounds box cells (the ragged
// last band, rows past the state) load as zeros and are never stored: the
// store map covers only the interior.
//
// Arithmetic: 0.25f * (((up + down) + left) + right) in f32 and the
// Dirichlet mask from global coordinates (row0, col0, gh, gw) at every
// sweep. bf16 rounds each value once, when it is produced, with
// __float2bfloat16_rn and widens it with __bfloat162float; every read of
// it as a neighbour takes that form, the centre of a held cell and the
// output keep f32. That is the plain version's rounding of every
// neighbour read. Built with -fmad=false and without fast math, so f32 is
// bit-identical to k serial sweeps of the numpy reference and bf16 to its
// plain version.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <algorithm>
#include <cstdint>

#include "stencil_wavefront.cuh"

namespace {

using wavefront::Keep;
using wavefront::smem_addr;
using wavefront::columns;
using wavefront::Window;

constexpr int kMaxThreads = 256;
constexpr int kMaxSlots = 3;
constexpr int kAlign = 128;
constexpr int kBox = 256;  // the longest edge of a TMA box
constexpr int kRunRows = 128;  // output rows a block streams at most
constexpr uint64_t kWaitNs = 10ull * 1000 * 1000 * 1000;  // 10 s

struct Plan {
  int h, w, row0, col0, gh, gw;  // the block and its place in the grid
  int k, stripe, band;
  int width;            // window columns: threads x C
  int box_w, boxes;     // the load's boxes: width = boxes x box_w
  int out_w, out_boxes; // the store's boxes: band = out_boxes x out_w
  int bands, stripes, runs;  // blocks = bands x runs; a run of stripes
  int slots;            // 1 or kMaxSlots
  // float offsets into the aligned dynamic shared memory
  int slot_at, stage_at, scratch_at, keep_at;
  int bar_at;           // byte offset of the mbarriers
};

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
}

// Chunks of the window through the slot ring, level k through the staging
// buffers. Window cell (i, j) is extended-state cell (s0 + i, b0 + j); the
// output row o is block row s0 + o. Steps come in order, so the chunk,
// slot and staging positions are counters, not divisions.
template <int C>
struct PipelineIO {
  const Plan& p;
  uint64_t load_map, store_map;
  float* slots;     // [slots][boxes][stripe][box_w]
  float* staging;   // [2][out_boxes][stripe][out_w]
  uint64_t* bars;   // [slots]
  int b0, s0, rows, chunks, j0, tid;
  // the thread's columns: in a slot row, and in a staging row (-1: none
  // of them lies in the band)
  int in_col, out_col;
  int chunk, row, slot;     // input: window row = chunk * stripe + row
  int out_chunk, out_row;   // output: row o = out_chunk * stripe + out_row
  int stored;               // staging chunks stored (thread 0)

  __device__ __forceinline__ void fetch_chunk(int c) {
    const int s = c % p.slots;
    barrier_expect(&bars[s], 4u * p.width * p.stripe);
    for (int b = 0; b < p.boxes; ++b) {
      tma_load(slots + (s * p.boxes + b) * p.stripe * p.box_w, load_map,
               &bars[s], b0 + b * p.box_w, s0 + c * p.stripe);
    }
  }

  // Store the staging chunks whose rows are all written (thread 0).
  __device__ __forceinline__ void store_ready() {
    for (; stored < out_chunk; ++stored) {
      const float* src =
          staging + (stored & 1) * p.out_boxes * p.stripe * p.out_w;
      for (int b = 0; b < p.out_boxes; ++b) {
        tma_store(store_map, src + b * p.stripe * p.out_w,
                  b0 + b * p.out_w, s0 + stored * p.stripe);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (p.slots == 1) {
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
      }
    }
  }

  __device__ __forceinline__ void begin() {
    in_col = j0 / p.box_w * p.stripe * p.box_w + j0 % p.box_w;
    const int jj = j0 - p.k;  // the thread's first band column
    // C columns in one store box: k and out_w are multiples of C
    out_col = jj >= 0 && jj < p.band
                  ? jj / p.out_w * p.stripe * p.out_w + jj % p.out_w
                  : -1;
    chunk = row = slot = 0;
    out_chunk = out_row = 0;
    stored = 0;
    if (tid == 0) {
      for (int s = 0; s < p.slots; ++s) barrier_init(&bars[s]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      for (int c = 0; c < min(p.slots, chunks); ++c) fetch_chunk(c);
    }
  }

  __device__ __forceinline__ void step(int) {
    const bool first = row == 0;
    if (tid == 0) {
      store_ready();
      // the next step starts a staging buffer: its last store has read it
      if (out_row == p.stripe - 1 && out_chunk >= 1) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
      // every thread has left chunk-1: its slot takes chunk-1+slots
      if (first && chunk > 0 && chunk - 1 + p.slots < chunks) {
        fetch_chunk(chunk - 1 + p.slots);
      }
    }
    if (first && chunk < chunks) {
      barrier_wait(&bars[slot], (chunk / p.slots) & 1);
    }
  }

  __device__ __forceinline__ void fetch(int, float (&v)[C]) {
    wavefront::load_row<C>(slots + slot * p.boxes * p.stripe * p.box_w +
                               row * p.box_w + in_col,
                           v);
    if (++row == p.stripe) {
      row = 0;
      ++chunk;
      slot = slot + 1 == p.slots ? 0 : slot + 1;
    }
  }

  __device__ __forceinline__ void store(int o, int, const float (&v)[C]) {
    if (o < 0 || o >= rows) return;
    if (out_col >= 0) {
      float* dst = staging + (out_chunk & 1) * p.out_boxes * p.stripe *
                                 p.out_w +
                   out_row * p.out_w + out_col;
#pragma unroll
      for (int c = 0; c < C; ++c) dst[c] = v[c];
    }
    if (++out_row == p.stripe) {
      // the threads' shared-memory writes, before the async proxy reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      out_row = 0;
      ++out_chunk;
    }
  }

  __device__ __forceinline__ void end(int) {
    __syncthreads();
    if (tid == 0) {
      store_ready();
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  }
};

// K = 8, 16, 32 with C = columns(K) columns a thread (levels in
// registers), or K = 0: any depth, one column a thread (levels in shared
// memory).
template <int K, bool kBf16>
__global__ void __launch_bounds__(kMaxThreads, 1)
    pipeline_kernel(const __grid_constant__ CUtensorMap load_map,
                    const __grid_constant__ CUtensorMap store_map,
                    const __grid_constant__ Plan p) {
  constexpr int C = columns(K);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t pad =
      (kAlign - (smem_addr(smem_raw) % kAlign)) % kAlign;
  float* base = reinterpret_cast<float*>(smem_raw + pad);
  // this block's band, and its run of stripes [first, last)
  const int band_i = blockIdx.x % p.bands;
  const int run = blockIdx.x / p.bands;
  const int first = static_cast<int>(static_cast<long long>(run) *
                                     p.stripes / p.runs);
  const int last = static_cast<int>(static_cast<long long>(run + 1) *
                                    p.stripes / p.runs);
  const int b0 = band_i * p.band;
  const int s0 = first * p.stripe;
  const int rows = (last - first) * p.stripe;
  const Window win{p.k, rows, p.row0 + s0 - p.k, p.col0 + b0 - p.k, p.gh,
                   p.gw};
  PipelineIO<C> io{p,
                   reinterpret_cast<uint64_t>(&load_map),
                   reinterpret_cast<uint64_t>(&store_map),
                   base + p.slot_at,
                   base + p.stage_at,
                   reinterpret_cast<uint64_t*>(
                       reinterpret_cast<unsigned char*>(base) + p.bar_at),
                   b0,
                   s0,
                   rows,
                   (rows + 2 * p.k + p.stripe - 1) / p.stripe,
                   static_cast<int>(threadIdx.x) * C,
                   static_cast<int>(threadIdx.x)};
  float* scratch = base + p.scratch_at;
  const Keep keep{base + p.keep_at, base + p.keep_at + 2 * p.width, p.width};
  if constexpr (K == 0) {
    wavefront::run_shared<kBf16>(io, win, scratch, keep);
  } else {
    wavefront::run_registers<K, C, 1, kBf16>(io, win, scratch, keep);
  }
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

int align_floats(int floats) {
  return (floats * 4 + kAlign - 1) / kAlign * kAlign / 4;
}

// Lay out the block's shared memory (slots, staging, mbarriers, the
// levels' scratch, the bf16 keep) in `p`; its size in bytes.
template <int K>
size_t layout(Plan& p, int threads) {
  p.slot_at = 0;
  p.stage_at = align_floats(p.slots * p.stripe * p.width);
  const int bars_at = p.stage_at + align_floats(2 * p.stripe * p.band);
  p.bar_at = 4 * bars_at;
  p.scratch_at = bars_at + align_floats(2 * kMaxSlots);
  p.keep_at = p.scratch_at +
              align_floats(K == 0 ? wavefront::level_floats(p.k, p.width)
                                  : wavefront::edge_floats(K, threads / 32));
  return 4 * static_cast<size_t>(
                 p.keep_at +
                 align_floats(2 * p.width + 2 * wavefront::kKeepRing)) +
         kAlign;
}

// Set the kernel's shared memory, then launch it, or only report the
// blocks an SM holds at once (`blocks_per_sm` not null).
template <int K, bool kBf16>
int launch(const CUtensorMap& load_map, const CUtensorMap& store_map,
           Plan p, int threads, cudaStream_t stream,
           int* blocks_per_sm = nullptr) {
  const size_t smem = layout<K>(p, threads);
  auto kernel = pipeline_kernel<K, kBf16>;
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
                                                        threads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_per_sm != nullptr) {
    *blocks_per_sm = per_sm;
    return 0;
  }
  // each band's stripes in runs of at most kRunRows rows, and as many
  // runs as fill the card once where that is more (shorter runs beat
  // one wave of long ones on the card, apron and all)
  const int fill = (sms * std::max(per_sm, 1) + p.bands - 1) / p.bands;
  p.runs = std::min(p.stripes,
                    std::max((p.h + kRunRows - 1) / kRunRows, fill));
  kernel<<<p.bands * p.runs, threads, smem, stream>>>(load_map, store_map,
                                                       p);
  return static_cast<int>(cudaGetLastError());
}

// The plan of a launch, or cudaErrorInvalidValue in `status` for one the
// kernel cannot run.
Plan make_plan(int h, int w, int row0, int col0, int gh, int gw, int k,
               int stripe, int band, int buffering, int& threads,
               int& status) {
  const int cols = columns(k == 8 || k == 16 || k == 32 ? k : 0);
  threads = band < 1 ? 0 : (band + 2 * k + 32 * cols - 1) / (32 * cols) * 32;
  const int out_boxes = (band + kBox - 1) / kBox;
  Plan p{};
  // TMA: 16-byte rows and a 16-byte-aligned interior; each staging box
  // 128-byte aligned; a thread's columns in one store box
  if (h < 1 || w < 1 || k < 1 || stripe < 1 || stripe > kBox ||
      h % stripe || band < 1 || threads > kMaxThreads || band % out_boxes ||
      (band / out_boxes) % 4 || (stripe * (band / out_boxes)) % 32 ||
      ((w + 2 * k) * 4) % 16 || (k * 4) % 16 || k % cols ||
      (buffering != 1 && buffering != kMaxSlots)) {
    status = static_cast<int>(cudaErrorInvalidValue);
    return p;
  }
  status = 0;
  p.h = h;
  p.w = w;
  p.row0 = row0;
  p.col0 = col0;
  p.gh = gh;
  p.gw = gw;
  p.k = k;
  p.stripe = stripe;
  p.band = band;
  p.width = threads * cols;
  p.box_w = std::min(p.width, kBox);
  while (p.width % p.box_w) p.box_w /= 2;
  p.boxes = p.width / p.box_w;
  p.out_boxes = out_boxes;
  p.out_w = band / out_boxes;
  p.bands = (w + band - 1) / band;
  p.stripes = h / stripe;
  p.slots = buffering;
  return p;
}

int dispatch(const CUtensorMap& load_map, const CUtensorMap& store_map,
             const Plan& p, int threads, bool bf16, void* stream,
             int* blocks_per_sm) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.k) {
    case 8:
      return bf16 ? launch<8, true>(load_map, store_map, p, threads, s,
                                    blocks_per_sm)
                  : launch<8, false>(load_map, store_map, p, threads, s,
                                     blocks_per_sm);
    case 16:
      return bf16 ? launch<16, true>(load_map, store_map, p, threads, s,
                                     blocks_per_sm)
                  : launch<16, false>(load_map, store_map, p, threads, s,
                                      blocks_per_sm);
    case 32:
      return bf16 ? launch<32, true>(load_map, store_map, p, threads, s,
                                     blocks_per_sm)
                  : launch<32, false>(load_map, store_map, p, threads, s,
                                      blocks_per_sm);
    default:
      return bf16 ? launch<0, true>(load_map, store_map, p, threads, s,
                                    blocks_per_sm)
                  : launch<0, false>(load_map, store_map, p, threads, s,
                                     blocks_per_sm);
  }
}

}  // namespace

// ext and out are (h + 2*depth, w + 2*depth) f32; the kernel reads ext and
// writes out's interior. `stripe` is the rows of a slot's chunk and of a
// store, `band` the output columns of a block; the block has ceil((band +
// 2k) / C) threads, rounded up to a warp, C = columns(depth) (4, 4, 2 at
// depth 8, 16, 32; 1 at any other). Returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for a plan it cannot run, or minus the
// CUresult of a tensor map it could not encode.
extern "C" int smi_stencil_pipeline(const float* ext, float* out, int h,
                                    int w, int row0, int col0, int gh,
                                    int gw, int depth, int stripe, int band,
                                    int bf16, int buffering, void* stream) {
  const int k = depth;
  int threads = 0, status = 0;
  const Plan p = make_plan(h, w, row0, col0, gh, gw, k, stripe, band,
                           buffering, threads, status);
  if (status != 0) return status;
  const int ext_w = w + 2 * k;
  CUtensorMap load_map, store_map;
  status = encode(&load_map, ext, ext_w, h + 2 * k, ext_w * 4, p.box_w,
                  stripe);
  if (status != 0) return status;
  status = encode(&store_map, out + static_cast<size_t>(k) * ext_w + k, w, h,
                  ext_w * 4, p.out_w, stripe);
  if (status != 0) return status;
  return dispatch(load_map, store_map, p, threads, bf16 != 0, stream,
                  nullptr);
}

// The blocks of a plan an SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a CUDA error.
extern "C" int smi_stencil_pipeline_blocks_per_sm(int depth, int stripe,
                                                  int band, int bf16,
                                                  int buffering) {
  int threads = 0, status = 0;
  // a shape every rule takes: the band's own width, one stripe
  const int w = (band + 127) / 128 * 128;
  const Plan p = make_plan(stripe, w, 0, 0, stripe, w, depth, stripe, band,
                           buffering, threads, status);
  if (status != 0) return -status;
  CUtensorMap unused{};
  int blocks = 0;
  status = dispatch(unused, unused, p, threads, bf16 != 0, nullptr, &blocks);
  return status != 0 ? -status : blocks;
}
