// The ring tier: neighbour streaming, all-gather, all-reduce and
// reduce-scatter as kernels in which the ranks of a ring write into each
// other's buffers and pace each other with flags in device memory.
//
// Replaces, in smi_tpu/kernels/ring.py:
//   smi_ring_neighbour_stream  <- _neighbour_stream_kernel     (:838)
//   smi_ring_all_gather        <- _ring_all_gather_kernel      (:388)
//   smi_ring_all_reduce        <- _ring_all_reduce_kernel      (:495)
//   smi_ring_all_reduce_chunked <- _ring_all_reduce_chunked_kernel (:542)
//   smi_ring_reduce_scatter    <- _ring_reduce_scatter_kernel  (:718)
// There each rank is a chip: a remote DMA writes one of two slots of the
// neighbour's scratch buffer, a receive semaphore counts its arrival, and
// a credit semaphore, signalled by the reader, tells the writer that a
// slot may be written again. The protocol is specified step by step in
// smi_tpu/parallel/credits.py (neighbour_stream_rank, all_gather_rank,
// all_reduce_rank, reduce_scatter_rank); the kernels here keep every
// signal and every wait of it.
//
// Design. One launch plays every rank that lives in this process: the
// grid is (blocks_per_rank, ranks), rank = blockIdx.y, and a
// table in device memory gives each rank its input, its output, its two
// comm slots, its flag words, its position in its ring and where in the
// table its left and right neighbours are (a launch may hold several
// rings, one per line of a grid axis; a rank only ever sees its own
// line). The payload is cut
// into blocks_per_rank contiguous slices (multiples of 16 bytes); block b
// of rank r runs the whole protocol on slice b and talks only to block b
// of ranks r-1 and r+1, with its own flag words, so no grid-wide
// synchronisation exists. Blocks of different ranks wait for each other,
// so the whole grid must be resident at once: every entry point refuses
// a grid larger than cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs
// and launches with cudaLaunchCooperativeKernel, which refuses it too.
//
// A "DMA" is the block copying its slice into the neighbour's slot, 16
// bytes a thread where source and destination are 16-byte aligned, by
// words or bytes otherwise, so any shape and any element type moves. Then
// all threads meet (__syncthreads), and thread 0 adds one to the
// neighbour's receive flag with a release at system scope. The reader's
// thread 0 spins on an acquire load at system scope until the flag has
// reached the count this step expects, the block meets, and all threads
// read the slot. Flags are counters that only grow; the host zeroes them
// before a launch, when no kernel is in flight. A spin that lasts ten
// seconds traps: a lost signal fails the launch, it cannot hang the card.
// Credits work the same way (the reader grants a slot to its writer after
// it has copied the slot out, or sent it onward), and each block counts
// the credits it granted and the credits it consumed into its flag words
// for the host to check that every credit domain drained. With
// flow_control == 0 there is no entry barrier and there are no credits;
// the receive flags stay, they are the completion of the copy.
//
// Bound on the H100 (3.35 TB/s): bytes, each input read once and each
// output written once. With P the bytes of the unit that circulates and n
// ranks, over all ranks: all-reduce 2nP (n inputs of P, n outputs of P;
// 67 MB at 4 MiB a rank and n = 8, 0.020 ms); reduce-scatter n(n+1)P
// (inputs of nP, outputs of P); all-gather n(1+n)P; the stream 2nP for P
// the whole message. The arithmetic (one operation per element and step)
// is far below the card's rate. The chunked all-reduce has the all-reduce's
// bound and schedule traffic; it makes `chunks` times the handshakes a step.
//
// What the ring schedule moves on top of that bound ("schedule traffic",
// logged beside the time, not a bound: all ranks' data lies on one card,
// so one pass over it would do). A rank of the all-reduce writes its
// input into the neighbour's slot (2P); on each of the n-2 later steps it
// reads the arrival and its input and writes their fold straight into the
// neighbour's slot (3P); the last arrival is folded with the input into
// the output (3P): (3n-1) P a rank, 23P at n = 8. The reduce-scatter
// moves the same with P one block of the input. The all-gather copies in
// (4P: output and slot 0) and per step forwards (2P) and copies out (2P):
// 4nP. The stream moves each chunk into the neighbour's slot (2P) and out
// of its own (2P): 4P a rank. The comm slots of eight ranks at 4 MiB (64
// MiB) do not fit the 50 MB L2, so this traffic reaches device memory.
//
// Arithmetic: combine(arrival, own), in the element type: +, max, min;
// bf16 adds in f32 and rounds to nearest even; 8- and 16-bit integers
// wrap. After step s rank r holds ((x[r-s-1] o x[r-s]) o ...) o x[r]: a
// left fold that ends at the rank's own input, a different association on
// every rank, exactly the TPU kernel's. A slot holds the arrival as it
// was sent; the rank's own input is folded in as the partial goes onward
// (or into the output), the same values in the same order as folding on
// arrival. All-reduce, chunked all-reduce and reduce-scatter are instances
// of one template, reduce_kernel<T, OP, REDUCE_SCATTER>: three entry
// functions over one body and one dispatch table. Built with
// -fmad=false; there is nothing to contract, and the plain version
// replays the same fold.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr uint64_t kWaitNs = 10ull * 1000 * 1000 * 1000;  // 10 s

// flag words of one block of one rank (128 bytes apart)
constexpr int kFlagWords = 32;
constexpr int kBarrier = 0;
constexpr int kRecv = 1;      // two words: slot 0, slot 1
constexpr int kCredit = 3;    // two words
constexpr int kGranted = 5;   // record: credits this block granted
constexpr int kConsumed = 6;  // record: credits this block consumed

struct RankEntry {  // eight 8-byte words, as the host's int64 table
  const char* in;
  char* out;
  char* slots;  // slot 0, then slot 1 at Params::slot_stride
  unsigned* flags;
  long long pos;    // position in its ring
  long long right;  // table index of pos + 1
  long long left;   // table index of pos - 1
  long long pad;
};

struct Params {
  const RankEntry* table;
  int n;                  // ranks of one ring
  long long elems;        // elements of the circulating unit
  long long slot_stride;  // bytes from slot 0 to slot 1
  int chunks;             // chunks of the message, or of the all-reduce
  int direction;          // neighbour stream: +1 or -1
  int flow_control;
};

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// thread 0, after the block has met: publish what the block wrote
__device__ __forceinline__ void flag_add(unsigned* flag) {
  __threadfence_system();
  asm volatile("red.release.sys.global.add.u32 [%0], %1;\n" ::"l"(flag),
               "r"(1u)
               : "memory");
}

__device__ __forceinline__ void flag_wait(const unsigned* flag,
                                          unsigned expected) {
  uint64_t start = 0;
  for (;;) {
    unsigned seen;
    asm volatile("ld.acquire.sys.global.u32 %0, [%1];\n"
                 : "=r"(seen)
                 : "l"(flag)
                 : "memory");
    if (seen >= expected) break;
    if (start == 0) {
      start = now_ns();
    } else if (now_ns() - start > kWaitNs) {
      __trap();
    }
  }
  __threadfence_system();
}

// all threads call these
__device__ __forceinline__ void block_signal(unsigned* flag) {
  __syncthreads();
  if (threadIdx.x == 0) flag_add(flag);
}

__device__ __forceinline__ void block_wait(const unsigned* flag,
                                           unsigned expected) {
  if (threadIdx.x == 0) flag_wait(flag, expected);
  __syncthreads();
}

template <int N>
struct Bits;
template <>
struct Bits<1> {
  using type = unsigned char;
};
template <>
struct Bits<2> {
  using type = unsigned short;
};
template <>
struct Bits<4> {
  using type = unsigned int;
};
template <>
struct Bits<8> {
  using type = unsigned long long;
};

// loads and stores that go to L2, where every SM sees the same line
template <typename T>
__device__ __forceinline__ T load_cg(const T* p) {
  using B = typename Bits<sizeof(T)>::type;
  const B b = __ldcg(reinterpret_cast<const B*>(p));
  T v;
  memcpy(&v, &b, sizeof(T));
  return v;
}

template <typename T>
__device__ __forceinline__ void store_cg(T* p, T v) {
  using B = typename Bits<sizeof(T)>::type;
  B b;
  memcpy(&b, &v, sizeof(T));
  __stcg(reinterpret_cast<B*>(p), b);
}

__device__ __forceinline__ bool aligned(const void* a, const void* b,
                                        uintptr_t to) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) %
          to) == 0;
}

// the block copies nbytes: 16 bytes a thread where both ends allow it
__device__ void copy_bytes(char* dst, const char* src, long long nbytes) {
  long long done = 0;
  if (aligned(dst, src, 16)) {
    const long long nvec = nbytes / 16;
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (long long i = threadIdx.x; i < nvec; i += blockDim.x)
      __stcg(d + i, __ldcg(s + i));
    done = nvec * 16;
  } else if (aligned(dst, src, 4)) {
    const long long nword = nbytes / 4;
    const unsigned* s = reinterpret_cast<const unsigned*>(src);
    unsigned* d = reinterpret_cast<unsigned*>(dst);
    for (long long i = threadIdx.x; i < nword; i += blockDim.x)
      __stcg(d + i, __ldcg(s + i));
    done = nword * 4;
  }
  for (long long i = done + threadIdx.x; i < nbytes; i += blockDim.x)
    __stcg(reinterpret_cast<unsigned char*>(dst) + i,
           __ldcg(reinterpret_cast<const unsigned char*>(src) + i));
}

constexpr int kAdd = 0;
constexpr int kMax = 1;
constexpr int kMin = 2;

template <typename T>
__device__ __forceinline__ float widen(T v) {
  return static_cast<float>(v);
}
template <>
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (OP == kAdd) {
    if constexpr (sizeof(T) == 2 && !std::is_integral<T>::value) {
      return __float2bfloat16_rn(widen(a) + widen(b));
    } else {
      return static_cast<T>(a + b);
    }
  } else if constexpr (sizeof(T) == 2 && !std::is_integral<T>::value) {
    const bool take_b = (OP == kMax) ? widen(b) > widen(a)
                                     : widen(b) < widen(a);
    return take_b ? b : a;
  } else {
    const bool take_b = (OP == kMax) ? b > a : b < a;
    return take_b ? b : a;
  }
}

// dst[i] = combine(arrival[i], own[i]) over n elements
template <typename T, int OP>
__device__ void combine_to(T* dst, const T* arrival, const T* own,
                           long long n) {
  constexpr int V = 16 / sizeof(T);
  long long done = 0;
  if (aligned(arrival, own, 16) && aligned(dst, own, 16)) {
    const long long nvec = n / V;
    for (long long i = threadIdx.x; i < nvec; i += blockDim.x) {
      uint4 a = __ldcg(reinterpret_cast<const uint4*>(arrival) + i);
      const uint4 b = __ldcg(reinterpret_cast<const uint4*>(own) + i);
      T ta[V], tb[V];
      memcpy(ta, &a, 16);
      memcpy(tb, &b, 16);
#pragma unroll
      for (int k = 0; k < V; ++k) ta[k] = combine<T, OP>(ta[k], tb[k]);
      memcpy(&a, ta, 16);
      __stcg(reinterpret_cast<uint4*>(dst) + i, a);
    }
    done = nvec * V;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x)
    store_cg(dst + i, combine<T, OP>(load_cg(arrival + i), load_cg(own + i)));
}

// This block's slice of a unit of `elems` elements of `esize` bytes:
// slices are multiples of 16 bytes, the last one takes the tail.
struct Slice {
  long long lo;  // first element
  long long n;   // elements
};

__device__ __forceinline__ Slice slice_of(long long elems, int esize) {
  const long long per16 = 16 / esize;
  long long per = (elems + gridDim.x - 1) / gridDim.x;
  per = (per + per16 - 1) / per16 * per16;
  long long lo = static_cast<long long>(blockIdx.x) * per;
  if (lo > elems) lo = elems;
  long long n = elems - lo;
  if (n > per) n = per;
  return {lo, n};
}

// One block's end of the protocol: its flags, its neighbours' flags, and
// the counts its waits expect next. The chunked all-reduce gives chunk c
// of a block flag row c * blocks + block (`c` below; chunk 0 is the row of
// an unchunked launch): every chunk's row sees the same signals at the
// same step, so chunk 0's counts stand for all of them.
struct Proto {
  unsigned* mine;
  unsigned* left;
  unsigned* right;
  long long chunk_stride;  // words from one chunk's flag row to the next
  unsigned recv_seen[2];
  unsigned credit_seen[2];
  unsigned granted, consumed;
  bool flow;

  __device__ Proto(const Params& p, const RankEntry& me)
      : chunk_stride(static_cast<long long>(gridDim.x) * kFlagWords),
        recv_seen{0, 0}, credit_seen{0, 0}, granted(0), consumed(0),
        flow(p.flow_control != 0) {
    const long long off = static_cast<long long>(blockIdx.x) * kFlagWords;
    mine = me.flags + off;
    left = p.table[me.left].flags + off;
    right = p.table[me.right].flags + off;
  }

  // both neighbours have entered the kernel
  __device__ void barrier() {
    if (!flow) return;
    block_signal(left + kBarrier);
    block_signal(right + kBarrier);
    block_wait(mine + kBarrier, 2);
  }
  // tell `writer` (the neighbour that writes our slots) that chunk c's
  // `slot` is free
  __device__ void grant(unsigned* writer, int slot, int c = 0) {
    block_signal(writer + c * chunk_stride + kCredit + slot);
    if (c == 0) ++granted;
  }
  // wait until the neighbour we write to has granted us chunk c's `slot`
  __device__ void take_credit(int slot, int c = 0) {
    if (c == 0) {
      ++credit_seen[slot];
      ++consumed;
    }
    block_wait(mine + c * chunk_stride + kCredit + slot, credit_seen[slot]);
  }
  __device__ void sent(unsigned* reader, int slot, int c = 0) {
    block_signal(reader + c * chunk_stride + kRecv + slot);
  }
  __device__ void arrived(int slot, int c = 0) {
    if (c == 0) ++recv_seen[slot];
    block_wait(mine + c * chunk_stride + kRecv + slot, recv_seen[slot]);
  }
  __device__ void finish(int chunks = 1) {
    if (threadIdx.x == 0) {
      for (int c = 0; c < chunks; ++c) {
        mine[c * chunk_stride + kGranted] = granted;
        mine[c * chunk_stride + kConsumed] = consumed;
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads)
    neighbour_stream_kernel(Params p, int esize) {
  const RankEntry& me = p.table[blockIdx.y];
  const Slice sl = slice_of(p.elems, esize);
  if (sl.n == 0) return;
  const long long lo = sl.lo * esize, nb = sl.n * esize;
  const long long unit = p.elems * esize;
  const RankEntry& dst = p.table[p.direction == 1 ? me.right : me.left];
  Proto pr(p, me);
  unsigned* dst_flags = p.direction == 1 ? pr.right : pr.left;
  unsigned* upstream_flags = p.direction == 1 ? pr.left : pr.right;
  pr.barrier();
  for (int c = 0; c < p.chunks; ++c) {
    const int slot = c & 1;
    // both slots start granted (empty); wait from chunk 2 on
    if (pr.flow && c >= 2) pr.take_credit(slot);
    copy_bytes(dst.slots + slot * p.slot_stride + lo, me.in + c * unit + lo,
               nb);
    pr.sent(dst_flags, slot);
    pr.arrived(slot);
    copy_bytes(me.out + c * unit + lo, me.slots + slot * p.slot_stride + lo,
               nb);
    // slot consumed: grant it back, unless no later chunk would wait
    if (pr.flow && c + 2 < p.chunks) pr.grant(upstream_flags, slot);
  }
  pr.finish();
}

__global__ void __launch_bounds__(kThreads)
    all_gather_kernel(Params p, int esize) {
  const RankEntry& me = p.table[blockIdx.y];
  const Slice sl = slice_of(p.elems, esize);
  if (sl.n == 0) return;
  const long long lo = sl.lo * esize, nb = sl.n * esize;
  const long long unit = p.elems * esize;
  const int n = p.n, pos = static_cast<int>(me.pos);
  char* slot[2] = {me.slots + lo, me.slots + p.slot_stride + lo};
  const RankEntry& right = p.table[me.right];
  char* right_slot[2] = {right.slots + lo, right.slots + p.slot_stride + lo};
  Proto pr(p, me);
  pr.barrier();
  copy_bytes(me.out + pos * unit + lo, me.in + lo, nb);
  copy_bytes(slot[0], me.in + lo, nb);
  __syncthreads();
  if (pr.flow) pr.grant(pr.left, 1);  // slot 1 starts empty
  for (int s = 0; s < n - 1; ++s) {
    const int cur = s & 1, nxt = cur ^ 1;
    if (pr.flow) pr.take_credit(nxt);
    copy_bytes(right_slot[nxt], slot[cur], nb);
    pr.sent(pr.right, nxt);
    pr.arrived(nxt);
    // our slot went onward: grant it upstream, except on the last step,
    // whose credit nobody would consume
    if (pr.flow && s < n - 2) pr.grant(pr.left, cur);
    const int src = (pos - s - 1 + n) % n;  // whose chunk arrived
    copy_bytes(me.out + src * unit + lo, slot[nxt], nb);
    __syncthreads();
  }
  pr.finish();
}

// REDUCE_SCATTER: the input is n units, the partial of unit (pos-1) starts
// and unit (pos-s-2) is folded into the arrival of step s; else the one
// unit every step. The fold of step s is done as the partial leaves at step
// s+1, straight into the neighbour's slot, and the last one into the output.
//
// The chunked all-reduce (smi_tpu/kernels/ring.py:542
// _ring_all_reduce_chunked_kernel, protocol credits.all_reduce_chunked_rank)
// is the all-reduce with Params::chunks > 1: the input is `chunks` units,
// unit c circulates on slot pair 2c, 2c+1 (Params::slot_stride apart) with
// its own flag row, and a step runs the model's three phases over the
// chunks: every chunk's credit and send, then every arrival in chunk order,
// then, but on the last step, the grants of the slots that went onward. Per
// element that is the unchunked fold, so the results agree bit for bit. The
// reduce-scatter is launched with one chunk.
template <typename T, int OP, bool REDUCE_SCATTER>
__global__ void __launch_bounds__(kThreads) reduce_kernel(Params p) {
  const RankEntry& me = p.table[blockIdx.y];
  const Slice sl = slice_of(p.elems, sizeof(T));
  if (sl.n == 0) return;
  const int n = p.n, pos = static_cast<int>(me.pos), chunks = p.chunks;
  const long long nb = sl.n * sizeof(T);
  const RankEntry& right = p.table[me.right];
  // slot `parity` of chunk c's pair in rank e's buffer
  auto slot = [&](const RankEntry& e, int c, int parity) {
    return reinterpret_cast<T*>(e.slots + (2LL * c + parity) * p.slot_stride) +
           sl.lo;
  };
  // what this rank folds in: its chunk c, or the reduce-scatter's block
  auto own = [&](int c, int block) {
    return reinterpret_cast<const T*>(me.in) +
           (REDUCE_SCATTER ? block : c) * p.elems + sl.lo;
  };
  Proto pr(p, me);
  pr.barrier();
  if (pr.flow)
    for (int c = 0; c < chunks; ++c) pr.grant(pr.left, 1, c);
  for (int s = 0; s < n - 1; ++s) {
    const int cur = s & 1, nxt = cur ^ 1;
    for (int c = 0; c < chunks; ++c) {
      if (pr.flow) pr.take_credit(nxt, c);
      if (s == 0) {
        copy_bytes(reinterpret_cast<char*>(slot(right, c, nxt)),
                   reinterpret_cast<const char*>(own(c, (pos - 1 + n) % n)),
                   nb);
      } else {
        combine_to<T, OP>(slot(right, c, nxt), slot(me, c, cur),
                          own(c, (pos - s - 1 + 2 * n) % n), sl.n);
      }
      pr.sent(pr.right, nxt, c);
    }
    for (int c = 0; c < chunks; ++c) pr.arrived(nxt, c);
    if (pr.flow && s < n - 2)
      for (int c = 0; c < chunks; ++c) pr.grant(pr.left, cur, c);
  }
  for (int c = 0; c < chunks; ++c)
    combine_to<T, OP>(reinterpret_cast<T*>(me.out) + c * p.elems + sl.lo,
                      slot(me, c, (n - 1) & 1), own(c, pos), sl.n);
  pr.finish(chunks);
}

using ReduceFn = void (*)(Params);

template <typename T, bool RS>
ReduceFn reduce_for_op(int op) {
  switch (op) {
    case kAdd: return reduce_kernel<T, kAdd, RS>;
    case kMax: return reduce_kernel<T, kMax, RS>;
    case kMin: return reduce_kernel<T, kMin, RS>;
  }
  return nullptr;
}

// dtype codes of the host wrapper
template <bool RS>
ReduceFn reduce_for(int dtype, int op) {
  switch (dtype) {
    case 0: return reduce_for_op<int32_t, RS>(op);
    case 1: return reduce_for_op<float, RS>(op);
    case 2: return reduce_for_op<double, RS>(op);
    case 3: return reduce_for_op<int8_t, RS>(op);
    case 4: return reduce_for_op<int16_t, RS>(op);
    case 5: return reduce_for_op<__nv_bfloat16, RS>(op);
  }
  return nullptr;
}

int esize_of(int dtype) {
  switch (dtype) {
    case 0: case 1: return 4;
    case 2: return 8;
    case 3: return 1;
    case 4: case 5: return 2;
  }
  return 0;
}

// Launch `kernel` on a (blocks, ranks) grid only if the whole grid can be
// resident at once.
int launch_resident(const void* kernel, int blocks, int ranks, void** args,
                    cudaStream_t stream) {
  if (blocks < 1 || ranks < 1) return cudaErrorInvalidValue;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  if (static_cast<long long>(blocks) * ranks >
      static_cast<long long>(per_sm) * sms)
    return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks, ranks), dim3(kThreads),
                                    args, 0, stream);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

int launch_reduce(ReduceFn kernel, const void* table, int ranks, int n,
                  long long elems, long long slot_stride, int chunks,
                  int flow_control, int blocks, void* stream) {
  if (kernel == nullptr || chunks < 1) return cudaErrorInvalidValue;
  Params p{static_cast<const RankEntry*>(table), n, elems,
           slot_stride, chunks, 1, flow_control};
  void* args[] = {&p};
  return launch_resident((const void*)kernel, blocks, ranks, args,
                         static_cast<cudaStream_t>(stream));
}

}  // namespace

// The common arguments: `table` (RankEntry rows in device memory, one for
// each rank this launch plays), the number of ranks, the ring size,
// the elements of the unit, the byte stride between a rank's two slots,
// the dtype code, flow control on or off, blocks per rank, the stream.

extern "C" int smi_ring_neighbour_stream(
    const void* table, int ranks, int n, long long elems,
    long long slot_stride, int dtype, int chunks, int direction,
    int flow_control, int blocks, void* stream) {
  int esize = esize_of(dtype);
  if (esize == 0 || chunks < 1 || (direction != 1 && direction != -1))
    return cudaErrorInvalidValue;
  Params p{static_cast<const RankEntry*>(table), n, elems,
           slot_stride, chunks, direction, flow_control};
  void* args[] = {&p, &esize};
  return launch_resident((const void*)neighbour_stream_kernel,
                         blocks, ranks, args,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int smi_ring_all_gather(
    const void* table, int ranks, int n, long long elems,
    long long slot_stride, int dtype, int flow_control, int blocks,
    void* stream) {
  int esize = esize_of(dtype);
  if (esize == 0) return cudaErrorInvalidValue;
  Params p{static_cast<const RankEntry*>(table), n, elems,
           slot_stride, 1, 1, flow_control};
  void* args[] = {&p, &esize};
  return launch_resident((const void*)all_gather_kernel,
                         blocks, ranks, args,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int smi_ring_all_reduce(
    const void* table, int ranks, int n, long long elems,
    long long slot_stride, int dtype, int op, int flow_control, int blocks,
    void* stream) {
  return launch_reduce(reduce_for<false>(dtype, op), table, ranks, n, elems,
                       slot_stride, 1, flow_control, blocks, stream);
}

// `elems` is one chunk's unit; `table` rows point at `chunks` units in and
// out, 2 * chunks slots, and chunks * blocks flag rows a rank.
extern "C" int smi_ring_all_reduce_chunked(
    const void* table, int ranks, int n, long long elems,
    long long slot_stride, int dtype, int op, int chunks, int flow_control,
    int blocks, void* stream) {
  return launch_reduce(reduce_for<false>(dtype, op), table, ranks, n, elems,
                       slot_stride, chunks, flow_control, blocks, stream);
}

extern "C" int smi_ring_reduce_scatter(
    const void* table, int ranks, int n, long long elems,
    long long slot_stride, int dtype, int op, int flow_control, int blocks,
    void* stream) {
  return launch_reduce(reduce_for<true>(dtype, op), table, ranks, n, elems,
                       slot_stride, 1, flow_control, blocks, stream);
}
