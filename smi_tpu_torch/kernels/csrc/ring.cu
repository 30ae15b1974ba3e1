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
// all_reduce_rank, all_reduce_chunked_rank, reduce_scatter_rank); the
// kernels here keep every signal and every wait of it.
//
// Design. One launch plays every rank that lives in this process: the
// grid is (blocks a rank, ranks), rank = blockIdx.y, and a table in device
// memory gives each rank its input, its output, its comm slots, its flag
// words, its position in its ring and where in the table its left and
// right neighbours are (a launch may hold several rings, one per line of a
// grid axis; a rank only ever sees its own line). The payload is cut into
// contiguous slices (multiples of 16 bytes); block x of rank r runs the
// whole protocol on its slice and talks only to block x of ranks r-1 and
// r+1, through flag row x of each (kFlagWords words), so no grid-wide
// synchronisation exists. The chunked all-reduce gives each chunk blocks
// of its own: block x plays chunk x / blocks on slice x % blocks of that
// chunk's unit, so a step costs one round of handshakes whatever the chunk
// count. Blocks of different ranks wait for each other, so the whole grid
// must be resident at once: every entry point refuses a grid larger than
// cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs and launches with
// cudaLaunchCooperativeKernel, which refuses it too.
//
// A "DMA" of the collectives is the block copying its slice into the
// neighbour's slot, 16 bytes a load where source and destination are
// 16-byte aligned (by words or bytes otherwise, so any shape and any
// element type moves), each thread with kUnroll loads in flight. Then all
// threads meet (__syncthreads) and thread 0 adds one to the neighbour's
// receive flag with a release; the reader's thread 0 polls the flag with
// relaxed loads until it has reached the count this step expects,
// acquires once, the block meets, and all threads read the slot. Every
// flag operation is at device scope (RING_SCOPE): one launch plays every
// rank, and every rank of it lives on this card, so nothing has to be
// made visible to the host or to another card. Flags are counters that
// only grow; the host zeroes them before a launch, when no kernel is in
// flight. A wait that lasts ten seconds traps (the clock is read once
// every kPollsPerClock polls): a lost signal fails the launch, it cannot
// hang the card. Credits work the same way (the reader grants a slot to
// its writer after it has copied the slot out, or sent it onward), and
// each block counts the credits it granted and the credits it consumed
// into its flag row for the host to check that every credit domain
// drained. With flow_control == 0 there is
// no entry barrier and there are no credits; the receive flags stay, they
// are the completion of the copy.
//
// The neighbour stream splits each block into two roles of one warpgroup
// (128 threads), as the reference splits Push and Pop into two kernels
// (templates/push.cl, pop.cl). In each role the first warp leads: its
// lane 0 waits and signals, and it moves no data; the other three warps
// copy. The Push role walks the chunks: its copying warps load their
// slice of chunk c into registers, the leader waits for slot c % 2's
// credit (from chunk 2 on), the slice is stored into the downstream
// rank's slot, the role meets on its own named barrier (bar.sync 1, 128)
// and the leader releases the downstream receive flag. The Pop role walks
// the same chunks: the leader waits for the arrival, the slot is loaded
// into registers, the role meets on bar.sync 2, the leader grants the
// slot back upstream (unless c + 2 >= chunks), and only then does the
// chunk go out, so the writer may refill the slot meanwhile. A role's
// release follows its own barrier, so it covers the role's stores (Push)
// or loads (Pop), as __syncthreads covers a block's. Push may run two
// chunks ahead of the downstream Pop, as the credits allow. A release is
// a MEMBAR.ALL.GPU before the red, and it waits for the outstanding loads
// and stores of the leader's own warp: a leader that copied, or that
// loaded the next chunk before its release, would delay each signal by a
// load's round trip, so the copying warps load the next chunk only after
// the barrier that precedes the release. What bounds the stream is the
// flags' round trip: a slot's cycle is the writer's stores and release,
// the reader's poll, acquire and load, its release and the writer's poll
// and acquire, all through L2, so a chunk costs a microsecond or two
// however small it is (chip_smoke.py phase 24), and two slots are at most
// two chunks in flight on a link.
// torch.roll of the stacked inputs (one pass at memory rate) is faster for
// any message of more than a few chunks; only more slots would close the
// gap, and they would change SMI's protocol. Every signal and wait of
// credits.neighbour_stream_rank stays, with the same counts and the same
// flag words; each role counts its own credits (Push the consumed, Pop
// the granted) and both write them after a final block barrier.
//
// Bound on the H100 (3.35 TB/s): bytes, each input read once and each
// output written once. With P the bytes of the unit that circulates and n
// ranks, over all ranks: all-reduce 2nP (n inputs of P, n outputs of P;
// 67 MB at 4 MiB a rank and n = 8, 0.020 ms); reduce-scatter n(n+1)P
// (inputs of nP, outputs of P); all-gather n(1+n)P; the stream 2nP for P
// the whole message. The arithmetic (one operation per element and step)
// is far below the card's rate. The chunked all-reduce has the all-reduce's
// bound, schedule traffic and handshakes a step.
//
// What the ring schedule moves on top of that bound ("schedule traffic",
// logged beside the time, not a bound: all ranks' data lies on one card,
// so one pass over it would do). A rank of the all-reduce writes its
// input into the neighbour's slot (2P); on each of the n-2 later steps it
// reads the arrival and its input and writes their fold straight into the
// neighbour's slot (3P); the last arrival is folded with the input into
// the output (3P): (3n-1) P a rank, 23P at n = 8, whatever the chunk
// count. The reduce-scatter moves the same with P one block of the input.
// The all-gather reads each unit once where it lies and writes it twice:
// its input to the output and to the neighbour's slot (3P), then on each
// of n-2 steps the arrival onward and to the output (3P), and the last
// arrival to the output (2P): (3n-1) P a rank. The stream moves each chunk
// into the neighbour's slot (2P) and out of its own (2P): 4P a rank. The
// comm slots of eight ranks at 4 MiB (64 MiB) do not fit the 50 MB L2, so
// this traffic reaches device memory.
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
#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

// The scope of every flag operation of the protocol: the device. A launch
// form whose ranks live in other processes or on other cards would set it.
#define RING_SCOPE "gpu"

namespace {

constexpr int kThreads = 256;
// at least four blocks an SM: 64 registers a thread at most, so that 512
// blocks (MAX_BLOCKS in kernels/ring.py) are resident on 132 SMs
constexpr int kMinBlocksPerSm = 4;
constexpr int kUnroll = 4;  // independent loads in flight a thread
constexpr uint64_t kWaitNs = 10ull * 1000 * 1000 * 1000;  // 10 s
constexpr unsigned kPollsPerClock = 256;

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

// Thread 0, right after the block met at __syncthreads: one release at
// device scope. bar.sync orders every thread's slot writes (and reads)
// before thread 0's next operation, and a release is cumulative: it makes
// visible at its scope every write that precedes it in that order, not
// only thread 0's. A reader that acquires the count therefore sees the
// whole block's slice.
__device__ __forceinline__ void flag_add(unsigned* flag) {
  asm volatile("red.release." RING_SCOPE ".global.add.u32 [%0], %1;\n"
               :
               : "l"(flag), "r"(1u)
               : "memory");
}

// Thread 0: poll with relaxed loads until the count is reached, then one
// acquire load of the flag. The count only grows, so the acquire reads
// the release that reached it or a later one of the same signaller (a
// release too), and everything the signalling block wrote before it is
// visible to this block after its next __syncthreads. An acquire load
// orders what follows it; a fence.acq_rel would also wait for the
// thread's own outstanding memory operations.
__device__ __forceinline__ void flag_wait(const unsigned* flag,
                                          unsigned expected) {
  uint64_t start = 0;
  unsigned seen;
  for (unsigned polls = 1;; ++polls) {
    asm volatile("ld.relaxed." RING_SCOPE ".global.u32 %0, [%1];\n"
                 : "=r"(seen)
                 : "l"(flag)
                 : "memory");
    if (seen >= expected) break;
    if (polls % kPollsPerClock == 0) {
      const uint64_t t = now_ns();
      if (start == 0) {
        start = t;
      } else if (t - start > kWaitNs) {
        __trap();
      }
    }
  }
  asm volatile("ld.acquire." RING_SCOPE ".global.u32 %0, [%1];\n"
               : "=r"(seen)
               : "l"(flag)
               : "memory");
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

// The block copies `count` words of type W from src to dst, and to dst2
// where it is not null: each thread loads kUnroll words, a block's width
// apart, before it stores any.
template <typename W>
__device__ __forceinline__ void copy_words(W* dst, W* dst2, const W* src,
                                           long long count) {
  const long long step = static_cast<long long>(blockDim.x) * kUnroll;
  for (long long base = threadIdx.x; base < count; base += step) {
    W v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * blockDim.x;
      if (i < count) v[u] = __ldcg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + static_cast<long long>(u) * blockDim.x;
      if (i < count) {
        __stcg(dst + i, v[u]);
        if (dst2 != nullptr) __stcg(dst2 + i, v[u]);
      }
    }
  }
}

// the block copies nbytes to dst, and to dst2 where it is not null: 16
// bytes a load where every end allows it, else words, and bytes for a tail
__device__ void copy_bytes(char* dst, char* dst2, const char* src,
                           long long nbytes) {
  auto all_aligned = [&](uintptr_t to) {
    return aligned(dst, src, to) && (dst2 == nullptr || aligned(dst2, src, to));
  };
  long long done = 0;
  if (all_aligned(16)) {
    done = nbytes / 16 * 16;
    copy_words(reinterpret_cast<uint4*>(dst), reinterpret_cast<uint4*>(dst2),
               reinterpret_cast<const uint4*>(src), nbytes / 16);
  } else if (all_aligned(4)) {
    done = nbytes / 4 * 4;
    copy_words(reinterpret_cast<unsigned*>(dst),
               reinterpret_cast<unsigned*>(dst2),
               reinterpret_cast<const unsigned*>(src), nbytes / 4);
  }
  copy_words(reinterpret_cast<unsigned char*>(dst + done),
             dst2 == nullptr ? nullptr
                             : reinterpret_cast<unsigned char*>(dst2 + done),
             reinterpret_cast<const unsigned char*>(src + done),
             nbytes - done);
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

// dst[i] = combine(arrival[i], own[i]) over n elements: where all three
// are 16-byte aligned, each thread loads kUnroll pairs of 16 bytes before
// it folds and stores any
template <typename T, int OP>
__device__ void combine_to(T* dst, const T* arrival, const T* own,
                           long long n) {
  constexpr int V = 16 / sizeof(T);
  long long done = 0;
  if (aligned(arrival, own, 16) && aligned(dst, own, 16)) {
    const long long nvec = n / V;
    const uint4* a = reinterpret_cast<const uint4*>(arrival);
    const uint4* b = reinterpret_cast<const uint4*>(own);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const long long step = static_cast<long long>(blockDim.x) * kUnroll;
    for (long long base = threadIdx.x; base < nvec; base += step) {
      uint4 va[kUnroll], vb[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + static_cast<long long>(u) * blockDim.x;
        if (i < nvec) {
          va[u] = __ldcg(a + i);
          vb[u] = __ldcg(b + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = base + static_cast<long long>(u) * blockDim.x;
        if (i < nvec) {
          T ta[V], tb[V];
          memcpy(ta, &va[u], 16);
          memcpy(tb, &vb[u], 16);
#pragma unroll
          for (int k = 0; k < V; ++k) ta[k] = combine<T, OP>(ta[k], tb[k]);
          memcpy(&va[u], ta, 16);
          __stcg(d + i, va[u]);
        }
      }
    }
    done = nvec * V;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x)
    store_cg(dst + i, combine<T, OP>(load_cg(arrival + i), load_cg(own + i)));
}

// Slice `part` of `parts` of a unit of `elems` elements of `esize` bytes:
// slices are multiples of 16 bytes, the last one takes the tail, and a
// part past the end is empty (tests/test_torch_ring.py::slice_of_model; the
// card's tests hold each block's barrier to that model).
struct Slice {
  long long lo;  // first element
  long long n;   // elements
};

__device__ __forceinline__ Slice slice_of(long long elems, int esize,
                                          int parts, int part) {
  const long long per16 = 16 / esize;
  long long per = (elems + parts - 1) / parts;
  per = (per + per16 - 1) / per16 * per16;
  long long lo = static_cast<long long>(part) * per;
  if (lo > elems) lo = elems;
  long long n = elems - lo;
  if (n > per) n = per;
  return {lo, n};
}

// One block's end of the protocol: its flag row (row blockIdx.x of its
// rank), the same row of its neighbours, and the counts its waits expect
// next.
struct Proto {
  unsigned* mine;
  unsigned* left;
  unsigned* right;
  unsigned recv_seen[2];
  unsigned credit_seen[2];
  unsigned granted, consumed;
  bool flow;

  __device__ Proto(const Params& p, const RankEntry& me)
      : recv_seen{0, 0}, credit_seen{0, 0}, granted(0), consumed(0),
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
  // tell `writer` (the neighbour that writes our slots) that `slot` is free
  __device__ void grant(unsigned* writer, int slot) {
    block_signal(writer + kCredit + slot);
    ++granted;
  }
  // wait until the neighbour we write to has granted us `slot`
  __device__ void take_credit(int slot) {
    ++consumed;
    block_wait(mine + kCredit + slot, ++credit_seen[slot]);
  }
  __device__ void sent(unsigned* reader, int slot) {
    block_signal(reader + kRecv + slot);
  }
  __device__ void arrived(int slot) {
    block_wait(mine + kRecv + slot, ++recv_seen[slot]);
  }
  __device__ void finish() {
    if (threadIdx.x == 0) {
      mine[kGranted] = granted;
      mine[kConsumed] = consumed;
    }
  }
};

// ---- the neighbour stream: a Push role and a Pop role a block ----------

constexpr int kRoleThreads = kThreads / 2;  // one warpgroup a role
constexpr int kPushBar = 1;                 // named barriers (0: __syncthreads)
constexpr int kPopBar = 2;
// A role's first warp only waits and signals (its lane 0); the other
// three copy. The release of a signal waits for the signalling warp's own
// outstanding loads and stores (MEMBAR.ALL.GPU); a leader that moves no
// data releases at once, while the copying warps already load the next
// chunk.
constexpr int kCopyThreads = kRoleThreads - 32;

// One role of a stream block. Its threads meet on the role's own named
// barrier, which orders their memory accesses before what the role's
// leader does next, as __syncthreads does for a block; the leader's
// release then covers the whole role's slice.
struct Role {
  int bar;   // kPushBar or kPopBar
  int rank;  // this thread's index in the role; 0 leads

  __device__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" : : "r"(bar), "n"(kRoleThreads)
                 : "memory");
  }
  __device__ void signal(unsigned* flag) const {
    sync();
    if (rank == 0) flag_add(flag);
  }
  __device__ void wait(const unsigned* flag, unsigned expected) const {
    if (rank == 0) flag_wait(flag, expected);
    sync();
  }
};

// One round of a role's copy in registers: kUnroll words W a copying
// thread, kCopyThreads apart (6 KiB a round at 16-byte words), and with
// round 0 a tail of fewer bytes than a word, one byte a thread. `rank` is
// the thread's index among the copying threads; the leader's warp
// (rank < 0) copies nothing.
template <typename W>
struct Round {
  static constexpr int kWords = kCopyThreads * kUnroll;
  W v[kUnroll];
  unsigned char tail;

  // the rounds of an nbytes copy (at least one, so that every thread of a
  // role meets its barriers also for an empty slice)
  static __device__ __forceinline__ long long of(long long nbytes) {
    const long long words = nbytes / static_cast<long long>(sizeof(W));
    return words > 0 ? (words + kWords - 1) / kWords : 1;
  }
  // round r of the nbytes at src
  __device__ __forceinline__ void load(const char* src, long long nbytes,
                                       long long r, int rank) {
    if (rank < 0) return;
    const long long words = nbytes / static_cast<long long>(sizeof(W));
    const W* s = reinterpret_cast<const W*>(src) + r * kWords;
    const long long left = words - r * kWords;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = u * kCopyThreads + rank;
      if (i < left) v[u] = __ldcg(s + i);
    }
    const long long at = words * static_cast<long long>(sizeof(W)) + rank;
    if (r == 0 && at < nbytes)
      tail = __ldcg(reinterpret_cast<const unsigned char*>(src) + at);
  }
  __device__ __forceinline__ void store(char* dst, long long nbytes,
                                        long long r, int rank) const {
    if (rank < 0) return;
    const long long words = nbytes / static_cast<long long>(sizeof(W));
    W* d = reinterpret_cast<W*>(dst) + r * kWords;
    const long long left = words - r * kWords;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = u * kCopyThreads + rank;
      if (i < left) __stcg(d + i, v[u]);
    }
    const long long at = words * static_cast<long long>(sizeof(W)) + rank;
    if (r == 0 && at < nbytes)
      __stcg(reinterpret_cast<unsigned char*>(dst) + at, tail);
  }
};

// The Push role: chunk c of `in` (chunks `unit` bytes apart; this block's
// nb bytes of each) into slot c % 2 of the downstream rank (`slots`), and
// its receive flag `recv` counted. A chunk's first round is loaded before
// its credit is waited for.
template <typename W>
__device__ void push_role(const Params& p, Proto& pr, Role role,
                          const char* in, char* slots, long long nb,
                          long long unit, unsigned* recv) {
  const long long rounds = Round<W>::of(nb);
  const int rank = role.rank - (kRoleThreads - kCopyThreads);
  for (int c = 0; c < p.chunks; ++c) {
    const int slot = c & 1;
    const char* from = in + c * unit;
    char* to = slots + slot * p.slot_stride;
    Round<W> w;
    w.load(from, nb, 0, rank);
    // both slots start granted (empty): wait from chunk 2 on
    if (pr.flow && c >= 2) {
      ++pr.consumed;
      role.wait(pr.mine + kCredit + slot, ++pr.credit_seen[slot]);
    }
    w.store(to, nb, 0, rank);
    for (long long r = 1; r < rounds; ++r) {
      w.load(from, nb, r, rank);
      w.store(to, nb, r, rank);
    }
    role.signal(recv + slot);
  }
}

// The Pop role: each arrival in this rank's slot c % 2 (`slots`) out to
// chunk c of `out`, the slot granted back to the upstream writer
// (`credit`) once its last round is read, before that round is stored.
template <typename W>
__device__ void pop_role(const Params& p, Proto& pr, Role role,
                         const char* slots, char* out, long long nb,
                         long long unit, unsigned* credit) {
  const long long rounds = Round<W>::of(nb);
  const int rank = role.rank - (kRoleThreads - kCopyThreads);
  for (int c = 0; c < p.chunks; ++c) {
    const int slot = c & 1;
    const char* from = slots + slot * p.slot_stride;
    char* to = out + c * unit;
    role.wait(pr.mine + kRecv + slot, ++pr.recv_seen[slot]);
    for (long long r = 0; r < rounds; ++r) {
      Round<W> w;
      w.load(from, nb, r, rank);
      // the slot is read: grant it back, unless no later chunk would wait
      if (r == rounds - 1 && pr.flow && c + 2 < p.chunks) {
        ++pr.granted;
        role.signal(credit + slot);
      }
      w.store(to, nb, r, rank);
    }
  }
}

template <typename W>
__device__ __forceinline__ void stream_role(
    const Params& p, Proto& pr, bool push, Role role, const char* in,
    char* out, char* dst_slots, const char* my_slots, long long nb,
    long long unit, unsigned* dst_flags, unsigned* upstream_flags) {
  if (push) {
    push_role<W>(p, pr, role, in, dst_slots, nb, unit, dst_flags + kRecv);
  } else {
    pop_role<W>(p, pr, role, my_slots, out, nb, unit,
                upstream_flags + kCredit);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    neighbour_stream_kernel(Params p, int esize) {
  const RankEntry& me = p.table[blockIdx.y];
  const Slice sl = slice_of(p.elems, esize, gridDim.x, blockIdx.x);
  if (sl.n == 0) return;
  const long long lo = sl.lo * esize, nb = sl.n * esize;
  const long long unit = p.elems * esize;
  const RankEntry& dst = p.table[p.direction == 1 ? me.right : me.left];
  Proto pr(p, me);
  unsigned* dst_flags = p.direction == 1 ? pr.right : pr.left;
  unsigned* upstream_flags = p.direction == 1 ? pr.left : pr.right;
  pr.barrier();
  const bool push = threadIdx.x < kRoleThreads;
  const Role role{push ? kPushBar : kPopBar,
                  static_cast<int>(threadIdx.x) % kRoleThreads};
  const char* in = me.in + lo;
  char* out = me.out + lo;
  char* dst_slots = dst.slots + lo;
  const char* my_slots = me.slots + lo;
  // one word size for every chunk: the widest that every chunk's input,
  // output and slot allow
  const uintptr_t ends = reinterpret_cast<uintptr_t>(in) |
                         reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(dst_slots) |
                         reinterpret_cast<uintptr_t>(my_slots) |
                         static_cast<uintptr_t>(unit) |
                         static_cast<uintptr_t>(p.slot_stride);
  if (ends % 16 == 0) {
    stream_role<uint4>(p, pr, push, role, in, out, dst_slots, my_slots, nb,
                       unit, dst_flags, upstream_flags);
  } else if (ends % 4 == 0) {
    stream_role<unsigned>(p, pr, push, role, in, out, dst_slots, my_slots,
                          nb, unit, dst_flags, upstream_flags);
  } else {
    stream_role<unsigned char>(p, pr, push, role, in, out, dst_slots,
                               my_slots, nb, unit, dst_flags,
                               upstream_flags);
  }
  // each role counted its own credits: Push the consumed, Pop the granted
  __syncthreads();
  if (threadIdx.x == 0) pr.mine[kConsumed] = pr.consumed;
  if (threadIdx.x == kRoleThreads) pr.mine[kGranted] = pr.granted;
}

// all_gather_rank's steps, each unit read once where it lies: step 0
// sends the rank's input (what the model writes into slot 0) and copies
// it to the output on the way; a later step sends the arrival of the step
// before onward and copies it out on the same pass, before the grant that
// frees its slot; the last arrival only goes out.
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    all_gather_kernel(Params p, int esize) {
  const RankEntry& me = p.table[blockIdx.y];
  const Slice sl = slice_of(p.elems, esize, gridDim.x, blockIdx.x);
  if (sl.n == 0) return;
  const long long lo = sl.lo * esize, nb = sl.n * esize;
  const long long unit = p.elems * esize;
  const int n = p.n, pos = static_cast<int>(me.pos);
  char* slot[2] = {me.slots + lo, me.slots + p.slot_stride + lo};
  const RankEntry& right = p.table[me.right];
  char* right_slot[2] = {right.slots + lo, right.slots + p.slot_stride + lo};
  // where rank `src`'s unit goes in the output
  auto out = [&](int src) { return me.out + src * unit + lo; };
  Proto pr(p, me);
  pr.barrier();
  if (pr.flow) pr.grant(pr.left, 1);  // slot 1 starts empty
  for (int s = 0; s < n - 1; ++s) {
    const int cur = s & 1, nxt = cur ^ 1;
    if (pr.flow) pr.take_credit(nxt);
    if (s == 0) {
      copy_bytes(right_slot[nxt], out(pos), me.in + lo, nb);
    } else {  // slot[cur] holds rank pos-s's unit, arrived at step s-1
      copy_bytes(right_slot[nxt], out((pos - s + n) % n), slot[cur], nb);
    }
    pr.sent(pr.right, nxt);
    pr.arrived(nxt);
    // our slot went onward and out: grant it upstream, except on the last
    // step, whose credit nobody would consume
    if (pr.flow && s < n - 2) pr.grant(pr.left, cur);
  }
  copy_bytes(out((pos + 1) % n), nullptr, slot[(n - 1) & 1], nb);
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
// and gridDim.x / chunks blocks play each. Block x plays chunk
// c = x / blocks: unit c, slot pair 2c, 2c+1 (Params::slot_stride apart),
// its own flag row, and per chunk the credit discipline of the unchunked
// kernel, so every element folds in the same order and the results agree
// bit for bit. The model's phases A/B/C interleave the chunks on the TPU's
// one core; here the chunks run side by side. The reduce-scatter is
// launched with one chunk.
template <typename T, int OP, bool REDUCE_SCATTER>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSm)
    reduce_kernel(Params p) {
  const RankEntry& me = p.table[blockIdx.y];
  const int blocks = gridDim.x / p.chunks;  // blocks a chunk
  const int c = blockIdx.x / blocks;
  const Slice sl = slice_of(p.elems, sizeof(T), blocks, blockIdx.x % blocks);
  if (sl.n == 0) return;
  const int n = p.n, pos = static_cast<int>(me.pos);
  const long long nb = sl.n * sizeof(T);
  const RankEntry& right = p.table[me.right];
  // slot `parity` of chunk c's pair in rank e's buffer
  auto slot = [&](const RankEntry& e, int parity) {
    return reinterpret_cast<T*>(e.slots + (2LL * c + parity) * p.slot_stride) +
           sl.lo;
  };
  // what this rank folds in: its chunk c, or the reduce-scatter's block
  auto own = [&](int block) {
    return reinterpret_cast<const T*>(me.in) +
           (REDUCE_SCATTER ? block : c) * p.elems + sl.lo;
  };
  Proto pr(p, me);
  pr.barrier();
  if (pr.flow) pr.grant(pr.left, 1);  // slot 1 starts empty
  for (int s = 0; s < n - 1; ++s) {
    const int cur = s & 1, nxt = cur ^ 1;
    if (pr.flow) pr.take_credit(nxt);
    if (s == 0) {
      copy_bytes(reinterpret_cast<char*>(slot(right, nxt)), nullptr,
                 reinterpret_cast<const char*>(own((pos - 1 + n) % n)), nb);
    } else {
      combine_to<T, OP>(slot(right, nxt), slot(me, cur),
                        own((pos - s - 1 + 2 * n) % n), sl.n);
    }
    pr.sent(pr.right, nxt);
    pr.arrived(nxt);
    if (pr.flow && s < n - 2) pr.grant(pr.left, cur);
  }
  combine_to<T, OP>(reinterpret_cast<T*>(me.out) + c * p.elems + sl.lo,
                    slot(me, (n - 1) & 1), own(pos), sl.n);
  pr.finish();
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

// The blocks of `kernel` that the current device holds at once (its SMs
// times the kernel's resident blocks an SM): asked of the runtime once a
// process for each kernel and device, since neither changes.
cudaError_t resident_blocks(const void* kernel, long long* out) {
  static std::mutex lock;
  static std::map<std::pair<const void*, int>, long long> known;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  const auto key = std::make_pair(kernel, device);
  const auto found = known.find(key);
  if (found != known.end()) {
    *out = found->second;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return err;
  *out = known[key] = static_cast<long long>(per_sm) * sms;
  return cudaSuccess;
}

// Launch `kernel` on a (blocks, ranks) grid only if the whole grid can be
// resident at once.
int launch_resident(const void* kernel, int blocks, int ranks, void** args,
                    cudaStream_t stream) {
  if (blocks < 1 || ranks < 1) return cudaErrorInvalidValue;
  long long resident = 0;
  cudaError_t err = resident_blocks(kernel, &resident);
  if (err != cudaSuccess) return err;
  if (static_cast<long long>(blocks) * ranks > resident)
    return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks, ranks), dim3(kThreads),
                                    args, 0, stream);
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}

// `blocks` a chunk: the grid is (chunks x blocks, ranks)
int launch_reduce(ReduceFn kernel, const void* table, int ranks, int n,
                  long long elems, long long slot_stride, int chunks,
                  int flow_control, int blocks, void* stream) {
  if (kernel == nullptr || chunks < 1 || blocks < 1)
    return cudaErrorInvalidValue;
  Params p{static_cast<const RankEntry*>(table), n, elems,
           slot_stride, chunks, 1, flow_control};
  void* args[] = {&p};
  return launch_resident((const void*)kernel, chunks * blocks, ranks, args,
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

// `elems` is one chunk's unit and `blocks` the blocks of one chunk;
// `table` rows point at `chunks` units in and out, 2 * chunks slots, and
// chunks * blocks flag rows a rank (chunk-major).
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
