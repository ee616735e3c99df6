// Copyright 2026 Conch-TPU authors.
// SPDX-License-Identifier: Apache-2.0
//
// Ring all-gather (K14).
//
// Replaces conch_tpu/kernels/collectives/ring_all_gather.py:_ring_all_gather_kernel.
// n ranks each hold a (rows, cols) shard of chunk_bytes bytes; every rank ends with
// the (n * rows, cols) concatenation, row block j being rank j's shard. The protocol
// is the TPU kernel's, rewritten for CUDA:
//   1. entry barrier: rank r signals its left and right neighbours and waits for both;
//   2. own chunk: rank r copies its shard into slot r of its own output;
//   3. ring steps i = 0 .. n-2: rank r forwards slot (r - i) mod n of its own output
//      into the same slot of its right neighbour's output, raises the neighbour's
//      step-i flag, and waits for its own step-i flag. The left neighbour raises that
//      flag once slot (r - 1 - i) mod n, the one rank r forwards at step i + 1, has
//      landed. The last wait is the last chunk's arrival.
// No slot is written twice, so no step overwrites data still to be read, whatever
// the skew between ranks.
//
// Addresses. A rank reaches its peers' outputs and flags through a table of device
// addresses passed by value (RingTable). The host binding alone decides where they
// point: into several buffers of one card (a ring of virtual ranks, as the JAX
// tests' virtual CPU devices), or into peers' memory behind NVLink peer access.
// The device code serves both: every flag access and fence is at system scope, and
// every load of data that another SM or card wrote goes around L1 (ld.global.cg),
// so a call on reused memory never reads a stale line.
//
// Flags without a reset. Each call on a flag buffer carries a larger 64-bit epoch
// than the last. A signal stores the epoch; a wait spins until the flag is at least
// the epoch. In the per-rank mode a fast neighbour may finish call e and signal call
// e + 1's barrier before a slow rank has read e's; the larger value still satisfies
// the slow rank's wait, so equality would deadlock where "at least" does not. The
// step flags are safe because call e + 1's entry barrier keeps a rank from writing
// into a neighbour that has not finished call e. Each spin is bounded by
// %globaltimer: on timeout the block writes an error word (the first one wins) and
// returns, so a broken ring reports instead of hanging.
//
// Memory order of a step: every thread's stores; __syncthreads(); one thread's
// fence.acq_rel.sys and release store of the flag (st.release.sys); on the other
// side an acquire spin (ld.acquire.sys), then __syncthreads().
//
// Two launch modes of one device body: the whole ring in one cooperative launch
// (rank = blockIdx.x / blocks_per_rank; cudaLaunchCooperativeKernel keeps all ranks
// co-resident), or one launch per rank on the rank's own stream (rank >= 0), the
// mode that peers on several cards need. Block b of every rank copies the same byte
// range of each chunk and has its own flags, so the blocks of a rank never wait on
// each other.
//
// Bound on the H100: bytes. The function must read the n inputs once and write the
// n outputs of n chunks once, (n * n + n) * chunk_bytes on the one HBM that all
// ranks share. This ring reads n * (n - 1) chunks more, since every step reads the
// chunk it forwards back out of its own output. The copy is dtype-blind: 16 bytes
// a load where chunk_bytes and every pointer allow it, 8, 4, 2 or 1 otherwise; four
// loads in flight a thread before their stores.

#include <cuda_runtime.h>

#include <cstdint>

namespace conch {
namespace {

constexpr int kMaxRanks = 64;  // rows of the address table (kept in sync with the Python launcher)
constexpr int kThreads = 512;
constexpr int kUnroll = 4;
// Flag slots of one (rank, block): the barrier from each side, then one per step.
constexpr int kFromLeft = 0;
constexpr int kFromRight = 1;
constexpr int kStep = 2;

struct RingTable {
  const unsigned char* inputs[kMaxRanks];
  unsigned char* outputs[kMaxRanks];
  unsigned long long* flags[kMaxRanks];
};

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.sys.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void fence_system() { asm volatile("fence.acq_rel.sys;" ::: "memory"); }

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spins until *flag >= epoch; false once timeout_ns have passed.
__device__ bool wait_flag(const unsigned long long* flag, unsigned long long epoch, unsigned long long timeout_ns) {
  if (load_acquire(flag) >= epoch) return true;
  const unsigned long long start = global_ns();
  while (load_acquire(flag) < epoch) {
    if (global_ns() - start > timeout_ns) return false;
    __nanosleep(64);
  }
  return true;
}

// The error word's value for a timed-out wait: nonzero, with the rank, block and
// stage (0 the entry barrier, 1 + i ring step i).
__device__ __forceinline__ int error_code(int rank, int block, int stage) {
  return 0x40000000 | (rank << 16) | (block << 8) | stage;
}

// dst[i] = src[i] for i in [lo, hi), in units of V, loads around L1.
template <typename V>
__device__ __forceinline__ void copy_range(V* dst, const V* src, int64_t lo, int64_t hi) {
  int64_t i = lo + threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < hi; i += kUnroll * kThreads) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcg(src + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) __stcg(dst + i + u * kThreads, v[u]);
  }
  for (; i < hi; i += kThreads) __stcg(dst + i, __ldcg(src + i));
}

// One block of one rank: its byte range of every chunk, through the whole protocol.
template <typename V>
__device__ void ring_rank(const RingTable& table, int n, int rank, int block, int blocks, int64_t chunk,
                          unsigned long long epoch, unsigned long long timeout_ns, int* error) {
  __shared__ int failed;
  const int left = (rank + n - 1) % n;
  const int right = (rank + 1) % n;
  const int64_t flag_offset = static_cast<int64_t>(block) * (n + 1);
  unsigned long long* mine = table.flags[rank] + flag_offset;
  const int64_t span = (chunk + blocks - 1) / blocks;
  const int64_t lo = block * span < chunk ? block * span : chunk;
  const int64_t hi = lo + span < chunk ? lo + span : chunk;
  const V* in = reinterpret_cast<const V*>(table.inputs[rank]);
  V* out = reinterpret_cast<V*>(table.outputs[rank]);
  V* out_right = reinterpret_cast<V*>(table.outputs[right]);

  // 1. Entry barrier: no rank writes into a neighbour that has not entered.
  if (threadIdx.x == 0) {
    failed = 0;
    store_release(table.flags[left] + flag_offset + kFromRight, epoch);
    store_release(table.flags[right] + flag_offset + kFromLeft, epoch);
    if (!wait_flag(mine + kFromLeft, epoch, timeout_ns) || !wait_flag(mine + kFromRight, epoch, timeout_ns)) {
      failed = 1;
      atomicCAS(error, 0, error_code(rank, block, 0));
    }
  }
  __syncthreads();
  if (failed) return;

  // 2. The own chunk lands in its global slot; it is step 0's source.
  copy_range(out + rank * chunk, in, lo, hi);
  __syncthreads();

  // 3. Ring steps, each slot forwarded from the own output into the right
  // neighbour's output at the same slot.
  for (int step = 0; step + 1 < n; ++step) {
    const int64_t slot = static_cast<int64_t>((rank - step + n) % n) * chunk;
    copy_range(out_right + slot, out + slot, lo, hi);
    __syncthreads();
    if (threadIdx.x == 0) {
      fence_system();
      store_release(table.flags[right] + flag_offset + kStep + step, epoch);
      if (!wait_flag(mine + kStep + step, epoch, timeout_ns)) {
        failed = 1;
        atomicCAS(error, 0, error_code(rank, block, 1 + step));
      }
    }
    __syncthreads();
    if (failed) return;
  }
}

// rank >= 0: one launch per rank, block b = blockIdx.x. rank < 0: the whole ring in
// one cooperative launch of n * blocks blocks.
template <typename V>
__global__ void __launch_bounds__(kThreads)
    ring_all_gather_kernel(const __grid_constant__ RingTable table, int n, int rank, int blocks, int64_t chunk,
                           unsigned long long epoch, unsigned long long timeout_ns, int* error) {
  const int r = rank >= 0 ? rank : static_cast<int>(blockIdx.x) / blocks;
  const int b = rank >= 0 ? static_cast<int>(blockIdx.x) : static_cast<int>(blockIdx.x) % blocks;
  ring_rank<V>(table, n, r, b, blocks, chunk, epoch, timeout_ns, error);
}

template <typename V>
cudaError_t launch(const RingTable& table, int n, int rank, int blocks, int64_t chunk_bytes,
                   unsigned long long epoch, unsigned long long timeout_ns, int* error, cudaStream_t stream) {
  int64_t chunk = chunk_bytes / static_cast<int64_t>(sizeof(V));
  if (rank >= 0) {
    ring_all_gather_kernel<V><<<blocks, kThreads, 0, stream>>>(table, n, rank, blocks, chunk, epoch, timeout_ns,
                                                                error);
    return cudaGetLastError();
  }
  void* args[] = {const_cast<RingTable*>(&table), &n, &rank, &blocks, &chunk, &epoch, &timeout_ns, &error};
  const cudaError_t status = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&ring_all_gather_kernel<V>),
                                                         dim3(n * blocks), dim3(kThreads), args, 0, stream);
  return status != cudaSuccess ? status : cudaGetLastError();
}

}  // namespace
}  // namespace conch

// inputs, outputs, flags: host arrays of n device addresses. Rank r's input holds
// chunk_bytes bytes, its output n * chunk_bytes, its flags blocks_per_rank * (n + 1)
// 64-bit words (zero before the first call, never reset). epoch: larger than any
// earlier call's on the same flags. rank: -1 for one cooperative launch of the whole
// ring, else that rank's launch alone. error: one int32, set on a timed-out wait.
extern "C" int conch_ring_all_gather(const void* const* inputs, void* const* outputs, void* const* flags, void* error,
                                     int n, int rank, int64_t chunk_bytes, int blocks_per_rank,
                                     unsigned long long epoch, unsigned long long timeout_ns, void* stream) {
  if (n < 1 || n > conch::kMaxRanks || rank >= n || blocks_per_rank < 1 || chunk_bytes < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (chunk_bytes == 0) return static_cast<int>(cudaSuccess);
  conch::RingTable table = {};
  uintptr_t alignment = static_cast<uintptr_t>(chunk_bytes);
  for (int r = 0; r < n; ++r) {
    table.inputs[r] = static_cast<const unsigned char*>(inputs[r]);
    table.outputs[r] = static_cast<unsigned char*>(outputs[r]);
    table.flags[r] = static_cast<unsigned long long*>(flags[r]);
    alignment |= reinterpret_cast<uintptr_t>(inputs[r]) | reinterpret_cast<uintptr_t>(outputs[r]);
  }
  int* err = static_cast<int*>(error);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t status;
  if (alignment % 16 == 0) {
    status = conch::launch<uint4>(table, n, rank, blocks_per_rank, chunk_bytes, epoch, timeout_ns, err, s);
  } else if (alignment % 8 == 0) {
    status = conch::launch<uint2>(table, n, rank, blocks_per_rank, chunk_bytes, epoch, timeout_ns, err, s);
  } else if (alignment % 4 == 0) {
    status = conch::launch<unsigned int>(table, n, rank, blocks_per_rank, chunk_bytes, epoch, timeout_ns, err, s);
  } else if (alignment % 2 == 0) {
    status = conch::launch<unsigned short>(table, n, rank, blocks_per_rank, chunk_bytes, epoch, timeout_ns, err, s);
  } else {
    status = conch::launch<unsigned char>(table, n, rank, blocks_per_rank, chunk_bytes, epoch, timeout_ns, err, s);
  }
  return static_cast<int>(status);
}
