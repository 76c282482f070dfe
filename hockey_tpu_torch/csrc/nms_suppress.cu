// Greedy NMS suppression for Hopper (sm_90a): a walk over the survivors
// only, through a suppression bitmask held in shared memory.
//
// Replaces the Pallas TPU kernel `_suppress_kernel` / `suppress_pallas`
// (hockey_tpu/ops/pallas/nms_kernel.py). Same kept set as
// hockey_tpu/ops/nms.py:_suppress_exact: for i = 0..K-1 over score-sorted
// candidates, if keep[i], clear every keep[j], j > i, with M[i, j] > thr.
//
// What bounds it. The bytes it must move are the tails M[i, i+1:] of the
// kept rows, keep0 and keep: about 77 KB for a batch of 8 frames at K = 256
// on the detect path, some 23 ns at the card's memory rate. The time goes
// to latency instead: the greedy recurrence is serial (candidate i's fate
// depends on every kept candidate above it), and a serial step that has to
// wait on a load from device memory costs a memory latency each.
//
// What the design does about it. One cluster of 8 blocks of 256 threads
// per frame (the blocks of a cluster run at once, one per SM, and can
// write each other's shared memory), in three phases:
//
//  A (parallel, the whole cluster). The first block of the cluster, the
//    leader, packs keep0 with one ballot per word into K/32 words of 32
//    bits. The cluster's 64 warps take the rows i = g + 64r of the valid
//    candidates (g: the warp's index in the cluster); a row of an invalid
//    candidate is never read, since that candidate can never suppress
//    anything. A warp loads the columns above the diagonal of up to 4
//    rows (1 above K = 256) before it uses any of them, in coalesced
//    128-byte segments of one 32-column word each, compares them with thr
//    and packs each word with one ballot into the suppression bitmask,
//    which it stores straight into the leader's shared memory (K*K/8
//    bytes: 8 KiB at K = 256, 128 KiB at K = 1024, dynamic shared memory
//    above 48 KB). Spread over 8 SMs, this phase waits about two memory
//    latencies (keep0, then the rows) plus a cluster barrier; on one SM it
//    was bound by the issue of the loads, compares and ballots of all of
//    a frame's rows.
//  B (serial, one thread of the leader, no barrier, no device-memory
//    load). The thread holds the alive words in registers and goes
//    through them in order (the loop over words is unrolled, so no
//    register is indexed at run time). Its first alive candidate i
//    survives, since every kept candidate above it has already been
//    applied; the thread reads mask row i from shared memory and clears
//    the words from i's on. One step per kept candidate, not one per
//    candidate, and no warp-wide instruction in the chain from one step
//    to the next.
//  C (parallel, the leader). The kept bits are written out as (B, K)
//    bytes.
//
// The kernel only compares, so it equals the plain version bit for bit
// (NaN > thr is false in both).
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (hockey_tpu_torch/ops/nms_kernel.py).

#include <atomic>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 1024;
constexpr int kCluster = 8;  // blocks per frame
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFrameWarps = kCluster * kWarps;  // 32 * 64 >= kMaxK rows
constexpr size_t kMaxMaskBytes = size_t(kMaxK) * (kMaxK / 32) * 4;
constexpr size_t kStaticSmemLimit = 48 * 1024;
constexpr uint32_t kFull = 0xffffffffu;

// A thread's arrival at, and wait on, the cluster barrier: between the
// two, every block of the cluster has started, so its shared memory may be
// written by the others.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Word `lane` of mask rows idx[0..kRows) (idx < 0: no row, and none
// after it): bit b set iff M[i, 32 * lane + b] > thr and i < 32 * lane + b
// < K. Called by a whole warp: lane l loads column 32w + l of word w, so
// each load of the warp is one coalesced 128-byte row segment and one
// ballot packs it. All loads of the kRows rows are issued before the first
// is used; a column at or below the diagonal is not loaded.
template <int kWords, int kRows>
__device__ __forceinline__ void mask_words(const float* __restrict__ mb,
                                           const int (&idx)[kRows], int K,
                                           float thr, int lane,
                                           uint32_t (&word)[kRows]) {
  const int W = (K + 31) >> 5;
  float v[kRows][kWords];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float* row = mb + (size_t)max(idx[r], 0) * K + lane;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int col = 32 * w + lane;
      v[r][w] = idx[r] >= 0 && col > idx[r] && col < K
                    ? __ldg(row + 32 * w)
                    : __int_as_float(0x7fc00000);  // NaN: never > thr
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    word[r] = 0;
    if (idx[r] < 0) break;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      if (w >= W) break;
      const uint32_t b = __ballot_sync(kFull, v[r][w] > thr);
      if (lane == w) word[r] = b;
    }
  }
}

// Phase B: the greedy walk over the alive words s_words[0..W), one thread;
// leaves the kept set in s_words. K <= 32 * kWords.
template <int kWords>
__device__ __forceinline__ void walk(const uint32_t* __restrict__ s_mask,
                                     uint32_t* __restrict__ s_words, int W) {
  uint32_t live[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) live[w] = w < W ? s_words[w] : 0u;
#pragma unroll
  for (int w = 0; w < kWords; ++w) {
    uint32_t kept = 0;
    while (live[w]) {
      const uint32_t bit = live[w] & (0u - live[w]);  // first alive: kept
      const uint32_t* row = s_mask + (32 * w + 31 - __clz(bit)) * W;
      kept |= bit;
      live[w] &= ~(bit | row[w]);
#pragma unroll
      for (int l = w + 1; l < kWords; ++l)
        if (l < W) live[l] &= ~row[l];
    }
    if (w < W) s_words[w] = kept;
  }
}

template <int kWords>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    nms_suppress_kernel(const float* __restrict__ m,
                        const uint8_t* __restrict__ keep0,
                        uint8_t* __restrict__ keep, int K, float thr) {
  constexpr int kRows = 32 / kWords;  // rows in flight: 32 loads a lane
  extern __shared__ uint32_t s_mask[];  // (K, W) suppression bits
  __shared__ uint32_t s_words[32];      // keep0, then the kept set, as bits
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  uint32_t* mask = cluster.map_shared_rank(s_mask, 0);  // the leader's
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int W = (K + 31) >> 5;
  const size_t frame = blockIdx.x / kCluster;
  const float* mb = m + frame * K * K;
  const uint8_t* k0 = keep0 + frame * K;
  cluster_arrive_relaxed();

  // A: keep0 as bits in the leader, and the mask rows of this warp's
  // valid rows i = g + 64r (as bits r), in groups of kRows, into the
  // leader's shared memory
  if (rank == 0) {
    for (int w = warp; w < W; w += kWarps) {
      const int c = 32 * w + lane;
      const uint32_t b = __ballot_sync(kFull, c < K && k0[c] != 0);
      if (lane == 0) s_words[w] = b;
    }
  }
  const int g = rank * kWarps + warp;
  const int mine = g + kFrameWarps * lane;
  uint32_t rows = __ballot_sync(kFull, mine < K && k0[mine] != 0);
  cluster_wait();  // the leader has started: its shared memory is writable
  while (rows) {
    int idx[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      idx[r] = rows ? g + kFrameWarps * (__ffs(rows) - 1) : -1;
      rows &= rows - 1u;
    }
    uint32_t word[kRows];
    mask_words<kWords, kRows>(mb, idx, K, thr, lane, word);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (idx[r] >= 0 && lane < W) mask[idx[r] * W + lane] = word[r];
  }
  cluster.sync();  // the leader's bitmask is complete and visible
  if (rank != 0) return;

  // B: one step per kept candidate, one thread
  if (t == 0) walk<kWords>(s_mask, s_words, W);
  __syncthreads();

  // C: the kept set as bytes
  for (int c = t; c < K; c += kThreads)
    keep[frame * K + c] = (s_words[c >> 5] >> (c & 31)) & 1u;
}

// The instance for K: 8 words of walk registers up to K = 256 (the detect
// path), else 32.
cudaError_t launch(const float* m, const uint8_t* keep0, uint8_t* keep, int B,
                   int K, float thr, int device, cudaStream_t stream) {
  const size_t smem = size_t(K) * ((K + 31) / 32) * sizeof(uint32_t);
  if (K <= 256) {
    nms_suppress_kernel<8><<<B * kCluster, kThreads, smem, stream>>>(
        m, keep0, keep, K, thr);
    return cudaGetLastError();
  }
  if (smem > kStaticSmemLimit) {
    // opt in to the large dynamic shared memory once per device
    static std::atomic<unsigned long long> opted{0};
    const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
    if (!(opted.load() & bit)) {
      const cudaError_t err = cudaFuncSetAttribute(
          nms_suppress_kernel<32>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)kMaxMaskBytes);
      if (err != cudaSuccess) return err;
      opted.fetch_or(bit);
    }
  }
  nms_suppress_kernel<32><<<B * kCluster, kThreads, smem, stream>>>(
      m, keep0, keep, K, thr);
  return cudaGetLastError();
}

}  // namespace

// m: (B, K, K) f32, keep0/keep: (B, K) bytes in {0, 1}, all on CUDA device
// `device`; launches on `stream`. Returns the cudaError_t of the launch
// (0 = success).
extern "C" int nms_suppress(const float* m, const uint8_t* keep0,
                            uint8_t* keep, int B, int K, float thr,
                            int device, void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: make the tensors' device
  // current for the launch when it is not, and restore the caller's after
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  err = launch(m, keep0, keep, B, K, thr, device, (cudaStream_t)stream);
  if (current != device) {
    const cudaError_t restore = cudaSetDevice(current);
    if (err == cudaSuccess) err = restore;
  }
  return (int)err;
}
