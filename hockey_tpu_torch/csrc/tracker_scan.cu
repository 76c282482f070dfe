// The device ByteTrack's batch (hockey_tpu_torch/tracking/device_tracker.py
// `tracker_scan`) as one launch for Hopper (sm_90a): B frames of tracking in
// order, with the auction's `while`, the greedy fill, the Kalman filter,
// births and the duplicate kills inside one block, and no host sync.
//
// It replaces no TPU kernel: the JAX package runs the tracker as XLA ops
// under `lax.scan` (hockey_tpu/tracking/device_tracker.py `tracker_scan`),
// with the auction and the fill as `lax.while_loop`s. In eager PyTorch the
// same step is some 470 launches a frame and one host sync per auction
// round, which kept the fused detect + track step waiting on the host.
//
// What bounds it. Its bytes are the state (~40 KB at T = 128) read and
// written once and 2.5 KB of detections a frame: microseconds at the card's
// memory rate. Its operations are few (a 128 x 64 IoU matrix, a few
// hundred 4x4 solves a batch). The time goes to latency: the frames are a
// recurrence, each frame's associations are sequential, and each auction
// round or fill step is a pair of block barriers around a scan of the
// thread's row of the IoU matrix in shared memory.
//
// What the design does about it. One block of up to 256 threads per batch;
// thread i owns track slot i and keeps its mean, covariance and counters in
// registers for the whole batch. The frame's (T, D) IoU matrix lives in
// shared memory, column-major so that a warp's reads of its rows are
// conflict-free; only the row's own thread ever reads it, so it needs no
// barrier. The benefit matrix of each stage is never stored: an entry is
// the IoU where the row and the column are admissible, else -1e9. A round:
// each bidding row scans its row for its best and second-best value and
// posts (bid, row) to its column with one 64-bit shared atomicMax (the bid
// as an order-preserving integer, the row inverted so that the lowest row
// wins a tie, as torch.argmax's first maximum does); then each column
// seats its winner. The greedy fill takes one step per (row, column) pair
// it assigns, each a shared atomicMax over the rows' cached best entries,
// with three rotating keys so that a step needs one barrier.
//
// Exactness. Every integer and boolean result equals the plain version's:
// this file is compiled with --fmad=false, and each f32 expression repeats
// PyTorch's order of operations (the IoU, xyah, the bids `(p + (v1 - v2)) +
// eps`, the prices, the transition's adds and the noise). The 4x4 solve of
// the filter's update (an LU with partial pivoting here, LAPACK or cuSOLVER
// there) and its products may round otherwise: mean and cov are held to a
// tolerance, not bit for bit.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (hockey_tpu_torch/tracking/scan_kernel.py).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 256;  // one thread per track slot: T <= 256
constexpr float kNeg = -1e9f;     // ops/assignment.py _NEG
constexpr float kIouEps = 1e-7f;  // ops/iou.py EPS
constexpr float kIomEps = 1e-9f;
constexpr float kMinH = 1e-6f;
constexpr float kLowFloor = 0.1f;  // the stage-2 band's floor
// the filter's noise factors as PyTorch rounds the Python doubles
constexpr float kStdPos = (float)(1.0 / 20.0);
constexpr float kStdVel = (float)(1.0 / 160.0);
constexpr float kInitPos = (float)(2.0 * (1.0 / 20.0));
constexpr float kInitVel = (float)(10.0 * (1.0 / 160.0));

// the detections' flag bits
constexpr unsigned kValid = 1u, kHigh = 2u, kLow = 4u, kMid = 8u,
                   kTaken2 = 16u, kTaken = 32u, kNew = 64u;

}  // namespace

// Everything a launch reads and writes; the layout is mirrored by
// scan_kernel.py's ctypes Structure.
struct ScanArgs {
  // state in: (T, 8), (T, 8, 8), (T,) x 9, ()
  const float* mean;
  const float* cov;
  const int* track_id;
  const uint8_t* active;
  const uint8_t* tracked;
  const int* consecutive;
  const uint8_t* activated;
  const int* missed;
  const int* class_id;
  const float* score;
  const int* next_id;
  // detections: (B, D, 4), (B, D), (B, D), (B, D)
  const float* boxes;
  const float* scores;
  const int* classes;
  const uint8_t* valid;
  // state out, same shapes
  float* mean_o;
  float* cov_o;
  int* track_id_o;
  uint8_t* active_o;
  uint8_t* tracked_o;
  int* consecutive_o;
  uint8_t* activated_o;
  int* missed_o;
  int* class_id_o;
  float* score_o;
  int* next_id_o;
  int* det_tid;   // (B, D)
  int* counters;  // [auction rounds, fill steps], added to
  int B, T, D;
  int smem;  // dynamic shared memory bytes: scan_kernel.py smem_bytes(T, D)
  int max_time_lost, min_consecutive, max_rounds;
  int stage3, contain_veto, dup_kill, lost_dup_kill;  // 0 or 1
  float activation_thresh, gate1, gate2, reacquire_floor;
  float veto_iomin, dup_iomin, lost_dup_iomin, eps;
};

namespace {

struct Shared {
  unsigned long long* key;  // (D) the auction's best (bid, row) per column
  float* iou;               // (D, T) column-major: iou[j * T + i]
  float4* tb;               // (T) track boxes, xyxy
  float4* db;               // (D) detection boxes
  float* dscore;            // (D)
  int* dcls;                // (D)
  float* price;             // (D)
  int* owner;               // (D)
  int* order;               // (D) the k-th new detection
  unsigned* dflag;          // (D) kValid ... kNew
  int* calive;              // (D) the fill's columns still open
  int* assign;              // (T)
  int* sid;                 // (T) track ids, for the kills
  int* scls;                // (T) class ids
  unsigned* sflag;          // (T) 1: live/active, 2: tracked and active
  int* rowbest;             // (T) the fill's best column per row
};

__device__ inline size_t round16(size_t n) { return (n + 15) & ~size_t(15); }

// The launch's dynamic shared memory, each array on a 16-byte boundary in
// this order; scan_kernel.py `smem_bytes` sums the same sizes.
__device__ inline Shared carve(unsigned char* p, int T, int D) {
  Shared s;
  auto take = [&p](size_t n) { unsigned char* q = p; p += round16(n); return q; };
  s.key = reinterpret_cast<unsigned long long*>(take(8 * size_t(D)));
  s.iou = reinterpret_cast<float*>(take(4 * size_t(T) * D));
  s.tb = reinterpret_cast<float4*>(take(16 * size_t(T)));
  s.db = reinterpret_cast<float4*>(take(16 * size_t(D)));
  s.dscore = reinterpret_cast<float*>(take(4 * size_t(D)));
  s.dcls = reinterpret_cast<int*>(take(4 * size_t(D)));
  s.price = reinterpret_cast<float*>(take(4 * size_t(D)));
  s.owner = reinterpret_cast<int*>(take(4 * size_t(D)));
  s.order = reinterpret_cast<int*>(take(4 * size_t(D)));
  s.dflag = reinterpret_cast<unsigned*>(take(4 * size_t(D)));
  s.assign = reinterpret_cast<int*>(take(4 * size_t(T)));
  s.sid = reinterpret_cast<int*>(take(4 * size_t(T)));
  s.scls = reinterpret_cast<int*>(take(4 * size_t(T)));
  s.sflag = reinterpret_cast<unsigned*>(take(4 * size_t(T)));
  s.calive = reinterpret_cast<int*>(take(4 * size_t(D)));
  s.rowbest = reinterpret_cast<int*>(take(4 * size_t(T)));
  return s;
}

// An unsigned integer with the order of the float (no NaN comes here).
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
// (value, row) as one key whose maximum is the largest value at the lowest row
__device__ __forceinline__ unsigned long long bid_key(float v, int row) {
  return (static_cast<unsigned long long>(ordered(v)) << 32) |
         static_cast<unsigned>(~row);
}
__device__ __forceinline__ int key_row(unsigned long long k) {
  return static_cast<int>(~static_cast<unsigned>(k));
}

// ops/iou.py box_iou for one pair, in its order
__device__ __forceinline__ float iou_pair(float4 a, float4 b) {
  const float w = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  const float h = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  const float inter = w * h;
  const float aa = fmaxf(a.z - a.x, 0.0f) * fmaxf(a.w - a.y, 0.0f);
  const float ab = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
  return inter / fmaxf((aa + ab) - inter, kIouEps);
}

// device_tracker.py _iomin for one pair
__device__ __forceinline__ float iomin_pair(float4 a, float4 b) {
  const float w = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.0f);
  const float h = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.0f);
  const float inter = w * h;
  const float aa = fmaxf(a.z - a.x, 0.0f) * fmaxf(a.w - a.y, 0.0f);
  const float ab = fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
  return inter / fmaxf(fminf(aa, ab), kIomEps);
}

__device__ __forceinline__ float4 xyah_to_xyxy(const float (&m)[8]) {
  const float w = m[2] * m[3];
  return make_float4(m[0] - w / 2.0f, m[1] - m[3] / 2.0f, m[0] + w / 2.0f,
                     m[1] + m[3] / 2.0f);
}

__device__ __forceinline__ void xyxy_to_xyah(float4 b, float (&z)[4]) {
  const float w = b.z - b.x;
  const float h = fmaxf(b.w - b.y, kMinH);
  z[0] = b.x + w / 2.0f;
  z[1] = b.y + h / 2.0f;
  z[2] = w / h;
  z[3] = h;
}

// _kf_predict: mean F^T, F cov F^T + Q(mean), F as its adds
__device__ __forceinline__ void kf_predict(float (&m)[8], float (&P)[64]) {
  const float h = m[3];
  const float s[8] = {kStdPos * h, kStdPos * h, 0.01f,      kStdPos * h,
                      kStdVel * h, kStdVel * h, 1e-5f, kStdVel * h};
#pragma unroll
  for (int r = 0; r < 4; ++r) m[r] = m[r] + m[r + 4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) P[r * 8 + c] = P[r * 8 + c] + P[(r + 4) * 8 + c];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) P[r * 8 + c] = P[r * 8 + c] + P[r * 8 + c + 4];
#pragma unroll
  for (int k = 0; k < 8; ++k) P[k * 9] = P[k * 9] + s[k] * s[k];
}

// _kf_update: K = P H^T S^-1 by an LU of S^T with partial pivoting, then
// mean + K innov and cov - K (H cov)
__device__ __forceinline__ void kf_update(float (&m)[8], float (&P)[64],
                                          const float (&z)[4]) {
  const float sp = kStdPos * m[3];
  const float r[4] = {sp * sp, sp * sp, 0.1f * 0.1f, sp * sp};
  float A[4][4];  // S^T
  float X[4][8];  // (P H^T)^T, becomes K^T
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      A[a][b] = a == b ? P[b * 8 + a] + r[a] : P[b * 8 + a];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < 8; ++c) X[k][c] = P[c * 8 + k];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int q = k + 1; q < 4; ++q)
      if (fabsf(A[q][k]) > best) { best = fabsf(A[q][k]); p = q; }
#pragma unroll
    for (int q = k + 1; q < 4; ++q) {
      if (q == p) {
#pragma unroll
        for (int c = 0; c < 4; ++c) { const float t = A[k][c]; A[k][c] = A[q][c]; A[q][c] = t; }
#pragma unroll
        for (int c = 0; c < 8; ++c) { const float t = X[k][c]; X[k][c] = X[q][c]; X[q][c] = t; }
      }
    }
    const float inv = 1.0f / A[k][k];
#pragma unroll
    for (int q = k + 1; q < 4; ++q) {
      const float l = A[q][k] * inv;
#pragma unroll
      for (int c = k + 1; c < 4; ++c) A[q][c] = A[q][c] - l * A[k][c];
#pragma unroll
      for (int c = 0; c < 8; ++c) X[q][c] = X[q][c] - l * X[k][c];
    }
  }
#pragma unroll
  for (int k = 3; k >= 0; --k)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float x = X[k][c];
#pragma unroll
      for (int q = k + 1; q < 4; ++q) x = x - A[k][q] * X[q][c];
      X[k][c] = x / A[k][k];
    }
  float innov[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) innov[k] = z[k] - m[k];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    float acc = X[0][a] * innov[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) acc = acc + X[k][a] * innov[k];
    m[a] = m[a] + acc;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float hp[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) hp[k] = P[k * 8 + c];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float acc = X[0][a] * hp[0];
#pragma unroll
      for (int k = 1; k < 4; ++k) acc = acc + X[k][a] * hp[k];
      P[a * 8 + c] = P[a * 8 + c] - acc;
    }
  }
}

// _init_cov and the mean of a new track
__device__ __forceinline__ void kf_init(float (&m)[8], float (&P)[64],
                                        const float (&z)[4]) {
  const float h = z[3];
  const float s[8] = {kInitPos * h, kInitPos * h, 0.01f,         kInitPos * h,
                      kInitVel * h, kInitVel * h, 1e-5f, kInitVel * h};
#pragma unroll
  for (int k = 0; k < 4; ++k) { m[k] = z[k]; m[k + 4] = 0.0f; }
#pragma unroll
  for (int k = 0; k < 64; ++k) P[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) P[k * 9] = s[k] * s[k];
}

// Sum over the block of one int per thread (all threads call it).
__device__ __forceinline__ int block_sum(int v, int* s_warp) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) s_warp[w] = v;
  __syncthreads();
  int total = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) total += s_warp[k];
  __syncthreads();
  return total;
}

// Rank of this thread among the threads whose flag is set, in thread
// order, and their number (all threads call it).
__device__ __forceinline__ int block_rank(bool flag, int* total, int* s_warp) {
  const unsigned b = __ballot_sync(0xffffffffu, flag);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) s_warp[w] = __popc(b);
  __syncthreads();
  int before = 0, all = 0;
  for (int k = 0; k < (int)(blockDim.x >> 5); ++k) {
    const int c = s_warp[k];
    before += k < w ? c : 0;
    all += c;
  }
  __syncthreads();
  *total = all;
  return before + __popc(b & ((1u << lane) - 1u));
}

// ops/assignment.py auction_match over the benefit of rows with `row_ok`
// and columns with flag `col`, then device_tracker.py _match's gate:
// the column of this thread's row, or -1. All threads call it.
__device__ int associate(const Shared& s, int T, int D, bool row_ok,
                         unsigned col, float gate, float eps, int max_rounds,
                         unsigned long long* fkey, int* s_warp, int* rounds,
                         int* fills) {
  const int i = threadIdx.x, nt = blockDim.x;
  const bool mine = i < T;
  int any_col = 0;
  for (int j = i; j < D; j += nt) {
    s.price[j] = 0.0f;
    s.owner[j] = -1;
    s.key[j] = 0ull;
    any_col |= (s.dflag[j] & col) != 0;
  }
  if (mine) s.assign[i] = -1;
  // rows with no admissible column give up before the first round
  bool gave_up = !(__syncthreads_or(any_col) && mine && row_ok);

  int it = 0;
  while (__syncthreads_or(mine && !gave_up && s.assign[i] < 0) && it < max_rounds) {
    if (!gave_up) {
      float v1 = -INFINITY, v2 = -INFINITY;
      int j1 = 0;
      for (int j = 0; j < D; ++j) {
        const float b = (s.dflag[j] & col) ? s.iou[j * T + i] : kNeg;
        const float v = b - s.price[j];
        if (v > v1) { v2 = v1; v1 = v; j1 = j; }
        else if (v > v2) v2 = v;
      }
      const float v2c = fmaxf(v2, 0.0f);  // unmatched is the outside option
      gave_up = v1 <= 0.0f;
      if (!gave_up && s.assign[i] < 0) {
        const float bid = (s.price[j1] + (v1 - v2c)) + eps;
        atomicMax(&s.key[j1], bid_key(bid, i));
      }
    }
    __syncthreads();
    // each column seats its best bidder and evicts its previous owner
    for (int j = i; j < D; j += nt) {
      const unsigned long long k = s.key[j];
      if (k) {
        s.key[j] = 0ull;
        const int r = key_row(k);
        const int o = s.owner[j];
        if (o >= 0) s.assign[o] = -1;
        s.assign[r] = j;
        s.owner[j] = r;
        s.price[j] = unordered(static_cast<unsigned>(k >> 32));
      }
    }
    ++it;
  }

  // the greedy fill: the open rows by the open columns form a rectangle,
  // and each step pairs its largest entry (the lowest row, then the lowest
  // column, of equal ones) and closes that row and column
  bool open_row = mine && row_ok && s.assign[i] < 0;
  int open_cols = 0;
  for (int j = i; j < D; j += nt) {
    const int c = (s.dflag[j] & col) && s.owner[j] < 0;
    s.calive[j] = c;
    open_cols += c;
  }
  if (i < 3) fkey[i] = 0ull;
  const int n_rows = __syncthreads_count(open_row);
  const int n_cols = block_sum(open_cols, s_warp);
  const int n_fill = min(n_rows, n_cols);
  int bj = -1, last = -1;
  float bv = 0.0f;
  for (int step = 0; step < n_fill; ++step) {
    if (i == 0) fkey[(step + 1) % 3] = 0ull;
    if (open_row) {
      if (bj < 0 || bj == last || !s.calive[bj]) {
        bj = -1;
        for (int j = 0; j < D; ++j) {
          if (j == last || !s.calive[j]) continue;
          const float v = s.iou[j * T + i];
          if (bj < 0 || v > bv) { bv = v; bj = j; }
        }
      }
      s.rowbest[i] = bj;
      atomicMax(&fkey[step % 3], bid_key(bv + 0.0f, i));
    }
    __syncthreads();
    const int r = key_row(fkey[step % 3]);
    const int c = s.rowbest[r];
    if (i == r) { s.assign[i] = c; open_row = false; }
    if (i == 0) s.calive[c] = 0;
    last = c;
  }
  __syncthreads();
  if (i == 0) { *rounds += it; *fills += n_fill; }
  int a = mine ? s.assign[i] : -1;
  if (a >= 0 && !(s.iou[a * T + i] >= gate)) a = -1;
  __syncthreads();
  return a;
}

__global__ void __launch_bounds__(kMaxThreads)
    tracker_scan_kernel(const ScanArgs g) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long fkey[3];
  __shared__ int s_warp[32];
  const int T = g.T, D = g.D;
  const Shared s = carve(smem, T, D);
  const int i = threadIdx.x, nt = blockDim.x;
  const bool mine = i < T;

  // this thread's track slot, in registers for the whole batch
  float m[8], P[64];
  int tid = 0, consec = 0, missed = 0, cls = 0;
  bool act = false, trk = false, actv = false;
  float scr = 0.0f;
  if (mine) {
#pragma unroll
    for (int k = 0; k < 8; ++k) m[k] = g.mean[i * 8 + k];
#pragma unroll
    for (int k = 0; k < 64; ++k) P[k] = g.cov[i * 64 + k];
    tid = g.track_id[i];
    act = g.active[i] != 0;
    trk = g.tracked[i] != 0;
    consec = g.consecutive[i];
    actv = g.activated[i] != 0;
    missed = g.missed[i];
    cls = g.class_id[i];
    scr = g.score[i];
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) m[k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 64; ++k) P[k] = 0.0f;
  }
  int next_id = *g.next_id;
  int rounds = 0, fills = 0;

  for (int f = 0; f < g.B; ++f) {
    // the frame's detections and their bands
    for (int j = i; j < D; j += nt) {
      const size_t q = size_t(f) * D + j;
      const float4 b = make_float4(g.boxes[q * 4], g.boxes[q * 4 + 1],
                                   g.boxes[q * 4 + 2], g.boxes[q * 4 + 3]);
      const float sc = g.scores[q];
      const bool v = g.valid[q] != 0;
      const bool high = v && sc >= g.activation_thresh;
      const bool low = v && sc >= kLowFloor && !high;
      s.db[j] = b;
      s.dscore[j] = sc;
      s.dcls[j] = g.classes[q];
      s.dflag[j] = (v ? kValid : 0u) | (high ? kHigh : 0u) | (low ? kLow : 0u);
      g.det_tid[q] = -1;
    }
    // predict every live track
    const bool was_active = act, was_tracked = trk;
    if (mine && act) {
      kf_predict(m, P);
      missed += 1;
    }
    __syncthreads();
    if (mine) {
      const float4 tb = xyah_to_xyxy(m);
      for (int j = 0; j < D; ++j) s.iou[j * T + i] = iou_pair(tb, s.db[j]);
    }

    // stage 1: all live tracks against the high detections
    const int a1 = associate(s, T, D, was_active, kHigh, g.gate1, g.eps,
                             g.max_rounds, fkey, s_warp, &rounds, &fills);
    const bool m1 = a1 >= 0;
    // stage 2: unmatched TRACKED tracks against the low detections
    const int a2 = associate(s, T, D, was_active && was_tracked && !m1, kLow,
                             g.gate2, g.eps, g.max_rounds, fkey, s_warp,
                             &rounds, &fills);
    const bool m2 = a2 >= 0;
    int a3 = -1;
    if (g.stage3) {
      // stage 3: unmatched LOST tracks against sub-threshold detections
      // that stage 2 did not take
      if (m2) s.dflag[a2] |= kTaken2;
      __syncthreads();
      for (int j = i; j < D; j += nt) {
        const unsigned fl = s.dflag[j];
        if ((fl & kValid) && s.dscore[j] >= g.reacquire_floor &&
            !(fl & kHigh) && !(fl & kTaken2))
          s.dflag[j] = fl | kMid;
      }
      __syncthreads();
      a3 = associate(s, T, D, was_active && !was_tracked && !m1, kMid,
                     g.gate2, g.eps, g.max_rounds, fkey, s_warp, &rounds,
                     &fills);
    }
    const bool m3 = a3 >= 0;

    // the matched tracks' update; unmatched tracked become lost, lost
    // expire after the buffer
    const bool matched = m1 || m2 || m3;
    const int di = m1 ? a1 : m2 ? a2 : m3 ? a3 : 0;
    if (matched) {
      float z[4];
      xyxy_to_xyah(s.db[di], z);
      kf_update(m, P, z);
      consec = was_tracked ? consec + 1 : 1;
      scr = s.dscore[di];
      if (m1) cls = s.dcls[di];
      missed = 0;
      s.dflag[di] |= kTaken;
    } else {
      consec = 0;
    }
    trk = matched;
    act = was_active && !(!matched && !was_tracked && missed > g.max_time_lost);
    actv = actv || (matched && consec >= g.min_consecutive);
    __syncthreads();

    // new tracks from unmatched high detections into free slots
    for (int j = i; j < D; j += nt) {
      const unsigned fl = s.dflag[j];
      if ((fl & kHigh) && !(fl & kTaken)) s.dflag[j] = fl | kNew;
    }
    if (g.contain_veto) {
      if (mine) {
        s.tb[i] = xyah_to_xyxy(m);
        s.sflag[i] = act ? 1u : 0u;
        s.scls[i] = cls;
      }
      __syncthreads();
      for (int j = i; j < D; j += nt) {
        if (!(s.dflag[j] & kNew)) continue;
        const float4 b = s.db[j];
        const int c = s.dcls[j];
        bool contained = false;
        for (int t = 0; t < T && !contained; ++t)
          contained = s.sflag[t] && s.scls[t] == c &&
                      iomin_pair(s.tb[t], b) > g.veto_iomin;
        if (contained) s.dflag[j] &= ~kNew;
      }
    }
    __syncthreads();
    // pair the k-th free slot with the k-th new detection
    int n_new = 0;
    for (int base = 0; base < D; base += nt) {
      const int j = base + i;
      const bool nw = j < D && (s.dflag[j] & kNew);
      int chunk;
      const int rank = block_rank(nw, &chunk, s_warp);
      if (nw) s.order[n_new + rank] = j;
      n_new += chunk;
    }
    int n_free;
    const int free_rank = block_rank(mine && !act, &n_free, s_warp);
    const bool takes = mine && !act && free_rank < n_new;
    int born = -1;
    if (takes) {
      born = s.order[free_rank];
      float z[4];
      xyxy_to_xyah(s.db[born], z);
      kf_init(m, P, z);
      tid = next_id + free_rank;
      act = trk = true;
      consec = 1;
      actv = g.min_consecutive <= 1;
      cls = s.dcls[born];
      scr = s.dscore[born];
      missed = 0;
    }
    next_id += n_new;

    if (g.dup_kill || g.lost_dup_kill) {
      if (mine) {
        s.tb[i] = xyah_to_xyxy(m);
        s.sid[i] = tid;
        s.scls[i] = cls;
        s.sflag[i] = act && trk ? 2u : 0u;
      }
      __syncthreads();
      if (g.dup_kill) {
        // one-shot: a live track dies inside any older live same-class one
        bool killed = false;
        if (mine && act && trk) {
          const float4 b = s.tb[i];
          for (int t = 0; t < T && !killed; ++t)
            killed = (s.sflag[t] & 2u) && s.scls[t] == cls && s.sid[t] < tid &&
                     iomin_pair(b, s.tb[t]) > g.dup_iomin;
        }
        __syncthreads();
        if (killed) act = trk = false;
        if (mine) s.sflag[i] = act && trk ? 2u : 0u;
        __syncthreads();
      }
      if (g.lost_dup_kill && mine && act && !trk) {
        // a LOST track dies inside an older TRACKED same-class one
        const float4 b = s.tb[i];
        bool dup = false;
        for (int t = 0; t < T && !dup; ++t)
          dup = (s.sflag[t] & 2u) && s.scls[t] == cls && s.sid[t] < tid &&
                iomin_pair(b, s.tb[t]) > g.lost_dup_iomin;
        if (dup) act = false;
      }
    }

    // each detection's emitted track id (stages and births take disjoint
    // detections, so one pass writes what the plain version's ordered
    // scatters leave)
    __syncthreads();
    if (act && trk && actv) {
      const int j = matched ? di : takes ? born : -1;
      if (j >= 0) g.det_tid[size_t(f) * D + j] = tid;
    }
    __syncthreads();
  }

  if (mine) {
#pragma unroll
    for (int k = 0; k < 8; ++k) g.mean_o[i * 8 + k] = m[k];
#pragma unroll
    for (int k = 0; k < 64; ++k) g.cov_o[i * 64 + k] = P[k];
    g.track_id_o[i] = tid;
    g.active_o[i] = act;
    g.tracked_o[i] = trk;
    g.consecutive_o[i] = consec;
    g.activated_o[i] = actv;
    g.missed_o[i] = missed;
    g.class_id_o[i] = cls;
    g.score_o[i] = scr;
  }
  if (i == 0) {
    *g.next_id_o = next_id;
    atomicAdd(&g.counters[0], rounds);
    atomicAdd(&g.counters[1], fills);
  }
}

}  // namespace

// One launch over args->B frames on `stream` of CUDA device `device`.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int tracker_scan(const ScanArgs* args, int device, void* stream) {
  const ScanArgs& a = *args;
  if (a.B <= 0) return 0;
  if (a.T <= 0 || a.T > kMaxThreads || a.D <= 0 || a.smem <= 0)
    return (int)cudaErrorInvalidValue;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const int smem = a.smem;
  int threads = a.T > a.D ? a.T : a.D;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  // opt in to shared memory above 48 KB, to the most a launch on this
  // device has needed so far
  static std::atomic<int> opted[64];
  if (smem > 48 * 1024 && (device >= 64 || opted[device].load() < smem)) {
    err = cudaFuncSetAttribute(tracker_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err == cudaSuccess && device < 64) opted[device].store(smem);
  }
  if (err == cudaSuccess) {
    tracker_scan_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(a);
    err = cudaGetLastError();
  }
  if (current != device) {
    const cudaError_t restore = cudaSetDevice(current);
    if (err == cudaSuccess) err = restore;
  }
  return (int)err;
}
