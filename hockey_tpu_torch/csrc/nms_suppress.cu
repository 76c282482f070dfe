// Greedy NMS suppression for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_suppress_kernel` / `suppress_pallas`
// (hockey_tpu/ops/pallas/nms_kernel.py). Same kept set as
// hockey_tpu/ops/nms.py:_suppress_exact: for i = 0..K-1 over score-sorted
// candidates, if keep[i], clear every keep[j], j > i, with M[i, j] > thr.
//
// Design: one block per frame, one thread per candidate column (K <= 1024).
// The keep vector lives in shared memory; each step reads keep[i] (uniform
// across the block, so no divergence), and only when it is set reads row i
// of M from global memory, coalesced, and clears the suppressed columns.
// A block barrier separates the steps.
//
// Bound: K dependent steps, each ending in a block barrier, so the kernel is
// latency-bound (about K barrier round trips plus one global row load per
// kept candidate), not bandwidth-bound: at B = 8, K = 256 it touches at most
// B*K*K*4 = 2 MiB, which the card moves in under a microsecond. The matrix
// is not staged in shared memory: 256x256 f32 is 256 KiB, over the 227 KB a
// block may hold.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (hockey_tpu_torch/ops/nms_kernel.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 1024;

__global__ void nms_suppress_kernel(const float* __restrict__ m,
                                    const uint8_t* __restrict__ keep0,
                                    uint8_t* __restrict__ keep, int K,
                                    float thr) {
  __shared__ uint8_t s_keep[kMaxK];
  const int j = threadIdx.x;
  const size_t frame = blockIdx.x;
  const float* mb = m + frame * (size_t)K * (size_t)K;
  if (j < K) s_keep[j] = keep0[frame * K + j] ? 1 : 0;
  __syncthreads();
  for (int i = 0; i < K; ++i) {
    // keep[i] is final here: only steps i' < i could clear it
    if (s_keep[i] && j > i && j < K && mb[(size_t)i * K + j] > thr) {
      s_keep[j] = 0;
    }
    __syncthreads();
  }
  if (j < K) keep[frame * K + j] = s_keep[j];
}

}  // namespace

// m: (B, K, K) f32, keep0/keep: (B, K) bytes in {0, 1}, all on one device;
// launches on `stream`. Returns the cudaError_t of the launch (0 = success).
extern "C" int nms_suppress(const float* m, const uint8_t* keep0,
                            uint8_t* keep, int B, int K, float thr,
                            void* stream) {
  if (B <= 0 || K <= 0) return 0;
  if (K > kMaxK) return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: make the tensors' device
  // current for it before launching
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, m);
  if (err != cudaSuccess) return (int)err;
  err = cudaSetDevice(attr.device);
  if (err != cudaSuccess) return (int)err;
  const int threads = (K + 31) / 32 * 32;
  nms_suppress_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(m, keep0, keep,
                                                               K, thr);
  return (int)cudaGetLastError();
}
