// The epilogue of an inference convolution for Hopper (sm_90a): the folded
// bias, SiLU and a bottleneck's residual in one pass over the conv's
// output, in place:
//
//   y = [residual +] [silu](y [+ bias])
//
// Replaces no TPU kernel: the JAX package leaves the conv and its epilogue
// to XLA, which fuses them. On the card PyTorch's cuDNN route runs the
// epilogue as up to three passes after the conv: the bias as a broadcast
// `add_` over the output (which a (1, C, 1, 1) bias over channels_last
// memory keeps off the vectorised elementwise kernel), `F.silu`, and the
// bottleneck's `x + y`. This kernel reads the output once, the residual
// once where there is one, and writes the output once.
//
// Arithmetic. Each step is the plain version's, rounded where it rounds:
// the bias sum in f32, rounded to the working dtype; SiLU in f32 as
// v / (1 + expf(-v)), rounded; the residual added in f32, rounded. Built
// without fast math, the result is bit-equal to the three passes.
//
// What bounds it: its bytes. y is read and written once, the residual
// read once, the bias (C elements) stays in cache: 2|y| + |residual| bytes
// at the card's 3.35 TB/s (ops/conv_epilogue.py `bound_bytes`).
//
// Layout. The output is seen as `rows` rows of `len` contiguous elements,
// a channel being a run of `run` elements in a row: channels_last memory
// is a row per pixel, len = C and run = 1; NCHW memory is a row per image,
// len = C*H*W and run = H*W. The residual has the same rows, `pitch`
// elements apart, so a C2f's `chunk` view (pitch 2C, offset C) is read in
// place.
//
// Design. One thread moves one vector: 16 bytes (8 bf16 or f16, 4 f32)
// where every row, run and the pitch hold whole vectors and the pointers
// are 16-byte aligned, one element otherwise (the wrapper decides from the
// shape). A channels_last vector spans V channels, whose biases are one
// vector load; an NCHW vector lies in one channel. Row and channel come
// from 32-bit divisions by invariants (multiply-high and shift), so the
// entry refuses an output of 2^31 elements or more (the largest of any
// served forward, the stem's at 8 x 736x1280, holds 121M). The SiLU's expf and IEEE division cost about as many instructions
// as the card can execute while its memory moves the bytes, so the most
// warps an SM holds overlap the two best: on an NVIDIA H100 80GB HBM3,
// over the 103 epilogues of a YOLOv8x forward at 8 x 736x1280, one vector
// a thread took 2.74-2.75 ms, two 2.85-2.87 ms and four 3.57 ms (fewer
// warps resident), against a bound of 2.20 ms.
//
// Plain C interface, built with nvcc into a shared library and called
// through ctypes (hockey_tpu_torch/ops/conv_epilogue.py).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxElems = 0x7fffffff;  // of an output

// n / d for n < 2^31 and 1 <= d < 2^31 by a multiply-high and a shift
// (Granlund and Montgomery).
struct FastDiv {
  uint32_t d, m, s;
};

FastDiv fast_div(uint32_t d) {
  uint32_t s = 0;
  while ((uint64_t(1) << s) < d) ++s;
  const uint64_t m = ((uint64_t(1) << 32) * ((uint64_t(1) << s) - d)) / d + 1;
  return {d, uint32_t(m), s};
}

__device__ __forceinline__ uint32_t divide(uint32_t n, const FastDiv& f) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

template <typename T>
struct Num;
template <>
struct Num<float> {
  __device__ static float in(float x) { return x; }
  __device__ static float out(float x) { return x; }
};
template <>
struct Num<__nv_bfloat16> {
  __device__ static float in(__nv_bfloat16 x) { return __bfloat162float(x); }
  __device__ static __nv_bfloat16 out(float x) { return __float2bfloat16_rn(x); }
};
template <>
struct Num<__half> {
  __device__ static float in(__half x) { return __half2float(x); }
  __device__ static __half out(float x) { return __float2half_rn(x); }
};

// v rounded to T and back: what storing a result of the plain version
// and reading it again gives
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return Num<T>::in(Num<T>::out(v));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T x[V];
};

struct Params {
  void* y;
  const void* bias;  // null: no bias
  const void* res;   // null: no residual
  uint32_t nvec;     // vectors of this launch
  FastDiv row;       // vectors per row
  FastDiv chan;      // vectors per channel run (run > 1 only)
  uint32_t pitch;    // residual row pitch, elements
  int act;           // apply SiLU
  int channel_runs;  // run > 1: a vector lies in one channel
};

template <typename T, int V, bool RES>
__global__ void __launch_bounds__(kThreads)
    conv_epilogue_kernel(const Params p) {
  using VT = Vec<T, V>;
  const uint32_t v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= p.nvec) return;
  VT* y = static_cast<VT*>(p.y) + v;
  const T* bias = static_cast<const T*>(p.bias);
  const uint32_t r = divide(v, p.row);
  const uint32_t col = v - r * p.row.d;  // the vector's place in its row
  VT yv = *y, rv;
  if (RES)
    rv = *reinterpret_cast<const VT*>(static_cast<const T*>(p.res) +
                                      size_t(r) * p.pitch + size_t(col) * V);
  VT b;
  if (bias) {
    if (p.channel_runs) {
      const T bc = bias[divide(col, p.chan)];
#pragma unroll
      for (int i = 0; i < V; ++i) b.x[i] = bc;
    } else {
      b = *reinterpret_cast<const VT*>(bias + size_t(col) * V);
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float x = Num<T>::in(yv.x[i]);
    if (bias) x = rounded<T>(x + Num<T>::in(b.x[i]));
    if (p.act) x = rounded<T>(x / (1.0f + expf(-x)));
    if (RES) x = Num<T>::in(rv.x[i]) + x;
    yv.x[i] = Num<T>::out(x);
  }
  *y = yv;
}

template <typename T, int V>
cudaError_t launch_vectors(void* y, const void* res, const void* bias,
                           int64_t rows, int64_t len, int64_t run,
                           int64_t pitch, int act, cudaStream_t stream) {
  Params p{};
  p.y = y;
  p.bias = bias;
  p.res = res;
  p.nvec = uint32_t(rows * len / V);
  p.row = fast_div(uint32_t(len / V));
  p.channel_runs = run > 1;
  p.chan = fast_div(uint32_t(run > 1 ? run / V : 1));
  p.pitch = uint32_t(pitch);
  p.act = act;
  const unsigned grid = (p.nvec + kThreads - 1) / kThreads;
  if (res)
    conv_epilogue_kernel<T, V, true><<<grid, kThreads, 0, stream>>>(p);
  else
    conv_epilogue_kernel<T, V, false><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(void* y, const void* bias, const void* res, int64_t rows,
                   int64_t len, int64_t run, int64_t pitch, int act, int vec,
                   cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (!vec)
    return launch_vectors<T, 1>(y, res, bias, rows, len, run, pitch, act, stream);
  const auto misaligned = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) != 0;
  };
  if (len % V || (run > 1 && run % V) || (res && pitch % V) || misaligned(y) ||
      misaligned(bias) || misaligned(res))
    return cudaErrorMisalignedAddress;
  return launch_vectors<T, V>(y, res, bias, rows, len, run, pitch, act, stream);
}

}  // namespace

// y: `rows` rows of `len` elements, contiguous, on CUDA device `device`;
// a channel is a run of `run` elements of a row (1: channels_last; H*W:
// NCHW), so C = len / run; bias: C elements or null; res: rows of `len`
// elements `pitch` apart, or null; dtype 0 f32, 1 bf16, 2 f16; act: SiLU;
// vec: 16-byte vectors (the wrapper checks that the shape allows them).
// Launches on `stream`; returns the cudaError_t of the launch (0 =
// success). An output of 2^31 elements or more is refused.
extern "C" int conv_epilogue(void* y, const void* bias, const void* res,
                             int dtype, int64_t rows, int64_t len, int64_t run,
                             int64_t pitch, int act, int vec, int device,
                             void* stream) {
  if (rows <= 0 || len <= 0) return 0;
  if (rows > kMaxElems / len || run <= 0 || len % run ||
      (res && (pitch < len || pitch > 0xffffffffLL)) ||
      dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  // this library carries its own CUDA runtime: make the tensors' device
  // current for the launch when it is not, and restore the caller's after
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess)
    return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    err = launch<float>(y, bias, res, rows, len, run, pitch, act, vec, s);
  else if (dtype == 1)
    err = launch<__nv_bfloat16>(y, bias, res, rows, len, run, pitch, act, vec, s);
  else
    err = launch<__half>(y, bias, res, rows, len, run, pitch, act, vec, s);
  if (current != device) {
    const cudaError_t restore = cudaSetDevice(current);
    if (err == cudaSuccess) err = restore;
  }
  return (int)err;
}
