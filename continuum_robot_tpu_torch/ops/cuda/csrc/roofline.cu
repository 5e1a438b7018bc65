// fma_chain: the float32 FMA-issue probe of utils/roofline.py (measure_vpu_ceiling).
//
// Replaces no TPU kernel. The JAX package measures its elementwise ceiling with a
// 256-long dependent chain y <- y*y + eps that XLA fuses into one pass over the
// array (continuum_robot_tpu/utils/roofline.py, measure_vpu_ceiling). Eager PyTorch
// would run that chain as 512 separate passes over device memory and measure the
// memory, not the FP32 units, so the chain is this kernel: each element is loaded
// once, run through `chain` dependent __fmaf_rn in registers, and stored once.
//
// Bound: operations. At chain = 256 an element costs 512 FLOPs (an FMA counted as
// two, the JAX module's convention) against 8 bytes moved, 64 FLOPs a byte, far
// above the H100's knee of 67e12 / 3.35e12 = 20 FLOPs a byte. Design: a thread owns
// four neighbouring elements (one 16-byte load and store) and runs their four chains
// interleaved, so each warp has four independent FMAs in flight per link and the
// 4-cycle FMA latency hides behind the other chains and the other resident warps.
// A grid-stride loop covers any n; a tail of n % 4 elements goes one element a
// thread.
//
// Rounding: __fmaf_rn rounds each link once; utils/roofline.fma_chain_plain rounds
// each link once too (ops/cuda/modal_rollout.madd), so kernel and twin agree bit for
// bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// x and y may be the same array (in place): each element is read and written by one
// thread only, so neither pointer is __restrict__.
__global__ void fma_chain_kernel(int64_t n, int chain, float eps, const float* x, float* y) {
  const int64_t n4 = n / 4;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t i = first; i < n4; i += stride) {
    float4 v = reinterpret_cast<const float4*>(x)[i];
    for (int k = 0; k < chain; ++k) {
      v.x = __fmaf_rn(v.x, v.x, eps);
      v.y = __fmaf_rn(v.y, v.y, eps);
      v.z = __fmaf_rn(v.z, v.z, eps);
      v.w = __fmaf_rn(v.w, v.w, eps);
    }
    reinterpret_cast<float4*>(y)[i] = v;
  }
  for (int64_t i = 4 * n4 + first; i < n; i += stride) {
    float v = x[i];
    for (int k = 0; k < chain; ++k) v = __fmaf_rn(v, v, eps);
    y[i] = v;
  }
}

}  // namespace

extern "C" {

// y[i] = chain links of v <- fma(v, v, eps) from v = x[i], for n float32 elements;
// x and y 16-byte aligned (y may be x). Returns the cudaError_t of the launch.
int fma_chain_launch(int64_t n, int chain, float eps, const void* x, void* y, void* stream) {
  if (n <= 0) return 0;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t items = (n + 3) / 4;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(sms) * 8;  // 8 blocks of 256 an SM: full occupancy
  if (blocks > cap) blocks = cap;
  fma_chain_kernel<<<static_cast<int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, chain, eps, static_cast<const float*>(x), static_cast<float*>(y));
  return static_cast<int>(cudaGetLastError());
}

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
