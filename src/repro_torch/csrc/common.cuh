// Shared pieces of the repro_torch kernels: accumulator types, the launch
// shape, and the error-string export every library carries.
//
// Each kernel source is compiled on its own into a shared library with a
// plain C interface (see repro_torch/kernels/_build.py); every entry point
// returns cudaGetLastError() right after its launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace repro {

constexpr int kThreads = 256;

// Widening load: bf16 inputs accumulate in float, f32/f64 in their own type.
__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ double to_acc(double v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }

// Products rounded on their own, never contracted into an FMA with the
// following subtraction: the elimination then rounds as the plain PyTorch
// version does, step for step.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// Opt in to more than 48 KB of dynamic shared memory where a launch needs it.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// set_smem once per device: `done` is the launching function's own flag
// word (one bit per device), so later launches skip the runtime call.
template <typename Kernel>
inline cudaError_t set_smem_once(std::atomic<uint32_t>& done, Kernel kernel, size_t bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = set_smem(kernel, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// Σ_s ws[s·total + src] over `splits` partials, added in split order, with
// the loads issued eight at a time: a reduce pass's threads wait on one
// round trip per eight partials, not one per partial.
template <typename T>
__device__ __forceinline__ T ordered_split_sum(const T* __restrict__ ws, size_t src, size_t total,
                                               int splits) {
  T sum = ws[src];
  for (int s = 1; s < splits; s += 8) {
    T v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (s + i < splits) v[i] = ws[static_cast<size_t>(s + i) * total + src];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (s + i < splits) sum += v[i];
  }
  return sum;
}

// Grid of a grid-stride pass of kThreads-thread blocks over `total`
// entries (at most 4096 blocks).
inline int stride_blocks(size_t total) {
  const size_t want = (total + kThreads - 1) / kThreads;
  return static_cast<int>(want < 4096 ? want : 4096);
}

// Launch `kernel` as a programmatic dependent of the work before it on
// `stream`: its blocks may start while that work ends, and must wait for it
// (griddepcontrol.wait) before reading what it wrote.
template <typename... Params, typename... Args>
inline cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
