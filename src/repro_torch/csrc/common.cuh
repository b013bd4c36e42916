// Shared helpers for the port's CUDA kernels.
//
// Every kernel source is compiled on its own into a shared library with a
// plain C interface (see repro_torch/kernels/cuda.py): pointers arrive as
// integers from torch's data_ptr(), the stream from torch's current stream,
// and each launcher returns the cudaError_t of its launch so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define REPRO_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes shared with the Python wrappers
enum { REPRO_F32 = 0, REPRO_BF16 = 1 };

namespace repro {

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) { return __bfloat162float(v); }

// round-to-nearest-even, as torch's .to(bfloat16) and XLA's convert
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

}  // namespace repro

// cudaSetDevice for the caller's device: the static runtime inside each
// library keeps its own current-device state, separate from torch's.
#define REPRO_SET_DEVICE(dev)                   \
  do {                                          \
    cudaError_t _e = cudaSetDevice(dev);        \
    if (_e != cudaSuccess) return (int)_e;      \
  } while (0)

REPRO_EXPORT const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
