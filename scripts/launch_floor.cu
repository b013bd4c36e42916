// An empty kernel, one block of 256 threads (the geometry of K2's one-block
// launch): the launch floor that scripts/decode_attention_ab.py times in the
// same CUDA-graph harness as the port's kernels.  Built by that script with
// the port's nvcc flags into build/.
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" __attribute__((visibility("default"))) int launch_floor(void* stream) {
  empty_kernel<<<1, 256, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
