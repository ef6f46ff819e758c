// The card's limits that the launch plans (ops/cuda_*.py) are laid over,
// read through the CUDA runtime: ops/_build.py `card_limits`.
#include <cuda_runtime.h>

// The current device's SMs and the bytes of shared memory a block can opt in
// to. Returns the first CUDA error, or 0.
extern "C" int device_limits(int* sms, int* smem_per_block) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}
