// Launches of a library's kernels as the card ran them, eagerly or
// replayed from a CUDA graph (where no host code runs to count them):
// each counted kernel's first thread of its first CTA adds one to the
// kernel's slot of the source's `g_launches`, which the source's
// `<name>_device_launches` copies out.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void count_launch(unsigned long long* slot) {
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y |
       threadIdx.z) == 0)
    atomicAdd(slot, 1ull);
}

}  // namespace
