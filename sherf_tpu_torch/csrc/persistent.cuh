// Sizing of a persistent grid, shared by the kernels that take their tiles
// from a counter (nn_1 and ray_body_mask in knn.cu, compact_mask in
// compaction.cu).  Host code only; asked on every call, cached nowhere.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>

// As many blocks of `kernel` (with `threads` threads and `smem` bytes of
// dynamic shared memory) as the current device holds at once, and no more
// than there are tiles.
template <typename K>
static cudaError_t persistent_blocks(K kernel, int threads, int smem,
                                     int tiles, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  *blocks = std::max(1, std::min(tiles, sms * std::max(per_sm, 1)));
  return err;
}
