// Stream compaction for Hopper (sm_90a): compact_mask.
//
// Replaces the Pallas kernel _kernel / compact_mask
// (sherf_tpu/kernels/compaction.py:41, :107): the positions of the first
// `cap` true entries of a bool mask of length n, in ascending order; the
// tail beyond the survivors is filled with the sentinel n, and valid[p] is
// idx[p] < n, so valid is a prefix.
//
// The Pallas kernel writes each block's run at its offset and relies on the
// TPU grid running blocks in order, so that each block overwrites the
// previous block's padded tail.  Blocks on a GPU run in no order, so this
// version makes the order explicit in three passes:
//   1. cm_count:   per block of 8192 entries, the survivor count
//                  (__ballot_sync + __popc per 32-entry warp step);
//   2. cm_scan:    one block turns the block counts into exclusive offsets
//                  and the total;
//   3. cm_scatter: each block recounts per warp, takes its warps' offsets
//                  from a shared-memory prefix, and writes every survivor
//                  at offset + popc(ballot & lanes below), so each warp
//                  writes its survivors in ascending order; positions at or
//                  beyond `cap` are dropped, and the tail [min(total, cap),
//                  cap) is filled with (n, false).
//
// What bounds it on an H100: bytes.  The function must read n mask bytes
// and write cap * 5 bytes (int32 index + bool valid); the kernel reads the
// mask twice (passes 1 and 3).  At n = 12.6M that is tens of microseconds
// at 3.35 TB/s; a first version reads one byte per lane per step, which
// leaves most of each 32-byte sector's bandwidth unused — a wider load is
// work for a later change.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 32;                   // 32-entry steps per warp
constexpr int kWarpSpan = 32 * kSteps;       // 1024 entries per warp
constexpr int kTile = kWarps * kWarpSpan;    // 8192 entries per block
constexpr int kScanThreads = 1024;

__device__ __forceinline__ int warp_count(const unsigned char* __restrict__ mask,
                                          long long base, int n, int lane) {
  int c = 0;
  for (int s = 0; s < kSteps; ++s) {
    const long long i = base + s * 32 + lane;
    const int m = (i < n) ? (mask[i] != 0) : 0;
    c += __popc(__ballot_sync(0xffffffffu, m));
  }
  return c;
}

__global__ void __launch_bounds__(kThreads)
cm_count(const unsigned char* __restrict__ mask, int n, int* __restrict__ counts) {
  __shared__ int wsum[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * kTile
      + warp * kWarpSpan;
  const int c = warp_count(mask, base, n, lane);
  if (lane == 0) wsum[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kWarps; ++w) s += wsum[w];
    counts[blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kScanThreads)
cm_scan(const int* __restrict__ counts, int nblk, int* __restrict__ offs,
        int* __restrict__ total) {
  __shared__ int part[kScanThreads];
  const int t = threadIdx.x;
  const int per = (nblk + kScanThreads - 1) / kScanThreads;
  const int lo = min(t * per, nblk), hi = min(lo + per, nblk);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += counts[i];
  part[t] = s;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {
    const int add = (t >= off) ? part[t - off] : 0;
    __syncthreads();
    part[t] += add;
    __syncthreads();
  }
  int run = part[t] - s;
  for (int i = lo; i < hi; ++i) {
    offs[i] = run;
    run += counts[i];
  }
  if (t == kScanThreads - 1) *total = part[t];
}

__global__ void __launch_bounds__(kThreads)
cm_scatter(const unsigned char* __restrict__ mask, int n, int cap,
           const int* __restrict__ offs, const int* __restrict__ total,
           int* __restrict__ idx, unsigned char* __restrict__ valid) {
  __shared__ int wsum[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long base = static_cast<long long>(blockIdx.x) * kTile
      + warp * kWarpSpan;
  const int c = warp_count(mask, base, n, lane);
  if (lane == 0) wsum[warp] = c;
  __syncthreads();
  int pos = offs[blockIdx.x];
  for (int w = 0; w < warp; ++w) pos += wsum[w];
  const unsigned below = (1u << lane) - 1u;
  for (int s = 0; s < kSteps && pos < cap; ++s) {
    const long long i = base + s * 32 + lane;
    const int m = (i < n) ? (mask[i] != 0) : 0;
    const unsigned b = __ballot_sync(0xffffffffu, m);
    if (m) {
      const int p = pos + __popc(b & below);
      if (p < cap) {
        idx[p] = static_cast<int>(i);
        valid[p] = 1;
      }
    }
    pos += __popc(b);
  }
  const int kept = min(*total, cap);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long p = kept + static_cast<long long>(blockIdx.x) * blockDim.x
           + threadIdx.x; p < cap; p += stride) {
    idx[p] = n;
    valid[p] = 0;
  }
}

}  // namespace

extern "C" {

int sherf_compact_tile() { return kTile; }

// scratch: counts and offs hold ceil(n / tile) ints each, total one int.
int sherf_compact_mask(const unsigned char* mask, int n, int cap, int* idx,
                       unsigned char* valid, int* counts, int* offs,
                       int* total, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (n + kTile - 1) / kTile;
  cm_count<<<nblk, kThreads, 0, s>>>(mask, n, counts);
  cm_scan<<<1, kScanThreads, 0, s>>>(counts, nblk, offs, total);
  cm_scatter<<<nblk, kThreads, 0, s>>>(mask, n, cap, offs, total, idx, valid);
  return cudaGetLastError();
}

}  // extern "C"
