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
// kernel orders the tiles itself, in one launch: a single-pass scan with
// decoupled look-back (Merrill and Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016).
//   * Persistent blocks take tiles of 4096 mask bytes from an atomic
//     counter, so every tile before a block's tile has already been taken
//     by a running block.  Each thread reads its 16 bytes with one 16-byte
//     load.
//   * A tile publishes its survivor count (flag AGGREGATE); one warp then
//     looks back over the predecessors' words, 32 at a time, adding
//     aggregates until it meets an INCLUSIVE prefix, and publishes the
//     tile's own inclusive prefix.  Meanwhile the tile's survivors are
//     packed in ascending order in shared memory (per-thread counts
//     scanned across the block); they are then copied out, coalesced, at
//     the tile's offset.  Positions at or beyond `cap` are dropped.
//   * A block out of tiles waits for the last tile's inclusive prefix (the
//     total) and fills its share of the tail [min(total, cap), cap) with
//     (n, false).  Waiting on other blocks is safe only if every block is
//     resident, so the kernel is launched cooperatively, which guarantees
//     that or refuses the launch.
// The tile counter and the status words (flag << 32 | count) live in
// per-call scratch that the host zeroes with cudaMemsetAsync before the
// launch, so no state passes from one call to the next.
//
// Alignment: tiles are cut from the 16-byte-aligned address at or below
// the mask's first byte, so every 16-byte group that lies wholly inside
// the mask is one aligned vector load; the two groups that the mask covers
// only in part (its head and its end) are read byte by byte.
//
// What bounds it on an H100: bytes, n + 5 * cap (read the mask once, write
// an int32 index and a bool a slot).  For the frame's calls (at most 1.2M
// entries, under a megabyte) that is a few microseconds: the fixed cost of
// the launch, the memset and the look-back chain is what remains.

#include <cuda_runtime.h>

#include <stdint.h>

#include "persistent.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;                        // mask bytes per thread
constexpr int kTile = kThreads * kVec;          // 4096 mask bytes per tile
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kPrefix = 2ull << 32;

// 0x80 in each byte of w that is nonzero, 0 in the others
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
}

// status words are read and written whole, through L2, by other blocks
__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long s) {
  *reinterpret_cast<volatile unsigned long long*>(p) = s;
}

// The exclusive prefix of the tiles before `tile` (warp 0, every lane
// returns it), after publishing the tile's aggregate; then publishes its
// inclusive prefix.
__device__ __forceinline__ int look_back(unsigned long long* status,
                                         int tile, int agg, int lane) {
  const unsigned count = static_cast<unsigned>(agg);
  if (tile == 0) {
    if (lane == 0) store_status(&status[0], kPrefix | count);
    return 0;
  }
  if (lane == 0) store_status(&status[tile], kAggregate | count);
  int prefix = 0;
  for (int last = tile - 1;; last -= 32) {      // last: nearest in window
    const int p = last - lane;
    unsigned long long s;
    do {
      s = p >= 0 ? load_status(&status[p]) : kPrefix;
    } while (!__all_sync(0xffffffffu, (s >> 32) != 0));
    const unsigned pre = __ballot_sync(0xffffffffu, (s >> 32) == 2);
    const int stop = pre ? __ffs(pre) - 1 : 31;   // nearest inclusive prefix
    int val = lane <= stop ? static_cast<int>(static_cast<unsigned>(s)) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      val += __shfl_xor_sync(0xffffffffu, val, off);
    prefix += val;
    if (pre) break;
  }
  const unsigned incl = static_cast<unsigned>(prefix) + count;
  if (lane == 0) store_status(&status[tile], kPrefix | incl);
  return prefix;
}

__global__ void __launch_bounds__(kThreads)
compact_lookback_kernel(const unsigned char* __restrict__ mask, int n,
                        int cap, int* __restrict__ idx,
                        unsigned char* __restrict__ valid,
                        unsigned long long* __restrict__ scratch) {
  __shared__ int packed[kTile];
  __shared__ int warp_sum[kWarps];
  __shared__ int tile_of, tile_off;
  unsigned* counter = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* status = scratch + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // mask byte i is byte i + head of the aligned view
  const int head = static_cast<int>(reinterpret_cast<uintptr_t>(mask) & 15);
  const unsigned char* view = mask - head;
  const long long span = static_cast<long long>(n) + head;
  const int ntiles = static_cast<int>((span + kTile - 1) / kTile);

  while (true) {
    if (threadIdx.x == 0) tile_of = atomicAdd(counter, 1u);
    __syncthreads();
    const int tile = tile_of;
    if (tile >= ntiles) break;                  // the whole block leaves
    const long long u0 = static_cast<long long>(tile) * kTile
        + threadIdx.x * kVec;
    unsigned bits[4];
    if (u0 >= head && u0 + kVec <= span) {
      const uint4 q = *reinterpret_cast<const uint4*>(view + u0);
      bits[0] = nonzero_bytes(q.x);
      bits[1] = nonzero_bytes(q.y);
      bits[2] = nonzero_bytes(q.z);
      bits[3] = nonzero_bytes(q.w);
    } else {                                    // the head or the end
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        unsigned b = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const long long u = u0 + 4 * w + c;
          if (u >= head && u < span && view[u] != 0) b |= 0x80u << (8 * c);
        }
        bits[w] = b;
      }
    }
    const int cnt = __popc(bits[0]) + __popc(bits[1]) + __popc(bits[2])
        + __popc(bits[3]);
    int incl = cnt;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += t;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int pos = incl - cnt, agg = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int s = warp_sum[w];
      if (w < warp) pos += s;
      agg += s;
    }
    if (warp == 0) {
      const int off = look_back(status, tile, agg, lane);
      if (lane == 0) tile_off = off;
    }
    // this thread's survivors, ascending, at its place in the tile
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      for (unsigned b = bits[w]; b; b &= b - 1) {
        const int byte = (__ffs(b) - 1) >> 3;
        packed[pos++] = static_cast<int>(u0 + 4 * w + byte - head);
      }
    }
    __syncthreads();
    const int off = tile_off;
    for (int j = threadIdx.x; j < agg && off + j < cap; j += kThreads) {
      idx[off + j] = packed[j];
      valid[off + j] = 1;
    }
  }

  // the tail, once the last tile has published the total
  if (threadIdx.x == 0) {
    unsigned long long s;
    while (((s = load_status(&status[ntiles - 1])) >> 32) != 2)
      __nanosleep(64);
    tile_off = static_cast<int>(static_cast<unsigned>(s));
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long p = min(tile_off, cap)
           + static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       p < cap; p += stride) {
    idx[p] = n;
    valid[p] = 0;
  }
}

int tiles_for(const unsigned char* mask, int n) {
  const long long head = reinterpret_cast<uintptr_t>(mask) & 15;
  return static_cast<int>((n + head + kTile - 1) / kTile);
}

}  // namespace

extern "C" {

int sherf_compact_tile() { return kTile; }

// 8-byte words of scratch a call of n entries needs, at any alignment
int sherf_compact_scratch_words(int n) {
  return static_cast<int>((n + 15LL + kTile - 1) / kTile) + 1;
}

// n >= 1, cap >= 1; scratch: sherf_compact_scratch_words(n) words.
int sherf_compact_mask(const unsigned char* mask, int n, int cap, int* idx,
                       unsigned char* valid, unsigned long long* scratch,
                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntiles = tiles_for(mask, n);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (ntiles + 1) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = persistent_blocks(compact_lookback_kernel, kThreads, 0, ntiles,
                          &blocks);
  if (err != cudaSuccess) return err;
  void* args[] = {&mask, &n, &cap, &idx, &valid, &scratch};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(compact_lookback_kernel), blocks,
      kThreads, args, 0, st);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch
  return err != cudaSuccess ? err : last;
}

}  // extern "C"
