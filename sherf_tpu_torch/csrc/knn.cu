// Nearest-vertex kernels for Hopper (sm_90a): nn_1 and ray_body_mask.
//
// nn_1 replaces the Pallas kernel _knn_kernel / nn_1_pallas
// (sherf_tpu/kernels/knn_pallas.py:127, :608): for each query, the squared
// distance to and the index of the nearest of V vertices (V = 6890 for
// SMPL), d2 built elementwise in f32 as ((dx*dx + dy*dy) + dz*dz) with
// d = v - q, ties to the lowest index.
//
// ray_body_mask replaces _ray_seg_kernel / ray_body_mask_pallas
// (knn_pallas.py:410, :554): for each ray (o, d), the minimum over vertices
// of the squared distance to the infinite line, a - b*b/|d|^2 with
// w = v - o, a = |w|^2, b = d.w, compared with a threshold.  A block of 256
// rays (the Pallas tile) in which no ray is active writes false and skips
// the scan.
//
// What bounds them on an H100: operations.  Each (query, vertex) pair
// costs ~9 f32 operations (3 sub, 3 mul, 2 add, 1 min; ray_body_mask ~17),
// and every vertex is reused by every query, so the bytes moved are tiny
// next to N*V*9 operations.  chip_smoke.py states the bound against the
// 67 TFLOP/s f32 CUDA-core peak, which counts an FMA as two operations;
// this code issues no FMA (see below), one operation per issue slot, so
// the ceiling it can reach is about twice that bound.
//
// The distance arithmetic uses the round-to-nearest intrinsics
// (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn): nvcc may not contract them
// into FMAs, so each operation rounds exactly as eager PyTorch's separate
// elementwise kernels do, and the plain torch versions in
// sherf_tpu_torch/kernels/knn.py are bit-equal to these kernels.
//
// nn_1's design spends its issue slots on the 8 rounded operations of a
// pair and little else:
//   * Persistent blocks of 512 threads, as many as fit on the card (two
//     per SM at V = 6890), each staging the vertices once into shared
//     memory as float4 with coalesced loads.
//   * A block is four groups of four warps.  A group takes a tile of 128
//     queries from a global atomic counter, so tiles balance across SMs
//     and the last wave has no tail of idle blocks.  Each warp of the group
//     scans one quarter of the vertices for all 128 queries: four queries
//     per lane in registers, so one broadcast LDS.128 of a vertex serves
//     four pairs, and the unit of work a warp takes is a quarter of a tile,
//     small next to the ~9 tiles per SM of the production call.
//   * Two-level argmin.  Over a chunk of 32 vertices a lane keeps only
//     fminf of each query's d2 (9 operations a pair); after the chunk, a
//     minimum strictly below the running best replaces it and records the
//     chunk (a compare and two selects a chunk).  At the end the lane
//     rescans that one chunk, with the same rounded operations and so the
//     same bits, for the first vertex at the minimum.  Earlier chunks win
//     ties, and inside a chunk the first vertex does.  (Rescanning at
//     every improvement instead was slower on the production frame;
//     PERF.md §6 has both times.)
//   * The four quarters merge with a shared-memory atomicMin of the 64-bit
//     key (d2 bits << 32 | index): for d2 >= 0 the bits order as the
//     values, so the smallest key is the smallest d2 at its lowest index.
//   * A tile whose 128 queries are bit-identical (the budgets' padding:
//     every padded slot reads the same clamped sample) is scanned once,
//     by all 128 lanes of the group with the vertices split among them,
//     and the (d2, index) keys reduced across lanes: the same function at
//     1/128 of the cost.
// A d2 that is NaN never wins (as the strict '<' of a sequential scan);
// a query with no finite d2 gets (inf, 0), as torch.min's first minimum.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // = RSEG_P, the Pallas ray tile

// nn_1
constexpr int kNnQ = 4;                        // queries per lane
constexpr int kNnTile = 32 * kNnQ;             // queries per group tile
constexpr int kNnWarpsPerGroup = 4;            // each scans 1/4 of V
constexpr int kNnGroups = 4;                   // groups per block
constexpr int kNnGroupThreads = 32 * kNnWarpsPerGroup;
constexpr int kNnThreads = kNnGroupThreads * kNnGroups;   // 512
constexpr int kNnChunk = 32;                   // vertices per argmin chunk
constexpr unsigned long long kNoKey = 0x7f80000000000000ull;  // (inf, 0)

static_assert(kNnGroupThreads == kNnTile, "one output per group thread");

__device__ unsigned int g_nn1_next_tile;       // the tile counter

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float dist2(float4 p, float qx, float qy,
                                       float qz) {
  return sq3(__fsub_rn(p.x, qx), __fsub_rn(p.y, qy), __fsub_rn(p.z, qz));
}

__device__ __forceinline__ unsigned long long nn_key(float d, int j) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32)
      | static_cast<unsigned>(j);
}

__device__ __forceinline__ void stage_vertices(const float* __restrict__ v,
                                               int nv, float4* sv) {
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    sv[j] = make_float4(v[3 * j], v[3 * j + 1], v[3 * j + 2], 0.0f);
  }
}

// (V, 3) floats read in order by consecutive threads
__device__ __forceinline__ void stage_vertices_coalesced(
    const float* __restrict__ v, int nv, float4* sv) {
  float* s = reinterpret_cast<float*>(sv);
  for (int i = threadIdx.x; i < 3 * nv; i += blockDim.x) {
    const int j = i / 3;
    s[4 * j + (i - 3 * j)] = v[i];
  }
}

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;" ::"r"(group + 1), "r"(kNnGroupThreads)
               : "memory");
}

// One warp's quarter [j0, j1) of the vertices for its lane's kNnQ queries:
// the (d2, index) keys of the quarter's first minimum, kNoKey where no d2
// is finite.
__device__ __forceinline__ void scan_quarter(const float4* sv, int j0, int j1,
                                             const float (&qx)[kNnQ],
                                             const float (&qy)[kNnQ],
                                             const float (&qz)[kNnQ],
                                             unsigned long long (&key)[kNnQ]) {
  float best[kNnQ];
  int bc[kNnQ];                      // first chunk at the running minimum
#pragma unroll
  for (int k = 0; k < kNnQ; ++k) {
    best[k] = INFINITY;
    bc[k] = -1;
  }
  for (int c0 = j0; c0 < j1; c0 += kNnChunk) {
    float cm[kNnQ];
#pragma unroll
    for (int k = 0; k < kNnQ; ++k) cm[k] = INFINITY;
    if (j1 - c0 >= kNnChunk) {
#pragma unroll 8
      for (int j = c0; j < c0 + kNnChunk; ++j) {
        const float4 p = sv[j];
#pragma unroll
        for (int k = 0; k < kNnQ; ++k)
          cm[k] = fminf(cm[k], dist2(p, qx[k], qy[k], qz[k]));
      }
    } else {
      for (int j = c0; j < j1; ++j) {
        const float4 p = sv[j];
#pragma unroll
        for (int k = 0; k < kNnQ; ++k)
          cm[k] = fminf(cm[k], dist2(p, qx[k], qy[k], qz[k]));
      }
    }
#pragma unroll
    for (int k = 0; k < kNnQ; ++k) {
      if (cm[k] < best[k]) {         // strict: an earlier chunk wins a tie
        best[k] = cm[k];
        bc[k] = c0;
      }
    }
  }
  // the first vertex at the minimum, in its chunk (same operations, same
  // bits)
#pragma unroll
  for (int k = 0; k < kNnQ; ++k) {
    if (bc[k] < 0) {
      key[k] = kNoKey;
      continue;
    }
    const int c1 = min(bc[k] + kNnChunk, j1);
    int j = bc[k];
    while (j + 1 < c1 && dist2(sv[j], qx[k], qy[k], qz[k]) != best[k]) ++j;
    key[k] = nn_key(best[k], j);
  }
}

__global__ void __launch_bounds__(kNnThreads, 2)
nn1_kernel(const float* __restrict__ q, int n, const float* __restrict__ v,
           int nv, float* __restrict__ d2_out, int* __restrict__ idx_out) {
  extern __shared__ float4 sv[];
  __shared__ unsigned long long keys[kNnGroups][kNnTile];
  __shared__ int tile_of[kNnGroups];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / kNnWarpsPerGroup;
  const int part = warp % kNnWarpsPerGroup;
  const int gt = threadIdx.x % kNnGroupThreads;   // = warp's part * 32 + lane
  const int ntiles = (n + kNnTile - 1) / kNnTile;
  const int j0 = part * nv / kNnWarpsPerGroup;
  const int j1 = (part + 1) * nv / kNnWarpsPerGroup;

  stage_vertices_coalesced(v, nv, sv);
  keys[group][gt] = kNoKey;
  if (gt == 0) tile_of[group] = atomicAdd(&g_nn1_next_tile, 1u);
  __syncthreads();

  while (true) {
    const int tile = tile_of[group];
    if (tile >= ntiles) break;                    // the whole group leaves
    const int base = tile * kNnTile;
    float qx[kNnQ], qy[kNnQ], qz[kNnQ];
#pragma unroll
    for (int k = 0; k < kNnQ; ++k) {
      const int i = min(base + 32 * k + lane, n - 1);   // past n: a copy
      qx[k] = q[3 * i];
      qy[k] = q[3 * i + 1];
      qz[k] = q[3 * i + 2];
    }
    // every warp of the group loads the same 128 queries and so reaches
    // the same verdict
    const unsigned x0 = __shfl_sync(0xffffffffu, __float_as_uint(qx[0]), 0);
    const unsigned y0 = __shfl_sync(0xffffffffu, __float_as_uint(qy[0]), 0);
    const unsigned z0 = __shfl_sync(0xffffffffu, __float_as_uint(qz[0]), 0);
    bool same = true;
#pragma unroll
    for (int k = 0; k < kNnQ; ++k)
      same = same && __float_as_uint(qx[k]) == x0
          && __float_as_uint(qy[k]) == y0 && __float_as_uint(qz[k]) == z0;
    if (__all_sync(0xffffffffu, same)) {
      // one query: the group's 128 lanes split the vertices
      float b = INFINITY;
      int bj = -1;
      for (int j = j0 + lane; j < j1; j += 32) {
        const float d = dist2(sv[j], qx[0], qy[0], qz[0]);
        if (d < b) {
          b = d;
          bj = j;
        }
      }
      unsigned long long key = bj < 0 ? kNoKey : nn_key(b, bj);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
        key = o < key ? o : key;
      }
      if (key != kNoKey) {
#pragma unroll
        for (int k = 0; k < kNnQ; ++k)
          atomicMin(&keys[group][32 * k + lane], key);
      }
    } else {
      unsigned long long key[kNnQ];
      scan_quarter(sv, j0, j1, qx, qy, qz, key);
#pragma unroll
      for (int k = 0; k < kNnQ; ++k)
        if (key[k] != kNoKey) atomicMin(&keys[group][32 * k + lane], key[k]);
    }
    group_sync(group);
    const int i = base + gt;
    const unsigned long long key = keys[group][gt];
    if (i < n) {
      d2_out[i] = __uint_as_float(static_cast<unsigned>(key >> 32));
      idx_out[i] = static_cast<int>(key & 0xffffffffu);
    }
    keys[group][gt] = kNoKey;
    if (gt == 0) tile_of[group] = atomicAdd(&g_nn1_next_tile, 1u);
    group_sync(group);
  }
}

__global__ void __launch_bounds__(kThreads)
ray_body_mask_kernel(const float* __restrict__ o, const float* __restrict__ dir,
                     const unsigned char* __restrict__ active, int n,
                     const float* __restrict__ v, int nv, float thr,
                     unsigned char* __restrict__ out) {
  extern __shared__ float4 sv[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int act = 1;
  if (active != nullptr) act = (i < n) ? (active[i] != 0) : 0;
  if (!__syncthreads_or(act)) {
    if (i < n) out[i] = 0;
    return;
  }
  stage_vertices(v, nv, sv);
  __syncthreads();
  if (i >= n) return;
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
  const float dd_inv = __fdiv_rn(1.0f, fmaxf(sq3(dx, dy, dz), 1e-12f));
  float best = INFINITY;
  for (int j = 0; j < nv; ++j) {
    const float4 p = sv[j];
    const float w0 = __fsub_rn(p.x, ox);
    const float w1 = __fsub_rn(p.y, oy);
    const float w2 = __fsub_rn(p.z, oz);
    const float a = sq3(w0, w1, w2);
    const float b = __fadd_rn(__fadd_rn(__fmul_rn(dx, w0), __fmul_rn(dy, w1)),
                              __fmul_rn(dz, w2));
    const float dist = __fsub_rn(a, __fmul_rn(__fmul_rn(b, b), dd_inv));
    best = fminf(best, dist);
  }
  out[i] = best < thr ? 1 : 0;
}

int smem_bytes(int nv) { return nv * static_cast<int>(sizeof(float4)); }

// static shared memory of nn1_kernel besides the staged vertices
constexpr int kNnStaticSmem =
    kNnGroups * kNnTile * static_cast<int>(sizeof(unsigned long long))
    + kNnGroups * static_cast<int>(sizeof(int));

}  // namespace

extern "C" {

// The most vertices both kernels can stage (nn_1 also holds its merge
// keys in shared memory).
int sherf_knn_max_vertices() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (optin - kNnStaticSmem) / static_cast<int>(sizeof(float4));
}

// queries per tile of nn_1; a tile whose queries are bit-identical (a
// partial last tile counts its missing slots as copies of query n-1) takes
// the cooperative scan
int sherf_nn1_tile() { return kNnTile; }

int sherf_nn1(const float* q, int n, const float* v, int nv, float* d2,
              int* idx, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = smem_bytes(nv);
  cudaError_t err = cudaFuncSetAttribute(
      nn1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn1_kernel,
                                                      kNnThreads, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (n + kNnTile - 1) / kNnTile;
  const int blocks = std::max(1, std::min((tiles + kNnGroups - 1) / kNnGroups,
                                          sms * std::max(per_sm, 1)));
  void* counter = nullptr;
  err = cudaGetSymbolAddress(&counter, g_nn1_next_tile);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(counter, 0, sizeof(unsigned int), st);
  if (err != cudaSuccess) return err;
  nn1_kernel<<<blocks, kNnThreads, smem, st>>>(q, n, v, nv, d2, idx);
  return cudaGetLastError();
}

int sherf_ray_body_mask(const float* o, const float* d,
                        const unsigned char* active, int n, const float* v,
                        int nv, float thr, unsigned char* out, void* stream) {
  const int smem = smem_bytes(nv);
  cudaError_t err = cudaFuncSetAttribute(
      ray_body_mask_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kThreads - 1) / kThreads;
  ray_body_mask_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      o, d, active, n, v, nv, thr, out);
  return cudaGetLastError();
}

const char* sherf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
