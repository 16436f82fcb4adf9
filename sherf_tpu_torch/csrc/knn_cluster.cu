// Morton-clustered nearest-vertex kernels for Hopper (sm_90a):
// nn_1_clustered, nn_1_shortlist and ray_body_mask_clustered, and the
// cluster prep they share.
//
// nn1_cluster_kernel replaces _knn_cluster_kernel / nn_1_clustered_pallas
// (sherf_tpu/kernels/knn_pallas.py:159, :207); nn1_shortlist_kernel replaces
// _knn_shortlist_kernel / nn_1_shortlist_pallas (:277, :318);
// ray_mask_cluster_kernel replaces _ray_seg_cluster_kernel /
// ray_body_mask_clustered_pallas (:461, :501); cluster_prep_kernel replaces
// the XLA prep of all three wrappers (morton_order :87, the gather and
// centring :220-227, _cluster_stats_sized :104).  They compute the
// contracts of nn_1 and ray_body_mask (csrc/knn.cu) over vertices sorted
// along a Morton curve, centred and cut into clusters of consecutive rows,
// each with a centroid and an inflated radius, and they scan only the
// clusters a bound admits.  sherf_tpu_torch/kernels/knn_cluster.py states
// the visit rules; its plain versions apply them at the kernels' grain with
// the same rounded operations, so kernel and plain version are bit-equal.
//
// cluster_prep_kernel: one block of 1024 threads builds a Clusters from
// the raw vertices, so a wrapper call is the prep, a memset and its kernel:
//   * the vertices staged in shared memory where they fit (V <= ~15k);
//   * the Morton code of each vertex (the plain version's f32 operations);
//   * CUB's block radix sort of the 30-bit codes, vertex ids as values in
//     blocked order: an LSD radix sort is stable, so equal codes keep
//     ascending vertex order, as torch.argsort(stable=True) gives.  (A
//     bitonic sort of 64-bit (code, id) keys in shared memory, the first
//     design, took ~90 us of the card's time: 91 stages, each bound by
//     shared-memory bandwidth; the radix sort takes the whole prep to
//     ~45 us);
//   * the centre as an f64 sum in a fixed order (lane t adds rows t,
//     t + 1024, ... in turn, then a halving tree over the lanes), rounded
//     once to f32, and each cluster's centroid the same way over a warp's
//     32 lanes.  The plain version sums in that order (_lane_sum): eager
//     torch's own reduction order could not be matched.
//
// nn_1_clustered and nn_1_shortlist: what bounds them on an H100 is
// operations, 9 f32 operations for each (query, vertex) pair that a scan
// visits, and the pairs depend on the data.  The old kernels (one query a
// thread, 1,632 non-persistent blocks restaging 111 KB each; one block of
// 512 per shortlist tile, two __syncthreads per listed cluster) lost most
// of their time to three things, and the design answers each:
//   * Persistent blocks of 16 warps (two a SM at V = 6890) stage the
//     sorted vertices and the cluster table once into shared memory as
//     float4.  Each WARP takes a unit of 64 consecutive queries (two a
//     lane) from a per-call counter that the entry point zeroes with a
//     memset, so warps never wait for each other.  One broadcast LDS.128 of
//     a vertex serves two pairs; over each chunk of 32 rows a lane keeps
//     only fminf of each query's d2, records the chunk that lowered its
//     best, and rescans that one chunk at the end for the first row at the
//     minimum (nn_1's two-level argmin).  The visit decision is per unit:
//     the plain versions' grain NN_GROUP = 64.  Two queries a lane, not
//     nn_1's four: the frame's point-budget call has ~4,800 units of real
//     queries for 4,224 resident warps, and at four a lane (half as many
//     units) the warps that drew two heavy units set the time (B5 0.84 ms
//     against 0.48; at one a lane 0.51).  The union a unit visits barely
//     depends on the grain (1.46e9 pairs at 32, 1.50e9 at 128).
//   * A unit whose 64 queries are bit-identical (the budgets' padding:
//     27% of the frame's point-budget call) takes the same decisions once:
//     cluster by cluster, in visit order, the lanes split the rows and a
//     shuffle reduction of the key (d2 bits << 32 | row) gives the first
//     row at the minimum, which replaces the running best only if strictly
//     lower, as the sequential scan would.
//   * nn_1_shortlist builds its tile's list itself: each warp computes the
//     bounding sphere of its 512-query tile (zero rows past n, as the
//     plain version pads), each cluster's lb_r and the tile's ub_r with
//     shortlist_tiles' exact operations, the count with a ballot, and the
//     stable lb order with a rank count over <= 64 clusters (two a lane).
//     Inside the list a unit skips a cluster where every query has
//     (max(|q - ctr_c| - r_c, 0) (1 - 1e-5))^2 > best: the list's grain is
//     the TPU's tile, where 26 of 27 clusters were listed and scanned.
// Both kernels take raw queries and subtract the centre (the same f32
// subtraction the plain versions' callers make), and write the index
// remapped to the original numbering through the sorted order when given
// one, so a wrapper launches nothing after them.  A d2 that is NaN never
// wins; a query no visited row beats keeps its initial best and index 0.
//
// ray_body_mask_clustered: what bounds it is operations too: each
// (ray, cluster) quick rejection (the line's squared distance to the
// centroid and a compare: 9 f32 operations where the rays share their
// origin, 17 where they do not), 7 more (the square-root test) for each
// (ray, cluster) it passes, then 9 for each (ray, vertex) pair a visit
// tests where the rays share their origin, 17 where they do not; at the
// frame's call on an H100 it reaches about 14% of that bound (PERF.md §6,
// row 7).  The design (PERF.md has the probes behind each choice; the
// SHERF_RAY_* and SHERF_PROBE macros below build the variants that
// sherf_tpu_torch/ray_cluster_probe.py times, and the default build
// defines none of them):
//   * one persistent block of 32 warps an SM stages the vertices and the
//     cluster table once, with cp.async; warps take units of 8 rays in ray
//     order from the per-call counter.  Units of 32 rays (one a lane) left
//     the few warps that drew the rays crossing the body running long
//     after the others had left;
//   * four lanes a ray split its bounds (cluster c in lane c mod 4), each
//     lane testing up to 32 clusters before any ballot, so the bounds run
//     as independent chains; a quick rejection, dl2 >= ((sqrt(thr) + r_c)
//     1.001)^2, spares most bounds the square root without changing a
//     decision;
//   * each ray takes its own visit decisions: cluster by cluster, in
//     ascending order, a ballot collects the rays that have not hit and
//     whose bound admits the cluster, the lanes split its rows (4 a lane a
//     pass of 128) and test two of those rays an iteration, and one OR
//     over the warp ends the pass.  Only pairs a ray's own bound admitted
//     are tested, and no lane waits on another's early exit;
//   * where a unit's rays share one origin (a pinhole camera's), a pass
//     computes w = v - o and a = |w|^2 once a row for all of them: 9
//     operations a pair instead of 17, the same bits;
//   * it reads raw origins and directions at any row and column strides
//     and subtracts the centre itself, so its wrapper is the prep, a memset
//     and this kernel, on the frame's strided rays.
//
// Every distance and bound uses the round-to-nearest intrinsics, which
// nvcc never contracts into FMAs, with the wrapper's f32 constants.  Each
// kernel's unit counter lives in per-call scratch, so calls on two streams
// share no state.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <cmath>

#include <cub/block/block_radix_sort.cuh>

#include "persistent.cuh"

namespace {

// the wrapper's f32 constants: each is the double rounded once to float
constexpr float kGrow = static_cast<float>(1.0 + 1e-5);
constexpr float kShrink = static_cast<float>(1.0 - 1e-5);
constexpr float kUbFloor = static_cast<float>(1e-12);
constexpr float kDdFloor = static_cast<float>(1e-12);
constexpr float kRadFloor = static_cast<float>(1e-6);
constexpr float kBoxFloor = static_cast<float>(1e-9);
constexpr float kSentinel = 1e6f;
constexpr unsigned kFull = 0xffffffffu;

// nn_1_clustered, nn_1_shortlist (and the launch of all three)
constexpr int kQ = 2;                           // queries a lane
constexpr int kUnit = 32 * kQ;                  // queries a warp takes
constexpr int kWarps = 16;
constexpr int kNnThreads = 32 * kWarps;
constexpr int kChunk = 32;                      // rows per argmin chunk
constexpr int kTile = 512;                      // = P_TILE, shortlist tile
constexpr int kUnitsPerTile = kTile / kUnit;
constexpr int kMaxListed = 64;                  // clusters a tile ranks
constexpr int kScratchWords = 2;                // tile counter, zero word
constexpr unsigned long long kNoKey = 0x7f80000000000000ull;  // (inf, 0)

static_assert(kTile % kUnit == 0, "a shortlist tile is whole units");

// ray_body_mask_clustered
#ifndef SHERF_RAY_WARPS
#define SHERF_RAY_WARPS 32
#endif
#ifndef SHERF_RAY_UNIT
#define SHERF_RAY_UNIT 8
#endif
#ifndef SHERF_RAY_ROWS
#define SHERF_RAY_ROWS 4
#endif
// SHERF_PROBE: 0 as built; 1 stage and leave; 2 bounds only, no visit; 3 no
// quick rejection; 4 one ray an iteration of a pass; 5 the vertices staged
// through registers (all three cluster kernels)
#ifndef SHERF_PROBE
#define SHERF_PROBE 0
#endif
constexpr int kRayWarps = SHERF_RAY_WARPS;      // warps a block, one an SM
constexpr int kRayThreads = 32 * kRayWarps;
constexpr int kRayUnit = SHERF_RAY_UNIT;        // rays a unit (a warp's)
constexpr int kRayLanes = 32 / kRayUnit;        // lanes a ray (its bounds)
static_assert(kRayUnit * kRayLanes == 32 && kRayLanes < 32,
              "a unit's rays share the warp's lanes evenly");
constexpr int kRayRows = SHERF_RAY_ROWS;        // rows a lane tests a pass
constexpr int kRayPass = 32 * kRayRows;         // rows of a cluster a pass
// margin of the quick rejection: far above the bound's f32 rounding
constexpr float kRejectGrow = 1.001f;

// prep
constexpr int kPrepThreads = 1024;              // = PREP_LANES
constexpr int kPrepMaxKeys = 16 * kPrepThreads; // vertices the block sorts
constexpr int kPrepSumsBytes = 3 * kPrepThreads * 8;

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ float dist2(float4 p, float qx, float qy,
                                       float qz) {
  return sq3(__fsub_rn(p.x, qx), __fsub_rn(p.y, qy), __fsub_rn(p.z, qz));
}

// distance from (qx, qy, qz) to the centroid of c: sqrt of (q - c)^2 summed
__device__ __forceinline__ float centroid_dist(float4 c, float qx, float qy,
                                               float qz) {
  return __fsqrt_rn(sq3(__fsub_rn(qx, c.x), __fsub_rn(qy, c.y),
                        __fsub_rn(qz, c.z)));
}

__device__ __forceinline__ unsigned long long nn_key(float d, int j) {
  return (static_cast<unsigned long long>(__float_as_uint(d)) << 32)
      | static_cast<unsigned>(j);
}

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// ---------------------------------------------------------------------------
// cluster prep

__device__ __forceinline__ unsigned spread10(unsigned x) {
  x = (x | (x << 16)) & 0x030000FFu;
  x = (x | (x << 8)) & 0x0300F00Fu;
  x = (x | (x << 4)) & 0x030C30C3u;
  x = (x | (x << 2)) & 0x09249249u;
  return x;
}

// the grid cell of x in [lo, hi] along one axis, as morton_order rounds it
__device__ __forceinline__ unsigned morton_cell(float x, float lo, float hi) {
  const float s = __fmul_rn(
      __fdiv_rn(__fsub_rn(x, lo), fmaxf(__fsub_rn(hi, lo), kBoxFloor)),
      1023.0f);
  return static_cast<unsigned>(static_cast<int>(fminf(fmaxf(s, 0.0f),
                                                      1023.0f)));
}

template <int kItems>
using PrepSort = cub::BlockRadixSort<unsigned, kPrepThreads, kItems,
                                     unsigned short>;

// Dynamic shared memory of the prep: the sort's temporary storage, reused
// after the sort for the lanes' f64 sums (3 per thread) and the order
// (u16 per vertex); then, where it fits, the raw vertices.
template <int kItems>
__host__ __device__ constexpr int prep_scratch_bytes(int nv) {
  constexpr int sort = sizeof(typename PrepSort<kItems>::TempStorage);
  return ((sort > kPrepSumsBytes + 2 * nv ? sort : kPrepSumsBytes + 2 * nv)
          + 15) / 16 * 16;
}

template <int kItems>
__global__ void __launch_bounds__(kPrepThreads)
cluster_prep_kernel(const float* __restrict__ ref_g, int nv, int csize,
                    int nc, int sorted_mean, int stage_ref,
                    long long* __restrict__ order_g, float* __restrict__ vs,
                    float* __restrict__ ctr0_out, float* __restrict__ cent,
                    float* __restrict__ rad) {
  using Sort = PrepSort<kItems>;
  extern __shared__ __align__(16) unsigned char prep_smem[];
  __shared__ float part[6][32];
  __shared__ float box[6];
  __shared__ float ctr[3];
  double* sums = reinterpret_cast<double*>(prep_smem);       // (1024, 3)
  unsigned short* ord =
      reinterpret_cast<unsigned short*>(prep_smem + kPrepSumsBytes);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // 0. the raw vertices: staged in shared memory where they fit
  const float* ref = ref_g;
  if (stage_ref) {
    float* s = reinterpret_cast<float*>(prep_smem
                                        + prep_scratch_bytes<kItems>(nv));
    for (int i = t; i < 3 * nv; i += kPrepThreads) s[i] = ref_g[i];
    ref = s;
    __syncthreads();
  }

  // 1. the bounding box (min and max are exact in any order)
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int j = t; j < nv; j += kPrepThreads) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float x = ref[3 * j + d];
      lo[d] = fminf(lo[d], x);
      hi[d] = fmaxf(hi[d], x);
    }
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = warp_min(lo[d]);
    hi[d] = warp_max(hi[d]);
    if (lane == 0) {
      part[d][warp] = lo[d];
      part[3 + d][warp] = hi[d];
    }
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float l = warp_min(part[d][lane]);
      const float h = warp_max(part[3 + d][lane]);
      if (lane == 0) {
        box[d] = l;
        box[3 + d] = h;
      }
    }
  }
  __syncthreads();

  // 2. a stable radix sort of the 30-bit codes, vertices in blocked order
  // (thread t holds t * kItems + e); padding carries all 30 bits set and
  // sorts after every real vertex of an equal code
  unsigned keys[kItems];
  unsigned short vals[kItems];
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int i = t * kItems + e;
    vals[e] = static_cast<unsigned short>(i);
    keys[e] = (1u << 30) - 1;
    if (i < nv)
      keys[e] = (spread10(morton_cell(ref[3 * i], box[0], box[3])) << 2)
          | (spread10(morton_cell(ref[3 * i + 1], box[1], box[4])) << 1)
          | spread10(morton_cell(ref[3 * i + 2], box[2], box[5]));
  }
  Sort sorter(*reinterpret_cast<typename Sort::TempStorage*>(prep_smem));
  sorter.Sort(keys, vals, 0, 30);
  __syncthreads();                     // the sort's storage is free again
#pragma unroll
  for (int e = 0; e < kItems; ++e) {
    const int p = t * kItems + e;
    if (p < nv) {
      ord[p] = vals[e];
      order_g[p] = vals[e];
    }
  }
  __syncthreads();

  // 3. each lane's f64 sum of the centre's rows, then the halving tree
  double s0 = 0.0, s1 = 0.0, s2 = 0.0;
  for (int p = t; p < nv; p += kPrepThreads) {
    const int r = sorted_mean ? ord[p] : p;
    s0 = __dadd_rn(s0, static_cast<double>(ref[3 * r]));
    s1 = __dadd_rn(s1, static_cast<double>(ref[3 * r + 1]));
    s2 = __dadd_rn(s2, static_cast<double>(ref[3 * r + 2]));
  }
  sums[3 * t] = s0;
  sums[3 * t + 1] = s1;
  sums[3 * t + 2] = s2;
  __syncthreads();
  for (int h = kPrepThreads / 2; h > 0; h >>= 1) {
    if (t < h) {
#pragma unroll
      for (int d = 0; d < 3; ++d)
        sums[3 * t + d] = __dadd_rn(sums[3 * t + d], sums[3 * (t + h) + d]);
    }
    __syncthreads();
  }
  if (t < 3) {
    const float c = __double2float_rn(
        __ddiv_rn(sums[t], static_cast<double>(nv)));
    ctr[t] = c;
    ctr0_out[t] = c;
  }
  __syncthreads();

  // 4. the sorted, centred rows
  for (int i = t; i < 3 * nv; i += kPrepThreads) {
    const int p = i / 3, d = i - 3 * p;
    vs[i] = __fsub_rn(ref[3 * ord[p] + d], ctr[d]);
  }

  // 5. one warp a cluster: f64 centroid over 32 lanes, then the radius;
  // each row recomputed as step 4 wrote it (the same bits)
  for (int c = warp; c < nc; c += kPrepThreads / 32) {
    const int j0 = c * csize;
    const int j1 = min(j0 + csize, nv);
    double a0 = 0.0, a1 = 0.0, a2 = 0.0;
    for (int j = j0 + lane; j < j1; j += 32) {
      const float* r = ref + 3 * ord[j];
      a0 = __dadd_rn(a0, static_cast<double>(__fsub_rn(r[0], ctr[0])));
      a1 = __dadd_rn(a1, static_cast<double>(__fsub_rn(r[1], ctr[1])));
      a2 = __dadd_rn(a2, static_cast<double>(__fsub_rn(r[2], ctr[2])));
    }
    // xor halving: lane 0 ends with (lane l + h onto lane l), h = 16 .. 1
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a0 = __dadd_rn(a0, __shfl_xor_sync(kFull, a0, off));
      a1 = __dadd_rn(a1, __shfl_xor_sync(kFull, a1, off));
      a2 = __dadd_rn(a2, __shfl_xor_sync(kFull, a2, off));
    }
    const int cnt = max(j1 - j0, 0);
    const double dn = static_cast<double>(max(cnt, 1));
    const float cx = __double2float_rn(__ddiv_rn(a0, dn));
    const float cy = __double2float_rn(__ddiv_rn(a1, dn));
    const float cz = __double2float_rn(__ddiv_rn(a2, dn));
    float r2 = 0.0f;
    for (int j = j0 + lane; j < j1; j += 32) {
      const float* r = ref + 3 * ord[j];
      r2 = fmaxf(r2, sq3(__fsub_rn(__fsub_rn(r[0], ctr[0]), cx),
                         __fsub_rn(__fsub_rn(r[1], ctr[1]), cy),
                         __fsub_rn(__fsub_rn(r[2], ctr[2]), cz)));
    }
    r2 = warp_max(r2);
    if (lane == 0) {
      cent[3 * c] = cnt ? cx : kSentinel;
      cent[3 * c + 1] = cnt ? cy : kSentinel;
      cent[3 * c + 2] = cnt ? cz : kSentinel;
      rad[c] = __fadd_rn(__fmul_rn(__fsqrt_rn(r2), kGrow), kRadFloor);
    }
  }
}

// The prep for kItems vertices a thread: stages the vertices where the
// device's shared memory holds them beside the scratch.
template <int kItems>
cudaError_t launch_prep(const float* ref, int nv, int csize, int sorted_mean,
                        long long* order, float* vs, float* ctr0, float* cent,
                        float* rad, cudaStream_t st) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attrs;
  cudaError_t err = cudaFuncGetAttributes(&attrs, cluster_prep_kernel<kItems>);
  if (err != cudaSuccess) return err;
  const int scratch = prep_scratch_bytes<kItems>(nv);
  const int staged = scratch + 12 * nv;
  const int stage_ref =
      staged + static_cast<int>(attrs.sharedSizeBytes) <= optin;
  const int smem = stage_ref ? staged : scratch;
  err = cudaFuncSetAttribute(cluster_prep_kernel<kItems>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int nc = (nv + csize - 1) / csize;
  cluster_prep_kernel<kItems><<<1, kPrepThreads, smem, st>>>(
      ref, nv, csize, nc, sorted_mean, stage_ref, order, vs, ctr0, cent, rad);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// nn_1_clustered, nn_1_shortlist

// sc[c] = (centroid, radius) of cluster c; sv[j] = sorted vertex j, from
// (V, 3) floats read in order by consecutive threads and copied with
// cp.async (no round trip through registers; the caller's __syncthreads
// publishes them)
__device__ __forceinline__ void stage_coalesced(
    const float* __restrict__ v, int nv, const float* __restrict__ cent,
    const float* __restrict__ rad, int nc, float4* sc, float4* sv) {
  for (int c = threadIdx.x; c < nc; c += blockDim.x)
    sc[c] = make_float4(cent[3 * c], cent[3 * c + 1], cent[3 * c + 2], rad[c]);
  float* s = reinterpret_cast<float*>(sv);
  for (int i = threadIdx.x; i < 3 * nv; i += blockDim.x) {
    const int j = i / 3;
#if SHERF_PROBE == 5
    s[4 * j + (i - 3 * j)] = v[i];
#else
    const unsigned dst = static_cast<unsigned>(
        __cvta_generic_to_shared(s + 4 * j + (i - 3 * j)));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
                 "l"(v + i) : "memory");
#endif
  }
#if SHERF_PROBE != 5
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// The next unit of the warp from the counter (every lane gets it).
__device__ __forceinline__ int next_unit(unsigned* counter, int lane) {
  unsigned u = 0;
  if (lane == 0) u = atomicAdd(counter, 1u);
  return static_cast<int>(__shfl_sync(kFull, u, 0));
}

// Queries base + 32k + lane, centred; past n: copies of query n - 1, which
// vote as query n - 1 does.  Returns whether all 128 are bit-identical.
__device__ __forceinline__ bool load_unit(const float* __restrict__ q, int n,
                                          int base, float cx, float cy,
                                          float cz, int lane,
                                          float (&qx)[kQ], float (&qy)[kQ],
                                          float (&qz)[kQ]) {
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = min(base + 32 * k + lane, n - 1);
    qx[k] = __fsub_rn(q[3 * i], cx);
    qy[k] = __fsub_rn(q[3 * i + 1], cy);
    qz[k] = __fsub_rn(q[3 * i + 2], cz);
  }
  const unsigned x0 = __shfl_sync(kFull, __float_as_uint(qx[0]), 0);
  const unsigned y0 = __shfl_sync(kFull, __float_as_uint(qy[0]), 0);
  const unsigned z0 = __shfl_sync(kFull, __float_as_uint(qz[0]), 0);
  bool same = true;
#pragma unroll
  for (int k = 0; k < kQ; ++k)
    same = same && __float_as_uint(qx[k]) == x0
        && __float_as_uint(qy[k]) == y0 && __float_as_uint(qz[k]) == z0;
  return __all_sync(kFull, same);
}

// Rows [j0, j1) for the lane's kQ queries: in chunks of kChunk rows, fminf
// of each query's d2; a chunk minimum strictly below the running best
// replaces it and records the chunk.
__device__ __forceinline__ void scan_rows(const float4* sv, int j0, int j1,
                                          const float (&qx)[kQ],
                                          const float (&qy)[kQ],
                                          const float (&qz)[kQ],
                                          float (&best)[kQ], int (&bc)[kQ]) {
  for (int c0 = j0; c0 < j1; c0 += kChunk) {
    float cm[kQ];
#pragma unroll
    for (int k = 0; k < kQ; ++k) cm[k] = INFINITY;
    if (j1 - c0 >= kChunk) {
#pragma unroll 8
      for (int j = c0; j < c0 + kChunk; ++j) {
        const float4 p = sv[j];
#pragma unroll
        for (int k = 0; k < kQ; ++k)
          cm[k] = fminf(cm[k], dist2(p, qx[k], qy[k], qz[k]));
      }
    } else {
      for (int j = c0; j < j1; ++j) {
        const float4 p = sv[j];
#pragma unroll
        for (int k = 0; k < kQ; ++k)
          cm[k] = fminf(cm[k], dist2(p, qx[k], qy[k], qz[k]));
      }
    }
#pragma unroll
    for (int k = 0; k < kQ; ++k) {
      if (cm[k] < best[k]) {          // strict: an earlier chunk wins a tie
        best[k] = cm[k];
        bc[k] = c0;
      }
    }
  }
}

// The first row at `best` in the chunk that set it (same operations, same
// bits); 0 where no visited row beat the initial best.
__device__ __forceinline__ int resolve_row(const float4* sv, int nv,
                                           int csize, int bc, float best,
                                           float qx, float qy, float qz) {
  if (bc < 0) return 0;
  const int end = min(min(bc + kChunk, (bc / csize + 1) * csize), nv);
  int j = bc;
  while (j + 1 < end && dist2(sv[j], qx, qy, qz) != best) ++j;
  return j;
}

// One query (the same in every lane) against rows [j0, j1): the lanes
// split the rows; the smallest key (d2 bits, row) over the warp, kNoKey
// where no d2 is below infinity.
__device__ __forceinline__ unsigned long long coop_rows(
    const float4* sv, int j0, int j1, float qx, float qy, float qz,
    int lane) {
  float b = INFINITY;
  int bj = -1;
  for (int j = j0 + lane; j < j1; j += 32) {
    const float d = dist2(sv[j], qx, qy, qz);
    if (d < b) {
      b = d;
      bj = j;
    }
  }
  unsigned long long key = bj < 0 ? kNoKey : nn_key(b, bj);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, key, off);
    key = o < key ? o : key;
  }
  return key;
}

// a cooperative cluster's result replaces the running best only if lower
__device__ __forceinline__ void take_key(unsigned long long key, float& b,
                                         int& bj) {
  const float d = __uint_as_float(static_cast<unsigned>(key >> 32));
  if (d < b) {
    b = d;
    bj = static_cast<int>(key & 0xffffffffu);
  }
}

__device__ __forceinline__ void write_unit(int base, int n, int lane,
                                           const float (&best)[kQ],
                                           const int (&row)[kQ],
                                           const long long* __restrict__ order,
                                           float* __restrict__ d2_out,
                                           int* __restrict__ idx_out) {
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = base + 32 * k + lane;
    if (i < n) {
      d2_out[i] = best[k];
      idx_out[i] = order ? static_cast<int>(order[row[k]]) : row[k];
    }
  }
}

__global__ void __launch_bounds__(kNnThreads, 2)
nn1_cluster_kernel(const float* __restrict__ q, int n,
                   const float* __restrict__ ctr0,
                   const float* __restrict__ v, int nv,
                   const float* __restrict__ cent,
                   const float* __restrict__ rad, int nc, int csize,
                   const long long* __restrict__ order,
                   float* __restrict__ d2_out, int* __restrict__ idx_out,
                   unsigned* __restrict__ counter) {
  extern __shared__ float4 smem[];
  float4* sc = smem;
  float4* sv = smem + nc;
  stage_coalesced(v, nv, cent, rad, nc, sc, sv);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const float cx = ctr0[0], cy = ctr0[1], cz = ctr0[2];
  const int units = (n + kUnit - 1) / kUnit;

  while (true) {
    const int unit = next_unit(counter, lane);
    if (unit >= units) break;
    const int base = unit * kUnit;
    float qx[kQ], qy[kQ], qz[kQ], best[kQ];
    int row[kQ];
    if (load_unit(q, n, base, cx, cy, cz, lane, qx, qy, qz)) {
      // one query: the lanes split the clusters for ub, then the rows
      float ub = INFINITY;
      for (int c = lane; c < nc; c += 32) {
        const float4 k = sc[c];
        const float t = __fadd_rn(centroid_dist(k, qx[0], qy[0], qz[0]), k.w);
        ub = fminf(ub, __fmul_rn(t, t));
      }
      float b = __fadd_rn(__fmul_rn(warp_min(ub), kGrow), kUbFloor);
      int bj = 0;
      for (int c = 0; c < nc; ++c) {
        const float4 k = sc[c];
        const float m = fmaxf(
            __fsub_rn(centroid_dist(k, qx[0], qy[0], qz[0]), k.w), 0.0f);
        if (!(__fmul_rn(m, m) <= b)) continue;           // warp-uniform
        take_key(coop_rows(sv, c * csize, min(c * csize + csize, nv), qx[0],
                           qy[0], qz[0], lane), b, bj);
      }
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        best[k] = b;
        row[k] = bj;
      }
    } else {
      int bc[kQ];
#pragma unroll
      for (int k = 0; k < kQ; ++k) best[k] = INFINITY;
      for (int c = 0; c < nc; ++c) {
        const float4 kc = sc[c];
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          const float t = __fadd_rn(centroid_dist(kc, qx[k], qy[k], qz[k]),
                                    kc.w);
          best[k] = fminf(best[k], __fmul_rn(t, t));
        }
      }
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        best[k] = __fadd_rn(__fmul_rn(best[k], kGrow), kUbFloor);
        bc[k] = -1;
      }
      for (int c = 0; c < nc; ++c) {
        const float4 kc = sc[c];
        bool want = false;
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          const float m = fmaxf(
              __fsub_rn(centroid_dist(kc, qx[k], qy[k], qz[k]), kc.w), 0.0f);
          want = want || __fmul_rn(m, m) <= best[k];
        }
        if (!__any_sync(kFull, want)) continue;
        scan_rows(sv, c * csize, min(c * csize + csize, nv), qx, qy, qz, best,
                  bc);
      }
#pragma unroll
      for (int k = 0; k < kQ; ++k)
        row[k] = resolve_row(sv, nv, csize, bc[k], best[k], qx[k], qy[k],
                             qz[k]);
    }
    write_unit(base, n, lane, best, row, order, d2_out, idx_out);
  }
}

// The list of the tile's clusters (shortlist_tiles' operations), built by
// one warp into `list` (ids in ascending lb_r, stable); returns the count
// of clusters with lb_r <= ub_r.  nc <= kMaxListed.
__device__ __forceinline__ int tile_list(const float* __restrict__ q, int n,
                                         int tile, float cx, float cy,
                                         float cz, const float4* sc, int nc,
                                         unsigned char* list, int lane) {
  const int base = tile * kTile;
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int r = lane; r < kTile; r += 32) {
    const int i = base + r;
    // rows past n are the zero rows the plain version pads the tile with
    const float p[3] = {i < n ? __fsub_rn(q[3 * i], cx) : 0.0f,
                        i < n ? __fsub_rn(q[3 * i + 1], cy) : 0.0f,
                        i < n ? __fsub_rn(q[3 * i + 2], cz) : 0.0f};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      lo[d] = fminf(lo[d], p[d]);
      hi[d] = fmaxf(hi[d], p[d]);
    }
  }
  float ct[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    ct[d] = __fmul_rn(0.5f, __fadd_rn(warp_min(lo[d]), warp_max(hi[d])));
  float r2 = 0.0f;
  for (int r = lane; r < kTile; r += 32) {
    const int i = base + r;
    const float px = i < n ? __fsub_rn(q[3 * i], cx) : 0.0f;
    const float py = i < n ? __fsub_rn(q[3 * i + 1], cy) : 0.0f;
    const float pz = i < n ? __fsub_rn(q[3 * i + 2], cz) : 0.0f;
    r2 = fmaxf(r2, sq3(__fsub_rn(px, ct[0]), __fsub_rn(py, ct[1]),
                       __fsub_rn(pz, ct[2])));
  }
  const float rt = __fadd_rn(__fmul_rn(__fsqrt_rn(warp_max(r2)), kGrow),
                             kRadFloor);
  // clusters lane and lane + 32
  float lb[2], ub = INFINITY;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = lane + 32 * h;
    lb[h] = INFINITY;
    if (c < nc) {
      const float4 k = sc[c];
      const float dct = __fsqrt_rn(sq3(__fsub_rn(ct[0], k.x),
                                       __fsub_rn(ct[1], k.y),
                                       __fsub_rn(ct[2], k.z)));
      ub = fminf(ub, __fadd_rn(dct, k.w));
      lb[h] = __fmul_rn(fmaxf(__fsub_rn(__fsub_rn(dct, k.w), rt), 0.0f),
                        kShrink);
    }
  }
  const float ub_r = __fadd_rn(__fmul_rn(__fadd_rn(warp_min(ub), rt), kGrow),
                               kRadFloor);
  const int count =
      __popc(__ballot_sync(kFull, lane < nc && lb[0] <= ub_r))
      + __popc(__ballot_sync(kFull, lane + 32 < nc && lb[1] <= ub_r));
  // stable rank: smaller lbs, and equal lbs of lower id, come first
  int rank[2] = {0, 0};
  for (int c2 = 0; c2 < nc; ++c2) {
    const float o = __shfl_sync(kFull, c2 < 32 ? lb[0] : lb[1], c2 & 31);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      rank[h] += (o < lb[h] || (o == lb[h] && c2 < lane + 32 * h)) ? 1 : 0;
  }
  __syncwarp();                        // the previous unit read its list
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (lane + 32 * h < nc)
      list[rank[h]] = static_cast<unsigned char>(lane + 32 * h);
  __syncwarp();
  return count;
}

__global__ void __launch_bounds__(kNnThreads, 2)
nn1_shortlist_kernel(const float* __restrict__ q, int n,
                     const float* __restrict__ ctr0,
                     const float* __restrict__ v, int nv,
                     const float* __restrict__ cent,
                     const float* __restrict__ rad, int nc, int csize,
                     const long long* __restrict__ order,
                     float* __restrict__ d2_out, int* __restrict__ idx_out,
                     int* __restrict__ counts_out, int* __restrict__ ids_out,
                     unsigned* __restrict__ counter) {
  extern __shared__ float4 smem[];
  __shared__ unsigned char lists[kWarps][kMaxListed];
  float4* sc = smem;
  float4* sv = smem + nc;
  stage_coalesced(v, nv, cent, rad, nc, sc, sv);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned char* list = lists[threadIdx.x >> 5];
  const float cx = ctr0[0], cy = ctr0[1], cz = ctr0[2];
  const int units = (n + kUnit - 1) / kUnit;

  while (true) {
    const int unit = next_unit(counter, lane);
    if (unit >= units) break;
    const int tile = unit / kUnitsPerTile;
    const int count = tile_list(q, n, tile, cx, cy, cz, sc, nc, list, lane);
    if (counts_out != nullptr && unit % kUnitsPerTile == 0) {
      if (lane == 0) counts_out[tile] = count;
      for (int s = lane; s < nc; s += 32)
        ids_out[static_cast<long long>(tile) * nc + s] = list[s];
    }
    const int base = unit * kUnit;
    float qx[kQ], qy[kQ], qz[kQ], best[kQ];
    int row[kQ];
    if (load_unit(q, n, base, cx, cy, cz, lane, qx, qy, qz)) {
      float b = INFINITY;
      int bj = 0;
      for (int s = 0; s < count; ++s) {
        const int c = list[s];
        const float4 k = sc[c];
        const float m = __fmul_rn(fmaxf(__fsub_rn(
            centroid_dist(k, qx[0], qy[0], qz[0]), k.w), 0.0f), kShrink);
        if (!(__fmul_rn(m, m) <= b)) continue;           // warp-uniform
        take_key(coop_rows(sv, c * csize, min(c * csize + csize, nv), qx[0],
                           qy[0], qz[0], lane), b, bj);
      }
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        best[k] = b;
        row[k] = bj;
      }
    } else {
      int bc[kQ];
#pragma unroll
      for (int k = 0; k < kQ; ++k) {
        best[k] = INFINITY;
        bc[k] = -1;
      }
      for (int s = 0; s < count; ++s) {
        const int c = list[s];
        const float4 kc = sc[c];
        bool want = false;
#pragma unroll
        for (int k = 0; k < kQ; ++k) {
          const float m = __fmul_rn(fmaxf(__fsub_rn(
              centroid_dist(kc, qx[k], qy[k], qz[k]), kc.w), 0.0f), kShrink);
          want = want || __fmul_rn(m, m) <= best[k];
        }
        if (!__any_sync(kFull, want)) continue;
        scan_rows(sv, c * csize, min(c * csize + csize, nv), qx, qy, qz, best,
                  bc);
      }
#pragma unroll
      for (int k = 0; k < kQ; ++k)
        row[k] = resolve_row(sv, nv, csize, bc[k], best[k], qx[k], qy[k],
                             qz[k]);
    }
    write_unit(base, n, lane, best, row, order, d2_out, idx_out);
  }
}

// ---------------------------------------------------------------------------
// ray_body_mask_clustered

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// a - (b*b) * dd_inv with b = d.w: the squared distance from the line of
// direction d to the point at w from its origin, a = |w|^2
__device__ __forceinline__ float line_dist(float a, float w0, float w1,
                                           float w2, float dx, float dy,
                                           float dz, float dd_inv) {
  const float b = __fadd_rn(__fadd_rn(__fmul_rn(dx, w0), __fmul_rn(dy, w1)),
                            __fmul_rn(dz, w2));
  return __fsub_rn(a, __fmul_rn(__fmul_rn(b, b), dd_inv));
}

// The squared distance from the lane's ray's line to the point p (w and
// a from the ray's origin, as the plain version rounds them).
__device__ __forceinline__ float line_dist_to(float px, float py, float pz,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float ddi) {
  const float w0 = __fsub_rn(px, ox);
  const float w1 = __fsub_rn(py, oy);
  const float w2 = __fsub_rn(pz, oz);
  return line_dist(sq3(w0, w1, w2), w0, w1, w2, dx, dy, dz, ddi);
}

// Ray q of the unit, for every lane: its direction and 1/|d|^2, and its
// origin where the unit's origins differ.
struct PassRay {
  float dx, dy, dz, di, ox, oy, oz;
};

template <bool kShared>
__device__ __forceinline__ PassRay pass_ray(int q, float ox, float oy,
                                            float oz, float dx, float dy,
                                            float dz, float ddi) {
  PassRay r;
  r.dx = __shfl_sync(kFull, dx, q);
  r.dy = __shfl_sync(kFull, dy, q);
  r.dz = __shfl_sync(kFull, dz, q);
  r.di = __shfl_sync(kFull, ddi, q);
  r.ox = kShared ? ox : __shfl_sync(kFull, ox, q);
  r.oy = kShared ? oy : __shfl_sync(kFull, oy, q);
  r.oz = kShared ? oz : __shfl_sync(kFull, oz, q);
  return r;
}

// One pass of a visited cluster: rows [jp, min(jp + kRows * 32, j1))
// against each ray of `todo` (lanes' bits).  The lanes split the rows,
// kRows each (a row past j1 is NaN, which never hits).  Two rays an
// iteration come by shuffle; each lane ORs its rows' verdicts into its
// mask of rays, and one OR over the warp ends the pass: the rays with a
// row at dist < thr.  kShared: every ray of the unit has the lane's
// origin, so w = p - o and a = |w|^2 are computed once a row.
template <bool kShared, int kRows>
__device__ __forceinline__ unsigned ray_pass(const float4* sv, int jp, int j1,
                                             unsigned todo, float ox,
                                             float oy, float oz, float dx,
                                             float dy, float dz, float ddi,
                                             float thr, int lane) {
  const float nan = __int_as_float(0x7fffffff);
  float px[kRows], py[kRows], pz[kRows], pa[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int j = jp + 32 * r + lane;
    const float4 p = j < j1 ? sv[j] : make_float4(nan, nan, nan, nan);
    if (kShared) {
      px[r] = __fsub_rn(p.x, ox);
      py[r] = __fsub_rn(p.y, oy);
      pz[r] = __fsub_rn(p.z, oz);
      pa[r] = sq3(px[r], py[r], pz[r]);
    } else {
      px[r] = p.x;
      py[r] = p.y;
      pz[r] = p.z;
    }
  }
  unsigned mine = 0;
  while (todo != 0) {
    // the second ray repeats the first where only one is left
    const int q0 = __ffs(todo) - 1;
    todo &= todo - 1;
#if SHERF_PROBE == 4
    const int q1 = q0;
#else
    const int q1 = todo != 0 ? __ffs(todo) - 1 : q0;
    todo &= todo - 1;
#endif
    const PassRay r0 = pass_ray<kShared>(q0, ox, oy, oz, dx, dy, dz, ddi);
    const PassRay r1 = pass_ray<kShared>(q1, ox, oy, oz, dx, dy, dz, ddi);
    bool h0 = false, h1 = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (kShared) {
        h0 |= line_dist(pa[r], px[r], py[r], pz[r], r0.dx, r0.dy, r0.dz,
                        r0.di) < thr;
        h1 |= line_dist(pa[r], px[r], py[r], pz[r], r1.dx, r1.dy, r1.dz,
                        r1.di) < thr;
      } else {
        h0 |= line_dist_to(px[r], py[r], pz[r], r0.ox, r0.oy, r0.oz, r0.dx,
                           r0.dy, r0.dz, r0.di) < thr;
        h1 |= line_dist_to(px[r], py[r], pz[r], r1.ox, r1.oy, r1.oz, r1.dx,
                           r1.dy, r1.dz, r1.di) < thr;
      }
    }
    mine |= (static_cast<unsigned>(h0) << q0)
        | (static_cast<unsigned>(h1) << q1);
  }
  return __reduce_or_sync(kFull, mine);
}

__global__ void __launch_bounds__(kRayThreads, 1024 / kRayThreads)
ray_mask_cluster_kernel(const float* __restrict__ o, long long os0,
                        long long os1, const float* __restrict__ dir,
                        long long ds0, long long ds1, int n,
                        const float* __restrict__ ctr0,
                        const float* __restrict__ v, int nv,
                        const float* __restrict__ cent,
                        const float* __restrict__ rad, int nc, int csize,
                        float thr, float thr_root,
                        unsigned char* __restrict__ out,
                        unsigned* __restrict__ counter) {
  extern __shared__ float4 smem[];
  float4* sc = smem;
  float4* sv = smem + nc;
  stage_coalesced(v, nv, cent, rad, nc, sc, sv);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const float cx = ctr0[0], cy = ctr0[1], cz = ctr0[2];
  const int units = (n + kRayUnit - 1) / kRayUnit;
#if SHERF_PROBE == 1
  if (n > 0) return;
#endif

  // lane = kRayLanes lanes of each of the unit's rays: the lane's ray and
  // its phase, the clusters (c = q mod kRayLanes) whose bounds it takes
  const int rr = lane / kRayLanes, q = lane % kRayLanes;
  // a mask with one bit a ray (at its lanes' first) spread to all its lanes
  constexpr unsigned kRayFill = (1u << kRayLanes) - 1u;

  while (true) {
    const int unit = next_unit(counter, lane);
    if (unit >= units) break;
    const int i = unit * kRayUnit + rr;
    // past n: a copy of ray n - 1, which is not live and wants nothing
    const long long r = min(i, n - 1);
    const float* po = o + r * os0;
    const float* pd = dir + r * ds0;
    const float ox = __fsub_rn(po[0], cx);
    const float oy = __fsub_rn(po[os1], cy);
    const float oz = __fsub_rn(po[2 * os1], cz);
    const float dx = pd[0], dy = pd[ds1], dz = pd[2 * ds1];
    const float ddi = __fdiv_rn(1.0f, clamp_min(sq3(dx, dy, dz), kDdFloor));
    // lane masks: every lane of a live ray, of a ray that has hit
    const unsigned live = __ballot_sync(kFull, i < n);
    const unsigned x0 = __shfl_sync(kFull, __float_as_uint(ox), 0);
    const unsigned y0 = __shfl_sync(kFull, __float_as_uint(oy), 0);
    const unsigned z0 = __shfl_sync(kFull, __float_as_uint(oz), 0);
    const bool shared = __all_sync(kFull, __float_as_uint(ox) == x0
                                   && __float_as_uint(oy) == y0
                                   && __float_as_uint(oz) == z0);
    unsigned hits = 0;
    for (int c0 = 0; c0 < nc && hits != live; c0 += 32) {
      const int cn = min(32, nc - c0);
      // bit k (k = q mod kRayLanes): cluster c0 + k may be admitted.
      // Quick rejection: dl2 >= ((sqrt(thr) + r_c) 1.001)^2 gives
      // lb >= thr (1 + 1.9e-3) whatever the f32 rounding of the exact
      // test, so only rays near a cluster take its square root
      unsigned near = 0;
#pragma unroll 4
      for (int k = q; k < cn; k += kRayLanes) {
#if SHERF_PROBE == 3
        near |= 1u << k;
#else
        const float4 kc = sc[c0 + k];
        const float dl2 = line_dist_to(kc.x, kc.y, kc.z, ox, oy, oz, dx, dy,
                                       dz, ddi);
        const float rj = __fmul_rn(__fadd_rn(thr_root, kc.w), kRejectGrow);
        near |= static_cast<unsigned>(dl2 < __fmul_rn(rj, rj)) << k;
#endif
      }
      // the exact test: max(sqrt(dl2) (1 - 1e-5) - r_c, 0)^2 < thr
      unsigned want = 0;
      for (unsigned m = near; m != 0; m &= m - 1) {
        const int k = __ffs(m) - 1;
        const float4 kc = sc[c0 + k];
        const float dl2 = line_dist_to(kc.x, kc.y, kc.z, ox, oy, oz, dx, dy,
                                       dz, ddi);
        const float mm = clamp_min(__fsub_rn(__fmul_rn(
            __fsqrt_rn(clamp_min(dl2, 0.0f)), kShrink), kc.w), 0.0f);
        want |= static_cast<unsigned>(__fmul_rn(mm, mm) < thr) << k;
      }
      // the chunk's clusters that some live ray that has not hit wants,
      // in ascending order
      const bool waiting = ((live & ~hits) >> lane) & 1u;
      unsigned any = __reduce_or_sync(kFull, waiting ? want : 0u);
      while (any != 0 && hits != live) {
        const int k = __ffs(any) - 1;
        any &= any - 1;
        // its rays, one bit each at their lane of phase k mod kRayLanes
        const int qk = k % kRayLanes;
        unsigned todo =
            __ballot_sync(kFull, (want >> k) & 1u) & live & ~hits;
#if SHERF_PROBE == 2
        if (todo == 0x5a5a5a5au) hits |= 1u;
        todo = 0;
#endif
        const int c = c0 + k;
        const int j1 = min(c * csize + csize, nv);
        for (int jp = c * csize; todo != 0 && jp < j1; jp += kRayPass) {
          const unsigned found = shared
              ? ray_pass<true, kRayRows>(sv, jp, j1, todo, ox, oy, oz, dx,
                                         dy, dz, ddi, thr, lane)
              : ray_pass<false, kRayRows>(sv, jp, j1, todo, ox, oy, oz, dx,
                                          dy, dz, ddi, thr, lane);
          hits |= (found >> qk) * kRayFill;
          todo &= ~found;
        }
      }
    }
    if (q == 0 && i < n) out[i] = (hits >> lane) & 1u;
  }
}

int cluster_smem_bytes(int nv, int nc) {
  return (nv + nc) * static_cast<int>(sizeof(float4));
}

// The persistent launch shared by the three cluster kernels: sizes the
// grid of `threads`-thread blocks for `units` warp units, zeroes the
// scratch words, launches.
template <typename K, typename... Args>
cudaError_t launch_units(K kernel, int threads, int units, int nv, int nc,
                         unsigned* scratch, cudaStream_t st, Args... args) {
  const int smem = cluster_smem_bytes(nv, nc);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  const int warps = threads / 32;
  err = persistent_blocks(kernel, threads, smem, (units + warps - 1) / warps,
                          &blocks);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(scratch, 0, kScratchWords * sizeof(unsigned), st);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, st>>>(args..., scratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// the most vertices the prep kernel sorts
int sherf_cluster_prep_max_vertices() { return kPrepMaxKeys; }

// queries a warp of nn_1_clustered / nn_1_shortlist takes (their visit
// grain), and queries per shortlist tile
int sherf_nn1_cluster_unit() { return kUnit; }
int sherf_nn1_shortlist_tile() { return kTile; }

// 1 <= nv <= kPrepMaxKeys; order (nv,) int64, vs (nv, 3), ctr0 (3,),
// cent (nc, 3), rad (nc,) with nc = ceil(nv / csize)
int sherf_cluster_prep(const float* ref, int nv, int csize, int sorted_mean,
                       long long* order, float* vs, float* ctr0, float* cent,
                       float* rad, void* stream) {
  if (nv < 1 || nv > kPrepMaxKeys || csize < 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nv <= 8 * kPrepThreads)
    return launch_prep<8>(ref, nv, csize, sorted_mean, order, vs, ctr0, cent,
                          rad, st);
  return launch_prep<16>(ref, nv, csize, sorted_mean, order, vs, ctr0, cent,
                         rad, st);
}

// q raw (n, 3); order null: idx in the sorted numbering; scratch:
// kScratchWords words, zeroed here
int sherf_nn1_clustered(const float* q, int n, const float* ctr0,
                        const float* v, int nv, const float* cent,
                        const float* rad, int nc, int csize,
                        const long long* order, float* d2, int* idx,
                        unsigned* scratch, void* stream) {
  return launch_units(nn1_cluster_kernel, kNnThreads, (n + kUnit - 1) / kUnit,
                      nv, nc, scratch, static_cast<cudaStream_t>(stream), q,
                      n, ctr0, v, nv, cent, rad, nc, csize, order, d2, idx);
}

// as sherf_nn1_clustered, nc <= kMaxListed; counts (T,) and ids (T, nc),
// both null or both given, receive each tile's list
int sherf_nn1_shortlist(const float* q, int n, const float* ctr0,
                        const float* v, int nv, const float* cent,
                        const float* rad, int nc, int csize,
                        const long long* order, float* d2, int* idx,
                        int* counts, int* ids, unsigned* scratch,
                        void* stream) {
  if (nc > kMaxListed) return cudaErrorInvalidValue;
  return launch_units(nn1_shortlist_kernel, kNnThreads,
                      (n + kUnit - 1) / kUnit, nv, nc, scratch,
                      static_cast<cudaStream_t>(stream), q, n, ctr0, v, nv,
                      cent, rad, nc, csize, order, d2, idx, counts, ids);
}

// o, d (n, 3) at strides (os0, os1), (ds0, ds1) in floats; o raw (the
// kernel subtracts ctr0); scratch: kScratchWords words, zeroed here
int sherf_ray_body_mask_clustered(const float* o, long long os0,
                                  long long os1, const float* d,
                                  long long ds0, long long ds1, int n,
                                  const float* ctr0, const float* v, int nv,
                                  const float* cent, const float* rad, int nc,
                                  int csize, float thr, unsigned char* out,
                                  unsigned* scratch, void* stream) {
  const float thr_root = static_cast<float>(std::sqrt(static_cast<double>(thr)));
  return launch_units(ray_mask_cluster_kernel, kRayThreads,
                      (n + kRayUnit - 1) / kRayUnit, nv, nc, scratch,
                      static_cast<cudaStream_t>(stream), o, os0, os1, d, ds0,
                      ds1, n, ctr0, v, nv, cent, rad, nc, csize, thr,
                      thr_root, out);
}

// the kernel as built: out[0] registers a thread, out[1] local (spilled)
// bytes a thread
int sherf_ray_body_mask_clustered_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t err = cudaFuncGetAttributes(&a, ray_mask_cluster_kernel);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  return cudaSuccess;
}

}  // extern "C"
