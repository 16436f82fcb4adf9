// Morton-clustered nearest-vertex kernels for Hopper (sm_90a):
// nn_1_clustered, nn_1_shortlist and ray_body_mask_clustered.
//
// nn1_cluster_kernel replaces _knn_cluster_kernel / nn_1_clustered_pallas
// (sherf_tpu/kernels/knn_pallas.py:159, :207); nn1_shortlist_kernel replaces
// _knn_shortlist_kernel / nn_1_shortlist_pallas (:277, :318);
// ray_cluster_kernel replaces _ray_seg_cluster_kernel /
// ray_body_mask_clustered_pallas (:461, :501).  They compute the contracts
// of nn_1 and ray_body_mask (csrc/knn.cu) over vertices that the wrapper
// (sherf_tpu_torch/kernels/knn_cluster.py) has Morton-sorted, centred and
// cut into clusters of consecutive rows, each with a centroid and an
// inflated radius, and they scan only the clusters a bound admits:
//
//   nn_1_clustered: one thread per query.  best starts at
//     min_c (d_c + r_c)^2 * (1 + 1e-5) + 1e-12; clusters are taken in
//     ascending order and a warp scans cluster c when any of its lanes has
//     max(d_c - r_c, 0)^2 <= best (__any_sync: the decision is warp-uniform,
//     and every lane of a visiting warp scans).
//   nn_1_shortlist: one block of P_TILE threads per tile of queries.  The
//     wrapper has sorted each tile's clusters by a lower bound and counted
//     the ones that may hold a nearest vertex; the block reads that count
//     and the ids from device memory (no host sync), stages each listed
//     cluster into shared memory in turn, and every thread scans it.
//   ray_body_mask_clustered: one thread per ray.  A warp scans cluster c
//     while any lane that has not hit has
//     max(sqrt(dl2) * (1 - 1e-5) - r_c, 0)^2 < thr, dl2 the squared distance
//     from its line to the centroid; a hit lane stops scanning.
//
// Inside a cluster the distance arithmetic is csrc/knn.cu's: exact
// elementwise f32 with the round-to-nearest intrinsics, which nvcc never
// contracts into FMAs, and a strict '<' over ascending rows.  The bounds
// use the same intrinsics and __fsqrt_rn, with every inflation factor as
// the wrapper's f32 constants, so they round as the plain torch versions
// in knn_cluster.py (which apply the same warp-grain visit rule) do, and
// kernel and plain version are bit-equal.  Padding rows of the last
// cluster are never read.
//
// What bounds them on an H100: operations, counted over the pairs a visit
// admits (9 f32 operations per (query, vertex) pair for the two nearest-
// vertex kernels, 17 for the ray kernel), which depend on the data.
// Design: B5 and B7 stage the cluster table and every vertex once per
// block into dynamic shared memory as float4 (6890 + 54 rows * 16 B =
// 111 KB), so a visit is a run of broadcast reads with no global traffic;
// B6 stages one cluster (256 * 16 B) at a time per block of 512 queries.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // = RSEG_P, rays (or queries) per block
// the wrapper's f32 constants: each is the double rounded once to float
constexpr float kGrow = static_cast<float>(1.0 + 1e-5);
constexpr float kShrink = static_cast<float>(1.0 - 1e-5);
constexpr float kUbFloor = static_cast<float>(1e-12);
constexpr float kDdFloor = static_cast<float>(1e-12);

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

// sc[c] = (centroid, radius) of cluster c; sv[j] = sorted vertex j
__device__ __forceinline__ void stage_clusters(
    const float* __restrict__ v, int nv, const float* __restrict__ cent,
    const float* __restrict__ rad, int nc, float4* sc, float4* sv) {
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    sc[c] = make_float4(cent[3 * c], cent[3 * c + 1], cent[3 * c + 2], rad[c]);
  }
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    sv[j] = make_float4(v[3 * j], v[3 * j + 1], v[3 * j + 2], 0.0f);
  }
}

// distance from (qx, qy, qz) to the centroid of c: sqrt of (q - c)^2 summed
__device__ __forceinline__ float centroid_dist(float4 c, float qx, float qy,
                                               float qz) {
  return __fsqrt_rn(sq3(__fsub_rn(qx, c.x), __fsub_rn(qy, c.y),
                        __fsub_rn(qz, c.z)));
}

__global__ void __launch_bounds__(kThreads)
nn1_cluster_kernel(const float* __restrict__ q, int n,
                   const float* __restrict__ v, int nv,
                   const float* __restrict__ cent,
                   const float* __restrict__ rad, int nc, int csize,
                   float* __restrict__ d2_out, int* __restrict__ idx_out) {
  extern __shared__ float4 smem[];
  float4* sc = smem;
  float4* sv = smem + nc;
  stage_clusters(v, nv, cent, rad, nc, sc, sv);
  __syncthreads();
  // every thread stays to the end: the visit votes need whole warps
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float qx = live ? q[3 * i] : 0.0f;
  const float qy = live ? q[3 * i + 1] : 0.0f;
  const float qz = live ? q[3 * i + 2] : 0.0f;
  float ub = INFINITY;
  for (int c = 0; c < nc; ++c) {
    const float4 k = sc[c];
    const float t = __fadd_rn(centroid_dist(k, qx, qy, qz), k.w);
    ub = fminf(ub, __fmul_rn(t, t));
  }
  float best = __fadd_rn(__fmul_rn(ub, kGrow), kUbFloor);
  int best_i = 0;
  for (int c = 0; c < nc; ++c) {
    const float4 k = sc[c];
    const float m = fmaxf(__fsub_rn(centroid_dist(k, qx, qy, qz), k.w), 0.0f);
    const bool want = live && __fmul_rn(m, m) <= best;
    if (!__any_sync(0xffffffffu, want)) continue;
    const int j1 = min(c * csize + csize, nv);
    for (int j = c * csize; j < j1; ++j) {
      const float4 p = sv[j];
      const float d = sq3(__fsub_rn(p.x, qx), __fsub_rn(p.y, qy),
                          __fsub_rn(p.z, qz));
      if (d < best) {
        best = d;
        best_i = j;
      }
    }
  }
  if (live) {
    d2_out[i] = best;
    idx_out[i] = best_i;
  }
}

__global__ void
nn1_shortlist_kernel(const float* __restrict__ q, int n,
                     const float* __restrict__ v, int nv,
                     const int* __restrict__ counts,
                     const int* __restrict__ ids, int nc, int csize,
                     float* __restrict__ d2_out, int* __restrict__ idx_out) {
  extern __shared__ float4 sv[];
  const int t = blockIdx.x;
  const int i = t * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float qx = live ? q[3 * i] : 0.0f;
  const float qy = live ? q[3 * i + 1] : 0.0f;
  const float qz = live ? q[3 * i + 2] : 0.0f;
  float best = INFINITY;
  int best_i = 0;
  const int cnt = counts[t];
  for (int s = 0; s < cnt; ++s) {
    const int j0 = ids[static_cast<long long>(t) * nc + s] * csize;
    const int rows = min(csize, nv - j0);
    __syncthreads();  // the previous cluster's scan is done with sv
    for (int j = threadIdx.x; j < rows; j += blockDim.x) {
      sv[j] = make_float4(v[3 * (j0 + j)], v[3 * (j0 + j) + 1],
                          v[3 * (j0 + j) + 2], 0.0f);
    }
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      const float4 p = sv[j];
      const float d = sq3(__fsub_rn(p.x, qx), __fsub_rn(p.y, qy),
                          __fsub_rn(p.z, qz));
      if (d < best) {
        best = d;
        best_i = j0 + j;
      }
    }
  }
  if (live) {
    d2_out[i] = best;
    idx_out[i] = best_i;
  }
}

// a - b*b*dd_inv with w = p - o, a = |w|^2, b = d.w
__device__ __forceinline__ float line_dist(float px, float py, float pz,
                                           float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float dd_inv) {
  const float w0 = __fsub_rn(px, ox);
  const float w1 = __fsub_rn(py, oy);
  const float w2 = __fsub_rn(pz, oz);
  const float a = sq3(w0, w1, w2);
  const float b = __fadd_rn(__fadd_rn(__fmul_rn(dx, w0), __fmul_rn(dy, w1)),
                            __fmul_rn(dz, w2));
  return __fsub_rn(a, __fmul_rn(__fmul_rn(b, b), dd_inv));
}

__global__ void __launch_bounds__(kThreads)
ray_cluster_kernel(const float* __restrict__ o, const float* __restrict__ dir,
                   int n, const float* __restrict__ v, int nv,
                   const float* __restrict__ cent,
                   const float* __restrict__ rad, int nc, int csize,
                   float thr, unsigned char* __restrict__ out) {
  extern __shared__ float4 smem[];
  float4* sc = smem;
  float4* sv = smem + nc;
  stage_clusters(v, nv, cent, rad, nc, sc, sv);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  const float ox = live ? o[3 * i] : 0.0f;
  const float oy = live ? o[3 * i + 1] : 0.0f;
  const float oz = live ? o[3 * i + 2] : 0.0f;
  const float dx = live ? dir[3 * i] : 0.0f;
  const float dy = live ? dir[3 * i + 1] : 0.0f;
  const float dz = live ? dir[3 * i + 2] : 0.0f;
  const float dd_inv = __fdiv_rn(1.0f, fmaxf(sq3(dx, dy, dz), kDdFloor));
  bool hit = false;
  for (int c = 0; c < nc; ++c) {
    const float4 k = sc[c];
    const float dl2 = fmaxf(
        line_dist(k.x, k.y, k.z, ox, oy, oz, dx, dy, dz, dd_inv), 0.0f);
    const float m = fmaxf(__fsub_rn(__fmul_rn(__fsqrt_rn(dl2), kShrink), k.w),
                          0.0f);
    const bool want = live && !hit && __fmul_rn(m, m) < thr;
    if (!__any_sync(0xffffffffu, want)) continue;
    const int j1 = min(c * csize + csize, nv);
    for (int j = c * csize; j < j1 && !hit; ++j) {
      const float4 p = sv[j];
      hit = line_dist(p.x, p.y, p.z, ox, oy, oz, dx, dy, dz, dd_inv) < thr;
    }
  }
  if (live) out[i] = hit ? 1 : 0;
}

int cluster_smem_bytes(int nv, int nc) {
  return (nv + nc) * static_cast<int>(sizeof(float4));
}

}  // namespace

extern "C" {

int sherf_nn1_clustered(const float* q, int n, const float* v, int nv,
                        const float* cent, const float* rad, int nc, int csize,
                        float* d2, int* idx, void* stream) {
  const int smem = cluster_smem_bytes(nv, nc);
  cudaError_t err = cudaFuncSetAttribute(
      nn1_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kThreads - 1) / kThreads;
  nn1_cluster_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      q, n, v, nv, cent, rad, nc, csize, d2, idx);
  return cudaGetLastError();
}

// one block of p_tile threads per tile; counts (T,), ids (T, nc)
int sherf_nn1_shortlist(const float* q, int n, const float* v, int nv,
                        const int* counts, const int* ids, int nc, int csize,
                        int p_tile, float* d2, int* idx, void* stream) {
  const int smem = csize * static_cast<int>(sizeof(float4));
  cudaError_t err = cudaFuncSetAttribute(
      nn1_shortlist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + p_tile - 1) / p_tile;
  nn1_shortlist_kernel<<<blocks, p_tile, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      q, n, v, nv, counts, ids, nc, csize, d2, idx);
  return cudaGetLastError();
}

int sherf_ray_body_mask_clustered(const float* o, const float* d, int n,
                                  const float* v, int nv, const float* cent,
                                  const float* rad, int nc, int csize,
                                  float thr, unsigned char* out,
                                  void* stream) {
  const int smem = cluster_smem_bytes(nv, nc);
  cudaError_t err = cudaFuncSetAttribute(
      ray_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kThreads - 1) / kThreads;
  ray_cluster_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      o, d, n, v, nv, cent, rad, nc, csize, thr, out);
  return cudaGetLastError();
}

}  // extern "C"
