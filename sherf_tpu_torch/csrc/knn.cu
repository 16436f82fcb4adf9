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
// costs ~9 f32 operations (3 sub, 3 mul, 2 add, 1 compare; ray_body_mask
// ~17), and every vertex is reused by every query, so the bytes moved are
// tiny next to N*V*9 operations.  chip_smoke.py states the bound against
// the 67 TFLOP/s f32 CUDA-core peak, which counts an FMA as two operations;
// this code issues no FMA (see below), one operation per issue slot, so
// the ceiling it can reach is about twice that bound.
// Design: the whole vertex set is staged once per block into dynamic shared
// memory as float4 (6890 * 16 B = 110 KB, under the 227 KB a block may
// use, set with cudaFuncSetAttribute); one thread per query keeps a running
// (min, argmin) in registers; every thread of a warp reads the same vertex,
// so each shared-memory load is a broadcast with no bank conflict.  The
// scan order is ascending with a strict '<', so the lowest index wins ties,
// as in the Pallas kernel.
//
// The distance arithmetic uses the round-to-nearest intrinsics
// (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn): nvcc may not contract them
// into FMAs, so each operation rounds exactly as eager PyTorch's separate
// elementwise kernels do, and the plain torch versions in
// sherf_tpu_torch/kernels/knn.py are bit-equal to these kernels.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // = RSEG_P, the Pallas ray tile

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

__device__ __forceinline__ void stage_vertices(const float* __restrict__ v,
                                               int nv, float4* sv) {
  for (int j = threadIdx.x; j < nv; j += blockDim.x) {
    sv[j] = make_float4(v[3 * j], v[3 * j + 1], v[3 * j + 2], 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads)
nn1_kernel(const float* __restrict__ q, int n, const float* __restrict__ v,
           int nv, float* __restrict__ d2_out, int* __restrict__ idx_out) {
  extern __shared__ float4 sv[];
  stage_vertices(v, nv, sv);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float qx = q[3 * i], qy = q[3 * i + 1], qz = q[3 * i + 2];
  float best = INFINITY;
  int best_i = 0;
  for (int j = 0; j < nv; ++j) {
    const float4 p = sv[j];
    const float d = sq3(__fsub_rn(p.x, qx), __fsub_rn(p.y, qy),
                        __fsub_rn(p.z, qz));
    if (d < best) {
      best = d;
      best_i = j;
    }
  }
  d2_out[i] = best;
  idx_out[i] = best_i;
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

}  // namespace

extern "C" {

int sherf_knn_max_vertices() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin / static_cast<int>(sizeof(float4));
}

int sherf_nn1(const float* q, int n, const float* v, int nv, float* d2,
              int* idx, void* stream) {
  const int smem = smem_bytes(nv);
  cudaError_t err = cudaFuncSetAttribute(
      nn1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + kThreads - 1) / kThreads;
  nn1_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, n, v, nv, d2, idx);
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
