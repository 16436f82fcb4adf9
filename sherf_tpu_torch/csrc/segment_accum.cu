// Table-gradient accumulation for Hopper (sm_90a): weighted_accumulate.
//
// Replaces the Pallas kernel _waccum_kernel / weighted_accumulate
// (sherf_tpu/kernels/segment_accum.py:48, :93), the adjoint of the K-tap
// table readout out[n] = sum_k w[n,k] * table[ids[n,k]]:
//
//   d_table[s] = sum over (n, k) with ids[n,k] == s of wq[n,k] * gq[n]
//
// with the declared precision of the JAX fallback _scatter_accumulate
// (:141-154): inside one row, duplicate ids first sum their f32 weights and
// the FIRST occurrence carries the sum (the later ones carry zero); that
// weight and the grad row are rounded to bf16 (round to nearest even);
// products and accumulation are f32.  Ids outside [0, n_rows) are dropped.
// Row 0 is computed like every other row (the Pallas kernel's tile skip
// leaves out id 0, whose row its callers discard).  A tap that
// deduplication zeroed still adds 0 * g, which is NaN where the bf16 grad
// value is not finite.
//
// What bounds it on an H100: bytes.  The function must read ids and w
// (N*K*8 bytes) and the f32 grad rows (N*C*4) and write the table
// (S*C*4); its f32 work is N*K*C multiply-adds.  At the production train
// step's largest readout (N = 180,224, K = 8, C = 96, S = 4,097) that is
// 82 MB, 24 microseconds at 3.35 TB/s.
//
// What held the first version back: it added every (tap, channel) product
// to device memory with an f32 atomicAdd, N*K*C of them, and the readout's
// taps pile onto few addresses (id 0, the zero row, takes every empty or
// out-of-volume corner: 27%, 56% and 90% of the taps of the production
// step's three calls), so same-address atomics serialised in L2.
//
// What did not pay (PERF.md §6 has the times): a table tile privatised in
// shared memory.  sm_90a has no native shared-memory f32 atomic add (the
// SASS is a compare-and-swap loop, ATOMS.CAST.SPIN), a 197 KB tile holds
// only 12 of the 96 channels, so every row was read and deduplicated once
// per slice, and its CAS chains summed the zero row in one long sequence
// whose rounding drifted ~1e-5 from the plain version's.  Nor did lanes =
// (tap, channel quarter), which deduplicated with __match_any_sync and
// shuffles under partial masks (WARPSYNC.COLLECTIVE loops in the SASS).
//
// This version: a warp owns a contiguous run of rows (the rows split
// evenly over the warps that fit on the card at once), and every decision
// in its loop is the same in all lanes:
//   * lane = channel: lane c owns channels c, c + 32, c + 64 of a pass of
//     96 (more channels, more passes over the rows), so the grad loads
//     and the reductions into the table are coalesced 128-byte rows;
//   * per row, loaded one row ahead: the 8 ids and weights (two 16-byte
//     loads each at K = 8, the same in every lane) and the lane's grad
//     values;
//     lanes 0-7 deduplicate one tap each against the other 7 (ascending
//     taps, as the plain version sums) and shuffle the bf16 weights out;
//   * each tap slot carries its sums in registers while its id stays the
//     same (consecutive samples in one cell) and adds them to the table
//     with f32 reductions (RED in L2, which does not stall the warp) when
//     it changes; taps on the zero row sum into a register of their own,
//     added once per warp at the end;
//   * a product that is exactly zero adds nothing (the sum never holds
//     -0), so only NaN survives from a zeroed tap, as required.
// The f32 sums happen in an order that changes from run to run; results
// agree with the plain version within f32 reassociation error, not bit for
// bit, and their NaN and inf entries sit in the same places.  The short
// register sums and the per-warp zero-row sums keep the hot row's rounding
// error well below that of one long sequential sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;                 // taps per row (trilinear corners)
constexpr int kCPL = 3;                  // channels a lane carries per tap
constexpr int kPass = 32 * kCPL;         // channels per pass over the rows

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One row's taps, the same in every lane: ids (-1 past K) and weights.
template <bool kVec8>
__device__ __forceinline__ void load_taps(const int* __restrict__ ids,
                                          const float* __restrict__ w,
                                          long long row, int k_taps,
                                          int (&id)[kMaxK],
                                          float (&wt)[kMaxK]) {
  if (kVec8) {
    const int4* i4 = reinterpret_cast<const int4*>(ids + row * kMaxK);
    const float4* w4 = reinterpret_cast<const float4*>(w + row * kMaxK);
    const int4 a = i4[0], b = i4[1];
    const float4 u = w4[0], v = w4[1];
    id[0] = a.x; id[1] = a.y; id[2] = a.z; id[3] = a.w;
    id[4] = b.x; id[5] = b.y; id[6] = b.z; id[7] = b.w;
    wt[0] = u.x; wt[1] = u.y; wt[2] = u.z; wt[3] = u.w;
    wt[4] = v.x; wt[5] = v.y; wt[6] = v.z; wt[7] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      id[j] = j < k_taps ? ids[row * k_taps + j] : -1;
      wt[j] = j < k_taps ? w[row * k_taps + j] : 0.0f;
    }
  }
}

// kVec8: K == 8 with ids and w 16-byte aligned (vector loads of a row)
template <bool kVec8>
__global__ void __launch_bounds__(kThreads, 2)
wa_kernel(const int* __restrict__ ids, const float* __restrict__ w,
          const float* __restrict__ g, int n, int k_taps, int c_dim,
          int n_rows, int rows_per_warp, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int kd = lane % kMaxK;                 // the tap this lane dedups
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads
                          + threadIdx.x) >> 5;
  const long long r0 = warp * rows_per_warp;
  if (r0 >= n) return;                          // whole warps leave
  const long long r1 = min(r0 + rows_per_warp, static_cast<long long>(n));
  for (int cb = 0; cb < c_dim; cb += kPass) {
    int cid[kMaxK];                             // each tap's carried id
    float carry[kMaxK][kCPL], z[kCPL];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      cid[j] = -1;
#pragma unroll
      for (int i = 0; i < kCPL; ++i) carry[j][i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kCPL; ++i) z[i] = 0.0f;
    // the next row, loaded one row ahead
    int id_n[kMaxK];
    float w_n[kMaxK], g_n[kCPL];
    load_taps<kVec8>(ids, w, r0, k_taps, id_n, w_n);
#pragma unroll
    for (int i = 0; i < kCPL; ++i) {
      const int c = cb + lane + 32 * i;
      g_n[i] = c < c_dim ? g[r0 * c_dim + c] : 0.0f;
    }
    for (long long row = r0; row < r1; ++row) {
      int id[kMaxK];
      float wt[kMaxK], gq[kCPL];
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        id[j] = id_n[j];
        wt[j] = w_n[j];
      }
#pragma unroll
      for (int i = 0; i < kCPL; ++i) gq[i] = bf16_round(g_n[i]);
      if (row + 1 < r1) {
        load_taps<kVec8>(ids, w, row + 1, k_taps, id_n, w_n);
#pragma unroll
        for (int i = 0; i < kCPL; ++i) {
          const int c = cb + lane + 32 * i;
          if (c < c_dim) g_n[i] = g[(row + 1) * c_dim + c];
        }
      }
      // lane kd: the f32 sum of the row's weights on tap kd's id, kept if
      // kd is that id's first tap (ascending taps, as the plain version)
      int my_id = id[0];
#pragma unroll
      for (int j = 1; j < kMaxK; ++j) my_id = kd == j ? id[j] : my_id;
      float wsum = 0.0f;
      bool first = true;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (id[j] == my_id && j < k_taps) {
          wsum = __fadd_rn(wsum, wt[j]);
          if (j < kd) first = false;
        }
      }
      const float wq_mine = first ? bf16_round(wsum) : 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        const float wq = __shfl_sync(0xffffffffu, wq_mine, j);
        // everything below is the same in every lane: no divergence
        if (j >= k_taps
            || static_cast<unsigned>(id[j]) >= static_cast<unsigned>(n_rows))
          continue;
        if (id[j] == 0) {                       // the zero row
#pragma unroll
          for (int i = 0; i < kCPL; ++i)
            z[i] = __fadd_rn(z[i], __fmul_rn(wq, gq[i]));
          continue;
        }
        const bool fresh = id[j] != cid[j];
        if (fresh) {
          if (cid[j] >= 0) {
#pragma unroll
            for (int i = 0; i < kCPL; ++i) {
              const int c = cb + lane + 32 * i;
              if (c < c_dim && carry[j][i] != 0.0f)     // NaN too
                atomicAdd(out + static_cast<long long>(cid[j]) * c_dim + c,
                          carry[j][i]);
            }
          }
          cid[j] = id[j];
        }
#pragma unroll
        for (int i = 0; i < kCPL; ++i) {
          const float p = __fmul_rn(wq, gq[i]);          // exact: bf16 x bf16
          carry[j][i] = fresh ? p : __fadd_rn(carry[j][i], p);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kCPL; ++i) {
      const int c = cb + lane + 32 * i;
      if (c >= c_dim) continue;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j)
        if (cid[j] >= 0 && carry[j][i] != 0.0f)
          atomicAdd(out + static_cast<long long>(cid[j]) * c_dim + c,
                    carry[j][i]);
      if (z[i] != 0.0f) atomicAdd(out + c, z[i]);
    }
  }
}

struct Plan {
  int rows_per_warp, warps, blocks, vec8;
};

// Rows per warp: the rows split evenly over the warps that fit on the card
// at once (one wave).  Returns false if the device cannot be queried.
bool plan(int n, int k, const void* ids, const void* w, Plan* p) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return false;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  p->vec8 = k == kMaxK
      && reinterpret_cast<unsigned long long>(ids) % 16 == 0
      && reinterpret_cast<unsigned long long>(w) % 16 == 0;
  if (p->vec8)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wa_kernel<true>,
                                                  kThreads, 0);
  else
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wa_kernel<false>,
                                                  kThreads, 0);
  if (sms <= 0 || per_sm <= 0) return false;
  const long long resident = static_cast<long long>(sms) * per_sm * kWarps;
  p->rows_per_warp = static_cast<int>(
      std::max(1LL, (static_cast<long long>(n) + resident - 1) / resident));
  p->warps = (n + p->rows_per_warp - 1) / p->rows_per_warp;
  p->blocks = (p->warps + kWarps - 1) / kWarps;
  return true;
}

}  // namespace

extern "C" {

int sherf_wa_max_taps() { return kMaxK; }

// How a call of n rows, k taps and c channels runs: {rows per warp, warps,
// blocks, passes over the rows, vector loads of the taps}, for 16-byte
// aligned ids and w.  Returns 0, or -1 if the device cannot be queried.
int sherf_wa_tiling(int n, int k, int c, int* out5) {
  Plan p;
  if (n <= 0 || c <= 0 || !plan(n, k, nullptr, nullptr, &p)) return -1;
  const int v[5] = {p.rows_per_warp, p.warps, p.blocks,
                    (c + kPass - 1) / kPass, p.vec8};
  for (int i = 0; i < 5; ++i) out5[i] = v[i];
  return 0;
}

// out must hold n_rows * c zeros; g is (n, c) f32.
int sherf_weighted_accumulate(const int* ids, const float* w, const float* g,
                              int n, int k, int c, int n_rows, float* out,
                              void* stream) {
  Plan p;
  if (!plan(n, k, ids, w, &p)) return cudaErrorInvalidDevice;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p.vec8)
    wa_kernel<true><<<p.blocks, kThreads, 0, st>>>(
        ids, w, g, n, k, c, n_rows, p.rows_per_warp, out);
  else
    wa_kernel<false><<<p.blocks, kThreads, 0, st>>>(
        ids, w, g, n, k, c, n_rows, p.rows_per_warp, out);
  return cudaGetLastError();
}

}  // extern "C"
