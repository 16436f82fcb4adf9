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
// leaves out id 0, whose row its callers discard).
//
// The TPU kernel builds a (P, VT) weighted multi-hot matrix in VMEM and
// contracts it with the grad tile on the MXU, skipping tiles by per-tile id
// ranges.  None of that carries over; this first version computes the
// contract directly:
//   * one warp per query row n; lanes 0..K-1 load ids[n,:] and w[n,:];
//   * per-row deduplication in registers: lane k sums the weights of every
//     j with ids[n,j] == ids[n,k] (ascending j) and keeps the sum only if no
//     j < k has the same id; the kept sum is rounded with
//     __float2bfloat16_rn and broadcast to the warp by __shfl_sync;
//   * lanes run over the C channels of the f32 grad row, round each value
//     to bf16 in registers (__float2bfloat16_rn), and every (kept tap,
//     channel) adds wq * gq to out[id, c] with an f32 atomicAdd.  wq and gq
//     are bf16 values, so their product is exact in f32.
// A tap dropped by deduplication adds its zero weight times the grad
// value, as the reference does: exactly zero for a finite value, so it is
// skipped then; NaN (0 * inf, 0 * NaN) for a non-finite one, so for those
// channels it is added.  The atomics make the order of the f32 sums change
// from run to run; results agree with the plain version within f32
// reassociation error, not bit for bit, and their NaN and inf entries
// sit in the same places.
//
// What bounds it on an H100: bytes.  The function must read ids and w
// (N*K*8 bytes) and the f32 grad rows (N*C*4) and write the table
// (S*C*4); its f32 work is N*K*C multiply-adds.  At the production train
// step's largest readout (N = 180,224, K = 8, C = 96, S = 4,097) that is
// 82 MB, 24 microseconds at 3.35 TB/s.  This version issues up to N*K*C
// atomics, and the rows that
// compaction emits in ray order hit the same sites one after another, so
// same-address atomics serialise in L2: warp aggregation of id-coherent
// runs, a shared-memory pre-reduction, or a sorted multi-hot wgmma are the
// ways to a faster kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;        // 8 warps, one row each
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 8;             // taps per row (trilinear corners)

__global__ void __launch_bounds__(kThreads)
wa_kernel(const int* __restrict__ ids, const float* __restrict__ w,
          const float* __restrict__ g, int n, int k_taps, int c_dim,
          int n_rows, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps
      + (threadIdx.x >> 5);
  if (row >= n) return;                // whole warps leave together
  int my_id = -1;
  float my_w = 0.0f;
  if (lane < k_taps) {
    my_id = ids[row * k_taps + lane];
    my_w = w[row * k_taps + lane];
  }
  // lane k (< K): f32 sum of the weights sharing its id, kept if first
  float wsum = 0.0f;
  bool first = true;
  for (int j = 0; j < k_taps; ++j) {
    const int id_j = __shfl_sync(0xffffffffu, my_id, j);
    const float w_j = __shfl_sync(0xffffffffu, my_w, j);
    if (id_j == my_id) {
      wsum += w_j;
      if (j < lane) first = false;
    }
  }
  const bool keep = lane < k_taps && first
      && static_cast<unsigned>(my_id) < static_cast<unsigned>(n_rows);
  const float wq = keep ? __bfloat162float(__float2bfloat16_rn(wsum)) : 0.0f;
  int tap_id[kMaxK];
  float tap_w[kMaxK];
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    tap_id[k] = __shfl_sync(0xffffffffu, my_id, k);
    tap_w[k] = __shfl_sync(0xffffffffu, wq, k);
  }
  const unsigned kept = __ballot_sync(0xffffffffu, keep);
  // in-range taps that deduplication dropped (their weight wq is 0)
  const unsigned dropped = __ballot_sync(
      0xffffffffu, lane < k_taps && !first
      && static_cast<unsigned>(my_id) < static_cast<unsigned>(n_rows));
  const float* grow = g + row * c_dim;
  for (int c = lane; c < c_dim; c += 32) {
    const float gq = __bfloat162float(__float2bfloat16_rn(grow[c]));
    const unsigned taps = isfinite(gq) ? kept : (kept | dropped);
#pragma unroll
    for (int k = 0; k < kMaxK; ++k) {
      if (taps >> k & 1u) {
        atomicAdd(out + static_cast<long long>(tap_id[k]) * c_dim + c,
                  tap_w[k] * gq);
      }
    }
  }
}

}  // namespace

extern "C" {

int sherf_wa_max_taps() { return kMaxK; }

// out must hold n_rows * c zeros; g is (n, c) f32.
int sherf_weighted_accumulate(const int* ids, const float* w, const float* g,
                              int n, int k, int c, int n_rows, float* out,
                              void* stream) {
  const long long blocks = (static_cast<long long>(n) + kWarps - 1) / kWarps;
  wa_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      ids, w, g, n, k, c, n_rows, out);
  return cudaGetLastError();
}

}  // extern "C"
