// Batched pairwise Jensen-Shannon divergence for Hopper (sm_90a), CUDA C++
// with a plain C interface (bound with ctypes by
// repro_torch/kernels/pairwise_js.py).
//
// Replaces the Pallas TPU kernel `pairwise_js`
// (src/repro/kernels/pairwise_js.py, body `_pjs_kernel`): p (N, B) and
// q (M, B) nonnegative fp32 histograms -> out (N, M) fp32 with
//   p_i = (p[i] + eps) / sum(p[i] + eps),  q_j likewise
//   out[i, j] = JS(p_i, q_j) = 0.5 sum_b [p log(p/m) + q log(q/m)],
//   m = (p_i + q_j) / 2
// An all-zero row normalises to the eps-uniform histogram and stays finite
// (the signature index passes its whole capacity block, inactive rows
// included).
//
// The Pallas kernel writes the same JS as 0.5 (hp_i + hq_j) - sum m log m
// with the negentropies hp = sum p log p. At 64 buckets those are about
// -4 each and JS about 0.01, so that form cancels: its fp32 result moved
// by about 1e-6 against the plain version on this card. The grouper ranks
// jobs by these values, and the join storm of flash_crowd_10k has
// shortlist boundaries whose two sides differ by less than 1e-6. The KL
// form sums small terms without cancellation (about 1e-8 from the plain
// version), at two logs per bucket instead of one.
//
// What bounds it on this card: every pair costs 2 B logs and divisions,
// and each row is read once, so at the grouping plane's shapes it is
// bound by fp32 operations once N reaches a few rows (about 10 N M B
// operations against 4 (N B + M B + N M) bytes); at N = 1 (one request
// against the fleet) it is bound by the bytes of q and by the launch.
//
// Design (simple and correct first):
//   * The grouper asks with N = 1 request against M = the index capacity,
//     so the parallelism comes from M: one warp per q row, 8 warps per
//     block, grid (ceil(M / 8), ceil(N / TN)).
//   * Each block first stages its TN p rows, normalised, in shared memory
//     (a warp per row). TN * B <= 2048, so TN = 32 at B = 64.
//   * Each warp loads its q row coalesced (lanes over buckets), normalises
//     it into its own shared strip, then for each staged p row sums the KL
//     terms over the buckets (lanes stride 32) with a warp shuffle
//     reduction; lane 0 writes out[i, j].
//   * Accurate logf and IEEE division (no fast math), all fp32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileFloats = 2048;  // TN * B of the staged p tile
constexpr int kMaxBuckets = 1024;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// normalise row `src` (B floats) with the eps shift into `dst` (shared
// memory); the warp's lanes stride over the buckets
__device__ void stage_row(const float* __restrict__ src, float* dst, int B,
                          float eps, int lane) {
  float s = 0.f;
  for (int b = lane; b < B; b += 32) s += __ldg(src + b) + eps;
  s = warp_sum(s);
  for (int b = lane; b < B; b += 32) dst[b] = (__ldg(src + b) + eps) / s;
}

__global__ void __launch_bounds__(kThreads)
pairwise_js_kernel(const float* __restrict__ p, const float* __restrict__ q,
                   float* __restrict__ out, int N, int M, int B, int TN,
                   float eps) {
  extern __shared__ float smem[];
  float* ps = smem;                    // (TN, B) normalised p rows
  float* qs = ps + TN * B;             // (kWarps, B) one q row per warp
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i0 = blockIdx.y * TN;
  const int tn = min(TN, N - i0);

  for (int r = warp; r < tn; r += kWarps)
    stage_row(p + static_cast<long long>(i0 + r) * B, ps + r * B, B, eps,
              lane);
  __syncthreads();

  const int j = blockIdx.x * kWarps + warp;
  if (j >= M) return;
  float* qrow = qs + warp * B;
  stage_row(q + static_cast<long long>(j) * B, qrow, B, eps, lane);
  __syncwarp();
  for (int r = 0; r < tn; ++r) {
    const float* prow = ps + r * B;
    float kl = 0.f;  // sum over b of p log(p/m) + q log(q/m)
    for (int b = lane; b < B; b += 32) {
      const float pv = prow[b], qv = qrow[b];
      const float m = 0.5f * (pv + qv);
      kl += pv * logf(pv / m) + qv * logf(qv / m);
    }
    kl = warp_sum(kl);
    if (lane == 0) out[static_cast<long long>(i0 + r) * M + j] = 0.5f * kl;
  }
}

}  // namespace

extern "C" {

// p (N, B) and q (M, B) fp32 row-major contiguous; writes out (N, M).
// Returns the CUDA error of the launch (0 on success).
int pairwise_js_fwd(const void* p, const void* q, void* out, int N, int M,
                    int B, float eps, void* stream) {
  if (N <= 0 || M <= 0) return 0;
  if (B <= 0 || B > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tn = max(1, min(32, kTileFloats / B));
  const dim3 grid((M + kWarps - 1) / kWarps, (N + tn - 1) / tn);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      (static_cast<size_t>(tn) + kWarps) * B * sizeof(float);
  pairwise_js_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(q),
      static_cast<float*>(out), N, M, B, tn, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
