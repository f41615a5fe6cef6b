// Fused fleet drift scoring for Hopper (sm_90a), CUDA C++ with a plain C
// interface (bound with ctypes by repro_torch/kernels/fleet_drift.py).
//
// Replaces the Pallas TPU kernel `fleet_drift`
// (src/repro/kernels/fleet_drift.py, body `_fleet_drift_kernel`): every
// stream's live window of tokens (N, T) int32 becomes a histogram over B
// buckets, normalised, and is scored with Jensen-Shannon divergence
// against the stream's reference row (N, B) fp32:
//   bucket(t) = clip((t * B) // vocab, 0, B - 1)   vocab > 0 (floor div)
//             = t mod B (floor modulo, in [0, B))  vocab == 0
//   h = counts / max(sum counts, 1)
//   p = (h + eps) / sum(h + eps),  q = (ref + eps) / sum(ref + eps)
//   score = 0.5 * (KL(p || m) + KL(q || m)),  m = (p + q) / 2
// Outputs scores (N,) and hists h (N, B), both fp32.
//
// What bounds it on this card: each token is read once and costs a bucket
// computation and one shared-memory increment; each row then does O(B)
// arithmetic with two logs per bucket. At the drift plane's shape (T = 256
// tokens, B = 64) that is about 2.5 operations per byte moved, far below
// the card's balance: it is bound by device-memory bytes (tokens in, the
// reference in, hists out).
//
// Design (simple and correct first):
//   * One warp per stream row, 8 warps per block, no block-wide
//     synchronisation, so a ragged last block just idles its extra warps.
//   * The Pallas kernel has no scatter and histograms with a one-hot
//     compare over a (rows, T, B) broadcast. Here each warp owns B integer
//     counters in shared memory and its lanes `atomicAdd` into them:
//     exact counts, one shared-memory atomic per token.
//   * Tokens are read coalesced: 16-byte loads (4 tokens a lane) where T is
//     a multiple of 4, so each row starts 16-byte aligned; scalar loads
//     otherwise.
//   * The bucket of `t * B // vocab` is computed in 64 bits, so a large
//     vocabulary cannot overflow; with the clip, C's truncating division
//     gives the floor's bucket for every t. The modulo bucket is
//     ((t % B) + B) % B: C's % is negative for a negative t.
//   * JS: lanes walk the buckets with stride 32; the three row sums
//     (sum of p, sum of q, the KL terms) are warp shuffle reductions.
//     Accurate logf and IEEE division (no fast math): the host rescores in
//     float64 only within 1e-4 of the threshold, on the premise that the
//     fp32 error is about 1e-7.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// the warps' counters must fit the default 48 KB of shared memory
constexpr int kMaxBuckets = 48 * 1024 / (kWarps * 4);

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int bucket_of(int t, int B, int vocab) {
  if (vocab > 0) {
    long long b = (static_cast<long long>(t) * B) / vocab;
    return b < 0 ? 0 : (b > B - 1 ? B - 1 : static_cast<int>(b));
  }
  int b = t % B;
  return b < 0 ? b + B : b;
}

__global__ void __launch_bounds__(kThreads)
fleet_drift_kernel(const int* __restrict__ tokens,
                   const float* __restrict__ ref, float* __restrict__ scores,
                   float* __restrict__ hists, int N, int T, int B, int vocab,
                   float eps, int vec) {
  extern __shared__ int smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= N) return;
  int* counts = smem + warp * B;
  for (int b = lane; b < B; b += 32) counts[b] = 0;
  __syncwarp();

  const int* trow = tokens + row * T;
  if (vec) {
    const int4* t4 = reinterpret_cast<const int4*>(trow);
    const int n4 = T >> 2;
#pragma unroll 4
    for (int i = lane; i < n4; i += 32) {
      const int4 v = __ldg(t4 + i);
      atomicAdd(&counts[bucket_of(v.x, B, vocab)], 1);
      atomicAdd(&counts[bucket_of(v.y, B, vocab)], 1);
      atomicAdd(&counts[bucket_of(v.z, B, vocab)], 1);
      atomicAdd(&counts[bucket_of(v.w, B, vocab)], 1);
    }
  } else {
#pragma unroll 4
    for (int i = lane; i < T; i += 32)
      atomicAdd(&counts[bucket_of(__ldg(trow + i), B, vocab)], 1);
  }
  __syncwarp();

  // every token lands in a bucket, so the counts sum to T exactly
  const float total = fmaxf(static_cast<float>(T), 1.0f);
  const float* rrow = ref + row * B;
  float* hrow = hists + row * B;
  float sp = 0.f, sq = 0.f;
  for (int b = lane; b < B; b += 32) {
    const float h = static_cast<float>(counts[b]) / total;
    hrow[b] = h;
    sp += h + eps;
    sq += __ldg(rrow + b) + eps;
  }
  sp = warp_sum(sp);
  sq = warp_sum(sq);

  float kl = 0.f;  // sum over b of p log(p/m) + q log(q/m)
  for (int b = lane; b < B; b += 32) {
    const float p = (static_cast<float>(counts[b]) / total + eps) / sp;
    const float q = (__ldg(rrow + b) + eps) / sq;
    const float m = 0.5f * (p + q);
    kl += p * logf(p / m) + q * logf(q / m);
  }
  kl = warp_sum(kl);
  if (lane == 0) scores[row] = 0.5f * kl;
}

}  // namespace

extern "C" {

// tokens (N, T) int32 and ref (N, B) fp32, both row-major contiguous;
// writes scores (N,) and hists (N, B). Returns the CUDA error of the launch
// (0 on success).
int fleet_drift_fwd(const void* tokens, const void* ref, void* scores,
                    void* hists, int N, int T, int B, int vocab, float eps,
                    void* stream) {
  if (N <= 0) return 0;
  if (B <= 0 || B > kMaxBuckets || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (T % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(tokens) % 16 == 0);
  const int blocks = (N + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(kWarps) * B * sizeof(int);
  fleet_drift_kernel<<<blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tokens), static_cast<const float*>(ref),
      static_cast<float*>(scores), static_cast<float*>(hists), N, T, B,
      vocab, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
