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
// Design: the fleet rows as a memory stream. PR 12's kernel gave each q
// row a warp (2 buckets a lane at B = 64), read the row twice with 4-byte
// loads, ran two 5-step shuffle sums per row and renormalised the request
// row in every block: a chain of dependent latencies, 0.0114 ms where the
// bytes take 0.0013.
//   * A group of LPR lanes owns one q row (8 lanes at B <= 128, 16 at
//     B <= 256, 32 at B <= 1024), so a warp has 32 / LPR rows in flight. Each lane loads its NV
//     16-byte pieces of the row once (lanes of a group on neighbouring
//     pieces) and keeps them in registers for the sum and for the terms;
//     the sums over the group take log2(LPR) shuffles (3 at B = 64).
//   * The block's TN request rows (TN B <= 2048 floats) are normalised
//     once, by one group each, into shared memory in the same register
//     layout, while the fleet rows' loads are in flight; at N = 1 every
//     group reads the one row as a broadcast.
//   * Grid (ceil(M / rows per block), ceil(N / TN)), 8 warps a block.
//     Groups that walk rows a grid apart and load the next row while
//     computing this one were slower (PERF.md, PR 16).
//   * Per element the arithmetic is PR 12's: the eps shift, IEEE division
//     by the row sum, accurate logf and the KL form; only the order of the
//     sums differs. Unaligned rows or B % 4 != 0 read 4-byte pieces into
//     the same layout.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileFloats = 2048;  // TN * (padded B) of the staged p tile
constexpr int kMaxBuckets = 1024;

// sum over the LPR lanes of a group (aligned lanes of one warp); the
// shuffles name the group's lanes only, so groups of a warp may diverge
template <int LPR>
__device__ __forceinline__ float group_sum(float x) {
  const unsigned mask =
      LPR == 32 ? 0xffffffffu
                : ((1u << (LPR & 31)) - 1u) << ((threadIdx.x & 31) / LPR * LPR);
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(mask, x, o);
  return x;
}

// Lane `sub` of a group: elements (sub + LPR v) * 4 + c of row `src`
// (B floats), zero past B; 16-byte loads when `vec`.
template <int LPR, int NV>
__device__ __forceinline__ void load_row(float4 (&x)[NV],
                                         const float* __restrict__ src, int B,
                                         int sub, bool vec) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int e = (sub + LPR * v) * 4;
    if (vec) {
      x[v] = e < B ? __ldg(reinterpret_cast<const float4*>(src + e))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      x[v].x = e < B ? __ldg(src + e) : 0.f;
      x[v].y = e + 1 < B ? __ldg(src + e + 1) : 0.f;
      x[v].z = e + 2 < B ? __ldg(src + e + 2) : 0.f;
      x[v].w = e + 3 < B ? __ldg(src + e + 3) : 0.f;
    }
  }
}

// the eps shift and the division by the row sum, in place; 0 past B
template <int LPR, int NV>
__device__ __forceinline__ void normalise(float4 (&x)[NV], int B, int sub,
                                          float eps) {
  float s = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int e = (sub + LPR * v) * 4;
    if (e < B) s += x[v].x + eps;
    if (e + 1 < B) s += x[v].y + eps;
    if (e + 2 < B) s += x[v].z + eps;
    if (e + 3 < B) s += x[v].w + eps;
  }
  s = group_sum<LPR>(s);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int e = (sub + LPR * v) * 4;
    x[v].x = e < B ? (x[v].x + eps) / s : 0.f;
    x[v].y = e + 1 < B ? (x[v].y + eps) / s : 0.f;
    x[v].z = e + 2 < B ? (x[v].z + eps) / s : 0.f;
    x[v].w = e + 3 < B ? (x[v].w + eps) / s : 0.f;
  }
}

// p log(p/m) + q log(q/m), m = (p + q) / 2
__device__ __forceinline__ float kl_term(float pv, float qv) {
  const float m = 0.5f * (pv + qv);
  return pv * logf(pv / m) + qv * logf(qv / m);
}

// out[i0 + r, j] for the block's staged p rows r, from the normalised q
// row j in the group's registers
template <int LPR, int NV>
__device__ __forceinline__ void js_row(const float4 (&x)[NV],
                                       const float4* ps, float* out, int i0,
                                       int tn, int j, int M, int B,
                                       int sub) {
  constexpr int PIECES = LPR * NV;
  for (int r = 0; r < tn; ++r) {
    float kl = 0.f;  // sum over b of p log(p/m) + q log(q/m)
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const int e = (sub + LPR * v) * 4;
      const float4 pv = ps[r * PIECES + sub + LPR * v];
      if (e < B) kl += kl_term(pv.x, x[v].x);
      if (e + 1 < B) kl += kl_term(pv.y, x[v].y);
      if (e + 2 < B) kl += kl_term(pv.z, x[v].z);
      if (e + 3 < B) kl += kl_term(pv.w, x[v].w);
    }
    kl = group_sum<LPR>(kl);
    if (sub == 0) out[static_cast<long long>(i0 + r) * M + j] = 0.5f * kl;
  }
}

template <int LPR, int NV>
__global__ void __launch_bounds__(kThreads)
pairwise_js_kernel(const float* __restrict__ p, const float* __restrict__ q,
                   float* __restrict__ out, int N, int M, int B, int TN,
                   float eps, bool vec) {
  constexpr int RPW = 32 / LPR;         // q rows per warp
  constexpr int RPB = kWarps * RPW;     // q rows per block
  constexpr int PIECES = LPR * NV;      // float4 pieces of a padded row
  extern __shared__ float4 ps[];        // (TN, PIECES) normalised p rows
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % LPR, grp = lane / LPR;
  const int i0 = blockIdx.y * TN;
  const int tn = min(TN, N - i0);

  // the fleet row's loads go out first, to overlap the staging of p
  const int j = blockIdx.x * RPB + warp * RPW + grp;
  const bool live = j < M;
  float4 x[NV];
  if (live)
    load_row<LPR, NV>(x, q + static_cast<long long>(j) * B, B, sub, vec);
  for (int r = warp * RPW + grp; r < tn; r += RPB) {
    float4 y[NV];
    load_row<LPR, NV>(y, p + static_cast<long long>(i0 + r) * B, B, sub, vec);
    normalise<LPR, NV>(y, B, sub, eps);
#pragma unroll
    for (int v = 0; v < NV; ++v) ps[r * PIECES + sub + LPR * v] = y[v];
  }
  __syncthreads();
  if (!live) return;  // whole groups leave together
  normalise<LPR, NV>(x, B, sub, eps);
  js_row<LPR, NV>(x, ps, out, i0, tn, j, M, B, sub);
}

template <int LPR, int NV>
int launch(const float* p, const float* q, float* out, int N, int M, int B,
           float eps, cudaStream_t stream) {
  constexpr int pieces = LPR * NV;
  const int tn = max(1, min(32, kTileFloats / (4 * pieces)));
  const dim3 grid((M + kWarps * (32 / LPR) - 1) / (kWarps * (32 / LPR)),
                  (N + tn - 1) / tn);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const size_t smem = static_cast<size_t>(tn) * pieces * sizeof(float4);
  pairwise_js_kernel<LPR, NV><<<grid, kThreads, smem, stream>>>(
      p, q, out, N, M, B, tn, eps, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// p (N, B) and q (M, B) fp32 row-major contiguous; writes out (N, M).
// Returns the CUDA error of the launch (0 on success).
int pairwise_js_fwd(const void* p, const void* q, void* out, int N, int M,
                    int B, float eps, void* stream) {
  if (N <= 0 || M <= 0) return 0;
  const float* pp = static_cast<const float*>(p);
  const float* qq = static_cast<const float*>(q);
  float* oo = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || B > kMaxBuckets)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 64) return launch<8, 2>(pp, qq, oo, N, M, B, eps, s);
  if (B <= 128) return launch<8, 4>(pp, qq, oo, N, M, B, eps, s);
  if (B <= 256) return launch<16, 4>(pp, qq, oo, N, M, B, eps, s);
  return launch<32, 8>(pp, qq, oo, N, M, B, eps, s);
}

}  // extern "C"
