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
// arithmetic: per bucket two accurate logs and five IEEE divisions (four
// where max(T, 1) is a power of two). At the drift plane's shape (T = 256
// tokens, B = 64) that is some 25 us of issue slots against 46 us of
// device-memory bytes (tokens in, the reference in, hists out): bound by
// bytes only if the loads overlap the arithmetic. The first version of
// this kernel (0.118 ms) did not: each warp loaded a row, counted it,
// scored it, and only then loaded the next; besides, it took a 64-bit
// division (vocab > 0) or a runtime modulo (vocab 0) per token.
//
// Design:
//   * The bucket without a hardware division (`bucket_mode`, chosen by
//     the wrapper, which computes the constants on the host):
//     - vocab > 0: t is clipped to [0, vocab] first; then a lookup table
//       of the vocab + 1 buckets in shared memory (LUT), or an exact
//       division by the per-launch constant vocab, q = umulhi64(t B, M)
//       with M = floor(2^64 / vocab) + 1 (RECIP; exact for t B < 2^32,
//       since t B (M vocab - 2^64) < 2^64), or, where vocab B >= 2^32,
//       a 64-bit division (WIDE);
//     - vocab == 0: t & (B - 1) for a power-of-two B (two's complement
//       gives the floor modulo; MASK), else the same reciprocal on |t|
//       with M = floor(2^64 / B) + 1 and the sign fixed (MODR).
//     Every path gives ref.bucket_index's bucket for every int32 token
//     (tests/test_torch_drift_buckets.py emulates each).
//   * Counting: a warp per row, its lanes adding into one shared-memory
//     counter per bucket with atomics. A sweep on the card (PERF.md) timed
//     this against private [bucket][lane] counters (4 or 32 lanes a
//     row), atomics shared by 4 or 8 lanes a row and `__match_any_sync`,
//     under every bucket path, on the plane's bigram tokens (a 256-token
//     row falls in 19-27 buckets, so 10-15 lanes of an atomic hit one
//     counter) and on uniform ones alike: this was the fastest everywhere,
//     and the others were taken out. The same-address serialisation costs
//     the shared-memory unit, not issue slots, and the kernel is bound by
//     issue and latency; the others paid instructions and registers per
//     token. Counts are exact integers, so hists are bit for bit.
//   * Memory in flight: each lane reads its share of a row as 16-byte
//     loads (T a multiple of 4 and the tokens 16-byte aligned; scalar
//     otherwise); the first ones of the next row are issued before the JS
//     of this one, so they arrive while it computes. The grid is
//     sized to the SMs (the occupancy the shared memory allows), each warp
//     walking rows with a stride of the grid's warps.
//   * JS per row as before: the warp's lanes walk its buckets with stride
//     32; the row sums (sum of p, sum of q, the KL terms) are shuffle
//     reductions over the warp. Each lane keeps h and the reference of
//     its first buckets in registers between the two passes, so h is
//     divided once and the reference read once; h = count * (1 / T)
//     where T is a power of two (the same float as count / T). Accurate
//     logf and IEEE division (no fast math): the host rescores in float64
//     only within 1e-4 of the threshold, on the premise that the fp32
//     error is about 1e-7.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSmemBytes = 232448;  // opt-in shared memory of a block
constexpr int kPrefetch = 2;           // 16-byte loads of the next row a lane
                                       // issues before the JS (a 256-token row)
constexpr int kUnroll = 8;             // 16-byte loads a lane has in flight
constexpr int kCache = 2;              // buckets a lane keeps in registers

enum BucketMode { WIDE = 0, LUT = 1, RECIP = 2, MASK = 3, MODR = 4 };

struct Args {
  const int* tokens;
  const float* ref;
  float* scores;
  float* hists;
  const int* lut;  // vocab + 1 buckets (LUT) or null
  unsigned long long magic;
  int N, T, B, vocab, vec;
  float eps;
  float inv_total;  // 1 / max(T, 1) where that is a power of two, else 0
};

template <int BM>
__device__ __forceinline__ int bucket_of(int t, const Args& a,
                                         const int* lut) {
  if (BM == MASK) return t & (a.B - 1);
  if (BM == MODR) {
    const unsigned u = t < 0 ? 0u - static_cast<unsigned>(t)
                             : static_cast<unsigned>(t);
    const unsigned q = static_cast<unsigned>(
        __umul64hi(static_cast<unsigned long long>(u), a.magic));
    const unsigned r = u - q * static_cast<unsigned>(a.B);
    return static_cast<int>(t < 0 && r != 0 ? a.B - r : r);
  }
  const int c = min(max(t, 0), a.vocab);  // clip first: [0, vocab]
  if (BM == LUT) return lut[c];
  if (BM == RECIP) {
    const unsigned q = static_cast<unsigned>(__umul64hi(
        static_cast<unsigned long long>(static_cast<unsigned>(c) * a.B),
        a.magic));
    return min(static_cast<int>(q), a.B - 1);
  }
  const long long q = static_cast<long long>(c) * a.B / a.vocab;  // WIDE
  return static_cast<int>(min(q, static_cast<long long>(a.B - 1)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int BM>
__global__ void __launch_bounds__(kThreads) fleet_drift_kernel(Args a) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* cnt = smem + warp * a.B;  // this warp's row's counters
  int* lut = reinterpret_cast<int*>(smem + kWarps * a.B);
  for (int e = threadIdx.x; e < kWarps * a.B; e += kThreads) smem[e] = 0;
  if (BM == LUT)
    for (int e = threadIdx.x; e <= a.vocab; e += kThreads) lut[e] = a.lut[e];
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  const float total = fmaxf(static_cast<float>(a.T), 1.0f);
  const int n4 = a.T >> 2;
  const int steps = a.vec ? (n4 + 31) / 32 : (a.T + 31) / 32;

  // this lane's first kPrefetch 16-byte loads of row r
  int4 v[kPrefetch];
  bool vok[kPrefetch];
  auto prefetch = [&](long long r) {
    const int4* t4 =
        reinterpret_cast<const int4*>(a.tokens + (r < a.N ? r : 0) * a.T);
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int k = u * 32 + lane;
      vok[u] = a.vec && r < a.N && u < steps && k < n4;
      v[u] = vok[u] ? __ldcs(t4 + k) : make_int4(0, 0, 0, 0);
    }
  };
  auto add = [&](int t) { atomicAdd(cnt + bucket_of<BM>(t, a, lut), 1u); };
  auto add4 = [&](const int4& t, bool ok) {
    if (!ok) return;
    add(t.x);
    add(t.y);
    add(t.z);
    add(t.w);
  };
  // h = count / total: a product where 1 / total is a power of two (the
  // same float), an IEEE division otherwise
  auto hist = [&](unsigned c) {
    return a.inv_total != 0.f ? static_cast<float>(c) * a.inv_total
                              : static_cast<float>(c) / total;
  };

  long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  prefetch(row);
  for (; row < a.N; row += stride) {
    const int* trow = a.tokens + row * a.T;
    if (a.vec) {
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) add4(v[u], vok[u]);
      const int4* t4 = reinterpret_cast<const int4*>(trow);
      for (int s0 = kPrefetch; s0 < steps; s0 += kUnroll) {  // the rest
        int4 w[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int k = (s0 + u) * 32 + lane;
          ok[u] = s0 + u < steps && k < n4;
          w[u] = ok[u] ? __ldcs(t4 + k) : make_int4(0, 0, 0, 0);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) add4(w[u], ok[u]);
      }
    } else {
      for (int k = lane; k < a.T; k += 32) add(__ldcs(trow + k));
    }
    prefetch(row + stride);  // the next row's tokens load during the JS
    __syncwarp();

    // every token lands in a bucket, so the counts sum to T exactly; the
    // lane's first kCache buckets keep h and the reference in registers
    const float* rrow = a.ref + row * a.B;
    float* hrow = a.hists + row * a.B;
    float hc[kCache], rc[kCache];
    float sp = 0.f, sq = 0.f;
#pragma unroll
    for (int k = 0; k < kCache; ++k) {
      const int b = lane + k * 32;
      hc[k] = rc[k] = 0.f;
      if (b < a.B) {
        hc[k] = hist(cnt[b]);
        rc[k] = __ldg(rrow + b);
        hrow[b] = hc[k];
        sp += hc[k] + a.eps;
        sq += rc[k] + a.eps;
      }
    }
    for (int b = lane + kCache * 32; b < a.B; b += 32) {
      const float h = hist(cnt[b]);
      hrow[b] = h;
      sp += h + a.eps;
      sq += __ldg(rrow + b) + a.eps;
    }
    sp = warp_sum(sp);
    sq = warp_sum(sq);
    float kl = 0.f;  // sum over b of p log(p/m) + q log(q/m)
#pragma unroll
    for (int k = 0; k < kCache; ++k)
      if (lane + k * 32 < a.B) {
        const float p = (hc[k] + a.eps) / sp;
        const float q = (rc[k] + a.eps) / sq;
        const float m = 0.5f * (p + q);
        kl += p * logf(p / m) + q * logf(q / m);
      }
    for (int b = lane + kCache * 32; b < a.B; b += 32) {
      const float p = (hist(cnt[b]) + a.eps) / sp;
      const float q = (__ldg(rrow + b) + a.eps) / sq;
      const float m = 0.5f * (p + q);
      kl += p * logf(p / m) + q * logf(q / m);
    }
    kl = warp_sum(kl);
    if (lane == 0) a.scores[row] = 0.5f * kl;
    __syncwarp();
    for (int e = lane; e < a.B; e += 32) cnt[e] = 0;  // the next row
    __syncwarp();
  }
}

size_t smem_bytes(int B, int lut_entries) {
  return sizeof(int) * (static_cast<size_t>(kWarps) * B + lut_entries);
}

template <int BM>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.B, BM == LUT ? a.vocab + 1 : 0);
  if (smem > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = fleet_drift_kernel<BM>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need = (static_cast<long long>(a.N) + kWarps - 1) / kWarps;
  const long long fill =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(need < fill ? need : fill);
  kernel<<<blocks, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// tokens (N, T) int32 and ref (N, B) fp32, both row-major contiguous;
// writes scores (N,) and hists (N, B). bucket_mode: 0 WIDE, 1 LUT (lut:
// vocab + 1 int32 buckets on the device), 2 RECIP (vocab >= 2, vocab B <
// 2^32, magic = floor(2^64 / vocab) + 1), 3 MASK (vocab 0, B a power of
// two), 4 MODR (vocab 0, B >= 2, magic = floor(2^64 / B) + 1). Returns the
// CUDA error of the launch (0 on success).
int fleet_drift_fwd(const void* tokens, const void* ref, void* scores,
                    void* hists, int N, int T, int B, int vocab, float eps,
                    int bucket_mode, unsigned long long magic,
                    const void* lut, void* stream) {
  if (N <= 0) return 0;
  if (B <= 0 || T < 0 || vocab < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool ok =
      (bucket_mode == WIDE && vocab > 0) ||
      (bucket_mode == LUT && vocab > 0 && lut != nullptr) ||
      (bucket_mode == RECIP && vocab >= 2 &&
       static_cast<unsigned long long>(vocab) * B < (1ULL << 32)) ||
      (bucket_mode == MASK && vocab == 0 && (B & (B - 1)) == 0) ||
      (bucket_mode == MODR && vocab == 0 && B >= 2);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (T % 4 == 0) &&
                  (reinterpret_cast<uintptr_t>(tokens) % 16 == 0);
  const int total = T > 1 ? T : 1;
  const float inv_total =
      (total & (total - 1)) == 0 ? 1.0f / static_cast<float>(total) : 0.f;
  Args a{static_cast<const int*>(tokens), static_cast<const float*>(ref),
         static_cast<float*>(scores), static_cast<float*>(hists),
         static_cast<const int*>(lut), magic, N, T, B, vocab, vec, eps,
         inv_total};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bucket_mode) {
    case WIDE: return launch<WIDE>(a, s);
    case LUT: return launch<LUT>(a, s);
    case RECIP: return launch<RECIP>(a, s);
    case MASK: return launch<MASK>(a, s);
    case MODR: return launch<MODR>(a, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
