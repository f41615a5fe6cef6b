// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (bound with ctypes by repro_torch/kernels/flash_attention.py).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, body `_attn_kernel`): blockwise
// online-softmax attention, q (B,S,H,hd) against k/v (B,T,K,hd), GQA head
// h -> kv head h / (H/K), causal with query i at absolute position
// i + (T - S), optional sliding window, fp32 accumulators, a row with no
// visible key -> 0, output in q's type.
//
// What bounds it on this card: serving calls it at prefill (S = T = prompt
// length) and at decode (S = 1 over the cache prefix). Decode reads the
// whole K/V prefix for one query row per head, about one multiply-add per
// byte: it is bound by device-memory bytes. Causal prefill at head_dim 128
// does about S/2 multiply-adds per byte of K/V, above the card's
// bytes-to-operations balance, so a kernel that reaches the bound is bound
// by tensor-core operations.
//
// Design (simple and correct first; wgmma/TMA come in a later change):
//   * One block of 4 warps per (query tile, head, batch). A warp owns R
//     query rows (R = 8 for prefill, R = 1 when S <= 4, so a decode warp
//     does not compute 7 dead rows).
//   * The block walks the kv tiles of 64 rows that intersect its causal /
//     window range (whole tiles outside the mask are skipped before any
//     load); K and V are staged in shared memory as fp32, read with
//     16-byte loads that a thread issues in batches before storing any
//     (scalar loads where a view is not 16-byte aligned); boundary tiles
//     are masked elementwise.
//   * Scores: lane c of a warp computes columns c and c+32 of the tile for
//     the warp's rows with fp32 FMAs on CUDA cores; the K rows are padded
//     by 4 floats so the 16-byte loads of 8 lanes hit distinct banks.
//   * Online softmax in fp32 registers (running max m, sum l); the
//     probabilities go through a per-warp shared-memory strip, and lane c
//     accumulates output dims c, c+32, ... in registers.
//   * Strides are arguments, so decode passes the cache prefix view
//     without a copy; only the last dim must be contiguous.
// The CUDA-core FMAs, the fp32 staging and, at decode, one block per
// (slot, head) walking the whole prefix alone are what keep it from its
// bound; PERF.md has its time beside the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBK = 64;  // kv rows per tile

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, S, T, H, K, hd;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float scale;
  int vec;  // k/v rows may be read in 16-byte vectors (alignment checked)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of k/v elements -> fp32 in shared memory
__device__ __forceinline__ void unpack16(float* dst, uint4 raw, float) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(&raw);
}
__device__ __forceinline__ void unpack16(float* dst, uint4 raw,
                                         __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// Stage kv rows [t0, t0 + kBK) of k and v into shared memory as fp32, rows
// at or past T and dims at or past hd as 0. With p.vec every thread keeps
// up to 2 x kBatch 16-byte loads in flight before it stores any.
template <typename TKV, int HDP>
__device__ __forceinline__ void load_kv_tile(float* Ks, float* Vs,
                                             const TKV* k, const TKV* v,
                                             int t0, const Params& p,
                                             int tid) {
  constexpr int KST = HDP + 4;
  if (p.vec) {
    constexpr int VEC = 16 / sizeof(TKV);
    constexpr int CPR = HDP / VEC;            // 16-byte chunks per row
    constexpr int N = kBK * CPR / kThreads;   // chunks per thread
    constexpr int kBatch = N < 8 ? N : 8;
#pragma unroll
    for (int base = 0; base < N; base += kBatch) {
      uint4 kr[kBatch], vr[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int idx = tid + (base + i) * kThreads;
        const int c = idx / CPR, d = (idx % CPR) * VEC, t = t0 + c;
        const bool ok = t < p.T && d < p.hd;
        const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
        kr[i] = ok ? *reinterpret_cast<const uint4*>(k + t * p.k_st + d)
                   : zero;
        vr[i] = ok ? *reinterpret_cast<const uint4*>(v + t * p.v_st + d)
                   : zero;
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int idx = tid + (base + i) * kThreads;
        const int c = idx / CPR, d = (idx % CPR) * VEC;
        unpack16(&Ks[c * KST + d], kr[i], TKV{});
        unpack16(&Vs[c * HDP + d], vr[i], TKV{});
      }
    }
    return;
  }
  for (int idx = tid; idx < kBK * HDP; idx += kThreads) {
    const int c = idx / HDP, d = idx % HDP, t = t0 + c;
    const bool ok = t < p.T && d < p.hd;
    Ks[c * KST + d] = ok ? to_f(k[t * p.k_st + d]) : 0.f;
    Vs[c * HDP + d] = ok ? to_f(v[t * p.v_st + d]) : 0.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

template <int HDP, int R>
constexpr size_t smem_bytes() {
  // Q tile + K tile (rows padded to HDP + 4) + V tile + per-warp P strips
  return sizeof(float) * (size_t)(kWarps * R * (HDP + 4) + kBK * (HDP + 4) +
                                  kBK * HDP + kWarps * R * kBK);
}

template <typename TQ, typename TKV, int HDP, int R>
__global__ void __launch_bounds__(kThreads) attn_fwd_kernel(Params p) {
  constexpr int BQ = kWarps * R;
  constexpr int KST = HDP + 4;  // padded row stride of Q and K in smem
  constexpr int NJ = HDP / 32;  // output dims per lane
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // BQ x KST
  float* Ks = Qs + BQ * KST;                    // kBK x KST
  float* Vs = Ks + kBK * KST;                   // kBK x HDP
  float* Ps = Vs + kBK * HDP;                   // kWarps x R x kBK

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.K);
  const int off = p.T - p.S;

  const TQ* q = static_cast<const TQ*>(p.q) + b * p.q_sb + h * p.q_sh;
  const TKV* k = static_cast<const TKV*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const TKV* v = static_cast<const TKV*>(p.v) + b * p.v_sb + hk * p.v_sh;

  for (int idx = tid; idx < BQ * HDP; idx += kThreads) {
    const int r = idx / HDP, d = idx % HDP, i = q0 + r;
    Qs[r * KST + d] = (i < p.S && d < p.hd) ? to_f(q[i * p.q_ss + d]) : 0.f;
  }

  // kv range this block can see: whole tiles outside it are never loaded
  const int rows = min(BQ, p.S - q0);
  const int qpos_first = q0 + off, qpos_last = q0 + rows - 1 + off;
  int kv_lo = 0, kv_hi = p.T;
  if (p.causal) {
    kv_hi = min(p.T, qpos_last + 1);
    if (p.window > 0) kv_lo = max(0, qpos_first - p.window + 1);
  }
  kv_lo = (kv_lo / kBK) * kBK;

  const int r0 = warp * R;  // first tile row of this warp
  const bool active = q0 + r0 < p.S;
  float* P = Ps + warp * R * kBK;

  float m[R], l[R], acc[R][NJ];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[r][j] = 0.f;
  }

  for (int t0 = kv_lo; t0 < kv_hi; t0 += kBK) {
    __syncthreads();  // the previous tile is consumed, the Q tile written
    load_kv_tile<TKV, HDP>(Ks, Vs, k, v, t0, p, tid);
    __syncthreads();
    if (!active) continue;

    float s[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll
    for (int d = 0; d < HDP; d += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(&Ks[lane * KST + d]);
      const float4 k1 =
          *reinterpret_cast<const float4*>(&Ks[(lane + 32) * KST + d]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&Qs[(r0 + r) * KST + d]);
        s[r][0] += dot4(qv, k0);
        s[r][1] += dot4(qv, k1);
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = q0 + r0 + r + off;
      float x[2];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int t = t0 + lane + 32 * cc;
        bool vis = t < p.T;
        if (p.causal) {
          vis = vis && t <= qpos;
          if (p.window > 0) vis = vis && qpos - t < p.window;
        }
        x[cc] = vis ? s[r][cc] * p.scale : -INFINITY;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x[0], x[1])));
      float corr = 1.f, p0 = 0.f, p1 = 0.f;
      if (m_new != -INFINITY) {  // else nothing visible yet: keep zeros
        corr = expf(m[r] - m_new);
        p0 = expf(x[0] - m_new);
        p1 = expf(x[1] - m_new);
      }
      l[r] = l[r] * corr + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[r][j] *= corr;
      P[r * kBK + lane] = p0;
      P[r * kBK + lane + 32] = p1;
    }
    __syncwarp();

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float vv[4][NJ];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          vv[cc][j] = Vs[(c + cc) * HDP + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(&P[r * kBK + c]);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          acc[r][j] += pr.x * vv[0][j] + pr.y * vv[1][j] + pr.z * vv[2][j] +
                       pr.w * vv[3][j];
      }
    }
    __syncwarp();  // P is rewritten by the next tile
  }

  if (!active) return;
  TQ* o = static_cast<TQ*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = q0 + r0 + r;
    if (i >= p.S) break;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < p.hd) store(&o[i * p.o_ss + d], acc[r][j] * inv);
    }
  }
}

template <typename TQ, typename TKV, int HDP, int R>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int BQ = kWarps * R;
  constexpr size_t smem = smem_bytes<HDP, R>();
  // above 48 KB of dynamic shared memory a kernel must opt in (per device)
  cudaError_t e = cudaFuncSetAttribute(
      attn_fwd_kernel<TQ, TKV, HDP, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.S + BQ - 1) / BQ, p.H, p.B);
  attn_fwd_kernel<TQ, TKV, HDP, R><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int HDP>
cudaError_t launch_rows(const Params& p, cudaStream_t stream) {
  if (p.S <= kWarps) return launch<TQ, TKV, HDP, 1>(p, stream);
  return launch<TQ, TKV, HDP, 8>(p, stream);
}

template <typename TQ, typename TKV>
cudaError_t launch_hd(const Params& p, cudaStream_t stream) {
  if (p.hd <= 32) return launch_rows<TQ, TKV, 32>(p, stream);
  if (p.hd <= 64) return launch_rows<TQ, TKV, 64>(p, stream);
  if (p.hd <= 128) return launch_rows<TQ, TKV, 128>(p, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. Strides are in elements; the
// last dim of every tensor is contiguous. Returns cudaGetLastError() of the
// launch (0 on success).
extern "C" int flash_attention_fwd(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    void* o, int B, int S, int T, int H, int K, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_st,
    long long k_sh, long long v_sb, long long v_st, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window,
    void* stream) {
  const long long vec = kv_dtype == 0 ? 4 : 8;  // elements in 16 bytes
  const bool aligned =
      (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) %
              16 == 0 &&
      hd % vec == 0 && k_sb % vec == 0 && k_st % vec == 0 &&
      k_sh % vec == 0 && v_sb % vec == 0 && v_st % vec == 0 &&
      v_sh % vec == 0;
  Params p{q,    k,    v,    o,    B,    S,    T,    H,    K,    hd,
           q_sb, q_ss, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb,
           o_ss, o_sh, causal, window, 1.0f / sqrtf((float)hd),
           aligned ? 1 : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0 && kv_dtype == 0) return launch_hd<float, float>(p, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return launch_hd<__nv_bfloat16, __nv_bfloat16>(p, st);
  if (q_dtype == 0 && kv_dtype == 1)
    return launch_hd<float, __nv_bfloat16>(p, st);
  return cudaErrorInvalidValue;
}
