// Flash attention forward for Hopper (sm_90a), CUDA C++ with a plain C
// interface (bound with ctypes by repro_torch/kernels/flash_attention.py).
//
// Replaces the Pallas TPU kernel `flash_attention`
// (src/repro/kernels/flash_attention.py, body `_attn_kernel`): blockwise
// online-softmax attention, q (B,S,H,hd) against k/v (B,T,K,hd), GQA head
// h -> kv head h / (H/K), causal with query i at absolute position
// i + (T - S), optional sliding window, fp32 accumulators, a row with no
// visible key -> 0, output in q's type. k/v may be strided views (the
// decode cache prefix); only the last dim must be contiguous.
//
// What bounds it on this card. Prefill (S = T = prompt length) does about
// S/2 multiply-adds per byte of K/V, far above the card's 295 bf16
// operations per byte: it is bound by tensor-core operations. Decode (S = 1
// over the cache prefix) reads the whole K/V prefix for a few query rows,
// about G multiply-adds per byte: it is bound by device-memory bytes.
//
// Three paths; the wrapper's `plan` picks one and passes it as `path`:
//
// 1. Tensor-core prefill (bf16 q, k, v; hd a multiple of 8; 16-byte rows).
//    A block owns 64 query rows of one query head, 16 rows a warp. QK^T and
//    PV are bf16 -> fp32 `mma.sync.m16n8k16` products fed by `ldmatrix`
//    (the warp-level form, which sm_90a runs on the same tensor cores;
//    `wgmma` needs descriptor-encoded shared-memory layouts that nothing
//    before the card can check). Q is staged once and held in registers as
//    A fragments. K and V tiles of 64 rows stay bf16 in shared memory, rows
//    padded by 16 bytes so the 8 row addresses of an `ldmatrix` hit
//    distinct banks, double-buffered with `cp.async` so the next tile's
//    load overlaps this tile's products; a step's B fragments are loaded
//    before its products are issued. The score accumulator becomes PV's A
//    operand in registers, rounded to bf16 (as the JAX model's `_gqa_out`
//    rounds its probabilities); the online softmax (m, l) runs on the
//    accumulator fragments with quad shuffles, in exp2 with the scale
//    folded in. Tiles outside the causal / window range are skipped before
//    any load; only boundary tiles are masked elementwise. The grid is
//    (query head, query tile, batch) with the heaviest causal tiles first:
//    the G query heads of one kv head are adjacent in launch order and read
//    each K/V tile from L2, not HBM. Where the grid is too small to fill
//    the card (olmo's 128 blocks), a block has two kv groups of 4 warps
//    that take alternate kv tiles, each with its own ring, and merge their
//    (m, l, o) at the end: twice the warps, half the causal critical path.
// 2. Split-KV decode (bf16, S x G <= 16 query rows per kv head). A block
//    owns (split, kv head, batch) and the S x G query rows that read that
//    kv head, padded to one 16-row tile, so each K/V byte is read from HBM
//    once per call. The 4 warps take a quarter of every 64-key tile each
//    (all warps compute), with the same products, double buffering and
//    online softmax as the prefill; a split is one or more tiles, as long
//    as every SM still gets a block. The block merges its warps' (m, l, o)
//    in shared memory and writes the split's fp32 partial to scratch that
//    the wrapper allocates. A split with no visible key writes m = -inf,
//    l = 0, o = 0. `attn_decode_combine_kernel`, a second launch of the
//    same call, rescales and sums the partials of each output row (a block
//    per row, the loads over the splits independent); a row with no visible
//    key in any split stays 0. Its arithmetic is `ref.combine_splits`.
//    With per-lane key lengths (the fleet decode: lanes at different
//    positions over one pool of `cap` rows), the splits cover [0, cap), a
//    split past its lane's length returns at once, and the combine reads
//    only the splits that cover [0, lengths[b]). The CUDA-core kernel
//    takes the same lengths; the prefill refuses them.
// 0. CUDA cores (fp32 q, fp32 q over a bf16 cache, and rows that are not
//    16-byte multiples or not aligned): one block of 4 warps per (query
//    tile, head, batch), K/V staged as fp32, fp32 FMAs. TF32 products
//    could not hold fp32's 2e-4 tolerance.
// PERF.md has each path's time beside its bound and beside SDPA's.

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
  // split-KV decode: keys per split (a multiple of kTile), the number of
  // splits, and the fp32 partials (m in log2 units and l, unnormalised o)
  int split, splits;
  float* part_o;
  float* part_ml;
  // per-lane key lengths (B,) int32, or null: lane b sees keys t <
  // lengths[b] only (clamped to [0, T]), its queries at the positions
  // i + lengths[b] - S, the causal convention of ref.attention_ref per lane
  const int* lengths;
};

// the keys lane b sees: lengths[b] clamped to [0, T], or T
__device__ __forceinline__ int lane_keys(const Params& p, int b) {
  return p.lengths ? min(max(p.lengths[b], 0), p.T) : p.T;
}

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

// ---------------------------------------------------------------------------
// Path 0: CUDA cores (fp32 q, fp32 q over a bf16 cache, rows that are not
// 16-byte multiples or not 16-byte aligned)
// ---------------------------------------------------------------------------

// Stage kv rows [t0, t0 + kBK) of k and v into shared memory as fp32, rows
// at or past T and dims at or past hd as 0. With p.vec every thread keeps
// up to 2 x kBatch 16-byte loads in flight before it stores any.
template <typename TKV, int HDP>
__device__ __forceinline__ void load_kv_tile(float* Ks, float* Vs,
                                             const TKV* k, const TKV* v,
                                             int t0, int T, const Params& p,
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
        const bool ok = t < T && d < p.hd;
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
    const bool ok = t < T && d < p.hd;
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
  const int T = lane_keys(p, b), off = T - p.S;

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
  int kv_lo = 0, kv_hi = T;
  if (p.causal) {
    kv_hi = min(T, qpos_last + 1);
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
    load_kv_tile<TKV, HDP>(Ks, Vs, k, v, t0, T, p, tid);
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
        bool vis = t < T;
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

// ---------------------------------------------------------------------------
// Paths 1 and 2: tensor cores (bf16 q, k, v; hd % 8 == 0; 16-byte rows)
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;  // query rows of a prefill block; keys of a tile

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared without passing through registers; the
// destination is zero-filled when !ok (no byte is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i; `_t` delivers them transposed
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr))
      : "memory");
}

// d += a (16x16 bf16, row major) * b (16x8 bf16, column major), fp32 sums;
// not volatile, so the compiler may move it past the loads it does not use
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one MUFU instruction (relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ bool visible(int t, int qpos, int T,
                                        const Params& p) {
  if (t >= T) return false;
  if (!p.causal) return true;
  return t <= qpos && (p.window <= 0 || qpos - t < p.window);
}

// Stage rows [r0, r0 + ROWS) of `src` (row stride ld elements) into shared
// memory rows of HDP + 8 elements with cp.async, NTH threads sharing the
// copies; rows at or past n and dims at or past hd are zero-filled.
template <int HDP, int ROWS, int NTH = kThreads>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           long long ld, int r0, int n,
                                           int hd, int tid) {
  constexpr int CPR = HDP / 8, LD = HDP + 8;
#pragma unroll
  for (int i = 0; i < ROWS * CPR / NTH; ++i) {
    const int idx = tid + i * NTH;
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const bool ok = r0 + r < n && c < hd;
    cp_async16(dst + r * LD + c, ok ? src + (r0 + r) * ld + c : src, ok);
  }
}

// One online-softmax step on a warp's accumulator fragments: s holds the
// raw scores of rows g and g + 8 (elements 0-1 and 2-3 of each n-tile),
// -inf where masked, and leaves the probabilities exp2((s - m) scale
// log2 e) there; m is in raw score units, l a per-thread partial sum.
template <int NT, int NO>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], float (&m)[2],
                                             float (&l)[2], float (&o)[NO][4],
                                             float sl2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = m[r];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    // nothing visible yet: base 0 keeps every probability exp2(-inf) = 0
    const float base = mx == -INFINITY ? 0.f : mx * sl2;
    const float corr = fast_exp2(m[r] * sl2 - base);
    float sum = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][2 * r] = fast_exp2(fmaf(s[n][2 * r], sl2, -base));
      s[n][2 * r + 1] = fast_exp2(fmaf(s[n][2 * r + 1], sl2, -base));
      sum += s[n][2 * r] + s[n][2 * r + 1];
    }
    l[r] = l[r] * corr + sum;
    m[r] = mx;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][2 * r] *= corr;
      o[j][2 * r + 1] *= corr;
    }
  }
}

// o (16 rows x HDP) += P (16 rows x 16 keys: n-tiles n0, n0 + 1 of s) V,
// V rows Vs.. of the tile in shared memory; the B fragments of up to four
// 16-dim column pairs are loaded before their products are issued
template <int NT, int NO, int LD>
__device__ __forceinline__ void pv_step(float (&o)[NO][4],
                                        const float (&s)[NT][4], int n0,
                                        const bf16* Vs, int lane) {
  constexpr int NB = NO / 2 < 4 ? NO / 2 : 4;
  const unsigned a[4] = {pack_bf16(s[n0][0], s[n0][1]),
                         pack_bf16(s[n0][2], s[n0][3]),
                         pack_bf16(s[n0 + 1][0], s[n0 + 1][1]),
                         pack_bf16(s[n0 + 1][2], s[n0 + 1][3])};
  const bf16* base =
      Vs + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3);
#pragma unroll
  for (int j0 = 0; j0 < NO / 2; j0 += NB) {
    unsigned bv[NB][4];
#pragma unroll
    for (int u = 0; u < NB; ++u) ldsm_x4_t(bv[u], base + (j0 + u) * 16);
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      mma16816(o[2 * (j0 + u)], a, bv[u][0], bv[u][1]);
      mma16816(o[2 * (j0 + u) + 1], a, bv[u][2], bv[u][3]);
    }
  }
}

// s (16 rows x 16 NP keys: n-tiles 0 .. 2 NP - 1) += Q K^T for K rows Ks..;
// per 16-dim step the B fragments of all NP key pairs are loaded first
template <int NP, int KS, int LD>
__device__ __forceinline__ void qk_tile(float (&s)[2 * NP][4],
                                        const unsigned (&qf)[KS][4],
                                        const bf16* Ks, int lane) {
  const bf16* base =
      Ks + ((lane & 7) + ((lane >> 4) << 3)) * LD + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    unsigned bk[NP][4];
#pragma unroll
    for (int nn = 0; nn < NP; ++nn)
      ldsm_x4(bk[nn], base + nn * 16 * LD + kk * 16);
#pragma unroll
    for (int nn = 0; nn < NP; ++nn) {
      mma16816(s[2 * nn], qf[kk], bk[nn][0], bk[nn][1]);
      mma16816(s[2 * nn + 1], qf[kk], bk[nn][2], bk[nn][3]);
    }
  }
}

// a barrier for the 4 warps of kv group `g` only (id 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "n"(kThreads) : "memory");
}

template <int HDP, int NG>
constexpr size_t prefill_smem() {  // Q tile + per kv group 2 x (K, V) tiles
  return sizeof(bf16) * (size_t)(kTile + 4 * kTile * NG) * (HDP + 8);
}

// A block owns 64 query rows, 16 a warp. NG kv groups of 4 warps share the
// rows: group g takes kv tiles g, g + NG, ... of the block's range with its
// own double-buffered ring, and group 0 merges the groups' (m, l, o) at
// the end.
template <int HDP, int NG>
__global__ void __launch_bounds__(kThreads* NG)
    attn_prefill_kernel(Params p) {
  constexpr int LD = HDP + 8, KS = HDP / 16, NO = HDP / 8, NT = kTile / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // kTile x LD
  const int tid = threadIdx.x, grp = tid / kThreads, gtid = tid % kThreads;
  const int warp = gtid >> 5, lane = tid & 31;  // warp within its group
  bf16* KV = Qs + (1 + 4 * grp) * kTile * LD;    // 2 x (K tile, V tile)

  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // heaviest first
  const int hk = h / (p.H / p.K), off = p.T - p.S;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // kv range this block can see: whole tiles outside it are never loaded
  const int rows = min(kTile, p.S - q0);
  const int qpos_first = q0 + off, qpos_last = q0 + rows - 1 + off;
  int kv_lo = 0, kv_hi = p.T;
  if (p.causal) {
    kv_hi = min(p.T, qpos_last + 1);
    if (p.window > 0) kv_lo = max(0, qpos_first - p.window + 1);
  }
  kv_lo = (kv_lo / kTile) * kTile;
  const int ntiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kTile - 1) / kTile : 0;
  const int nj = ntiles > grp ? (ntiles - grp + NG - 1) / NG : 0;
  const int t_first = kv_lo + grp * kTile;  // tile j at t_first + j NG kTile

  // Q by every thread; this group's first two tiles by its own threads
  stage_rows<HDP, kTile, kThreads * NG>(Qs, q, p.q_ss, q0, p.S, p.hd, tid);
  for (int j = 0; j < 2 && j < nj; ++j) {
    bf16* buf = KV + j * 2 * kTile * LD;
    const int t0 = t_first + j * NG * kTile;
    stage_rows<HDP, kTile>(buf, k, p.k_st, t0, p.T, p.hd, gtid);
    stage_rows<HDP, kTile>(buf + kTile * LD, v, p.v_st, t0, p.T, p.hd, gtid);
    cp_async_commit();
  }
  if (nj == 0) cp_async_commit();
  if (nj > 1) {
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();  // Q and every group's first tile have landed

  const float sl2 = p.scale * 1.4426950408889634f;
  const int g = lane >> 2, t4 = lane & 3;
  const int qp0 = q0 + warp * 16 + g + off;  // rows qp0 and qp0 + 8
  unsigned qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                        ((lane >> 4) << 3));
  float o[NO][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int j = 0; j < nj; ++j) {
    const int t0 = t_first + j * NG * kTile;
    if (j > 0) {  // tile j + 1 loads while tile j computes
      if (j + 1 < nj) {
        bf16* nxt = KV + ((j + 1) & 1) * 2 * kTile * LD;
        const int t1 = t0 + NG * kTile;
        stage_rows<HDP, kTile>(nxt, k, p.k_st, t1, p.T, p.hd, gtid);
        stage_rows<HDP, kTile>(nxt + kTile * LD, v, p.v_st, t1, p.T, p.hd,
                               gtid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      group_sync(grp);
    }
    const bf16* Ks = KV + (j & 1) * 2 * kTile * LD;
    const bf16* Vs = Ks + kTile * LD;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    qk_tile<NT / 2, KS, LD>(s, qf, Ks, lane);

    const bool edge =
        t0 + kTile > p.T ||
        (p.causal && (t0 + kTile - 1 > qpos_first ||
                      (p.window > 0 && qpos_last - t0 >= p.window)));
    if (edge) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(t0 + n * 8 + 2 * t4 + (e & 1), qp0 + (e >> 1) * 8, p.T,
                       p))
            s[n][e] = -INFINITY;
    }
    softmax_step<NT, NO>(s, m, l, o, sl2);
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk)
      pv_step<NT, NO, LD>(o, s, 2 * kk, Vs + kk * 16 * LD, lane);
    group_sync(grp);  // this buffer is refilled two tiles on
  }

  if constexpr (NG > 1) {  // group 0 takes the others' (m, l, o)
    __syncthreads();       // every group is done with its tiles
    float* X = reinterpret_cast<float*>(Qs + kTile * LD);
    constexpr int NV = NO * 4 + 4;  // values per thread
    if (grp > 0) {
      float* mine = X + (grp - 1) * NV * kThreads + gtid;
#pragma unroll
      for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(j * 4 + e) * kThreads] = o[j][e];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mine[(NO * 4 + r) * kThreads] = m[r];
        mine[(NO * 4 + 2 + r) * kThreads] = l[r];
      }
    }
    __syncthreads();
    if (grp > 0) return;
    for (int og = 1; og < NG; ++og) {
      const float* theirs = X + (og - 1) * NV * kThreads + gtid;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = theirs[(NO * 4 + r) * kThreads];
        const float mx = fmaxf(m[r], m1);
        const float base = mx == -INFINITY ? 0.f : mx * sl2;
        const float c0 = exp2f(m[r] * sl2 - base), c1 = exp2f(m1 * sl2 - base);
        l[r] = l[r] * c0 + theirs[(NO * 4 + 2 + r) * kThreads] * c1;
        m[r] = mx;
#pragma unroll
        for (int j = 0; j < NO; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            o[j][2 * r + c] = o[j][2 * r + c] * c0 +
                              theirs[(j * 4 + 2 * r + c) * kThreads] * c1;
      }
    }
  }

  bf16* out = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int i = q0 + warp * 16 + g + 8 * r;
    if (i >= p.S) continue;
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int d = j * 8 + 2 * t4;
      if (d < p.hd)
        *reinterpret_cast<__nv_bfloat162*>(out + i * p.o_ss + d) =
            __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    }
  }
}

template <int HDP>
constexpr size_t decode_smem() {  // 16-row Q tile + 2 x (K, V) tiles
  return sizeof(bf16) * (size_t)(16 + 4 * kTile) * (HDP + 8);
}

template <int HDP>
__global__ void __launch_bounds__(kThreads)
    attn_decode_split_kernel(Params p) {
  constexpr int LD = HDP + 8, KS = HDP / 16, NO = HDP / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // 16 x LD
  bf16* KV = Qs + 16 * LD;                    // 2 x (K tile, V tile)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  // a split past the lane's keys returns at once: the combine reads only
  // the splits that cover [0, lengths[b])
  const int T = lane_keys(p, b);
  if (p.lengths && sp * p.split >= T) return;
  const int G = p.H / p.K, R = p.S * G, off = T - p.S;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;

  // tile row r is query r / G of head hk G + r % G; rows past R are 0
  for (int idx = tid; idx < 16 * (HDP / 8); idx += kThreads) {
    const int r = idx / (HDP / 8), c = (idx % (HDP / 8)) * 8;
    const bool ok = r < R && c < p.hd;
    cp_async16(Qs + r * LD + c,
               ok ? q + (r / G) * p.q_ss + (hk * G + r % G) * p.q_sh + c : q,
               ok);
  }
  // this split's keys, from the first tile that the first row can see
  const int s_lo = sp * p.split, s_hi = min(T, s_lo + p.split);
  int lo = s_lo;
  if (p.causal && p.window > 0) lo = max(lo, off - p.window + 1);
  lo = s_lo + ((lo - s_lo) / kTile) * kTile;
  const int ntiles = s_hi > lo ? (s_hi - lo + kTile - 1) / kTile : 0;
  if (ntiles > 0) {
    stage_rows<HDP, kTile>(KV, k, p.k_st, lo, s_hi, p.hd, tid);
    stage_rows<HDP, kTile>(KV + kTile * LD, v, p.v_st, lo, s_hi, p.hd, tid);
  }
  cp_async_commit();

  const float sl2 = p.scale * 1.4426950408889634f;
  const int g = lane >> 2, t4 = lane & 3;
  const bool row_ok[2] = {g < R, g + 8 < R};
  const int qpos[2] = {g / G + off, (g + 8) / G + off};
  unsigned qf[KS][4];
  float o[NO][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int t0 = lo + it * kTile;
    if (it + 1 < ntiles) {
      bf16* nxt = KV + ((it + 1) & 1) * 2 * kTile * LD;
      stage_rows<HDP, kTile>(nxt, k, p.k_st, t0 + kTile, s_hi, p.hd, tid);
      stage_rows<HDP, kTile>(nxt + kTile * LD, v, p.v_st, t0 + kTile, s_hi,
                             p.hd, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], Qs + (lane & 15) * LD + kk * 16 + ((lane >> 4) << 3));
    }
    // warp w takes keys t0 + 16 w .. t0 + 16 w + 15 of the tile
    const bf16* Ks = KV + (it & 1) * 2 * kTile * LD + warp * 16 * LD;
    const bf16* Vs = Ks + kTile * LD;
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    qk_tile<1, KS, LD>(s, qf, Ks, lane);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = t0 + warp * 16 + n * 8 + 2 * t4 + (e & 1);
        if (!row_ok[e >> 1] || t >= s_hi || !visible(t, qpos[e >> 1], T, p))
          s[n][e] = -INFINITY;
      }
    softmax_step<2, NO>(s, m, l, o, sl2);
    pv_step<2, NO, LD>(o, s, 0, Vs, lane);
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();  // the tiles' memory is reused below

  // merge the four warps' (m, l, o): m in log2 units, rescaled to the max
  float* Ow = reinterpret_cast<float*>(KV);  // 4 warps x 16 rows x HDP
  float* Mw = Ow + 4 * 16 * HDP;             // 4 x 16
  float* Lw = Mw + 4 * 16;                   // 4 x 16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = warp * 16 + g + 8 * r;
    if (t4 == 0) {
      Mw[row] = m[r] * sl2;
      Lw[row] = lr;
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      Ow[row * HDP + j * 8 + 2 * t4] = o[j][2 * r];
      Ow[row * HDP + j * 8 + 2 * t4 + 1] = o[j][2 * r + 1];
    }
  }
  __syncthreads();
  const long long nrows = (long long)p.B * p.S * p.H;
  for (int idx = tid; idx < R * HDP; idx += kThreads) {
    const int r = idx / HDP, d = idx % HDP;
    if (d >= p.hd) continue;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, Mw[w * 16 + r]);
    float L = 0.f, acc = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float c = exp2f(Mw[w * 16 + r] - M);
        L += Lw[w * 16 + r] * c;
        acc += Ow[(w * 16 + r) * HDP + d] * c;
      }
    }
    const long long row =
        ((long long)b * p.S + r / G) * p.H + hk * G + r % G;
    const long long at = (long long)sp * nrows + row;
    p.part_o[at * p.hd + d] = acc;
    if (d == 0) {
      p.part_ml[2 * at] = M;
      p.part_ml[2 * at + 1] = L;
    }
  }
}

// o[row] = sum_i o_i 2^(m_i - M) / sum_i l_i 2^(m_i - M), M = max_i m_i,
// over the splits' partials; a block per (b, s, h) row: the splits' (m, l)
// are read in parallel into shared memory, then thread d sums dim d with
// its loads over the splits independent of each other.
__global__ void __launch_bounds__(kThreads)
    attn_decode_combine_kernel(Params p) {
  extern __shared__ float4 smem4[];
  float* w = reinterpret_cast<float*>(smem4);  // splits x (m, l), then weights
  const long long nrows = (long long)p.B * p.S * p.H;
  const long long row = blockIdx.x;
  const int tid = threadIdx.x;
  const int h = (int)(row % p.H), s = (int)(row / p.H % p.S);
  const int b = (int)(row / ((long long)p.H * p.S));
  // with per-lane lengths only the splits that cover [0, lengths[b]) ran
  const int n =
      p.lengths ? min(p.splits, (lane_keys(p, b) + p.split - 1) / p.split)
                : p.splits;
  for (int i = tid; i < n; i += kThreads) {
    const float2 ml =
        *reinterpret_cast<const float2*>(p.part_ml + 2 * (i * nrows + row));
    w[2 * i] = ml.x;
    w[2 * i + 1] = ml.y;
  }
  __syncthreads();
  float M = -INFINITY, L = 0.f;
  for (int i = 0; i < n; ++i) M = fmaxf(M, w[2 * i]);
  if (M != -INFINITY)
    for (int i = 0; i < n; ++i) L += w[2 * i + 1] * exp2f(w[2 * i] - M);
  const float inv = L > 0.f ? 1.f / L : 0.f;
  __syncthreads();
  // each split's weight over its own m: no thread reads another's slot
  for (int i = tid; i < n; i += kThreads)
    w[2 * i] = M == -INFINITY ? 0.f : exp2f(w[2 * i] - M) * inv;
  __syncthreads();
  bf16* out = static_cast<bf16*>(p.o) + b * p.o_sb + s * p.o_ss + h * p.o_sh;
  for (int d = tid; d < p.hd; d += kThreads) {
    const float* src = p.part_o + row * p.hd + d;
    float acc = 0.f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) acc += src[i * nrows * p.hd] * w[2 * i];
    out[d] = __float2bfloat16(acc);
  }
}

template <int HDP, int NG>
cudaError_t launch_prefill(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = prefill_smem<HDP, NG>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_prefill_kernel<HDP, NG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.H, (p.S + kTile - 1) / kTile, p.B);
  attn_prefill_kernel<HDP, NG><<<grid, kThreads * NG, smem, stream>>>(p);
  return cudaGetLastError();
}

size_t combine_smem(int splits) { return sizeof(float) * 2 * (size_t)splits; }

template <int HDP>
cudaError_t launch_decode(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = decode_smem<HDP>();
  cudaError_t e = cudaFuncSetAttribute(
      attn_decode_split_kernel<HDP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(p.splits, p.K, p.B);
  attn_decode_split_kernel<HDP><<<grid, kThreads, smem, stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the combine: a block per output row
  attn_decode_combine_kernel<<<(unsigned)((long long)p.B * p.S * p.H),
                               kThreads, combine_smem(p.splits), stream>>>(p);
  return cudaGetLastError();
}

template <int HDP>
cudaError_t launch_tc(int path, int groups, const Params& p,
                      cudaStream_t stream) {
  if (path == 2) return launch_decode<HDP>(p, stream);
  return groups == 2 ? launch_prefill<HDP, 2>(p, stream)
                     : launch_prefill<HDP, 1>(p, stream);
}

// the attributes of one kernel of a path at a padded head dim
template <int HDP>
cudaError_t attrs_hdp(int path, cudaFuncAttributes* a, int* dyn) {
  switch (path) {  // the codes of flash_attention_attrs
    case 0:
      *dyn = (int)smem_bytes<HDP, 8>();
      return cudaFuncGetAttributes(a, attn_fwd_kernel<float, float, HDP, 8>);
    case 1:
      *dyn = (int)prefill_smem<HDP, 1>();
      return cudaFuncGetAttributes(a, attn_prefill_kernel<HDP, 1>);
    case 4:
      *dyn = (int)prefill_smem<HDP, 2>();
      return cudaFuncGetAttributes(a, attn_prefill_kernel<HDP, 2>);
    case 2:
      *dyn = (int)decode_smem<HDP>();
      return cudaFuncGetAttributes(a, attn_decode_split_kernel<HDP>);
    default:
      *dyn = (int)combine_smem(1);
      return cudaFuncGetAttributes(a, attn_decode_combine_kernel);
  }
}

}  // namespace

// path: 0 = CUDA cores, 1 = tensor-core prefill with `groups` (1 or 2) kv
// groups of 4 warps per block, 2 = split-KV decode: `splits` splits of
// `split` keys write their partials to part_o (splits, B S H, hd) and
// part_ml (splits, B S H, 2), fp32, and a second launch combines them into
// o. `lengths`, null or (B,) int32 on the device: lane b sees keys t <
// lengths[b] of the T a lane holds (paths 0 and 2; the prefill refuses it).
// dtype codes: 0 = float32, 1 = bfloat16. Strides are in elements; the
// last dim of every tensor is contiguous. Returns cudaGetLastError() of the
// launch(es) (0 on success), or cudaErrorInvalidValue for what the path
// does not take.
extern "C" int flash_attention_fwd(
    int path, int q_dtype, int kv_dtype, const void* q, const void* k,
    const void* v, void* o, int B, int S, int T, int H, int K, int hd,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_st, long long k_sh, long long v_sb, long long v_st,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, int groups, int split, int splits,
    void* part_o, void* part_ml, const void* lengths, void* stream) {
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
           aligned ? 1 : 0, split, splits,
           static_cast<float*>(part_o), static_cast<float*>(part_ml),
           static_cast<const int*>(lengths)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == 0) {
    if (q_dtype == 0 && kv_dtype == 0) return launch_hd<float, float>(p, st);
    if (q_dtype == 1 && kv_dtype == 1)
      return launch_hd<__nv_bfloat16, __nv_bfloat16>(p, st);
    if (q_dtype == 0 && kv_dtype == 1)
      return launch_hd<float, __nv_bfloat16>(p, st);
    return cudaErrorInvalidValue;
  }
  const bool q_aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                         q_sb % 8 == 0 && q_ss % 8 == 0 && q_sh % 8 == 0;
  const bool decode_ok = S * (H / K) <= 16 && split % kTile == 0 &&
                         splits >= 1 && splits <= 4096 &&
                         (long long)split * splits >= T && part_o && part_ml;
  if (q_dtype != 1 || kv_dtype != 1 || !aligned || !q_aligned || hd > 128 ||
      !((path == 1 && !lengths && (groups == 1 || groups == 2)) ||
        (path == 2 && decode_ok)))
    return cudaErrorInvalidValue;
  if (hd <= 32) return launch_tc<32>(path, groups, p, st);
  if (hd <= 64) return launch_tc<64>(path, groups, p, st);
  return launch_tc<128>(path, groups, p, st);
}

// What the card reports for one kernel: path 0 (the fp32 CUDA-core kernel
// at 8 rows a warp), 1 (the prefill, one kv group), 2 (the split-KV decode),
// 3 (its combine) or 4 (the prefill, two kv groups), at padded head dim
// hdp (32, 64 or 128). out: registers per thread, static shared memory,
// the dynamic shared memory a launch asks for (the combine's at one
// split), local (spill) bytes per thread.
extern "C" int flash_attention_attrs(int path, int hdp, int* out) {
  cudaFuncAttributes a;
  int dyn = 0;
  cudaError_t e = hdp == 32   ? attrs_hdp<32>(path, &a, &dyn)
                  : hdp == 64 ? attrs_hdp<64>(path, &a, &dyn)
                              : attrs_hdp<128>(path, &a, &dyn);
  if (e != cudaSuccess) return e;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = dyn;
  out[3] = (int)a.localSizeBytes;
  return 0;
}
