// Chunkwise stabilised mLSTM (xLSTM matrix memory) for Hopper (sm_90a),
// CUDA C++ with a plain C interface (bound with ctypes by
// repro_torch/kernels/mlstm_scan.py).
//
// Replaces the Pallas TPU kernel `mlstm_scan` (src/repro/kernels/
// mlstm_scan.py, body `_mlstm_kernel`): q, k, v (B,S,H,P), raw input and
// forget gates (B,S,H) -> h (B,S,H,P) in q's type, and optionally the final
// state C (B,H,P,P), n (B,H,P), m (B,H) in fp32, which the Pallas kernel
// keeps in VMEM scratch and drops (the port's prefill needs it for the
// decode cache). Per head, chunks of Q steps, b = inclusive cumsum of
// log sigmoid(f) within the chunk, q scaled by 1/sqrt(P):
//   m_i   = max(max_{j<=i} (b_i - b_j + i_j), b_i + m_prev)        (>= -1e30)
//   h_i   = (sum_{j<=i} (q_i . k_j) e^{b_i - b_j + i_j - m_i} v_j
//            + e^{b_i + m_prev - m_i} C q_i)
//           / max(|sum_{j<=i} (q_i . k_j) e^{...} + e^{...} n . q_i|, e^{-m_i})
//   a_j   = i_j + b_Q - b_j,  m' = max(b_Q + m_prev, max_j a_j)
//   C     = e^{b_Q + m_prev - m'} C + sum_j e^{a_j - m'} v_j k_j^T  (n: k_j)
// Steps past the sequence end get i = -1e30 and no decay (no padded
// copies), so a ragged last chunk leaves the final state equal to the
// token-by-token recurrence's.
//
// What bounds it on this card: per chunk and head the causal q k^T and
// w v triangles and the two Q P^2 products (q C^T and the state update),
// against Q (3 P + 2) elements read and Q P written; at xlstm-350m's
// prefill shape (Q = 64, P = 512, bf16) that is some 270 fp32 operations
// per byte (220 with the fp32 state written out), ten times the card's
// fp32 rate over its memory rate, so a kernel at its bound would be bound
// by fp32 operations (or tensor-core operations, with the products on
// wgmma).
//
// Design (simple and correct first; wgmma/TMA and a sequence split are
// later work):
//   * The (P, P) state of one head is 1 MiB in fp32 at P = 512, more than
//     a block's shared memory. Rows p of C (and the columns p of h) are
//     independent given q, k and the gates, so the grid is (B H, P / 32):
//     each block owns 32 rows of C, kept in shared memory as [r][p], and
//     walks the chunks in order. Every block of a head recomputes the
//     gates, the (Q, Q) q k^T products and the normaliser n (P floats,
//     it depends on k alone) itself, rather than splitting into a first
//     pass: at B = 1, H = 4, P = 512 that fills 64 of the 132 SMs, with
//     119,056 bytes of shared memory per block at Q = 64 (one block per
//     SM).
//   * Per chunk the block stages the gates and computes the stabiliser
//     and the decay weights (warp-scanned cumsum, accurate logf/expf in
//     fp32 whatever the input type), then walks the head dimension in
//     tiles of 32: q and k tiles (fp32, rows padded to 33 floats) feed
//     the (Q, Q) q k^T micro-tiles held in registers, h's inter-chunk
//     term q C^T and q . n against the old state, and then, after a
//     barrier, the state tile's update. Last, the masked weights W =
//     (q k^T) o e^{...} go to shared memory and each warp finishes its
//     rows of h.
//   * The mask selects 0 above the diagonal before the exponential, whose
//     argument is positive there; m starts at -inf, and e^{-inf} = 0
//     gives the first chunk no inter-chunk term (no fast math).
//   * Strided q, k, v and gates (the model's einsum outputs and the split
//     gate projection): only the last dim of q, k, v must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPT = 32;    // rows p of C (columns of h) per block
constexpr int kR = 32;     // head-dim tile of q and k
constexpr int kRS = kR + 1;
constexpr int kMaxSmemBytes = 232448;  // opt-in shared memory of a block
constexpr float kNoInput = -1e30f;     // input gate of a step past the end

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* ig;
  const void* fg;
  void* h;
  float* C;  // (B, H, P, P) or null
  float* n;  // (B, H, P)
  float* m;  // (B, H)
  int B, S, H, P, Q;
  float scale;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long i_sb, i_ss, i_sh, f_sb, f_ss, f_sh;
  long long h_sb, h_ss, h_sh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// log sigmoid(x) = -softplus(-x), written so that neither branch overflows
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

size_t smem_floats(int QT, int P) {
  return static_cast<size_t>(P) * kPT + P + 2 * static_cast<size_t>(QT) * kRS +
         2 * static_cast<size_t>(QT) * kPT +
         static_cast<size_t>(QT) * (QT + 1) + 6 * static_cast<size_t>(QT) + 4;
}

template <typename T, int QT>
__global__ void __launch_bounds__(kThreads) mlstm_scan_kernel(Params p) {
  constexpr int MT = QT / 16;       // q k^T micro-tile per thread: MT x MT
  constexpr int MR = QT / kWarps;   // rows of h per warp
  constexpr int WS = QT + 1;        // row stride of W
  extern __shared__ float smem[];
  const int P = p.P;
  float* Cs = smem;                 // (P, kPT) state rows [r][p]
  float* ns = Cs + P * kPT;         // (P) normaliser
  float* qs = ns + P;               // (QT, kRS) q tile, scaled
  float* ks = qs + QT * kRS;        // (QT, kRS) k tile
  float* vs = ks + QT * kRS;        // (QT, kPT) v columns of the block
  float* vws = vs + QT * kPT;       // (QT, kPT) e^{a_j - m'} v
  float* W = vws + QT * kPT;        // (QT, WS) masked q k^T weights
  float* bs = W + QT * WS;          // (QT) cumsum of log sigmoid(f)
  float* igs = bs + QT;             // (QT) input gate, -1e30 past the end
  float* mloc = igs + QT;           // (QT) row stabiliser
  float* winter = mloc + QT;        // (QT) e^{b_i + m_prev - m_i}
  float* as = winter + QT;          // (QT) a_j, then e^{a_j - m'}
  float* den = as + QT;             // (QT) denominators
  float* sc = den + QT;             // m', e^{b_Q + m_prev - m'}

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, b = bh / p.H, hh = bh - b * p.H;
  const int p0 = blockIdx.y * kPT, pc = p0 + lane;  // this lane's column
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + hh * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hh * p.v_sh;
  const T* ig = static_cast<const T*>(p.ig) + b * p.i_sb + hh * p.i_sh;
  const T* fg = static_cast<const T*>(p.fg) + b * p.f_sb + hh * p.f_sh;
  T* h = static_cast<T*>(p.h) + b * p.h_sb + hh * p.h_sh;
  const int ty = tid >> 4, tx = tid & 15;  // q k^T micro-tile coordinates

  for (int e = tid; e < P * kPT; e += kThreads) Cs[e] = 0.f;
  for (int e = tid; e < P; e += kThreads) ns[e] = 0.f;
  float m_prev = -INFINITY;

  for (int t0 = 0; t0 < p.S; t0 += p.Q) {
    const int len = min(p.Q, p.S - t0);
    // ---- gates and the v columns of the chunk ----
    if (tid < QT) {
      float lf = 0.f, it = kNoInput;  // past the end: no input, no decay
      if (tid < len) {
        lf = log_sigmoid(to_f(fg[(t0 + tid) * p.f_ss]));
        it = to_f(ig[(t0 + tid) * p.i_ss]);
      }
      bs[tid] = lf;
      igs[tid] = it;
    }
    for (int e = tid; e < QT * kPT; e += kThreads) {
      const int j = e / kPT, c = e - j * kPT;
      vs[e] = (j < len && p0 + c < P) ? to_f(v[(t0 + j) * p.v_ss + p0 + c])
                                      : 0.f;
    }
    __syncthreads();
    if (warp == 0) {  // inclusive cumsum of log sigmoid(f)
      constexpr int run_len = (QT + 31) / 32;
      const int lo = min(lane * run_len, QT), hi = min(lo + run_len, QT);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += bs[i];
        bs[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += u;
      }
      const float before = incl - run;
      for (int i = lo; i < hi; ++i) bs[i] += before;
    }
    __syncthreads();
    const float b_last = bs[QT - 1];
    if (tid < QT) {  // row stabiliser and inter-chunk weight
      const float bi = bs[tid];
      float mx = bi + m_prev;
      for (int j = 0; j <= tid; ++j) mx = fmaxf(mx, bi - bs[j] + igs[j]);
      mx = fmaxf(mx, -1e30f);  // no -inf - -inf below
      mloc[tid] = mx;
      winter[tid] = expf(bi + m_prev - mx);
      as[tid] = igs[tid] + (b_last - bi);
    }
    __syncthreads();
    if (warp == 0) {  // the state's new stabiliser and decay
      float amax = -INFINITY;
      for (int j = lane; j < QT; j += 32) amax = fmaxf(amax, as[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float m_new = fmaxf(b_last + m_prev, amax);
      for (int j = lane; j < QT; j += 32) as[j] = expf(as[j] - m_new);
      if (lane == 0) {
        sc[0] = m_new;
        sc[1] = expf(b_last + m_prev - m_new);
      }
    }
    __syncthreads();
    const float m_new = sc[0], w_old = sc[1];
    for (int e = tid; e < QT * kPT; e += kThreads) vws[e] = as[e / kPT] * vs[e];

    // ---- walk the head dimension in tiles of kR ----
    float acc[MT][MT];
#pragma unroll
    for (int u = 0; u < MT; ++u)
#pragma unroll
      for (int w = 0; w < MT; ++w) acc[u][w] = 0.f;
    float hacc[MR];
#pragma unroll
    for (int u = 0; u < MR; ++u) hacc[u] = 0.f;
    float qn = 0.f;

    for (int r0 = 0; r0 < P; r0 += kR) {
      const int rlen = min(kR, P - r0);
      for (int e = tid; e < QT * kR; e += kThreads) {
        const int i = e / kR, r = e - i * kR;
        const bool in = i < len && r < rlen;
        qs[i * kRS + r] =
            in ? to_f(q[(t0 + i) * p.q_ss + r0 + r]) * p.scale : 0.f;
        ks[i * kRS + r] = in ? to_f(k[(t0 + i) * p.k_ss + r0 + r]) : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < rlen; ++r) {  // q k^T, rows ty + 16u, cols tx + 16w
        float qa[MT], kb[MT];
#pragma unroll
        for (int u = 0; u < MT; ++u) {
          qa[u] = qs[(ty + 16 * u) * kRS + r];
          kb[u] = ks[(tx + 16 * u) * kRS + r];
        }
#pragma unroll
        for (int u = 0; u < MT; ++u)
#pragma unroll
          for (int w = 0; w < MT; ++w) acc[u][w] = fmaf(qa[u], kb[w], acc[u][w]);
      }
      for (int r = 0; r < rlen; ++r) {  // q C^T against the old state
        const float c = Cs[(r0 + r) * kPT + lane];
#pragma unroll
        for (int u = 0; u < MR; ++u)
          hacc[u] = fmaf(qs[(warp * MR + u) * kRS + r], c, hacc[u]);
      }
      if (tid < QT)  // q . n against the old normaliser
        for (int r = 0; r < rlen; ++r) qn = fmaf(qs[tid * kRS + r], ns[r0 + r], qn);
      __syncthreads();
      // state update of rows r0 + warp * 4 + u (kR / kWarps = 4 per warp)
      constexpr int RW = kR / kWarps;
      float upd[RW];
#pragma unroll
      for (int u = 0; u < RW; ++u) upd[u] = 0.f;
      for (int j = 0; j < QT; ++j) {
        const float vw = vws[j * kPT + lane];
#pragma unroll
        for (int u = 0; u < RW; ++u)
          upd[u] = fmaf(ks[j * kRS + warp * RW + u], vw, upd[u]);
      }
#pragma unroll
      for (int u = 0; u < RW; ++u) {
        const int r = warp * RW + u;
        if (r < rlen) {
          float* c = Cs + (r0 + r) * kPT + lane;
          *c = fmaf(w_old, *c, upd[u]);
        }
      }
      if (tid < rlen) {
        float s = 0.f;
        for (int j = 0; j < QT; ++j) s = fmaf(as[j], ks[j * kRS + tid], s);
        ns[r0 + tid] = fmaf(w_old, ns[r0 + tid], s);
      }
      __syncthreads();  // before the next tile overwrites q and k
    }

    // ---- masked weights, denominators, h ----
#pragma unroll
    for (int u = 0; u < MT; ++u) {
      const int i = ty + 16 * u;
#pragma unroll
      for (int w = 0; w < MT; ++w) {
        const int j = tx + 16 * w;
        float x = 0.f;  // selected before the exponential
        if (j <= i) x = acc[u][w] * expf(bs[i] - bs[j] + igs[j] - mloc[i]);
        W[i * WS + j] = x;
      }
    }
    __syncthreads();
    if (tid < QT) {
      float s = 0.f;
      for (int j = 0; j <= tid; ++j) s += W[tid * WS + j];
      const float nq = s + winter[tid] * qn;
      den[tid] = fmaxf(fabsf(nq), expf(-mloc[tid]));
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < MR; ++u) {
      const int i = warp * MR + u;
      if (i < len) {
        float s = 0.f;
        for (int j = 0; j <= i; ++j) s = fmaf(W[i * WS + j], vs[j * kPT + lane], s);
        if (pc < P)
          store(h + (t0 + i) * p.h_ss + pc, (s + winter[i] * hacc[u]) / den[i]);
      }
    }
    m_prev = m_new;
    __syncthreads();  // before the next chunk overwrites the staged rows
  }

  if (p.C != nullptr) {
    float* Cout = p.C + static_cast<long long>(bh) * P * P;
    for (int e = tid; e < kPT * P; e += kThreads) {
      const int r = e / kPT, c = e - r * kPT;
      if (p0 + c < P) Cout[static_cast<long long>(p0 + c) * P + r] = Cs[e];
    }
    if (blockIdx.y == 0) {
      for (int e = tid; e < P; e += kThreads)
        p.n[static_cast<long long>(bh) * P + e] = ns[e];
      if (tid == 0) p.m[bh] = m_prev;
    }
  }
}

template <typename T, int QT>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(QT, p.P) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlstm_scan_kernel<T, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.B * p.H, (p.P + kPT - 1) / kPT);
  mlstm_scan_kernel<T, QT><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tile(const Params& p, cudaStream_t stream) {
  if (p.Q <= 16) return launch<T, 16>(p, stream);
  if (p.Q <= 32) return launch<T, 32>(p, stream);
  if (p.Q <= 64) return launch<T, 64>(p, stream);
  if (p.Q <= 128) return launch<T, 128>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for q, k, v, both gates and h; the
// state is fp32. q, k, v, the gates and h take (batch, seq, head) strides
// in elements; the last dim of q, k, v and h is contiguous. Q is the chunk
// (1..128), scale the factor on q (1/sqrt(P)). C (B,H,P,P), n (B,H,P) and
// m (B,H) contiguous, or C null for no state. Returns the CUDA error of
// the launch (0 on success).
int mlstm_scan_fwd(int dtype, const void* q, const void* k, const void* v,
                   const void* ig, const void* fg, void* h, void* C, void* n,
                   void* m, int B, int S, int H, int P, int Q, float scale,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   long long i_sb, long long i_ss, long long i_sh,
                   long long f_sb, long long f_ss, long long f_sh,
                   long long h_sb, long long h_ss, long long h_sh,
                   void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S <= 0 || P <= 0 || Q <= 0 || Q > 128 ||
      static_cast<long long>(B) * H > 2147483647LL || (P + kPT - 1) / kPT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, ig, fg, h, static_cast<float*>(C), static_cast<float*>(n),
           static_cast<float*>(m), B, S, H, P, Q, scale,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           i_sb, i_ss, i_sh, f_sb, f_ss, f_sh, h_sb, h_ss, h_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tile<float>(p, s);
  if (dtype == 1) return launch_tile<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
