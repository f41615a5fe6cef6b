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
// An optional initial state (C0 (B,H,P,P), n0 (B,H,P), m0 (B,H), fp32,
// contiguous) seeds the walk in place of C = 0, n = 0, m = -inf: the
// seeded output pass of the sequence-parallel mLSTM, whose shards start
// from the combined state of the shards before them (the reference's
// `mlstm_chunked(init_state=...)`). With none given, every kernel runs
// exactly as before.
//
// What bounds it on this card: per chunk and head the causal q k^T and
// w v triangles and the two Q P^2 products (q C^T and the state update),
// against Q (3 P + 2) elements read and Q P written. At xlstm-350m's
// prefill shape (Q = 64, P = 512, bf16, state out) that is 4.58 GFLOP and
// 21 MB: 0.068 ms at the fp32 rate of the CUDA cores, but 0.0046 ms on
// bf16 tensor cores, where the 21 MB (0.0063 ms) bound it. PR 14's design
// (a block per 32 rows of one head's C walking all chunks, every block
// recomputing the gates and the (Q, Q) q k^T, fp32 FMAs) filled 64 SMs and
// took 2.0 ms.
//
// Two paths; the wrapper's `plan` picks one and passes it as `path`:
//
// 1. Tensor cores (bf16, P % 8 == 0, 16-byte aligned rows): four launches
//    of one call, the chunkwise-parallel form (`ref.mlstm_chunk_parallel`
//    is its plain-PyTorch transcript), each chunk's gates, stabilisers and
//    (Q, Q) weights computed once:
//    a. `mlstm_gate_kernel`, a block per head: each warp takes whole
//       chunks (warp scans for the cumsum of log sigmoid(f) and the prefix
//       max of i_j - b_j, so m_i = max(b_i + max_{j<=i}(i_j - b_j),
//       b_i + m_prev) costs O(Q)), warp 0 scans m over the chunks, and
//       the per-step b, i, m_i, e^{b_i + m_prev - m_i}, e^{a_j - m'} and
//       per-chunk decay e^{b_Q + m_prev - m'} go to scratch.
//    b. `mlstm_qk_kernel`, a block per (chunk, head): q k^T on
//       `mma.sync.m16n8k16` (bf16 in, fp32 sums; the causal upper tiles
//       skipped), masked and weighted into W in fp32, with its row sums.
//    c. `mlstm_state_kernel`, a block per (64 x 64 tile of C, head): the
//       only sequential walk. Per chunk it scales its fp32 tile (held in
//       registers as mma accumulators) by the decay, adds
//       (e^{a - m'} o v)^T k on tensor cores, and writes the tile as the
//       next chunk's entry state. 256 blocks at xlstm's shape, where PR
//       14's walk had 64.
//    d. `mlstm_out_kernel`, a block per (64 columns of h, chunk, head):
//       W v and q C_prev^T on tensor cores, q . n_prev in fp32, then the
//       normaliser and h.
//    A second design measured against it on the card (a and b, then one
//    sequential walk per (16 rows of C, head) with the state in
//    registers, no entry state through device memory) lost: 128 blocks,
//    each re-staging every chunk's whole q and k, took about twice as
//    long (PERF.md has both times).
//    Precision: q, k, v arrive in bf16, so q k^T, and k and v as the
//    other operand, are exact up to the fp32 sums. The three weighted
//    operands (e^{a - m'} o v, W and C_prev) go in as two bf16 halves,
//    hi = bf16(x) and lo = bf16(x - hi), two products each: one bf16
//    rounding of any of them moves h past the bf16 tolerance at xlstm's
//    width, where small denominators magnify the numerator's error. The
//    state, the gates and the stabilisers stay fp32 (accurate logf/expf);
//    the row sums of W and q . n use W and n unrounded.
//    Scratch (the wrapper's `scratch_bytes`, allocated with torch.empty):
//    per head the per-step gate terms, W (2 Q^2 bf16 per chunk) and the
//    chunk-entry states C_prev as hi/lo bf16 (4 P^2 bytes per chunk:
//    60 MiB at xlstm's shape, written once, read once).
// 0. CUDA cores (fp32, and bf16 rows that are not 16-byte multiples or not
//    aligned): PR 14's kernel, unchanged. The (P, P) state of one head
//    does not fit a block, so a block owns 32 rows of it in shared memory
//    ([r][p]) and walks the chunks: grid (B H, P / 32), 256 threads, the
//    gates and q k^T recomputed per block, fp32 FMAs throughout. The mask
//    selects 0 above the diagonal before the exponential; m starts at
//    -inf, and e^{-inf} = 0 gives the first chunk no inter-chunk term.
//
// Strided q, k, v and gates (the model's einsum outputs and the split
// gate projection): only the last dim of q, k, v must be contiguous.

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
  const float* C0;  // initial state (B, H, P, P) or null (zero state)
  const float* n0;  // (B, H, P)
  const float* m0;  // (B, H)
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

  if (p.C0 != nullptr) {  // rows p0 .. p0 + 31 of the initial state
    const float* Cin = p.C0 + static_cast<long long>(bh) * P * P;
    for (int e = tid; e < P * kPT; e += kThreads) {
      const int r = e / kPT, c = e - r * kPT;
      Cs[e] = p0 + c < P ? Cin[static_cast<long long>(p0 + c) * P + r] : 0.f;
    }
    for (int e = tid; e < P; e += kThreads)
      ns[e] = p.n0[static_cast<long long>(bh) * P + e];
  } else {
    for (int e = tid; e < P * kPT; e += kThreads) Cs[e] = 0.f;
    for (int e = tid; e < P; e += kThreads) ns[e] = 0.f;
  }
  float m_prev = p.m0 != nullptr ? p.m0[bh] : -INFINITY;

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
int launch_cuda_core(const Params& p, cudaStream_t stream) {
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
int launch_cuda_core_tile(const Params& p, cudaStream_t stream) {
  if (p.Q <= 16) return launch_cuda_core<T, 16>(p, stream);
  if (p.Q <= 32) return launch_cuda_core<T, 32>(p, stream);
  if (p.Q <= 64) return launch_cuda_core<T, 64>(p, stream);
  if (p.Q <= 128) return launch_cuda_core<T, 128>(p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}


// ---------------------------------------------------------------------------
// Path 1: tensor cores (bf16; P % 8 == 0; 16-byte aligned rows)
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;          // columns of a staged tile (p, r or dims)
constexpr int kLD = kTile + 8;     // its row stride in bf16: 8 ldmatrix rows
                                   // land on distinct banks
constexpr int kGateThreads = 256;

// Scratch of the tensor-core path, carved from the wrapper's buffer in this
// order (each array rounded up to 256 bytes; kernels/mlstm_scan.py
// `scratch_bytes` mirrors it). nch chunks, Sp = nch Q steps, QT the tile.
struct Scratch {
  float* b;       // (BH, Sp) cumsum of log sigmoid(f) within the chunk
  float* ig;      // (BH, Sp) input gate, -1e30 past the end
  float* mrow;    // (BH, Sp) row stabiliser m_i
  float* beta;    // (BH, Sp) e^{b_i + m_prev - m_i}
  float* win;     // (BH, Sp) e^{a_j - m'}
  float* cb;      // (BH, nch) b_Q
  float* ca;      // (BH, nch) max_j a_j
  float* cm;      // (BH, nch) m entering the chunk
  float* wold;    // (BH, nch) e^{b_Q + m_prev - m'}
  float* rowsum;  // (BH, nch, QT) row sums of W
  bf16* W;        // (BH, nch, 2, QT, QT) W as hi, lo
  float* nloc;    // (BH, nch, P) sum_j e^{a_j - m'} k_j of each chunk
  float* nprev;   // (BH, ns, P) n entering chunks 1 .. (0 .. when seeded)
  bf16* Cprev;    // (BH, ns, 2, P, P) C entering them, hi, lo
};

// chunk-entry states kept: those of chunks 1 .., and chunk 0's too when an
// initial state seeds it
__host__ __device__ __forceinline__ int entry_states(int nch, bool seeded) {
  return seeded ? nch : nch - 1;
}

size_t carve(Scratch* s, char* base, int BH, int nch, int Q, int QT, int P,
             bool seeded) {
  const long long Sp = static_cast<long long>(nch) * Q;
  const long long ns = entry_states(nch, seeded);
  const long long sizes[14] = {
      4 * BH * Sp, 4 * BH * Sp, 4 * BH * Sp, 4 * BH * Sp, 4 * BH * Sp,
      4LL * BH * nch, 4LL * BH * nch, 4LL * BH * nch, 4LL * BH * nch,
      4LL * BH * nch * QT, 2LL * BH * nch * 2 * QT * QT, 4LL * BH * nch * P,
      4LL * BH * ns * P, 2LL * BH * ns * 2 * P * P};
  void** slots[14] = {
      reinterpret_cast<void**>(&s->b),     reinterpret_cast<void**>(&s->ig),
      reinterpret_cast<void**>(&s->mrow),  reinterpret_cast<void**>(&s->beta),
      reinterpret_cast<void**>(&s->win),   reinterpret_cast<void**>(&s->cb),
      reinterpret_cast<void**>(&s->ca),    reinterpret_cast<void**>(&s->cm),
      reinterpret_cast<void**>(&s->wold),  reinterpret_cast<void**>(&s->rowsum),
      reinterpret_cast<void**>(&s->W),     reinterpret_cast<void**>(&s->nloc),
      reinterpret_cast<void**>(&s->nprev),
      reinterpret_cast<void**>(&s->Cprev)};
  size_t off = 0;
  for (int i = 0; i < 14; ++i) {
    *slots[i] = base + off;
    off += (static_cast<size_t>(sizes[i]) + 255) / 256 * 256;
  }
  return off;
}

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

// d += a (16x16 bf16, row major) * b (16x8 bf16, column major), fp32 sums
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// (x0, x1) as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_pack(float x0, float x1, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// A fragment (16 rows x 16 k) of a row-major [m][k] tile at (m0, k0)
__device__ __forceinline__ void lda(unsigned (&a)[4], const bf16* S, int ld,
                                    int m0, int k0, int lane) {
  ldsm_x4(a, S + (m0 + (lane & 15)) * ld + k0 + ((lane >> 4) << 3));
}
// A fragment of a tile stored transposed, [k][m]
__device__ __forceinline__ void lda_t(unsigned (&a)[4], const bf16* S, int ld,
                                      int m0, int k0, int lane) {
  ldsm_x4_t(a, S + (k0 + (lane & 7) + ((lane >> 4) << 3)) * ld + m0 +
                   (((lane >> 3) & 1) << 3));
}
// B fragments of two n-tiles (n0 .. n0 + 15, k0 .. k0 + 15): b[0], b[1]
// for n-tile n0, b[2], b[3] for n0 + 8. `ldb` from a tile stored [n][k],
// `ldb_t` from one stored [k][n].
__device__ __forceinline__ void ldb(unsigned (&b)[4], const bf16* S, int ld,
                                    int n0, int k0, int lane) {
  ldsm_x4(b, S + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 +
                 (((lane >> 3) & 1) << 3));
}
__device__ __forceinline__ void ldb_t(unsigned (&b)[4], const bf16* S, int ld,
                                      int n0, int k0, int lane) {
  ldsm_x4_t(b, S + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 +
                   ((lane >> 4) << 3));
}

// Stage rows [0, ROWS) x columns [c0, c0 + 64) of `src` (row stride ld
// elements) into shared rows of kLD, NTH threads sharing the 16-byte
// copies; rows at or past n and columns at or past ncol are zero-filled.
template <int ROWS, int NTH>
__device__ __forceinline__ void stage64(bf16* dst, const bf16* src,
                                        long long ld, int n, int c0, int ncol,
                                        int tid) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / NTH; ++i) {
    const int idx = tid + i * NTH;
    const int r = idx >> 3, c = (idx & 7) << 3;
    const bool ok = r < n && c0 + c < ncol;
    cp_async16(dst + r * kLD + c, ok ? src + r * ld + c0 + c : src, ok);
  }
}

__device__ __forceinline__ float warp_incl_sum(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += u;
  }
  return x;
}
__device__ __forceinline__ float warp_incl_max(float x, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = fmaxf(x, u);
  }
  return x;
}

// a. Gates and stabilisers of every chunk of one head (block per head).
template <typename T>
__global__ void __launch_bounds__(kGateThreads)
    mlstm_gate_kernel(Params p, Scratch s) {
  constexpr int NW = kGateThreads / 32;
  const int bh = blockIdx.x, b = bh / p.H, hh = bh - b * p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = (p.S + p.Q - 1) / p.Q;
  const long long Sp = static_cast<long long>(nch) * p.Q;
  const T* ig = static_cast<const T*>(p.ig) + b * p.i_sb + hh * p.i_sh;
  const T* fg = static_cast<const T*>(p.fg) + b * p.f_sb + hh * p.f_sh;
  float* sb = s.b + bh * Sp;
  float* sig = s.ig + bh * Sp;
  float* smr = s.mrow + bh * Sp;
  float* cb = s.cb + static_cast<long long>(bh) * nch;
  float* ca = s.ca + static_cast<long long>(bh) * nch;
  float* cm = s.cm + static_cast<long long>(bh) * nch;
  float* wold = s.wold + static_cast<long long>(bh) * nch;
  const int RL = (p.Q + 31) / 32;  // steps per lane, one contiguous run

  // chunk-local: b, i, the prefix max of i_j - b_j, b_Q and max_j a_j
  for (int c = warp; c < nch; c += NW) {
    const int t0 = c * p.Q, len = min(p.Q, p.S - t0);
    const int lo = min(lane * RL, p.Q), hi = min(lo + RL, p.Q);
    float run = 0.f;
    for (int i = lo; i < hi; ++i) {  // past the end: no decay
      run += i < len ? log_sigmoid(to_f(fg[(t0 + i) * p.f_ss])) : 0.f;
      sb[t0 + i] = run;
    }
    const float before = warp_incl_sum(run, lane) - run;
    float mx = -INFINITY, blast = 0.f;
    for (int i = lo; i < hi; ++i) {
      const float bi = sb[t0 + i] + before;
      const float it = i < len ? to_f(ig[(t0 + i) * p.i_ss]) : kNoInput;
      sb[t0 + i] = bi;
      sig[t0 + i] = it;
      mx = fmaxf(mx, it - bi);
      smr[t0 + i] = mx;  // the lane's own prefix max for now
      blast = bi;
    }
    const float incl = warp_incl_max(mx, lane);
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = -INFINITY;
    for (int i = lo; i < hi; ++i) smr[t0 + i] = fmaxf(excl, smr[t0 + i]);
    const float bQ = __shfl_sync(0xffffffffu, blast, (p.Q - 1) / RL);
    float amax = -INFINITY;
    for (int i = lo; i < hi; ++i) amax = fmaxf(amax, sig[t0 + i] + (bQ - sb[t0 + i]));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (lane == 0) {
      cb[c] = bQ;
      ca[c] = amax;
    }
  }
  __syncthreads();
  // m over the chunks: m' = max(b_Q + m, max_j a_j), 32 chunks per batch
  if (warp == 0) {
    float m = p.m0 != nullptr ? p.m0[bh] : -INFINITY;
    for (int c0 = 0; c0 < nch; c0 += 32) {
      const int c = c0 + lane;
      const float bq = c < nch ? cb[c] : 0.f, am = c < nch ? ca[c] : 0.f;
      float my_m = 0.f, my_w = 0.f;
      for (int u = 0; u < 32 && c0 + u < nch; ++u) {
        const float bQ = __shfl_sync(0xffffffffu, bq, u);
        const float aM = __shfl_sync(0xffffffffu, am, u);
        const float m_new = fmaxf(bQ + m, aM);
        if (lane == u) {
          my_m = m;
          my_w = expf(bQ + m - m_new);
        }
        m = m_new;
      }
      if (c < nch) {
        cm[c] = my_m;
        wold[c] = my_w;
      }
    }
    if (lane == 0 && p.m != nullptr) p.m[bh] = m;
  }
  __syncthreads();
  // per step: m_i, e^{b_i + m_prev - m_i}, e^{a_j - m'}
  for (int c = warp; c < nch; c += NW) {
    const int t0 = c * p.Q;
    const float bQ = cb[c], m_prev = cm[c];
    const float m_new = fmaxf(bQ + m_prev, ca[c]);
    for (int i = lane; i < p.Q; i += 32) {
      const float bi = sb[t0 + i];
      const float mr = fmaxf(fmaxf(bi + smr[t0 + i], bi + m_prev), -1e30f);
      smr[t0 + i] = mr;
      s.beta[bh * Sp + t0 + i] = expf(bi + m_prev - mr);
      s.win[bh * Sp + t0 + i] = expf(sig[t0 + i] + (bQ - bi) - m_new);
    }
  }
}

// b. W = (q k^T) scale e^{b_i - b_j + i_j - m_i} (j <= i) of one chunk of
// one head, stored as hi/lo bf16, and its row sums. QT / 16 warps, 16 rows
// each; the head dim streams through shared memory 64 at a time.
template <int QT>
__global__ void __launch_bounds__(QT * 2) mlstm_qk_kernel(Params p,
                                                          Scratch s) {
  constexpr int NTH = QT * 2, NT = QT / 8;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // 2 x (QT, kLD)
  bf16* Ks = Qs + 2 * QT * kLD;               // 2 x (QT, kLD)
  float* bj = reinterpret_cast<float*>(Ks + 2 * QT * kLD);  // (QT)
  float* gj = bj + QT;                                       // (QT)
  float* wj = gj + QT;                                       // (QT)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / p.H, hh = bh - b * p.H;
  const int nch = (p.S + p.Q - 1) / p.Q, t0 = c * p.Q;
  const int len = min(p.Q, p.S - t0);
  const long long Sp = static_cast<long long>(nch) * p.Q;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + hh * p.q_sh +
                  t0 * p.q_ss;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hh * p.k_sh +
                  t0 * p.k_ss;
  for (int e = tid; e < QT; e += NTH) {
    bj[e] = e < len ? s.b[bh * Sp + t0 + e] : 0.f;
    gj[e] = e < len ? s.ig[bh * Sp + t0 + e] : kNoInput;
    wj[e] = e < p.Q ? s.win[bh * Sp + t0 + e] : 0.f;
  }
  // the chunk's own normaliser sum_j e^{a_j - m'} k_j: NTH / 64 threads
  // (neighbouring lanes) per column of a k tile, 32 steps each
  constexpr int TPC = NTH / kTile;
  const int ncol = tid / TPC, jpart = tid % TPC;
  float* nloc = s.nloc + (static_cast<long long>(bh) * nch + c) * p.P;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int nk = (p.P + kTile - 1) / kTile;
  stage64<QT, NTH>(Qs, q, p.q_ss, len, 0, p.P, tid);
  stage64<QT, NTH>(Ks, k, p.k_ss, len, 0, p.P, tid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      const int nb = (kt + 1) & 1;
      stage64<QT, NTH>(Qs + nb * QT * kLD, q, p.q_ss, len, (kt + 1) * kTile,
                       p.P, tid);
      stage64<QT, NTH>(Ks + nb * QT * kLD, k, p.k_ss, len, (kt + 1) * kTile,
                       p.P, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qb = Qs + (kt & 1) * QT * kLD;
    const bf16* Kb = Ks + (kt & 1) * QT * kLD;
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      unsigned a[4];
      lda(a, Qb, kLD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nn = 0; nn < NT / 2; ++nn) {
        if (nn > warp) continue;  // above the diagonal: masked anyway
        unsigned bk[4];
        ldb(bk, Kb, kLD, nn * 16, kk * 16, lane);
        mma16816(acc[2 * nn], a, bk[0], bk[1]);
        mma16816(acc[2 * nn + 1], a, bk[2], bk[3]);
      }
    }
    float nsum = 0.f;
#pragma unroll 8
    for (int j = jpart * (QT / TPC); j < (jpart + 1) * (QT / TPC); ++j)
      nsum = fmaf(wj[j], __bfloat162float(Kb[j * kLD + ncol]), nsum);
#pragma unroll
    for (int o = TPC / 2; o > 0; o >>= 1)
      nsum += __shfl_xor_sync(0xffffffffu, nsum, o);
    if (jpart == 0 && kt * kTile + ncol < p.P) nloc[kt * kTile + ncol] = nsum;
    __syncthreads();  // before the buffer is staged again
  }

  const int g = lane >> 2, t4 = lane & 3;
  bf16* Wh = s.W + (static_cast<long long>(bh) * nch + c) * 2 * QT * QT;
  bf16* Wl = Wh + QT * QT;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = warp * 16 + g + 8 * r;
    const bool row = i < len;
    const float bi = row ? s.b[bh * Sp + t0 + i] : 0.f;
    const float mi = row ? s.mrow[bh * Sp + t0 + i] : 0.f;
    float rs = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float w[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = n * 8 + 2 * t4 + e;
        w[e] = 0.f;  // selected before the exponential
        if (row && j <= i)
          w[e] = acc[n][2 * r + e] * p.scale * expf(bi - bj[j] + gj[j] - mi);
        rs += w[e];
      }
      unsigned hi, lo;
      split_pack(w[0], w[1], hi, lo);
      const int off = i * QT + n * 8 + 2 * t4;
      *reinterpret_cast<unsigned*>(Wh + off) = hi;
      *reinterpret_cast<unsigned*>(Wl + off) = lo;
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    if (t4 == 0) s.rowsum[(static_cast<long long>(bh) * nch + c) * QT + i] = rs;
  }
}

// c. The state walk of one (64 x 64) tile of one head's C over all chunks;
// 4 warps of 16 rows p. Blocks of the first row tile also carry n (from
// the chunks' own sums of b). The next chunk's v and k tiles, weights and
// decay are loaded while this chunk is computed; the entry states go out
// through shared memory as whole 16-byte pieces.
template <int QT>
__global__ void __launch_bounds__(128) mlstm_state_kernel(Params p,
                                                          Scratch s) {
  constexpr int NTH = 128;
  extern __shared__ float4 smem4[];
  bf16* Vr = reinterpret_cast<bf16*>(smem4);  // 2 x (QT, kLD) raw v
  bf16* Kr = Vr + 2 * QT * kLD;               // 2 x (QT, kLD) raw k
  bf16* VWh = Kr + 2 * QT * kLD;              // (QT, kLD) e^{a - m'} v, hi;
  bf16* VWl = VWh + QT * kLD;                 //   lo; then the state, hi/lo
  float* wj = reinterpret_cast<float*>(VWl + QT * kLD);  // 2 x (QT)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * kTile, p0 = blockIdx.y * kTile;
  const int bh = blockIdx.z, b = bh / p.H, hh = bh - b * p.H;
  const int P = p.P, nch = (p.S + p.Q - 1) / p.Q;
  const long long Sp = static_cast<long long>(nch) * p.Q;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hh * p.v_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hh * p.k_sh;
  const float* win = s.win + bh * Sp;
  const float* wold = s.wold + static_cast<long long>(bh) * nch;
  const float* nloc = s.nloc + static_cast<long long>(bh) * nch * P + r0 + tid;
  const bool carry_n = blockIdx.y == 0 && tid < kTile && r0 + tid < P;
  const int g = lane >> 2, t4 = lane & 3;
  const bool seeded = p.C0 != nullptr;
  const int ns = entry_states(nch, seeded);

  // the tile's state, as mma accumulators: the initial state's or zeros
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = r0 + n * 8 + 2 * t4, pr = p0 + warp * 16 + g + 8 * h2;
      float2 c0 = make_float2(0.f, 0.f);
      if (seeded && pr < P && r < P)
        c0 = *reinterpret_cast<const float2*>(
            p.C0 + (static_cast<long long>(bh) * P + pr) * P + r);
      acc[n][2 * h2] = c0.x;
      acc[n][2 * h2 + 1] = c0.y;
    }
  float nr = seeded && carry_n
                 ? p.n0[static_cast<long long>(bh) * P + r0 + tid]
                 : 0.f;

  // the tile of the state entering a chunk, hi and lo, through shared
  // memory (the w v tiles, free whenever this is called) as whole 16-byte
  // pieces; n likewise
  auto store_entry = [&](long long slot) {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        unsigned hi, lo;
        split_pack(acc[n][2 * h2], acc[n][2 * h2 + 1], hi, lo);
        const int off = (warp * 16 + g + 8 * h2) * kLD + n * 8 + 2 * t4;
        *reinterpret_cast<unsigned*>(VWh + off) = hi;
        *reinterpret_cast<unsigned*>(VWl + off) = lo;
      }
    __syncthreads();
    bf16* Ch = s.Cprev + slot * 2 * P * P;
#pragma unroll
    for (int i = 0; i < 2 * kTile * 8 / NTH; ++i) {
      const int e = tid + i * NTH, pl = e / (kTile * 8);
      const int r = (e / 8) % kTile, cc = (e % 8) * 8;
      if (p0 + r < P && r0 + cc < P)
        *reinterpret_cast<float4*>(Ch + pl * P * P +
                                   static_cast<long long>(p0 + r) * P + r0 +
                                   cc) =
            *reinterpret_cast<const float4*>((pl ? VWl : VWh) + r * kLD + cc);
    }
    if (carry_n) s.nprev[slot * P + r0 + tid] = nr;
  };
  if (seeded) {  // chunk 0 enters with the initial state
    store_entry(static_cast<long long>(bh) * ns);
    __syncthreads();  // before the first chunk's w v overwrite the tiles
  }

  stage64<QT, NTH>(Vr, v, p.v_ss, min(p.Q, p.S), p0, P, tid);
  stage64<QT, NTH>(Kr, k, p.k_ss, min(p.Q, p.S), r0, P, tid);
  cp_async_commit();
  if (tid < QT) wj[tid] = tid < p.Q ? win[tid] : 0.f;
  float wo = wold[0], nl = carry_n ? nloc[0] : 0.f;
  for (int c = 0; c < nch; ++c) {
    const int t0 = c * p.Q;
    float wo_next = 0.f, nl_next = 0.f;
    if (c + 1 < nch) {
      const int nb = (c + 1) & 1, t1 = t0 + p.Q, len1 = min(p.Q, p.S - t1);
      stage64<QT, NTH>(Vr + nb * QT * kLD, v + t1 * p.v_ss, p.v_ss, len1, p0,
                       P, tid);
      stage64<QT, NTH>(Kr + nb * QT * kLD, k + t1 * p.k_ss, p.k_ss, len1, r0,
                       P, tid);
      cp_async_commit();
      if (tid < QT) wj[nb * QT + tid] = tid < p.Q ? win[t1 + tid] : 0.f;
      wo_next = wold[c + 1];
      if (carry_n) nl_next = nloc[static_cast<long long>(c + 1) * P];
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Vb = Vr + (c & 1) * QT * kLD;
    const bf16* Kb = Kr + (c & 1) * QT * kLD;
    const float* w = wj + (c & 1) * QT;
    for (int e = tid; e < QT * kTile / 2; e += NTH) {
      const int j = e / (kTile / 2), cc = (e % (kTile / 2)) * 2;
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Vb + j * kLD + cc));
      unsigned hi, lo;
      split_pack(w[j] * x.x, w[j] * x.y, hi, lo);
      *reinterpret_cast<unsigned*>(VWh + j * kLD + cc) = hi;
      *reinterpret_cast<unsigned*>(VWl + j * kLD + cc) = lo;
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= wo;
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      unsigned ah[4], al[4];
      lda_t(ah, VWh, kLD, warp * 16, kk * 16, lane);
      lda_t(al, VWl, kLD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        unsigned bk[4];
        ldb_t(bk, Kb, kLD, nn * 16, kk * 16, lane);
        mma16816(acc[2 * nn], ah, bk[0], bk[1]);
        mma16816(acc[2 * nn], al, bk[0], bk[1]);
        mma16816(acc[2 * nn + 1], ah, bk[2], bk[3]);
        mma16816(acc[2 * nn + 1], al, bk[2], bk[3]);
      }
    }
    nr = fmaf(wo, nr, nl);
    __syncthreads();  // the w v tiles are free again
    if (c + 1 < nch)  // the entry state of chunk c + 1
      store_entry(static_cast<long long>(bh) * ns + c + (seeded ? 1 : 0));
    wo = wo_next;
    nl = nl_next;
  }
  if (p.C != nullptr) {
    float* Cout = p.C + static_cast<long long>(bh) * P * P;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int r = r0 + n * 8 + 2 * t4;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int pr = p0 + warp * 16 + g + 8 * h2;
        if (pr < P && r < P)
          *reinterpret_cast<float2*>(Cout + static_cast<long long>(pr) * P +
                                     r) =
              make_float2(acc[n][2 * h2], acc[n][2 * h2 + 1]);
      }
    }
    if (carry_n) p.n[static_cast<long long>(bh) * P + r0 + tid] = nr;
  }
}

// d. h for 64 columns of one chunk of one head: W v and q C_prev^T on
// tensor cores, q . n_prev in fp32, the normaliser. QT / 16 warps.
template <int QT>
__global__ void __launch_bounds__(QT * 2) mlstm_out_kernel(Params p,
                                                           Scratch s) {
  constexpr int NTH = QT * 2, WLD = QT + 8;
  extern __shared__ float4 smem4[];
  bf16* Wh = reinterpret_cast<bf16*>(smem4);  // (QT, WLD)
  bf16* Wl = Wh + QT * WLD;                   // (QT, WLD)
  bf16* Vs = Wl + QT * WLD;                   // (QT, kLD) v columns
  bf16* Qs = Vs + QT * kLD;                   // 2 x (QT, kLD)
  bf16* Ch = Qs + 2 * QT * kLD;               // 2 x (kTile, kLD) C_prev hi
  bf16* Cl = Ch + 2 * kTile * kLD;            // 2 x (kTile, kLD) lo
  float* ns = reinterpret_cast<float*>(Cl + 2 * kTile * kLD);  // 2 x kTile
  float* qn = ns + 2 * kTile;                                   // (QT)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int p0 = blockIdx.x * kTile, c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.H, hh = bh - b * p.H;
  const int P = p.P, nch = (p.S + p.Q - 1) / p.Q, t0 = c * p.Q;
  const int len = min(p.Q, p.S - t0);
  const long long Sp = static_cast<long long>(nch) * p.Q;
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + hh * p.q_sh +
                  t0 * p.q_ss;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hh * p.v_sh +
                  t0 * p.v_ss;
  const bf16* Wg = s.W + (static_cast<long long>(bh) * nch + c) * 2 * QT * QT;

  // W hi, lo and the v columns of the chunk
  for (int e = tid; e < 2 * QT * (QT / 8); e += NTH) {
    const int pl = e / (QT * (QT / 8)), rem = e - pl * QT * (QT / 8);
    const int r = rem / (QT / 8), cc = (rem % (QT / 8)) * 8;
    cp_async16(Wh + pl * QT * WLD + r * WLD + cc, Wg + pl * QT * QT + r * QT + cc,
               true);
  }
  stage64<QT, NTH>(Vs, v, p.v_ss, len, p0, P, tid);
  cp_async_commit();

  const int nk = (P + kTile - 1) / kTile;
  const bf16* Chg = nullptr;
  const float* npg = nullptr;
  auto stage_inter = [&](int kt, int buf) {
    stage64<QT, NTH>(Qs + buf * QT * kLD, q, p.q_ss, len, kt * kTile, P, tid);
    stage64<kTile, NTH>(Ch + buf * kTile * kLD, Chg + static_cast<long long>(p0) * P,
                        P, P - p0, kt * kTile, P, tid);
    stage64<kTile, NTH>(Cl + buf * kTile * kLD,
                        Chg + static_cast<long long>(P) * P + static_cast<long long>(p0) * P,
                        P, P - p0, kt * kTile, P, tid);
    if (tid < kTile / 4) {
      const int e = kt * kTile + tid * 4;
      cp_async16(ns + buf * kTile + tid * 4, npg + (e < P ? e : 0), e < P);
    }
  };
  const bool seeded = p.C0 != nullptr;
  const bool inter = c > 0 || seeded;  // an entry state to read
  if (inter) {
    const long long slot =
        static_cast<long long>(bh) * entry_states(nch, seeded) + c -
        (seeded ? 0 : 1);
    Chg = s.Cprev + slot * 2 * P * P;
    npg = s.nprev + slot * P;
    stage_inter(0, 0);
    cp_async_commit();
    cp_async_wait<1>();
  } else {
    cp_async_wait<0>();
  }
  __syncthreads();

  float ai[8][4], ae[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ai[n][e] = ae[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < QT / 16; ++kk) {
    if (kk > warp) continue;  // W is 0 above the diagonal
    unsigned ah[4], al[4];
    lda(ah, Wh, WLD, warp * 16, kk * 16, lane);
    lda(al, Wl, WLD, warp * 16, kk * 16, lane);
#pragma unroll
    for (int nn = 0; nn < 4; ++nn) {
      unsigned bv[4];
      ldb_t(bv, Vs, kLD, nn * 16, kk * 16, lane);
      mma16816(ai[2 * nn], ah, bv[0], bv[1]);
      mma16816(ai[2 * nn], al, bv[0], bv[1]);
      mma16816(ai[2 * nn + 1], ah, bv[2], bv[3]);
      mma16816(ai[2 * nn + 1], al, bv[2], bv[3]);
    }
  }

  const int row = tid >> 1, half = tid & 1;  // q . n_prev: 2 threads a row
  float qpart = 0.f;
  if (inter) {
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) {
        stage_inter(kt + 1, (kt + 1) & 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* Qb = Qs + (kt & 1) * QT * kLD;
      const bf16* Hb = Ch + (kt & 1) * kTile * kLD;
      const bf16* Lb = Cl + (kt & 1) * kTile * kLD;
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        unsigned a[4];
        lda(a, Qb, kLD, warp * 16, kk * 16, lane);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          unsigned bh4[4], bl4[4];
          ldb(bh4, Hb, kLD, nn * 16, kk * 16, lane);
          ldb(bl4, Lb, kLD, nn * 16, kk * 16, lane);
          mma16816(ae[2 * nn], a, bh4[0], bh4[1]);
          mma16816(ae[2 * nn], a, bl4[0], bl4[1]);
          mma16816(ae[2 * nn + 1], a, bh4[2], bh4[3]);
          mma16816(ae[2 * nn + 1], a, bl4[2], bl4[3]);
        }
      }
      const float* nb = ns + (kt & 1) * kTile + half * 32;
      const bf16* qr = Qb + row * kLD + half * 32;
#pragma unroll 8
      for (int e = 0; e < 32; ++e)
        qpart = fmaf(__bfloat162float(qr[e]), nb[e], qpart);
      __syncthreads();  // before the buffer is staged again
    }
  }
  qpart += __shfl_xor_sync(0xffffffffu, qpart, 1);
  if (half == 0) qn[row] = qpart;
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = warp * 16 + g + 8 * r;
    if (i >= len) continue;
    const long long t = bh * Sp + t0 + i;
    const float be = s.beta[t], mi = s.mrow[t];
    const float rsum =
        s.rowsum[(static_cast<long long>(bh) * nch + c) * QT + i];
    const float den = fmaxf(fabsf(rsum + be * (qn[i] * p.scale)), expf(-mi));
    bf16* hrow = static_cast<bf16*>(p.h) + b * p.h_sb + hh * p.h_sh +
                 (t0 + i) * p.h_ss;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = p0 + n * 8 + 2 * t4;
      if (col < P)
        *reinterpret_cast<unsigned*>(hrow + col) =
            pack_bf16((ai[n][2 * r] + ae[n][2 * r] * p.scale * be) / den,
                      (ai[n][2 * r + 1] + ae[n][2 * r + 1] * p.scale * be) /
                          den);
    }
  }
}

template <typename K>
int opt_in_smem(K kernel, size_t bytes) {
  if (bytes > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// kernels a-d. The shared-memory opt-ins act on the current device, so
// they are set on every call (a cheap host call), not once per process.
template <int QT>
int launch_tensor_core(const Params& p, void* scratch,
                       long long scratch_bytes, cudaStream_t stream) {
  const int BH = p.B * p.H, nch = (p.S + p.Q - 1) / p.Q;
  const int nt = (p.P + kTile - 1) / kTile;
  if (BH > 65535 || nch > 65535 || (p.P & 7) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Scratch s;
  if (carve(&s, static_cast<char*>(scratch), BH, nch, p.Q, QT, p.P,
            p.C0 != nullptr) > static_cast<size_t>(scratch_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t qk_smem = sizeof(bf16) * 4 * QT * kLD + sizeof(float) * 3 * QT;
  const size_t st_smem = sizeof(bf16) * 6 * QT * kLD + sizeof(float) * 2 * QT;
  const size_t out_smem =
      sizeof(bf16) * (2 * QT * (QT + 8) + 3 * QT * kLD + 4 * kTile * kLD) +
      sizeof(float) * (2 * kTile + QT);
  int err = opt_in_smem(mlstm_qk_kernel<QT>, qk_smem);
  if (!err) err = opt_in_smem(mlstm_state_kernel<QT>, st_smem);
  if (!err) err = opt_in_smem(mlstm_out_kernel<QT>, out_smem);
  if (err) return err;
  mlstm_gate_kernel<bf16><<<BH, kGateThreads, 0, stream>>>(p, s);
  mlstm_qk_kernel<QT><<<dim3(nch, BH), QT * 2, qk_smem, stream>>>(p, s);
  mlstm_state_kernel<QT><<<dim3(nt, nt, BH), 128, st_smem, stream>>>(p, s);
  mlstm_out_kernel<QT><<<dim3(nt, nch, BH), QT * 2, out_smem, stream>>>(p, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for q, k, v, both gates and h; the
// state is fp32. path: 0 = the CUDA-core kernel (either dtype), 1 = the
// tensor-core kernels (bf16, P % 8 == 0, q, k, v 16-byte aligned with
// strides in multiples of 8 elements), which need `scratch` of at least
// the wrapper's scratch_bytes(B, S, H, P, Q). q, k, v, the gates and h
// take (batch, seq, head) strides in elements; the last dim of q, k, v and
// h is contiguous. Q is the chunk (1..128), scale the factor on q
// (1/sqrt(P)). C (B,H,P,P), n (B,H,P) and m (B,H) contiguous, or C null
// for no state; C0, n0, m0 the initial state, fp32 and contiguous in the
// same shapes, or C0 null for the zero state. Returns the CUDA error of
// the launch (0 on success).
int mlstm_scan_fwd(int dtype, int path, const void* q, const void* k,
                   const void* v, const void* ig, const void* fg, void* h,
                   void* C, void* n, void* m, const void* C0, const void* n0,
                   const void* m0, void* scratch,
                   long long scratch_bytes, int B, int S, int H, int P, int Q,
                   float scale, long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   long long i_sb, long long i_ss, long long i_sh,
                   long long f_sb, long long f_ss, long long f_sh,
                   long long h_sb, long long h_ss, long long h_sh,
                   void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S <= 0 || P <= 0 || Q <= 0 || Q > 128 ||
      static_cast<long long>(B) * H > 2147483647LL ||
      (P + kPT - 1) / kPT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((C0 == nullptr) != (n0 == nullptr) || (C0 == nullptr) != (m0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, ig, fg, h, static_cast<float*>(C), static_cast<float*>(n),
           static_cast<float*>(m), static_cast<const float*>(C0),
           static_cast<const float*>(n0), static_cast<const float*>(m0),
           B, S, H, P, Q, scale,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           i_sb, i_ss, i_sh, f_sb, f_ss, f_sh, h_sb, h_ss, h_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
    return Q <= 64 ? launch_tensor_core<64>(p, scratch, scratch_bytes, s)
                   : launch_tensor_core<128>(p, scratch, scratch_bytes, s);
  }
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_cuda_core_tile<float>(p, s);
  if (dtype == 1) return launch_cuda_core_tile<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
