// Mamba-2 SSD chunk scan for Hopper (sm_90a), CUDA C++ with a plain C
// interface (bound with ctypes by repro_torch/kernels/ssd_scan.py).
//
// Replaces the Pallas TPU kernel `ssd_scan` (src/repro/kernels/ssd_scan.py,
// body `_ssd_kernel`): x (B,S,H,P), dt (B,S,H) fp32 after softplus, A and
// D (H,) fp32, Bm and Cm (B,S,N) shared by the heads -> y (B,S,H,P) in x's
// type, and optionally the final state (B,H,P,N) fp32, which the Pallas
// kernel keeps in VMEM scratch and drops (the port's prefill needs it for
// the decode cache). Per head, chunks of Q steps, cum = cumsum(dt A):
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//         + exp(cum_i) C_i . state                                (inter)
//         + D x_i                                                 (skip)
//   state = exp(cum_Q) state + sum_j exp(cum_Q - cum_j) dt_j B_j (outer) x_j
// Steps past the sequence end get dt = 0 (no padded copies), so a ragged
// last chunk leaves the state as it was.
//
// What bounds it on this card: per head and chunk about 2 Q^2 N + 2 Q^2 P
// + 4 Q N P operations against Q (2 P + 2 N) elements moved. At hymba's
// prefill shape (x (1, 1152, 50, 64) bf16, N 16, Q 64, state out) that is
// 476 MFLOP and 15.2 MB: 0.0071 ms at the fp32 rate of the CUDA cores,
// but 0.0005 ms on bf16 tensor cores, where the 15.2 MB (0.0045 ms) bound
// it. The CUDA-core design below (a block per (head, batch) walking all
// chunks, fp32 FMA chains through shared memory) fills 50 SMs there and
// took 0.53 ms.
//
// Two paths; the wrapper's `plan` picks one and passes it as `path`:
//
// 1. Tensor cores (bf16; P and N multiples of 8, N <= 64; x, Bm, Cm rows
//    16-byte aligned): three launches of one call, the chunkwise-parallel
//    form (`ref.ssd_chunk_parallel` is its plain-PyTorch transcript):
//    a. `ssd_state_kernel`, a block per (chunk, 64 columns p, head): the
//       gates (warp scan of dt A for cum, seg_end, w_j = e^{seg_end -
//       cum_j} dt_j; cum and dt go to scratch for c) and the chunk's own
//       end state S_c^T = x^T (B o w) on `mma.sync.m16n8k16` (bf16 in,
//       fp32 sums), (P, N) fp32 to scratch.
//    b. `ssd_walk_kernel`, four state elements a thread: the only
//       sequential walk, state_c = e^{seg_end_c} state_{c-1} + S_c over
//       the chunks, with the loads of several chunks in flight; each
//       chunk's entry state overwrites its S_c in place (3.7 MB at
//       hymba's shape), and the last state is the final state.
//    c. `ssd_out_kernel`, a block per (chunk, 64 columns p, pair of
//       heads): C B^T on tensor cores once for the pair (N = 16 is one
//       k-step), then per
//       head C . state on tensor cores into the accumulator, scaled by
//       e^{cum_i}, then W x into the same accumulator, W = C B^T o
//       e^{cum_i - cum_j} dt_j (masked before the exponential) built in
//       registers and fed as the A operand without a trip through shared
//       memory; y = that + D x, staged in shared memory for 16-byte
//       stores. The next head's x, cum and dt are copied (cp.async) while
//       this one is computed.
//    Precision: x, B and C arrive in bf16 and enter the products exactly.
//    The three fp32 operands, W, B o w and the entry state, go in as two
//    bf16 halves hi = bf16(v), lo = bf16(v - hi), two products each: on
//    the CPU at hymba's shape one bf16 rounding of any of them puts y at
//    1.45-2.17 times the bf16 tolerance, the halves at 0.37 (the fp32
//    form's own 0.27; tests/test_torch_ssd_parallel.py). Gates and sums
//    are fp32, accurate expf.
// 0. CUDA cores (fp32, and bf16 the tensor-core path does not take): the
//    first design, kept unchanged:
//   * One block of 256 threads per (head, batch) walks the chunks in order,
//     so the state never leaves the block; it lives in shared memory as
//     (N, P) fp32.
//   * Each chunk's x, B and C are staged in shared memory as fp32 (B and C
//     rows padded to N + 1 floats so that a warp reading 32 rows at one n
//     hits 32 banks), dt with 0 past the end.
//   * Warp 0 scans dt A: each lane sums a run of ceil(Q / 32) steps, then a
//     shuffle scan adds the runs before it.
//   * The masked decay weights W[i, j] = (C_i . B_j) exp(cum_i - cum_j) dt_j
//     go to shared memory; the mask selects 0 for j > i before the
//     exponential is taken, whose argument is positive there (the Pallas
//     kernel used jnp.where; inf * 0 would be NaN).
//   * Outputs: a thread per (row, column) of the chunk, consecutive
//     threads on consecutive columns, summing W x, C . state and D x in fp32
//     on CUDA cores; then the state update, a thread per (n, column).
//   * Accurate expf and IEEE arithmetic (no fast math).
//
// Strided x, dt, Bm and Cm (apply_mamba's split projection): only the last
// dim of x, Bm and Cm must be contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 232448;  // opt-in shared memory of a block

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* D;
  void* y;
  float* state;  // (B, H, P, N) or null
  int B, S, H, P, N, Q;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  long long y_sb, y_ss, y_sh;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_floats(int Q, int P, int N) {
  return static_cast<size_t>(Q) * P + 2 * static_cast<size_t>(Q) * (N + 1) +
         static_cast<size_t>(Q) * Q + static_cast<size_t>(N) * P + 4 * Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Params p) {
  extern __shared__ float smem[];
  const int Q = p.Q, P = p.P, N = p.N, NS = N + 1;
  float* xs = smem;           // (Q, P) x of the chunk
  float* bs = xs + Q * P;     // (Q, NS) B of the chunk
  float* cs = bs + Q * NS;    // (Q, NS) C of the chunk
  float* ws = cs + Q * NS;    // (Q, Q) masked decay weights
  float* st = ws + Q * Q;     // (N, P) carried state
  float* dts = st + N * P;    // (Q) dt, 0 past the end
  float* cum = dts + Q;       // (Q) inclusive cumsum of dt A
  float* wj = cum + Q;        // (Q) exp(cum_Q - cum_j) dt_j
  float* ec = wj + Q;         // (Q) exp(cum_i)

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const float a = p.A[h], d = p.D[h];
  const T* x = static_cast<const T*>(p.x) + b * p.x_sb + h * p.x_sh;
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh;
  const T* Bm = static_cast<const T*>(p.Bm) + b * p.b_sb;
  const T* Cm = static_cast<const T*>(p.Cm) + b * p.c_sb;
  T* y = static_cast<T*>(p.y) + b * p.y_sb + h * p.y_sh;

  for (int e = tid; e < N * P; e += kThreads) st[e] = 0.f;

  for (int t0 = 0; t0 < p.S; t0 += Q) {
    const int len = min(Q, p.S - t0);
    for (int e = tid; e < Q * P; e += kThreads) {
      const int i = e / P, c = e - i * P;
      xs[e] = i < len ? to_f(x[(t0 + i) * p.x_ss + c]) : 0.f;
    }
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N, n = e - i * N;
      const bool in = i < len;
      bs[i * NS + n] = in ? to_f(Bm[(t0 + i) * p.b_ss + n]) : 0.f;
      cs[i * NS + n] = in ? to_f(Cm[(t0 + i) * p.c_ss + n]) : 0.f;
    }
    for (int i = tid; i < Q; i += kThreads)
      dts[i] = i < len ? dt[(t0 + i) * p.dt_ss] : 0.f;
    __syncthreads();

    if (tid < 32) {  // inclusive cumsum of dt A
      const int run_len = (Q + 31) / 32;
      const int lo = min(tid * run_len, Q), hi = min(lo + run_len, Q);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) {
        run += dts[i] * a;
        cum[i] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      const float before = incl - run;
      for (int i = lo; i < hi; ++i) cum[i] += before;
    }
    __syncthreads();

    const float seg_end = cum[Q - 1];
    for (int i = tid; i < Q; i += kThreads) {
      wj[i] = expf(seg_end - cum[i]) * dts[i];
      ec[i] = expf(cum[i]);
    }
    for (int e = tid; e < Q * Q; e += kThreads) {
      const int i = e / Q, j = e - i * Q;
      float w = 0.f;
      if (j <= i) {  // masked before the exponential
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(cs[i * NS + n], bs[j * NS + n], cb);
        w = cb * expf(cum[i] - cum[j]) * dts[j];
      }
      ws[e] = w;
    }
    __syncthreads();

    for (int e = tid; e < len * P; e += kThreads) {
      const int i = e / P, c = e - i * P;
      float intra = 0.f;
      for (int j = 0; j <= i; ++j) intra = fmaf(ws[i * Q + j], xs[j * P + c], intra);
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(cs[i * NS + n], st[n * P + c], inter);
      store(y + (t0 + i) * p.y_ss + c, intra + inter * ec[i] + xs[e] * d);
    }
    __syncthreads();  // every output has read the state before it moves

    const float decay = expf(seg_end);
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, c = e - n * P;
      float upd = 0.f;
      for (int j = 0; j < len; ++j)
        upd = fmaf(wj[j] * bs[j * NS + n], xs[j * P + c], upd);
      st[e] = decay * st[e] + upd;
    }
    __syncthreads();
  }

  if (p.state != nullptr) {  // (N, P) in shared memory -> (P, N) per head
    float* out = p.state + (static_cast<long long>(b) * p.H + h) * P * N;
    for (int e = tid; e < N * P; e += kThreads) {
      const int c = e / N, n = e - c * N;
      out[e] = st[n * P + c];
    }
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_floats(p.Q, p.P, p.N) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmemBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(p.H, p.B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Path 1: tensor cores (bf16; P % 8 == 0; N % 8 == 0, N <= 64; 16-byte
// aligned rows of x, Bm and Cm)
// ---------------------------------------------------------------------------
typedef __nv_bfloat16 bf16;

constexpr int kPTile = 64;          // columns p of a block
constexpr int kLDX = kPTile + 8;    // row stride of an x tile in bf16: 8
                                    // ldmatrix rows land on distinct banks
constexpr int kStateThreads = 128;  // ssd_state_kernel: 4 warps x 16 rows p
constexpr int kWalkThreads = 128;
constexpr int kWalkAhead = 6;       // chunks whose loads the walk has in flight
constexpr int kHeads = 2;           // ssd_out_kernel: heads per block (one
                                    // C B^T for both; a sweep on the card
                                    // timed 1, 2 and 5, PERF.md)

// Scratch of the tensor-core path, carved from the wrapper's buffer in this
// order (each array rounded up to 256 bytes; kernels/ssd_scan.py
// `scratch_bytes` mirrors it). nch chunks, QT the chunk tile.
struct Scratch {
  float* cum;  // (BH, nch, QT) in-chunk cumsum of dt A
  float* dtz;  // (BH, nch, QT) dt, 0 past the end
  float* seg;  // (BH, nch) cum at the chunk's last step
  float* st;   // (BH, nch, P, N) S_c, then the entry state of chunk c
};

size_t carve(Scratch* s, char* base, int BH, int nch, int QT, int P, int N) {
  const long long sizes[4] = {4LL * BH * nch * QT, 4LL * BH * nch * QT,
                              4LL * BH * nch, 4LL * BH * nch * P * N};
  float** slots[4] = {&s->cum, &s->dtz, &s->seg, &s->st};
  size_t off = 0;
  for (int i = 0; i < 4; ++i) {
    *slots[i] = reinterpret_cast<float*>(base + off);
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

// Stage rows [0, ROWS) x columns [c0, c0 + COLS) of `src` (row stride ld
// elements) into shared rows of `lds` elements, NTH threads sharing the
// 16-byte copies; rows at or past n and columns at or past ncol are
// zero-filled.
template <int ROWS, int COLS, int NTH>
__device__ __forceinline__ void stage(bf16* dst, int lds, const bf16* src,
                                      long long ld, int n, int c0, int ncol,
                                      int tid) {
  constexpr int CH = COLS / 8;
#pragma unroll
  for (int i = 0; i < (ROWS * CH + NTH - 1) / NTH; ++i) {
    const int idx = tid + i * NTH;
    if (ROWS * CH % NTH != 0 && idx >= ROWS * CH) break;
    const int r = idx / CH, c = (idx % CH) * 8;
    const bool ok = r < n && c0 + c < ncol;
    cp_async16(dst + r * lds + c, ok ? src + r * ld + c0 + c : src, ok);
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

// a. Gates and the chunk's own end state S_c (P, N) of one (chunk, 64
// columns p, head): S_c^T[p][n] = sum_j x[j][p] (B[j][n] w_j), 4 warps of
// 16 rows p, B o w as hi/lo bf16. NK = N rounded up to 16, over 16.
template <int QT, int NK>
__global__ void __launch_bounds__(kStateThreads)
    ssd_state_kernel(Params p, Scratch s) {
  constexpr int NTH = kStateThreads, NP = NK * 16, LDN = NP + 8;
  extern __shared__ float4 smem4[];
  bf16* Xs = reinterpret_cast<bf16*>(smem4);  // (QT, kLDX) x
  bf16* Bs = Xs + QT * kLDX;                  // (QT, LDN) B
  bf16* BWh = Bs + QT * LDN;                  // (QT, LDN) B o w, hi
  bf16* BWl = BWh + QT * LDN;                 //   lo
  float* dts = reinterpret_cast<float*>(BWl + QT * LDN);  // (QT) dt
  float* cum = dts + QT;                                   // (QT) cumsum
  float* wj = cum + QT;                                    // (QT) w_j
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = blockIdx.x, pt = blockIdx.y, bh = blockIdx.z;
  const int b = bh / p.H, h = bh - b * p.H;
  const int nch = (p.S + p.Q - 1) / p.Q, t0 = c * p.Q;
  const int len = min(p.Q, p.S - t0);
  const bf16* x = static_cast<const bf16*>(p.x) + b * p.x_sb + h * p.x_sh +
                  t0 * p.x_ss;
  const bf16* Bm = static_cast<const bf16*>(p.Bm) + b * p.b_sb + t0 * p.b_ss;

  stage<QT, kPTile, NTH>(Xs, kLDX, x, p.x_ss, len, pt * kPTile, p.P, tid);
  stage<QT, NP, NTH>(Bs, LDN, Bm, p.b_ss, len, 0, p.N, tid);
  cp_async_commit();
  const float a = p.A[h];
  const float* dt = p.dt + b * p.dt_sb + h * p.dt_sh + t0 * p.dt_ss;
  for (int i = tid; i < QT; i += NTH) dts[i] = i < len ? dt[i * p.dt_ss] : 0.f;
  __syncthreads();
  if (warp == 0) {  // inclusive cumsum of dt A: a run per lane, then a scan
    constexpr int RL = QT / 32;
    float run = 0.f;
#pragma unroll
    for (int i = lane * RL; i < lane * RL + RL; ++i) {
      run += dts[i] * a;
      cum[i] = run;
    }
    const float before = warp_incl_sum(run, lane) - run;
#pragma unroll
    for (int i = lane * RL; i < lane * RL + RL; ++i) cum[i] += before;
  }
  __syncthreads();
  const float seg_end = cum[QT - 1];  // dt = 0 past the end: cum is flat
  for (int i = tid; i < QT; i += NTH) wj[i] = expf(seg_end - cum[i]) * dts[i];
  if (pt == 0) {
    const long long g = (static_cast<long long>(bh) * nch + c) * QT;
    for (int i = tid; i < QT; i += NTH) {
      s.cum[g + i] = cum[i];
      s.dtz[g + i] = dts[i];
    }
    if (tid == 0) s.seg[static_cast<long long>(bh) * nch + c] = seg_end;
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int e = tid; e < QT * NP / 2; e += NTH) {
    const int j = e / (NP / 2), n = (e % (NP / 2)) * 2;
    const float2 v = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(Bs + j * LDN + n));
    unsigned hi, lo;
    split_pack(v.x * wj[j], v.y * wj[j], hi, lo);
    *reinterpret_cast<unsigned*>(BWh + j * LDN + n) = hi;
    *reinterpret_cast<unsigned*>(BWl + j * LDN + n) = lo;
  }
  __syncthreads();

  float acc[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < QT / 16; ++kk) {
    if (kk * 16 >= len) break;  // rows past the end are 0
    unsigned ax[4];
    lda_t(ax, Xs, kLDX, warp * 16, kk * 16, lane);
#pragma unroll
    for (int nn = 0; nn < NK; ++nn) {
      unsigned bh4[4], bl4[4];
      ldb_t(bh4, BWh, LDN, nn * 16, kk * 16, lane);
      ldb_t(bl4, BWl, LDN, nn * 16, kk * 16, lane);
      mma16816(acc[2 * nn], ax, bh4[0], bh4[1]);
      mma16816(acc[2 * nn], ax, bl4[0], bl4[1]);
      mma16816(acc[2 * nn + 1], ax, bh4[2], bh4[3]);
      mma16816(acc[2 * nn + 1], ax, bl4[2], bl4[3]);
    }
  }
  const int g = lane >> 2, t4 = lane & 3;
  float* out = s.st + (static_cast<long long>(bh) * nch + c) * p.P * p.N;
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n) {
    const int col = n * 8 + 2 * t4;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = pt * kPTile + warp * 16 + g + 8 * h2;
      if (row < p.P && col < p.N)
        *reinterpret_cast<float2*>(out + static_cast<long long>(row) * p.N +
                                   col) =
            make_float2(acc[n][2 * h2], acc[n][2 * h2 + 1]);
    }
  }
}

// b. The walk over the chunks of one head, four state elements a thread:
// S_c is replaced by the entry state of chunk c (the state after chunks
// 0 .. c-1), the last state goes to p.state.
__global__ void __launch_bounds__(kWalkThreads)
    ssd_walk_kernel(Params p, Scratch s) {
  const int PN = p.P * p.N;
  const int e = (blockIdx.x * kWalkThreads + threadIdx.x) * 4;
  if (e >= PN) return;
  const int bh = blockIdx.y, nch = (p.S + p.Q - 1) / p.Q;
  float* base = s.st + static_cast<long long>(bh) * nch * PN + e;
  const float* seg = s.seg + static_cast<long long>(bh) * nch;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nch; c0 += kWalkAhead) {
    float4 v[kWalkAhead];
    float d[kWalkAhead];
#pragma unroll
    for (int u = 0; u < kWalkAhead; ++u)
      if (c0 + u < nch) {
        v[u] = *reinterpret_cast<const float4*>(
            base + static_cast<long long>(c0 + u) * PN);
        d[u] = seg[c0 + u];
      }
#pragma unroll
    for (int u = 0; u < kWalkAhead; ++u)
      if (c0 + u < nch) {
        *reinterpret_cast<float4*>(base + static_cast<long long>(c0 + u) *
                                              PN) = st;
        const float dk = expf(d[u]);
        st = make_float4(dk * st.x + v[u].x, dk * st.y + v[u].y,
                         dk * st.z + v[u].z, dk * st.w + v[u].w);
      }
  }
  if (p.state != nullptr)
    *reinterpret_cast<float4*>(p.state + static_cast<long long>(bh) * PN +
                               e) = st;
}

// c. y for one chunk, 64 columns p and a pair of heads; QT / 16
// warps of 16 rows i. C B^T is computed once for the group and kept in
// registers; per head W (hi/lo bf16 A fragments straight from those
// registers) times x, and C times the entry state (hi/lo), on tensor cores.
template <int QT, int NK>
__global__ void __launch_bounds__(QT * 2)
    ssd_out_kernel(Params p, Scratch s) {
  constexpr int NTH = QT * 2, NP = NK * 16, LDN = NP + 8, NT = QT / 8;
  extern __shared__ float4 smem4[];
  bf16* Bs = reinterpret_cast<bf16*>(smem4);  // (QT, LDN) B
  bf16* Cs = Bs + QT * LDN;                   // (QT, LDN) C
  bf16* Xs = Cs + QT * LDN;                   // 2 x (QT, kLDX) x
  bf16* Ys = Xs + 2 * QT * kLDX;              // (QT, kLDX) y, for the stores
  bf16* STh = Ys + QT * kLDX;                 // (kPTile, LDN) entry state hi
  bf16* STl = STh + kPTile * LDN;             //   lo
  float* gates = reinterpret_cast<float*>(STl + kPTile * LDN);  // 2 x 2 x QT
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ptiles = (p.P + kPTile - 1) / kPTile;
  const int c = blockIdx.x, pt = blockIdx.y % ptiles;
  const int h0 = (blockIdx.y / ptiles) * kHeads, h1 = min(h0 + kHeads, p.H);
  const int b = blockIdx.z, p0 = pt * kPTile;
  const int nch = (p.S + p.Q - 1) / p.Q, t0 = c * p.Q;
  const int len = min(p.Q, p.S - t0);
  const int g = lane >> 2, t4 = lane & 3;
  const int i0 = warp * 16 + g, i1 = i0 + 8;  // this thread's rows

  auto stage_head = [&](int h, int buf) {
    const bf16* x = static_cast<const bf16*>(p.x) + b * p.x_sb +
                    h * p.x_sh + t0 * p.x_ss;
    stage<QT, kPTile, NTH>(Xs + buf * QT * kLDX, kLDX, x, p.x_ss, len, p0,
                           p.P, tid);
    const long long gi =
        ((static_cast<long long>(b) * p.H + h) * nch + c) * QT;
    float* gs = gates + buf * 2 * QT;
    for (int i = tid; i < QT / 2; i += NTH) {  // cum then dt, 4 floats a copy
      const int k = i % (QT / 4);
      const float* src = (i < QT / 4 ? s.cum : s.dtz) + gi + 4 * k;
      cp_async16(gs + (i < QT / 4 ? 0 : QT) + 4 * k, src, true);
    }
  };
  stage<QT, NP, NTH>(Bs, LDN,
                     static_cast<const bf16*>(p.Bm) + b * p.b_sb +
                         t0 * p.b_ss,
                     p.b_ss, len, 0, p.N, tid);
  stage<QT, NP, NTH>(Cs, LDN,
                     static_cast<const bf16*>(p.Cm) + b * p.c_sb +
                         t0 * p.c_ss,
                     p.c_ss, len, 0, p.N, tid);
  stage_head(h0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // C B^T for this warp's 16 rows, the n-tiles on or below the diagonal
  float cb[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    unsigned ac[4];
    lda(ac, Cs, LDN, warp * 16, kk * 16, lane);
#pragma unroll
    for (int nn = 0; nn < NT / 2; ++nn) {
      if (nn > warp) continue;  // above the diagonal: masked anyway
      unsigned bb[4];
      ldb(bb, Bs, LDN, nn * 16, kk * 16, lane);
      mma16816(cb[2 * nn], ac, bb[0], bb[1]);
      mma16816(cb[2 * nn + 1], ac, bb[2], bb[3]);
    }
  }

  for (int h = h0; h < h1; ++h) {
    const int buf = (h - h0) & 1;
    if (h + 1 < h1) {
      stage_head(h + 1, buf ^ 1);
      cp_async_commit();
    }
    const long long bh = static_cast<long long>(b) * p.H + h;
    if (c > 0) {  // the entry state, (P, N) fp32 -> hi/lo bf16 [p][n]
      const float* st = s.st + (bh * nch + c) * p.P * p.N;
      for (int e = tid; e < kPTile * NP / 4; e += NTH) {
        const int r = e / (NP / 4), n = (e % (NP / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (p0 + r < p.P && n < p.N)
          v = *reinterpret_cast<const float4*>(
              st + static_cast<long long>(p0 + r) * p.N + n);
        unsigned hi0, lo0, hi1, lo1;
        split_pack(v.x, v.y, hi0, lo0);
        split_pack(v.z, v.w, hi1, lo1);
        *reinterpret_cast<uint2*>(STh + r * LDN + n) = make_uint2(hi0, hi1);
        *reinterpret_cast<uint2*>(STl + r * LDN + n) = make_uint2(lo0, lo1);
      }
    }
    if (h + 1 < h1)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
    __syncthreads();
    const bf16* Xb = Xs + buf * QT * kLDX;
    const float* cum = gates + buf * 2 * QT;
    const float* dts = cum + QT;
    const float ci0 = cum[i0], ci1 = cum[i1];

    // e^{cum_i} C . state_{c-1} first, scaled in the accumulator ...
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    if (c > 0) {
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        unsigned ac[4];
        lda(ac, Cs, LDN, warp * 16, kk * 16, lane);
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) {
          unsigned sh[4], sl[4];
          ldb(sh, STh, LDN, nn * 16, kk * 16, lane);
          ldb(sl, STl, LDN, nn * 16, kk * 16, lane);
          mma16816(acc[2 * nn], ac, sh[0], sh[1]);
          mma16816(acc[2 * nn], ac, sl[0], sl[1]);
          mma16816(acc[2 * nn + 1], ac, sh[2], sh[3]);
          mma16816(acc[2 * nn + 1], ac, sl[2], sl[3]);
        }
      }
      const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][0] *= e0;
        acc[n][1] *= e0;
        acc[n][2] *= e1;
        acc[n][3] *= e1;
      }
    }
    // ... then + W x, W_ij = CB_ij e^{cum_i - cum_j} dt_j (j <= i)
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      if (kk > warp) continue;  // W is 0 above the diagonal
      float w[2][4];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = (2 * kk + q) * 8 + 2 * t4 + e;
          const float dj = dts[j], cj = cum[j];
          // selected before the exponential, whose argument is > 0 above
          w[q][e] = j <= i0 ? cb[2 * kk + q][e] * expf(ci0 - cj) * dj : 0.f;
          w[q][2 + e] =
              j <= i1 ? cb[2 * kk + q][2 + e] * expf(ci1 - cj) * dj : 0.f;
        }
      unsigned ah[4], al[4];
      split_pack(w[0][0], w[0][1], ah[0], al[0]);  // row i0, k 2t4
      split_pack(w[0][2], w[0][3], ah[1], al[1]);  // row i1, k 2t4
      split_pack(w[1][0], w[1][1], ah[2], al[2]);  // row i0, k 8 + 2t4
      split_pack(w[1][2], w[1][3], ah[3], al[3]);  // row i1, k 8 + 2t4
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        unsigned bx[4];
        ldb_t(bx, Xb, kLDX, nn * 16, kk * 16, lane);
        mma16816(acc[2 * nn], ah, bx[0], bx[1]);
        mma16816(acc[2 * nn], al, bx[0], bx[1]);
        mma16816(acc[2 * nn + 1], ah, bx[2], bx[3]);
        mma16816(acc[2 * nn + 1], al, bx[2], bx[3]);
      }
    }
    // y = W x + e^{cum_i} C . state + D x, through shared memory
    const float d = p.D[h];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + 2 * t4;
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int i = h2 ? i1 : i0;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(Xb + i * kLDX + col));
        *reinterpret_cast<unsigned*>(Ys + i * kLDX + col) =
            pack_bf16(acc[n][2 * h2] + d * xv.x,
                      acc[n][2 * h2 + 1] + d * xv.y);
      }
    }
    __syncwarp();
    bf16* y = static_cast<bf16*>(p.y) + b * p.y_sb + h * p.y_sh +
              t0 * p.y_ss;
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // the warp's 16 rows, 16 bytes a lane
      const int idx = lane + 32 * k;
      const int r = warp * 16 + (idx >> 3), cc = (idx & 7) * 8;
      if (r < len && p0 + cc < p.P)
        *reinterpret_cast<float4*>(y + static_cast<long long>(r) * p.y_ss +
                                   p0 + cc) =
            *reinterpret_cast<const float4*>(Ys + r * kLDX + cc);
    }
    __syncthreads();  // before the state and the x buffer are staged again
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

// kernels a-c. The shared-memory opt-ins act on the current device, so
// they are set on every call (a cheap host call), not once per process.
template <int QT, int NK>
int launch_tensor_core(const Params& p, void* scratch,
                       long long scratch_bytes, cudaStream_t stream) {
  constexpr int LDN = NK * 16 + 8;
  const int BH = p.B * p.H, nch = (p.S + p.Q - 1) / p.Q;
  const int ptiles = (p.P + kPTile - 1) / kPTile;
  const int groups = (p.H + kHeads - 1) / kHeads;
  if (BH > 65535 || p.B > 65535 || static_cast<long long>(ptiles) * groups >
                                       65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Scratch s;
  if (carve(&s, static_cast<char*>(scratch), BH, nch, QT, p.P, p.N) >
      static_cast<size_t>(scratch_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t st_smem =
      sizeof(bf16) * (QT * kLDX + 3 * QT * LDN) + sizeof(float) * 3 * QT;
  const size_t out_smem =
      sizeof(bf16) * (2 * QT * LDN + 3 * QT * kLDX + 2 * kPTile * LDN) +
      sizeof(float) * 4 * QT;
  int err = opt_in_smem(ssd_state_kernel<QT, NK>, st_smem);
  if (!err) err = opt_in_smem(ssd_out_kernel<QT, NK>, out_smem);
  if (err) return err;
  ssd_state_kernel<QT, NK><<<dim3(nch, ptiles, BH), kStateThreads, st_smem,
                             stream>>>(p, s);
  const int walk_blocks =
      (p.P * p.N / 4 + kWalkThreads - 1) / kWalkThreads;
  ssd_walk_kernel<<<dim3(walk_blocks, BH), kWalkThreads, 0, stream>>>(p, s);
  ssd_out_kernel<QT, NK><<<dim3(nch, ptiles * groups, p.B), QT * 2, out_smem,
                           stream>>>(p, s);
  return static_cast<int>(cudaGetLastError());
}

template <int QT>
int launch_tensor_core_n(const Params& p, void* scratch,
                         long long scratch_bytes, cudaStream_t stream) {
  switch ((p.N + 15) / 16) {
    case 1: return launch_tensor_core<QT, 1>(p, scratch, scratch_bytes,
                                                 stream);
    case 2: return launch_tensor_core<QT, 2>(p, scratch, scratch_bytes,
                                                 stream);
    case 3: return launch_tensor_core<QT, 3>(p, scratch, scratch_bytes,
                                                 stream);
    case 4: return launch_tensor_core<QT, 4>(p, scratch, scratch_bytes,
                                                 stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for x, Bm, Cm and y; dt, A, D and the
// state are fp32. path: 0 = the CUDA-core kernel (either dtype), 1 = the
// tensor-core kernels (bf16; P % 8 == 0; N % 8 == 0, N <= 64; x, Bm, Cm
// 16-byte aligned with strides in multiples of 8 elements; y contiguous),
// which need `scratch` of at least the wrapper's scratch_bytes(B, S, H, P,
// N, Q). x, dt and y take (batch, seq, head) strides, Bm and Cm (batch,
// seq) strides, in elements; the last dim of each is contiguous. state
// (B, H, P, N) contiguous, or null.
// Returns the CUDA error of the launch (0 on success).
int ssd_scan_fwd(int dtype, int path, const void* x, const void* dt,
                 const void* A, const void* Bm, const void* Cm, const void* D,
                 void* y, void* state, void* scratch, long long scratch_bytes,
                 int B, int S, int H, int P, int N, int Q,
                 long long x_sb, long long x_ss, long long x_sh,
                 long long dt_sb, long long dt_ss, long long dt_sh,
                 long long b_sb, long long b_ss, long long c_sb,
                 long long c_ss, long long y_sb, long long y_ss,
                 long long y_sh, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (S <= 0 || P <= 0 || N <= 0 || Q <= 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{x,  static_cast<const float*>(dt), static_cast<const float*>(A),
           Bm, Cm, static_cast<const float*>(D), y,
           static_cast<float*>(state), B, S, H, P, N, Q,
           x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss,
           y_sb, y_ss, y_sh};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    if (dtype != 1 || Q > 128 || (P & 7) != 0 || (N & 7) != 0 || N > 64)
      return static_cast<int>(cudaErrorInvalidValue);
    return Q <= 64
               ? launch_tensor_core_n<64>(p, scratch, scratch_bytes, s)
               : launch_tensor_core_n<128>(p, scratch, scratch_bytes, s);
  }
  if (path != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
