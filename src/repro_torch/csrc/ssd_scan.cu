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
// + 4 Q N P operations against Q (2 P + 2 N) elements moved, so at the
// serving shape (Q = 64, P = 64, N = 16) it does some 40 fp32 operations per
// byte: a kernel that reached the bound would be bound by fp32 operations
// (or by tensor-core operations, were the two Q x Q products on them).
//
// Design (simple and correct first; wgmma/TMA and splitting the sequence
// across blocks come in a later change):
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
// With one block per (batch, head), hymba's prefill (B = 1, H = 50) fills
// 50 of the 132 SMs; PERF.md has its time beside the bound.

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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 for x, Bm, Cm and y; dt, A, D and the
// state are fp32. x, dt and y take (batch, seq, head) strides, Bm and Cm
// (batch, seq) strides, in elements; the last dim of each is contiguous.
// state (B, H, P, N) contiguous, or null. Returns the CUDA error of the
// launch (0 on success).
int ssd_scan_fwd(int dtype, const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, const void* D, void* y,
                 void* state, int B, int S, int H, int P, int N, int Q,
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
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
