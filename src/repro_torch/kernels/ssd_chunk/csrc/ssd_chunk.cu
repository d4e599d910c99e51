// Mamba-2 SSD chunked scan on Hopper: one CUDA kernel with a plain C
// interface (built with nvcc into a shared library, bound with ctypes from
// repro_torch/kernels/ssd_chunk/kernel.py).
//
//   ssd_chunk   replaces repro/kernels/ssd_chunk/kernel.py:
//               ssd_chunk_pallas (_kernel); what it computes is
//               repro/kernels/ssd_chunk/ref.py:ssd_chunked_ref at the
//               chunk length Q it is given: per chunk, with cum the
//               inclusive cumsum of dt * A over the chunk,
//                 W[i, j] = (C_i . B_j) * exp(min(cum_i - cum_j, 0)) * dt_j
//                           for j <= i, else 0,
//                 y_i     = sum_j W[i, j] x_j + exp(cum_i) * (C_i . S),
//                 S       = exp(cum_Q) * S + sum_j (x_j * w_j) (x) B_j,
//                           w_j = exp(cum_Q - cum_j) * dt_j,
//               all in f32 on the CUDA cores (no TF32).  Head h reads B/C
//               group h / (H / G), so G > 1 runs here too (the reference
//               falls back to jnp there).
//
// What bounds it on the H100: operations.  Per chunk of Q rows, the causal
// C.B^T costs Q (Q + 1) / 2 N multiply-adds a group, the intra-chunk
// product Q (Q + 1) / 2 P and the state's read and update 2 Q P N a head;
// at mamba2-370m's widths (H 32, P 64, N 128, Q 128) that is 85 M
// multiply-adds a chunk against 2.2 MB of inputs and outputs, far above
// the f32 line (67 TFLOP/s over 3.35 TB/s is 20 FLOP a byte).
//
// Design:
//
// * The sequential chunk axis.  The Pallas grid walks the chunks of a
//   sequence in order and carries the whole (H, P, N) state in VMEM (1 MiB
//   at mamba2's widths, more than a block's 227 KB).  Heads are
//   independent, and so are the state's P rows, so a block owns one
//   (sequence, head, tile of PT = 16 state rows) and loops over the chunks
//   itself, keeping its (PT, N) slice of the state in registers (mirrored
//   in shared memory for the output term).  At B = 1 that is 128 blocks
//   for mamba2 and 200 for hymba (H 50), about one wave of the 132 SMs,
//   where a block per sequence would use one SM.  The three-pass SSD form
//   (chunk states in parallel, a scan across chunks, then the outputs)
//   would spread further at the price of a (T / Q, H, P, N) f32 scratch
//   (268 MB at T = 32,768) and two more launches; the loop keeps the state
//   on chip and is the simpler kernel.
// * C.B^T is shared by the heads of a group.  Each block recomputes it for
//   its chunk from the B and C tiles it stages anyway (a 16 x 16 thread
//   grid, 8 x 8 strided outputs a thread, the tiles above the diagonal
//   skipped at compile time), so four P-tiles of a head and all heads
//   repeat the same Q^2 N / 2 products: the price of having no second
//   pass or scratch.  PERF.md counts the work once in the bound.
// * Any chunk length 1..128 (the model passes min(ssm_chunk, max(8, T)),
//   e.g. 10 or 100): the tiles are padded to a multiple of 16 rows with
//   zeros in shared memory and the kernel runs at the Q it is given, since
//   the rounding depends on it.  T must be a multiple of Q: the wrapper pads
//   with dt = 0 rows, which leave the state untouched (decay 1, weight 0).
// * Latency.  One block of 8 warps an SM leaves little to hide a load's
//   latency behind, so x, B and C arrive in 16-byte loads, and every loop
//   issues the shared-memory loads of 2 to 4 steps before their products
//   and runs to the padded length without per-element predicates (rows
//   and columns past Q hold zeros).
// * Shared memory, in floats: C and B tiles QP x (N + 1), W QP x (QP + 1)
//   (rows padded by one against bank conflicts), x and x * w QP x PT, the
//   state PT x (N + 1), and dt, cum, w, exp(cum) QP each: 224,832 bytes
//   at Q 128, N 128, PT 16, one block an SM (dynamic, opted in).
//
// Instances: P a multiple of 16 (PT 16) or P = 8 (PT 8); N a multiple of
// 4 dividing 256, up to 128; 1 <= Q <= 128; G dividing H.  The entry point launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQMax = 128;
constexpr int kNMax = 128;

__host__ __device__ inline int round16(int q) { return (q + 15) & ~15; }

__host__ __device__ inline size_t smem_floats(int QP, int N, int PT) {
  return 2 * (size_t)QP * (N + 1)     // C, B
         + (size_t)QP * (QP + 1)      // W
         + 2 * (size_t)QP * PT        // x, x * w
         + (size_t)PT * (N + 1)       // state
         + 4 * (size_t)QP;            // dt, cum, w, exp(cum)
}

template <int PT>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm,
                     const float* __restrict__ s0, float* __restrict__ y,
                     float* __restrict__ fs, int T, int H, int P, int G, int N,
                     int Q) {
  constexpr int kE = PT * kNMax / kThreads;   // state rows a thread
  constexpr int kR = PT * kQMax / kThreads;   // output rows a thread
  constexpr int RG = kThreads / PT;           // output row groups
  extern __shared__ float sm[];
  const int QP = round16(Q);
  const int NS = N + 1, WS = QP + 1;
  float* C_s = sm;
  float* B_s = C_s + QP * NS;
  float* W_s = B_s + QP * NS;
  float* x_s = W_s + QP * WS;
  float* xw_s = x_s + QP * PT;
  float* S_s = xw_s + QP * PT;
  float* dt_s = S_s + PT * NS;
  float* cum_s = dt_s + QP;
  float* w_s = cum_s + QP;
  float* ec_s = w_s + QP;

  const int n_pt = P / PT;
  const int h = blockIdx.x / n_pt, p0 = (blockIdx.x % n_pt) * PT;
  const int b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x;
  const float a_h = A[h];
  const int n_chunks = T / Q;

  // this thread's state elements: column n, rows pg + NG * k
  const int NG = kThreads / N;
  const int sn = tid % N, pg = tid / N;
  const size_t s_base = ((size_t)b * H + h) * P + p0;
  float sreg[kE];
#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const int p = pg + NG * k;
    sreg[k] = p < PT ? s0[(s_base + p) * N + sn] : 0.f;
    if (p < PT) S_s[p * NS + sn] = sreg[k];
  }

  // 16-byte loads of x, B and C when every base is aligned (rows are: N
  // and PT are multiples of 4)
  const bool vec =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
        reinterpret_cast<uintptr_t>(Cm)) & 15) == 0;
  // this thread's output rows r0 + RG k below QP (rows past Q hold zeros
  // in W and C, so they are computed and not stored)
  const int r0 = tid / PT, nk = (QP - r0 + RG - 1) / RG;

  for (int c = 0; c < n_chunks; ++c) {
    const size_t t0 = (size_t)b * T + (size_t)c * Q;   // row in (B * T)

    // 1. stage B, C, x and dt of the chunk, zero rows past Q
    if (vec) {
      const int n4 = N / 4, p4 = PT / 4;
#pragma unroll 4
      for (int i = tid; i < QP * n4; i += kThreads) {
        const int r = i / n4, n = (i % n4) * 4;
        float4 bv = make_float4(0.f, 0.f, 0.f, 0.f), cv = bv;
        if (r < Q) {
          const size_t off = ((t0 + r) * G + g) * N + n;
          bv = *reinterpret_cast<const float4*>(Bm + off);
          cv = *reinterpret_cast<const float4*>(Cm + off);
        }
        float* bd = B_s + r * NS + n;
        float* cd = C_s + r * NS + n;
        bd[0] = bv.x, bd[1] = bv.y, bd[2] = bv.z, bd[3] = bv.w;
        cd[0] = cv.x, cd[1] = cv.y, cd[2] = cv.z, cd[3] = cv.w;
      }
#pragma unroll 2
      for (int i = tid; i < QP * p4; i += kThreads) {
        const int r = i / p4, q = (i % p4) * 4;
        float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < Q)
          xv = *reinterpret_cast<const float4*>(
              x + ((t0 + r) * H + h) * P + p0 + q);
        float* xd = x_s + r * PT + q;
        xd[0] = xv.x, xd[1] = xv.y, xd[2] = xv.z, xd[3] = xv.w;
      }
    } else {
      for (int i = tid; i < QP * N; i += kThreads) {
        const int r = i / N, n = i % N;
        const size_t off = ((t0 + r) * G + g) * N + n;
        B_s[r * NS + n] = r < Q ? Bm[off] : 0.f;
        C_s[r * NS + n] = r < Q ? Cm[off] : 0.f;
      }
      for (int i = tid; i < QP * PT; i += kThreads) {
        const int r = i / PT, q = i % PT;
        x_s[i] = r < Q ? x[((t0 + r) * H + h) * P + p0 + q] : 0.f;
      }
    }
    for (int i = tid; i < QP; i += kThreads)
      dt_s[i] = i < Q ? dt[(t0 + i) * H + h] : 0.f;
    __syncthreads();

    // 2. inclusive cumsum of dt * A by warp 0: the f32 products (not
    //    fused) summed in f64, each prefix rounded once to f32, as the
    //    plain version computes it.  The decays are exponentials of
    //    differences of these prefixes, which reach |cum| ~ 2,000 at the
    //    model's ranges, where one f32 step is 1.2e-4: an f32 running sum
    //    would carry a few such steps into every decay, while f64 sums of
    //    at most 128 such products round to the same f32 prefixes in any
    //    order.  The other warps start on C.B^T meanwhile.
    if (tid < 32) {
      double carry = 0.0;
      for (int base = 0; base < QP; base += 32) {
        const int i = base + tid;
        double v = i < Q ? (double)__fmul_rn(dt_s[i], a_h) : 0.0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, off);
          if (tid >= off) v += u;
        }
        v += carry;
        if (i < QP) cum_s[i] = __double2float_rn(v);
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }

    // 3. C.B^T, then the per-row weights and W = (C.B^T) * decay * dt
    //    under the mask
    {
      const int ti = tid / 16, tj = tid % 16, na = QP / 16;
      float acc[8][8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[a][q] = 0.f;
      // two columns of N at a time, their loads issued before the products
      for (int n = 0; n < N; n += 2) {
        float cv[2][8], bv[2][8];
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            cv[u][a] = a < na ? C_s[(ti + 16 * a) * NS + n + u] : 0.f;
            bv[u][a] = a < na ? B_s[(tj + 16 * a) * NS + n + u] : 0.f;
          }
        // rows ti + 16 a, columns tj + 16 q: q > a lies above the diagonal
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int q = 0; q <= a; ++q)
              acc[a][q] = fmaf(cv[u][a], bv[u][q], acc[a][q]);
      }
      __syncthreads();   // the cumsum is in place
      for (int i = tid; i < QP; i += kThreads) {
        w_s[i] = i < Q ? expf(cum_s[Q - 1] - cum_s[i]) * dt_s[i] : 0.f;
        ec_s[i] = expf(cum_s[i]);
      }
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int i = ti + 16 * a, j = tj + 16 * q;
          if (a < na && q < na) {
            float wv = 0.f;
            if (j <= i && i < Q)
              wv = acc[a][q] * expf(fminf(cum_s[i] - cum_s[j], 0.f)) * dt_s[j];
            W_s[i * WS + j] = wv;
          }
        }
    }
    __syncthreads();

    // 4. x * w for the update, and the outputs
    //    y_i = sum_j W[i, j] x_j + exp(cum_i) * (C_i . S)
    //    over all QP columns (W is zero above the diagonal and past Q),
    //    four at a time with their loads issued first
    for (int i = tid; i < QP * PT; i += kThreads) xw_s[i] = x_s[i] * w_s[i / PT];
    {
      const int p = tid % PT;
      float acc[kR], cs[kR];
#pragma unroll
      for (int k = 0; k < kR; ++k) acc[k] = cs[k] = 0.f;
      for (int j = 0; j < QP; j += 4) {
        float xv[4], wv[kR][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) xv[u] = x_s[(j + u) * PT + p];
#pragma unroll
        for (int k = 0; k < kR; ++k)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            wv[k][u] = k < nk ? W_s[(r0 + RG * k) * WS + j + u] : 0.f;
#pragma unroll
        for (int k = 0; k < kR; ++k)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[k] = fmaf(wv[k][u], xv[u], acc[k]);
      }
      for (int n = 0; n < N; n += 4) {
        float sv[4], cv[kR][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) sv[u] = S_s[p * NS + n + u];
#pragma unroll
        for (int k = 0; k < kR; ++k)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            cv[k][u] = k < nk ? C_s[(r0 + RG * k) * NS + n + u] : 0.f;
#pragma unroll
        for (int k = 0; k < kR; ++k)
#pragma unroll
          for (int u = 0; u < 4; ++u) cs[k] = fmaf(cv[k][u], sv[u], cs[k]);
      }
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int i = r0 + RG * k;
        if (i < Q) y[((t0 + i) * H + h) * P + p0 + p] = acc[k] + ec_s[i] * cs[k];
      }
    }
    __syncthreads();

    // 5. S = exp(cum_Q) * S + sum_j (x_j * w_j) B_j, four rows j at a time
    //    (rows past Q hold zeros)
    {
      const float dec = expf(cum_s[Q - 1]);
      float acc[kE];
#pragma unroll
      for (int k = 0; k < kE; ++k) acc[k] = 0.f;
      for (int j = 0; j < QP; j += 4) {
        float bv[4], xv[kE][4];
#pragma unroll
        for (int u = 0; u < 4; ++u) bv[u] = B_s[(j + u) * NS + sn];
#pragma unroll
        for (int k = 0; k < kE; ++k)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            xv[k][u] = pg + NG * k < PT ? xw_s[(j + u) * PT + pg + NG * k] : 0.f;
#pragma unroll
        for (int k = 0; k < kE; ++k)
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[k] = fmaf(xv[k][u], bv[u], acc[k]);
      }
#pragma unroll
      for (int k = 0; k < kE; ++k) {
        const int p = pg + NG * k;
        if (p < PT) {
          sreg[k] = dec * sreg[k] + acc[k];
          S_s[p * NS + sn] = sreg[k];
        }
      }
    }
    __syncthreads();   // before the next chunk overwrites the tiles
  }

#pragma unroll
  for (int k = 0; k < kE; ++k) {
    const int p = pg + NG * k;
    if (p < PT) fs[(s_base + p) * N + sn] = sreg[k];
  }
}

template <int PT>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* s0, float* y, float* fs, int B,
           int T, int H, int P, int G, int N, int Q, cudaStream_t st) {
  const size_t bytes = smem_floats(round16(Q), N, PT) * sizeof(float);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_chunk_kernel<PT><<<dim3(H * (P / PT), B), kThreads, bytes, st>>>(
      x, dt, A, Bm, Cm, s0, y, fs, T, H, P, G, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, T, H, P), dt (B, T, H), A (H,), Bm / Cm (B, T, G, N), s0 (B, H, P,
// N), all f32 and contiguous; y (B, T, H, P) and fs (B, H, P, N) f32.
// T a multiple of Q.
int ssd_chunk_scan(const float* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* s0,
                   float* y, float* fs, int B, int T, int H, int P, int G,
                   int N, int Q, void* stream) {
  if (B < 1 || T < 1 || H < 1 || G < 1 || H % G || Q < 1 || Q > kQMax ||
      T % Q || N < 4 || N > kNMax || kThreads % N || N % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P % 16 == 0)
    return launch<16>(x, dt, A, Bm, Cm, s0, y, fs, B, T, H, P, G, N, Q, st);
  if (P == 8)
    return launch<8>(x, dt, A, Bm, Cm, s0, y, fs, B, T, H, P, G, N, Q, st);
  return (int)cudaErrorInvalidValue;
}

int ssd_chunk_max_chunk() { return kQMax; }

}  // extern "C"
