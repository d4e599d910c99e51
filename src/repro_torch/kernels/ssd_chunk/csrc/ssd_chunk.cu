// Mamba-2 SSD chunked scan on Hopper: four CUDA kernels behind one plain C
// entry point (built with nvcc into a shared library, bound with ctypes
// from repro_torch/kernels/ssd_chunk/kernel.py).
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
// Design: the chunk-parallel SSD form, four kernels on the caller's stream
// over one scratch buffer that the wrapper allocates.  Only pass 3 walks
// the chunks in order, and it does no products: the time no longer grows
// with the chunk count at a fixed width of the card, and C.B^T is
// computed once per (chunk, group) instead of once per block of a head.
//
// 1. chunk_prep, a block per (sequence, chunk, group): the causal C.B^T
//    (Q x Q, j-major, zero above the diagonal and past Q) into CB, and for
//    each head of the group the inclusive prefix of dt * A into cum: each
//    f32 product (not fused) summed in f64 by a warp scan, each prefix
//    rounded once to f32, as the plain version computes it.  The decays
//    are exponentials of differences of these prefixes, which reach
//    |cum| ~ 2,000 at the model's ranges, where one f32 step is 1.2e-4;
//    f64 sums of at most 128 such products round to the same f32 prefixes
//    in any order.  Passes 2-4 read the same cum.
// 2. chunk_states, a block per (sequence, chunk, head, tile of PT state
//    rows): the chunk's own contribution sum_j (x_j w_j) (x) B_j into S.
// 3. state_pass, a thread per state element: over the chunks in order it
//    leaves in S[c] the state entering chunk c and carries
//    S = exp(cum_Q) S + S[c]; the last is the final state.  It moves the
//    scratch twice (2 x 268 MB at T 32,768 on mamba2's heads).
// 4. chunk_outputs, a block per (sequence, chunk, head, tile of PT rows):
//    y = W x + exp(cum) (C . S), W formed from CB, cum and dt.
//
// Passes 2 and 4 are small products out of shared memory: each thread
// owns TR = PT / 8 rows by 4 columns of the output (a warp 16 rows, all PT
// columns) and at every step of the sum reads its rows as one or two
// 16-byte loads of a k-major tile and its columns as one, for 4 TR fused
// multiply-adds.  Each stays under 113 KB of shared memory (99.8 KB at
// Q 128, N 128, PT 64) and 128 registers, so two blocks share an SM; the
// intra-chunk sum of warp w stops at row 16 w + 16 (W is causal).  The
// sums run over j and n in order, as the plain version's and the
// single-pass kernel's did.  Pass 1 keeps its 16 x 16 thread grid with
// 8 x 8 strided outputs a thread and skips the tiles above the diagonal.
//
// Any chunk length 1..128 (the model passes min(ssm_chunk, max(8, T)),
// e.g. 10 or 100): tiles are padded to QP, a multiple of 16 rows, with
// zeros, and the kernels run at the Q they are given, since the rounding
// depends on it.  T must be a multiple of Q: the wrapper pads with dt = 0
// rows, which leave the state untouched (decay 1, weight 0).
//
// Scratch, in floats (ssd_chunk_scratch_floats): CB B (T / Q) G QP^2, cum
// B T H (rounded up to 64), S B (T / Q) H N P, laid out (b, c, h, n, p).
//
// Instances: P a multiple of 16 (PT 64, 32 or 16) or P = 8; N a multiple
// of 4 up to 128; 1 <= Q <= 128; G dividing H.  x, Bm, Cm, y and the
// scratch 16-byte aligned.  The entry point launches on the caller's
// stream, allocates nothing and returns the first CUDA error.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQMax = 128;
constexpr int kNMax = 128;

__host__ __device__ inline int round16(int q) { return (q + 15) & ~15; }

struct Layout {
  size_t cb, cum, s, total;   // offsets in floats
};

__host__ inline Layout scratch_layout(int B, int T, int H, int P, int G,
                                      int N, int Q) {
  const size_t nc = T / Q, QP = round16(Q);
  Layout l;
  l.cb = 0;
  l.cum = (size_t)B * nc * G * QP * QP;
  l.s = l.cum + (((size_t)B * T * H + 63) & ~(size_t)63);
  l.total = l.s + (size_t)B * nc * H * N * P;
  return l;
}

// ---------------------------------------------------------------------------
// pass 1: C.B^T once per (chunk, group), and cum
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
    chunk_prep(const float* __restrict__ dt, const float* __restrict__ A,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               float* __restrict__ CB, float* __restrict__ cum, int T, int H,
               int G, int N, int Q) {
  extern __shared__ __align__(16) float sm[];
  const int QP = round16(Q), NS = N + 1;   // rows padded against conflicts
  float* C_s = sm;
  float* B_s = C_s + QP * NS;
  const int nc = T / Q;
  const int b = blockIdx.x / nc, c = blockIdx.x % nc, g = blockIdx.y;
  const size_t t0 = (size_t)b * T + (size_t)c * Q;   // row in (B * T)
  const int tid = threadIdx.x;

  // stage B and C of the chunk, zero rows past Q
  const int n4 = N / 4;
#pragma unroll 4
  for (int e = tid; e < QP * n4; e += kThreads) {
    const int r = e / n4, n = (e % n4) * 4;
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

  // cum for each head of the group, a warp a head: the f32 products summed
  // in f64, each prefix rounded once
  {
    const int lane = tid & 31, hg = H / G;
    for (int hh = tid >> 5; hh < hg; hh += kWarps) {
      const int h = g * hg + hh;
      const float a_h = A[h];
      double carry = 0.0;
      for (int base = 0; base < Q; base += 32) {
        const int i = base + lane;
        double v = i < Q ? (double)__fmul_rn(dt[(t0 + i) * H + h], a_h) : 0.0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const double u = __shfl_up_sync(0xffffffffu, v, off);
          if (lane >= off) v += u;
        }
        v += carry;
        if (i < Q) cum[(t0 + i) * H + h] = __double2float_rn(v);
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
  }
  __syncthreads();

  // C.B^T: rows i = ti + 16 a, columns j = tj + 16 q (q > a lies above the
  // diagonal), two columns of N at a time with their loads issued first
  const int ti = tid % 16, tj = tid / 16, na = QP / 16;
  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int q = 0; q < 8; ++q) acc[a][q] = 0.f;
  for (int n = 0; n < N; n += 2) {
    float cv[2][8], bv[2][8];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        cv[u][a] = a < na ? C_s[(ti + 16 * a) * NS + n + u] : 0.f;
        bv[u][a] = a < na ? B_s[(tj + 16 * a) * NS + n + u] : 0.f;
      }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int q = 0; q <= a; ++q)
          acc[a][q] = fmaf(cv[u][a], bv[u][q], acc[a][q]);
  }
  // CB[j][i], the whole QP x QP tile, zero above the diagonal and past Q
  float* cb = CB + ((size_t)blockIdx.x * G + g) * QP * QP;
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int i = ti + 16 * a, j = tj + 16 * q;
      if (a < na && q < na)
        cb[j * QP + i] = (q <= a && j <= i && i < Q) ? acc[a][q] : 0.f;
    }
}

// ---------------------------------------------------------------------------
// passes 2 and 4: a warp's 16 rows by PT columns out of shared memory
// ---------------------------------------------------------------------------

template <int TR>
__device__ __forceinline__ void load_rows(const float* p, float (&v)[TR]) {
  if constexpr (TR % 4 == 0) {
#pragma unroll
    for (int q = 0; q < TR / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = f.x, v[4 * q + 1] = f.y, v[4 * q + 2] = f.z, v[4 * q + 3] = f.w;
    }
  } else if constexpr (TR == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

// acc[r][u] += sum_{k < K} At[k][r0 + r] * Bk[k][c0 + u], k in order
template <int TR>
__device__ __forceinline__ void outer(const float* At, int lda,
                                      const float* Bk, int ldb, int K,
                                      int r0, int c0, float (&acc)[TR][4]) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TR];
    load_rows<TR>(At + k * lda + r0, a);
    const float4 bv = *reinterpret_cast<const float4*>(Bk + k * ldb + c0);
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      acc[r][0] = fmaf(a[r], bv.x, acc[r][0]);
      acc[r][1] = fmaf(a[r], bv.y, acc[r][1]);
      acc[r][2] = fmaf(a[r], bv.z, acc[r][2]);
      acc[r][3] = fmaf(a[r], bv.w, acc[r][3]);
    }
  }
}

// this thread's first row and column of a warp's 16 x PT outputs
template <int PT>
struct Tile {
  static constexpr int CG = PT / 4;   // column groups of 4 a warp
  static constexpr int TR = PT / 8;   // rows a thread
  int r0, c0;
  __device__ Tile(int tid) {
    const int lane = tid & 31;
    r0 = 16 * (tid >> 5) + (lane / CG) * TR;
    c0 = (lane % CG) * 4;
  }
};

__host__ __device__ inline size_t states_smem_floats(int QP, int NP, int PT) {
  return (size_t)QP * NP + (size_t)QP * PT + QP;   // B, x * w, w
}

// pass 2: S[b, c, h, n, p0 + p] = sum_j B_j[n] (x_j[p] w_j)
template <int PT>
__global__ void __launch_bounds__(kThreads, 2)
    chunk_states(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ Bm, const float* __restrict__ cum,
                 float* __restrict__ S, int T, int H, int P, int G, int N,
                 int Q) {
  extern __shared__ __align__(16) float sm[];
  const int QP = round16(Q), NP = round16(N);
  float* B_s = sm;                 // QP x NP, row j, zero columns past N
  float* xw_s = B_s + QP * NP;     // QP x PT, row j
  float* w_s = xw_s + QP * PT;     // QP
  const int nc = T / Q, n_pt = P / PT;
  const int b = blockIdx.x / nc, c = blockIdx.x % nc;
  const int h = blockIdx.y / n_pt, p0 = (blockIdx.y % n_pt) * PT;
  const int g = h / (H / G);
  const size_t t0 = (size_t)b * T + (size_t)c * Q;
  const int tid = threadIdx.x;

  const float total = cum[(t0 + Q - 1) * H + h];
  for (int i = tid; i < Q; i += kThreads)
    w_s[i] = expf(total - cum[(t0 + i) * H + h]) * dt[(t0 + i) * H + h];
  const int np4 = NP / 4;
#pragma unroll 4
  for (int e = tid; e < Q * np4; e += kThreads) {
    const int j = e / np4, n = (e % np4) * 4;
    float4 bv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < N)
      bv = *reinterpret_cast<const float4*>(Bm + ((t0 + j) * G + g) * N + n);
    *reinterpret_cast<float4*>(B_s + j * NP + n) = bv;
  }
  __syncthreads();
  constexpr int p4 = PT / 4;
#pragma unroll 2
  for (int e = tid; e < Q * p4; e += kThreads) {
    const int j = e / p4, q = (e % p4) * 4;
    float4 xv = *reinterpret_cast<const float4*>(x + ((t0 + j) * H + h) * P +
                                                 p0 + q);
    const float w = w_s[j];
    xv.x *= w, xv.y *= w, xv.z *= w, xv.w *= w;
    *reinterpret_cast<float4*>(xw_s + j * PT + q) = xv;
  }
  __syncthreads();

  using Tl = Tile<PT>;
  const Tl tl(tid);
  if (16 * (tid >> 5) >= NP) return;
  float acc[Tl::TR][4] = {};
  outer<Tl::TR>(B_s, NP, xw_s, PT, Q, tl.r0, tl.c0, acc);
  float* out = S + (((size_t)blockIdx.x * H + h) * N) * P + p0 + tl.c0;
#pragma unroll
  for (int r = 0; r < Tl::TR; ++r) {
    const int n = tl.r0 + r;
    if (n < N)
      *reinterpret_cast<float4*>(out + (size_t)n * P) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

// pass 3: S[c] <- the state entering chunk c; fs <- the final state
__global__ void __launch_bounds__(kThreads)
    state_pass(const float* __restrict__ s0, const float* __restrict__ cum,
               float* __restrict__ S, float* __restrict__ fs, int B, int T,
               int H, int P, int N, int Q) {
  const size_t per_b = (size_t)H * N * P;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)B * per_b) return;
  const int b = (int)(e / per_b);
  const size_t r = e % per_b;                 // (h N + n) P + p
  const int p = (int)(r % P), n = (int)((r / P) % N), h = (int)(r / (N * (size_t)P));
  const int nc = T / Q;
  const size_t si = (((size_t)b * H + h) * P + p) * N + n;
  float* sp = S + (size_t)b * nc * per_b + r;            // chunk c: + c per_b
  const float* cp = cum + ((size_t)b * T + Q - 1) * H + h;   // + c Q H
  float s = s0[si];
  constexpr int U = 8;   // loads of U chunks issued before their updates
  for (int c0 = 0; c0 < nc; c0 += U) {
    float add[U], dec[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < nc) {
        add[u] = sp[(size_t)(c0 + u) * per_b];
        dec[u] = cp[(size_t)(c0 + u) * Q * H];
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (c0 + u < nc) {
        sp[(size_t)(c0 + u) * per_b] = s;
        s = expf(dec[u]) * s + add[u];
      }
  }
  fs[si] = s;
}

__host__ __device__ inline size_t outputs_smem_floats(int QP, int N, int PT) {
  const size_t a = (size_t)QP * QP + (size_t)QP * PT;   // W^T, x
  const size_t s = (size_t)N * QP + (size_t)N * PT;     // C^T, S^T
  return 3 * (size_t)QP + (a > s ? a : s);              // cum, dt, exp(cum)
}

// pass 4: y_i = sum_{j <= i} W[i, j] x_j + exp(cum_i) (C_i . S_in)
template <int PT>
__global__ void __launch_bounds__(kThreads, 2)
    chunk_outputs(const float* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ Cm, const float* __restrict__ CB,
                  const float* __restrict__ cum, const float* __restrict__ S,
                  float* __restrict__ y, int T, int H, int P, int G, int N,
                  int Q) {
  extern __shared__ __align__(16) float sm[];
  const int QP = round16(Q);
  float* cum_s = sm;
  float* dt_s = cum_s + QP;
  float* ec_s = dt_s + QP;
  float* U = ec_s + QP;
  float* Ct = U;                 // phase 1: N x QP, C transposed
  float* St = Ct + N * QP;       //          N x PT, the entering state
  float* Wt = U;                 // phase 2: QP x QP, W transposed
  float* x_s = Wt + QP * QP;     //          QP x PT
  const int nc = T / Q, n_pt = P / PT;
  const int b = blockIdx.x / nc, c = blockIdx.x % nc;
  const int h = blockIdx.y / n_pt, p0 = (blockIdx.y % n_pt) * PT;
  const int g = h / (H / G);
  const size_t t0 = (size_t)b * T + (size_t)c * Q;
  const int tid = threadIdx.x;
  constexpr int p4 = PT / 4;

  for (int i = tid; i < QP; i += kThreads) {
    const float cv = i < Q ? cum[(t0 + i) * H + h] : 0.f;
    cum_s[i] = cv;
    dt_s[i] = i < Q ? dt[(t0 + i) * H + h] : 0.f;
    ec_s[i] = expf(cv);
  }
  const int n4 = N / 4;
#pragma unroll 4
  for (int e = tid; e < QP * n4; e += kThreads) {
    const int i = e % QP, n = (e / QP) * 4;
    float4 cv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < Q)
      cv = *reinterpret_cast<const float4*>(Cm + ((t0 + i) * G + g) * N + n);
    Ct[n * QP + i] = cv.x, Ct[(n + 1) * QP + i] = cv.y;
    Ct[(n + 2) * QP + i] = cv.z, Ct[(n + 3) * QP + i] = cv.w;
  }
  const float* s_in = S + (((size_t)blockIdx.x * H + h) * N) * P + p0;
#pragma unroll 4
  for (int e = tid; e < N * p4; e += kThreads) {
    const int n = e / p4, q = (e % p4) * 4;
    *reinterpret_cast<float4*>(St + n * PT + q) =
        *reinterpret_cast<const float4*>(s_in + (size_t)n * P + q);
  }
  __syncthreads();

  using Tl = Tile<PT>;
  const Tl tl(tid);
  const bool rows = 16 * (tid >> 5) < QP;
  float cs[Tl::TR][4] = {};
  if (rows) outer<Tl::TR>(Ct, QP, St, PT, N, tl.r0, tl.c0, cs);
  __syncthreads();   // before W and x overwrite C and S

  const float* cb = CB + ((size_t)blockIdx.x * G + g) * QP * QP;
  const int q4 = QP / 4;
#pragma unroll 4
  for (int e = tid; e < QP * q4; e += kThreads) {
    const int j = e / q4, i0 = (e % q4) * 4;
    const float4 v = *reinterpret_cast<const float4*>(cb + j * QP + i0);
    const float vv[4] = {v.x, v.y, v.z, v.w};
    float w[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u;
      w[u] = (j <= i && i < Q)
                 ? vv[u] * expf(fminf(cum_s[i] - cum_s[j], 0.f)) * dt_s[j]
                 : 0.f;
    }
    *reinterpret_cast<float4*>(Wt + j * QP + i0) =
        make_float4(w[0], w[1], w[2], w[3]);
  }
#pragma unroll 2
  for (int e = tid; e < Q * p4; e += kThreads) {
    const int j = e / p4, q = (e % p4) * 4;
    *reinterpret_cast<float4*>(x_s + j * PT + q) =
        *reinterpret_cast<const float4*>(x + ((t0 + j) * H + h) * P + p0 + q);
  }
  __syncthreads();
  if (!rows) return;

  float acc[Tl::TR][4] = {};
  const int K = min(Q, 16 * (tid >> 5) + 16);   // W is zero past the warp's rows
  outer<Tl::TR>(Wt, QP, x_s, PT, K, tl.r0, tl.c0, acc);
#pragma unroll
  for (int r = 0; r < Tl::TR; ++r) {
    const int i = tl.r0 + r;
    if (i < Q) {
      const float e = ec_s[i];
      *reinterpret_cast<float4*>(y + ((t0 + i) * H + h) * P + p0 + tl.c0) =
          make_float4(acc[r][0] + e * cs[r][0], acc[r][1] + e * cs[r][1],
                      acc[r][2] + e * cs[r][2], acc[r][3] + e * cs[r][3]);
    }
  }
}

// opt in to `bytes` of dynamic shared memory, and ask for the largest
// carveout so that two blocks of passes 2 and 4 fit an SM
template <typename K>
cudaError_t set_smem(K kernel, size_t bytes, size_t optin) {
  if (bytes > optin) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int PT>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, const float* s0, float* y, float* fs,
           float* scratch, int B, int T, int H, int P, int G, int N, int Q,
           cudaStream_t st) {
  const int QP = round16(Q), NP = round16(N), nc = T / Q;
  const Layout l = scratch_layout(B, T, H, P, G, N, Q);
  float* CB = scratch + l.cb;
  float* cum = scratch + l.cum;
  float* S = scratch + l.s;
  const size_t b1 = 2 * (size_t)QP * (N + 1) * sizeof(float);
  const size_t b2 = states_smem_floats(QP, NP, PT) * sizeof(float);
  const size_t b4 = outputs_smem_floats(QP, N, PT) * sizeof(float);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaError_t err = set_smem(chunk_prep, b1, optin);
  if (err == cudaSuccess) err = set_smem(chunk_states<PT>, b2, optin);
  if (err == cudaSuccess) err = set_smem(chunk_outputs<PT>, b4, optin);
  if (err != cudaSuccess) return (int)err;

  const dim3 chunks(B * nc, G), tiles(B * nc, H * (P / PT));
  chunk_prep<<<chunks, kThreads, b1, st>>>(dt, A, Bm, Cm, CB, cum, T, H, G,
                                           N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  chunk_states<PT><<<tiles, kThreads, b2, st>>>(x, dt, Bm, cum, S, T, H, P,
                                                G, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t n_state = (size_t)B * H * N * P;
  state_pass<<<(unsigned)((n_state + kThreads - 1) / kThreads), kThreads, 0,
               st>>>(s0, cum, S, fs, B, T, H, P, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  chunk_outputs<PT><<<tiles, kThreads, b4, st>>>(x, dt, Cm, CB, cum, S, y, T,
                                                 H, P, G, N, Q);
  return (int)cudaGetLastError();
}

bool shape_ok(int B, int T, int H, int P, int G, int N, int Q) {
  return B >= 1 && T >= 1 && H >= 1 && G >= 1 && H % G == 0 && Q >= 1 &&
         Q <= kQMax && T % Q == 0 && N >= 4 && N <= kNMax && N % 4 == 0 &&
         (P % 16 == 0 || P == 8) && (size_t)B * (T / Q) < (1u << 31) &&
         H * (P / 8) < 65536;
}

}  // namespace

extern "C" {

// Floats of scratch that ssd_chunk_scan needs at these shapes, or -1.
long long ssd_chunk_scratch_floats(int B, int T, int H, int P, int G, int N,
                                   int Q) {
  if (!shape_ok(B, T, H, P, G, N, Q)) return -1;
  return (long long)scratch_layout(B, T, H, P, G, N, Q).total;
}

// x (B, T, H, P), dt (B, T, H), A (H,), Bm / Cm (B, T, G, N), s0 (B, H, P,
// N), all f32 and contiguous; y (B, T, H, P) and fs (B, H, P, N) f32;
// scratch ssd_chunk_scratch_floats(...) f32.  T a multiple of Q.
int ssd_chunk_scan(const float* x, const float* dt, const float* A,
                   const float* Bm, const float* Cm, const float* s0,
                   float* y, float* fs, float* scratch, int B, int T, int H,
                   int P, int G, int N, int Q, void* stream) {
  if (!shape_ok(B, T, H, P, G, N, Q) ||
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
        reinterpret_cast<uintptr_t>(Cm) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(scratch)) & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P % 64 == 0)
    return launch<64>(x, dt, A, Bm, Cm, s0, y, fs, scratch, B, T, H, P, G, N,
                      Q, st);
  if (P % 32 == 0)
    return launch<32>(x, dt, A, Bm, Cm, s0, y, fs, scratch, B, T, H, P, G, N,
                      Q, st);
  if (P % 16 == 0)
    return launch<16>(x, dt, A, Bm, Cm, s0, y, fs, scratch, B, T, H, P, G, N,
                      Q, st);
  return launch<8>(x, dt, A, Bm, Cm, s0, y, fs, scratch, B, T, H, P, G, N, Q,
                   st);
}

int ssd_chunk_max_chunk() { return kQMax; }

}  // extern "C"
