// Flash-decoding GQA attention on Hopper: two CUDA kernels with a plain C
// interface (built with nvcc into a shared library, bound with ctypes from
// repro_torch/kernels/decode_attn/kernel.py).
//
//   decode_attn   replaces repro/kernels/decode_attn/kernel.py:
//                 decode_attn_pallas (_kernel); what it computes is
//                 repro/models/attention.py:_decode_attend, the model's
//                 decode attention: one query token per sequence, G = Hq /
//                 Hkv query heads sharing each kv head, over a (B, S, Hkv,
//                 D) cache, positions p < min(length, S) and, with a
//                 window, p >= length - window; softmax in f32 with its
//                 denominator clamped at 1e-30; the output in q's dtype.
//
// What bounds it on the H100: the bytes of the valid K/V rows (at decode
// every cache row is read once and used for G dot products and G
// multiply-adds, far below the tensor cores' line).  The design keeps
// those reads wide and spread over the card:
//
// * Flash-decoding split.  The Pallas kernel walks S sequentially per
//   sequence, carrying (m, l, acc) in VMEM between grid steps; a Hopper
//   grid has no such order, and B * Hkv blocks (64 at B = 32, Hkv = 2)
//   would leave half of the 132 SMs idle.  So each block owns one chunk
//   of rows of one (sequence, kv head) and writes a partial (m, l, acc)
//   for its G query rows; a second small kernel combines the chunks.
//   Chunks are cut at fixed offsets; a block whose chunk holds no valid
//   row exits at once, so the work follows this batch's lengths.
// * Positions outside the valid range are skipped, not masked: in exact
//   arithmetic that is the same, since exp(-1e30 - m) is 0.  A length
//   above S reads all S rows (the reference never attends past S).  When
//   no position is valid (a window that ends before the cache starts) the
//   reference's scores are all -1e30 and its softmax is uniform over the S
//   rows; the kernel then takes every row with a score of 0, the same.
// * Per tile of 64 rows: scores with one 16-byte load of K per lane (a
//   row spread over D / 8 lanes in bf16, D / 4 in f32, at most a warp),
//   the G dot products against the query rows held in registers, reduced
//   with warp shuffles; the online-softmax update one warp a query row;
//   then P.V with each thread owning one 16-byte column of V for every
//   query row, the row groups summed through shared memory at the end.
//
// Templated on the element type (float, __nv_bfloat16) and on D in {64,
// 128, 256} (hymba, qwen2 and gemma3) and 16 (the reduced test configs,
// which the card-against-CPU serving parity runs); G <= 8 (kGMax).  The entry point launches on the caller's
// stream, allocates nothing (the wrapper passes the partials' scratch) and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGMax = 8;
constexpr int kTile = 64;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int n = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
};

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// eight bf16 values: each 32-bit word holds two, the lower address in
// its low half; a bf16 is the top half of the f32 with the same value
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

// [lo, hi) of valid positions of a sequence; uniform when none is valid
__device__ __forceinline__ void valid_range(int length, int S, int window,
                                            int* lo, int* hi, bool* uniform) {
  long long h = length < S ? length : S;
  long long l = 0;
  if (window >= 0) {
    l = (long long)length - window;
    if (l < 0) l = 0;
  }
  if (h < 0) h = 0;
  *uniform = l >= h;
  *lo = *uniform ? 0 : (int)l;
  *hi = *uniform ? S : (int)h;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    decode_attn_partial(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ lengths, int S, int Hkv,
                        int G, int window, float scale, int chunk,
                        int n_chunks, float* __restrict__ m_part,
                        float* __restrict__ l_part,
                        float* __restrict__ acc_part) {
  constexpr int VEC = Vec<T>::n;                          // elements / 16 B
  constexpr int LPR = (D / VEC) < 32 ? (D / VEC) : 32;    // lanes a K row
  constexpr int NV = D / (VEC * LPR);                     // loads a lane
  constexpr int RPW = 32 / LPR;                           // K rows a warp
  constexpr int COLS = D / VEC;                           // V columns
  constexpr int RG = kThreads / COLS;                     // V row groups
  static_assert(kThreads % COLS == 0 && RG >= 1, "bad D");
  static_assert(kTile % (kWarps * RPW) == 0 && kTile == 64, "bad tile");

  __shared__ float q_s[kGMax * D];
  __shared__ float p_s[kGMax * kTile];
  __shared__ float m_s[kGMax], l_s[kGMax], corr_s[kGMax];
  __shared__ float red_s[RG * kGMax * D];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t part = ((size_t)b * Hkv + h) * n_chunks + c;

  int lo, hi;
  bool uniform;
  valid_range(lengths[b], S, window, &lo, &hi, &uniform);
  const int row_lo = max(lo, c * chunk);
  const int row_hi = min(hi, (c + 1) * chunk);
  if (row_lo >= row_hi) {
    if (tid < G) m_part[part * G + tid] = -INFINITY;   // nothing to add
    return;
  }

  const int Hq = Hkv * G;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    q_s[g * D + d] = to_f32(q[((size_t)b * Hq + h * G + g) * D + d]) * scale;
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  // this lane's slice of every query row, for the score dot products
  const int li = lane % LPR;
  float qr[kGMax][NV * VEC];
#pragma unroll
  for (int g = 0; g < kGMax; ++g)
#pragma unroll
    for (int n = 0; n < NV; ++n)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        qr[g][n * VEC + j] =
            g < G ? q_s[g * D + (n * LPR + li) * VEC + j] : 0.f;

  const int col = tid % COLS, rg = tid / COLS;
  float acc[kGMax][VEC];
#pragma unroll
  for (int g = 0; g < kGMax; ++g)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;

  const size_t row_stride = (size_t)Hkv * D;
  const T* kb = k + ((size_t)b * S * Hkv + h) * D;
  const T* vb = v + ((size_t)b * S * Hkv + h) * D;

  for (int r0 = row_lo; r0 < row_hi; r0 += kTile) {
    const int nrows = min(kTile, row_hi - r0);

    // scores: RPW rows a warp at a time, LPR lanes a row
    for (int rr = warp * RPW + lane / LPR; rr < kTile; rr += kWarps * RPW) {
      const bool ok = rr < nrows;
      float dot[kGMax];
#pragma unroll
      for (int g = 0; g < kGMax; ++g) dot[g] = 0.f;
      if (ok) {
        const T* kr = kb + (size_t)(r0 + rr) * row_stride;
#pragma unroll
        for (int n = 0; n < NV; ++n) {
          float kv[VEC];
          load16(kr + (n * LPR + li) * VEC, kv);
#pragma unroll
          for (int g = 0; g < kGMax; ++g)
#pragma unroll
            for (int j = 0; j < VEC; ++j) dot[g] += kv[j] * qr[g][n * VEC + j];
        }
      }
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        if (g < G) {
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            dot[g] += __shfl_xor_sync(kFull, dot[g], off);
          if (li == 0)
            p_s[g * kTile + rr] = ok ? (uniform ? 0.f : dot[g]) : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax, one warp a query row
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = p_s[g * kTile + lane], s1 = p_s[g * kTile + lane + 32];
      const float m_old = m_s[g], l_old = l_s[g];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(kFull, sum, off);
      p_s[g * kTile + lane] = p0;
      p_s[g * kTile + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);   // 0 on the first tile
        m_s[g] = m_new;
        l_s[g] = l_old * corr + sum;
        corr_s[g] = corr;
      }
    }
    __syncthreads();

    // acc = corr * acc + P . V, one 16-byte V column a thread
#pragma unroll
    for (int g = 0; g < kGMax; ++g) {
      if (g < G) {
        const float corr = corr_s[g];
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] *= corr;
      }
    }
    for (int rr = rg; rr < nrows; rr += RG) {
      float vv[VEC];
      load16(vb + (size_t)(r0 + rr) * row_stride + col * VEC, vv);
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        if (g < G) {
          const float p = p_s[g * kTile + rr];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[g][j] += p * vv[j];
        }
      }
    }
    __syncthreads();
  }

  // sum the row groups' accumulators and write this chunk's partials
#pragma unroll
  for (int g = 0; g < kGMax; ++g)
    if (g < G)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        red_s[(rg * kGMax + g) * D + col * VEC + j] = acc[g][j];
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float s = 0.f;
    for (int r = 0; r < RG; ++r) s += red_s[(r * kGMax + g) * D + d];
    acc_part[(part * G + g) * D + d] = s;
  }
  if (tid < G) {
    m_part[part * G + tid] = m_s[tid];
    l_part[part * G + tid] = l_s[tid];
  }
}

// out[b, h * G + g] = sum_c w_c acc_c / max(sum_c w_c l_c, 1e-30),
// w_c = exp(m_c - max_c m_c), over the chunks that held valid rows
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attn_combine(const float* __restrict__ m_part,
                        const float* __restrict__ l_part,
                        const float* __restrict__ acc_part, int Hkv, int G,
                        int D, int n_chunks, T* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t base = ((size_t)b * Hkv + h) * n_chunks;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
    for (int c = 0; c < n_chunks; ++c) M = fmaxf(M, m_part[(base + c) * G + g]);
    float L = 0.f, A = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const float m = m_part[(base + c) * G + g];
      if (m == -INFINITY) continue;   // an empty chunk wrote nothing else
      const float w = expf(m - M);
      L += w * l_part[(base + c) * G + g];
      A += w * acc_part[((base + c) * G + g) * D + d];
    }
    store(out + (((size_t)b * Hkv + h) * G + g) * D + d, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int32_t* lengths,
           int B, int S, int Hkv, int G, int window, float scale, int chunk,
           int n_chunks, float* m_part, float* l_part, float* acc_part,
           void* out, cudaStream_t st) {
  decode_attn_partial<T, D><<<dim3(n_chunks, Hkv, B), kThreads, 0, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, S, Hkv, G, window, scale, chunk,
      n_chunks, m_part, l_part, acc_part);
  decode_attn_combine<T><<<dim3(Hkv, B), kThreads, 0, st>>>(
      m_part, l_part, acc_part, Hkv, G, D, n_chunks, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int32_t* lengths, int B, int S, int Hkv, int G,
               int window, float scale, int chunk, int n_chunks,
               float* m_part, float* l_part, float* acc_part, void* out,
               cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, lengths, B, S, Hkv, G, window, scale,
                           chunk, n_chunks, m_part, l_part, acc_part, out, st);
    case 64:
      return launch<T, 64>(q, k, v, lengths, B, S, Hkv, G, window, scale,
                           chunk, n_chunks, m_part, l_part, acc_part, out, st);
    case 128:
      return launch<T, 128>(q, k, v, lengths, B, S, Hkv, G, window, scale,
                            chunk, n_chunks, m_part, l_part, acc_part, out, st);
    case 256:
      return launch<T, 256>(q, k, v, lengths, B, S, Hkv, G, window, scale,
                            chunk, n_chunks, m_part, l_part, acc_part, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B, Hkv * G, D), k / v (B, S, Hkv, D) of one dtype (bf16 when is_bf16,
// else f32), lengths (B,) int32; window < 0 means none.  m_part / l_part
// (B, Hkv, n_chunks, G) and acc_part (B, Hkv, n_chunks, G, D) f32 scratch;
// out (B, Hkv * G, D) in q's dtype.
int da_decode_attn(const void* q, const void* k, const void* v,
                   const int32_t* lengths, int B, int S, int Hkv, int G, int D,
                   int is_bf16, int window, float scale, int chunk,
                   int n_chunks, float* m_part, float* l_part,
                   float* acc_part, void* out, void* stream) {
  if (G < 1 || G > kGMax || B < 1 || S < 1 || Hkv < 1 || chunk < 1 ||
      n_chunks < 1 || (long long)chunk * n_chunks < S)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, lengths, B, S, Hkv, G, window,
                                     scale, chunk, n_chunks, m_part, l_part,
                                     acc_part, out, st);
  return dispatch_d<float>(D, q, k, v, lengths, B, S, Hkv, G, window, scale,
                           chunk, n_chunks, m_part, l_part, acc_part, out, st);
}

int da_max_group() { return kGMax; }

}  // extern "C"
