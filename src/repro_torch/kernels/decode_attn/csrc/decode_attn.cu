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
// multiply-adds, far below the tensor cores' line).  So the design is
// about keeping enough bytes in flight on every SM (about 25 KB at
// 3.35 TB/s and a microsecond of latency):
//
// * A balanced flash-decoding split.  The Pallas kernel walks S in order,
//   carrying (m, l, acc) in VMEM between grid steps; a Hopper grid has no
//   such order.  Each (sequence, kv head) valid range [lo, hi), computed
//   here from `lengths`, is cut into n_split equal pieces rounded up to
//   whole tiles (the host picks n_split from B * Hkv and S alone, enough
//   for two waves of two blocks an SM, and never reads `lengths`); a block
//   owns one piece and writes a partial (m, l, acc) for its G query rows,
//   and a second small kernel combines the pieces.  No block walks rows
//   outside the valid range, a sequence of one tile is one piece, and an
//   empty piece writes m = -inf and exits.
// * A ring of kStages = 3 stages in dynamic shared memory, each a tile of
//   K rows and the same V rows (16 KB each at most: 64 rows at bf16 D
//   128), filled by 16-byte cp.async.cg copies with commit / wait groups.
//   cp.async rather than TMA: a tile is TILE rows of one kv head, each row
//   D * esz contiguous bytes at a stride of Hkv * D elements, which cp.async
//   covers with one 16-byte copy per thread and chunk and no tensor map to
//   build on the host for every call's cache pointer; TMA would save the
//   copy instructions, a few percent of the issue slots here.  Two tiles
//   are in flight while the third is used: 64 KB a block, two blocks an SM
//   (96 KB of ring each), so about 128 KB an SM.  One __syncthreads a stage:
//   it publishes the stage that landed and frees the one the next copy
//   overwrites.
// * No other block-wide barrier in the loop: each of the 8 warps owns TILE
//   / 8 rows of every tile and runs its own online softmax over them (m,
//   l and acc of every query row), the warps' partials merged once at the
//   end through the freed ring.  Scores: a K row over LPR lanes, one
//   16-byte shared load a lane, the G query rows' slices in registers,
//   summed by a butterfly that halves the values at each step (8 shuffles
//   for G <= 8 and 16 lanes, not G * 4); the softmax of the warp's rows
//   one group of 32 / NG lanes a query row; P.V with each lane owning VP
//   columns of V for every query row.
// * Register arrays sized by the compile-time group: an instance per G in
//   1..8, per D in {16, 64, 128, 256} (the reduced test configs, hymba,
//   qwen2, gemma3) and per dtype (f32, bf16).
//
// Positions outside the valid range are skipped, not masked: in exact
// arithmetic that is the same, since exp(-1e30 - m) is 0.  A length above
// S reads all S rows (the reference never attends past S, F8).  When no
// position is valid (a window that ends before the cache starts) the
// reference's scores are all -1e30 and its softmax is uniform over the S
// rows; the kernel then takes every row with a score of 0, the same.
//
// nvcc -Xptxas -v, sm_90a, CUDA 12.8 (registers, spill bytes and shared
// memory a block of decode_attn_partial, as kernels/_build.py's
// build(src, verbose=True) prints them for every instance):
//   before (128 threads, kGMax = 8 arrays for every G, 512-row chunks,
//   static shared memory): bf16 D 128 161 registers, 0 spills, 39,008 B;
//   f32 D 256 128 registers, 0 spills, 26,720 B; f32 D 128 96 registers,
//   22,624 B.  One block of 4 warps an SM at bf16 D 128 (registers).
//   after (256 threads, dynamic shared memory): bf16 D 128 G 6 122
//   registers, 0 spills, 100,608 B; f32 D 256 G 4 124 registers, 0
//   spills, 98,688 B; f32 D 128 G 6 102 registers.  Two blocks of 8 warps
//   an SM.  Every instance has 0 spills; G 8 in bf16 at D 16, 64 and 128,
//   and G 6-8 at D 256, take one block an SM (146-184 registers).
//
// The entry point launches on the caller's stream, allocates nothing (the
// wrapper passes the partials' scratch) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGMax = 8;
constexpr int kStages = 3;
constexpr int kStageBytes = 16384;     // K bytes of one stage; V the same
constexpr unsigned kFull = 0xffffffffu;

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// The tiling of one (dtype, D) instance.
template <typename T, int D>
struct Shape {
  static constexpr int esz = (int)sizeof(T);
  static constexpr int VEC = 16 / esz;                    // elements / 16 B
  static constexpr int LPR = cmin(D / VEC, 32);           // lanes a K row
  static constexpr int NV = D / (VEC * LPR);              // loads a lane a row
  static constexpr int RPW = 32 / LPR;                    // K rows a warp step
  static constexpr int TILE =
      cmax(16, cmin(128, kStageBytes / (D * esz)));       // rows a stage
  static constexpr int RW = TILE / kWarps;                // rows a warp a tile
  static constexpr int VP = cmax(D / 32, 4);              // V columns a lane
  static constexpr int LR = D / VP;                       // lanes a V row
  static constexpr int RR = 32 / LR;                      // V rows a warp step
  static constexpr int CPR = D * esz / 16;                // 16-B chunks a row
  static constexpr int RING = kStages * 2 * TILE * D * esz;   // bytes
  static_assert(RW >= 1 && RW % RPW == 0, "bad tile");
  static_assert(LR * VP == D && LR <= 32, "bad V split");
};

// G padded to a power of two for the butterfly and the softmax groups
template <int G>
struct Pad {
  static constexpr int value = G <= 1 ? 1 : G <= 2 ? 2 : G <= 4 ? 4 : 8;
};

// one block an SM where the per-thread arrays leave too few registers for
// two (2 x 256 threads x 128 registers fill the register file)
template <typename T, int D, int G>
struct MinBlocks {
  static constexpr int value =
      G * (Shape<T, D>::NV * Shape<T, D>::VEC + Shape<T, D>::VP) > 84 ? 1 : 2;
};

__device__ __forceinline__ void cvt16(const float4& v, float* out) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// eight bf16 values: each 32-bit word holds two, the lower address in its
// low half; a bf16 is the top half of the f32 with the same value
__device__ __forceinline__ void cvt16(const uint4& u, float* out) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load16(const float* p, float* out) {
  cvt16(*reinterpret_cast<const float4*>(p), out);
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  cvt16(*reinterpret_cast<const uint4*>(p), out);
}

// N consecutive elements (N a multiple of 4) from shared memory as f32
template <int N>
__device__ __forceinline__ void loadv(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 4) load16(p + i, out + i);
}
template <int N>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(u.x << 16);
    out[1] = __uint_as_float(u.x & 0xffff0000u);
    out[2] = __uint_as_float(u.y << 16);
    out[3] = __uint_as_float(u.y & 0xffff0000u);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) load16(p + i, out + i);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as astype(bfloat16)
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads, (MinBlocks<T, D, G>::value))
    decode_attn_partial(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int32_t* __restrict__ lengths, int S, int Hkv,
                        int window, float scale, int n_split,
                        float* __restrict__ m_part, float* __restrict__ l_part,
                        float* __restrict__ acc_part) {
  using Sh = Shape<T, D>;
  constexpr int VEC = Sh::VEC, LPR = Sh::LPR, NV = Sh::NV, RPW = Sh::RPW;
  constexpr int TILE = Sh::TILE, RW = Sh::RW, VP = Sh::VP, LR = Sh::LR;
  constexpr int RR = Sh::RR, CPR = Sh::CPR;
  constexpr int NG = Pad<G>::value;
  constexpr int GS = 32 / NG;          // softmax lanes a query row

  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);       // [kStages][K, V][TILE][D]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this warp's scores / probabilities [RW][NG], then its corrections [NG]
  float* ws = reinterpret_cast<float*>(smem + Sh::RING) + warp * (RW + 1) * NG;
  float* wcorr = ws + RW * NG;

  const int p = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t part = ((size_t)b * Hkv + h) * n_split + p;

  int lo, hi;
  bool uniform;
  valid_range(lengths[b], S, window, &lo, &hi, &uniform);
  const long long per = (hi - lo + n_split - 1) / n_split;
  const long long piece = (per + TILE - 1) / TILE * TILE;
  const long long rlo = lo + p * piece;
  const int row_lo = (int)(rlo < hi ? rlo : hi);
  const int row_hi = (int)(rlo + piece < hi ? rlo + piece : hi);
  if (row_lo >= row_hi) {
    if (tid < G) m_part[part * G + tid] = -INFINITY;   // nothing to add
    return;
  }

  // this lane's slice of every query row, scaled, for the score dot products
  const int li = lane % LPR, sub = lane / LPR;
  float qr[G][NV * VEC];
  {
    const T* qb = q + ((size_t)b * Hkv + h) * G * D;
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        load16(qb + g * D + (n * LPR + li) * VEC, &qr[g][n * VEC]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) qr[g][n * VEC + j] *= scale;
      }
  }

  const size_t rs = (size_t)Hkv * D;    // elements between cache rows
  const T* kb = k + ((size_t)b * S * Hkv + h) * D;
  const T* vb = v + ((size_t)b * S * Hkv + h) * D;
  const int ntiles = (row_hi - row_lo + TILE - 1) / TILE;

  // copy tile t's valid rows of K and V into stage t % kStages; always
  // commit a group (empty past the last tile) so the waits count alike
  auto issue = [&](int t) {
    if (t < ntiles) {
      T* ks = ring + (t % kStages) * 2 * TILE * D;
      T* vs = ks + TILE * D;
      const int r0 = row_lo + t * TILE;
      const int nr = min(TILE, row_hi - r0);
      for (int i = tid; i < nr * CPR; i += kThreads) {
        const int r = i / CPR, c = i % CPR;
        const size_t off = (size_t)(r0 + r) * rs + c * VEC;
        cp_async16(ks + r * D + c * VEC, kb + off);
        cp_async16(vs + r * D + c * VEC, vb + off);
      }
    }
    cp_async_commit();
  };

  float acc[G][VP];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < VP; ++j) acc[g][j] = 0.f;
  // the running max and sum of query row sg, kept by its GS softmax lanes
  const int sg = lane / GS, sj = lane % GS;
  float m_run = -INFINITY, l_run = 0.f;
  const int vl = lane % LR, vr = lane / LR;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // tile t landed; tile t - 1 is done with
    issue(t + kStages - 1);
    const T* ks = ring + (t % kStages) * 2 * TILE * D + warp * RW * D;
    const T* vs = ks + TILE * D;
    const int nw = min(RW, row_hi - row_lo - t * TILE - warp * RW);
    if (nw <= 0) continue;           // this warp has no row in this tile

    // scores of the warp's RW rows, RPW rows a step, LPR lanes a row
#pragma unroll
    for (int it = 0; it < RW / RPW; ++it) {
      const int r = it * RPW + sub;
      float dot[NG];
#pragma unroll
      for (int g = 0; g < NG; ++g) dot[g] = 0.f;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        float kv[VEC];
        load16(ks + r * D + (n * LPR + li) * VEC, kv);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int j = 0; j < VEC; ++j) dot[g] += kv[j] * qr[g][n * VEC + j];
      }
      // butterfly: at each step a lane keeps half of its values and adds
      // its partner's other half, until one value (or LPR < NG values) is
      // left; then plain reduction over the remaining lanes
      int gb = 0, cnt = NG, pmask = 0;
#pragma unroll
      for (int off = LPR / 2; off >= 1; off >>= 1) {
        if (cnt > 1) {
          const int half = cnt / 2;
          const bool up = (lane & off) != 0;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float send = up ? dot[i] : dot[i + half];
            const float keep = up ? dot[i + half] : dot[i];
            dot[i] = keep + __shfl_xor_sync(kFull, send, off);
          }
          if (up) gb += half;
          cnt = half;
        } else {
          dot[0] += __shfl_xor_sync(kFull, dot[0], off);
          pmask |= off;
        }
      }
      if ((li & pmask) == 0) {
        const bool ok = r < nw;
#pragma unroll
        for (int i = 0; i < NG; ++i)
          if (i < cnt)
            ws[r * NG + gb + i] = ok ? (uniform ? 0.f : dot[i]) : -INFINITY;
      }
    }
    __syncwarp();

    // online softmax over the warp's rows: GS lanes a query row
    float mx = -INFINITY;
#pragma unroll
    for (int r = sj; r < RW; r += GS) mx = fmaxf(mx, ws[r * NG + sg]);
#pragma unroll
    for (int off = GS / 2; off >= 1; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    const float m_new = fmaxf(m_run, mx);   // finite: row 0 is valid
    float sum = 0.f;
#pragma unroll
    for (int r = sj; r < RW; r += GS) {
      const float e = expf(ws[r * NG + sg] - m_new);
      ws[r * NG + sg] = e;
      sum += e;
    }
#pragma unroll
    for (int off = GS / 2; off >= 1; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    const float corr = expf(m_run - m_new);  // 0 on the warp's first tile
    m_run = m_new;
    l_run = l_run * corr + sum;
    if (sj == 0) wcorr[sg] = corr;
    __syncwarp();

    // acc = corr * acc + P . V over the warp's rows, VP columns a lane
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float c = wcorr[g];
#pragma unroll
      for (int j = 0; j < VP; ++j) acc[g][j] *= c;
    }
    for (int r = vr; r < nw; r += RR) {
      float vv[VP];
      loadv<VP>(vs + r * D + vl * VP, vv);
      float pr[NG];
      if constexpr (NG >= 4) {
#pragma unroll
        for (int g = 0; g < NG; g += 4)
          cvt16(*reinterpret_cast<const float4*>(ws + r * NG + g), pr + g);
      } else {
#pragma unroll
        for (int g = 0; g < NG; ++g) pr[g] = ws[r * NG + g];
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int j = 0; j < VP; ++j) acc[g][j] += pr[g] * vv[j];
    }
  }

  // merge the warps' partials through the freed ring and write the piece's
  cp_async_wait<0>();
  __syncthreads();
  float* cm = reinterpret_cast<float*>(smem);   // [kWarps][G] maxima
  float* cl = cm + kWarps * G;                  // [kWarps][G] sums
  float* ca = cl + kWarps * G;                  // [kWarps][G][D]
#pragma unroll
  for (int off = LR; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < VP; ++j)
        acc[g][j] += __shfl_xor_sync(kFull, acc[g][j], off);
  if (lane < LR) {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int j = 0; j < VP; ++j)
        ca[(warp * G + g) * D + vl * VP + j] = acc[g][j];
  }
  if (sj == 0 && sg < G) {
    cm[warp * G + sg] = m_run;     // -inf for a warp that saw no row
    cl[warp * G + sg] = l_run;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, cm[w * G + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float m = cm[w * G + g];
      if (m == -INFINITY) continue;
      const float wgt = expf(m - M);
      L += wgt * cl[w * G + g];
      A += wgt * ca[(w * G + g) * D + d];
    }
    acc_part[(part * G + g) * D + d] = A;
    if (d == 0) {
      m_part[part * G + g] = M;
      l_part[part * G + g] = L;
    }
  }
}

// out[b, h * G + g] = sum_c w_c acc_c / max(sum_c w_c l_c, 1e-30),
// w_c = exp(m_c - max_c m_c), over the pieces that held valid rows
template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_attn_combine(const float* __restrict__ m_part,
                        const float* __restrict__ l_part,
                        const float* __restrict__ acc_part, int Hkv, int G,
                        int D, int n_split, T* __restrict__ out) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t base = ((size_t)b * Hkv + h) * n_split;
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = -INFINITY;
    for (int c = 0; c < n_split; ++c) M = fmaxf(M, m_part[(base + c) * G + g]);
    float L = 0.f, A = 0.f;
    for (int c = 0; c < n_split; ++c) {
      const float m = m_part[(base + c) * G + g];
      if (m == -INFINITY) continue;   // an empty piece wrote nothing else
      const float w = expf(m - M);
      L += w * l_part[(base + c) * G + g];
      A += w * acc_part[((base + c) * G + g) * D + d];
    }
    store(out + (((size_t)b * Hkv + h) * G + g) * D + d, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int32_t* lengths,
           int B, int S, int Hkv, int window, float scale, int n_split,
           float* m_part, float* l_part, float* acc_part, void* out,
           cudaStream_t st) {
  using Sh = Shape<T, D>;
  constexpr int smem = Sh::RING + kWarps * (Sh::RW + 1) * Pad<G>::value * 4;
  static_assert(2 * kWarps * G * 4 + kWarps * G * D * 4 <= Sh::RING,
                "the warps' partials must fit in the ring");
  static bool opted = false;   // once an instance (and never in a capture)
  if (!opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_partial<T, D, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  decode_attn_partial<T, D, G><<<dim3(n_split, Hkv, B), kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, S, Hkv, window, scale, n_split,
      m_part, l_part, acc_part);
  decode_attn_combine<T><<<dim3(Hkv, B), kThreads, 0, st>>>(
      m_part, l_part, acc_part, Hkv, G, D, n_split, static_cast<T*>(out));
  return (int)cudaGetLastError();
}

typedef int (*launch_fn)(const void*, const void*, const void*,
                         const int32_t*, int, int, int, int, float, int,
                         float*, float*, float*, void*, cudaStream_t);

template <typename T, int D>
launch_fn pick_g(int G) {
  switch (G) {
    case 1: return launch<T, D, 1>;
    case 2: return launch<T, D, 2>;
    case 3: return launch<T, D, 3>;
    case 4: return launch<T, D, 4>;
    case 5: return launch<T, D, 5>;
    case 6: return launch<T, D, 6>;
    case 7: return launch<T, D, 7>;
    case 8: return launch<T, D, 8>;
    default: return nullptr;
  }
}

template <typename T>
launch_fn pick(int D, int G) {
  switch (D) {
    case 16: return pick_g<T, 16>(G);
    case 64: return pick_g<T, 64>(G);
    case 128: return pick_g<T, 128>(G);
    case 256: return pick_g<T, 256>(G);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// q (B, Hkv * G, D), k / v (B, S, Hkv, D) of one dtype (bf16 when is_bf16,
// else f32), lengths (B,) int32; window < 0 means none.  m_part / l_part
// (B, Hkv, n_split, G) and acc_part (B, Hkv, n_split, G, D) f32 scratch;
// out (B, Hkv * G, D) in q's dtype.
int da_decode_attn(const void* q, const void* k, const void* v,
                   const int32_t* lengths, int B, int S, int Hkv, int G, int D,
                   int is_bf16, int window, float scale, int n_split,
                   float* m_part, float* l_part, float* acc_part, void* out,
                   void* stream) {
  if (G < 1 || G > kGMax || B < 1 || S < 1 || Hkv < 1 || n_split < 1 ||
      n_split > 65535 || Hkv > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const launch_fn fn =
      is_bf16 ? pick<__nv_bfloat16>(D, G) : pick<float>(D, G);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k, v, lengths, B, S, Hkv, window, scale, n_split, m_part,
            l_part, acc_part, out, static_cast<cudaStream_t>(stream));
}

int da_max_group() { return kGMax; }

// rows of one ring stage for this (D, dtype): the tile the pieces round to
int da_tile_rows(int D, int is_bf16) {
  const int esz = is_bf16 ? 2 : 4;
  return cmax(16, cmin(128, kStageBytes / (D * esz)));
}

}  // extern "C"
