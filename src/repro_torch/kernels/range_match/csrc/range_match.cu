// The switch match-action hot path on Hopper: three CUDA kernels with a
// plain C interface (built with nvcc into a shared library, bound with
// ctypes from repro_torch/kernels/range_match/kernel.py).
//
//   range_match         replaces repro/kernels/range_match/kernel.py:
//                       range_match_pallas (_kernel)
//   range_match_spread  replaces kernel.py: range_match_spread_pallas
//                       (_kernel_spread)
//   slab_lookup         replaces kernel.py: slab_lookup_pallas
//                       (_kernel_lookup / _slab_lookup_tile)
//
// What each computes is the Pallas body's contract, not its 128-lane
// one-hot tiling: the TPU contracted one-hot matrices because dynamic
// gathers are slow there; on Hopper a gather from shared memory is the
// natural form, so every packet is one thread that indexes the tables.
//
// What bounds them on the H100, and what the design does about it:
//
// * range_match / range_match_spread are bound by the bytes of the packet
//   vectors in (matching value, opcode, two p2c draws) and the
//   (ridx, target, chain) rows out.  The tables (8 B of span a slot,
//   clen, the (r_max, S) chains, the N load registers) are a few tens of
//   KB: each block stages them once into shared memory and then walks a
//   grid-stride loop over packets, so the tables cost L2 traffic per
//   block, not per packet.  The per-packet slot match is a linear scan of
//   the shared-memory spans that stops at the first hit (the min index).
// * slab_lookup is bound by latency: a lower-bound binary search does
//   ceil(log2(C)) + 1 dependent loads from the (N, C) slab in device
//   memory.  One thread per packet keeps many searches in flight so the
//   card overlaps their latencies; a warp-cooperative search and staged
//   upper tree levels are later work.
//
// Integer conventions (shared with the plain PyTorch versions in ref.py):
// keys, matching values, targets and slab words arrive as the port's int64
// carriers of 32-bit values (8 B read where the values need 4); spans
// and load registers as the uint32 bits of int32 tensors; node, slot and
// position ids as int32.  Loads are compared as uint32, like the
// reference's routing._p2c_pick (its Pallas wrapper casts them to int32;
// the two agree below 2**31).  The p2c draws are non-negative (randint
// over [0, 2**31 - 1)), so C's truncating % equals jnp's floor-mod.
//
// Every entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t kEmptyKey = 0xFFFFFFFFull;
constexpr int kThreads = 256;

// Stage the dead-masked spans, chain lengths and transposed chains (and
// optionally the load registers) into shared memory.
struct Tables {
    const uint32_t* lo;
    const uint32_t* hi;
    const int32_t* clen;
    const int32_t* chains;   // (r_max, S)
    const uint32_t* loads;   // (n_loads,) or nullptr
};

__device__ __forceinline__ int first_hit(uint32_t v, const uint32_t* lo,
                                         const uint32_t* hi, int S) {
    for (int i = 0; i < S; ++i) {
        if (v >= lo[i] && v <= hi[i]) return i;
    }
    return S;
}

template <bool kSpread>
__global__ void range_match_kernel(
    const int64_t* __restrict__ mvals, const int32_t* __restrict__ opcodes,
    const int32_t* __restrict__ u1, const int32_t* __restrict__ u2,
    Tables t, int64_t B, int S, int r_max, int num_slots, int n_loads,
    int32_t* __restrict__ ridx_out, int32_t* __restrict__ target_out,
    int32_t* __restrict__ chain_out) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* s_lo = reinterpret_cast<uint32_t*>(smem);
    uint32_t* s_hi = s_lo + S;
    int32_t* s_clen = reinterpret_cast<int32_t*>(s_hi + S);
    int32_t* s_chain = s_clen + S;
    uint32_t* s_loads = reinterpret_cast<uint32_t*>(s_chain + r_max * S);
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
        s_lo[i] = t.lo[i];
        s_hi[i] = t.hi[i];
        s_clen[i] = t.clen[i];
    }
    for (int i = threadIdx.x; i < r_max * S; i += blockDim.x) {
        s_chain[i] = t.chains[i];
    }
    if (kSpread) {
        for (int i = threadIdx.x; i < n_loads; i += blockDim.x) {
            s_loads[i] = t.loads[i];
        }
    }
    __syncthreads();

    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < B;
         b += stride) {
        const uint32_t v = (uint32_t)(uint64_t)mvals[b];
        int r = first_hit(v, s_lo, s_hi, S);
        if (r > num_slots - 1) r = num_slots - 1;   // total miss clamps
        const int32_t op = opcodes[b];
        const bool is_write = (op == 1) || (op == 2);
        const int c = s_clen[r];
        const int32_t head = s_chain[r];
        int32_t target;
        if (kSpread) {
            const int cc = c > 1 ? c : 1;
            const int p1 = u1[b] % cc;
            const int p2 = u2[b] % cc;
            const int32_t n1 = s_chain[p1 * S + r];
            const int32_t n2 = s_chain[p2 * S + r];
            const uint32_t l1 = s_loads[n1 > 0 ? n1 : 0];
            const uint32_t l2 = s_loads[n2 > 0 ? n2 : 0];
            const int32_t picked = (l1 <= l2) ? n1 : n2;  // first pick wins ties
            target = is_write ? head : picked;
        } else {
            const int tp = c - 1 > 0 ? c - 1 : 0;
            target = is_write ? head : s_chain[tp * S + r];
        }
        ridx_out[b] = r;
        target_out[b] = target;
        for (int p = 0; p < r_max; ++p) {
            chain_out[(int64_t)p * B + b] = s_chain[p * S + r];
        }
    }
}

__global__ void slab_lookup_kernel(
    const int64_t* __restrict__ qkeys, const int64_t* __restrict__ target,
    const int64_t* __restrict__ slabs, int64_t B, int64_t N, int64_t C,
    int32_t* __restrict__ slot_out, uint8_t* __restrict__ found_out) {
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int64_t t = target[b];
    const int64_t ts = t < 0 ? 0 : (t > N - 1 ? N - 1 : t);
    const int64_t* row = slabs + ts * C;
    const int64_t q = qkeys[b];
    int64_t lo = 0, hi = C;            // bisect_left over the sorted row
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (row[mid] < q) lo = mid + 1; else hi = mid;
    }
    const int64_t slot = lo < C - 1 ? lo : C - 1;
    slot_out[b] = (int32_t)slot;
    found_out[b] = (row[slot] == q) && ((uint64_t)q != kEmptyKey) && (t >= 0);
}

size_t route_smem_bytes(int S, int r_max, int n_loads) {
    return (size_t)S * (3 + r_max) * 4 + (size_t)n_loads * 4;
}

template <bool kSpread>
int launch_route(const int64_t* mvals, const int32_t* opcodes,
                 const int32_t* u1, const int32_t* u2, Tables t, int64_t B,
                 int S, int r_max, int num_slots, int n_loads, int grid,
                 int32_t* ridx, int32_t* target, int32_t* chain,
                 cudaStream_t stream) {
    const size_t smem = route_smem_bytes(S, r_max, kSpread ? n_loads : 0);
    cudaFuncSetAttribute(range_match_kernel<kSpread>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    if (B > 0) {
        range_match_kernel<kSpread><<<grid, kThreads, smem, stream>>>(
            mvals, opcodes, u1, u2, t, B, S, r_max, num_slots, n_loads, ridx,
            target, chain);
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int rm_threads_per_block() { return kThreads; }

int rm_range_match(const void* mvals, const void* opcodes, const void* lo,
                   const void* hi, const void* chains, const void* clen,
                   int64_t B, int32_t S, int32_t r_max, int32_t num_slots,
                   int32_t grid, void* ridx, void* target, void* chain,
                   void* stream) {
    Tables t{static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
             static_cast<const int32_t*>(clen),
             static_cast<const int32_t*>(chains), nullptr};
    return launch_route<false>(
        static_cast<const int64_t*>(mvals), static_cast<const int32_t*>(opcodes),
        nullptr, nullptr, t, B, S, r_max, num_slots, 0, grid,
        static_cast<int32_t*>(ridx), static_cast<int32_t*>(target),
        static_cast<int32_t*>(chain), static_cast<cudaStream_t>(stream));
}

int rm_range_match_spread(const void* mvals, const void* opcodes,
                          const void* u1, const void* u2, const void* lo,
                          const void* hi, const void* chains, const void* clen,
                          const void* loads, int64_t B, int32_t S,
                          int32_t r_max, int32_t num_slots, int32_t n_loads,
                          int32_t grid, void* ridx, void* target, void* chain,
                          void* stream) {
    Tables t{static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
             static_cast<const int32_t*>(clen),
             static_cast<const int32_t*>(chains),
             static_cast<const uint32_t*>(loads)};
    return launch_route<true>(
        static_cast<const int64_t*>(mvals), static_cast<const int32_t*>(opcodes),
        static_cast<const int32_t*>(u1), static_cast<const int32_t*>(u2), t, B,
        S, r_max, num_slots, n_loads, grid, static_cast<int32_t*>(ridx),
        static_cast<int32_t*>(target), static_cast<int32_t*>(chain),
        static_cast<cudaStream_t>(stream));
}

int rm_slab_lookup(const void* qkeys, const void* target, const void* slabs,
                   int64_t B, int64_t N, int64_t C, void* slot, void* found,
                   void* stream) {
    if (B > 0) {
        const int64_t grid = (B + kThreads - 1) / kThreads;
        slab_lookup_kernel<<<(unsigned)grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int64_t*>(qkeys),
            static_cast<const int64_t*>(target),
            static_cast<const int64_t*>(slabs), B, N, C,
            static_cast<int32_t*>(slot), static_cast<uint8_t*>(found));
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
