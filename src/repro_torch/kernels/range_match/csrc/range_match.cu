// The switch match-action hot path on Hopper: six CUDA kernels with a
// plain C interface (built with nvcc into a shared library, bound with
// ctypes from repro_torch/kernels/range_match/kernel.py).
//
//   range_match               replaces repro/kernels/range_match/kernel.py:
//                             range_match_pallas (_kernel)
//   range_match_spread        replaces kernel.py: range_match_spread_pallas
//                             (_kernel_spread)
//   range_match_spread_dirty  replaces kernel.py:
//                             range_match_spread_dirty_pallas
//                             (_kernel_spread_dirty), plus the hashed
//                             per-key dirty filter of
//                             core/routing.py:route_load_aware_dirty,
//                             which the Pallas kernel lacks
//   range_match_apply         replaces kernel.py: range_match_apply_pallas
//                             (_kernel_apply)
//   slab_lookup               replaces kernel.py: slab_lookup_pallas
//                             (_kernel_lookup / _slab_lookup_tile)
//   range_match_stale         replaces kernel.py: range_match_stale_pallas
//                             (_kernel_stale), the per-switch table match
//                             of the replicated directory tier
//
// What each computes is the Pallas body's contract, not its 128-lane
// one-hot tiling: the TPU contracted one-hot matrices because dynamic
// gathers are slow there; on Hopper a gather from shared memory is the
// natural form, so every packet is one thread that indexes the tables.
// The four routing kernels are one template (route_kernel<kMode>), each
// mode extending the last, as the Pallas kernels share their tiles.
//
// What bounds them on the H100, and what the design does about it:
//
// * the routing kernels are bound by the bytes of the packet vectors in
//   (matching value, opcode, two p2c draws, and for the filter the raw
//   key) and the (ridx, target, chain, picked, bounced) rows out.  The
//   tables (8 B of span a slot, clen, the (r_max, S) chains, the N load
//   registers, the (r_max, S) uint8 dirty bits) are a few tens of KB:
//   each block stages them once into shared memory and then walks a
//   grid-stride loop over packets, so the tables cost L2 traffic per
//   block, not per packet.  The per-packet slot match is a linear scan of
//   the shared-memory spans that stops at the first hit (the min index).
//   The (S, F) key filter (128 KB at F = 64) is not staged: a read whose
//   pick is dirty loads its one filter byte from device memory (L2).
// * slab_lookup, and the probe that range_match_apply adds, are bound by
//   latency: a lower-bound binary search does ceil(log2(C)) + 1 dependent
//   loads from the (N, C) slab in device memory.  One thread per packet
//   keeps many searches in flight so the card overlaps their latencies.
//   Both kernels call the one __device__ probe_slab.
// * range_match_stale is bound like the routing kernels, by the packet
//   vectors and the W switches' tables.  Its W copies at full width (lo,
//   hi, clen, version, chains, committed: 270 KB at W = 4, S = 2,048,
//   r_max = 4) exceed a block's shared memory, so a block stages only the
//   W copies of the spans (8 W S bytes) and reads the matched slot's
//   chain word, clen, version and committed word from device memory.  The
//   ingress switch and, under hash partitioning, the matching value are
//   the reference's hash_key of the raw key, computed in the kernel.
//
// Integer conventions (shared with the plain PyTorch versions in ref.py):
// keys, matching values, targets and slab words arrive as the port's int64
// carriers of 32-bit values (8 B read where the values need 4); spans
// and load registers as the uint32 bits of int32 tensors; node, slot and
// position ids as int32; dirty bits, filter bits and the bool outputs as
// one byte each.  Loads are compared as uint32, like the reference's
// routing._p2c_pick (its Pallas wrapper casts them to int32; the two agree
// below 2**31).  The p2c draws are non-negative (randint over
// [0, 2**31 - 1)), so C's truncating % equals jnp's floor-mod.
//
// Every entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t kEmptyKey = 0xFFFFFFFFull;
constexpr int kThreads = 256;

// route_kernel modes, each one the previous plus more
constexpr int kTail = 0;     // K1: reads at the chain tail
constexpr int kSpread = 1;   // K2: p2c read pick over the load registers
constexpr int kDirty = 2;    // K3: CRAQ tail bounce of dirty picks
constexpr int kApply = 3;    // K4b: K3 then the slab probe

// The tables every block stages into shared memory.
struct Tables {
    const uint32_t* lo;
    const uint32_t* hi;
    const int32_t* clen;
    const int32_t* chains;   // (r_max, S)
    const uint32_t* loads;   // (n_loads,), from kSpread on
    const uint8_t* dirty;    // (r_max, S), from kDirty on
};

// Per-packet inputs besides the tables.
struct Packets {
    const int64_t* mvals;
    const int32_t* opcodes;
    const int32_t* u1;
    const int32_t* u2;
    const int64_t* keys;         // raw keys (B,): the filter's with F > 0,
                                 // the probe's in kApply
    const uint8_t* key_filter;   // kDirty with F > 0: (S, F)
    int F;
    const int64_t* slabs;        // kApply: (N, C) sorted rows
    int64_t N;
    int64_t C;
};

struct Outputs {
    int32_t* ridx;
    int32_t* target;
    int32_t* chain;      // (r_max, B)
    int32_t* picked;     // from kDirty on
    uint8_t* bounced;    // from kDirty on
    int32_t* slot;       // kApply
    uint8_t* found;      // kApply
};

__device__ __forceinline__ int first_hit(uint32_t v, const uint32_t* lo,
                                         const uint32_t* hi, int S) {
    for (int i = 0; i < S; ++i) {
        if (v >= lo[i] && v <= hi[i]) return i;
    }
    return S;
}

// The reference's keys.hash_key: two rounds of the murmur3 fmix32 mixer.
__device__ __forceinline__ uint32_t hash_key(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7FEB352Du;
    x ^= x >> 15;
    x *= 0x846CA68Bu;
    x ^= x >> 16;
    x *= 0x9E3779B1u;
    x ^= x >> 16;
    return x;
}

// bisect_left of q in row clip(t, 0, N-1) of the sorted (N, C) slabs, the
// position clamped into [0, C), and the hit (off for EMPTY keys and
// unrouted packets).
__device__ __forceinline__ void probe_slab(const int64_t* __restrict__ slabs,
                                           int64_t N, int64_t C, int64_t q,
                                           int64_t t, int32_t* slot,
                                           uint8_t* found) {
    const int64_t ts = t < 0 ? 0 : (t > N - 1 ? N - 1 : t);
    const int64_t* row = slabs + ts * C;
    int64_t lo = 0, hi = C;
    while (lo < hi) {
        const int64_t mid = (lo + hi) >> 1;
        if (row[mid] < q) lo = mid + 1; else hi = mid;
    }
    const int64_t s = lo < C - 1 ? lo : C - 1;
    *slot = (int32_t)s;
    *found = (row[s] == q) && ((uint64_t)q != kEmptyKey) && (t >= 0);
}

template <int kMode>
__global__ void route_kernel(Packets in, Tables t, int64_t B, int S,
                             int r_max, int num_slots, int n_loads,
                             Outputs out) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint32_t* s_lo = reinterpret_cast<uint32_t*>(smem);
    uint32_t* s_hi = s_lo + S;
    int32_t* s_clen = reinterpret_cast<int32_t*>(s_hi + S);
    int32_t* s_chain = s_clen + S;
    uint32_t* s_loads = reinterpret_cast<uint32_t*>(s_chain + r_max * S);
    uint8_t* s_dirty = reinterpret_cast<uint8_t*>(
        s_loads + (kMode >= kSpread ? n_loads : 0));
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
        s_lo[i] = t.lo[i];
        s_hi[i] = t.hi[i];
        s_clen[i] = t.clen[i];
    }
    for (int i = threadIdx.x; i < r_max * S; i += blockDim.x) {
        s_chain[i] = t.chains[i];
        if (kMode >= kDirty) s_dirty[i] = t.dirty[i];
    }
    if (kMode >= kSpread) {
        for (int i = threadIdx.x; i < n_loads; i += blockDim.x) {
            s_loads[i] = t.loads[i];
        }
    }
    __syncthreads();

    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < B;
         b += stride) {
        const uint32_t v = (uint32_t)(uint64_t)in.mvals[b];
        int r = first_hit(v, s_lo, s_hi, S);
        if (r > num_slots - 1) r = num_slots - 1;   // total miss clamps
        const int32_t op = in.opcodes[b];
        const bool is_write = (op == 1) || (op == 2);
        const int c = s_clen[r];
        const int32_t head = s_chain[r];
        const int tp = c - 1 > 0 ? c - 1 : 0;
        const int32_t tail = s_chain[tp * S + r];
        int32_t target;
        if (kMode == kTail) {
            target = is_write ? head : tail;
        } else {
            const int cc = c > 1 ? c : 1;
            const int p1 = in.u1[b] % cc;
            const int p2 = in.u2[b] % cc;
            const int32_t n1 = s_chain[p1 * S + r];
            const int32_t n2 = s_chain[p2 * S + r];
            const uint32_t l1 = s_loads[n1 > 0 ? n1 : 0];
            const uint32_t l2 = s_loads[n2 > 0 ? n2 : 0];
            const bool first = l1 <= l2;                  // first pick wins ties
            const int32_t picked = first ? n1 : n2;
            int32_t read_target = picked;
            if (kMode >= kDirty) {
                const int ppos = first ? p1 : p2;
                // a dirty non-tail pick of a real node bounces a read to the
                // tail; with the filter, only if the key's bit is set too
                bool bounce = !is_write && picked >= 0 && ppos != c - 1 &&
                              s_dirty[ppos * S + r] != 0;
                if (bounce && in.F > 0) {
                    const uint32_t hb =
                        hash_key((uint32_t)(uint64_t)in.keys[b]) % (uint32_t)in.F;
                    bounce = in.key_filter[(int64_t)r * in.F + hb] != 0;
                }
                if (bounce) read_target = tail;
                out.picked[b] = picked;
                out.bounced[b] = bounce;
            }
            target = is_write ? head : read_target;
        }
        out.ridx[b] = r;
        out.target[b] = target;
        for (int p = 0; p < r_max; ++p) {
            out.chain[(int64_t)p * B + b] = s_chain[p * S + r];
        }
        if (kMode == kApply) {   // in.keys holds the query keys here
            probe_slab(in.slabs, in.N, in.C, in.keys[b], target, &out.slot[b],
                       &out.found[b]);
        }
    }
}

// K5: each packet matches against its ingress switch's private copy of
// the spans.  The W copies' spans are staged slot-major, one (lo, hi) pair
// per (slot, switch): the threads of a warp scan the rows of different
// switches in step, so at each slot they read W neighbouring 8-byte words
// (no bank conflict) instead of W words one row (a multiple of 32 words)
// apart.  After the match, the packet's one chain word, clen, version and
// committed word come from device memory (the tables are L2-resident).
__global__ void stale_kernel(const int64_t* __restrict__ keys,
                             const int32_t* __restrict__ opcodes,
                             const uint32_t* __restrict__ lo_w,
                             const uint32_t* __restrict__ hi_w,
                             const int32_t* __restrict__ chains_w,
                             const int32_t* __restrict__ clen_w,
                             const int32_t* __restrict__ version_w,
                             const int32_t* __restrict__ committed, int64_t B,
                             int S, int W, int r_max, int num_slots,
                             int hash_partitioned, int32_t* __restrict__ sridx,
                             int32_t* __restrict__ server,
                             uint8_t* __restrict__ divergent) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint2* s_span = reinterpret_cast<uint2*>(smem);   // (S, W) of (lo, hi)
    for (int j = threadIdx.x; j < W * S; j += blockDim.x) {
        const int w = j / S, i = j - w * S;
        s_span[i * W + w] = make_uint2(lo_w[j], hi_w[j]);
    }
    __syncthreads();

    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < B;
         b += stride) {
        const uint32_t key = (uint32_t)(uint64_t)keys[b];
        const uint32_t h = hash_key(key);
        const int w = (int)(h % (uint32_t)W);             // ingress switch
        const uint32_t v = hash_partitioned ? h : key;    // matching value
        int r = S;
        for (int i = 0; i < S; ++i) {
            const uint2 sp = s_span[i * W + w];
            if (v >= sp.x && v <= sp.y) { r = i; break; }
        }
        if (r > num_slots - 1) r = num_slots - 1;   // total miss clamps
        const int32_t op = opcodes[b];
        const bool is_write = (op == 1) || (op == 2);
        const int64_t ws = (int64_t)w * S + r;
        const int c = clen_w[ws];
        const int pos = is_write ? 0 : (c - 1 > 0 ? c - 1 : 0);
        sridx[b] = r;
        server[b] = chains_w[((int64_t)w * r_max + pos) * S + r];
        divergent[b] = version_w[ws] != committed[r];
    }
}

__global__ void slab_lookup_kernel(
    const int64_t* __restrict__ qkeys, const int64_t* __restrict__ target,
    const int64_t* __restrict__ slabs, int64_t B, int64_t N, int64_t C,
    int32_t* __restrict__ slot_out, uint8_t* __restrict__ found_out) {
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    probe_slab(slabs, N, C, qkeys[b], target[b], &slot_out[b], &found_out[b]);
}

template <int kMode>
int launch_route(const Packets& in, const Tables& t, int64_t B, int S,
                 int r_max, int num_slots, int n_loads, int grid,
                 const Outputs& out, cudaStream_t stream) {
    size_t smem = (size_t)S * (3 + r_max) * 4;
    if (kMode >= kSpread) smem += (size_t)n_loads * 4;
    if (kMode >= kDirty) smem += (size_t)r_max * S;
    cudaFuncSetAttribute(route_kernel<kMode>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    if (B > 0) {
        route_kernel<kMode><<<grid, kThreads, smem, stream>>>(
            in, t, B, S, r_max, num_slots, n_loads, out);
    }
    return (int)cudaGetLastError();
}

Tables tables(const void* lo, const void* hi, const void* chains,
              const void* clen, const void* loads, const void* dirty) {
    return Tables{static_cast<const uint32_t*>(lo),
                  static_cast<const uint32_t*>(hi),
                  static_cast<const int32_t*>(clen),
                  static_cast<const int32_t*>(chains),
                  static_cast<const uint32_t*>(loads),
                  static_cast<const uint8_t*>(dirty)};
}

}  // namespace

extern "C" {

int rm_threads_per_block() { return kThreads; }

int rm_range_match(const void* mvals, const void* opcodes, const void* lo,
                   const void* hi, const void* chains, const void* clen,
                   int64_t B, int32_t S, int32_t r_max, int32_t num_slots,
                   int32_t grid, void* ridx, void* target, void* chain,
                   void* stream) {
    Packets in{static_cast<const int64_t*>(mvals),
               static_cast<const int32_t*>(opcodes)};
    Outputs out{static_cast<int32_t*>(ridx), static_cast<int32_t*>(target),
                static_cast<int32_t*>(chain)};
    return launch_route<kTail>(in, tables(lo, hi, chains, clen, nullptr, nullptr),
                               B, S, r_max, num_slots, 0, grid, out,
                               static_cast<cudaStream_t>(stream));
}

int rm_range_match_spread(const void* mvals, const void* opcodes,
                          const void* u1, const void* u2, const void* lo,
                          const void* hi, const void* chains, const void* clen,
                          const void* loads, int64_t B, int32_t S,
                          int32_t r_max, int32_t num_slots, int32_t n_loads,
                          int32_t grid, void* ridx, void* target, void* chain,
                          void* stream) {
    Packets in{static_cast<const int64_t*>(mvals),
               static_cast<const int32_t*>(opcodes),
               static_cast<const int32_t*>(u1), static_cast<const int32_t*>(u2)};
    Outputs out{static_cast<int32_t*>(ridx), static_cast<int32_t*>(target),
                static_cast<int32_t*>(chain)};
    return launch_route<kSpread>(in, tables(lo, hi, chains, clen, loads, nullptr),
                                 B, S, r_max, num_slots, n_loads, grid, out,
                                 static_cast<cudaStream_t>(stream));
}

// keys / key_filter may be null when F == 0
int rm_range_match_spread_dirty(
    const void* mvals, const void* opcodes, const void* u1, const void* u2,
    const void* lo, const void* hi, const void* chains, const void* clen,
    const void* loads, const void* dirty, const void* keys,
    const void* key_filter, int64_t B, int32_t S, int32_t r_max,
    int32_t num_slots, int32_t n_loads, int32_t F, int32_t grid, void* ridx,
    void* target, void* chain, void* picked, void* bounced, void* stream) {
    Packets in{static_cast<const int64_t*>(mvals),
               static_cast<const int32_t*>(opcodes),
               static_cast<const int32_t*>(u1), static_cast<const int32_t*>(u2),
               static_cast<const int64_t*>(keys),
               static_cast<const uint8_t*>(key_filter), F};
    Outputs out{static_cast<int32_t*>(ridx), static_cast<int32_t*>(target),
                static_cast<int32_t*>(chain), static_cast<int32_t*>(picked),
                static_cast<uint8_t*>(bounced)};
    return launch_route<kDirty>(in, tables(lo, hi, chains, clen, loads, dirty),
                                B, S, r_max, num_slots, n_loads, grid, out,
                                static_cast<cudaStream_t>(stream));
}

int rm_range_match_apply(
    const void* mvals, const void* opcodes, const void* u1, const void* u2,
    const void* lo, const void* hi, const void* chains, const void* clen,
    const void* loads, const void* dirty, const void* qkeys, const void* slabs,
    int64_t B, int32_t S, int32_t r_max, int32_t num_slots, int32_t n_loads,
    int64_t N, int64_t C, int32_t grid, void* ridx, void* target, void* chain,
    void* picked, void* bounced, void* slot, void* found, void* stream) {
    Packets in{static_cast<const int64_t*>(mvals),
               static_cast<const int32_t*>(opcodes),
               static_cast<const int32_t*>(u1), static_cast<const int32_t*>(u2),
               static_cast<const int64_t*>(qkeys), nullptr, 0,
               static_cast<const int64_t*>(slabs), N, C};
    Outputs out{static_cast<int32_t*>(ridx), static_cast<int32_t*>(target),
                static_cast<int32_t*>(chain), static_cast<int32_t*>(picked),
                static_cast<uint8_t*>(bounced), static_cast<int32_t*>(slot),
                static_cast<uint8_t*>(found)};
    return launch_route<kApply>(in, tables(lo, hi, chains, clen, loads, dirty),
                                B, S, r_max, num_slots, n_loads, grid, out,
                                static_cast<cudaStream_t>(stream));
}

// The shared memory a block of this device may opt in to (the wrapper
// refuses K5's staged spans above it).
int rm_max_smem_optin(int device) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    return v;
}

int rm_range_match_stale(const void* keys, const void* opcodes,
                         const void* lo_w, const void* hi_w,
                         const void* chains_w, const void* clen_w,
                         const void* version_w, const void* committed,
                         int64_t B, int32_t S, int32_t W, int32_t r_max,
                         int32_t num_slots, int32_t hash_partitioned,
                         int32_t grid, void* sridx, void* server,
                         void* divergent, void* stream) {
    const size_t smem = (size_t)W * S * sizeof(uint2);
    cudaFuncSetAttribute(stale_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    if (B > 0) {
        stale_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const int64_t*>(keys),
            static_cast<const int32_t*>(opcodes),
            static_cast<const uint32_t*>(lo_w),
            static_cast<const uint32_t*>(hi_w),
            static_cast<const int32_t*>(chains_w),
            static_cast<const int32_t*>(clen_w),
            static_cast<const int32_t*>(version_w),
            static_cast<const int32_t*>(committed), B, S, W, r_max, num_slots,
            hash_partitioned, static_cast<int32_t*>(sridx),
            static_cast<int32_t*>(server), static_cast<uint8_t*>(divergent));
    }
    return (int)cudaGetLastError();
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
