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
//   tables (clen, the (r_max, S) chains, the N load registers, the
//   (r_max, S) uint8 dirty bits) are a few tens of KB: each block stages
//   them once into shared memory and then walks a grid-stride loop over
//   packets, so the tables cost L2 traffic per block, not per packet.
//   The staging is asynchronous (cp.async, 16 bytes a copy where the
//   addresses allow it): a block issues every table's copies, then waits
//   once, so it pays about one L2 round trip and not one a loop step.
//   The (S, F) key filter (128 KB at F = 64) is not staged: a read whose
//   pick is dirty loads its one filter byte from device memory (L2).
// * the slot match is a search of a sorted span table.  A linear scan of
//   the S spans that stops at the first hit keeps a warp until its last
//   lane has found its slot: about S dependent shared-memory iterations a
//   packet.  Instead each call runs two kernels.  span_order, over the
//   whole grid, writes the live spans (lo <= hi as uint32; dead slots
//   carry lo = MAX_KEY > hi = 0) in (lo, slot id) order into a scratch
//   buffer the wrapper allocates: a warp per slot counts its rank, the
//   live spans before it in that order, its lanes striding over tiles of
//   the spans staged in shared memory and summed with a warp reduction
//   (S^2 compares, no atomics, deterministic).  route_kernel is launched
//   as its programmatic dependent (Hopper's PDL; K4b excepted, see
//   launch_route): its blocks start while span_order runs, stage the
//   tables that do not depend on it, and wait for it only before they
//   stage the sorted (lo, hi) pairs and 16-bit slot ids.  (A table of at
//   most 256 slots skips span_order: each route block ranks its slots
//   itself, a thread a slot.)  Each block then checks adjacent entries
//   for overlap.  Where the live spans are disjoint, as a
//   controller's directory always is, exactly one span can hold a value:
//   an upper-bound binary search over the sorted lo finds it in
//   ceil(log2(n_live)) shared loads.  Where they are not (a malformed
//   table), the block takes an exhaustive pass over the staged spans,
//   keeping the lowest slot id among the hits: the reference's lookup
//   contract, the lowest-index hit, holds on every table.  Block 0
//   records which pass ran in the scratch.
// * slab_lookup, and the probe that range_match_apply adds, are bound by
//   latency: a lower-bound binary search does ceil(log2(C)) + 1 dependent
//   loads from the (N, C) slab in device memory.  One thread per packet
//   keeps many searches in flight so the card overlaps their latencies.
//   Both kernels call the one __device__ probe_slab.
// * range_match_stale is bound like the routing kernels, by the packet
//   vectors and the W switches' tables, and matches as they do, over a
//   sorted span table per switch copy.  span_order runs over a (slot,
//   copy) grid, each copy ranked over its own slots only, into W tables of
//   the wrapper's scratch.  stale_kernel then stages the W sorted tables'
//   (lo, hi) pairs with cp.async, waits once, and checks each copy's
//   adjacent entries for overlap on its own, so a malformed or rogue copy
//   takes the exhaustive pass alone and the disjoint copies keep the
//   binary search.  Each block keeps each copy's live count and pass in
//   a word of shared memory after the spans (block 0 also records the pass
//   in the copy's header): 8 W S + 4 W bytes, the linear scan's 8 W S and
//   a word a copy.  The 16-bit slot ids stay in the scratch (L2): a packet
//   reads the one id its search lands on.  The search kernel launches
//   plainly after span_order: it has nothing to stage before the order is
//   written, and as span_order's programmatic dependent it measured no
//   faster.  After the match, the packet's one chain word, clen, version
//   and committed word come from device memory (the tables are
//   L2-resident).  The ingress switch and, under hash partitioning, the
//   matching value are the reference's hash_key of the raw key, computed
//   in the kernel.
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
// (the route entries and range_match_stale take the wrapper's scratch for
// the sorted span tables) and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint64_t kEmptyKey = 0xFFFFFFFFull;
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

// The match pass a route call took, as block 0 records it.
constexpr uint32_t kSearch = 1;
constexpr uint32_t kExhaustive = 2;

// route_kernel modes, each one the previous plus more
constexpr int kTail = 0;     // K1: reads at the chain tail
constexpr int kSpread = 1;   // K2: p2c read pick over the load registers
constexpr int kDirty = 2;    // K3: CRAQ tail bounce of dirty picks
constexpr int kApply = 3;    // K4b: K3 then the slab probe

// span_order's output in the wrapper's scratch (order_bytes(S, W)
// bytes) for W copies of S slots (one for the route kernels): a 16-byte
// header a copy, then each copy's live spans in (lo, slot id) order as
// (lo, hi) pairs, copy w's from entry w * S, then their slot ids likewise.
struct Order {
    uint32_t* header;   // 4 words a copy: [0] live spans; [1] the match
                        // pass block 0 took
    uint2* span;        // (W, S), the first header[0] entries of a copy
    uint16_t* id;       // (W, S)
};

size_t order_bytes(int S, int W) {
    return (size_t)W * (16 + (size_t)S * (sizeof(uint2) + 2));
}

Order order_of(void* scratch, int S, int W) {
    unsigned char* base = static_cast<unsigned char*>(scratch);
    const size_t spans = 16 * (size_t)W;
    return Order{reinterpret_cast<uint32_t*>(base),
                 reinterpret_cast<uint2*>(base + spans),
                 reinterpret_cast<uint16_t*>(base + spans + (size_t)W * S * 8)};
}

// copy w's table of an Order over copies of S slots
__host__ __device__ __forceinline__ Order copy_of(Order o, int S, int w) {
    return Order{o.header + 4 * w, o.span + (size_t)w * S,
                 o.id + (size_t)w * S};
}

// route_kernel's shared memory: byte offsets of its tables, each on a
// 16-byte boundary, and the total.
struct RouteSmem {
    size_t span, chain, clen, loads, id, dirty, bytes;
};

__host__ __device__ __forceinline__ size_t align16(size_t x) {
    return (x + 15) & ~size_t(15);
}

__host__ __device__ __forceinline__ RouteSmem route_smem(int mode, int S,
                                                         int r_max,
                                                         int n_loads) {
    RouteSmem m;
    m.span = 0;
    m.chain = align16(m.span + (size_t)S * sizeof(uint2));
    m.clen = align16(m.chain + (size_t)r_max * S * 4);
    m.loads = align16(m.clen + (size_t)S * 4);
    m.id = align16(m.loads + (mode >= kSpread ? (size_t)n_loads * 4 : 0));
    m.dirty = align16(m.id + (size_t)S * 2);
    m.bytes = align16(m.dirty + (mode >= kDirty ? (size_t)r_max * S : 0));
    return m;
}

// The tables every block stages into shared memory.
struct Tables {
    Order order;
    const uint32_t* lo;      // the raw spans where the block orders them
    const uint32_t* hi;      // itself (S <= kThreads), else null
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

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The block copies n bytes from global src to shared dst: cp.async of 16
// bytes while both addresses are 16-byte aligned, of 4 while they are
// 4-byte aligned, and the last bytes plainly.  The caller waits for the
// copies (cp_async_wait_all) and then synchronises the block.
__device__ __forceinline__ void stage(void* dst, const void* src, int64_t n) {
    const unsigned char* s = static_cast<const unsigned char*>(src);
    unsigned char* d = static_cast<unsigned char*>(dst);
    const unsigned ds = (unsigned)__cvta_generic_to_shared(d);
    const uintptr_t both = reinterpret_cast<uintptr_t>(s) | ds;
    int64_t done = 0;
    if ((both & 15) == 0) {
        const int64_t n16 = n & ~int64_t(15);
        for (int64_t i = threadIdx.x * 16ll; i < n16; i += blockDim.x * 16ll) {
            cp_async16(ds + (unsigned)i, s + i);
        }
        done = n16;
    }
    if ((both & 3) == 0) {
        const int64_t n4 = n & ~int64_t(3);
        for (int64_t i = done + threadIdx.x * 4ll; i < n4;
             i += blockDim.x * 4ll) {
            cp_async4(ds + (unsigned)i, s + i);
        }
        done = n4 > done ? n4 : done;
    }
    for (int64_t i = done + threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
}

// The lowest slot id among the staged spans that hold v (S on a total
// miss).  Disjoint spans: an upper-bound binary search over the n sorted
// lo (a fixed ceil(log2(n)) steps), then the one candidate's hi.
// Otherwise every staged span, with no early exit: the sorted order is
// not id order.
__device__ __forceinline__ int sorted_match(uint32_t v, const uint2* span,
                                            const uint16_t* id, int n,
                                            bool disjoint, int S) {
    if (disjoint) {
        if (n == 0) return S;
        int base = 0, len = n;
        while (len > 1) {
            const int half = len >> 1;
            if (span[base + half].x <= v) base += half;
            len -= half;
        }
        const int k = base + (span[base].x <= v);   // spans with lo <= v
        return (k > 0 && v <= span[k - 1].y) ? id[k - 1] : S;
    }
    int r = S;
    for (int k = 0; k < n; ++k) {
        const uint2 sp = span[k];
        if (v >= sp.x && v <= sp.y && id[k] < r) r = id[k];
    }
    return r;
}

// A warp per slot: the rank of each live span in (lo, slot id) order,
// counted over all S slots, and its (lo, hi, id) written at that rank.
// With kCopies (K5) the grid's y index is the copy: lo, hi and the order
// are copy-major, and a copy is ranked over its own slots only.  The route
// kernels' one table takes the instance without it, which computes no
// per-copy offsets.
// The block stages the spans kOrderTile at a time; each lane counts over
// its stride of a tile and the warp sums the counts at the end.  Slot 0's
// warp also writes the live count.  Each block lets the route kernel
// launch as soon as it starts (PDL), since the route kernel waits for the
// whole grid before it reads the order.
constexpr int kOrderThreads = 512;   // 16 slots a block
constexpr int kOrderTile = 2048;     // 16 KB of (lo, hi) a tile

template <bool kCopies>
__global__ void __launch_bounds__(kOrderThreads)
span_order_kernel(const uint32_t* __restrict__ lo,
                  const uint32_t* __restrict__ hi, int S, Order o) {
    __shared__ __align__(16) uint32_t s_lo[kOrderTile];
    __shared__ __align__(16) uint32_t s_hi[kOrderTile];
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    if constexpr (kCopies) {
        lo += (size_t)blockIdx.y * S;
        hi += (size_t)blockIdx.y * S;
        o = copy_of(o, S, blockIdx.y);
    }
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * (kOrderThreads / 32) + (threadIdx.x >> 5);
    const uint32_t lo_i = i < S ? lo[i] : 1u;      // past S: dead
    const uint32_t hi_i = i < S ? hi[i] : 0u;
    const bool live_i = lo_i <= hi_i;
    const bool counts = live_i || i == 0;          // warp-uniform
    unsigned rank = 0, n_live = 0;
    for (int t0 = 0; t0 < S; t0 += kOrderTile) {
        const int n = S - t0 < kOrderTile ? S - t0 : kOrderTile;
        if (t0 > 0) __syncthreads();                // the last tile is read
        stage(s_lo, lo + t0, 4ll * n);
        stage(s_hi, hi + t0, 4ll * n);
        cp_async_wait_all();
        __syncthreads();
        if (!counts) continue;
#pragma unroll 4
        for (int k = lane; k < n; k += 32) {
            const uint32_t lo_j = s_lo[k];
            const bool live_j = lo_j <= s_hi[k];
            rank += live_j && (lo_j < lo_i || (lo_j == lo_i && t0 + k < i));
            n_live += live_j;
        }
    }
    if (!counts) return;
    rank = __reduce_add_sync(0xFFFFFFFFu, rank);
    n_live = __reduce_add_sync(0xFFFFFFFFu, n_live);
    if (lane == 0) {
        if (live_i) {
            o.span[rank] = make_uint2(lo_i, hi_i);
            o.id[rank] = (uint16_t)i;
        }
        if (i == 0) o.header[0] = n_live;
    }
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
    const RouteSmem m = route_smem(kMode, S, r_max, n_loads);
    uint2* s_span = reinterpret_cast<uint2*>(smem + m.span);
    int32_t* s_chain = reinterpret_cast<int32_t*>(smem + m.chain);
    int32_t* s_clen = reinterpret_cast<int32_t*>(smem + m.clen);
    uint32_t* s_loads = reinterpret_cast<uint32_t*>(smem + m.loads);
    uint16_t* s_id = reinterpret_cast<uint16_t*>(smem + m.id);
    uint8_t* s_dirty = smem + m.dirty;
    // the tables that do not depend on span_order first, then (after it
    // has finished: a no-op unless launched as its dependent) the order
    stage(s_chain, t.chains, 4ll * r_max * S);
    stage(s_clen, t.clen, 4ll * S);
    if (kMode >= kSpread) stage(s_loads, t.loads, 4ll * n_loads);
    if (kMode >= kDirty) stage(s_dirty, t.dirty, (int64_t)r_max * S);
    int n_live;
    if (t.lo != nullptr) {
        // a table of at most kThreads slots, ordered by the block itself
        // (no span_order launch): thread k ranks slot k over the staged
        // spans as span_order does, then writes it at its rank over them
        const int k = threadIdx.x;
        const uint32_t lo_k = k < S ? t.lo[k] : 1u, hi_k = k < S ? t.hi[k] : 0u;
        if (k < S) s_span[k] = make_uint2(lo_k, hi_k);
        cp_async_wait_all();
        __syncthreads();
        const bool live_k = lo_k <= hi_k;
        int rank = 0;
        for (int j = 0; live_k && j < S; ++j) {
            const uint2 sp = s_span[j];
            rank += sp.x <= sp.y && (sp.x < lo_k || (sp.x == lo_k && j < k));
        }
        n_live = __syncthreads_count(live_k);   // every span read first
        if (live_k) {
            s_span[rank] = make_uint2(lo_k, hi_k);
            s_id[rank] = (uint16_t)k;
        }
        __syncthreads();
        if (blockIdx.x == 0) {   // the table span_order would have written
            if (k < n_live) {
                t.order.span[k] = s_span[k];
                t.order.id[k] = s_id[k];
            }
            if (k == 0) t.order.header[0] = (uint32_t)n_live;
        }
    } else {
        asm volatile("griddepcontrol.wait;" ::: "memory");
        n_live = (int)t.order.header[0];
        stage(s_span, t.order.span, 8ll * n_live);
        stage(s_id, t.order.id, 2ll * n_live);
        cp_async_wait_all();
        __syncthreads();
    }
    int overlap = 0;
    for (int k = threadIdx.x; k + 1 < n_live; k += blockDim.x) {
        overlap |= s_span[k].y >= s_span[k + 1].x;
    }
    const bool disjoint = __syncthreads_or(overlap) == 0;   // block-uniform
    if (blockIdx.x == 0 && threadIdx.x == 0) {
        t.order.header[1] = disjoint ? kSearch : kExhaustive;
    }

    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < B;
         b += stride) {
        const uint32_t v = (uint32_t)(uint64_t)in.mvals[b];
        int r = sorted_match(v, s_span, s_id, n_live, disjoint, S);
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

// K5: each packet matches against its ingress switch's copy of the spans,
// over that copy's sorted table (span_order's, copy w from entry w * S).
// The block stages the W tables' (lo, hi) pairs, waits once, and checks
// each copy for overlap: a shared word a copy gets its live count and
// pass, which its packets read back.
// After the match, the packet's one chain word, clen, version and
// committed word come from device memory (the tables are L2-resident).
__global__ void __launch_bounds__(kThreads)
stale_kernel(const int64_t* __restrict__ keys,
             const int32_t* __restrict__ opcodes, Order o,
             const int32_t* __restrict__ chains_w,
             const int32_t* __restrict__ clen_w,
             const int32_t* __restrict__ version_w,
             const int32_t* __restrict__ committed, int64_t B, int S, int W,
             int r_max, int num_slots, int hash_partitioned,
             int32_t* __restrict__ sridx, int32_t* __restrict__ server,
             uint8_t* __restrict__ divergent) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint2* s_span = reinterpret_cast<uint2*>(smem);   // (W, S) of (lo, hi)
    // a word a copy: its live count << 2 | its pass
    uint32_t* s_copy = reinterpret_cast<uint32_t*>(s_span + (size_t)W * S);
    for (int w = 0; w < W; ++w) {
        const Order c = copy_of(o, S, w);
        stage(s_span + (size_t)w * S, c.span, 8ll * c.header[0]);
    }
    cp_async_wait_all();
    __syncthreads();
    // each copy's pass, decided over its own adjacent entries
    for (int w = 0; w < W; ++w) {
        const int n = (int)o.header[4 * w];
        const uint2* sp = s_span + (size_t)w * S;
        int overlap = 0;
        for (int k = threadIdx.x; k + 1 < n; k += blockDim.x) {
            overlap |= sp[k].y >= sp[k + 1].x;
        }
        const uint32_t pass = __syncthreads_or(overlap) ? kExhaustive : kSearch;
        if (threadIdx.x == 0) {
            s_copy[w] = ((uint32_t)n << 2) | pass;
            if (blockIdx.x == 0) o.header[4 * w + 1] = pass;
        }
    }
    __syncthreads();   // the words are written before any packet reads them

    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    for (int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; b < B;
         b += stride) {
        const uint32_t key = (uint32_t)(uint64_t)keys[b];
        const uint32_t h = hash_key(key);
        const int w = (int)(h % (uint32_t)W);             // ingress switch
        const uint32_t v = hash_partitioned ? h : key;    // matching value
        const uint32_t rw = s_copy[w];
        int r = sorted_match(v, s_span + (size_t)w * S, o.id + (size_t)w * S,
                             (int)(rw >> 2), (rw & 3) == kSearch, S);
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

// Lets route_kernel<kMode> (or, for kStale, stale_kernel) opt in to all
// the shared memory a block of the current device may take, once per
// device; a launch that needs more fails and its error is returned.
constexpr int kStale = 4;

template <int kKernel>
void allow_smem() {
    static bool done[kMaxDevices];
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev < kMaxDevices && done[dev]) return;
    int optin = 0;
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if constexpr (kKernel == kStale) {
        cudaFuncSetAttribute(stale_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    } else {
        cudaFuncSetAttribute(route_kernel<kKernel>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    }
    if (dev < kMaxDevices) done[dev] = true;
}

// span_order then route_kernel<kMode>, both on the caller's stream; K1-K3
// as span_order's programmatic dependent.  A table of at most kThreads
// slots is ordered by each route block itself, in one launch: the
// serving router's 32 slots pay for one launch, as the linear scan did.  K4b is launched plainly: its
// threads each run the slab probe's 21 dependent loads, and with its
// blocks placed while span_order still held the SMs it measured 3.5 us
// slower at the full-width shape (12 % of its time), where K1-K3 gain
// 1.2 us.
template <int kMode>
int launch_route(const Packets& in, const void* lo, const void* hi,
                 Tables t, void* scratch, int64_t B, int S, int r_max,
                 int num_slots, int n_loads, int grid, const Outputs& out,
                 cudaStream_t stream) {
    allow_smem<kMode>();
    if (B > 0 && S <= kThreads) {
        t.order = order_of(scratch, S, 1);
        t.lo = static_cast<const uint32_t*>(lo);
        t.hi = static_cast<const uint32_t*>(hi);
        route_kernel<kMode><<<grid, kThreads,
                              route_smem(kMode, S, r_max, n_loads).bytes,
                              stream>>>(in, t, B, S, r_max, num_slots, n_loads,
                                        out);
    } else if (B > 0) {
        t.order = order_of(scratch, S, 1);
        span_order_kernel<false>
            <<<(S + kOrderThreads / 32 - 1) / (kOrderThreads / 32),
               kOrderThreads, 0, stream>>>(
            static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
            S, t.order);
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
        attr[0].val.programmaticStreamSerializationAllowed = 1;
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((unsigned)grid);
        cfg.blockDim = dim3(kThreads);
        cfg.dynamicSmemBytes = route_smem(kMode, S, r_max, n_loads).bytes;
        cfg.stream = stream;
        cfg.attrs = attr;
        cfg.numAttrs = kMode == kApply ? 0 : 1;
        cudaLaunchKernelEx(&cfg, route_kernel<kMode>, in, t, B, S, r_max,
                           num_slots, n_loads, out);
    }
    return (int)cudaGetLastError();
}

Tables tables(const void* chains, const void* clen, const void* loads,
              const void* dirty) {
    return Tables{Order{}, nullptr, nullptr,
                  static_cast<const int32_t*>(clen),
                  static_cast<const int32_t*>(chains),
                  static_cast<const uint32_t*>(loads),
                  static_cast<const uint8_t*>(dirty)};
}

}  // namespace

extern "C" {

int rm_threads_per_block() { return kThreads; }

// Bytes of the scratch each route entry takes for its sorted span table,
// and range_match_stale for its W tables.
int64_t rm_order_bytes(int32_t S, int32_t W) {
    return (int64_t)order_bytes(S, W);
}

// Bytes of shared memory route_kernel<mode> takes a block (the wrapper
// checks them against the device's opt-in limit before a launch).
int64_t rm_route_smem_bytes(int32_t mode, int32_t S, int32_t r_max,
                            int32_t n_loads) {
    return (int64_t)route_smem(mode, S, r_max, n_loads).bytes;
}

int rm_range_match(const void* mvals, const void* opcodes, const void* lo,
                   const void* hi, const void* chains, const void* clen,
                   int64_t B, int32_t S, int32_t r_max, int32_t num_slots,
                   int32_t grid, void* order, void* ridx, void* target,
                   void* chain, void* stream) {
    Packets in{static_cast<const int64_t*>(mvals),
               static_cast<const int32_t*>(opcodes)};
    Outputs out{static_cast<int32_t*>(ridx), static_cast<int32_t*>(target),
                static_cast<int32_t*>(chain)};
    return launch_route<kTail>(in, lo, hi,
                               tables(chains, clen, nullptr, nullptr), order,
                               B, S, r_max, num_slots, 0, grid, out,
                               static_cast<cudaStream_t>(stream));
}

int rm_range_match_spread(const void* mvals, const void* opcodes,
                          const void* u1, const void* u2, const void* lo,
                          const void* hi, const void* chains, const void* clen,
                          const void* loads, int64_t B, int32_t S,
                          int32_t r_max, int32_t num_slots, int32_t n_loads,
                          int32_t grid, void* order, void* ridx,
                          void* target, void* chain, void* stream) {
    Packets in{static_cast<const int64_t*>(mvals),
               static_cast<const int32_t*>(opcodes),
               static_cast<const int32_t*>(u1), static_cast<const int32_t*>(u2)};
    Outputs out{static_cast<int32_t*>(ridx), static_cast<int32_t*>(target),
                static_cast<int32_t*>(chain)};
    return launch_route<kSpread>(in, lo, hi,
                                 tables(chains, clen, loads, nullptr), order,
                                 B, S, r_max, num_slots, n_loads, grid, out,
                                 static_cast<cudaStream_t>(stream));
}

// keys / key_filter may be null when F == 0
int rm_range_match_spread_dirty(
    const void* mvals, const void* opcodes, const void* u1, const void* u2,
    const void* lo, const void* hi, const void* chains, const void* clen,
    const void* loads, const void* dirty, const void* keys,
    const void* key_filter, int64_t B, int32_t S, int32_t r_max,
    int32_t num_slots, int32_t n_loads, int32_t F, int32_t grid, void* order,
    void* ridx, void* target, void* chain, void* picked, void* bounced,
    void* stream) {
    Packets in{static_cast<const int64_t*>(mvals),
               static_cast<const int32_t*>(opcodes),
               static_cast<const int32_t*>(u1), static_cast<const int32_t*>(u2),
               static_cast<const int64_t*>(keys),
               static_cast<const uint8_t*>(key_filter), F};
    Outputs out{static_cast<int32_t*>(ridx), static_cast<int32_t*>(target),
                static_cast<int32_t*>(chain), static_cast<int32_t*>(picked),
                static_cast<uint8_t*>(bounced)};
    return launch_route<kDirty>(in, lo, hi,
                                tables(chains, clen, loads, dirty), order,
                                B, S, r_max, num_slots, n_loads, grid, out,
                                static_cast<cudaStream_t>(stream));
}

int rm_range_match_apply(
    const void* mvals, const void* opcodes, const void* u1, const void* u2,
    const void* lo, const void* hi, const void* chains, const void* clen,
    const void* loads, const void* dirty, const void* qkeys, const void* slabs,
    int64_t B, int32_t S, int32_t r_max, int32_t num_slots, int32_t n_loads,
    int64_t N, int64_t C, int32_t grid, void* order, void* ridx, void* target,
    void* chain, void* picked, void* bounced, void* slot, void* found,
    void* stream) {
    Packets in{static_cast<const int64_t*>(mvals),
               static_cast<const int32_t*>(opcodes),
               static_cast<const int32_t*>(u1), static_cast<const int32_t*>(u2),
               static_cast<const int64_t*>(qkeys), nullptr, 0,
               static_cast<const int64_t*>(slabs), N, C};
    Outputs out{static_cast<int32_t*>(ridx), static_cast<int32_t*>(target),
                static_cast<int32_t*>(chain), static_cast<int32_t*>(picked),
                static_cast<uint8_t*>(bounced), static_cast<int32_t*>(slot),
                static_cast<uint8_t*>(found)};
    return launch_route<kApply>(in, lo, hi,
                                tables(chains, clen, loads, dirty), order,
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

// span_order over the W copies, then stale_kernel over the sorted tables.
int rm_range_match_stale(const void* keys, const void* opcodes,
                         const void* lo_w, const void* hi_w,
                         const void* chains_w, const void* clen_w,
                         const void* version_w, const void* committed,
                         int64_t B, int32_t S, int32_t W, int32_t r_max,
                         int32_t num_slots, int32_t hash_partitioned,
                         int32_t grid, void* scratch, void* sridx,
                         void* server, void* divergent, void* stream) {
    allow_smem<kStale>();
    if (B > 0) {
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        const Order o = order_of(scratch, S, W);
        span_order_kernel<true>
            <<<dim3((S + kOrderThreads / 32 - 1) / (kOrderThreads / 32), W),
               kOrderThreads, 0, st>>>(
            static_cast<const uint32_t*>(lo_w),
            static_cast<const uint32_t*>(hi_w), S, o);
        const size_t smem = (size_t)W * S * sizeof(uint2) + 4 * (size_t)W;
        stale_kernel<<<(unsigned)grid, kThreads, smem, st>>>(
            static_cast<const int64_t*>(keys),
            static_cast<const int32_t*>(opcodes), o,
            static_cast<const int32_t*>(chains_w),
            static_cast<const int32_t*>(clen_w),
            static_cast<const int32_t*>(version_w),
            static_cast<const int32_t*>(committed), B, (int)S, (int)W,
            (int)r_max, (int)num_slots, (int)hash_partitioned,
            static_cast<int32_t*>(sridx), static_cast<int32_t*>(server),
            static_cast<uint8_t*>(divergent));
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
