// Component resolution: (B, N) labels -> per-frame label tables, the
// tables' chains and dense ranks, and tables -> per-pixel values, in six
// kernels.
//
// Replaces: the sort-centric formulation of
// isaac_ros_apriltag_tpu/ops/resolve.py (XLA, no Pallas kernel), which the
// port's twin (isaac_ros_apriltag_tpu_torch/ops/resolve.py::
// resolve_roots_rank, resolve_components) takes as it is: a stable sort of
// the N pixel keys, an int64 cumsum of group starts, a scatter and a second
// pass to compact the first R distinct labels, a seed scatter and a packed
// cummax to broadcast each group's value along the sorted stream, and an
// unsort scatter back to image order. The TPU needed that because a scatter
// serialises there (the reference's header records the measurement). Here
// labels are flat pixel indices or ranks < R, so each distinct label is an
// index into a per-frame table of S entries, and a presence table with an
// exclusive scan gives the distinct labels in the sort's order:
//
//   resolve_count_kernel  cnt[b, L] += 1 for each valid pixel labelled L in
//       [0, S), the table zeroed first by a memset on the stream: a thread
//       loads PT consecutive pixels with vector loads (a scalar instance
//       takes rows that are not so aligned), a block 256 PT pixels (PT 16
//       from 2^20 pixels a launch, else 4, so a 720p frame still fills the
//       card). Runs of one label are merged across the whole block: a run's
//       start is the last run boundary at or before it, a block max-scan of
//       the threads' last boundaries. The thread that holds a run's last
//       pixel adds its length into the block's shared-memory hash table of
//       labels (the global table if 16 probes find no slot), and the table
//       is then added to the global one, one integer atomic a distinct label
//       a block: the bench's labels change every few pixels, and a
//       component's runs in the rows a block spans share one atomic.
//       Integer atomics: the counts are exact in any order;
//   resolve_tile_sums_kernel  the present labels (cnt > 0) of each tile of
//       4096 table entries;
//   resolve_scan_kernel  many blocks a frame, one a tile: the tile's offset
//       is the sum of the tile sums before it; a warp ballot and a block
//       pass rank the tile's present labels. Writes inv[b, L] = the group
//       rank of a present label capped at R (R for an absent label and for
//       entry S), D[b, k] = the k-th present label for k < R (S past the
//       frame's group count, filled by the frame's blocks together), and
//       n_groups[b];
//   resolve_slots_kernel  one thread a slot k of the (B, R + 1) slot
//       tables (k = R the extra slot): f(k) is the slot of the label at
//       pixel D[k] (in rank mode at pixel rank_table[D[k]]), and the thread
//       follows f from k for 2^(s-1) hops, then as many again (s the chain
//       steps), which is what s pointer doublings give, f^(2^s) beside
//       f^(2^(s-1)), with no barrier across the grid: each slot's f is
//       computed by whoever needs it first and kept, +1, in a memo table
//       (zeroed by a memset on the stream; a stale 0 only means computing
//       it again). A walk stops at a fixpoint, and a walk of more than
//       R + 1 hops is on a cycle, whose length shortens the rest. The
//       contraction writes the map's table (root & 0xFFFF, R at slot R) and
//       the overflow flag; the final resolve writes each slot's root slot,
//       adds its pixel count into its root's total by integer atomics (one
//       a warp's slots of one root), and with more than R groups sums the
//       counts of slots 0 .. R - 2, which slot R - 1 takes negated;
//   resolve_dense_kernel  the final resolve, one block a frame: a root slot
//       r < R is a component when a slot maps to it (its total is positive,
//       or it is slot R - 1's root then) and eligible when its total
//       reaches the area gate; r's dense id is the eligible root slots
//       below r (D is increasing, so root slots order as the twin's root
//       labels do), by ballots and one block scan, kept in shared memory
//       as 16 bits; then the map's table, each slot's dense id through its
//       root slot (_KMAX past 32766 or gated out; slot R takes slot 65535's
//       at R = 65536), n_eligible, overflow and converged;
//   resolve_map_kernel  out[b, p] = table[b, inv[b, label[b, p]]] for a
//       valid pixel labelled in [0, S), else fill: the contraction's rank
//       image and the final resolve's dense ids, from the (B, R + 1)
//       tables of the slots and dense kernels. A thread
//       takes PT consecutive pixels as the count kernel does (vector loads
//       and stores where the rows are aligned, PT 16 from 2^20 pixels a
//       launch), gathers once a run of equal labels among them, and issues
//       its inv gathers before its table gathers; the pixel rows are read
//       and written with streaming hints, so inv and the table keep L2.
//
// Against the plain versions (ops/resolve.py::count_plain, scan_plain,
// slots_plain, dense_plain, map_plain): bit-exact, all integer.
//
// What bounds it on an H100: bytes, but for count, whose integer atomics
// bound it on labels that change every few pixels. count reads 5 B a pixel
// and writes the 4 B a table entry (the memset; the atomics then meet the
// table in L2); tile sums read the table once; scan reads it again and writes inv (4 B
// an entry) and D; map reads 5 B a pixel, writes 4 B, and gathers from inv
// and the table, which runs of equal labels keep in L1 and L2: its gathers
// are dependent (the table's index is inv's entry), so it keeps many in
// flight a thread. The slots kernel reads D, n_groups and its slots' pixel
// labels and counts once and writes its (B, R + 1) outputs; its hops are
// L2 reads of the memo, dependent, so a frame's longest chain sets its
// time. The dense kernel reads the totals and root slots once and writes
// the table; one block a frame, so at batch 1 one SM's rate bounds it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COUNT_THREADS = 256;
constexpr int COUNT_WARPS = COUNT_THREADS / 32;
constexpr int COUNT_PROBES = 16;              // hash slots a run tries before the global table
constexpr long long COUNT_BIG = 1 << 20;      // pixels a launch from which blocks take 4096
constexpr int SCAN_PER_THREAD = 16;
constexpr int SCAN_TILE = THREADS * SCAN_PER_THREAD;          // table entries a block
constexpr int32_t EDGE = -2;                 // the key beyond a block's ends: no run crosses them
constexpr int KBITS = 15;                    // dense ids: [0, 2^15) (ops/resolve.py::_KBITS)
constexpr int KMAX = (1 << KBITS) - 1;       // the dense id of a gated-out slot
constexpr int MAX_R = 1 << 16;               // slots a frame at most
constexpr int DENSE_THREADS = 1024;
constexpr int DENSE_WARPS = DENSE_THREADS / 32;
constexpr int DENSE_ROUNDS = MAX_R / DENSE_THREADS;   // root slots a thread at most
constexpr int DENSE_BATCH = 8;               // loads a thread keeps in flight

// A label's first slot in a hash table of 2^HBITS slots.
template <int HBITS>
__device__ __forceinline__ unsigned slot_of(int32_t key) {
    return ((uint32_t)key * 2654435769u) >> (32 - HBITS);
}

// PT consecutive pixels a thread (4 or 16: blocks of 1024 or 4096 pixels).
// VEC: label rows start 16-byte aligned, valid rows PT-byte aligned and N is
// a multiple of PT, so a thread's pixels are PT / 4 int4 of labels and PT
// bytes of validity in one load, or all past N.
template <bool VEC, int PT>
__global__ void __launch_bounds__(COUNT_THREADS)
resolve_count_kernel(const int32_t* __restrict__ label, const uint8_t* __restrict__ valid,
                     int32_t* __restrict__ cnt, int N, int S) {
    constexpr int TILE = COUNT_THREADS * PT;     // pixels a block
    constexpr int HS = TILE;                     // hash slots
    constexpr int HBITS = PT == 16 ? 12 : 10;
    static_assert(HS == 1 << HBITS, "a power of two slots");
    __shared__ int32_t first_key[COUNT_THREADS], last_key[COUNT_THREADS];
    __shared__ int wmax[COUNT_WARPS];
    __shared__ int32_t hkey[HS];
    __shared__ int hcnt[HS];
    const int b = blockIdx.y, t = threadIdx.x, lane = t & 31, w = t >> 5;
    const int p0 = blockIdx.x * TILE + t * PT;
    label += (size_t)b * N;
    valid += (size_t)b * N;
    cnt += (size_t)b * S;
    for (int i = t; i < HS; i += COUNT_THREADS) {
        hkey[i] = -1;
        hcnt[i] = 0;
    }
    int32_t k[PT];                               // -1: not counted
    if (VEC && p0 < N) {
        uint32_t m[PT / 4];
        if constexpr (PT == 16) {
            const uint4 v = *reinterpret_cast<const uint4*>(valid + p0);
            m[0] = v.x; m[1] = v.y; m[2] = v.z; m[3] = v.w;
        } else {
            m[0] = *reinterpret_cast<const uint32_t*>(valid + p0);
        }
#pragma unroll
        for (int q = 0; q < PT / 4; ++q) {
            const int4 a = *reinterpret_cast<const int4*>(label + p0 + 4 * q);
            const int32_t l[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
            for (int j = 0; j < 4; ++j)
                k[4 * q + j] = (m[q] >> (8 * j)) & 0xFFu && l[j] >= 0 && l[j] < S ? l[j] : -1;
        }
    } else {
#pragma unroll
        for (int j = 0; j < PT; ++j) {
            const int p = p0 + j;
            const int32_t l = p < N && valid[p] ? label[p] : -1;
            k[j] = l >= 0 && l < S ? l : -1;
        }
    }
    first_key[t] = k[0];
    last_key[t] = k[PT - 1];
    __syncthreads();
    const int32_t prev = t > 0 ? last_key[t - 1] : EDGE;
    const int32_t next = t + 1 < COUNT_THREADS ? first_key[t + 1] : EDGE;
    const int q0 = t * PT;                       // the thread's first pixel in the block
    // The last run boundary in this thread's pixels (-1: none), max-scanned
    // over the block: the start of the run that enters each thread.
    int last = -1;
#pragma unroll
    for (int j = 0; j < PT; ++j)
        if (k[j] != (j ? k[j - 1] : prev)) last = q0 + j;
    int inc = last;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int n = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc = max(inc, n);
    }
    if (lane == 31) wmax[w] = inc;
    __syncthreads();
    int start = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) start = -1;
#pragma unroll
    for (int u = 0; u < COUNT_WARPS; ++u)
        if (u < w) start = max(start, wmax[u]);
    // Each run that ends in this thread, into the block's hash table (the
    // global table when COUNT_PROBES slots are taken by other labels).
#pragma unroll
    for (int j = 0; j < PT; ++j) {
        if (k[j] != (j ? k[j - 1] : prev)) start = q0 + j;
        if (k[j] >= 0 && k[j] != (j + 1 < PT ? k[j + 1] : next)) {
            const int len = q0 + j + 1 - start;
            unsigned slot = slot_of<HBITS>(k[j]);
            int probe = 0;
            for (; probe < COUNT_PROBES; ++probe, slot = (slot + 1) & (HS - 1)) {
                const int32_t had = atomicCAS(hkey + slot, -1, k[j]);
                if (had == -1 || had == k[j]) {
                    atomicAdd(hcnt + slot, len);
                    break;
                }
            }
            if (probe == COUNT_PROBES) atomicAdd(cnt + k[j], len);
        }
    }
    __syncthreads();
    for (int i = t; i < HS; i += COUNT_THREADS)
        if (hkey[i] >= 0) atomicAdd(cnt + hkey[i], hcnt[i]);
}

// Block sum of one int a thread (THREADS threads, every thread calls it);
// every thread gets the sum.
__device__ __forceinline__ int block_sum(int v, int* buf) {
    v = __reduce_add_sync(FULL, v);
    if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
    __syncthreads();
    int s = 0;
#pragma unroll
    for (int u = 0; u < WARPS; ++u) s += buf[u];
    __syncthreads();                             // buf is free again
    return s;
}

__global__ void __launch_bounds__(THREADS)
resolve_tile_sums_kernel(const int32_t* __restrict__ cnt, int32_t* __restrict__ tile_sum,
                         int S, int tiles) {
    __shared__ int buf[WARPS];
    const int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
    cnt += (size_t)b * S;
    const int base = tile * SCAN_TILE;
    int c = 0;
#pragma unroll
    for (int j = 0; j < SCAN_PER_THREAD; ++j) {
        const int e = base + j * THREADS + t;
        c += e < S && cnt[e] > 0;
    }
    c = block_sum(c, buf);
    if (t == 0) tile_sum[(size_t)b * tiles + tile] = c;
}

__global__ void __launch_bounds__(THREADS)
resolve_scan_kernel(const int32_t* __restrict__ cnt, const int32_t* __restrict__ tile_sum,
                    int32_t* __restrict__ inv, int32_t* __restrict__ D,
                    int32_t* __restrict__ n_groups, int S, int R, int tiles) {
    __shared__ int buf[WARPS];
    __shared__ int wsum[WARPS];
    const int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x, lane = t & 31, w = t >> 5;
    cnt += (size_t)b * S;
    inv += (size_t)b * (S + 1);
    D += (size_t)b * R;
    tile_sum += (size_t)b * tiles;
    int before = 0, all = 0;                     // present labels before this tile, in all
    for (int i = t; i < tiles; i += THREADS) {
        const int v = tile_sum[i];
        all += v;
        before += i < tile ? v : 0;
    }
    int off = block_sum(before, buf);
    const int ng = block_sum(all, buf);
    const int base = tile * SCAN_TILE;
    for (int j = 0; j < SCAN_PER_THREAD; ++j) {
        const int e = base + j * THREADS + t;
        const bool present = e < S && cnt[e] > 0;
        const unsigned m = __ballot_sync(FULL, present);
        if (lane == 0) wsum[w] = __popc(m);
        __syncthreads();
        int before_w = 0, in_round = 0;
#pragma unroll
        for (int u = 0; u < WARPS; ++u) {
            const int c = wsum[u];
            before_w += u < w ? c : 0;
            in_round += c;
        }
        const int rank = off + before_w + __popc(m & ((1u << lane) - 1u));
        if (e <= S) inv[e] = present ? min(rank, R) : R;
        if (present && rank < R) D[rank] = e;
        off += in_round;
        __syncthreads();                         // wsum is written again
    }
    if (tile == 0 && t == 0) n_groups[b] = ng;
    for (int k = ng + tile * THREADS + t; k < R; k += tiles * THREADS) D[k] = S;
}

// One frame's slot tables (the pointers at its rows) and its parent map f
// over the slots [0, R]: ops/resolve.py::_slot_parents.
struct Slots {
    const int32_t* lab;          // (N,) pixel labels
    const int32_t* inv;          // (S + 1,) a label's slot
    const int32_t* D;            // (R,) a slot's label
    const int32_t* rank_table;   // (S,) in rank mode a label's pixel, else null
    int32_t* memo;               // (R + 1,) f(x) + 1, 0 where not yet known
    int N, S, R, ng;

    // f(x): the slot of the label at pixel D[x] (rank_table[D[x]] in rank
    // mode); a pixel outside [0, N) reads the sentinel label S, a label is
    // clamped to [0, S], and a slot without a group (x >= n_groups, the
    // extra slot R) points at R.
    __device__ int parent(int x) const {
        if (x >= ng || x >= R) return R;
        const int d = __ldg(D + x);
        const int p = rank_table ? __ldg(rank_table + d) : d;
        const int l = p >= 0 && p < N ? __ldg(lab + p) : S;
        return __ldg(inv + min(max(l, 0), S));
    }

    // f(x) from the memo, computed and kept there where no thread has yet.
    // The memo is read from L2 (__ldcg), since other SMs write it.
    __device__ int hop(int x) const {
        const int v = __ldcg(memo + x);
        if (v) return v - 1;
        const int f = parent(x);
        __stcg(memo + x, f + 1);
        return f;
    }

    // f^(2^e)(x), by following f: a fixpoint ends the walk; after R + 1
    // hops over the R + 1 slots without one, x lies on a cycle, and the
    // 2^e - (R + 1) hops left are taken modulo its length.
    __device__ int walk(int x, int e) const {
        const unsigned long long n = e < 63 ? 1ull << e : ~0ull;
        for (unsigned long long i = 0; i < n; ++i) {
            const int y = hop(x);
            if (y == x) return x;
            x = y;
            if (i == (unsigned long long)R && i + 1 < n) {
                unsigned long long len = 1;
                for (int z = hop(x); z != x; z = hop(z)) ++len;
                unsigned long long pw = 1 % len, sq = 2 % len;   // 2^e mod len
                for (int q = e; q > 0; q >>= 1, sq = sq * sq % len)
                    if (q & 1) pw = pw * sq % len;
                for (unsigned long long rest = (pw + len - (unsigned long long)(R + 1) % len) % len;
                     rest > 0; --rest)
                    x = hop(x);
                return x;
            }
        }
        return x;
    }
};

// One thread a slot k in [0, R] of frame blockIdx.y: half = f^(2^e)(k),
// root = f^(2^(e+1))(k). FINAL (cnt given): root[k] for k < R, and into
// acc (R + 2 a frame: the root slots' totals, the counts of slots
// 0 .. R - 2 when n_groups > R, an unconverged flag) the slot's pixel
// count at its root slot (not for root R, and not slot R - 1's when
// n_groups > R). Else the contraction's map table, root & 0xFFFF (R at
// slot R), and ovf[b] = n_groups > R.
template <bool FINAL>
__global__ void __launch_bounds__(THREADS)
resolve_slots_kernel(const int32_t* __restrict__ lab, const int32_t* __restrict__ inv,
                     const int32_t* __restrict__ D, const int32_t* __restrict__ n_groups,
                     const int32_t* __restrict__ rank_table, const int32_t* __restrict__ cnt,
                     int32_t* memo, int32_t* __restrict__ out, int32_t* acc,
                     uint8_t* __restrict__ ovf, int N, int S, int R, int e) {
    const int b = blockIdx.y, k = blockIdx.x * THREADS + threadIdx.x, lane = threadIdx.x & 31;
    const int ng = n_groups[b];
    const Slots s{lab + (size_t)b * N, inv + (size_t)b * (S + 1), D + (size_t)b * R,
                  rank_table ? rank_table + (size_t)b * S : nullptr, memo + (size_t)b * (R + 1),
                  N, S, R, ng};
    const bool live = k <= R;
    int half = R, root = R;
    if (live) {
        half = s.walk(k, e);
        root = s.walk(half, e);
    }
    if constexpr (!FINAL) {
        if (live) out[(size_t)b * (R + 1) + k] = k == R ? R : root & 0xFFFF;
        if (k == 0) ovf[b] = ng > R;
    } else {
        acc += (size_t)b * (R + 2);
        if (k < R) {
            out[(size_t)b * R + k] = root;
            if (half != root) acc[R + 1] = 1;
        }
        const bool over = ng > R;
        const int c = k < R && k < ng ? cnt[(size_t)b * S + __ldg(s.D + k)] : 0;
        const bool adds = c != 0 && root < R && !(over && k == R - 1);
        // The warp's slots of one root add once.
        const unsigned peers = __match_any_sync(FULL, adds ? root : -1 - lane);
        const int sum = __reduce_add_sync(peers, adds ? c : 0);
        if (adds && lane == __ffs(peers) - 1) atomicAdd(acc + root, sum);
        if (over) {                              // the same for every thread of the frame
            const int m = __reduce_add_sync(FULL, k < R - 1 ? c : 0);
            if (lane == 0 && m) atomicAdd(acc + R, m);
        }
    }
}

// One block a frame: the final resolve's map table (R + 1 a frame),
// n_eligible (int64), overflow and converged (bytes), from the slots
// kernel's root slots and acc. Root slot r = q DENSE_THREADS + t is thread
// t's round q; a round's eligible slots are ranked by a ballot a warp and
// an exclusive scan over (round, warp) in that order.
__global__ void __launch_bounds__(DENSE_THREADS)
resolve_dense_kernel(const int32_t* __restrict__ root, const int32_t* __restrict__ acc,
                     const int32_t* __restrict__ n_groups, int32_t* __restrict__ table,
                     long long* __restrict__ n_eligible, uint8_t* __restrict__ overflow,
                     uint8_t* __restrict__ converged, int R, int min_px) {
    extern __shared__ uint16_t dense_of[];       // (R,) a root slot's dense id
    __shared__ int base[DENSE_ROUNDS * DENSE_WARPS];
    __shared__ int wsum[DENSE_WARPS];
    const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, w = t >> 5;
    root += (size_t)b * R;
    acc += (size_t)b * (R + 2);
    table += (size_t)b * (R + 1);
    const int ng = n_groups[b];
    const bool over = ng > R;
    const int sp = over ? root[R - 1] : -1;      // slot R - 1's root slot, which takes
    const int minus = over ? acc[R] : 0;         // minus the counts of slots 0 .. R - 2
    const int rounds = (R + DENSE_THREADS - 1) / DENSE_THREADS;
    unsigned long long mine = 0;                 // bit q: root slot q DENSE_THREADS + t is eligible
    for (int q0 = 0; q0 < rounds; q0 += DENSE_BATCH) {
        int tot[DENSE_BATCH];
#pragma unroll
        for (int j = 0; j < DENSE_BATCH; ++j) {
            const int r = (q0 + j) * DENSE_THREADS + t;
            tot[j] = q0 + j < rounds && r < R ? acc[r] : 0;
        }
#pragma unroll
        for (int j = 0; j < DENSE_BATCH; ++j) {
            const int q = q0 + j, r = q * DENSE_THREADS + t;
            if (q >= rounds) break;              // the same for every thread
            const bool el = r < R && (tot[j] > 0 || r == sp)
                            && tot[j] - (r == sp ? minus : 0) >= min_px;
            mine |= (unsigned long long)el << q;
            const unsigned m = __ballot_sync(FULL, el);
            if (lane == 0) base[q * DENSE_WARPS + w] = __popc(m);
        }
    }
    __syncthreads();
    // Exclusive scan of base in (round, warp) order, two entries a thread.
    const int n = rounds * DENSE_WARPS;
    const int v0 = 2 * t < n ? base[2 * t] : 0, v1 = 2 * t + 1 < n ? base[2 * t + 1] : 0;
    int inc = v0 + v1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc += y;
    }
    if (lane == 31) wsum[w] = inc;
    __syncthreads();
    if (w == 0) {
        int x = wsum[lane];
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(FULL, x, d);
            if (lane >= d) x += y;
        }
        wsum[lane] = x;
    }
    __syncthreads();
    const int ex = inc - v0 - v1 + (w ? wsum[w - 1] : 0);
    const int total = wsum[DENSE_WARPS - 1];
    if (2 * t < n) base[2 * t] = ex;
    if (2 * t + 1 < n) base[2 * t + 1] = ex + v0;
    __syncthreads();
    for (int q = 0; q < rounds; ++q) {
        const bool el = (mine >> q) & 1;
        const unsigned m = __ballot_sync(FULL, el);
        const int rank = base[q * DENSE_WARPS + w] + __popc(m & ((1u << lane) - 1u));
        const int r = q * DENSE_THREADS + t;
        if (r < R) dense_of[r] = el && rank < KMAX ? rank : KMAX;
    }
    __syncthreads();
    for (int k0 = t; k0 < R; k0 += DENSE_BATCH * DENSE_THREADS) {
        int rt[DENSE_BATCH];
#pragma unroll
        for (int j = 0; j < DENSE_BATCH; ++j) {
            const int k = k0 + j * DENSE_THREADS;
            rt[j] = k < R ? root[k] : R;
        }
#pragma unroll
        for (int j = 0; j < DENSE_BATCH; ++j) {
            const int k = k0 + j * DENSE_THREADS;
            if (k < R) table[k] = rt[j] < R ? dense_of[rt[j]] : KMAX;
        }
    }
    if (t == 0) {
        const int last = root[R - 1];
        table[R] = R == MAX_R && last < R ? dense_of[last] : KMAX;
        n_eligible[b] = total;
        overflow[b] = over || total > KMAX;
        converged[b] = acc[R + 1] == 0;
    }
}

// PT consecutive pixels a thread (4, or 16 from COUNT_BIG pixels a launch),
// as resolve_count_kernel takes them (VEC: PT / 4 int4 of labels, PT bytes
// of validity and PT / 4 int4 of output a thread). The pixel rows are read
// and written once, with streaming hints, so inv and the table keep L2. A
// thread gathers once a run of equal labels among its pixels, and issues
// all its inv gathers, then all its table gathers, so they are in flight
// together.
template <bool VEC, int PT>
__global__ void __launch_bounds__(THREADS)
resolve_map_kernel(const int32_t* __restrict__ label, const uint8_t* __restrict__ valid,
                   const int32_t* __restrict__ inv, const int32_t* __restrict__ table,
                   int32_t* __restrict__ out, int N, int S, int R, int fill) {
    const int b = blockIdx.y;
    label += (size_t)b * N;
    valid += (size_t)b * N;
    out += (size_t)b * N;
    inv += (size_t)b * (S + 1);
    table += (size_t)b * (R + 1);
    const int chunks = (N + THREADS * PT - 1) / (THREADS * PT);
    for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
        const int p0 = (chunk * THREADS + threadIdx.x) * PT;
        if (p0 >= N) break;
        int32_t l[PT];
        bool ok[PT];
        if constexpr (VEC) {
            uint32_t m[PT / 4];
            if constexpr (PT == 16) {
                const uint4 v = __ldcs(reinterpret_cast<const uint4*>(valid + p0));
                m[0] = v.x; m[1] = v.y; m[2] = v.z; m[3] = v.w;
            } else {
                m[0] = __ldcs(reinterpret_cast<const unsigned int*>(valid + p0));
            }
#pragma unroll
            for (int q = 0; q < PT / 4; ++q) {
                const int4 a = __ldcs(reinterpret_cast<const int4*>(label + p0 + 4 * q));
                l[4 * q] = a.x; l[4 * q + 1] = a.y; l[4 * q + 2] = a.z; l[4 * q + 3] = a.w;
#pragma unroll
                for (int j = 0; j < 4; ++j) ok[4 * q + j] = (m[q] >> (8 * j)) & 0xFFu;
            }
        } else {
#pragma unroll
            for (int j = 0; j < PT; ++j) {
                const int p = p0 + j;
                ok[j] = p < N && valid[p];
                l[j] = ok[j] ? label[p] : 0;
            }
        }
        bool first[PT];                     // the first pixel of a run of one label
        int32_t r[PT];
#pragma unroll
        for (int j = 0; j < PT; ++j) {
            ok[j] = ok[j] && l[j] >= 0 && l[j] < S;
            first[j] = ok[j] && !(j > 0 && ok[j - 1] && l[j] == l[j - 1]);
            r[j] = first[j] ? __ldg(inv + l[j]) : 0;
        }
#pragma unroll
        for (int j = 0; j < PT; ++j) r[j] = first[j] ? __ldg(table + r[j]) : fill;
#pragma unroll
        for (int j = 1; j < PT; ++j)
            if (ok[j] && !first[j]) r[j] = r[j - 1];
        if constexpr (VEC) {
#pragma unroll
            for (int q = 0; q < PT / 4; ++q)
                __stcs(reinterpret_cast<int4*>(out + p0 + 4 * q),
                       make_int4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]));
        } else {
#pragma unroll
            for (int j = 0; j < PT; ++j)
                if (p0 + j < N) out[p0 + j] = r[j];
        }
    }
}

int scan_tiles(int S) { return (S + 1 + SCAN_TILE - 1) / SCAN_TILE; }

}  // namespace

extern "C" int apriltag_resolve_count(const void* label, const void* valid, void* cnt, int B,
                                      int N, int S, void* stream) {
    if (B < 1 || N < 1 || S < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t e = cudaMemsetAsync(cnt, 0, (size_t)B * S * sizeof(int32_t), st);
    if (e != cudaSuccess) return (int)e;
    const int32_t* l = (const int32_t*)label;
    const uint8_t* v = (const uint8_t*)valid;
    int32_t* c = (int32_t*)cnt;
    const bool big = (long long)B * N >= COUNT_BIG;
    const int pt = big ? 16 : 4;
    const dim3 grid((N + COUNT_THREADS * pt - 1) / (COUNT_THREADS * pt), B);
    const bool vec = N % pt == 0 && (uintptr_t)label % 16 == 0 && (uintptr_t)valid % pt == 0;
    if (big && vec) resolve_count_kernel<true, 16><<<grid, COUNT_THREADS, 0, st>>>(l, v, c, N, S);
    else if (big) resolve_count_kernel<false, 16><<<grid, COUNT_THREADS, 0, st>>>(l, v, c, N, S);
    else if (vec) resolve_count_kernel<true, 4><<<grid, COUNT_THREADS, 0, st>>>(l, v, c, N, S);
    else resolve_count_kernel<false, 4><<<grid, COUNT_THREADS, 0, st>>>(l, v, c, N, S);
    return (int)cudaGetLastError();
}

extern "C" int apriltag_resolve_tile_sums(const void* cnt, void* tile_sum, int B, int S,
                                          int tiles, void* stream) {
    if (B < 1 || S < 1 || tiles != scan_tiles(S)) return (int)cudaErrorInvalidValue;
    const dim3 grid(tiles, B);
    resolve_tile_sums_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)cnt, (int32_t*)tile_sum, S, tiles);
    return (int)cudaGetLastError();
}

extern "C" int apriltag_resolve_scan(const void* cnt, const void* tile_sum, void* inv, void* D,
                                     void* n_groups, int B, int S, int R, int tiles,
                                     void* stream) {
    if (B < 1 || S < 1 || R < 1 || tiles != scan_tiles(S)) return (int)cudaErrorInvalidValue;
    const dim3 grid(tiles, B);
    resolve_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)cnt, (const int32_t*)tile_sum, (int32_t*)inv, (int32_t*)D,
        (int32_t*)n_groups, S, R, tiles);
    return (int)cudaGetLastError();
}

// blocks: a frame's blocks (at least 1), each taking every blocks-th chunk
// of THREADS PT pixels.
extern "C" int apriltag_resolve_map(const void* label, const void* valid, const void* inv,
                                    const void* table, void* out, int B, int N, int S, int R,
                                    int fill, int blocks, void* stream) {
    if (B < 1 || N < 1 || S < 1 || R < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int32_t *l = (const int32_t*)label, *iv = (const int32_t*)inv,
                  *tb = (const int32_t*)table;
    const uint8_t* v = (const uint8_t*)valid;
    int32_t* o = (int32_t*)out;
    const bool big = (long long)B * N >= COUNT_BIG;
    const int pt = big ? 16 : 4;
    const int chunks = (N + THREADS * pt - 1) / (THREADS * pt);
    const dim3 grid(min(blocks, chunks), B);
    const bool vec = N % pt == 0 && (uintptr_t)label % 16 == 0 && (uintptr_t)valid % pt == 0
                     && (uintptr_t)out % 16 == 0;
    auto kernel = big ? (vec ? resolve_map_kernel<true, 16> : resolve_map_kernel<false, 16>)
                      : (vec ? resolve_map_kernel<true, 4> : resolve_map_kernel<false, 4>);
    kernel<<<grid, THREADS, 0, st>>>(l, v, iv, tb, o, N, S, R, fill);
    return (int)cudaGetLastError();
}

// cnt null: the contraction (out (B, R + 1) map table, ovf (B,) bytes);
// else the final resolve (out (B, R) root slots, acc after the memo in
// scratch). scratch: the memo (B (R + 1) ints), then for the final resolve
// acc (B (R + 2) ints), zeroed here by one memset. rank_table (B, S) or
// null. steps: the chain steps (at least 1 is taken).
extern "C" int apriltag_resolve_slots(const void* label, const void* inv, const void* D,
                                      const void* n_groups, const void* rank_table,
                                      const void* cnt, void* scratch, void* out, void* ovf,
                                      int B, int N, int S, int R, int steps, void* stream) {
    const bool final_ = cnt != nullptr;
    if (B < 1 || N < 1 || S < 1 || R < 1 || R > MAX_R || (!final_ && ovf == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const size_t words = (size_t)B * (R + 1) + (final_ ? (size_t)B * (R + 2) : 0);
    const cudaError_t err = cudaMemsetAsync(scratch, 0, words * sizeof(int32_t), st);
    if (err != cudaSuccess) return (int)err;
    int32_t* memo = (int32_t*)scratch;
    const int e = max(steps, 1) - 1;
    const dim3 grid((R + 1 + THREADS - 1) / THREADS, B);
    auto kernel = final_ ? resolve_slots_kernel<true> : resolve_slots_kernel<false>;
    kernel<<<grid, THREADS, 0, st>>>(
        (const int32_t*)label, (const int32_t*)inv, (const int32_t*)D, (const int32_t*)n_groups,
        (const int32_t*)rank_table, (const int32_t*)cnt, memo, (int32_t*)out,
        final_ ? memo + (size_t)B * (R + 1) : nullptr, (uint8_t*)ovf, N, S, R, e);
    return (int)cudaGetLastError();
}

// One block a frame; its dense ids take 2 R bytes of shared memory, past
// the default 48 KB, which each device is told once.
extern "C" int apriltag_resolve_dense(const void* root, const void* acc, const void* n_groups,
                                      void* table, void* n_eligible, void* overflow,
                                      void* converged, int B, int R, int min_px, void* stream) {
    if (B < 1 || R < 1 || R > MAX_R) return (int)cudaErrorInvalidValue;
    static bool sized[256];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= 256) return (int)cudaErrorInvalidDevice;
    if (!sized[dev]) {
        err = cudaFuncSetAttribute(resolve_dense_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   MAX_R * (int)sizeof(uint16_t));
        if (err != cudaSuccess) return (int)err;
        sized[dev] = true;
    }
    resolve_dense_kernel<<<B, DENSE_THREADS, R * sizeof(uint16_t), (cudaStream_t)stream>>>(
        (const int32_t*)root, (const int32_t*)acc, (const int32_t*)n_groups, (int32_t*)table,
        (long long*)n_eligible, (uint8_t*)overflow, (uint8_t*)converged, R, min_px);
    return (int)cudaGetLastError();
}
