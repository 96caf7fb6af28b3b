// Component resolution: (B, N) labels -> per-frame label tables, the
// tables' chains and dense ranks, and tables -> per-pixel values, in five
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
//   resolve_scan_kernel  many blocks a frame, one a tile, thread t entries
//       t + 256 j of it: every load of the tile and, in each warp, of the
//       frame's tile sums in one round (the tile's offset and the group
//       count by two warp sums), a ballot a round, one barrier, and each
//       warp's scan of the tile's 128 (round, warp) counts rank the tile's
//       present labels. Writes inv[b, L] = the group rank of a present label
//       capped at R (R for an absent label and for entry S), D[b, k] = the
//       k-th present label for k < R (S past the frame's group count,
//       filled by the frame's blocks together), and n_groups[b];
//   resolve_chain_kernel  one thread-block cluster of CLUSTER (8) blocks a
//       frame, each block owning a contiguous range of ceil(R / 8) of the
//       (B, R + 1) slot tables' slots in its shared memory (slot R, whose
//       parent is itself, is stored nowhere). Each thread computes f(k) for
//       its slots: the slot of the label at pixel D[k] (in rank mode at
//       pixel rank_table[D[k]]), all its slots' loads of one level issued
//       before the next. Then max(s, 1) rounds of f <- f o f (s the chain
//       steps), as the reference's pointer doubling: each round reads one
//       shared buffer, another block's slots through distributed shared
//       memory, and writes the other, with a cluster barrier between
//       rounds; a round that changes no entry of the frame ends them, since
//       every later one would change nothing. The last buffer is f^(2^s),
//       the one before f^(2^(s-1)). The contraction writes the map's table
//       (root & 0xFFFF, R at slot R) and the overflow flag. The final
//       resolve, in the same launch: each slot's pixel count into its root
//       slot's total at the root's owner block (DSMEM integer atomics, one
//       a warp's slots of one root; with more than R groups, slot R - 1
//       takes minus the counts of slots 0 .. R - 2), then the area gate: a
//       root slot r < R is a component when a slot maps to it (its total
//       is positive, or it is slot R - 1's root then) and eligible when its
//       total reaches the gate; r's dense id is the eligible root slots
//       below r (D is increasing, so root slots order as the twin's root
//       labels do), by ballots in each block and the blocks' counts
//       exchanged for their offsets, kept in shared memory as 16 bits; then
//       the map's table, each slot's dense id through its root slot, read
//       from the owner block (_KMAX past 32766 or gated out; slot R takes
//       slot 65535's at R = 65536), n_eligible, overflow and converged;
//   resolve_map_kernel  out[b, p] = table[b, inv[b, label[b, p]]] for a
//       valid pixel labelled in [0, S), else fill: the contraction's rank
//       image and the final resolve's dense ids, from the chain kernel's
//       (B, R + 1) tables. A thread takes PT consecutive pixels as the
//       count kernel does (vector loads and stores where the rows are
//       aligned, PT 16 from 2^20 pixels a launch), gathers once a run of
//       equal labels among them, and issues its inv gathers before its
//       table gathers; the pixel rows are read and written with streaming
//       hints, so inv and the table keep L2.
//
// Against the plain versions (ops/resolve.py::count_plain, scan_plain,
// slots_plain, final_plain = dense_plain after slots_plain, map_plain):
// bit-exact, all integer.
//
// What bounds it on an H100: bytes, but for count, whose integer atomics
// bound it on labels that change every few pixels. count reads 5 B a pixel
// and writes the 4 B a table entry (the memset; the atomics then meet the
// table in L2); tile sums read the table once; scan reads it again and writes inv (4 B
// an entry) and D: at batch 1 its 8-57 blocks leave most SMs idle, so a
// block's latency chain is the launch's time, and the scan keeps it to one
// round of loads, one barrier and coalesced stores (a single-pass
// look-back that also took the tile sums' launch was slower at both bench
// shapes: its ticket, status words' memset and look-back cost more than
// that launch); map reads 5 B a pixel, writes 4 B, and gathers from inv
// and the table, which runs of equal labels keep in L1 and L2: its gathers
// are dependent (the table's index is inv's entry), so it keeps many in
// flight a thread. The chain kernel reads D, n_groups and its slots' pixel
// labels (and counts) once and writes its (B, R + 1) table: its gathers
// are dependent, four levels deep, so a thread keeps its slots' loads of
// one level in flight together; its doubling rounds, totals and ranks stay
// in shared memory, and a frame's time follows the rounds (a DSMEM gather
// and a cluster barrier each) and not its chains' lengths. At batch 1 one
// cluster, 8 of the 132 SMs, does the frame.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

#include "stamps.cuh"

namespace cg = cooperative_groups;

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
constexpr int CLUSTER = 8;                   // blocks a frame: the portable cluster size
constexpr int CHAIN_THREADS = 1024;
constexpr int CHAIN_WARPS = CHAIN_THREADS / 32;
constexpr int CHAIN_SLOTS = MAX_R / CLUSTER;           // slots a block at most
constexpr int CHAIN_PER_THREAD = CHAIN_SLOTS / CHAIN_THREADS;
static_assert(CHAIN_PER_THREAD * CHAIN_THREADS == CHAIN_SLOTS, "whole slots a thread");
static_assert(CHAIN_PER_THREAD <= 32, "a bit a slot in a thread's mask");
// Dynamic shared memory a block at most: two int32 buffers, the int32
// totals and the 16-bit dense ids of CHAIN_SLOTS slots.
constexpr int CHAIN_SMEM = CHAIN_SLOTS * 14;

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

// One block a tile of SCAN_TILE table entries of one frame (grid (tiles,
// B)); thread t's j-th entry is base + j THREADS + t, so each of its
// SCAN_PER_THREAD loads and inv stores is a warp's 128 contiguous bytes,
// whatever the row's alignment. Every load is issued at once: the tile's
// entries and, in each warp, the frame's tile sums (lane l sums tiles l, l +
// 32, ...: the tile's offset and the frame's group count by two warp sums).
// A ballot a round gives the (round, warp) counts, which one barrier
// publishes; each warp then scans the 128 counts (four a lane, in round-
// major order, which is entry order) and takes its rounds' offsets by
// shuffles, so the entries' ranks need no second barrier.
__global__ void __launch_bounds__(THREADS)
resolve_scan_kernel(const int32_t* __restrict__ cnt, const int32_t* __restrict__ tile_sum,
                    int32_t* __restrict__ inv, int32_t* __restrict__ D,
                    int32_t* __restrict__ n_groups, int S, int R, int tiles) {
    constexpr int COUNTS = SCAN_PER_THREAD * WARPS;          // (round, warp) counts, round-major
    static_assert(COUNTS == 4 * 32, "four counts a lane");
    __shared__ int4 counts[COUNTS / 4];
    const int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x, lane = t & 31, w = t >> 5;
    STAMP(0, t);
    cnt += (size_t)b * S;
    inv += (size_t)b * (S + 1);
    D += (size_t)b * R;
    tile_sum += (size_t)b * tiles;
    const int base = tile * SCAN_TILE + t;
    int c[SCAN_PER_THREAD];
#pragma unroll
    for (int j = 0; j < SCAN_PER_THREAD; ++j) {
        const int e = base + j * THREADS;
        c[j] = e < S ? __ldg(cnt + e) : 0;
    }
    int before = 0, all = 0;                     // present labels before this tile, in all
#pragma unroll 4
    for (int i = lane; i < tiles; i += 32) {
        const int v = __ldg(tile_sum + i);
        all += v;
        before += i < tile ? v : 0;
    }
    before = __reduce_add_sync(FULL, before);
    all = __reduce_add_sync(FULL, all);
    STAMP(1, before + all);
    unsigned m[SCAN_PER_THREAD];
#pragma unroll
    for (int j = 0; j < SCAN_PER_THREAD; ++j) m[j] = __ballot_sync(FULL, c[j] > 0);
    if (lane == 0) {
        int* flat = reinterpret_cast<int*>(counts);
#pragma unroll
        for (int j = 0; j < SCAN_PER_THREAD; ++j) flat[j * WARPS + w] = __popc(m[j]);
    }
    __syncthreads();
    // Lane l holds counts 4l .. 4l + 3 (round l / 2, warps 4 (l & 1) .. + 3).
    const int4 q = counts[lane];
    const int x1 = q.x, x2 = x1 + q.y, x3 = x2 + q.z, x4 = x3 + q.w;
    int inc = x4;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc += y;
    }
    // At lane l: the counts before 4l + (w & 3), the index of (round l / 2,
    // warp 4 (l & 1) + (w & 3)); this warp's round j is index 4 (2j + (w >> 2)) + (w & 3).
    const int sub = w & 3;
    const int pre = before + inc - x4 + (sub == 0 ? 0 : sub == 1 ? x1 : sub == 2 ? x2 : x3);
    const unsigned below = (1u << lane) - 1u;
    int rank = 0;
#pragma unroll
    for (int j = 0; j < SCAN_PER_THREAD; ++j) {
        rank = __shfl_sync(FULL, pre, 2 * j + (w >> 2)) + __popc(m[j] & below);
        const int e = base + j * THREADS;
        const bool present = c[j] > 0;
        if (e <= S) inv[e] = present ? min(rank, R) : R;
        if (present && rank < R) D[rank] = e;
    }
    STAMP(2, rank);
    if (tile == 0 && t == 0) n_groups[b] = all;
    for (int k = all + tile * THREADS + t; k < R; k += tiles * THREADS) D[k] = S;
    STAMP(3, all);
}

// One frame's cluster: each of its CLUSTER blocks owns the slots [lo, hi),
// P = ceil(R / CLUSTER) a block (the last blocks short or empty), in its
// shared memory. Slot R is stored nowhere: f(R) = R.
struct ChainSlots {
    int P;
    unsigned long long magic;    // ceil(2^32 / P): x / P = (x magic) >> 32 for x <= 2^16, P <= 2^13

    __device__ explicit ChainSlots(int P_) : P(P_), magic((0x100000000ull + P_ - 1) / P_) {}

    __device__ int owner(int x) const { return (int)(((unsigned long long)x * magic) >> 32); }

    // &buf[x] of whichever block of the cluster owns slot x < R: the
    // calling block's own shared memory when it is `rank`, else another
    // block's through DSMEM, whose scattered accesses cost far more.
    template <typename T>
    __device__ T* at(cg::cluster_group& cluster, T* buf, int x, int rank) const {
        const int q = owner(x);
        return (q == rank ? buf : cluster.map_shared_rank(buf, q)) + (x - q * P);
    }
};

// One cluster of CLUSTER blocks a frame (grid (CLUSTER, B)); slot
// k = lo + j CHAIN_THREADS + t is thread t's j-th, j < JMAX (chain_kernel
// takes 4 where a block owns at most 4096 slots, else 8). f(k): the slot
// of the label at pixel D[k] (rank_table[D[k]] in rank mode), R past
// n_groups; then max(steps, 1) = `rounds` rounds of f <- f o f, each reading one
// shared buffer (another block's slots through DSMEM) and writing the
// other, a cluster barrier between rounds; a round that changes no entry
// of the frame ends them (f is then idempotent). root = the last buffer,
// half = the one before: f^(2^s) and f^(2^(s-1)).
// Contraction (!FINAL): table (B, R + 1) = root & 0xFFFF, R at slot R;
// overflow[b] = n_groups > R.
// Final resolve: each slot's count cnt[D[k]] into its root slot's total
// (DSMEM atomics at the owner; not for root R, nor slot R - 1's when
// n_groups > R, which takes minus slots 0 .. R - 2's), the area gate, the
// dense ids of the eligible root slots in slot order (ballots in each
// block, the blocks' counts exchanged for their offsets), then table (B,
// R + 1) = each slot's id through its root slot (_KMAX when gated out or
// past _KMAX - 1; slot R takes slot 65535's at R = 65536), n_eligible,
// overflow and converged (half == root everywhere).
template <bool FINAL, int JMAX>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(CHAIN_THREADS)
resolve_chain_kernel(const int32_t* __restrict__ lab, const int32_t* __restrict__ inv,
                     const int32_t* __restrict__ D, const int32_t* __restrict__ n_groups,
                     const int32_t* __restrict__ rank_table, const int32_t* __restrict__ cnt,
                     int32_t* __restrict__ table, long long* __restrict__ n_eligible,
                     uint8_t* __restrict__ overflow, uint8_t* __restrict__ converged,
                     int N, int S, int R, int rounds, int min_px) {
    cg::cluster_group cluster = cg::this_cluster();
    extern __shared__ int4 chain_smem[];
    __shared__ int flag[2];                      // a round changed an entry (pushed by every block)
    // Slots 0 .. R - 2's counts, the cluster's and a block's; half != root somewhere.
    __shared__ int minus, part, unconv;
    __shared__ int bcount[CLUSTER];              // each block's eligible root slots
    __shared__ int base[JMAX * CHAIN_WARPS];
    __shared__ int wsum[CHAIN_WARPS];
    const int P = (R + CLUSTER - 1) / CLUSTER;
    const ChainSlots sl(P);
    int32_t* cur = reinterpret_cast<int32_t*>(chain_smem);   // (P,) f, then f^(2^i)
    int32_t* nxt = cur + P;                                  // (P,) the other buffer
    int32_t* tot = nxt + P;                                  // (P,) root slots' totals
    uint16_t* ids = reinterpret_cast<uint16_t*>(tot + P);    // (P,) root slots' dense ids
    const int rank = (int)cluster.block_rank(), b = blockIdx.y;
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const int lo = min(rank * P, R), hi = min(lo + P, R);
    const int ng = n_groups[b];
    const bool over = ng > R;
    lab += (size_t)b * N;
    inv += (size_t)b * (S + 1);
    D += (size_t)b * R;
    table += (size_t)b * (R + 1);
    if (rank_table) rank_table += (size_t)b * S;

    // Parents, each level's loads of all the thread's slots issued together.
    int c[JMAX];                                 // FINAL: the slot's pixel count
    {
        int d[JMAX], p[JMAX];
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            const int k = lo + j * CHAIN_THREADS + t;
            d[j] = k < hi && k < ng ? __ldg(D + k) : -1;
        }
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            p[j] = d[j] >= 0 && rank_table ? __ldg(rank_table + d[j]) : d[j];
            if constexpr (FINAL) c[j] = d[j] >= 0 ? __ldg(cnt + (size_t)b * S + d[j]) : 0;
        }
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            p[j] = d[j] < 0 ? -1 : p[j] >= 0 && p[j] < N ? __ldg(lab + p[j]) : S;
        }
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            const int k = lo + j * CHAIN_THREADS + t;
            if (k < hi) cur[k - lo] = d[j] < 0 ? R : __ldg(inv + min(max(p[j], 0), S));
        }
    }
    if constexpr (FINAL)
        for (int i = t; i < hi - lo; i += CHAIN_THREADS) tot[i] = 0;
    if (t == 0) {
        flag[0] = flag[1] = 0;
        minus = part = unconv = 0;
    }
    cluster.sync();

    // Doubling: round i reads cur, writes nxt, and pushes "changed" into
    // every block's flag[i & 1]; after the barrier each block reads its own.
    // Its flag[(i + 1) & 1] was read in round i - 1 (the block barrier below
    // orders that) and is reset here, before the barrier after which round
    // i + 1 pushes into it. A slot whose entry x a round leaves unchanged
    // (x = f_i(x), so x = f_i+1(x) = f_i+1(k) too) holds x in both buffers
    // for good: later rounds neither read nor write it (bit j of `done`).
    unsigned done = 0;
    for (int i = 0; i < rounds; ++i) {
        int x[JMAX], y[JMAX];
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            const int k = lo + j * CHAIN_THREADS + t;
            x[j] = k < hi && !((done >> j) & 1) ? cur[k - lo] : R;
        }
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            y[j] = x[j] < R ? *sl.at(cluster, cur, x[j], rank) : R;
        }
        bool changed = false;
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            const int k = lo + j * CHAIN_THREADS + t;
            if (k < hi && !((done >> j) & 1)) {
                nxt[k - lo] = y[j];
                changed |= y[j] != x[j];
                done |= (unsigned)(y[j] == x[j]) << j;
            }
        }
        const int any = __syncthreads_or(changed);
        if (t == 0) flag[(i + 1) & 1] = 0;
        if (any && t < CLUSTER) *cluster.map_shared_rank(flag + (i & 1), t) = 1;   // to block t
        cluster.sync();
        int32_t* s = cur;
        cur = nxt;
        nxt = s;
        if (!*(volatile int*)(flag + (i & 1))) break;     // the same in every block
    }
    // cur: root; nxt: half (equal to root after a round that changed nothing).

    if constexpr (!FINAL) {
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            const int k = lo + j * CHAIN_THREADS + t;
            if (k < hi) table[k] = cur[k - lo] & 0xFFFF;
        }
        if (rank == 0 && t == 0) {
            table[R] = R;
            overflow[b] = over;
        }
        // No block reads another's shared memory after the last barrier.
    } else {
        // Totals at the root slots' owners: a run of the warp's lanes with
        // one root adds once, at its first lane (a segmented suffix sum by
        // shuffles, in a warp that has such a run; __match_any_sync is far
        // slower on this card); slot R - 1's minus; half != root.
        int m = 0;
        bool unc = false;
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            const int k = lo + j * CHAIN_THREADS + t;
            const int root = k < hi ? cur[k - lo] : R;
            unc |= k < hi && nxt[k - lo] != root;
            const bool adds = c[j] != 0 && root < R && !(over && k == R - 1);
            const int key = adds ? root : -1 - lane;
            int sum = adds ? c[j] : 0;
            const int below = __shfl_down_sync(FULL, key, 1);    // every lane shuffles
            const int above = __shfl_up_sync(FULL, key, 1);
            const bool joins = adds && lane > 0 && above == key;     // continues the run above
            if (__any_sync(FULL, joins)) {                            // the same in the warp
                int end = lane == 31 || below != key;                 // the run ends here
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {   // sum: this lane's to its run's end
                    const int y = __shfl_down_sync(FULL, sum, d);
                    const int e = __shfl_down_sync(FULL, end, d);
                    if (!end) {
                        sum += y;
                        end = e;
                    }
                }
            }
            if (adds && !joins) atomicAdd(sl.at(cluster, tot, root, rank), sum);
            m += k < R - 1 ? c[j] : 0;
        }
        if (over) {
            m = __reduce_add_sync(FULL, m);
            if (lane == 0 && m) atomicAdd(&part, m);
        }
        if (__syncthreads_or(unc) && t == 0) *cluster.map_shared_rank(&unconv, 0) = 1;
        if (over && part && t < CLUSTER) atomicAdd(cluster.map_shared_rank(&minus, t), part);
        cluster.sync();

        // The gate on this block's root slots, ranked by a ballot a warp and
        // an exclusive scan over (j, warp) in that order, which is slot order.
        const int sp = over ? *sl.at(cluster, cur, R - 1, rank) : -1;   // slot R - 1's root slot
        const int mn = *(volatile int*)&minus;
        unsigned mine = 0;                       // bit j: the thread's j-th root slot is eligible
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            const int r = lo + j * CHAIN_THREADS + t;
            const int tt = r < hi ? tot[r - lo] : 0;
            const bool el = r < hi && (tt > 0 || r == sp) && tt - (r == sp ? mn : 0) >= min_px;
            mine |= (unsigned)el << j;
            const unsigned bal = __ballot_sync(FULL, el);
            if (lane == 0) base[j * CHAIN_WARPS + w] = __popc(bal);
        }
        __syncthreads();
        constexpr int NB = JMAX * CHAIN_WARPS;
        static_assert(NB <= CHAIN_THREADS && NB % 32 == 0, "one base entry a thread");
        const int v = t < NB ? base[t] : 0;
        int inc = v;
#pragma unroll
        for (int dd = 1; dd < 32; dd <<= 1) {
            const int y = __shfl_up_sync(FULL, inc, dd);
            if (lane >= dd) inc += y;
        }
        if (lane == 31) wsum[w] = inc;
        __syncthreads();
        int before = 0, mine_total = 0;
#pragma unroll
        for (int u = 0; u < NB / 32; ++u) {
            const int s = wsum[u];
            before += u < w ? s : 0;
            mine_total += s;
        }
        if (t < NB) base[t] = before + inc - v;
        if (t < CLUSTER) cluster.map_shared_rank(bcount, t)[rank] = mine_total;
        cluster.sync();
        int off = 0, total = 0;
#pragma unroll
        for (int q = 0; q < CLUSTER; ++q) {
            const int n = ((volatile int*)bcount)[q];
            off += q < rank ? n : 0;
            total += n;
        }
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            const int r = lo + j * CHAIN_THREADS + t;
            const bool el = (mine >> j) & 1;
            const unsigned bal = __ballot_sync(FULL, el);
            const int id = off + base[j * CHAIN_WARPS + w] + __popc(bal & ((1u << lane) - 1u));
            if (r < hi) ids[r - lo] = el && id < KMAX ? id : KMAX;
        }
        cluster.sync();

        // The map table: each slot's dense id through its root slot.
        int root[JMAX], id[JMAX];
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            const int k = lo + j * CHAIN_THREADS + t;
            root[j] = k < hi ? cur[k - lo] : R;
        }
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            id[j] = root[j] < R ? *sl.at(cluster, ids, root[j], rank) : KMAX;
        }
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
            const int k = lo + j * CHAIN_THREADS + t;
            if (k < hi) table[k] = id[j];
            if (k == R - 1) table[R] = R == MAX_R ? id[j] : KMAX;
        }
        if (rank == 0 && t == 0) {
            n_eligible[b] = total;
            overflow[b] = over || total > KMAX;
            converged[b] = *(volatile int*)&unconv == 0;
        }
        cluster.sync();                          // no block leaves while another reads its ids
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

using ChainKernel = void (*)(const int32_t*, const int32_t*, const int32_t*, const int32_t*,
                            const int32_t*, const int32_t*, int32_t*, long long*, uint8_t*,
                            uint8_t*, int, int, int, int, int);

// The chain kernel's instance for a pass at R slots a frame: JMAX 4 where a
// block owns at most 4096 slots (R <= 32768), else 8.
static ChainKernel chain_kernel(bool final_, int R) {
    const bool small = (R + CLUSTER - 1) / CLUSTER <= CHAIN_SLOTS / 2;
    return final_ ? (small ? resolve_chain_kernel<true, CHAIN_PER_THREAD / 2>
                           : resolve_chain_kernel<true, CHAIN_PER_THREAD>)
                  : (small ? resolve_chain_kernel<false, CHAIN_PER_THREAD / 2>
                           : resolve_chain_kernel<false, CHAIN_PER_THREAD>);
}

// Each device is told once that the chain kernels may take CHAIN_SMEM
// bytes of dynamic shared memory, past the default 48 KB.
static cudaError_t size_chain_kernels() {
    static bool sized[256];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= 256) return cudaErrorInvalidDevice;
    if (!sized[dev]) {
        const ChainKernel kernels[4] = {chain_kernel(false, 1), chain_kernel(false, MAX_R),
                                        chain_kernel(true, 1), chain_kernel(true, MAX_R)};
        for (const ChainKernel k : kernels) {
            err = cudaFuncSetAttribute((const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       CHAIN_SMEM);
            if (err != cudaSuccess) return err;
        }
        sized[dev] = true;
    }
    return cudaSuccess;
}

static size_t chain_smem_bytes(bool final_, int R) {
    const size_t P = (R + CLUSTER - 1) / CLUSTER;
    return P * (final_ ? 14 : 8);                // cur, nxt (int32); tot (int32), ids (uint16)
}

// One cluster of CLUSTER blocks a frame. cnt null: the contraction (table
// (B, R + 1), overflow (B,) bytes; n_eligible and converged unused); else
// the final resolve (table, n_eligible (B,) int64, overflow and converged
// (B,) bytes). rank_table (B, S) or null. steps: the doubling rounds (at
// least 1 is taken).
extern "C" int apriltag_resolve_chain(const void* label, const void* inv, const void* D,
                                      const void* n_groups, const void* rank_table,
                                      const void* cnt, void* table, void* n_eligible,
                                      void* overflow, void* converged, int B, int N, int S,
                                      int R, int steps, int min_px, void* stream) {
    const bool final_ = cnt != nullptr;
    if (B < 1 || N < 1 || S < 1 || R < 1 || R > MAX_R || table == nullptr || overflow == nullptr
        || (final_ && (n_eligible == nullptr || converged == nullptr)))
        return (int)cudaErrorInvalidValue;
    const cudaError_t err = size_chain_kernels();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(CLUSTER, B);
    const ChainKernel kernel = chain_kernel(final_, R);
    kernel<<<grid, CHAIN_THREADS, chain_smem_bytes(final_, R), (cudaStream_t)stream>>>(
        (const int32_t*)label, (const int32_t*)inv, (const int32_t*)D, (const int32_t*)n_groups,
        (const int32_t*)rank_table, (const int32_t*)cnt, (int32_t*)table,
        (long long*)n_eligible, (uint8_t*)overflow, (uint8_t*)converged, N, S, R,
        max(steps, 1), min_px);
    return (int)cudaGetLastError();
}

// *clusters = cudaOccupancyMaxActiveClusters of the chain kernel (final or
// not) at R slots a frame: the frames the card runs at once.
extern "C" int apriltag_resolve_chain_clusters(void* clusters, int final_, int R, void* stream) {
    if (clusters == nullptr || R < 1 || R > MAX_R) return (int)cudaErrorInvalidValue;
    cudaError_t err = size_chain_kernels();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(CLUSTER, 1);
    config.blockDim = dim3(CHAIN_THREADS);
    config.dynamicSmemBytes = chain_smem_bytes(final_ != 0, R);
    config.stream = (cudaStream_t)stream;
    err = cudaOccupancyMaxActiveClusters((int*)clusters, (const void*)chain_kernel(final_, R),
                                         &config);
    return (int)err;
}
