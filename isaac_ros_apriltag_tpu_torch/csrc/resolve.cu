// Component resolution's pixel passes: (B, N) labels -> per-frame label
// tables, and tables -> per-pixel values, in four kernels.
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
//       [0, S): a thread counts 8 consecutive pixels (staged through shared
//       memory, so the loads are coalesced) as runs, and adds each run with
//       one integer atomic; its last run is merged with the warp's other
//       last runs of the same label (__match_any_sync), so a frame's
//       background component costs one atomic a warp, not one a pixel.
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
//   resolve_map_kernel  out[b, p] = table[b, inv[b, label[b, p]]] for a
//       valid pixel labelled in [0, S), else fill: the contraction's rank
//       image and the final resolve's dense ids, from (B, R + 1) tables
//       that torch computes on the R slots between scan and map.
//
// Against the plain versions (ops/resolve.py::count_plain, scan_plain,
// map_plain): bit-exact, all integer.
//
// What bounds it on an H100: bytes. count reads 5 B a pixel and writes the
// 4 B a table entry (zeroed by the wrapper); tile sums read the table once;
// scan reads it again and writes inv (4 B an entry) and D; map reads 5 B a
// pixel, writes 4 B, and gathers from inv and the table, which runs of
// equal labels keep in L1 and L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int COUNT_PER_THREAD = 8;                           // consecutive pixels a thread
constexpr int COUNT_TILE = THREADS * COUNT_PER_THREAD;        // pixels a block
constexpr int SCAN_PER_THREAD = 16;
constexpr int SCAN_TILE = THREADS * SCAN_PER_THREAD;          // table entries a block
constexpr int MAP_PER_THREAD = 4;
constexpr int MAP_TILE = THREADS * MAP_PER_THREAD;

// Staging index with one pad word every 32: a warp storing 32 consecutive
// words and a thread reading its 8 consecutive words both meet 32 banks.
__host__ __device__ constexpr int skew(int i) { return i + (i >> 5); }

__global__ void __launch_bounds__(THREADS)
resolve_count_kernel(const int32_t* __restrict__ label, const uint8_t* __restrict__ valid,
                     int32_t* __restrict__ cnt, int N, int S) {
    __shared__ int32_t key[skew(COUNT_TILE)];
    __shared__ int lane_run[WARPS][32];
    const int b = blockIdx.y, t = threadIdx.x, lane = t & 31, w = t >> 5;
    const int base = blockIdx.x * COUNT_TILE;
    label += (size_t)b * N;
    valid += (size_t)b * N;
    cnt += (size_t)b * S;
#pragma unroll
    for (int j = 0; j < COUNT_PER_THREAD; ++j) {
        const int i = j * THREADS + t, p = base + i;
        int32_t k = -1;                          // -1: not counted
        if (p < N && valid[p]) {
            const int32_t l = label[p];
            if (l >= 0 && l < S) k = l;
        }
        key[skew(i)] = k;
    }
    __syncthreads();
    int32_t cur = key[skew(t * COUNT_PER_THREAD)];
    int run = 1;
#pragma unroll
    for (int j = 1; j < COUNT_PER_THREAD; ++j) {
        const int32_t k = key[skew(t * COUNT_PER_THREAD + j)];
        if (k != cur) {
            if (cur >= 0) atomicAdd(cnt + cur, run);
            cur = k;
            run = 0;
        }
        ++run;
    }
    // The warp's last runs: one atomic per distinct label, by its lowest lane.
    lane_run[w][lane] = run;
    __syncwarp();
    const unsigned peers = __match_any_sync(FULL, cur);
    if (cur >= 0 && lane == __ffs(peers) - 1) {
        int total = 0;
        for (unsigned m = peers; m; m &= m - 1) total += lane_run[w][__ffs(m) - 1];
        atomicAdd(cnt + cur, total);
    }
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

__global__ void __launch_bounds__(THREADS)
resolve_map_kernel(const int32_t* __restrict__ label, const uint8_t* __restrict__ valid,
                   const int32_t* __restrict__ inv, const int32_t* __restrict__ table,
                   int32_t* __restrict__ out, int N, int S, int R, int fill) {
    const int b = blockIdx.y, t = threadIdx.x;
    label += (size_t)b * N;
    valid += (size_t)b * N;
    out += (size_t)b * N;
    inv += (size_t)b * (S + 1);
    table += (size_t)b * (R + 1);
    const int base = blockIdx.x * MAP_TILE;
#pragma unroll
    for (int j = 0; j < MAP_PER_THREAD; ++j) {
        const int p = base + j * THREADS + t;
        if (p >= N) return;
        int32_t v = fill;
        if (valid[p]) {
            const int32_t l = label[p];
            if (l >= 0 && l < S) v = table[inv[l]];
        }
        out[p] = v;
    }
}

int scan_tiles(int S) { return (S + 1 + SCAN_TILE - 1) / SCAN_TILE; }

}  // namespace

extern "C" int apriltag_resolve_count(const void* label, const void* valid, void* cnt, int B,
                                      int N, int S, void* stream) {
    if (B < 1 || N < 1 || S < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + COUNT_TILE - 1) / COUNT_TILE, B);
    resolve_count_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)label, (const uint8_t*)valid, (int32_t*)cnt, N, S);
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

extern "C" int apriltag_resolve_map(const void* label, const void* valid, const void* inv,
                                    const void* table, void* out, int B, int N, int S, int R,
                                    int fill, void* stream) {
    if (B < 1 || N < 1 || S < 1 || R < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + MAP_TILE - 1) / MAP_TILE, B);
    resolve_map_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)label, (const uint8_t*)valid, (const int32_t*)inv,
        (const int32_t*)table, (int32_t*)out, N, S, R, fill);
    return (int)cudaGetLastError();
}
