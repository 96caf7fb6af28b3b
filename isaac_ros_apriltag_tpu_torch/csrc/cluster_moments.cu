// Cluster moments: (B, H, W) trinary + area-gated dense component ids ->
// per-cluster angular moment tables, in four kernels around one torch.sort.
//
// Replaces: the sort-centric formulation of
// isaac_ros_apriltag_tpu/ops/cluster_moments.py (XLA, no Pallas kernel),
// which the port's plain version (isaac_ros_apriltag_tpu_torch/ops/
// cluster_moments.py::extract_cluster_moments) takes as it is: after one
// stable sort of the pairs by (black, white) key, a reverse cummin for the
// segment sizes, a stable sort for the top C, a cumsum and a packed cummax
// to broadcast slot ids, a second stable sort to compact the slots' pairs
// to E2, and three one-hot f64 GEMMs. The TPU needed that because a
// per-element scatter serialises there. Here one fact replaces it: after
// the sort each (black, white) segment is a contiguous range of the sorted
// keys, and each top-C cluster is one such segment. So nothing after the
// sort scans or sorts E elements again.
//
//   cm_edge_count_kernel  the pairs of a frame (4 offsets a pixel, mask
//       only): num_edge, by block sums and one integer atomic a block
//       (exact in any order);
//   cm_edge_pairs_kernel  the pairs' keys, decimated by the frame's stride
//       (from num_edge and the budget), and their pays, offset-major as the
//       plain version lays them out: torch.sort's stable order depends on
//       that layout;
//   (torch.sort, stable, of the keys: values and permutation)
//   cm_segments_kernel  one block a frame over the first E sorted keys: a
//       segment's size is found at its start by a galloping binary search
//       (no scan); the size gate; counts; a histogram of the gated sizes in
//       shared memory; the candidates compacted in position order (block
//       scans); the threshold size of the top C; the winners taken in
//       position order, ties at the threshold to the lower position (the
//       plain version's stable sort), then ranked by (size descending,
//       position);
//   cm_moments_kernel  one block a (frame, slot): the slot's resident pairs
//       are sorted positions [top_pos, top_pos + n), n = its size cut at E2
//       less the sizes of the slots before it (the plain version's second
//       sort and cut at E2; the count stays the uncut size). Pass 1 sums the
//       seven centroid terms in f64, exact whatever the order (each term is
//       a multiple of 1/4 under 2^24, a slot has at most 2^14 pairs). Pass 2
//       bins each pair about the centroid and adds its six f32 terms into
//       per-warp f64 tables in a fixed order: the lanes of one bin are
//       grouped by __match_any_sync and added by the group's lowest lane in
//       lane order; then the warps' tables are summed in warp order. No
//       float atomics: a call gives the same bits every time, so a captured
//       replay equals the eager call.
//
// Against the plain version: the integer outputs, the centroid and the
// scale are bit-exact (exact f64 sums, then the plain version's f32 and f64
// operations in its order, built with --fmad=false; IEEE division and
// square root, and rsqrtf as torch's CUDA rsqrt computes it). The bin
// tables are f64 sums of the same f32 terms in another order than the plain
// version's GEMM, so a cell may round to the neighbouring f32.
//
// What bounds it on an H100: bytes. The pair kernels read 5 B a pixel and
// write 32 B (key and pay at 4 offsets); the segments kernel reads the
// valid prefix of the first E sorted keys once (and a few keys again in its
// searches); the moments kernel reads each resident pair's permutation
// entry (8 B) and pay (4 B) twice, the second time from L1/L2. The sort
// between them is torch's.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int KBITS = 15;
constexpr int32_t KMAX = (1 << KBITS) - 1;     // dense id of a gated-out component
constexpr int32_t I32MAX = INT32_MAX;          // key of no pair
constexpr int NBINS = 64;
constexpr int NQ = 6;                          // terms a bin
constexpr int MAX_C = 128;
constexpr int PIX_THREADS = 256;
constexpr int SEG_THREADS = 1024;
constexpr int SEG_WARPS = SEG_THREADS / 32;
constexpr int MOM_THREADS = 256;
constexpr int MOM_WARPS = MOM_THREADS / 32;

struct Pair {
    bool m;
    int32_t key, pay;
};

// Offset o of (dx, dy): right, down, down-left, down-right (the plain
// version's _OFFSETS).
__device__ __forceinline__ int off_dx(int o) {
    return o == 0 ? 1 : (o == 1 ? 0 : (o == 2 ? -1 : 1));
}
__device__ __forceinline__ int off_dy(int o) { return o == 0 ? 0 : 1; }

// The pair of pixel (y, x) (trinary v0, id d0) and its neighbour at (dx, dy)
// of one frame, as the plain version's _pairs computes it in int32.
__device__ __forceinline__ Pair make_pair(const uint8_t* tri, const int32_t* dense, int H, int W,
                                          int y, int x, int v0, int32_t d0, int dx, int dy) {
    const int ny = y + dy, nx = x + dx;
    const bool in = nx >= 0 && nx < W && ny < H;
    const int v1 = in ? tri[(size_t)ny * W + nx] : 127;
    const int32_t d1 = in ? dense[(size_t)ny * W + nx] : KMAX;
    const bool black = v0 == 0;
    const int32_t db = black ? d0 : d1, dw = black ? d1 : d0;
    Pair p;
    p.m = v0 + v1 == 255 && db != KMAX && dw != KMAX;
    const int sgn = black ? 1 : -1;
    const int g = (dx * sgn + 1) | ((dy * sgn + 1) << 2);
    p.key = p.m ? (int32_t)(((uint32_t)db << KBITS) | (uint32_t)dw) : I32MAX;
    p.pay = (2 * x + dx) | ((2 * y + dy) << 12) | (g << 24);
    return p;
}

__device__ __forceinline__ int edge_stride(int num_edge, int budget) {
    return max(1, (num_edge + budget - 1) / budget);
}

__global__ void __launch_bounds__(PIX_THREADS)
cm_edge_count_kernel(const uint8_t* __restrict__ tri, const int32_t* __restrict__ dense,
                     int32_t* __restrict__ num_edge, int H, int W) {
    const int b = blockIdx.y;
    const int HW = H * W;
    tri += (size_t)b * HW;
    dense += (size_t)b * HW;
    const int p = blockIdx.x * PIX_THREADS + threadIdx.x;
    int c = 0;
    if (p < HW) {
        const int y = p / W, x = p - y * W;
        const int v0 = tri[p];
        const int32_t d0 = dense[p];
#pragma unroll
        for (int o = 0; o < 4; ++o)
            c += make_pair(tri, dense, H, W, y, x, v0, d0, off_dx(o), off_dy(o)).m;
    }
    __shared__ int warp_sum[PIX_THREADS / 32];
    c = __reduce_add_sync(FULL, c);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < PIX_THREADS / 32; ++w) c += warp_sum[w];
        if (c) atomicAdd(num_edge + b, c);
    }
}

__global__ void __launch_bounds__(PIX_THREADS)
cm_edge_pairs_kernel(const uint8_t* __restrict__ tri, const int32_t* __restrict__ dense,
                     const int32_t* __restrict__ num_edge, int32_t* __restrict__ key,
                     int32_t* __restrict__ pay, int H, int W, int budget) {
    const int b = blockIdx.y;
    const int HW = H * W;
    const int p = blockIdx.x * PIX_THREADS + threadIdx.x;
    if (p >= HW) return;
    tri += (size_t)b * HW;
    dense += (size_t)b * HW;
    key += (size_t)b * 4 * HW;
    pay += (size_t)b * 4 * HW;
    const unsigned stride = edge_stride(num_edge[b], budget);
    const int y = p / W, x = p - y * W;
    const int v0 = tri[p];
    const int32_t d0 = dense[p];
#pragma unroll
    for (int o = 0; o < 4; ++o) {
        const Pair q = make_pair(tri, dense, H, W, y, x, v0, d0, off_dx(o), off_dy(o));
        // Bits 15..30 of the int32-wrapped product pay * -1640531527.
        const unsigned hash = ((uint32_t)q.pay * 2654435769u >> 15) & 0xFFFFu;
        key[(size_t)o * HW + p] = q.m && hash % stride == 0 ? q.key : I32MAX;
        pay[(size_t)o * HW + p] = q.pay;
    }
}

// Block-wide exclusive prefix sum of one int a thread (SEG_THREADS threads,
// every thread calls it); *total gets the block's sum.
__device__ __forceinline__ int block_scan(int v, int* buf, int* total) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int inc = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int n = __shfl_up_sync(FULL, inc, d);
        if (lane >= d) inc += n;
    }
    if (lane == 31) buf[w] = inc;
    __syncthreads();
    if (w == 0) {
        const int s = buf[lane];            // SEG_WARPS == 32: one warp total a lane
        int si = s;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int n = __shfl_up_sync(FULL, si, d);
            if (lane >= d) si += n;
        }
        buf[lane] = si - s;
        if (lane == 31) buf[SEG_WARPS] = si;
    }
    __syncthreads();
    const int out = buf[w] + inc - v;
    *total = buf[SEG_WARPS];
    __syncthreads();                        // buf is free for the next scan
    return out;
}

// The first index in (i, n] whose key differs from ks[i] == k (n if none);
// the keys ascend. Gallops from i, then bisects.
__device__ __forceinline__ int segment_end(const int32_t* ks, int i, int n, int32_t k) {
    int lo = i + 1, hi = lo, step = 1;      // ks[lo - 1] == k
    while (hi < n && ks[hi] == k) {
        lo = hi + 1;
        hi = lo + step;
        step <<= 1;
    }
    hi = min(hi, n);                        // hi == n or ks[hi] != k
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (ks[mid] == k) lo = mid + 1;
        else hi = mid;
    }
    return lo;
}

static_assert(SEG_WARPS == 32, "block_scan takes one warp total a lane");

// Dynamic shared memory: (max_per + 1) ints, the histogram of gated sizes.
__global__ void __launch_bounds__(SEG_THREADS)
cm_segments_kernel(const int32_t* __restrict__ key_s, const int32_t* __restrict__ num_edge,
                   const uint8_t* __restrict__ comp_overflow, int32_t* __restrict__ cand_pos,
                   int32_t* __restrict__ cand_size, int32_t* __restrict__ top_pos,
                   int32_t* __restrict__ count, uint8_t* __restrict__ valid,
                   int32_t* __restrict__ n_clusters, int32_t* __restrict__ n_eligible,
                   int32_t* __restrict__ edge_stride_out, uint8_t* __restrict__ overflow, int row,
                   int E, int E2, int C, int min_pix, int max_per, int budget) {
    extern __shared__ int hist[];
    __shared__ int buf[SEG_WARPS + 1];
    __shared__ int s_nv, s_T, s_ngt;
    __shared__ int win_pos[MAX_C], win_size[MAX_C];
    const int b = blockIdx.x, t = threadIdx.x;
    const int32_t* ks = key_s + (size_t)b * row;
    cand_pos += (size_t)b * E;
    cand_size += (size_t)b * E;
    for (int s = t; s <= max_per; s += SEG_THREADS) hist[s] = 0;
    const int ne = num_edge[b];
    const int stride = edge_stride(ne, budget);
    if (t == 0) {                           // the valid keys are a prefix: its length
        int lo = 0, hi = E;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (ks[mid] < I32MAX) lo = mid + 1;
            else hi = mid;
        }
        s_nv = lo;
        s_T = INT_MAX;
        s_ngt = 0;
    }
    __syncthreads();
    const int nv = s_nv;

    // Pass over the valid keys, 4 a thread: segment starts, the size gate,
    // the histogram, and the candidates in position order.
    int n_first = 0, n_elig = 0, n_cand = 0;
    for (int base = 0; base < nv; base += 4 * SEG_THREADS) {
        const int i0 = base + 4 * t;
        int k[4];
        if (i0 + 3 < nv) {
            const int4 v = *reinterpret_cast<const int4*>(ks + i0);
            k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) k[j] = i0 + j < nv ? ks[i0 + j] : I32MAX;
        }
        int prev = i0 > 0 && i0 < nv ? ks[i0 - 1] : -1;
        int sz[4], nc = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int i = i0 + j;
            const bool first = i < nv && k[j] != prev;
            prev = k[j];
            long long true_size = 0;
            int cnt = 0;
            if (first) {
                cnt = segment_end(ks, i, nv, k[j]) - i;
                true_size = (long long)cnt * stride;
            }
            const bool elig = i < nv && true_size >= min_pix && true_size <= max_per;
            n_first += first;
            n_elig += elig;
            sz[j] = first && elig ? cnt : 0;
            if (sz[j]) {
                atomicAdd(hist + cnt, 1);
                ++nc;
            }
        }
        int tot;
        int at = n_cand + block_scan(nc, buf, &tot);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            if (sz[j]) {
                cand_pos[at] = i0 + j;
                cand_size[at] = sz[j];
                ++at;
            }
        }
        n_cand += tot;
    }
    int tot_first, tot_elig;
    block_scan(n_first, buf, &tot_first);
    block_scan(n_elig, buf, &tot_elig);
    if (min_pix <= 0) tot_elig += E - nv;   // the invalid positions' size 0 passes the gate

    // The threshold size T of the top `want`: thread t holds bins
    // [hi - per, hi), hi = NB - t per, so a scan in thread order runs from the
    // largest size down.
    const int want = min(C, n_cand);
    const int NB = max_per + 1;
    const int per = (NB + SEG_THREADS - 1) / SEG_THREADS;
    const int hi = NB - t * per, lo = max(0, hi - per);
    int mine = 0;
    for (int s = lo; s < hi; ++s) mine += hist[s];
    int tot_h;
    const int above = block_scan(mine, buf, &tot_h);
    if (want > 0 && above < want && above + mine >= want) {
        int acc = above;
        for (int s = hi - 1; s >= lo; --s) {
            if (acc + hist[s] >= want) {
                s_T = s;
                s_ngt = acc;
                break;
            }
            acc += hist[s];
        }
    }
    __syncthreads();
    const int T = s_T, ties = want - s_ngt;

    // The winners in position order: every size above T, and the first
    // `ties` candidates of size T.
    int n_win = 0, n_tie = 0;
    for (int base = 0; base < n_cand && n_win < want; base += SEG_THREADS) {
        const int i = base + t;
        const int size = i < n_cand ? cand_size[i] : 0;
        int tt, tw;
        const int tie_at = n_tie + block_scan(size == T, buf, &tt);
        const bool take = size > T || (size == T && tie_at < ties);
        const int win_at = n_win + block_scan(take, buf, &tw);
        if (take) {
            win_pos[win_at] = cand_pos[i];
            win_size[win_at] = size;
        }
        n_tie += tt;
        n_win += tw;
    }
    __syncthreads();

    // Rank the winners by (size descending, position ascending).
    int size = 0;
    if (t < want) {
        const int pos = win_pos[t];
        size = win_size[t];
        int r = 0;
        for (int u = 0; u < want; ++u) {
            const int su = win_size[u];
            r += su > size || (su == size && win_pos[u] < pos);
        }
        top_pos[(size_t)b * C + r] = pos;
        count[(size_t)b * C + r] = size;
        valid[(size_t)b * C + r] = 1;
    } else if (t < C) {
        top_pos[(size_t)b * C + t] = 0;
        count[(size_t)b * C + t] = 0;
        valid[(size_t)b * C + t] = 0;
    }
    int tot_size;
    block_scan(size, buf, &tot_size);
    if (t == 0) {
        n_clusters[b] = tot_first;
        n_eligible[b] = tot_elig;
        edge_stride_out[b] = stride;
        overflow[b] = ne > E || comp_overflow[b] || tot_elig > C || tot_size > E2;
    }
}

__device__ __forceinline__ void pair_terms(int32_t pv, float& x, float& y, float& gx, float& gy) {
    x = __fmul_rn((float)(pv & 0xFFF), 0.5f);
    y = __fmul_rn((float)((pv >> 12) & 0xFFF), 0.5f);
    const int gp = pv >> 24;
    gx = (float)((gp & 0x3) - 1);
    gy = (float)(((gp >> 2) & 0x3) - 1);
}

// The plain version's _diamond_bin: a monotone circular angle surrogate.
__device__ __forceinline__ int diamond_bin(float dx, float dy) {
    const float tiny = (float)1e-12;
    const float ax = fabsf(dx), ay = fabsf(dy);
    float den = __fadd_rn(ax, ay);
    if (den < tiny) den = tiny;
    float a;
    if (dy >= 0.0f) a = dx >= 0.0f ? __fdiv_rn(dy, den) : __fadd_rn(1.0f, __fdiv_rn(ax, den));
    else a = dx < 0.0f ? __fadd_rn(2.0f, __fdiv_rn(ay, den)) : __fadd_rn(3.0f, __fdiv_rn(dx, den));
    const int bin = (int)__fmul_rn(a, (float)(NBINS / 4));
    return min(max(bin, 0), NBINS - 1);
}

__global__ void __launch_bounds__(MOM_THREADS)
cm_moments_kernel(const int64_t* __restrict__ perm, const int32_t* __restrict__ pay,
                  const int32_t* __restrict__ top_pos, const int32_t* __restrict__ count,
                  float* __restrict__ table, float* __restrict__ centroid,
                  float* __restrict__ scale, uint8_t* __restrict__ dark, int row, int C, int E2) {
    __shared__ double wt[MOM_WARPS][NBINS * NQ];
    __shared__ float stage[MOM_WARPS][32][NQ];
    __shared__ double part[MOM_WARPS][7];
    __shared__ float s_cx, s_cy, s_inv;
    __shared__ int s_n, s_p;
    const int j = blockIdx.x, b = blockIdx.y, t = threadIdx.x, lane = t & 31, w = t >> 5;
    const size_t slot = (size_t)b * C + j;
    if (w == 0) {                           // pairs of the slots before this one
        int o = 0;
        for (int k = lane; k < j; k += 32) o += count[(size_t)b * C + k];
        o = __reduce_add_sync(FULL, o);
        if (lane == 0) {
            s_n = max(0, min(count[slot], E2 - o));
            s_p = top_pos[slot];
        }
    }
    for (int c = t; c < MOM_WARPS * NBINS * NQ; c += MOM_THREADS) (&wt[0][0])[c] = 0.0;
    __syncthreads();
    const int n = s_n;
    const int64_t* pm = perm + (size_t)b * row + s_p;
    const int32_t* py = pay + (size_t)b * row;

    // Pass 1: the seven centroid terms, summed exactly in f64.
    double acc[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int i = t; i < n; i += MOM_THREADS) {
        float x, y, gx, gy;
        pair_terms(py[pm[i]], x, y, gx, gy);
        acc[0] += 1.0;
        acc[1] += x;
        acc[2] += y;
        acc[3] += __fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y));
        acc[4] += gx;
        acc[5] += gy;
        acc[6] += __fadd_rn(__fmul_rn(x, gx), __fmul_rn(y, gy));
    }
#pragma unroll
    for (int q = 0; q < 7; ++q) {
        for (int d = 16; d > 0; d >>= 1) acc[q] += __shfl_down_sync(FULL, acc[q], d);
        if (lane == 0) part[w][q] = acc[q];
    }
    __syncthreads();
    if (t == 0) {
        double c[7];
        float f[7];
        for (int q = 0; q < 7; ++q) {
            c[q] = part[0][q];
            for (int u = 1; u < MOM_WARPS; ++u) c[q] = __dadd_rn(c[q], part[u][q]);
            f[q] = __double2float_rn(c[q]);
        }
        const float safe = f[0] < 1.0f ? 1.0f : f[0];
        const float cx = __fdiv_rn(f[1], safe), cy = __fdiv_rn(f[2], safe);
        const double s64 = (double)safe;
        const double m1 = __ddiv_rn(c[1], s64), m2 = __ddiv_rn(c[2], s64);
        float r2 = __double2float_rn(
            __dsub_rn(__dsub_rn(__ddiv_rn(c[3], s64), __dmul_rn(m1, m1)), __dmul_rn(m2, m2)));
        const float tiny = (float)1e-12;
        if (r2 < tiny) r2 = tiny;
        const float mean_dot = __fdiv_rn(
            __fsub_rn(__fsub_rn(f[6], __fmul_rn(cx, f[4])), __fmul_rn(cy, f[5])), safe);
        centroid[2 * slot] = cx;
        centroid[2 * slot + 1] = cy;
        scale[slot] = __fsqrt_rn(r2);
        dark[slot] = mean_dot > 0.0f;
        s_cx = cx;
        s_cy = cy;
        s_inv = rsqrtf(r2);
    }
    __syncthreads();
    const float cx = s_cx, cy = s_cy, inv = s_inv;

    // Pass 2: each pair's six terms into its warp's table at its bin, in
    // (iteration, lane) order; inactive lanes form a group of their own.
    for (int base = 0; base < n; base += MOM_THREADS) {
        const int i = base + t;
        int bin = NBINS;
        if (i < n) {
            float x, y, gx, gy;
            pair_terms(py[pm[i]], x, y, gx, gy);
            const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy);
            bin = diamond_bin(dx, dy);
            const float sx = __fmul_rn(dx, inv), sy = __fmul_rn(dy, inv);
            float* st = stage[w][lane];
            st[0] = 1.0f;
            st[1] = sx;
            st[2] = sy;
            st[3] = __fmul_rn(sx, sx);
            st[4] = __fmul_rn(sx, sy);
            st[5] = __fmul_rn(sy, sy);
        }
        __syncwarp();
        const unsigned grp = __match_any_sync(FULL, bin);
        if (bin < NBINS && lane == __ffs(grp) - 1) {
            double* cell = wt[w] + bin * NQ;
            for (unsigned m = grp; m; m &= m - 1) {
                const float* st = stage[w][__ffs(m) - 1];
#pragma unroll
                for (int q = 0; q < NQ; ++q) cell[q] = __dadd_rn(cell[q], (double)st[q]);
            }
        }
        __syncwarp();
    }
    __syncthreads();
    float* out = table + slot * NBINS * NQ;
    for (int c = t; c < NBINS * NQ; c += MOM_THREADS) {
        double s = wt[0][c];
        for (int u = 1; u < MOM_WARPS; ++u) s = __dadd_rn(s, wt[u][c]);
        out[c] = __double2float_rn(s);
    }
}

}  // namespace

extern "C" int apriltag_cm_count(const void* tri, const void* dense, void* num_edge, int B,
                                 int H, int W, void* stream) {
    const dim3 grid((H * W + PIX_THREADS - 1) / PIX_THREADS, B);
    cm_edge_count_kernel<<<grid, PIX_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)tri, (const int32_t*)dense, (int32_t*)num_edge, H, W);
    return (int)cudaGetLastError();
}

extern "C" int apriltag_cm_pairs(const void* tri, const void* dense, const void* num_edge,
                                 void* key, void* pay, int B, int H, int W, int budget,
                                 void* stream) {
    if (budget < 1) return (int)cudaErrorInvalidValue;
    const dim3 grid((H * W + PIX_THREADS - 1) / PIX_THREADS, B);
    cm_edge_pairs_kernel<<<grid, PIX_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)tri, (const int32_t*)dense, (const int32_t*)num_edge, (int32_t*)key,
        (int32_t*)pay, H, W, budget);
    return (int)cudaGetLastError();
}

extern "C" int apriltag_cm_segments(const void* key_s, const void* num_edge,
                                    const void* comp_overflow, void* cand_pos, void* cand_size,
                                    void* top_pos, void* count, void* valid, void* n_clusters,
                                    void* n_eligible, void* edge_stride, void* overflow, int B,
                                    int row, int E, int E2, int C, int min_pix, int max_per,
                                    int budget, void* stream) {
    if (budget < 1 || C < 1 || C > MAX_C || E < 1 || E > row || max_per < 0)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(max_per + 1) * sizeof(int);
    // Past 48 KB with the static arrays (about 1.2 KB) the kernel must opt in.
    if (smem > 40 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            cm_segments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    cm_segments_kernel<<<B, SEG_THREADS, smem, (cudaStream_t)stream>>>(
        (const int32_t*)key_s, (const int32_t*)num_edge, (const uint8_t*)comp_overflow,
        (int32_t*)cand_pos, (int32_t*)cand_size, (int32_t*)top_pos, (int32_t*)count,
        (uint8_t*)valid, (int32_t*)n_clusters, (int32_t*)n_eligible, (int32_t*)edge_stride,
        (uint8_t*)overflow, row, E, E2, C, min_pix, max_per, budget);
    return (int)cudaGetLastError();
}

extern "C" int apriltag_cm_moments(const void* perm, const void* pay, const void* top_pos,
                                   const void* count, void* table, void* centroid, void* scale,
                                   void* dark, int B, int row, int C, int E2, void* stream) {
    if (C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
    const dim3 grid(C, B);
    cm_moments_kernel<<<grid, MOM_THREADS, 0, (cudaStream_t)stream>>>(
        (const int64_t*)perm, (const int32_t*)pay, (const int32_t*)top_pos,
        (const int32_t*)count, (float*)table, (float*)centroid, (float*)scale, (uint8_t*)dark,
        row, C, E2);
    return (int)cudaGetLastError();
}
