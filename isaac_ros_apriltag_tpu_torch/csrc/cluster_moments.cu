// Cluster moments: (B, H, W) trinary + area-gated dense component ids ->
// per-cluster angular moment tables, in nine launches: the pair count, the
// kept pairs' sort (one histogram pass, then four launches of one kernel, a
// radix pass each, the first of which builds the pairs from the pixels), the
// two segment kernels and the moments kernel.
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
// sort scans or sorts E elements again. The reference sorts the whole
// padded row of 4 H W pair slots; here only the kept pairs are sorted, by a
// stable LSD radix sort written by hand, which gives the same order: keys
// ascending, ties in the padded layout's order (offset o major, then pixel
// p).
//
//   cm_edge_count_kernel<VEC>  the pairs of a frame (4 offsets a pixel,
//       mask only): num_edge. 4 pixels a thread through the histogram
//       pass's loader (load_quad: where W % 4 == 0, the pixels' row and
//       the row below as vector loads); a pair is a byte compare
//       (quad_pair_bits) and its two ids' != KMAX a bit mask of the 5 ids
//       of the row and the 6 below, counted by __popc, no pair built (else
//       each pixel reads its own neighbours). A fixed grid of one wave
//       strides over each frame's 1024-pixel blocks; one integer atomic a
//       block (exact in any order);
//   cm_pair_count_kernel  the sort's one histogram pass: a block 1024
//       pixels of a frame (4 a thread, their pairs found by byte compares
//       and built only where they exist), each kept key counted into every
//       pass's digit counts (runs of one key merged across a thread's
//       pixels and a warp's lanes: a run has one digit in every pass; a
//       shared-memory table a pass, the first pass's by offset; one integer
//       atomic a nonzero bin), the kept count K, each first-pass tile's
//       count of each first digit and their sums over groups of 16 tiles
//       (the counters and sums zeroed by one memset on the stream);
//   cm_radix_scatter_kernel<SRC, KPT>  one launch a pass, four passes: the
//       first takes the key's low 6 bits, the later three 8 bits each (the
//       key's 30 bits: two 15-bit dense ids). The first pass (SRC pixels)
//       reads the pixels: a block a (frame, 1024-pixel block), its tiles
//       (offset o, block); a kept pair goes to its digit's first position,
//       plus its digit's keys at the offsets before o, plus those of the
//       tiles before its own at o (the histogram pass's sums of the groups
//       before the tile's group, then its group's tiles before it: a few
//       loads, no look-back, so no block waits on another), plus its rank
//       in its tile: the warps before its warp (their counts by digit), then
//       its rank in its warp's pairs of its digit in pixel order (the warp's
//       kept digits compacted in order, ranked 32 at a time by
//       __match_any_sync). Key and pay go out from registers, and the pass
//       zeroes pass 1's look-back words of the live tiles. A later pass
//       (SRC rows) reads the rows in the onesweep form: a block a sort tile
//       of 256 KPT positions in [0, K) at a time, the tiles taken in order
//       from the frame's counter; a key's rank among the tile's keys of its
//       digit is its rank in its warp's run of 32 KPT positions
//       (__match_any_sync groups, chunk by chunk in position order) plus the
//       counts of the warps before it, so equal digits keep their order;
//       the keys of its digit in the tiles before come by decoupled
//       look-back over the tiles' published counts. Each pass but the last
//       zeroes the next pass's look-back words of the live tiles; the last
//       writes I32MAX into [K, E) of its row, so [0, max(K, E)) reads as
//       the reference's sorted padded row;
//   cm_seg_tiles_kernel  a tile of SEG_TILE sorted keys a warp (16 a lane,
//       four int4 loads at once), a grid of one wave whose warps walk a
//       frame's tiles with the next tile's loads in flight: the segment
//       starts; each start's size from the next start in the tile (a warp
//       suffix minimum, no search, no barrier), the tile's last start left
//       to the top kernel when its segment runs past the tile; the size
//       gate; the tile's candidates compacted in position order; one
//       integer atomic a candidate into the frame's size histogram (zeroed
//       by the sort's memset in the stage); the tile's counts, first start,
//       largest candidate and crossing start; a walk's first tile past the
//       valid prefix writes its later tiles' fields at once;
//   cm_seg_top_kernel  one block of 256 threads a frame over the tiles'
//       fields, four tiles a thread: the histogram loaded into shared
//       memory (opted in past 48 KB) with the fields in one round, each
//       warp's 32 bins of a round summed into a coarse bin; each crossing
//       segment's size from the first start of a later tile (a suffix
//       minimum over tiles: one barrier) into both histograms; the
//       threshold size T of the top C found by every warp alone (the coarse
//       bin by a warp scan, then T by a warp scan of its 32 bins); the
//       candidates of the tiles that hold a size >= T laid out in position
//       order by a block scan and loaded in one round, a run of them a
//       thread; ties at T to the lower position by a block scan of the
//       size-T entries, each winner at T ranked ngt + its place there, the
//       ngt winners above T ranked by (size descending, position) against
//       their list in shared memory. Six barriers of 8 warps and two
//       rounds of dependent loads a frame;
//   cm_moments_kernel  the slots' moments: a slot's resident pairs are
//       sorted positions [top_pos, top_pos + n), n = its size cut at E2
//       less the sizes of the slots before it (the plain version's second
//       sort and cut at E2; the count stays the uncut size), their pays
//       read where the sort left them. A slot takes w = ceil(n / per)
//       rounded up to a power of two warps (at most 8), each an equal range
//       of its pairs (per 64 at one or two frames a launch, else 128); a
//       frame's slots take consecutive warps of 8-warp blocks in slot
//       order, so a slot lies in one block (the top-C ranks slots by size,
//       so w never grows from slot to slot; where it does, slot j takes
//       block j alone). Pass 1 sums the seven centroid terms as integers
//       (2 x, 2 y, 4 (x^2 + y^2) as rounded in f32, ...): the plain
//       version's f64 sums, which are exact whatever the order; each warp
//       of a slot finds the centroid from them. Pass 2 takes a warp's
//       pairs 32 at a time, a pair a lane: each lane bins its pair about
//       the centroid, the lanes are ranked by bin (ballots) and stage
//       their five f32 terms in that order, a segmented tree of f64
//       shuffles sums each bin's segment, and its head adds the sums into
//       the warp's f64 table (add_bins: no serial chain, one add a bin);
//       then the slot's warp tables are summed in warp order. No float
//       atomics, and the order is fixed: a call gives the same bits every
//       time, so a captured replay equals the eager call.
//
// In a later radix pass a block waits only on tiles taken before its own,
// whose blocks run and publish their own counts before they wait on
// anything; in the first pass no block waits. The counts are integer adds, exact in any
// order, and every position comes from counts and ranks, so the sort gives
// the same bits every call.
//
// Against the plain version: the integer outputs, the centroid and the
// scale are bit-exact (exact f64 sums, then the plain version's f32 and f64
// operations in its order, built with --fmad=false; IEEE division and
// square root, and rsqrtf as torch's CUDA rsqrt computes it). The bin
// tables are f64 sums of the same f32 terms in another order than the plain
// version's GEMM, so a cell may round to the neighbouring f32. The sorted
// keys and pays are those of torch.sort(stable=True) on the padded row, bit
// for bit.
//
// What bounds it on an H100: bytes in principle, latency in fact. The
// histogram and the first pass read 5 B a pixel each (tri, dense; the
// neighbours from L1), the first pass writes 8 B a kept pair; each later
// pass reads and writes 8 B a kept pair (the look-back words stay in L2);
// the tiles kernel reads the valid prefix of the first E sorted keys once,
// a tile a warp's short chain, so it runs as one wave of warps with no
// barrier, each warp's next tile loading under its current one; the top
// kernel reads 20 B a tile and the candidates of the few tiles that reach
// T, but one block a frame is a chain of loads and barriers, so latency
// bounds it, and its design is that chain made short; the moments kernel reads each resident pair's pay (4 B) twice,
// the second time from L1, in blocks whose warps are sized to the slots, and
// a block is a chain of loads, shuffles and barriers too. The pixel kernels
// run far from their bytes: a block's loads, shuffles and barriers in a
// chain. So the sort is written
// as few launches and passes over the data: the pixels are read twice, the
// kept pairs written once in the first pass's order (no compaction in
// layout order read back), every pass's digit counts come from the one
// histogram pass, and a pass needs no histogram kernel or scan of its own.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "stamps.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int KBITS = 15;
constexpr int32_t KMAX = (1 << KBITS) - 1;     // dense id of a gated-out component
constexpr int32_t I32MAX = INT32_MAX;          // key of no pair
constexpr int NBINS = 64;
constexpr int NQ = 6;                          // terms a bin
constexpr int MAX_C = 128;
constexpr int PIX_THREADS = 256;
constexpr int SEG_TILE = 512;                  // sorted keys a tile of cm_seg_tiles_kernel
constexpr int SEG_POS_BITS = 10;               // a candidate's offset in its tile, under its size
constexpr int SEG_KPT = SEG_TILE / 32;         // keys a lane of a tile's warp: four int4 loads
constexpr int SEG_THREADS = 128;               // threads a block of cm_seg_tiles_kernel
constexpr int SEG_WARPS = SEG_THREADS / 32;
constexpr int SEG_MAX_PER = (1 << 15) - 1;    // the largest max_per: the top kernel's
                                               // histogram in 128 KB of shared memory
// A tile's fields (stats[b, f, tile]): its starts, its compacted candidates,
// their largest size, its first start (INT_MAX: none), and its crossing
// start (-1: none).
constexpr int ST_STARTS = 0, ST_CANDS = 1, ST_MAX = 2, ST_FIRST = 3, ST_CROSS = 4, SEG_STATS = 5;
constexpr int TOP_THREADS = 256;
constexpr int TOP_WARPS = TOP_THREADS / 32;
constexpr int TOP_TPT = 4;                     // tiles a thread of cm_seg_top_kernel
constexpr int TOP_CHUNK = TOP_THREADS * TOP_TPT;   // tiles a chunk: 2^19 keys
constexpr int TOP_BIN = 32;                    // sizes a coarse bin: a warp's bins of a round
constexpr int TOP_HIST_ROUND = 24;             // histogram bins a thread loads at once
constexpr int TOP_PER = 8;                     // pass-2 entries a thread a round
constexpr int TOP_CPL = 8;                     // coarse bins a lane holds in registers
static_assert(SEG_TILE <= (1 << SEG_POS_BITS) && SEG_MAX_PER < (1 << (31 - SEG_POS_BITS)),
              "a candidate's offset and size must fit its fields");
static_assert(SEG_KPT == 16 && SEG_THREADS % 32 == 0 && TOP_THREADS >= MAX_C,
              "a tile's four int4 loads a lane (its start mask under 32 bits); a thread a slot");
constexpr int MOM_THREADS = 256;
constexpr int MOM_WARPS = MOM_THREADS / 32;
// Resident pairs a warp of the moments kernel, about: 64 at one or two
// frames a launch (the card has warps to spare: shorter chains), 128 from
// three on (fewer blocks: about one wave at 8 frames).
constexpr int MOM_FEW_FRAMES = 2;
constexpr int MOM_LANE_PAIRS = 4;              // a lane's loads at once in pass 1
static_assert(MAX_C <= 4 * 32 && (MOM_WARPS & (MOM_WARPS - 1)) == 0,
              "the moments kernel's warp 0 reads 4 slots a lane; warps a slot are powers of two");
// The kept pairs' sort. The histogram pass and the first radix pass take
// PAIR_BLOCK pixels a block, 4 consecutive ones a thread, so warp w holds
// the block's pixels [128 w, 128 w + 128) in order. A frame's tiles of the
// first pass are (offset o, pixel block), o-major, as the padded layout
// orders the pairs. A later pass's sort tile is SORT_THREADS * KPT
// positions, warp w's run of 32 KPT from w * 32 KPT, its i-th chunk of 32
// at i * 32. The first pass takes the key's low FIRST_BITS bits (R0
// digits: 4 R0 chains of (offset, digit), one a thread), each later pass k
// the RADIX_BITS above: (key >> digit_shift(k)) & (RADIX - 1), one digit a
// thread. Pass k's digit counts lie in digits[k, b, digit], the first
// pass's by offset in odig[b, o, digit]; each first-pass tile's counts in
// tcnt[b, o, block, digit] and their sums over groups of FIRST_GROUP tiles
// in gsum[b, o, group, digit]; pass k's look-back words (k >= 1) in
// look[k - 1, b, tile, digit], its tile counter in ctl[b, k].
constexpr int PAIR_THREADS = 256;
constexpr int PAIR_WARPS = PAIR_THREADS / 32;
constexpr int PAIR_BLOCK = PAIR_THREADS * 4;   // pixels a block, 4 a thread
constexpr int SORT_THREADS = 256;
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int KEY_BITS = 2 * KBITS;            // keys are under 2^30: two 15-bit dense ids
constexpr int RADIX_BITS = 8;                  // a later pass's digit
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int SORT_PASSES = 4;
constexpr int FIRST_BITS = KEY_BITS - (SORT_PASSES - 1) * RADIX_BITS;   // the first pass's: 6
constexpr int R0 = 1 << FIRST_BITS;
constexpr int FIRST_GROUP = 16;                // first-pass tiles a group of the prefix's sums
static_assert(PAIR_THREADS == SORT_THREADS && RADIX == SORT_THREADS && 4 * R0 == SORT_THREADS,
              "one block shape: a thread a later digit, a thread a first-pass chain");

__host__ __device__ constexpr int digit_shift(int k) {   // pass k's digit's low bit
    return k ? FIRST_BITS + (k - 1) * RADIX_BITS : 0;
}

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
// (trinary v1, id d1: 127 and KMAX outside the frame), as the plain
// version's _pairs computes it in int32.
__device__ __forceinline__ Pair pair_of(int v0, int32_t d0, int v1, int32_t d1, int y, int x,
                                        int dx, int dy) {
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

// The same pair, its neighbour read from the frame.
__device__ __forceinline__ Pair make_pair(const uint8_t* tri, const int32_t* dense, int H, int W,
                                          int y, int x, int v0, int32_t d0, int dx, int dy) {
    const int ny = y + dy, nx = x + dx;
    const bool in = nx >= 0 && nx < W && ny < H;
    return pair_of(v0, d0, in ? tri[(size_t)ny * W + nx] : 127,
                   in ? dense[(size_t)ny * W + nx] : KMAX, y, x, dx, dy);
}

// The 4 pixels p .. p + 3 of one row and their neighbours, as the pixel
// kernels' vector path loads them (W % 4 == 0 and p % 4 == 0, so the 4
// pixels lie in one row, and tri and dense rows are 4- and 16-byte aligned):
// the pixels' row and the row below as vector loads, the columns beside
// them as scalars. `a` holds the pixels' trinary bytes, nb[o] byte i the
// trinary of pixel p + i's neighbour at offset o (127 outside the frame);
// d0 the ids of row y at x .. x + 4, d1 those of row y + 1 at x - 1 .. x + 4
// (KMAX outside the frame).
struct Quad {
    int y, x;
    uint32_t a, nb[4];
    int32_t d0[5], d1[6];
};

__device__ __forceinline__ void load_quad(const uint8_t* tri, const int32_t* dense, int H, int W,
                                          int p, Quad& q) {
    q.y = p / W;
    q.x = p - q.y * W;
    const bool right = q.x + 4 < W, left = q.x > 0, down = q.y + 1 < H;
    q.a = *reinterpret_cast<const uint32_t*>(tri + p);
    const int4 da = *reinterpret_cast<const int4*>(dense + p);
    q.d0[0] = da.x; q.d0[1] = da.y; q.d0[2] = da.z; q.d0[3] = da.w;
    const uint32_t r0 = right ? tri[p + 4] : 127u;
    q.d0[4] = right ? dense[p + 4] : KMAX;
    uint32_t c = 0x7F7F7F7Fu, l1 = 127u, r1 = 127u;   // the row below (127: outside the frame)
    if (down) {
        c = *reinterpret_cast<const uint32_t*>(tri + p + W);
        const int4 dc = *reinterpret_cast<const int4*>(dense + p + W);
        q.d1[1] = dc.x; q.d1[2] = dc.y; q.d1[3] = dc.z; q.d1[4] = dc.w;
        l1 = left ? tri[p + W - 1] : 127u;
        q.d1[0] = left ? dense[p + W - 1] : KMAX;
        r1 = right ? tri[p + W + 4] : 127u;
        q.d1[5] = right ? dense[p + W + 4] : KMAX;
    } else {
#pragma unroll
        for (int i = 0; i < 6; ++i) q.d1[i] = KMAX;
    }
    q.nb[0] = (q.a >> 8) | (r0 << 24);
    q.nb[1] = c;
    q.nb[2] = (c << 8) | l1;
    q.nb[3] = (c >> 8) | (r1 << 24);
}

// Trinary values are 0, 127 or 255, so two pixels pair (sum 255) exactly
// when their bytes XOR to 0xFF: bit i of the result is set when pixel p + i
// pairs with its neighbour at offset o, whatever their ids.
__device__ __forceinline__ unsigned quad_pair_bits(const Quad& q, int o) {
    const uint32_t pm = __vcmpeq4(q.a ^ q.nb[o], 0xFFFFFFFFu) & 0x01010101u;
    return (pm | pm >> 7 | pm >> 14 | pm >> 21) & 0xFu;
}

// The id of pixel p + i's neighbour at offset o.
__device__ __forceinline__ int32_t quad_nb_id(const Quad& q, int o, int i) {
    return o == 0 ? q.d0[i + 1] : q.d1[o == 1 ? i + 1 : (o == 2 ? i : i + 2)];
}

// The 16 pairs q[o][i] of the 4 pixels p + i of a frame (offset o of
// pixel p + i; q.m false past the frame). VEC: the 4 pixels come by
// load_quad, and only the pairs its byte compares find are built. Else each
// pixel reads its own neighbours.
template <bool VEC>
__device__ __forceinline__ void quad_pairs(const uint8_t* tri, const int32_t* dense, int H, int W,
                                           int HW, int p, Pair (&q)[4][4]) {
    if constexpr (VEC) {
        if (p >= HW) {
#pragma unroll
            for (int o = 0; o < 4; ++o)
#pragma unroll
                for (int i = 0; i < 4; ++i) q[o][i] = Pair{false, I32MAX, 0};
            return;
        }
        Quad qd;
        load_quad(tri, dense, H, W, p, qd);
#pragma unroll
        for (int o = 0; o < 4; ++o) {
            const unsigned pm = quad_pair_bits(qd, o);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                q[o][i] = Pair{false, I32MAX, 0};
                if ((pm >> i) & 1u)
                    q[o][i] = pair_of((qd.a >> (8 * i)) & 0xFF, qd.d0[i], (qd.nb[o] >> (8 * i)) & 0xFF,
                                      quad_nb_id(qd, o, i), qd.y, qd.x + i, off_dx(o), off_dy(o));
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int pi = p + i;
            if (pi < HW) {
                const int y = pi / W, x = pi - y * W;
                const int v = tri[pi];
                const int32_t d = dense[pi];
#pragma unroll
                for (int o = 0; o < 4; ++o)
                    q[o][i] = make_pair(tri, dense, H, W, y, x, v, d, off_dx(o), off_dy(o));
            } else {
#pragma unroll
                for (int o = 0; o < 4; ++o) q[o][i] = Pair{false, I32MAX, 0};
            }
        }
    }
}

__device__ __forceinline__ int edge_stride(int num_edge, int budget) {
    return max(1, (num_edge + budget - 1) / budget);
}

// The pairs of 4 pixels p .. p + 3 (p < H W): VEC, from load_quad's bytes
// and ids, without building a pair: a pair exists where the byte compare
// finds it and neither id is KMAX, a bit mask of the 4 + 1 ids of row y and
// the 6 of row y + 1; else from quad_pairs' masks.
template <bool VEC>
__device__ __forceinline__ int quad_count(const uint8_t* tri, const int32_t* dense, int H, int W,
                                          int HW, int p) {
    int c = 0;
    if constexpr (VEC) {
        Quad q;
        load_quad(tri, dense, H, W, p, q);
        unsigned k0 = 0, k1 = 0;     // bit i: d0[i] != KMAX; bit j: d1[j] != KMAX
#pragma unroll
        for (int i = 0; i < 5; ++i) k0 |= (unsigned)(q.d0[i] != KMAX) << i;
#pragma unroll
        for (int j = 0; j < 6; ++j) k1 |= (unsigned)(q.d1[j] != KMAX) << j;
        const unsigned kn[4] = {k0 >> 1, k1 >> 1, k1, k1 >> 2};   // the neighbour's, by pixel
#pragma unroll
        for (int o = 0; o < 4; ++o) c += __popc(quad_pair_bits(q, o) & k0 & kn[o]);
    } else {
        Pair q[4][4];
        quad_pairs<false>(tri, dense, H, W, HW, p, q);
#pragma unroll
        for (int o = 0; o < 4; ++o)
#pragma unroll
            for (int i = 0; i < 4; ++i) c += q[o][i].m;
    }
    return c;
}

// A fixed grid of gridDim.x blocks a frame (a few an SM in all) strides over
// the frame's 1024-pixel blocks, 4 pixels a thread, so a frame takes
// gridDim.x integer atomics.
template <bool VEC>
__global__ void __launch_bounds__(PIX_THREADS)
cm_edge_count_kernel(const uint8_t* __restrict__ tri, const int32_t* __restrict__ dense,
                     int32_t* __restrict__ num_edge, int H, int W) {
    const int b = blockIdx.y;
    const int HW = H * W;
    tri += (size_t)b * HW;
    dense += (size_t)b * HW;
    int c = 0;
    for (int p = 4 * (blockIdx.x * PIX_THREADS + threadIdx.x); p < HW;
         p += 4 * PIX_THREADS * gridDim.x)
        c += quad_count<VEC>(tri, dense, H, W, HW, p);
    __shared__ int warp_sum[PIX_THREADS / 32];
    c = __reduce_add_sync(FULL, c);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < PIX_THREADS / 32; ++w) c += warp_sum[w];
        if (c) atomicAdd(num_edge + b, c);
    }
}

// Block-wide exclusive prefix sum of one int a thread (NT threads, every
// thread calls it); *total gets the block's sum.
template <int NT>
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
    int before = 0, all = 0;
#pragma unroll
    for (int u = 0; u < NT / 32; ++u) {
        const int s = buf[u];
        before += u < w ? s : 0;
        all += s;
    }
    *total = all;
    __syncthreads();                        // buf is free for the next scan
    return before + inc - v;
}

// A pair is kept when its hash is a multiple of the frame's stride: bits
// 15..30 of the int32-wrapped product pay * -1640531527.
__device__ __forceinline__ bool kept_pair(const Pair& q, unsigned stride) {
    if (stride == 1) return q.m;            // no decimation: no division
    const unsigned hash = ((uint32_t)q.pay * 2654435769u >> 15) & 0xFFFFu;
    return q.m && hash % stride == 0;
}

// A look-back word of a radix pass: a tile's count of one digit (the low
// 30 bits), the tile's own (LB_AGG) or with every tile before it in its
// chain (LB_INCL); 0 until the tile's block publishes it. One word holds
// both, so a word read is whole and needs no fence.
constexpr int LB_AGG = 1 << 30, LB_INCL = INT_MIN, LB_COUNT = LB_AGG - 1;

__device__ __forceinline__ int load_relaxed(const int32_t* p) {
    int v;
    asm volatile("ld.relaxed.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_relaxed(int32_t* p, int v) {
    asm volatile("st.relaxed.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Decoupled look-back over one chain: the word of tile q at w + q step,
// read LB_READS tiles at once from the nearest before `tile`, counts added
// back to the first LB_INCL word (a word not yet published is read again;
// before the first tile an inclusive 0). Returns the chain's count in the
// tiles before `tile`. Every tile a reader waits on belongs to a block that
// runs and publishes its own word before it waits on any.
constexpr int LB_READS = 8;                    // words a thread reads at once

__device__ __forceinline__ int look_back(const int32_t* w, size_t step, int tile) {
    int before = 0;
    for (int qt = tile - 1; qt >= 0;) {
        int word[LB_READS];
#pragma unroll
        for (int u = 0; u < LB_READS; ++u)
            word[u] = qt - u >= 0 ? load_relaxed(w + (size_t)(qt - u) * step) : LB_INCL;
        int u = 0;
        bool done = false;
#pragma unroll
        for (; u < LB_READS; ++u) {
            if (word[u] == 0) break;            // not published yet: read again from here
            before += word[u] & LB_COUNT;
            if (word[u] & LB_INCL) {
                done = true;
                break;
            }
        }
        if (done) break;
        qt -= u;
    }
    return before;
}

// A warp's lanes each hold at most one run of `len` equal keys (key < 0:
// none), consecutive lanes in the keys' order: the last lane of each
// segment of lanes that hold one key gets the segment's summed length (the
// others 0), so each segment is counted once.
__device__ __forceinline__ int lane_run_total(int32_t key, int len) {
    const int lane = threadIdx.x & 31;
    const int32_t key_before = __shfl_up_sync(FULL, key, 1);   // every lane takes part
    const unsigned heads = __ballot_sync(FULL, lane == 0 || key_before != key);
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int n = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += n;
    }
    const int first = 31 - __clz(heads & ((2u << lane) - 1u));
    const int ahead = __shfl_sync(FULL, incl, first > 0 ? first - 1 : 0);
    const bool tail = lane == 31 || ((heads >> (lane + 1)) & 1u);
    return tail && key >= 0 ? incl - (first > 0 ? ahead : 0) : 0;
}

// The histogram pass's shared tables: the first pass's digit by offset,
// then each later pass's digit.
struct HistTables {
    int first[4][R0];
    int later[SORT_PASSES - 1][RADIX];
};

// A run of `len` kept keys equal to `key` at offset o into every pass's
// table (a run of equal keys has equal digits in every pass).
__device__ __forceinline__ void add_run(HistTables& h, int o, int32_t key, int len) {
    atomicAdd(&h.first[o][key & (R0 - 1)], len);
#pragma unroll
    for (int k = 1; k < SORT_PASSES; ++k)
        atomicAdd(&h.later[k - 1][(key >> digit_shift(k)) & (RADIX - 1)], len);
}

// The histogram pass, the sort's only one: a block PAIR_BLOCK pixels of
// frame blockIdx.y, 4 consecutive ones a thread. Each kept pair's key adds
// into every pass's digit count: a thread's runs of equal kept keys at one
// offset merged, then a segment of lanes that hold one key (a horizontal
// edge spans many), one shared atomic a run and pass; then one integer
// atomic a nonzero bin into odig[b, o] (the first pass's digits by offset),
// digits[0, b] (their sum over o) and digits[k, b], and one a block into
// kept[b]; all zeroed by the launcher's memset. The block's pixels are the
// first pass's tile (o, blockIdx.x) at each offset: the block writes the
// tile's count of each first digit (tcnt) and adds it into its group's
// sums (gsum, integer atomics), so the first pass finds the keys of the
// tiles before its own in a few loads and never waits on another block.
template <bool VEC>
__global__ void __launch_bounds__(PAIR_THREADS)
cm_pair_count_kernel(const uint8_t* __restrict__ tri, const int32_t* __restrict__ dense,
                     const int32_t* __restrict__ num_edge, int32_t* __restrict__ digits,
                     int32_t* __restrict__ odig, int32_t* __restrict__ gsum,
                     int32_t* __restrict__ kept, int32_t* __restrict__ tcnt, int H, int W,
                     int budget) {
    __shared__ HistTables hist;
    __shared__ int red[PAIR_WARPS];
    const int b = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x, B = gridDim.y;
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const int HW = H * W;
    tri += (size_t)b * HW;
    dense += (size_t)b * HW;
    for (int i = t; i < (int)(sizeof(hist) / 4); i += PAIR_THREADS)
        reinterpret_cast<int*>(&hist)[i] = 0;
    const unsigned stride = edge_stride(num_edge[b], budget);
    __syncthreads();
    Pair q[4][4];
    quad_pairs<VEC>(tri, dense, H, W, HW, blk * PAIR_BLOCK + 4 * t, q);
    int n_kept = 0;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
        // The thread's runs of equal kept keys: a run starts where the key
        // differs from the last kept one; its length counted from the back.
        bool kp[4], st[4];
        int len[4], n = 0, n_runs = 0;
        int32_t last = -1;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            kp[i] = kept_pair(q[o][i], stride);
            st[i] = kp[i] && q[o][i].key != last;
            n_runs += st[i];
            if (kp[i]) {
                last = q[o][i].key;
                ++n;
            }
        }
        n_kept += n;
        if (!__any_sync(FULL, n)) continue;   // the warp keeps no pair here
        int32_t nk = -1;
        int nl = 0;
#pragma unroll
        for (int i = 3; i >= 0; --i) {
            len[i] = 0;
            if (kp[i]) {
                len[i] = q[o][i].key == nk ? nl + 1 : 1;
                nk = q[o][i].key;
                nl = len[i];
            }
        }
        if (n_runs > 1) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (st[i]) add_run(hist, o, q[o][i].key, len[i]);
        }
        // A thread of one run joins the lanes around it that hold the same
        // key.
        const int tot = lane_run_total(n_runs == 1 ? last : -1, n_runs == 1 ? n : 0);
        if (tot) add_run(hist, o, last, tot);
    }
    n_kept = __reduce_add_sync(FULL, n_kept);
    if (lane == 0) red[w] = n_kept;
    __syncthreads();
    if (t == 0) {
        int s = 0;
        for (int u = 0; u < PAIR_WARPS; ++u) s += red[u];
        if (s) atomicAdd(kept + b, s);
    }
    const int ng = (nblk + FIRST_GROUP - 1) / FIRST_GROUP;
    {   // a thread a chain (offset o, digit d)
        const int o = t / R0, d = t & (R0 - 1), c = hist.first[o][d];
        tcnt[(((size_t)b * 4 + o) * nblk + blk) * R0 + d] = c;
        if (c) {
            atomicAdd(odig + ((size_t)b * 4 + o) * R0 + d, c);
            atomicAdd(gsum + (((size_t)b * 4 + o) * ng + blk / FIRST_GROUP) * R0 + d, c);
        }
    }
    if (t < R0) {
        const int s = hist.first[0][t] + hist.first[1][t] + hist.first[2][t] + hist.first[3][t];
        if (s) atomicAdd(digits + (size_t)b * RADIX + t, s);
    }
#pragma unroll
    for (int k = 1; k < SORT_PASSES; ++k) {   // a thread a digit
        const int c = hist.later[k - 1][t];
        if (c) atomicAdd(digits + ((size_t)k * B + b) * RADIX + t, c);
    }
}

// A radix pass's arguments: the first pass reads the pixels (tri, dense,
// num_edge, H, W, budget), a later one the rows (key_in, pay_in); N = 4 H W
// slots a row, T sort tiles of a later pass a row, `tile` their positions,
// E the pair budget.
struct PassArgs {
    const uint8_t* tri;
    const int32_t* dense;
    const int32_t* num_edge;
    const int32_t* key_in;
    const int32_t* pay_in;
    const int32_t* kept;
    const int32_t* digits;
    const int32_t* odig;
    const int32_t* tcnt;
    const int32_t* gsum;
    int32_t* look;
    int32_t* ctl;
    int32_t* key_out;
    int32_t* pay_out;
    int H, W, budget, N, T, tile, E, pass;
};

enum PassSource { SRC_ROWS = 0, SRC_PIXELS_VEC = 1, SRC_PIXELS = 2 };

// The first pass's shared memory: wcnt[4][SORT_WARPS][R0] (uint16), dst[4][R0],
// base[R0], then a warp's compacted first digits (int, 128) and each
// offset's ranks (uint16, 4 x 128 a warp).
constexpr size_t FIRST_SMEM = (size_t)4 * SORT_WARPS * R0 * 2 + (size_t)5 * R0 * 4
                              + (size_t)SORT_WARPS * 128 * 4 + (size_t)4 * SORT_WARPS * 128 * 2;

// The pay of pixel (x, y)'s pair at offset (dx, dy), the pixel black or not
// (pair_of's).
__device__ __forceinline__ int32_t pair_pay(int x, int y, int dx, int dy, bool black) {
    const int sgn = black ? 1 : -1;
    const int g = (dx * sgn + 1) | ((dy * sgn + 1) << 2);
    return (2 * x + dx) | ((2 * y + dy) << 12) | (g << 24);
}

// The first radix pass, from the pixels: block (frame blockIdx.x, tile
// blockIdx.y) takes the frame's PAIR_BLOCK pixels of that tile.
// A kept pair of offset o and first digit d goes to the digit's first
// position (a block scan of the frame's digit counts), plus the keys of
// digit d at the offsets before o (odig), plus those of the tiles (o,
// block') before its own, plus its rank in its tile (o, block): the order
// of a stable pass over the padded layout, offset-major, then pixel. The
// tiles before come from the histogram pass's counts: the sums of the
// groups of FIRST_GROUP tiles before the tile's group, then its group's
// tiles before it (a chain an offset and digit, one a thread; at most
// ceil(blocks / FIRST_GROUP) + FIRST_GROUP - 1 loads, none waiting on
// another block, so the pass needs no look-back and no block waits). Then
// one walk: each warp builds its 128 pixels' pairs and, offset by offset,
// compacts its kept pairs' digits in pixel order into shared memory (a
// prefix of the lanes' counts by three ballots) and ranks them 32 at a time
// (a __match_any_sync group of one digit reads the warp's count of it, its
// lowest lane adds the group's size) into shared memory. The pairs' threads
// keep only the keys (a pay is rebuilt from its pixel at the write, so the
// block holds few registers and more blocks share an SM) and write key and
// pay to the tile's place of the digit plus the warps before theirs plus
// the rank. The block then zeroes pass 1's look-back words of the frame's
// live sort tiles.
template <bool VEC>
__device__ __forceinline__ void first_pass(const PassArgs& a, unsigned char* smem) {
    auto wcnt = reinterpret_cast<uint16_t (*)[SORT_WARPS][R0]>(smem);
    auto dst = reinterpret_cast<int (*)[R0]>(smem + (size_t)4 * SORT_WARPS * R0 * 2);
    int* sbase = reinterpret_cast<int*>(dst + 4);
    int32_t* sdig = sbase + R0;                       // [SORT_WARPS][128]
    auto srank = reinterpret_cast<uint16_t (*)[SORT_WARPS][128]>(sdig + SORT_WARPS * 128);
    __shared__ int scan_buf[SORT_WARPS];
    const int b = blockIdx.x, tile = blockIdx.y, nb = gridDim.y;
    const int t = threadIdx.x, lane = t & 31, w = t >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const int H = a.H, W = a.W, HW = H * W;
    const uint8_t* tri = a.tri + (size_t)b * HW;
    // Thread t's chain: offset o_t, digit d_t. Its keys in the tiles before
    // this one: the sums of the whole groups before its group, then the
    // tiles of its group before it (loads that wait on nothing).
    const int o_t = t / R0, d_t = t & (R0 - 1);
    const int g = tile / FIRST_GROUP, ng = (nb + FIRST_GROUP - 1) / FIRST_GROUP;
    const int32_t* gs = a.gsum + ((size_t)b * 4 + o_t) * ng * R0 + d_t;
    const int32_t* tc = a.tcnt + ((size_t)b * 4 + o_t) * nb * R0 + d_t;
    int before = 0, v[FIRST_GROUP];
    for (int u0 = 0; u0 < g; u0 += FIRST_GROUP) {   // loads issued together
#pragma unroll
        for (int k = 0; k < FIRST_GROUP; ++k) v[k] = u0 + k < g ? gs[(size_t)(u0 + k) * R0] : 0;
#pragma unroll
        for (int k = 0; k < FIRST_GROUP; ++k) before += v[k];
    }
#pragma unroll
    for (int k = 0; k < FIRST_GROUP; ++k)
        v[k] = g * FIRST_GROUP + k < tile ? tc[(size_t)(g * FIRST_GROUP + k) * R0] : 0;
#pragma unroll
    for (int k = 0; k < FIRST_GROUP; ++k) before += v[k];
    int ahead = 0;                           // the digit's keys at the offsets before o_t
    for (int o = 0; o < o_t; ++o) ahead += a.odig[((size_t)b * 4 + o) * R0 + d_t];
    uint32_t* wz = reinterpret_cast<uint32_t*>(smem);
    for (int i = t; i < 4 * SORT_WARPS * R0 / 2; i += SORT_THREADS) wz[i] = 0;
    {   // the first digits' first positions (the scan's barriers publish wcnt's zeros)
        int total;
        const int base = block_scan<SORT_THREADS>(t < R0 ? a.digits[(size_t)b * RADIX + t] : 0,
                                                  scan_buf, &total);
        if (t < R0) sbase[t] = base;
    }
    // The walk: the warp's pairs, ranked by first digit in pixel order.
    const int p0 = tile * PAIR_BLOCK + 4 * t;
    const unsigned stride = edge_stride(a.num_edge[b], a.budget);
    int32_t key[4][4];
    unsigned m = 0, pre = 0;                 // bit 4 o + i: kept; byte o: the thread's first slot
    {
        Pair q[4][4];
        quad_pairs<VEC>(tri, a.dense + (size_t)b * HW, H, W, HW, p0, q);
#pragma unroll
        for (int o = 0; o < 4; ++o)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                key[o][i] = q[o][i].key;
                m |= (unsigned)kept_pair(q[o][i], stride) << (4 * o + i);
            }
    }
    int32_t* sd = sdig + w * 128;
#pragma unroll
    for (int o = 0; o < 4; ++o) {
        const unsigned mo = (m >> (4 * o)) & 15u;
        const unsigned has = __ballot_sync(FULL, mo != 0);
        if (!has) continue;
        const int c = __popc(mo);
        const unsigned b0 = __ballot_sync(FULL, c & 1), b1 = __ballot_sync(FULL, c & 2),
                       b2 = __ballot_sync(FULL, c & 4);
        const int first = __popc(b0 & lt) + 2 * __popc(b1 & lt) + 4 * __popc(b2 & lt);
        const int n_all = __popc(b0) + 2 * __popc(b1) + 4 * __popc(b2);
        pre |= (unsigned)first << (8 * o);
        int at = first;
#pragma unroll
        for (int i = 0; i < 4; ++i)
            if ((mo >> i) & 1u) sd[at++] = key[o][i] & (R0 - 1);
        __syncwarp();
        for (int j0 = 0; j0 < n_all; j0 += 32) {
            const int j = j0 + lane;
            const int d = j < n_all ? sd[j] : R0;
            const unsigned grp = __match_any_sync(FULL, d);
            const int cnt = d < R0 ? wcnt[o][w][d] : 0;
            __syncwarp();
            if (d < R0) {
                srank[o][w][j] = (uint16_t)(cnt + __popc(grp & lt));
                if (lane == __ffs(grp) - 1) wcnt[o][w][d] = (uint16_t)(cnt + __popc(grp));
            }
            __syncwarp();
        }
    }
    __syncthreads();
    // Each warp's first place among the tile's keys of a digit, and each
    // digit's place in the tile's output.
    {
        int s = 0;
#pragma unroll
        for (int u = 0; u < SORT_WARPS; ++u) {
            const int c = wcnt[o_t][u][d_t];
            wcnt[o_t][u][d_t] = (uint16_t)s;
            s += c;
        }
        dst[o_t][d_t] = sbase[d_t] + ahead + before;
    }
    __syncthreads();
    if (m) {
        int32_t* key_out = a.key_out + (size_t)b * a.N;
        int32_t* pay_out = a.pay_out + (size_t)b * a.N;
        unsigned black = 0;                  // bit i: pixel i is black
        int x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int pi = min(p0 + i, HW - 1);
            y[i] = pi / W;
            x[i] = pi - y[i] * W;
            black |= (unsigned)(tri[pi] == 0) << i;
        }
#pragma unroll
        for (int o = 0; o < 4; ++o) {
            int at = (pre >> (8 * o)) & 255u;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                if ((m >> (4 * o + i)) & 1u) {
                    const int d = key[o][i] & (R0 - 1);
                    const int to = dst[o][d] + wcnt[o][w][d] + srank[o][w][at++];
                    key_out[to] = key[o][i];
                    pay_out[to] = pair_pay(x[i], y[i], off_dx(o), off_dy(o), (black >> i) & 1u);
                }
            }
        }
    }
    const int live = (a.kept[b] + a.tile - 1) / a.tile * RADIX;
    int32_t* lz = a.look + (size_t)b * a.T * RADIX;          // plane 0: pass 1's
    for (int i = tile * SORT_THREADS + t; i < live; i += nb * SORT_THREADS) lz[i] = 0;
}

// A later pass's shared memory: wcnt[SORT_WARPS][RADIX], tstart[RADIX],
// dstart[RADIX], then (a staged tile) the tile's keys and pays by digit.
template <int KPT>
constexpr size_t rows_smem() {
    return ((size_t)SORT_WARPS + 2) * RADIX * 4
           + (KPT > 4 ? (size_t)2 * SORT_THREADS * KPT * 4 : 0);
}

// A later radix pass (pass >= 1) over the frame's kept pairs [0, K), a
// block a sort tile of SORT_THREADS * KPT positions at a time, the tiles
// taken in order from the frame's counter (so every tile before a block's
// is held by a block that runs). A key's destination is its digit's first
// position (a block scan of the pass's digit counts, from the histogram
// pass), plus the keys of its digit in the tiles before its tile, plus
// those before it in its tile: the warps before its warp, and its rank in
// its warp's run, counted chunk by chunk in position order (a
// __match_any_sync group's lanes read the warp's count of the digit, then
// its lowest lane adds the group's size). So the pass is stable. The tiles
// before come by decoupled look-back (look_back: the block publishes its
// tile's counts first). A tile of 4096 is laid out by digit in shared
// memory first, so its stores go out as runs of consecutive places (a tile
// of 1024, at small launches, goes out from registers: the staging costs
// more latency than it saves there). When it has no more tiles, the block
// zeroes its share of the next pass's look-back words on the live tiles,
// or, in the last pass, writes I32MAX into its share of [K, E).
template <int KPT>
__device__ __forceinline__ void rows_pass(const PassArgs& a, unsigned char* smem) {
    constexpr int R = RADIX;
    constexpr int TILE = SORT_THREADS * KPT;
    constexpr bool STAGED = KPT > 4;         // large tiles go out through shared memory
    auto wcnt = reinterpret_cast<int (*)[R]>(smem);   // a digit's keys a warp, then those before it
    int* tstart = reinterpret_cast<int*>(smem) + SORT_WARPS * R;   // a digit's first place in tile
    int* dstart = tstart + R;                // its keys' destination less their tile place
    int32_t* skey = dstart + R;              // the tile by digit (STAGED)
    int32_t* spay = skey + TILE;
    __shared__ int scan_buf[SORT_WARPS];
    __shared__ int s_tile;
    const int b = blockIdx.y, B = gridDim.y, t = threadIdx.x, lane = t & 31, w = t >> 5;
    const int pass = a.pass, N = a.N;
    const int K = a.kept[b], tiles = (K + TILE - 1) / TILE;
    const int shift = digit_shift(pass);
    const int32_t* key_in = a.key_in + (size_t)b * N;
    const int32_t* pay_in = a.pay_in + (size_t)b * N;
    int32_t* key_out = a.key_out + (size_t)b * N;
    int32_t* pay_out = a.pay_out + (size_t)b * N;
    // a thread a digit: tile q's word of digit t at lw[q R]
    int32_t* lw = a.look + ((size_t)(pass - 1) * B + b) * a.T * R + t;
    int32_t* next_tile = a.ctl + b * SORT_PASSES + pass;
    const unsigned lt = (1u << lane) - 1u;
    int total;                               // digit t's first position
    const int dbase = block_scan<SORT_THREADS>(a.digits[((size_t)pass * B + b) * R + t],
                                               scan_buf, &total);
    for (;;) {
        if (t == 0) s_tile = atomicAdd(next_tile, 1);
        for (int i = t; i < SORT_WARPS * R; i += SORT_THREADS) (&wcnt[0][0])[i] = 0;
        __syncthreads();
        const int tile = s_tile;
        if (tile >= tiles) break;
        const int p0 = tile * TILE + w * 32 * KPT + lane;
        int32_t k[KPT], v[KPT];
        int r[KPT];
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            const int p = p0 + i * 32;
            k[i] = p < K ? key_in[p] : -1;      // kept keys are >= 0
            v[i] = p < K ? pay_in[p] : 0;
        }
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
            const int d = k[i] >= 0 ? (k[i] >> shift) & (R - 1) : R;
            const unsigned grp = __match_any_sync(FULL, d);
            const int c = d < R ? wcnt[w][d] : 0;
            r[i] = c + __popc(grp & lt);
            __syncwarp();
            if (d < R && lane == __ffs(grp) - 1) wcnt[w][d] = c + __popc(grp);
            __syncwarp();
        }
        __syncthreads();
        int own = 0;
        for (int u = 0; u < SORT_WARPS; ++u) {
            const int c = wcnt[u][t];
            wcnt[u][t] = own;
            own += c;
        }
        int32_t* mine = lw + (size_t)tile * R;
        store_relaxed(mine, (tile == 0 ? LB_INCL : LB_AGG) | own);
        int tile_keys;
        const int first = block_scan<SORT_THREADS>(own, scan_buf, &tile_keys);
        tstart[t] = first;
        const int before = look_back(lw, R, tile);
        if (tile > 0) store_relaxed(mine, LB_INCL | (before + own));
        dstart[t] = dbase + before - first;
        __syncthreads();
        if constexpr (STAGED) {
            // The tile by digit in shared memory, then written out in order,
            // so a warp's stores are runs of consecutive places.
#pragma unroll
            for (int i = 0; i < KPT; ++i) {
                if (k[i] >= 0) {
                    const int d = (k[i] >> shift) & (R - 1);
                    const int at = tstart[d] + wcnt[w][d] + r[i];
                    skey[at] = k[i];
                    spay[at] = v[i];
                }
            }
            __syncthreads();
            for (int j = t; j < tile_keys; j += SORT_THREADS) {
                const int32_t key = skey[j];
                const int at = dstart[(key >> shift) & (R - 1)] + j;
                key_out[at] = key;
                pay_out[at] = spay[j];
            }
        } else {
#pragma unroll
            for (int i = 0; i < KPT; ++i) {
                if (k[i] >= 0) {
                    const int d = (k[i] >> shift) & (R - 1);
                    const int at = dstart[d] + tstart[d] + wcnt[w][d] + r[i];
                    key_out[at] = k[i];
                    pay_out[at] = v[i];
                }
            }
        }
        if (tiles <= (int)gridDim.x) break; // every tile went in the first round
        __syncthreads();                    // the shared arrays are written again
    }
    const int nb = gridDim.x, i0 = blockIdx.x * SORT_THREADS + t;
    if (pass + 1 < SORT_PASSES) {
        int32_t* lz = a.look + ((size_t)pass * B + b) * a.T * R;   // pass + 1's words
        for (int i = i0; i < tiles * R; i += nb * SORT_THREADS) lz[i] = 0;
    } else {
        for (int i = K + i0; i < a.E; i += nb * SORT_THREADS) key_out[i] = I32MAX;
    }
}

// Every radix pass is this kernel: SRC_ROWS a later pass (KPT keys a
// thread), SRC_PIXELS_VEC or SRC_PIXELS the first (the pixel kernels' vector
// or scalar loads; KPT 0).
template <int SRC, int KPT>
__global__ void __launch_bounds__(SORT_THREADS, SRC == SRC_ROWS ? 1 : 4)
cm_radix_scatter_kernel(const PassArgs a) {
    static_assert((SRC == SRC_ROWS) == (KPT > 0), "KPT keys a thread in a later pass only");
    extern __shared__ __align__(16) unsigned char smem[];
    if constexpr (SRC == SRC_ROWS) rows_pass<KPT>(a, smem);
    else first_pass<SRC == SRC_PIXELS_VEC>(a, smem);
}

// A tile of SEG_TILE sorted keys [s, e), e = min(s + SEG_TILE, E), is one
// warp's work, SEG_KPT consecutive keys a lane, loaded by four int4 loads
// issued in one round. A key at i is a segment start when it is valid
// (< I32MAX) and differs from the key at i - 1; the valid keys are a
// prefix, of length nv. A start's segment ends at the next start in the
// tile or, for the tile's last start, at the tile's valid end s + vt,
// unless the tile is all valid and its last key's segment runs on into the
// next tile (`open_end`): that crossing start is left to cm_seg_top_kernel,
// which knows the next tile's first start. A lane's starts are a bit mask,
// so each start's next one is its lowest bit above (or, past the lane's
// last, the warp's suffix minimum of the lanes' first starts) and every
// size, gate and candidate's place (a popcount) is found at once. Writes
// the tile's fields (stats[b, f, tile]: ST_STARTS, ST_CANDS, ST_MAX,
// ST_FIRST, ST_CROSS), its gated in-tile segments (candidates) compacted
// in position order from cand[b, s] as size << SEG_POS_BITS | (start - s),
// one histogram atomic a candidate (hist zeroed before the launch), and,
// from the one tile that holds the end of the valid prefix, nv[b].
// The grid is one wave: `warps` warps a frame (warp blockIdx.x SEG_WARPS +
// its place in the block), warp g walking tiles g, g + warps, ... with the
// next tile's loads issued before the current tile's work; no warp waits
// on another, and no barrier or shared memory is used. The first tile of a
// walk past the valid prefix (its first key I32MAX) ends the walk: the
// warp writes that tile's fields and those of its later tiles at once.
// Replaces the reverse cummin of isaac_ros_apriltag_tpu/ops/
// cluster_moments.py:202 (XLA; no Pallas kernel). Bound: bytes, the valid
// prefix read once (~9 MB, 0.0027 ms at 1080p b8); a tile is a short chain
// (loads, scans, sizes, stores), so its latency rules, which the one round
// of loads, the next tile's loads in flight and the independent sizes
// shorten.
struct SegKeys {
    int4 v[SEG_KPT / 4];                 // the lane's keys
    int32_t prev, first, last, end;      // the keys at i0 - 1 (lane 0), s, e - 1, e
};

__device__ __forceinline__ void seg_load(const int32_t* __restrict__ ks, int u, int E, int lane,
                                         SegKeys& K) {
    const int s = u * SEG_TILE, e = min(s + SEG_TILE, E), i0 = s + SEG_KPT * lane;
    if (i0 + SEG_KPT <= e) {
#pragma unroll
        for (int q = 0; q < SEG_KPT / 4; ++q) K.v[q] = reinterpret_cast<const int4*>(ks + i0)[q];
    } else {
        int32_t k[SEG_KPT];
#pragma unroll
        for (int j = 0; j < SEG_KPT; ++j) k[j] = i0 + j < e ? ks[i0 + j] : I32MAX;
#pragma unroll
        for (int q = 0; q < SEG_KPT / 4; ++q)
            K.v[q] = make_int4(k[4 * q], k[4 * q + 1], k[4 * q + 2], k[4 * q + 3]);
    }
    K.prev = lane == 0 && s > 0 ? ks[s - 1] : -1;
    K.first = ks[s];
    K.last = ks[e - 1];
    K.end = e < E ? ks[e] : I32MAX;
}

// Stamps of a block's first warp's first tile (torch_stamp_split.py).
#define SEG_STAMP(k, anchor)             \
    do {                                 \
        if (u == warp) STAMP(k, anchor); \
    } while (0)

__global__ void __launch_bounds__(SEG_THREADS)
cm_seg_tiles_kernel(const int32_t* __restrict__ key_s, const int32_t* __restrict__ num_edge,
                    int32_t* __restrict__ stats, int32_t* __restrict__ cand,
                    int32_t* __restrict__ hist, int32_t* __restrict__ nv_out, int row, int E,
                    int tiles, int warps, int min_pix, int max_per, int budget) {
    const int b = blockIdx.y, lane = threadIdx.x & 31;
    const int warp = blockIdx.x * SEG_WARPS + threadIdx.x / 32;
    if (warp >= warps) return;
    const int32_t* ks = key_s + (size_t)b * row;
    int32_t* st = stats + (size_t)b * SEG_STATS * tiles;     // field f of tile u at st[f tiles + u]
    int32_t* hb = hist + (size_t)b * (max_per + 1);
    const int stride = edge_stride(num_edge[b], budget);
    SegKeys cur;
    seg_load(ks, warp, E, lane, cur);
    for (int u = warp; u < tiles; u += warps) {
        SEG_STAMP(0, u);
        if (u > 0 && cur.first == I32MAX) {      // past the valid prefix, and so are the later
            for (int v = u + lane * warps; v < tiles; v += 32 * warps) {
                st[ST_STARTS * tiles + v] = 0;
                st[ST_CANDS * tiles + v] = 0;
                st[ST_MAX * tiles + v] = 0;
                st[ST_FIRST * tiles + v] = INT_MAX;
                st[ST_CROSS * tiles + v] = -1;
            }
            return;
        }
        const bool more = u + warps < tiles;
        SegKeys nxt;
        if (more) seg_load(ks, u + warps, E, lane, nxt);   // in flight under this tile's work
        const int s = u * SEG_TILE, e = min(s + SEG_TILE, E), i0 = s + SEG_KPT * lane;
        int32_t k[SEG_KPT];
#pragma unroll
        for (int q = 0; q < SEG_KPT / 4; ++q) {
            k[4 * q] = cur.v[q].x;
            k[4 * q + 1] = cur.v[q].y;
            k[4 * q + 2] = cur.v[q].z;
            k[4 * q + 3] = cur.v[q].w;
        }
        SEG_STAMP(1, k[0] ^ k[SEG_KPT - 1] ^ cur.end);
        int32_t prev = __shfl_up_sync(FULL, k[SEG_KPT - 1], 1);
        if (lane == 0) prev = cur.prev;
        unsigned sm = 0;                     // bit j: key i0 + j starts a segment
        int n_valid = 0;
#pragma unroll
        for (int j = 0; j < SEG_KPT; ++j) {
            const bool v = k[j] < I32MAX;
            sm |= (unsigned)(v && k[j] != (j ? k[j - 1] : prev)) << j;
            n_valid += v;
        }
        const int first = sm ? i0 + __ffs(sm) - 1 : INT_MAX;
        const int last = sm ? i0 + 31 - __clz(sm) : -1;
        // The first start after this lane's keys; the tile's valid keys,
        // starts, first and last start.
        int inc = first;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int n = __shfl_down_sync(FULL, inc, d);
            if (lane + d < 32) inc = min(inc, n);
        }
        int next = __shfl_down_sync(FULL, inc, 1);
        if (lane == 31) next = INT_MAX;
        const int vt = __reduce_add_sync(FULL, n_valid);
        const int n_starts = __reduce_add_sync(FULL, __popc(sm));
        const int ls = __reduce_max_sync(FULL, last), fs = __shfl_sync(FULL, inc, 0);
        SEG_STAMP(2, ls + vt + next);
        const int vend = s + vt;            // the tile's valid end
        const bool full = vend == e;
        const bool open_end = full && e < E && cur.end == cur.last;

        // Each start's size, all at once: its segment ends at the lowest
        // start bit above it in the lane, else at `next`; the gate; the
        // candidates (bit j of cm).
        int sz[SEG_KPT], mx = 0;
        unsigned cm = 0;
#pragma unroll
        for (int j = 0; j < SEG_KPT; ++j) {
            sz[j] = 0;
            if ((sm >> j) & 1u) {
                const unsigned above = sm >> (j + 1);
                const int nx = above ? i0 + j + __ffs(above) : next;
                const bool tail = nx == INT_MAX;       // the tile's last start
                if (!(tail && open_end)) {
                    const int cnt = (tail ? vend : nx) - (i0 + j);
                    const long long true_size = (long long)cnt * stride;
                    if (true_size >= min_pix && true_size <= max_per) sz[j] = cnt;
                }
            }
            cm |= (unsigned)(sz[j] > 0) << j;
            mx = max(mx, sz[j]);
        }
        const int nc = __popc(cm);
        int cinc = nc;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int n = __shfl_up_sync(FULL, cinc, d);
            if (lane >= d) cinc += n;
        }
        const int n_cand = __shfl_sync(FULL, cinc, 31), tile_max = __reduce_max_sync(FULL, mx);
        SEG_STAMP(3, n_cand + tile_max);
        const int at = cinc - nc;             // the lane's first candidate's place
        int32_t* cd = cand + (size_t)b * tiles * SEG_TILE + s;
#pragma unroll
        for (int j = 0; j < SEG_KPT; ++j) {
            if ((cm >> j) & 1u) {
                cd[at + __popc(cm & ((1u << j) - 1u))] = (sz[j] << SEG_POS_BITS) | (i0 + j - s);
                atomicAdd(hb + sz[j], 1);
            }
        }
        SEG_STAMP(4, at);
        if (lane < SEG_STATS) {             // field `lane` of the tile
            st[lane * tiles + u] = lane == ST_STARTS ? n_starts
                                   : lane == ST_CANDS ? n_cand
                                   : lane == ST_MAX   ? tile_max
                                   : lane == ST_FIRST ? fs
                                                      : (open_end && n_starts > 0 ? ls : -1);
        }
        if (lane == 0 && (!full || e == E || cur.end == I32MAX)) nv_out[b] = vend;
        SEG_STAMP(5, n_cand);
        if (!more) break;
        cur = nxt;
    }
}

#undef SEG_STAMP

// One block of TOP_THREADS a frame over the tiles' fields, thread t the
// TOP_TPT tiles from t TOP_TPT of a chunk of TOP_CHUNK (one chunk up to
// 2^19 keys); hist itself is not written.
// - The histogram is loaded into shared memory in one round with the
//   fields, thread t bin t + TOP_THREADS k, so a warp's 32 bins of a round
//   are one coarse bin, summed by one warp reduction.
// - Pass 1, chunks from the last: each crossing start's segment ends at the
//   first start of a later tile (the thread's later tiles, then a warp and
//   a block suffix minimum over the threads: one barrier) or at nv; its
//   gated size is added into both histograms by shared atomics.
// - The threshold size T of the top want = min(C, candidates): every warp
//   finds T's coarse bin (a warp scan of the lanes' coarse sums from the
//   top, then the one lane's walk) and T in it (a warp scan of its 32
//   bins), so no barrier.
// - Pass 2, chunks in order: the tiles that hold a size >= T are listed
//   with their first entry by a block scan (their candidates, compacted,
//   then the crossing one: position order); thread t takes TOP_PER
//   consecutive entries a round, finds the first one's tile by one binary
//   search of the list and the rest from the next TOP_PER list entries
//   (each listed tile holds an entry), and loads them in one round. The
//   sizes above T go to a shared list of keys size << 32 | ~position, one
//   atomic a warp; a block scan of the size-T entries in entry order gives
//   each its place among the ties, and the first `ties` take rank ngt +
//   place. Each listed winner (ngt < C) takes as its rank the number of
//   listed keys above its own (two lanes a winner, half the list each):
//   (size descending, position ascending). The winners are staged by rank
//   in shared memory and written out at once after one more barrier.
__global__ void __launch_bounds__(TOP_THREADS)
cm_seg_top_kernel(const int32_t* __restrict__ stats, const int32_t* __restrict__ cand,
                  const int32_t* __restrict__ hist, const int32_t* __restrict__ nv_in,
                  const int32_t* __restrict__ num_edge,
                  const uint8_t* __restrict__ comp_overflow, int32_t* __restrict__ cross,
                  int32_t* __restrict__ top_pos, int32_t* __restrict__ count,
                  uint8_t* __restrict__ valid, int32_t* __restrict__ n_clusters,
                  int32_t* __restrict__ n_eligible, int32_t* __restrict__ edge_stride_out,
                  uint8_t* __restrict__ overflow, int tiles, int E, int E2, int C, int min_pix,
                  int max_per, int budget) {
    extern __shared__ int s_fine[];         // max_per + 1 bins, then the coarse bins
    __shared__ int s_wmin[2][TOP_WARPS], s_wred[2][TOP_WARPS], s_wscan[2][TOP_WARPS];
    __shared__ int s_weq[2][TOP_WARPS];
    // Pass 2's listed tiles: first entry (and the total past the last); the
    // first entry, first position, candidates and crossing size; the
    // crossing start.
    __shared__ int s_ro[TOP_CHUNK + 1];
    __shared__ int4 s_rinfo[TOP_CHUNK];
    __shared__ int s_rls[TOP_CHUNK];
    __shared__ unsigned long long s_gt_key[MAX_C];
    __shared__ int s_top_pos[MAX_C], s_top_size[MAX_C];   // the winners by rank
    __shared__ int s_gtn, s_gtsum;
    const int b = blockIdx.x, t = threadIdx.x, lane = t & 31, w = t >> 5;
    const int32_t* st = stats + (size_t)b * SEG_STATS * tiles;
    const int32_t* cd = cand + (size_t)b * tiles * SEG_TILE;
    const int32_t* hb = hist + (size_t)b * (max_per + 1);
    int32_t* cr = cross + (size_t)b * tiles;
    const int NB = max_per + 1, NCB = (NB + TOP_BIN - 1) / TOP_BIN;
    int* s_c = s_fine + NB;
    STAMP(0, t);
    if (t == 0) {
        s_gtn = 0;
        s_gtsum = 0;
    }
    const bool chunked = tiles > TOP_CHUNK;
    const int last_c0 = (tiles - 1) / TOP_CHUNK * TOP_CHUNK;
    int ns[TOP_TPT], nc[TOP_TPT], mx[TOP_TPT], fs[TOP_TPT], ls[TOP_TPT], cs[TOP_TPT];
    auto load_fields = [&](int c0, bool all) {
#pragma unroll
        for (int k = 0; k < TOP_TPT; ++k) {
            const int u = c0 + t * TOP_TPT + k;
            const bool in = u < tiles;
            nc[k] = in ? st[ST_CANDS * tiles + u] : 0;
            mx[k] = in ? st[ST_MAX * tiles + u] : 0;
            ls[k] = in ? st[ST_CROSS * tiles + u] : -1;
            if (all) {
                ns[k] = in ? st[ST_STARTS * tiles + u] : 0;
                fs[k] = in ? st[ST_FIRST * tiles + u] : INT_MAX;
            } else {
                cs[k] = in ? __ldcg(cr + u) : 0;
            }
        }
    };
    load_fields(last_c0, true);
    const int ne = num_edge[b], stride = edge_stride(ne, budget), nv = nv_in[b];
    for (int x0 = 0; x0 < NB; x0 += TOP_THREADS * TOP_HIST_ROUND) {
        int v[TOP_HIST_ROUND];
#pragma unroll
        for (int r = 0; r < TOP_HIST_ROUND; ++r) {
            const int x = x0 + r * TOP_THREADS + t;
            v[r] = x < NB ? __ldg(hb + x) : 0;
        }
#pragma unroll
        for (int r = 0; r < TOP_HIST_ROUND; ++r) {
            const int x = x0 + r * TOP_THREADS + t, cb = (x0 + r * TOP_THREADS) / TOP_BIN + w;
            if (x < NB) s_fine[x] = v[r];
            const int cv = __reduce_add_sync(FULL, v[r]);
            if (lane == 0 && cb < NCB) s_c[cb] = cv;
        }
    }

    // Pass 1.
    int n_first = 0, n_cand = 0, later = nv, par = 0;
    for (int c0 = last_c0; c0 >= 0; c0 -= TOP_CHUNK, par ^= 1) {
        if (c0 != last_c0) load_fields(c0, true);
        int mine = INT_MAX;
#pragma unroll
        for (int k = 0; k < TOP_TPT; ++k) mine = min(mine, fs[k]);
        int inc = mine;                     // the least of lanes lane .. 31
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int n = __shfl_down_sync(FULL, inc, d);
            if (lane + d < 32) inc = min(inc, n);
        }
        int next = __shfl_down_sync(FULL, inc, 1);
        if (lane == 31) next = INT_MAX;
        if (lane == 0) s_wmin[par][w] = inc;
        __syncthreads();
        int all = INT_MAX;
#pragma unroll
        for (int u = 0; u < TOP_WARPS; ++u) {
            const int m = s_wmin[par][u];
            if (u > w) next = min(next, m);
            all = min(all, m);
        }
        STAMP(1, all);
        next = min(next, later);
        later = min(later, all);
#pragma unroll
        for (int k = TOP_TPT - 1; k >= 0; --k) {
            cs[k] = 0;
            if (ls[k] >= 0) {
                const int cnt = next - ls[k];
                const long long true_size = (long long)cnt * stride;
                if (true_size >= min_pix && true_size <= max_per) cs[k] = cnt;
            }
            if (cs[k] > 0) {
                atomicAdd(s_fine + cs[k], 1);
                atomicAdd(s_c + cs[k] / TOP_BIN, 1);
            }
            next = min(next, fs[k]);
            n_first += ns[k];
            n_cand += nc[k] + (cs[k] > 0);
            const int u = c0 + t * TOP_TPT + k;
            if (chunked && u < tiles) cr[u] = cs[k];
        }
    }
    n_first = __reduce_add_sync(FULL, n_first);
    n_cand = __reduce_add_sync(FULL, n_cand);
    if (lane == 0) {
        s_wred[0][w] = n_first;
        s_wred[1][w] = n_cand;
    }
    __syncthreads();
    int tot_first = 0, tot_cand = 0;
#pragma unroll
    for (int u = 0; u < TOP_WARPS; ++u) {
        tot_first += s_wred[0][u];
        tot_cand += s_wred[1][u];
    }
    STAMP(2, tot_cand);
    // The invalid positions' and non-starts' size 0 passes the gate too.
    const int tot_elig = tot_cand + (min_pix <= 0 ? E - tot_first : 0);

    // The threshold size T of the top `want`, and ngt, the candidates above
    // it. Lane l holds the coarse bins [lo, hi), hi = NCB - l cpl, so a scan
    // in lane order runs from the largest size down.
    const int want = min(C, tot_cand);
    int T = INT_MAX, ngt = 0;
    if (want > 0) {
        const int cpl = (NCB + 31) / 32, hi = NCB - lane * cpl, lo = max(0, hi - cpl);
        int sum = 0, cv[TOP_CPL];               // the lane's bins from the top, up to TOP_CPL
#pragma unroll
        for (int i = 0; i < TOP_CPL; ++i) {
            cv[i] = hi - 1 - i >= lo ? s_c[hi - 1 - i] : 0;
            sum += cv[i];
        }
        for (int x = hi - 1 - TOP_CPL; x >= lo; --x) sum += s_c[x];
        int inc = sum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int n = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += n;
        }
        const int L = __ffs(__ballot_sync(FULL, inc >= want)) - 1;
        int G = 0, above = 0;
        if (lane == L) {
            int acc = inc - sum;
            bool found = false;
#pragma unroll
            for (int i = 0; i < TOP_CPL; ++i) {
                if (!found && acc + cv[i] >= want) {
                    G = hi - 1 - i;
                    above = acc;
                    found = true;
                }
                acc += found ? 0 : cv[i];
            }
            for (int x = hi - 1 - TOP_CPL; x >= lo && !found; --x) {
                if (acc + s_c[x] >= want) {
                    G = x;
                    above = acc;
                    found = true;
                }
                acc += s_c[x];
            }
        }
        G = __shfl_sync(FULL, G, L);
        above = __shfl_sync(FULL, above, L);
        const int x = G * TOP_BIN + TOP_BIN - 1 - lane;
        const int v = x < NB ? s_fine[x] : 0;
        int finc = v;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int n = __shfl_up_sync(FULL, finc, d);
            if (lane >= d) finc += n;
        }
        const int F = __ffs(__ballot_sync(FULL, above + finc >= want)) - 1;
        T = G * TOP_BIN + TOP_BIN - 1 - F;
        ngt = above + __shfl_sync(FULL, finc - v, F);
    }
    const int ties = want - ngt;
    STAMP(3, T);
    // Pass 2: the entries of the tiles that hold a size >= T, in position
    // order. Those tiles are listed (r: their order in the chunk) with their
    // first entry s_ro[r], so a thread's run of entries, which crosses a
    // listed tile at each step at most, walks the list from one search.
    int eq_base = 0, epar = 0;
    for (int c0 = 0; c0 < tiles; c0 += TOP_CHUNK) {
        if (c0 > 0) load_fields(c0, false);
        int n[TOP_TPT], my = 0, rel = 0;
#pragma unroll
        for (int k = 0; k < TOP_TPT; ++k) {
            n[k] = max(mx[k], cs[k]) >= T ? nc[k] + (cs[k] > 0) : 0;
            my += n[k];
            rel += n[k] > 0;
        }
        int inc = my, rinc = rel;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int m = __shfl_up_sync(FULL, inc, d), mr = __shfl_up_sync(FULL, rinc, d);
            if (lane >= d) {
                inc += m;
                rinc += mr;
            }
        }
        if (lane == 31) {
            s_wscan[0][w] = inc;
            s_wscan[1][w] = rinc;
        }
        __syncthreads();
        int off = inc - my, r = rinc - rel, tot = 0, R = 0;
#pragma unroll
        for (int u = 0; u < TOP_WARPS; ++u) {
            const int s = s_wscan[0][u], sr = s_wscan[1][u];
            off += u < w ? s : 0;
            r += u < w ? sr : 0;
            tot += s;
            R += sr;
        }
#pragma unroll
        for (int k = 0; k < TOP_TPT; ++k) {
            if (n[k] > 0) {
                s_ro[r] = off;
                s_rinfo[r] = make_int4(off, (c0 + t * TOP_TPT + k) * SEG_TILE, nc[k], cs[k]);
                s_rls[r] = ls[k];
                ++r;
                off += n[k];
            }
        }
        if (t == 0) s_ro[R] = tot;
        const int top_step = R > 1 ? 1 << (31 - __clz(R - 1)) : 0;   // the search's first step
        __syncthreads();
        STAMP(4, tot);
        for (int f0 = 0; f0 < tot; f0 += TOP_THREADS * TOP_PER, epar ^= 1) {
            const int first = f0 + t * TOP_PER;
            int size[TOP_PER], pos[TOP_PER], g = 0, e = 0, gsum = 0;
            if (first < tot) {
                int a = 0;                      // the last listed tile with s_ro[a] <= first
                for (int step = top_step; step > 0; step >>= 1) {
                    const int c = min(a + step, R);     // s_ro[R] = tot > first
                    a = s_ro[c] <= first ? c : a;
                }
                int ends[TOP_PER], at[TOP_PER], raw[TOP_PER];
                int4 info[TOP_PER];
#pragma unroll
                for (int i = 0; i < TOP_PER; ++i) ends[i] = s_ro[min(a + 1 + i, R)];
#pragma unroll
                for (int i = 0; i < TOP_PER; ++i) {
                    at[i] = a;
#pragma unroll
                    for (int h = 0; h < TOP_PER; ++h) at[i] += h <= i && first + i >= ends[h];
                    info[i] = s_rinfo[min(at[i], R - 1)];
                    pos[i] = first + i - info[i].x;     // the entry's place in its tile
                }
                // Every load in range (an entry past the tile's candidates
                // reads one and drops it), so all are issued at once.
#pragma unroll
                for (int i = 0; i < TOP_PER; ++i)
                    raw[i] = __ldg(cd + (size_t)info[i].y + min(pos[i], SEG_TILE - 1));
#pragma unroll
                for (int i = 0; i < TOP_PER; ++i) {
                    size[i] = -1;
                    if (first + i < tot) {
                        if (pos[i] < info[i].z) {
                            size[i] = raw[i] >> SEG_POS_BITS;
                            pos[i] = info[i].y + (raw[i] & ((1 << SEG_POS_BITS) - 1));
                        } else {
                            size[i] = info[i].w;
                            pos[i] = s_rls[min(at[i], R - 1)];
                        }
                    }
                    g += size[i] > T;
                    gsum += size[i] > T ? size[i] : 0;
                    e += size[i] == T;
                }
            }
            // The sizes above T go to the list, one shared atomic a warp; the
            // size-T entries' places come from a block scan.
            int ginc = g, einc = e;
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int m = __shfl_up_sync(FULL, ginc, d), me = __shfl_up_sync(FULL, einc, d);
                if (lane >= d) {
                    ginc += m;
                    einc += me;
                }
            }
            const int gsum_w = __reduce_add_sync(FULL, gsum);
            int base = 0;
            if (lane == 31) {
                s_weq[epar][w] = einc;
                if (ginc > 0) {
                    base = atomicAdd(&s_gtn, ginc);
                    atomicAdd(&s_gtsum, gsum_w);
                }
            }
            base = __shfl_sync(FULL, base, 31) + ginc - g;
            if (g > 0) {
#pragma unroll
                for (int i = 0; i < TOP_PER; ++i) {
                    if (size[i] > T) {
                        s_gt_key[base++] = (unsigned long long)size[i] << 32
                                           | (0xffffffffu - (unsigned)pos[i]);
                    }
                }
            }
            __syncthreads();
            int place = eq_base + einc - e;
#pragma unroll
            for (int u = 0; u < TOP_WARPS; ++u) {
                const int s = s_weq[epar][u];
                place += u < w ? s : 0;
                eq_base += s;
            }
            STAMP(5, eq_base);
            if (e > 0) {
#pragma unroll
                for (int i = 0; i < TOP_PER; ++i) {
                    if (size[i] == T) {
                        if (place < ties) s_top_pos[ngt + place] = pos[i];
                        ++place;
                    }
                }
            }
        }
        if (c0 + TOP_CHUNK < tiles) __syncthreads();    // the list is written again
    }

    // The winners above T (every one listed before the last barrier), two
    // neighbouring lanes each, a half of the list each: a winner's rank
    // counts the listed keys above its own, a key being size << 32 |
    // ~position, so (size descending, position ascending). The winners are
    // staged by rank in shared memory and written out together.
    const int wi = t >> 1, half = t & 1;
    int above = 0;
    unsigned long long key = 0;
    if (wi < ngt) {
        key = s_gt_key[wi];
#pragma unroll 8
        for (int u = half; u < ngt; u += 2) above += s_gt_key[u] > key;
    }
    above += __shfl_xor_sync(FULL, above, 1);
    if (wi < ngt && half == 0) {
        s_top_pos[above] = (int)(0xffffffffu - (unsigned)key);
        s_top_size[above] = (int)(key >> 32);
    }
    __syncthreads();
    if (t < C) {
        const bool won = t < want;
        top_pos[(size_t)b * C + t] = won ? s_top_pos[t] : 0;
        count[(size_t)b * C + t] = won ? (t < ngt ? s_top_size[t] : T) : 0;
        valid[(size_t)b * C + t] = won;
    }
    STAMP(6, above);
    if (t == 0) {
        const int tot_size = want > 0 ? s_gtsum + ties * T : 0;
        n_clusters[b] = tot_first;
        n_eligible[b] = tot_elig;
        edge_stride_out[b] = stride;
        overflow[b] = ne > E || comp_overflow[b] || tot_elig > C || tot_size > E2;
    }
    STAMP(7, t);
}

__device__ __forceinline__ void pair_terms(int32_t pv, float& x, float& y, float& gx, float& gy) {
    x = __fmul_rn((float)(pv & 0xFFF), 0.5f);
    y = __fmul_rn((float)((pv >> 12) & 0xFFF), 0.5f);
    const int gp = pv >> 24;
    gx = (float)((gp & 0x3) - 1);
    gy = (float)(((gp >> 2) & 0x3) - 1);
}

// The plain version's _diamond_bin: a monotone circular angle surrogate.
// The quadrant picks the numerator and the offset, so every lane divides
// once, on one path.
__device__ __forceinline__ int diamond_bin(float dx, float dy) {
    const float tiny = (float)1e-12;
    const float ax = fabsf(dx), ay = fabsf(dy);
    float den = __fadd_rn(ax, ay);
    if (den < tiny) den = tiny;
    const bool up = dy >= 0.0f, right = dx >= 0.0f;
    const float num = up ? (right ? dy : ax) : (right ? dx : ay);
    const float off = up ? (right ? 0.0f : 1.0f) : (right ? 3.0f : 2.0f);
    const float f = __fdiv_rn(num, den);
    const float a = up && right ? f : __fadd_rn(off, f);
    const int bin = (int)__fmul_rn(a, (float)(NBINS / 4));
    return min(max(bin, 0), NBINS - 1);
}

// The warps a slot of n resident pairs takes: ceil(n / per) rounded up to
// a power of two, at most MOM_WARPS (at least 1).
__device__ __forceinline__ int slot_warps(int n, int per) {
    const int k = max(1, (n + per - 1) / per);
    return k >= MOM_WARPS ? MOM_WARPS : 1 << (32 - __clz(k - 1));
}

// One step of pass 2 for a warp: lane l holds a pair (has) of bin `bin`
// and its five f32 terms t. The lanes are ranked by (bin, lane) (a radix
// rank by ballots: no pair sorts last), and each writes its terms to that
// rank in the warp's staging (stg, 5 x 32 floats; sbin, 32 bins), so each
// bin's pairs lie in one segment; a segmented sum over the staged order
// (lane r adds lane r + d's sum while r + d is in its segment, d = 1, 2, 4,
// ...: a fixed tree, in f64) leaves each bin's sums at its segment's head,
// which adds them and its pair count into the warp's table tab. Every bin
// has one head, so no two lanes add into one cell.
__device__ __forceinline__ void add_bins(bool has, int bin, const float (&t)[NQ - 1],
                                         double* tab, float* stg, int* sbin, int lane) {
    const int key = has ? bin : NBINS;
    unsigned eq = FULL;
    int less = 0;
#pragma unroll
    for (int k = 6; k >= 0; --k) {          // keys are under 2^7
        const bool bit = (key >> k) & 1;
        const unsigned bb = __ballot_sync(FULL, bit);
        if (bit) {
            less += __popc(eq & ~bb);
            eq &= bb;
        } else {
            eq &= ~bb;
        }
    }
    const int at = less + __popc(eq & ((1u << lane) - 1u));
    sbin[at] = key;
#pragma unroll
    for (int q = 0; q < NQ - 1; ++q) stg[q * 32 + at] = t[q];
    __syncwarp();
    const int b = sbin[lane];
    const bool head = lane == 0 || sbin[lane - 1] != b;
    const unsigned heads = __ballot_sync(FULL, head);
    const unsigned after = heads & ~((2u << lane) - 1u);
    const int end = after ? __ffs(after) - 1 : 32;   // the end of lane's segment
    double v[NQ - 1];
#pragma unroll
    for (int q = 0; q < NQ - 1; ++q) v[q] = stg[q * 32 + lane];
    const int most = (int)__reduce_max_sync(FULL, head && b < NBINS ? (unsigned)(end - lane) : 1u);
    for (int d = 1; d < most; d <<= 1) {
#pragma unroll
        for (int q = 0; q < NQ - 1; ++q) {
            const double o = __shfl_down_sync(FULL, v[q], d);
            if (lane + d < end) v[q] = __dadd_rn(v[q], o);
        }
    }
    if (head && b < NBINS) {
        double* cell = tab + b * NQ;
        cell[0] = __dadd_rn(cell[0], (double)(end - lane));
#pragma unroll
        for (int q = 0; q < NQ - 1; ++q) cell[q + 1] = __dadd_rn(cell[q + 1], v[q]);
    }
    __syncwarp();
}

// A block of MOM_WARPS warps; warp u of block k is the frame's warp
// MOM_WARPS k + u, and works on the slot whose warps hold it (see
// slot_warps and the comment at the top).
__global__ void __launch_bounds__(MOM_THREADS, 4)
cm_moments_kernel(const int32_t* __restrict__ pay_s, const int32_t* __restrict__ top_pos,
                  const int32_t* __restrict__ count, float* __restrict__ table,
                  float* __restrict__ centroid, float* __restrict__ scale,
                  uint8_t* __restrict__ dark, int row, int C, int E2) {
    const int per = gridDim.x <= MOM_FEW_FRAMES ? 64 : 128;   // pairs a warp, about
    __shared__ double wt[MOM_WARPS][NBINS * NQ];   // a warp's table
    __shared__ long long part[MOM_WARPS][6];       // a warp's pass-1 sums
    __shared__ int s_slot[MOM_WARPS], s_rank[MOM_WARPS], s_parts[MOM_WARPS], s_n[MOM_WARPS],
        s_p[MOM_WARPS];
    __shared__ float stage[MOM_WARPS][(NQ - 1) * 32];   // a warp's pass-2 terms in bin order
    __shared__ int stage_bin[MOM_WARPS][32];
    const int b = blockIdx.x, k = blockIdx.y, t = threadIdx.x, lane = t & 31, u = t >> 5;
    if (u == 0) {
        // Lane l: slots 4 l .. 4 l + 3. Resident pairs n (the count cut at
        // E2 less the slots before), warps w, first warp (the prefix of w,
        // or MOM_WARPS j when w grows somewhere).
        int c[4], top[4], sum = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int j = 4 * lane + i;
            c[i] = j < C ? count[(size_t)b * C + j] : 0;
            top[i] = j < C ? top_pos[(size_t)b * C + j] : 0;
            sum += c[i];
        }
        if (lane < MOM_WARPS) s_slot[lane] = -1;
        int before = sum;
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(FULL, before, d);
            if (lane >= d) before += v;
        }
        before -= sum;
        int n[4], w[4], wsum = 0;
        bool grows = false;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            n[i] = max(0, min(c[i], E2 - before));
            before += c[i];
            w[i] = slot_warps(n[i], per);
            wsum += w[i];
            if (i) grows |= w[i] > w[i - 1];
        }
        const int w_prev = __shfl_up_sync(FULL, w[3], 1);
        grows |= lane > 0 && 4 * lane < C && w[0] > w_prev;
        const bool packed = !__any_sync(FULL, grows);
        int first = wsum;
        for (int d = 1; d < 32; d <<= 1) {
            const int v = __shfl_up_sync(FULL, first, d);
            if (lane >= d) first += v;
        }
        first -= wsum;
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int j = 4 * lane + i, at = packed ? first : MOM_WARPS * j;
            if (j < C && at / MOM_WARPS == k)
                for (int r = 0; r < w[i]; ++r) {
                    const int v = at % MOM_WARPS + r;
                    s_slot[v] = j;
                    s_rank[v] = r;
                    s_parts[v] = w[i];
                    s_n[v] = n[i];
                    s_p[v] = top[i];
                }
            first += w[i];
        }
    }
    __syncthreads();
    if (s_slot[0] < 0) return;              // a block past the frame's warps (uniform)
    const int j = s_slot[u], r = s_rank[u], parts = s_parts[u], lead = u - r;
    const bool live = j >= 0;
    int lo = 0, hi = 0;
    const int32_t* py = pay_s + (size_t)b * row;
    if (live) {
        const int n = s_n[u];
        lo = r * n / parts;
        hi = (r + 1) * n / parts;
        py += s_p[u];
    }
    double* tab = wt[u];
    for (int c = lane; c < NBINS * NQ; c += 32) tab[c] = 0.0;

    // Pass 1: the centroid terms as integers (2 x, 2 y, 4 (x^2 + y^2) as
    // the plain version rounds it in f32, gx, gy, 2 (x gx + y gy)), exact:
    // the plain version's f64 sums, which are exact too.
    long long s3 = 0;
    int sx = 0, sy = 0, sgx = 0, sgy = 0, s6 = 0;
    for (int base = lo; base < hi; base += 32 * MOM_LANE_PAIRS) {
        int32_t pv[MOM_LANE_PAIRS];
#pragma unroll
        for (int q = 0; q < MOM_LANE_PAIRS; ++q) {
            const int i = base + lane + 32 * q;
            pv[q] = i < hi ? py[i] : 0;
        }
#pragma unroll
        for (int q = 0; q < MOM_LANE_PAIRS; ++q) {
            if (base + lane + 32 * q >= hi) continue;
            const int X = pv[q] & 0xFFF, Y = (pv[q] >> 12) & 0xFFF, gp = pv[q] >> 24;
            const int gx = (gp & 0x3) - 1, gy = ((gp >> 2) & 0x3) - 1;
            const float x = __fmul_rn((float)X, 0.5f), y = __fmul_rn((float)Y, 0.5f);
            s3 += (long long)__fmul_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), 4.0f);
            sx += X;
            sy += Y;
            sgx += gx;
            sgy += gy;
            s6 += X * gx + Y * gy;
        }
    }
    sx = __reduce_add_sync(FULL, sx);
    sy = __reduce_add_sync(FULL, sy);
    sgx = __reduce_add_sync(FULL, sgx);
    sgy = __reduce_add_sync(FULL, sgy);
    s6 = __reduce_add_sync(FULL, s6);
    for (int d = 16; d > 0; d >>= 1) s3 += __shfl_down_sync(FULL, s3, d);
    if (lane == 0) {
        part[u][0] = sx;
        part[u][1] = sy;
        part[u][2] = s3;
        part[u][3] = sgx;
        part[u][4] = sgy;
        part[u][5] = s6;
    }
    __syncthreads();
    // Every warp of a slot finds its centroid from the slot's pass-1 sums
    // (lane 0; the slot's first warp writes it out).
    float cx = 0.0f, cy = 0.0f, inv = 0.0f;
    if (live) {
        if (lane == 0) {
            long long q6[6] = {0, 0, 0, 0, 0, 0};
            for (int v = 0; v < parts; ++v)
                for (int q = 0; q < 6; ++q) q6[q] += part[lead + v][q];
            const double c[7] = {(double)s_n[u], 0.5 * (double)q6[0], 0.5 * (double)q6[1],
                                 0.25 * (double)q6[2], (double)q6[3], (double)q6[4],
                                 0.5 * (double)q6[5]};
            float f[7];
            for (int q = 0; q < 7; ++q) f[q] = __double2float_rn(c[q]);
            const float safe = f[0] < 1.0f ? 1.0f : f[0];
            cx = __fdiv_rn(f[1], safe);
            cy = __fdiv_rn(f[2], safe);
            const double s64 = (double)safe;
            const double m1 = __ddiv_rn(c[1], s64), m2 = __ddiv_rn(c[2], s64);
            float r2 = __double2float_rn(__dsub_rn(
                __dsub_rn(__ddiv_rn(c[3], s64), __dmul_rn(m1, m1)), __dmul_rn(m2, m2)));
            const float tiny = (float)1e-12;
            if (r2 < tiny) r2 = tiny;
            inv = rsqrtf(r2);
            if (r == 0) {
                const float mean_dot = __fdiv_rn(
                    __fsub_rn(__fsub_rn(f[6], __fmul_rn(cx, f[4])), __fmul_rn(cy, f[5])), safe);
                const size_t slot = (size_t)b * C + j;
                centroid[2 * slot] = cx;
                centroid[2 * slot + 1] = cy;
                scale[slot] = __fsqrt_rn(r2);
                dark[slot] = mean_dot > 0.0f;
            }
        }
        cx = __shfl_sync(FULL, cx, 0);
        cy = __shfl_sync(FULL, cy, 0);
        inv = __shfl_sync(FULL, inv, 0);
    }

    // Pass 2: 32 pairs of the warp's range at a time, a pair a lane, each
    // bin's lanes summed and added once (add_bins).
    if (live) {
        for (int base = lo; base < hi; base += 32) {
            const int i = base + lane;
            int bin = 0;
            float tq[NQ - 1] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            if (i < hi) {
                float x, y, gx, gy;
                pair_terms(py[i], x, y, gx, gy);
                const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy);
                bin = diamond_bin(dx, dy);
                const float ux = __fmul_rn(dx, inv), uy = __fmul_rn(dy, inv);
                tq[0] = ux;
                tq[1] = uy;
                tq[2] = __fmul_rn(ux, ux);
                tq[3] = __fmul_rn(ux, uy);
                tq[4] = __fmul_rn(uy, uy);
            }
            add_bins(i < hi, bin, tq, tab, stage[u], stage_bin[u], lane);
        }
    }
    __syncthreads();

    // The slot's table: its warps' tables summed in warp order.
    if (live) {
        float* out = table + ((size_t)b * C + j) * NBINS * NQ;
        for (int c = 32 * r + lane; c < NBINS * NQ; c += 32 * parts) {
            double sum = wt[lead][c];
            for (int v = 1; v < parts; ++v) sum = __dadd_rn(sum, wt[lead + v][c]);
            out[c] = __double2float_rn(sum);
        }
    }
}

}  // namespace

// The later passes' sort tiles: 2^tshift positions, 1024 or 4096; T of
// them a frame's row of 4 H W pair slots.
static bool sort_shape_ok(long long N, int tshift, int T) {
    return (tshift == 10 || tshift == 12) && T == (int)((N + (1LL << tshift) - 1) >> tshift);
}

// The pixel kernels' vector path: rows of a multiple of 4 pixels, tri 4-
// and dense 16-byte aligned.
static bool quads_vec(const void* tri, const void* dense, int W) {
    return W % 4 == 0 && (uintptr_t)tri % 4 == 0 && (uintptr_t)dense % 16 == 0;
}

// Blocks of the pair count the card holds at once: its SMs times the
// kernel's resident blocks an SM (read at the first call).
template <bool VEC>
static cudaError_t count_fill(int* fill) {
    static int cached = 0;
    if (!cached) {
        int dev = 0, sms = 0, occ = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, cm_edge_count_kernel<VEC>,
                                                              PIX_THREADS, 0);
        if (e != cudaSuccess) return e;
        cached = max(1, sms * occ);
    }
    *fill = cached;
    return cudaSuccess;
}

// One wave: each frame's blocks of 4 PIX_THREADS pixels split evenly over
// ceil(blocks / iters) blocks of the grid, iters the fewest that fit the
// batch in the blocks the card holds at once (one block a frame at least).
extern "C" int apriltag_cm_count(const void* tri, const void* dense, void* num_edge, int B,
                                 int H, int W, void* stream) {
    if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
    const bool vec = quads_vec(tri, dense, W);
    int fill = 0;
    const cudaError_t e = vec ? count_fill<true>(&fill) : count_fill<false>(&fill);
    if (e != cudaSuccess) return (int)e;
    const long long nblk = ((long long)H * W + 4 * PIX_THREADS - 1) / (4 * PIX_THREADS);
    const long long most = max(1, fill / B);          // blocks a frame in one wave
    const long long iters = (nblk + most - 1) / most;
    const dim3 grid((unsigned)((nblk + iters - 1) / iters), B);
    auto kernel = vec ? cm_edge_count_kernel<true> : cm_edge_count_kernel<false>;
    kernel<<<grid, PIX_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)tri, (const int32_t*)dense, (int32_t*)num_edge, H, W);
    return (int)cudaGetLastError();
}

// ctl (B, P), digits (P, B, RADIX), odig (B, 4, R0), gsum (B, 4, groups,
// R0) and kept (B) are one buffer in that order, zeroed by one memset, P =
// SORT_PASSES; tcnt is (B, 4, blocks, R0), written whole by the kernel;
// blocks = ceil(H W / PAIR_BLOCK), groups = ceil(blocks / FIRST_GROUP).
extern "C" int apriltag_cm_pair_count(const void* tri, const void* dense, const void* num_edge,
                                      void* ctl, void* digits, void* odig, void* gsum,
                                      void* kept, void* tcnt, int B, int H, int W, int budget,
                                      int extra, void* stream) {
    if (B < 1 || H < 1 || W < 1 || budget < 1 || extra < 0) return (int)cudaErrorInvalidValue;
    constexpr size_t P = SORT_PASSES;
    const size_t nblk = ((size_t)H * W + PAIR_BLOCK - 1) / PAIR_BLOCK;
    const size_t ng = (nblk + FIRST_GROUP - 1) / FIRST_GROUP;
    int32_t* z = (int32_t*)ctl;
    if ((int32_t*)digits != z + (size_t)B * P
        || (int32_t*)odig != (int32_t*)digits + P * B * RADIX
        || (int32_t*)gsum != (int32_t*)odig + B * 4 * R0
        || (int32_t*)kept != (int32_t*)gsum + B * 4 * ng * R0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    // `extra` more ints past kept (the stage's segment-tiles histogram) in the same memset.
    const cudaError_t e = cudaMemsetAsync(
        ctl, 0,
        ((size_t)B * P + P * B * RADIX + B * 4 * R0 + B * 4 * ng * R0 + B + extra)
            * sizeof(int32_t),
        st);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((H * W + PAIR_BLOCK - 1) / PAIR_BLOCK, B);
    auto kernel = quads_vec(tri, dense, W) ? cm_pair_count_kernel<true>
                                           : cm_pair_count_kernel<false>;
    kernel<<<grid, PAIR_THREADS, 0, st>>>((const uint8_t*)tri, (const int32_t*)dense,
                                          (const int32_t*)num_edge, (int32_t*)digits,
                                          (int32_t*)odig, (int32_t*)gsum, (int32_t*)kept,
                                          (int32_t*)tcnt, H, W, budget);
    return (int)cudaGetLastError();
}

template <int SRC, int KPT>
static int launch_pass(const PassArgs& a, dim3 grid, cudaStream_t st) {
    auto kernel = cm_radix_scatter_kernel<SRC, KPT>;
    const size_t smem = SRC == SRC_ROWS ? rows_smem<KPT>() : FIRST_SMEM;
    if (smem > 48 * 1024) {                 // past 48 KB the kernel must opt in
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, SORT_THREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
}

// The first pass: a block a (frame, pixel block); T and kpt are the later
// passes' tiles, whose pass-1 look-back words it zeroes.
extern "C" int apriltag_cm_radix_first(const void* tri, const void* dense, const void* num_edge,
                                       const void* kept, const void* digits, const void* odig,
                                       const void* tcnt, const void* gsum, void* look,
                                       void* key_out, void* pay_out, int B, int H, int W,
                                       int budget, int T, int kpt, void* stream) {
    if (B < 1 || H < 1 || W < 1 || budget < 1 || (kpt != 4 && kpt != 16)
        || !sort_shape_ok(4LL * H * W, kpt == 16 ? 12 : 10, T))
        return (int)cudaErrorInvalidValue;
    PassArgs a{(const uint8_t*)tri, (const int32_t*)dense, (const int32_t*)num_edge, nullptr,
               nullptr, (const int32_t*)kept, (const int32_t*)digits, (const int32_t*)odig,
               (const int32_t*)tcnt, (const int32_t*)gsum, (int32_t*)look, nullptr,
               (int32_t*)key_out, (int32_t*)pay_out, H, W, budget, 4 * H * W, T,
               SORT_THREADS * kpt, 0, 0};
    const dim3 grid(B, (H * W + PAIR_BLOCK - 1) / PAIR_BLOCK);
    return quads_vec(tri, dense, W)
               ? launch_pass<SRC_PIXELS_VEC, 0>(a, grid, (cudaStream_t)stream)
               : launch_pass<SRC_PIXELS, 0>(a, grid, (cudaStream_t)stream);
}

// A later pass (1 <= pass < SORT_PASSES) over rows of N slots; `blocks` a
// frame.
extern "C" int apriltag_cm_radix_scatter(const void* key_in, const void* pay_in, const void* kept,
                                         const void* digits, void* look, void* ctl,
                                         void* key_out, void* pay_out, int B, int N, int T,
                                         int blocks, int pass, int kpt, int E, void* stream) {
    if (B < 1 || N < 1 || blocks < 1 || pass < 1 || pass >= SORT_PASSES || E < 1 || E > N
        || (kpt != 4 && kpt != 16) || !sort_shape_ok(N, kpt == 16 ? 12 : 10, T))
        return (int)cudaErrorInvalidValue;
    PassArgs a{nullptr, nullptr, nullptr, (const int32_t*)key_in, (const int32_t*)pay_in,
               (const int32_t*)kept, (const int32_t*)digits, nullptr, nullptr, nullptr,
               (int32_t*)look, (int32_t*)ctl, (int32_t*)key_out, (int32_t*)pay_out, 0, 0, 0, N,
               T, SORT_THREADS * kpt, E, pass};
    const dim3 grid(blocks, B);
    cudaStream_t st = (cudaStream_t)stream;
    return kpt == 16 ? launch_pass<SRC_ROWS, 16>(a, grid, st) : launch_pass<SRC_ROWS, 4>(a, grid, st);
}

// The tiles kernel's warps of one wave on the current device: SMs times
// its resident blocks an SM times SEG_WARPS (asked once a device).
static int seg_wave_warps() {
    static int wave[64] = {};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0) return 0;
    if (dev < 64 && wave[dev] > 0) return wave[dev];
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cm_seg_tiles_kernel,
                                                         SEG_THREADS, 0) != cudaSuccess)
        return 0;
    const int n = max(1, sms * per_sm) * SEG_WARPS;
    if (dev < 64) wave[dev] = n;
    return n;
}

// `zeroed`: hist is already zero (the sort's memset); else it is zeroed here.
extern "C" int apriltag_cm_seg_tiles(const void* key_s, const void* num_edge, void* stats,
                                     void* cand, void* hist, void* nv, int B, int row, int E,
                                     int tiles, int min_pix, int max_per, int budget, int zeroed,
                                     void* stream) {
    if (B < 1 || budget < 1 || E < 1 || E > row || row % 4 || max_per < 0
        || max_per > SEG_MAX_PER || tiles != (E + SEG_TILE - 1) / SEG_TILE)
        return (int)cudaErrorInvalidValue;
    if (!zeroed) {
        const cudaError_t e = cudaMemsetAsync(
            hist, 0, (size_t)B * (max_per + 1) * sizeof(int32_t), (cudaStream_t)stream);
        if (e != cudaSuccess) return (int)e;
    }
    const int wave = seg_wave_warps();
    if (wave < 1) return (int)cudaErrorInvalidValue;
    const int warps = min(tiles, max(1, wave / B));    // a frame's
    const dim3 grid((warps + SEG_WARPS - 1) / SEG_WARPS, B);
    cm_seg_tiles_kernel<<<grid, SEG_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)key_s, (const int32_t*)num_edge, (int32_t*)stats, (int32_t*)cand,
        (int32_t*)hist, (int32_t*)nv, row, E, tiles, warps, min_pix, max_per, budget);
    return (int)cudaGetLastError();
}

extern "C" int apriltag_cm_seg_top(const void* stats, const void* cand, const void* hist,
                                   const void* nv, const void* num_edge,
                                   const void* comp_overflow, void* cross, void* top_pos,
                                   void* count, void* valid, void* n_clusters, void* n_eligible,
                                   void* edge_stride, void* overflow, int B, int tiles, int E,
                                   int E2, int C, int min_pix, int max_per, int budget,
                                   void* stream) {
    if (budget < 1 || C < 1 || C > MAX_C || E < 1 || max_per < 0 || max_per > SEG_MAX_PER
        || tiles != (E + SEG_TILE - 1) / SEG_TILE)
        return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(max_per + 1 + (max_per + TOP_BIN) / TOP_BIN) * sizeof(int32_t);
    // Past 48 KB with the static arrays (about 26 KB) the kernel must opt in.
    if (smem > 20 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            cm_seg_top_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    cm_seg_top_kernel<<<B, TOP_THREADS, smem, (cudaStream_t)stream>>>(
        (const int32_t*)stats, (const int32_t*)cand, (const int32_t*)hist, (const int32_t*)nv,
        (const int32_t*)num_edge, (const uint8_t*)comp_overflow, (int32_t*)cross,
        (int32_t*)top_pos, (int32_t*)count, (uint8_t*)valid, (int32_t*)n_clusters,
        (int32_t*)n_eligible, (int32_t*)edge_stride, (uint8_t*)overflow, tiles, E, E2, C,
        min_pix, max_per, budget);
    return (int)cudaGetLastError();
}

extern "C" int apriltag_cm_moments(const void* pay_s, const void* top_pos, const void* count,
                                   void* table, void* centroid, void* scale, void* dark, int B,
                                   int row, int C, int E2, void* stream) {
    if (B < 1 || C < 1 || C > MAX_C) return (int)cudaErrorInvalidValue;
    // Frames along x, a frame's blocks along y: the blocks that hold slots
    // (the low y) start first. A frame needs at most C blocks.
    const dim3 grid(B, C);
    cm_moments_kernel<<<grid, MOM_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)pay_s, (const int32_t*)top_pos, (const int32_t*)count, (float*)table,
        (float*)centroid, (float*)scale, (uint8_t*)dark, row, C, E2);
    return (int)cudaGetLastError();
}
