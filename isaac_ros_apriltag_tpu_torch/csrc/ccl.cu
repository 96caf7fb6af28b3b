// One connected-component-labeling scan round, as two kernels.
//
// Replaces: isaac_ros_apriltag_tpu/ops/pallas/ccl.py, `_row_kernel` (K2) and
// `_col_diag_kernel` (K3), launched once each per round by
// `connected_components_pallas` (through `ccl_scan_pallas`). Both are
// bit-exact with the plain versions in
// isaac_ros_apriltag_tpu_torch/ops/cuda/ccl.py.
//
// Semantics (tri is a batch of u8 trinary images {0, 127, 255}, (B, H, W),
// labels are int32 of the same shape; frames never touch):
//   K2: a forward then a backward segmented min-scan along each row. A
//       segment breaks where tri changes or tri == 127, so every maximal run
//       of equal non-127 values ends up holding the run's minimum label and
//       127 pixels keep their own.
//   K3: a white-only diagonal hop (a 255 pixel takes the min of its own
//       label and the labels of its diagonal neighbours that are also 255,
//       all read from the INPUT labels; neighbours outside the frame never
//       connect), then the same forward/backward segmented min-scan down each
//       column. Input and output are separate buffers.
//
// Both scans compute the run minimum in O(n) work. The forward scan is a
// segmented min with a (min, broken) carry; since the forward value is
// non-increasing along a run, the backward scan only has to copy each run's
// last forward value to the run, which is the run's minimum. Integer min is
// exact, so the order of the work does not change the labels.
//
// What bounds them on an H100: the least time is set by bytes. A call reads
// the u8 trinary and the int32 labels once and writes the labels once, 9
// bytes a pixel: 37 MB and 11.1 us at 3.35 TB/s for a batch of 8 x 540 x
// 960; the few integer operations a pixel are far below the card's rate.
// K2 comes near that bound once every access is coalesced and enough loads
// are in flight. K3 walks each column chunk row by row, so its time is the
// chain of memory round trips along that walk (and at batch 8 its 240
// blocks are fewer than two per SM): the design keeps COL_UNROLL rows of
// loads in flight per round trip, loads the halo in the same round trip,
// and fits two 512-thread blocks on an SM (64 registers a thread). Neither
// kernel has a block-wide barrier inside its scans.
//
// K2 (rows): one warp per row, up to 8 rows a block. The warp walks its row
// in groups of 32 pixels, lane i on pixel 32g + i, so every load and store
// is coalesced; it loads ROW_UNROLL groups before it scans them. A group's
// segment breaks are one __ballot_sync; the forward scan inside a group is
// five __shfl_up_sync steps bounded by the lane's segment start, and the
// carry between groups is lane 31's value. The forward values and the break
// masks stay in the warp's slice of shared memory (4 bytes a pixel, 16.5 KB
// at the 4096-pixel limit, so a block stays under 48 KB). The backward pass
// walks the groups from the end: each lane takes the forward value at the
// end of its run with one __shfl_sync, or the carry of the next group when
// its run goes on past the group.
//
// K3 (columns): one block per band of 32 adjacent columns of one frame, one
// lane per column, so a warp's load of one row of the band is 128
// contiguous bytes of labels and 32 of trinary. The band's rows are split
// into up to COL_WARPS contiguous chunks, one per warp, and each lane walks
// its column chunk row by row (COL_UNROLL rows loaded at a time). The hop's
// diagonal neighbours come from the rows above and below, which the lane
// holds in a sliding window; the x +- 1 labels come from the neighbouring
// lanes by shuffle, and lanes 0 and 31 load the band's halo columns. Pass 1
// writes each chunk's local forward scan (no carry yet) to lab_out and keeps
// a summary of the chunk in registers and shared memory. One warp then
// combines the chunks' summaries down each column (forward, then backward)
// and pass 2 walks each chunk bottom-up, reading its pass-1 values back (the
// same thread wrote them, and they are still in L2), applying both carries
// and writing the result. Two block barriers in all; shared memory is 8.5 KB
// whatever H is, since the column itself never sits in shared memory (a
// 4096-row band of 32 columns would not fit).
//
// No padding is needed: the TPU version padded the image to 64x128 tiles
// with 127 pixels, which never join a segment.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int32_t NONE = INT32_MAX;   // identity of min: the carry before any pixel
constexpr int ROW_WARPS = 8;          // K2: rows (warps) per block, at most
constexpr int ROW_UNROLL = 8;         // K2: groups of 32 pixels loaded before they are scanned
constexpr int ROW_SMEM = 48 * 1024;   // K2: shared memory a block may take
constexpr int COL_BAND = 32;          // K3: columns per block, one per lane
constexpr int COL_WARPS = 16;         // K3: row chunks (warps) per block, at most
constexpr int COL_UNROLL = 8;         // K3: rows loaded before they are scanned

// Pixel i of a line starts a new segment unless it has the same trinary
// value as pixel i - 1 and that value is not 127. Outside the frame the
// trinary value is 127, so lines start and end segments by themselves.
__device__ __forceinline__ bool starts(int t, int prev) { return t != prev || t == 127; }

// ---------------------------------------------------------------- K2: rows

// Shared memory of one warp: W rounded up to groups of 32 forward values,
// then one break mask per group and one for the pixel after the row.
__host__ __device__ inline int row_warp_words(int W) {
    const int G = (W + 31) / 32;
    return G * 32 + G + 1;
}

__global__ void __launch_bounds__(ROW_WARPS * 32)
row_scan_kernel(const uint8_t* __restrict__ tri, const int32_t* __restrict__ lab_in,
                int32_t* __restrict__ lab_out, int rows, int W) {
    extern __shared__ int32_t row_smem[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int row = blockIdx.x * (blockDim.x >> 5) + warp;
    if (row >= rows) return;               // whole warps only; no block barrier below
    const int G = (W + 31) / 32;
    int32_t* fwd = row_smem + warp * row_warp_words(W);
    uint32_t* brk = reinterpret_cast<uint32_t*>(fwd + G * 32);
    const size_t base = (size_t)row * W;

    // Forward: segmented min-scan, group by group.
    int32_t carry = NONE;
    for (int g0 = 0; g0 < G; g0 += ROW_UNROLL) {
        int t[ROW_UNROLL], tp[ROW_UNROLL];
        int32_t l[ROW_UNROLL];
#pragma unroll
        for (int k = 0; k < ROW_UNROLL; ++k) {
            const int x = (g0 + k) * 32 + lane;
            const bool in = x < W;
            t[k] = in ? tri[base + x] : 127;
            l[k] = in ? lab_in[base + x] : NONE;
            tp[k] = (lane == 0 && in && x > 0) ? tri[base + x - 1] : 127;
        }
#pragma unroll
        for (int k = 0; k < ROW_UNROLL; ++k) {
            const int g = g0 + k;
            if (g >= G) break;
            int prev = __shfl_up_sync(FULL, t[k], 1);
            if (lane == 0) prev = tp[k];
            const uint32_t m = __ballot_sync(FULL, starts(t[k], prev));
            // s: the lane's segment start within the group, -1 if the
            // segment began in an earlier group.
            const uint32_t upto = m & (FULL >> (31 - lane));
            const int s = upto ? 31 - __clz(upto) : -1;
            int32_t v = l[k];
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const int32_t o = __shfl_up_sync(FULL, v, d);
                if (lane >= d && lane - d >= s) v = min(v, o);
            }
            if (s < 0) v = min(v, carry);
            carry = __shfl_sync(FULL, v, 31);
            fwd[g * 32 + lane] = v;
            if (lane == 0) brk[g] = m;
        }
    }
    if (lane == 0) brk[G] = 1;             // the row ends every segment
    __syncwarp();

    // Backward: each pixel takes the forward value at the end of its run.
    carry = NONE;
    for (int g = G - 1; g >= 0; --g) {
        const int x = g * 32 + lane;
        const int32_t v = fwd[x];
        // Bit i: pixel 32g + i ends its run (pixel 32g + i + 1 starts one).
        const uint32_t ends = (brk[g] >> 1) | (brk[g + 1] << 31);
        const uint32_t from = ends & (FULL << lane);
        int32_t res = __shfl_sync(FULL, v, from ? __ffs(from) - 1 : 0);
        if (!from) res = carry;
        carry = __shfl_sync(FULL, res, 0);
        if (x < W) lab_out[base + x] = res;
    }
}

// ------------------------------------------------------------- K3: columns

// One row of the band as one lane sees it: its trinary value and label, and
// the least label of its left and right neighbours that are white (255),
// NONE if neither is or both lie outside the frame.
struct Row {
    int t;
    int32_t l, side;
};

__device__ __forceinline__ Row load_row(const uint8_t* __restrict__ tri,
                                        const int32_t* __restrict__ lab, int y, int x,
                                        int lane, int H, int W) {
    Row r{127, NONE, NONE};
    const bool in_y = y >= 0 && y < H;
    const size_t o = (size_t)(in_y ? y : 0) * W + x;
    if (in_y && x < W) {
        r.t = tri[o];
        r.l = lab[o];
    }
    // Lanes 0 and 31 also load the band's halo column, trinary and label in
    // one round trip.
    const int hx = lane == 0 ? x - 1 : x + 1;
    int ht = 127;
    int32_t hl = NONE;
    if ((lane == 0 || lane == 31) && in_y && hx >= 0 && hx < W) {
        ht = tri[o - x + hx];
        hl = lab[o - x + hx];
    }
    const int32_t white = r.t == 255 ? r.l : NONE;
    int32_t left = __shfl_up_sync(FULL, white, 1);
    int32_t right = __shfl_down_sync(FULL, white, 1);
    const int32_t halo = ht == 255 ? hl : NONE;
    if (lane == 0) left = halo;
    if (lane == 31) right = halo;
    r.side = min(left, right);
    return r;
}

__global__ void __launch_bounds__(COL_WARPS * 32)
col_diag_kernel(const uint8_t* __restrict__ tri, const int32_t* __restrict__ lab_in,
                int32_t* __restrict__ lab_out, int H, int W, int chunk) {
    // Per (chunk, column): pass 1's summary, then the carries into the chunk.
    __shared__ int32_t s_last[COL_WARPS][COL_BAND];   // forward value of the chunk's last row
    __shared__ int32_t s_head[COL_WARPS][COL_BAND];   // forward value at the end of its first run
    __shared__ uint8_t s_flags[COL_WARPS][COL_BAND];  // START0 | INNER | END
    __shared__ int32_t c_fwd[COL_WARPS][COL_BAND];    // forward carry from the chunks above
    __shared__ int32_t c_bwd[COL_WARPS][COL_BAND];    // result of the row below the chunk
    constexpr uint8_t START0 = 1, INNER = 2, END = 4;

    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int x = blockIdx.x * COL_BAND + lane;
    const bool in_x = x < W;
    const size_t frame = (size_t)blockIdx.y * H * W;
    tri += frame;
    lab_in += frame;
    lab_out += frame;
    const int y0 = w * chunk, y1 = min(H, y0 + chunk);

    // Pass 1: hop, and the chunk's forward scan without a carry from above.
    Row prev = load_row(tri, lab_in, y0 - 1, x, lane, H, W);
    Row cur = load_row(tri, lab_in, y0, x, lane, H, W);
    int32_t v = NONE, head = NONE;
    bool start0 = false, inner = false;
    int head_end = y1;                     // rows [y0, head_end) take the forward carry
    for (int yb = y0; yb < y1; yb += COL_UNROLL) {
        Row nxt[COL_UNROLL];
#pragma unroll
        for (int k = 0; k < COL_UNROLL; ++k)
            nxt[k] = load_row(tri, lab_in, min(yb + k + 1, y1), x, lane, H, W);
#pragma unroll
        for (int k = 0; k < COL_UNROLL; ++k) {
            const int y = yb + k;
            if (y >= y1) break;
            int32_t m = cur.l;
            if (cur.t == 255) m = min(m, min(prev.side, nxt[k].side));
            const bool s = starts(cur.t, prev.t);
            if (y == y0) {
                start0 = s;
                v = m;
            } else if (s) {
                if (!inner) {
                    inner = true;
                    head = v;
                    head_end = y;
                }
                v = m;
            } else {
                v = min(v, m);
            }
            if (in_x) lab_out[(size_t)y * W + x] = v;
            prev = cur;
            cur = nxt[k];
        }
    }
    if (!inner) head = v;
    if (start0) head_end = y0;
    // Here prev is row y1 - 1 and cur is row y1 (127 past the frame).
    s_last[w][lane] = v;
    s_head[w][lane] = head;
    s_flags[w][lane] = (start0 ? START0 : 0) | (inner ? INNER : 0) |
                       (starts(cur.t, prev.t) ? END : 0);
    __syncthreads();

    // Combine the chunks down each column: one lane per column.
    if (w == 0) {
        int32_t cf = NONE;
        for (int c = 0; c < nw; ++c) {
            c_fwd[c][lane] = cf;
            const int32_t last = s_last[c][lane];
            cf = (s_flags[c][lane] & (START0 | INNER)) ? last : min(cf, last);
        }
        int32_t cb = NONE;
        for (int c = nw - 1; c >= 0; --c) {
            c_bwd[c][lane] = cb;
            const uint8_t f = s_flags[c][lane];
            // The chunk's first run: its final forward value, and whether the
            // run ends inside the chunk or at its last row.
            int32_t first = s_head[c][lane];
            if (!(f & START0)) first = min(first, c_fwd[c][lane]);
            cb = (f & (INNER | END)) ? first : min(first, cb);
        }
    }
    __syncthreads();

    // Pass 2, bottom-up: each row takes the forward value at the end of its run.
    const int32_t cf = c_fwd[w][lane];
    int32_t below = c_bwd[w][lane];        // result of row y + 1
    int t_below = cur.t;                   // trinary value of row y + 1
    for (int yt = y1 - 1; yt >= y0; yt -= COL_UNROLL) {
        int32_t lf[COL_UNROLL];
        int tt[COL_UNROLL];
#pragma unroll
        for (int k = 0; k < COL_UNROLL; ++k) {
            const size_t o = (size_t)max(yt - k, y0) * W + x;
            lf[k] = in_x ? lab_out[o] : NONE;
            tt[k] = in_x ? tri[o] : 127;
        }
#pragma unroll
        for (int k = 0; k < COL_UNROLL; ++k) {
            const int y = yt - k;
            if (y < y0) break;
            const int32_t f = y < head_end ? min(lf[k], cf) : lf[k];
            const int32_t res = starts(t_below, tt[k]) ? f : min(f, below);
            if (in_x) lab_out[(size_t)y * W + x] = res;
            below = res;
            t_below = tt[k];
        }
    }
}

}  // namespace

extern "C" int apriltag_ccl_row(const void* tri, const void* lab_in, void* lab_out,
                                int B, int H, int W, void* stream) {
    const int rows = B * H;
    const size_t warp_bytes = (size_t)row_warp_words(W) * sizeof(int32_t);
    int warps = (int)(ROW_SMEM / warp_bytes);
    warps = warps < 1 ? 1 : (warps > ROW_WARPS ? ROW_WARPS : warps);
    if (warps > rows) warps = rows;
    row_scan_kernel<<<(rows + warps - 1) / warps, warps * 32, warps * warp_bytes,
                      (cudaStream_t)stream>>>(
        (const uint8_t*)tri, (const int32_t*)lab_in, (int32_t*)lab_out, rows, W);
    return (int)cudaGetLastError();
}

extern "C" int apriltag_ccl_col_diag(const void* tri, const void* lab_in, void* lab_out,
                                     int B, int H, int W, void* stream) {
    const int chunk = (H + COL_WARPS - 1) / COL_WARPS;
    const int warps = (H + chunk - 1) / chunk;
    col_diag_kernel<<<dim3((W + COL_BAND - 1) / COL_BAND, B), warps * 32, 0,
                      (cudaStream_t)stream>>>(
        (const uint8_t*)tri, (const int32_t*)lab_in, (int32_t*)lab_out, H, W, chunk);
    return (int)cudaGetLastError();
}
