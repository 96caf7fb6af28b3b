// The detector's tail after the quad fit: the top-2T candidate quads of
// each frame, their edge refinement and decode, the dedupe and top-T tags,
// and their pose.
//
// Replaces: isaac_ros_apriltag_tpu/detector.py:234-245 (the top-2T pick),
// isaac_ros_apriltag_tpu/ops/refine.py:61 (refine_edges),
// isaac_ros_apriltag_tpu/ops/decode.py:105 (decode_quads),
// isaac_ros_apriltag_tpu/detector.py:80 and :254-310 (_dedupe, the top-T
// pick, the takes, the center and the counts) and
// isaac_ros_apriltag_tpu/ops/pose.py:38 (estimate_poses), XLA code with no
// Pallas kernel there. On a TPU the whole tail is one jitted program; in
// PyTorch each of its steps on the (B, 2T) quads and (B, T) tags is a kernel
// of its own that does almost no work (~160 for refine, ~350 for decode,
// ~85 for the picks and ~320 for pose a call), so here each stage is one
// launch that keeps every intermediate in registers or shared memory, and
// neighbouring stages share a launch where one feeds the other little: the
// top-2T pick and refine, the finish and pose.
//
//   refine_kernel, the top-2T pick and refine in one launch, one block a
//     picked quad (B k blocks), thread i quad i of its frame's C <= 128:
//     score_quad gives the quad's polarity gate and perimeter score (-inf
//     where not valid), all loads in one round; select_rank its rank in
//     torch.sort(descending, stable)'s order (NaN first, ties to the lower
//     index) by compares over the set bits of the ballot masks of the
//     quads scored above -inf only, a -inf quad's rank being their count
//     plus its -inf predecessors. The thread of rank q % k puts its corners,
//     upscaled to full resolution, and its dark side in shared memory and
//     writes pre_valid, and the frame's block of rank 0 writes num_quads, so
//     no launch and no global round trip lie between the pick and refine.
//     Then warp k refines edge k: the 12 points'
//     profiles along the edge's normal, 12 x P samples (204 at P = 17), go to all 32
//     lanes (lane l sample l, l + 32, ... of the 12 points' samples taken
//     a profile step at a time, each point's place on the edge shuffled
//     from its lane), every sample's four taps issued before any is used,
//     and are staged in shared memory in chunks of up to REFINE_CHUNK
//     samples a point; lane s < 12 then streams point s's staged samples
//     through a ring of five (the gradient pairs samples j and j - 4), in j
//     order, the ring carried from chunk to chunk, so any search range
//     fits; the edge's weighted line fit is five half-warp sums
//     (refine.py::_point_sum's order); lane 0 of warp k intersects edges
//     k - 1 and k through shared memory and keeps the input corner where the
//     result is not finite or moved too far.
//   decode_kernel, one warp a quad, DECODE_WARPS = 2 quads a block (64
//     blocks for 720p b1's 128 quads): the block stages the codebook in
//     shared memory by cp.async, under the rest; the family's tables and
//     the corners are read before the quad's unit-square homography, which
//     every lane solves alone (homography(): the unit square's corners are
//     constants, so the compiler folds the elimination's first six columns
//     and their pivots, and what is left is a short chain; a form that
//     solved it once a warp, lanes 0-7 a row with warp max, min and ballot
//     for each pivot and shuffles for each pivot row, took ~3 us more on
//     the card); lane l's samples are cells l and l + 32 of the border
//     ring, the outer ring and the bit cells, and all their taps are
//     issued in one round before any is used (bilinear, with
//     bilinear_taps' clamps and NaN-to-index-0 rule, so no lane reads
//     outside its frame); the gray models' sums and the margin's class
//     sums are warp sums (a lane's two cells, then a butterfly), the
//     inverse normal matrices are family tables; sharpening reads the
//     (tw, tw) grid from the warp's shared memory, wrapping as torch.roll
//     does; the bits' ballot gives each rotation's code by a bit reversal,
//     the lanes stride over the staged codebook with __popcll and a warp
//     min of (hamming << 24 | code index) gives the first minimum.
//   tail_finish_kernel, one block a frame, thread j candidate j (2T <= 128):
//     its validity after decode and the margin gate, as four warp ballots
//     in shared memory; the dedupe against every better valid candidate of
//     the same id within 0.75 of the larger mean edge (centers and edges in
//     shared memory), walking the valid masks' set bits only; its rank by
//     margin as select_rank ranks, by compares over the candidates
//     scored above -inf (a second ballot) only, a -inf candidate's rank
//     being their count plus its -inf predecessors; and in the top k its
//     fields and center; the frame's detection count and overflow.
//   pose_kernel, one thread a tag (pose_one): the tag-plane homography,
//     K^-1 (K shared or one per frame), M = K^-1 H, the scale and its sign,
//     the cross product, 4 Newton polar steps and the quaternion. A tag is
//     one thread's chain of ~950 dependent f32 operations, and the 8x8
//     elimination was three quarters of it: its pivot search, predicated
//     row exchanges and 28 divisions. Columns 0-5 of the system hold only
//     the tag's own corners, so at a size whose pivots there are the
//     structural ones the host reduces them once (ops/cuda/pose.py::
//     pose_constants; PoseConsts) and a thread eliminates only the data
//     columns by those multipliers (solve8_fixed), bit for bit solve8.
//   finish_pose_kernel, tail_finish_kernel's block with pose_one after it:
//     the thread that writes top-T slot r poses that tag (K^-1 of the
//     frame's K computed while the candidates load), so the detect path's
//     pose takes no launch of its own; pose_kernel serves the other callers
//     (a rig whose cameras have their own K).
//
// Against the plain versions (ops/tail.py, ops/refine.py::refine_edges,
// ops/decode.py::decode_quads, ops/pose.py::estimate_poses,
// utils/geometry.py): bit-exact. Every float step is theirs in their order
// (built with --fmad=false, IEEE division and square root; clamps, minimum,
// maximum and argmax treat NaN as torch does), a warp sum is their
// _warp_sum or _point_sum (zeros past the set, then halves), and the
// elimination picks the first largest |pivot| of a column.
//
// What bounds them on an H100: bytes, and all far under a microsecond, so a
// launch is bound by its latency: one wave covers a call, and a warp's or a
// thread's steps run one after another. So each kernel issues its loads in
// as few rounds as it can: refine a chunk's tap loads at once, decode its
// tables and codebook before the homography and every sample's taps after
// it in one round.
// refine reads each profile sample's four taps (48 points x (4 search_range
// + 5) samples a quad: ~13 MB at B x 2T = 1024 quads, ~4 us, before the L2
// cache serves the taps that neighbouring samples share); decode reads each
// sample's four taps (100 samples a tag36h11 quad), the corners and the
// codebook (once a block) and writes ~60 bytes a quad: ~0.3 MB at 1024
// quads; the picks read ~40 bytes a quad; pose reads 32 bytes of corners a
// tag and writes 64. The picks' ranks walk only the set bits of their
// masks: the top-2T pick's the frame's quads scored above -inf, the
// finish's dedupe and rank a bench frame's handful of valid candidates, not
// C or 2T steps each; every block of refine_kernel repeats its frame's
// pick, a few us of latency that the launch and the round trip it saves
// outweigh. Pose's bytes are ~0 against its latency,
// a thread's chain, which the host's constants shorten and the finish's
// launch hosts.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "stamps.cuh"
#include "torch_math.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 32;
constexpr int MAX_CELLS = 2 * LANES;  // cells a sample set holds at most
constexpr int MAX_GRID = 128;         // total_width^2 at most (11^2 = 121)
constexpr int DECODE_WARPS = 2;       // quads a block of decode_kernel
constexpr int DECODE_SLOTS = 6;       // a lane's samples: 2 cells of each of 3 sets
constexpr int STAGED_CODES = 4096;    // codes a decode block stages in shared memory
constexpr int POSE_THREADS = 128;
constexpr int CODE_BITS = 24;         // code index bits of a warp-min key
constexpr int REFINE_POINTS = 12;     // points an edge (ops/refine.py::_NSAMPLES)
constexpr int REFINE_THREADS = 4 * LANES;   // one warp an edge, one block a quad
// refine_kernel's blocks an SM keeps resident (64 registers a thread at
// most, where ptxas spills 24 bytes a thread): 1056 on an H100, one wave for
// the 1024 picked quads of a batch of 8 frames, where its 69 registers
// unbounded left 7 blocks an SM and a second wave (~6 us a call more).
// Sized for that launch; a batch of 9 or more frames takes a second wave.
constexpr int REFINE_BLOCKS_PER_SM = 8;
constexpr int REFINE_CHUNK = 24;      // profile samples a point staged at once (P <= 21 on the path)
constexpr int REFINE_ROUNDS = REFINE_POINTS * REFINE_CHUNK / LANES;   // samples a lane a chunk
constexpr int TAIL_THREADS = 128;     // a frame's quads at most (max_clusters <= 128)

// torch.argmax's order among the first i + 1 values: NaN is the largest,
// ties go to the lower index.
__device__ __forceinline__ bool beats(float v, float top) {
    return v > top || (is_nan(v) && !is_nan(top));
}

// utils/geometry.py::solve_pivoted for n = 8, fully unrolled so that A stays
// in registers: the row swap is a predicated exchange.
__device__ __forceinline__ void solve8(float (&A)[8][8], float (&b)[8], float (&x)[8]) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        int p = k;
        float top = fabsf(A[k][k]);
#pragma unroll
        for (int i = k + 1; i < 8; ++i) {
            const float a = fabsf(A[i][k]);
            if (a > top) {
                top = a;
                p = i;
            }
        }
#pragma unroll
        for (int i = k + 1; i < 8; ++i) {
            if (i == p) {
#pragma unroll
                for (int j = k; j < 8; ++j) {
                    const float t = A[k][j];
                    A[k][j] = A[i][j];
                    A[i][j] = t;
                }
                const float t = b[k];
                b[k] = b[i];
                b[i] = t;
            }
        }
#pragma unroll
        for (int i = k + 1; i < 8; ++i) {
            const float f = A[i][k] / A[k][k];
#pragma unroll
            for (int j = k + 1; j < 8; ++j) A[i][j] = A[i][j] - f * A[k][j];
            b[i] = b[i] - f * b[k];
        }
    }
#pragma unroll
    for (int j = 7; j >= 0; --j) {
        x[j] = b[j] / A[j][j];
#pragma unroll
        for (int i = 0; i < j; ++i) b[i] = b[i] - A[i][j] * x[j];
    }
}

// The part of a tag-plane homography's elimination that depends on the
// tag's half size alone (ops/cuda/pose.py::pose_constants, float32 on the
// host, as solve8 computes it): columns 0-5 of its system hold only the
// tag's corners (+-half, 0, 1), so at a size whose pivots there are the
// structural (0, 1, 2, 4, 5, 6) (rows u0, u1, u2, v0, v1, v2, then u3 and
// v3, in that order) their multipliers f (k < 6, i > k, k-major) and
// their reduced rows u (k <= j < 6, k-major) are the same for every tag.
struct PoseConsts {
    float f[27];
    float u[21];
};

// solve8 on a tag-plane homography's system, given PoseConsts: only the
// data columns 6 and 7 and b (rows in pivot order) are eliminated, by the
// host's multipliers (no division, no pivot search in columns 0-5), then
// column 6 pivots between rows 6 and 7 as solve8 does, and the back
// substitution reads columns 0-5 from u. Each float operation is the one
// solve8 makes on the same values, so x is solve8's to the bit.
__device__ __forceinline__ void solve8_fixed(const PoseConsts& pc, float (&c6)[8],
                                             float (&c7)[8], float (&b)[8], float (&x)[8]) {
    int m = 0;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
#pragma unroll
        for (int i = k + 1; i < 8; ++i) {
            const float f = pc.f[m++];
            c6[i] = c6[i] - f * c6[k];
            c7[i] = c7[i] - f * c7[k];
            b[i] = b[i] - f * b[k];
        }
    }
    if (fabsf(c6[7]) > fabsf(c6[6])) {
        float t = c6[6];
        c6[6] = c6[7];
        c6[7] = t;
        t = c7[6];
        c7[6] = c7[7];
        c7[7] = t;
        t = b[6];
        b[6] = b[7];
        b[7] = t;
    }
    {
        const float f = c6[7] / c6[6];
        c7[7] = c7[7] - f * c7[6];
        b[7] = b[7] - f * b[6];
    }
    x[7] = b[7] / c7[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) b[i] = b[i] - c7[i] * x[7];
    x[6] = b[6] / c6[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) b[i] = b[i] - c6[i] * x[6];
    // u's row k starts at entry k (11 - k) / 2 + k: rows of 6 - k entries.
#pragma unroll
    for (int j = 5; j >= 0; --j) {
        x[j] = b[j] / pc.u[j * (13 - j) / 2];
#pragma unroll
        for (int i = 0; i < j; ++i) b[i] = b[i] - pc.u[i * (13 - i) / 2 + (j - i)] * x[j];
    }
}

// utils/geometry.py::homography_from_correspondences: the 3x3 H (row-major)
// taking the src corners (sx, sy) to the dst corners (dx, dy). FIXED: the
// src corners are the tag's at the size of pc, solved by solve8_fixed.
template <bool FIXED = false>
__device__ __forceinline__ void homography(const float (&sx)[4], const float (&sy)[4],
                                           const float (&dx)[4], const float (&dy)[4],
                                           float (&Hm)[9], const PoseConsts* pc = nullptr) {
    const float cx = (((dx[0] + dx[1]) + dx[2]) + dx[3]) * 0.25f;
    const float cy = (((dy[0] + dy[1]) + dy[2]) + dy[3]) * 0.25f;
    float ex[4], ey[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        ex[k] = dx[k] - cx;
        ey[k] = dy[k] - cy;
    }
    float s = fabsf(ex[0]);
    s = s + fabsf(ey[0]);
#pragma unroll
    for (int k = 1; k < 4; ++k) {
        s = s + fabsf(ex[k]);
        s = s + fabsf(ey[k]);
    }
    s = clamp_min(s * 0.125f, 1e-6f);
    float h[8];
    if constexpr (FIXED) {
        // Rows in pivot order: u0, u1, u2, v0, v1, v2, u3, v3.
        float c6[8], c7[8], b[8];
        constexpr int corner[8] = {0, 1, 2, 0, 1, 2, 3, 3};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            const int k = corner[r];
            const bool v_row = (r >= 3 && r < 6) || r == 7;
            const float w = v_row ? ey[k] / s : ex[k] / s;
            c6[r] = -w * sx[k];
            c7[r] = -w * sy[k];
            b[r] = w;
        }
        solve8_fixed(*pc, c6, c7, b, h);
    } else {
        float A[8][8], b[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const float u = ex[k] / s, v = ey[k] / s;
            const float ru[8] = {sx[k], sy[k], 1.0f, 0.0f, 0.0f, 0.0f, -u * sx[k], -u * sy[k]};
            const float rv[8] = {0.0f, 0.0f, 0.0f, sx[k], sy[k], 1.0f, -v * sx[k], -v * sy[k]};
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                A[k][j] = ru[j];
                A[4 + k][j] = rv[j];
            }
            b[k] = u;
            b[4 + k] = v;
        }
        solve8(A, b, h);
    }
    const float Hn[9] = {h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7], 1.0f};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
        Hm[j] = Hn[j] * s + cx * Hn[6 + j];
        Hm[3 + j] = Hn[3 + j] * s + cy * Hn[6 + j];
        Hm[6 + j] = Hn[6 + j];
    }
}

// utils/geometry.py::inverse3x3 (adjugate / det), row-major.
__device__ __forceinline__ void inverse3x3(const float (&M)[9], float (&out)[9]) {
    const float a = M[0], b = M[1], c = M[2], d = M[3], e = M[4], f = M[5], g = M[6],
                h = M[7], i = M[8];
    const float adj[9] = {e * i - f * h, c * h - b * i, b * f - c * e,
                          f * g - d * i, a * i - c * g, c * d - a * f,
                          d * h - e * g, b * g - a * h, a * e - b * d};
    const float det = (a * adj[0] + b * adj[3]) + c * adj[6];
    const float inv_det = 1.0f / (fabsf(det) < 1e-20f ? 1e-20f : det);
#pragma unroll
    for (int k = 0; k < 9; ++k) out[k] = adj[k] * inv_det;
}

// ops/refine.py::bilinear_taps at (x, y) of one frame: clamp to [0, xmax] x
// [0, ymax], NaN to index 0, indices clamped to the frame (no lane reads
// outside it).
struct Taps {
    float v00, v01, v10, v11, fx, fy;
};

__device__ __forceinline__ Taps bilinear_taps(const float* __restrict__ img, int H, int W,
                                              float xmax, float ymax, float x, float y) {
    x = clamp_lo_hi(x, 0.0f, xmax);
    y = clamp_lo_hi(y, 0.0f, ymax);
    float x0f = floorf(x), y0f = floorf(y);
    if (is_nan(x0f)) x0f = 0.0f;
    if (is_nan(y0f)) y0f = 0.0f;
    const int x0 = clampi((int)x0f, 0, W - 1), y0 = clampi((int)y0f, 0, H - 1);
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    return {__ldg(img + (size_t)y0 * W + x0), __ldg(img + (size_t)y0 * W + x1),
            __ldg(img + (size_t)y1 * W + x0), __ldg(img + (size_t)y1 * W + x1), x - x0f,
            y - y0f};
}

// ops/decode.py's bilinear sample of one frame at H (u, v): apply_homography,
// then the taps (decode_taps issues the loads; decode_value uses them,
// associated as decode.py does).
__device__ __forceinline__ Taps decode_taps(const float* __restrict__ img, int H, int W,
                                            float xmax, float ymax, const float (&Hm)[9],
                                            float u, float v) {
    const float qx = (Hm[0] * u + Hm[1] * v) + Hm[2];
    const float qy = (Hm[3] * u + Hm[4] * v) + Hm[5];
    const float qw = (Hm[6] * u + Hm[7] * v) + Hm[8];
    return bilinear_taps(img, H, W, xmax, ymax, qx / qw, qy / qw);
}

__device__ __forceinline__ float decode_value(const Taps& t) {
    return t.v00 * (1.0f - t.fx) * (1.0f - t.fy) + t.v01 * t.fx * (1.0f - t.fy)
           + t.v10 * (1.0f - t.fx) * t.fy + t.v11 * t.fx * t.fy;
}

// ops/refine.py::_bilinear: the taps at (x, y), associated as refine.py does.
__device__ __forceinline__ float refine_sample(const float* __restrict__ img, int H, int W,
                                               float xmax, float ymax, float x, float y) {
    const Taps t = bilinear_taps(img, H, W, xmax, ymax, x, y);
    return (t.v00 * (1.0f - t.fx) + t.v01 * t.fx) * (1.0f - t.fy)
           + (t.v10 * (1.0f - t.fx) + t.v11 * t.fx) * t.fy;
}

// ops/decode.py::_warp_sum of a set whose cells lane and lane + 32 hold lo
// and hi (0 past the set): every lane gets the sum.
__device__ __forceinline__ float warp_sum(float lo, float hi) {
    float s = lo + hi;
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) s = s + __shfl_xor_sync(FULL, s, off);
    return s;
}

// 8 bytes from global to shared memory without registers (cp.async).
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
    const unsigned at = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(at), "l"(gmem));
}

// One warp a quad, DECODE_WARPS quads a block. The block first stages the
// codebook (its first STAGED_CODES codes) in shared memory by cp.async, which
// runs under the rest. Lane l's samples are cells l and l + 32 of the border
// ring, the outer ring and the bits (slot s: set s / 2, cell l + 32 (s % 2)):
// all their taps are issued in one round once H is known (an idle slot loads
// the quad's center), then the sums and thresholds run on registers.
__global__ void __launch_bounds__(DECODE_WARPS * LANES)
decode_kernel(const float* __restrict__ gray, const float* __restrict__ corners,
              const float* __restrict__ ftab, const int* __restrict__ itab,
              const long long* __restrict__ codes, bool* __restrict__ valid_out,
              int* __restrict__ id_out, int* __restrict__ ham_out,
              float* __restrict__ margin_out, int* __restrict__ rot_out,
              float* __restrict__ corners_out, int B, int C, int H, int W, int nb, int no,
              int nbits, int tw, int ncodes, int max_hamming, int sharpen_on,
              float sharpen) {
    extern __shared__ unsigned long long dsm[];     // the staged codes, then the warps' grids
    const int staged = min(ncodes, STAGED_CODES);
    unsigned long long* s_codes = dsm;
    for (int j = threadIdx.x; j < staged; j += blockDim.x) cp_async8(s_codes + j, codes + j);
    asm volatile("cp.async.commit_group;\n" ::);
    STAMP(0, staged);

    const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
    // A warp past the last quad decodes the last one again and stores
    // nothing, so every thread reaches the block's one barrier.
    const long long n_quads = (long long)B * C;
    const long long q_at = (long long)blockIdx.x * DECODE_WARPS + warp;
    const bool live = q_at < n_quads;
    const long long q = live ? q_at : n_quads - 1;
    const float* img = gray + (size_t)(q / C) * H * W;
    const float* cq = corners + q * 8;
    float dx[4], dy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        dx[k] = cq[2 * k];
        dy[k] = cq[2 * k + 1];
    }

    // The family's tables (ops/decode.py::_tables), read before H is known.
    const float* uv_set[3] = {ftab, ftab + 2 * nb, ftab + 2 * (nb + no)};
    const int n_set[3] = {nb, no, nbits};
    const float* minv_in = ftab + 2 * (nb + no + nbits);
    const float* minv_out = minv_in + 9;
    const int* lin = itab;
    const int* perms = itab + nbits;
    float su[DECODE_SLOTS], sv[DECODE_SLOTS];
#pragma unroll
    for (int s = 0; s < DECODE_SLOTS; ++s) {
        const int i = lane + (s & 1) * LANES;
        const bool in = i < n_set[s >> 1];
        su[s] = in ? __ldg(uv_set[s >> 1] + 2 * i) : 0.0f;
        sv[s] = in ? __ldg(uv_set[s >> 1] + 2 * i + 1) : 0.0f;
    }
    float mi[9], mo[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
        mi[k] = __ldg(minv_in + k);
        mo[k] = __ldg(minv_out + k);
    }
    int gl[2], pr[4][2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int i = lane + s * LANES;
        gl[s] = i < nbits ? __ldg(lin + i) : 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) pr[r][s] = i < nbits ? __ldg(perms + r * nbits + i) : 0;
    }

    const float sx[4] = {-1.0f, 1.0f, 1.0f, -1.0f}, sy[4] = {-1.0f, -1.0f, 1.0f, 1.0f};
    float Hm[9];
    homography(sx, sy, dx, dy, Hm);
    STAMP(1, Hm[0]);

    // One round of tap loads: every slot's four taps, then their values.
    // torch.clamp's bound W - 1.001, a double rounded to float.
    const float xmax = (float)((double)W - 1.001), ymax = (float)((double)H - 1.001);
    Taps tp[DECODE_SLOTS];
#pragma unroll
    for (int s = 0; s < DECODE_SLOTS; ++s)
        tp[s] = decode_taps(img, H, W, xmax, ymax, Hm, su[s], sv[s]);
    float val[DECODE_SLOTS];
#pragma unroll
    for (int s = 0; s < DECODE_SLOTS; ++s)
        val[s] = lane + (s & 1) * LANES < n_set[s >> 1] ? decode_value(tp[s]) : 0.0f;
    STAMP(2, val[0] + val[5]);

    // ops/decode.py::_fit_gray_model of the border (slots 0-1) and outer
    // (slots 2-3) rings: the sums of val, u val and v val, then minv.
    float m_in[3], m_out[3];
#pragma unroll
    for (int g = 0; g < 2; ++g) {
        const float atb[3] = {warp_sum(val[2 * g], val[2 * g + 1]),
                              warp_sum(su[2 * g] * val[2 * g], su[2 * g + 1] * val[2 * g + 1]),
                              warp_sum(sv[2 * g] * val[2 * g], sv[2 * g + 1] * val[2 * g + 1])};
        const float* minv = g ? mo : mi;
        float* m = g ? m_out : m_in;
#pragma unroll
        for (int i = 0; i < 3; ++i)
            m[i] = (minv[3 * i] * atb[0] + minv[3 * i + 1] * atb[1]) + minv[3 * i + 2] * atb[2];
    }

    // Lane l holds bits l and l + 32 (slots 4-5): their samples and thresholds.
    float vb[2], th[2] = {0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        vb[s] = val[4 + s];
        if (lane + s * LANES < nbits) {
            const float u = su[4 + s], v = sv[4 + s];
            th[s] = 0.5f * (((m_in[0] + m_in[1] * u) + m_in[2] * v)
                            + ((m_out[0] + m_out[1] * u) + m_out[2] * v));
        }
    }
    if (sharpen_on) {
        float* g = reinterpret_cast<float*>(dsm + staged) + warp * MAX_GRID;
        for (int i = lane; i < tw * tw; i += LANES) g[i] = 0.0f;
        __syncwarp();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            if (lane + s * LANES < nbits) g[gl[s]] = vb[s];
        }
        __syncwarp();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            if (lane + s * LANES < nbits) {
                const int gi = gl[s], gy = gi / tw, gx = gi % tw;
                const float c = g[gi];
                const float up = g[((gy + tw - 1) % tw) * tw + gx];
                const float down = g[((gy + 1) % tw) * tw + gx];
                const float left = g[gy * tw + (gx + tw - 1) % tw];
                const float right = g[gy * tw + (gx + 1) % tw];
                const float lap = (((4.0f * c - up) - down) - left) - right;
                vb[s] = c + sharpen * lap;
            }
        }
    }

    // Bits, and the margin: the worse of the white and black class means.
    bool bit[2];
    float wt[2], bt[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const bool in = lane + s * LANES < nbits;
        const float dev = vb[s] - th[s];
        bit[s] = in && dev > 0.0f;
        const float wm = bit[s] ? 1.0f : 0.0f;
        wt[s] = in ? dev * wm : 0.0f;
        bt[s] = in ? -dev * (1.0f - wm) : 0.0f;
    }
    const float wsum = warp_sum(wt[0], wt[1]);
    const float bsum = warp_sum(bt[0], bt[1]);
    const unsigned lo = __ballot_sync(FULL, bit[0]), hi = __ballot_sync(FULL, bit[1]);
    const int wc = __popc(lo) + __popc(hi), bc = nbits - wc;
    const float wmean = wc > 0 ? wsum / (float)wc : INFINITY;
    const float bmean = bc > 0 ? bsum / (float)bc : INFINITY;
    const float margin = is_nan(wmean) ? wmean : is_nan(bmean) ? bmean
                         : (bmean < wmean ? bmean : wmean);

    // Each rotation's code: bit i of the ballot is position i of the word,
    // whose weight is 2^(nbits - 1 - i).
    const unsigned long long mask = (unsigned long long)lo | ((unsigned long long)hi << 32);
    unsigned long long code[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const bool plo = lane < nbits && ((mask >> pr[r][0]) & 1ull);
        const bool phi = lane + LANES < nbits && ((mask >> pr[r][1]) & 1ull);
        const unsigned long long m = (unsigned long long)__ballot_sync(FULL, plo)
                                     | ((unsigned long long)__ballot_sync(FULL, phi) << 32);
        code[r] = __brevll(m) >> (64 - nbits);
    }
    // First minimum over the codes (torch.argmin), per rotation; the staged
    // codes from shared memory, any past them from global memory.
    STAMP(3, (unsigned)code[0] ^ (unsigned)code[3]);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    STAMP(4, staged);
    unsigned key[4] = {~0u, ~0u, ~0u, ~0u};
#pragma unroll 4
    for (int j = lane; j < ncodes; j += LANES) {
        const unsigned long long cw =
            j < staged ? s_codes[j] : (unsigned long long)__ldg(codes + j);
#pragma unroll
        for (int r = 0; r < 4; ++r)
            key[r] = min(key[r], ((unsigned)__popcll(code[r] ^ cw) << CODE_BITS) | (unsigned)j);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) key[r] = __reduce_min_sync(FULL, key[r]);
    STAMP(5, key[0] ^ key[3]);
    // First minimum over the rotations.
    int best = 0;
    unsigned best_key = key[0];
#pragma unroll
    for (int r = 1; r < 4; ++r) {
        if ((key[r] >> CODE_BITS) < (best_key >> CODE_BITS)) {
            best = r;
            best_key = key[r];
        }
    }
    if (!live) return;
    const int ham = (int)(best_key >> CODE_BITS);
    if (lane == 0) {
        valid_out[q] = ham <= max_hamming;
        id_out[q] = (int)(best_key & ((1u << CODE_BITS) - 1));
        ham_out[q] = ham;
        margin_out[q] = margin;
        rot_out[q] = best;
    }
    // Rotation-corrected corners: corner k is input corner (k + 2 - best) mod 4.
    if (lane < 8) {
        const int k = lane >> 1, roll = (6 - best) & 3;
        corners_out[q * 8 + lane] = cq[((k + roll) & 3) * 2 + (lane & 1)];
    }
    STAMP(6, best);
}

// ops/pose.py::estimate_poses of one tag: its corners (dx, dy), K^-1 and
// the tag's half size -> rotation X (row-major), translation t and
// quaternion q. The tag-plane homography (FIXED: by solve8_fixed with pc),
// M = K^-1 H, the scale and its sign, the cross product, 4 Newton polar
// steps and the quaternion; K^-1 comes in, so a caller computes it beside
// the homography (no dependence between them). STAMPED: thread 0 of a block
// stamps steps 2-6 (pose_kernel's split).
template <bool FIXED, bool STAMPED>
__device__ __forceinline__ void pose_one(const float (&dx)[4], const float (&dy)[4],
                                         const float (&Kinv)[9], float half,
                                         const PoseConsts& pc, float (&X)[9], float (&t)[3],
                                         float (&q)[4]) {
    // TAG_CORNERS * (tag_size / 2).
    const float sx[4] = {-1.0f * half, 1.0f * half, 1.0f * half, -1.0f * half};
    const float sy[4] = {-1.0f * half, -1.0f * half, 1.0f * half, 1.0f * half};
    float Hm[9];
    homography<FIXED>(sx, sy, dx, dy, Hm, &pc);
    if (STAMPED) STAMP(2, Hm[0] + Hm[8]);
    // M = K^-1 H (utils/geometry.py::matmul3).
    float M[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            M[3 * i + j] = (Kinv[3 * i] * Hm[j] + Kinv[3 * i + 1] * Hm[3 + j])
                           + Kinv[3 * i + 2] * Hm[6 + j];
    if (STAMPED) STAMP(3, M[0] + M[8]);
    const float n1 = sqrtf((M[0] * M[0] + M[3] * M[3]) + M[6] * M[6]);
    const float n2 = sqrtf((M[1] * M[1] + M[4] * M[4]) + M[7] * M[7]);
    float scale = (1.0f / clamp_min(n1 + n2, 1e-12f)) * 2.0f;
    const float z = M[8];
    scale = scale * ((z > 0.0f ? 1.0f : 0.0f) - (z < 0.0f ? 1.0f : 0.0f));   // positive depth
    const float r1[3] = {M[0] * scale, M[3] * scale, M[6] * scale};
    const float r2[3] = {M[1] * scale, M[4] * scale, M[7] * scale};
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = M[3 * k + 2] * scale;
    const float r3[3] = {r1[1] * r2[2] - r1[2] * r2[1], r1[2] * r2[0] - r1[0] * r2[2],
                         r1[0] * r2[1] - r1[1] * r2[0]};
    // Columns r1, r2, r3; then 4 Newton polar steps X <- (X + X^-T) / 2.
    const float X0[9] = {r1[0], r2[0], r3[0], r1[1], r2[1], r3[1], r1[2], r2[2], r3[2]};
#pragma unroll
    for (int k = 0; k < 9; ++k) X[k] = X0[k];
    if (STAMPED) STAMP(4, X[0] + X[8] + t[2]);
#pragma unroll
    for (int it = 0; it < 4; ++it) {
        float Xi[9];
        inverse3x3(X, Xi);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) X[3 * i + j] = 0.5f * (X[3 * i + j] + Xi[3 * j + i]);
    }
    if (STAMPED) STAMP(5, X[0] + X[8]);
    // utils/geometry.py::quat_from_rotmat.
    const float m00 = X[0], m01 = X[1], m02 = X[2], m10 = X[3], m11 = X[4], m12 = X[5],
                m20 = X[6], m21 = X[7], m22 = X[8];
    const float tr = (m00 + m11) + m22;
    const float piv[4] = {1.0f + tr, ((1.0f + m00) - m11) - m22, ((1.0f - m00) + m11) - m22,
                          ((1.0f - m00) - m11) + m22};
    const float cands[4][4] = {{piv[0], m21 - m12, m02 - m20, m10 - m01},
                               {m21 - m12, piv[1], m01 + m10, m02 + m20},
                               {m02 - m20, m01 + m10, piv[2], m12 + m21},
                               {m10 - m01, m02 + m20, m12 + m21, piv[3]}};
    int best = 0;
#pragma unroll
    for (int i = 1; i < 4; ++i)
        if (beats(piv[i], piv[best])) best = i;
    float qv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        float c = cands[0][k];
#pragma unroll
        for (int i = 1; i < 4; ++i) c = best == i ? cands[i][k] : c;
        qv[k] = c;
    }
    const float norm = sqrtf(((qv[0] * qv[0] + qv[1] * qv[1]) + qv[2] * qv[2]) + qv[3] * qv[3]);
#pragma unroll
    for (int k = 0; k < 4; ++k) qv[k] = qv[k] / norm;
    int lead = 0;
#pragma unroll
    for (int i = 1; i < 4; ++i)
        if (beats(fabsf(qv[i]), fabsf(qv[lead]))) lead = i;
    float lv = qv[0];
#pragma unroll
    for (int i = 1; i < 4; ++i) lv = lead == i ? qv[i] : lv;
    const float sign = lv < 0.0f ? -1.0f : 1.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = qv[k] * sign;
    if (STAMPED) STAMP(6, q[0]);
}

// A tag's outputs at slot n.
__device__ __forceinline__ void pose_store(size_t n, const float (&X)[9], const float (&t)[3],
                                           const float (&q)[4], float* __restrict__ rot_out,
                                           float* __restrict__ t_out, float* __restrict__ q_out) {
#pragma unroll
    for (int k = 0; k < 9; ++k) rot_out[n * 9 + k] = X[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t_out[n * 3 + k] = t[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) q_out[n * 4 + k] = q[k];
}

// One thread a tag: its corners (two float4 loads where the row is 16-byte
// aligned) and K in one round, K^-1 beside the homography, then pose_one.
template <bool FIXED>
__global__ void __launch_bounds__(POSE_THREADS)
pose_kernel(const float* __restrict__ corners, const float* __restrict__ K,
            float* __restrict__ rot_out, float* __restrict__ t_out, float* __restrict__ q_out,
            int N, int per_frame, int k_batched, float half, const PoseConsts pc) {
    const int n = blockIdx.x * POSE_THREADS + threadIdx.x;
    STAMP(0, n);
    if (n >= N) return;
    const float* cq = corners + (size_t)n * 8;
    const float* Kp = K + (k_batched ? (size_t)(n / per_frame) * 9 : 0);
    float c[8], Km[9];
    if ((reinterpret_cast<uintptr_t>(corners) & 15) == 0) {
        const float4 lo = reinterpret_cast<const float4*>(cq)[0];
        const float4 hi = reinterpret_cast<const float4*>(cq)[1];
        c[0] = lo.x; c[1] = lo.y; c[2] = lo.z; c[3] = lo.w;
        c[4] = hi.x; c[5] = hi.y; c[6] = hi.z; c[7] = hi.w;
    } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) c[k] = cq[k];
    }
#pragma unroll
    for (int k = 0; k < 9; ++k) Km[k] = Kp[k];
    const float dx[4] = {c[0], c[2], c[4], c[6]}, dy[4] = {c[1], c[3], c[5], c[7]};
    STAMP(1, dx[0] + dy[3] + Km[0] + Km[8]);
    float Kinv[9], X[9], t[3], q[4];
    inverse3x3(Km, Kinv);
    pose_one<FIXED, true>(dx, dy, Kinv, half, pc, X, t, q);
    pose_store(n, X, t, q, rot_out, t_out, q_out);
    STAMP(7, n);
}

// Whether (u at i) comes before (v at j) in torch.sort(descending=True,
// stable=True): NaN first, then the larger value, ties to the lower index.
__device__ __forceinline__ bool precedes(float u, int i, float v, int j) {
    const bool un = is_nan(u), vn = is_nan(v);
    if (un || vn) return un && (!vn || i < j);
    return u > v || (u == v && i < j);
}

// ops/tail.py::_edge_lengths and _sum4: the four edges' lengths (edge k
// from corner k - 1 to corner k) of corners c, summed in index order.
__device__ __forceinline__ float edge_sum(const float (&c)[8]) {
    float n[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int j = (k + 3) & 3;
        const float ex = c[2 * k] - c[2 * j], ey = c[2 * k + 1] - c[2 * j + 1];
        n[k] = sqrtf(ex * ex + ey * ey);
    }
    return ((n[0] + n[1]) + n[2]) + n[3];
}

// The top-2T pick's inputs and outputs past the quads' corners and dark
// sides: (B, C) valid and fit_err; (B, K) pre_valid and (B,) num_quads out.
struct Pick {
    const bool* __restrict__ valid;
    const float* __restrict__ fit_err;
    bool* __restrict__ pre_valid;
    int* __restrict__ num_quads;
    int K;
    int want_dark;
    int decimate;
};

// A frame's quads as one block of TAIL_THREADS takes them, thread i quad i
// (i < C), for the top-2T pick: the corners, dark side, polarity gate and
// perimeter score (-inf where not valid), all loads in one round; the
// scores and the ballot masks of the quads scored above -inf (NaN among
// them) in shared memory; the frame's count of valid quads.
struct PickedQuad {
    float c[8];
    bool dark;
    float score;
    int n_valid;
};

__device__ __forceinline__ PickedQuad score_quad(const float* __restrict__ corners,
                                                 const bool* __restrict__ dark, const Pick& pk,
                                                 int b, int C, float* s_score,
                                                 unsigned* s_ranked) {
    const int i = threadIdx.x;
    const bool in = i < C;
    const size_t q = (size_t)b * C + i;
    PickedQuad p;
    bool qvalid = false;
    p.dark = false;
    p.score = -INFINITY;
    if (in) {
#pragma unroll
        for (int k = 0; k < 8; ++k) p.c[k] = corners[q * 8 + k];
        p.dark = dark[q];
        const bool v = pk.valid[q];
        const float fe = pk.fit_err[q];
        qvalid = v && p.dark == (pk.want_dark != 0);
        p.score = qvalid ? edge_sum(p.c) / (1.0f + fe) : -INFINITY;
        s_score[i] = p.score;
    }
    const unsigned m = __ballot_sync(FULL, in && !(p.score == -INFINITY));
    if ((i & 31) == 0) s_ranked[i >> 5] = m;
    p.n_valid = __syncthreads_count(qvalid);
    return p;
}

// Quad i's rank (score s, i < C) in precedes' order among its frame's
// quads, from score_quad's shared scores and masks: a quad scored above
// -inf compares with the set bits of the masks only (a bench frame's valid
// quads, not C); a -inf quad's rank is their count plus the -inf quads
// below it (they tie, and ties go to the lower index).
__device__ __forceinline__ int select_rank(const float* s_score, const unsigned* s_ranked, int i,
                                           float s) {
    constexpr int MASKS = TAIL_THREADS / LANES;
    const int lane = i & 31, w = i >> 5;
    if (s == -INFINITY) {
        int above = 0, below = 0;
#pragma unroll
        for (int u = 0; u < MASKS; ++u) {
            const unsigned r = s_ranked[u];
            above += __popc(r);
            below += u < w ? __popc(r) : u == w ? __popc(r & ((1u << lane) - 1u)) : 0;
        }
        return above + i - below;
    }
    int rank = 0;
    for (int u = 0; u < MASKS; ++u) {
        for (unsigned bits = s_ranked[u]; bits; bits &= bits - 1) {
            const int j = u * LANES + __ffs(bits) - 1;
            rank += precedes(s_score[j], j, s, i);
        }
    }
    return rank;
}

// The corners of quad p upscaled from the decimated image to full
// resolution (ops/tail.py::upscale_coords).
__device__ __forceinline__ float upscale(float x, int decimate) {
    return decimate == 1 ? x : x * (float)decimate + 0.5f * (float)(decimate - 1);
}

// ops/refine.py::_point_sum of an edge's point terms, held by lanes 0-11 of
// the half warp (0 in lanes 12-15): the halves added pairwise; every lane of
// the half warp gets the sum.
__device__ __forceinline__ float point_sum(float v) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v = v + __shfl_xor_sync(FULL, v, off);
    return v;
}

// One block a picked quad: block q refines its frame's candidate of rank
// q % K in the top-2T pick, which the block makes first: thread i scores
// quad i of the C (score_quad, all loads in one round) and ranks it
// (select_rank); the thread of rank q % K publishes the quad's upscaled
// corners and dark side in shared memory and writes its pre_valid, and the
// frame's block of rank 0 writes num_quads.
__global__ void __launch_bounds__(REFINE_THREADS, REFINE_BLOCKS_PER_SM)
refine_kernel(const float* __restrict__ gray, const float* __restrict__ corners,
              const bool* __restrict__ dark_inside, float* __restrict__ out, int C, int H, int W,
              int P, float first, float limit, const Pick pk) {
    static_assert(REFINE_THREADS == TAIL_THREADS, "a thread a quad of the frame");
    __shared__ float s_line[4][4];       // edge k: its point (x, y) and direction (x, y)
    // Edge k's staged samples, a point's row padded to an odd stride (no bank conflict).
    __shared__ float s_prof[4][REFINE_POINTS][REFINE_CHUNK + 1];
    __shared__ float s_quad[8];          // the candidate's corners
    __shared__ bool s_dark;              // its dark side
    __shared__ float s_score[TAIL_THREADS];
    __shared__ unsigned s_ranked[TAIL_THREADS / LANES];
    const int k = threadIdx.x / LANES, lane = threadIdx.x % LANES;
    const long long q = blockIdx.x;
    const long long frame = q / pk.K;
    {
        const int r = (int)(q - frame * pk.K), i = threadIdx.x;
        const PickedQuad p = score_quad(corners, dark_inside, pk, (int)frame, C, s_score,
                                        s_ranked);
        if (r == 0 && i == 0) pk.num_quads[frame] = p.n_valid;
        if (i < C && select_rank(s_score, s_ranked, i, p.score) == r) {
#pragma unroll
            for (int j = 0; j < 8; ++j) s_quad[j] = upscale(p.c[j], pk.decimate);
            s_dark = p.dark;
            pk.pre_valid[q] = is_finite(p.score);
        }
        __syncthreads();
    }
    const float* cq = s_quad;
    const bool dark = s_dark;
    const float* img = gray + (size_t)frame * H * W;
    const float cx = (((cq[0] + cq[2]) + cq[4]) + cq[6]) * 0.25f;
    const float cy = (((cq[1] + cq[3]) + cq[5]) + cq[7]) * 0.25f;
    // Edge k, from corner k to corner k + 1, its unit direction and its
    // normal, turned toward the centroid.
    const float x0 = cq[2 * k], y0 = cq[2 * k + 1];
    const float x1 = cq[2 * ((k + 1) & 3)], y1 = cq[2 * ((k + 1) & 3) + 1];
    const float ex = x1 - x0, ey = y1 - y0;
    const float den = clamp_min(sqrtf(ex * ex + ey * ey), 1e-6f);
    const float ux = ex / den, uy = ey / den;
    const float mx = 0.5f * (x0 + x1), my = 0.5f * (y0 + y1);
    float nx = uy, ny = -ux;
    if (!(nx * (cx - mx) + ny * (cy - my) >= 0.0f)) {
        nx = -nx;
        ny = -ny;
    }
    // torch.clamp's bound W - 1.001, a double rounded to float.
    const float xmax = (float)((double)W - 1.001), ymax = (float)((double)H - 1.001);

    // Point s of the edge: its place, and lane s < 12's gradient weights and
    // offset, streamed over its profile of P samples along the normal
    // through a ring of five (the gradient pairs samples j and j - 4 at the
    // offset of j - 2), in chunks of up to REFINE_CHUNK samples a point.
    const bool point = lane < REFINE_POINTS;
    const float alpha = (float)(lane + 1) / (float)(REFINE_POINTS + 1);
    const float px = point ? x0 + alpha * ex : 0.0f, py = point ? y0 + alpha * ey : 0.0f;
    float wsum = 0.0f, num = 0.0f;
    float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f, r3 = 0.0f;
    float (*prof)[REFINE_CHUNK + 1] = s_prof[k];
    for (int j0 = 0; j0 < P; j0 += REFINE_CHUNK) {
        // The chunk's len samples of each of the 12 points, sample j of
        // point s at i = 12 j + s, spread over the warp's lanes: every tap
        // load issued before any sample is used.
        const int len = min(REFINE_CHUNK, P - j0);
        const int total = REFINE_POINTS * len;
        float v[REFINE_ROUNDS] = {};
#pragma unroll
        for (int r = 0; r < REFINE_ROUNDS; ++r) {
            const int i = lane + LANES * r, s = i % REFINE_POINTS;
            // Point s's place on the edge, from lane s.
            const float sx = __shfl_sync(FULL, px, s), sy = __shfl_sync(FULL, py, s);
            if (i < total) {
                const float off = first + 0.5f * (float)(j0 + i / REFINE_POINTS);
                v[r] = refine_sample(img, H, W, xmax, ymax, sx + off * nx, sy + off * ny);
            }
        }
#pragma unroll
        for (int r = 0; r < REFINE_ROUNDS; ++r) {
            const int i = lane + LANES * r;
            if (i < total) prof[i % REFINE_POINTS][i / REFINE_POINTS] = v[r];
        }
        __syncwarp();
        if (point) {
#pragma unroll
            for (int jj = 0; jj < REFINE_CHUNK; ++jj) {
                if (jj < len) {
                    const int j = j0 + jj;
                    const float u = prof[lane][jj];
                    if (j >= 4) {
                        const float diff = dark ? r0 - u : u - r0;
                        const float w = diff > 0.0f ? diff * diff : 0.0f;
                        wsum = wsum + w;
                        num = num + w * (first + 0.5f * (float)(j - 2));
                    }
                    r0 = r1;
                    r1 = r2;
                    r2 = r3;
                    r3 = u;
                }
            }
        }
        __syncwarp();
    }
    const float n0 = num / clamp_min(wsum, 1e-9f);
    const bool ok = point && wsum > 1e-3f;
    const float qx = px + n0 * nx, qy = py + n0 * ny;

    // The edge's weighted line fit over its points (half-warp sums).
    const float sw = ok ? wsum : 0.0f;
    const float tot = clamp_min(point_sum(sw), 1e-9f);
    const float mean_x = point_sum(point ? qx * sw : 0.0f) / tot;
    const float mean_y = point_sum(point ? qy * sw : 0.0f) / tot;
    const float dx = qx - mean_x, dy = qy - mean_y;
    const float cxx = point_sum(point ? (sw * dx) * dx : 0.0f);
    const float cxy = point_sum(point ? (sw * dx) * dy : 0.0f);
    const float cyy = point_sum(point ? (sw * dy) * dy : 0.0f);
    const int n_ok = __popc(__ballot_sync(FULL, ok));
    const float dd = cxx - cyy;
    const float disc = sqrtf(clamp_min(dd * dd + (4.0f * cxy) * cxy, 0.0f));
    const float lam = 0.5f * ((cxx + cyy) + disc);
    const float v1x = cxy, v1y = lam - cxx, v2x = lam - cyy, v2y = cxy;
    const bool pick = v1x * v1x + v1y * v1y > v2x * v2x + v2y * v2y;
    const float vx = pick ? v1x : v2x, vy = pick ? v1y : v2y;
    const float vn = clamp_min(sqrtf(vx * vx + vy * vy), 1e-9f);
    const bool good = n_ok >= REFINE_POINTS / 2 && lam > 1e-9f;
    if (lane == 0) {
        s_line[k][0] = good ? mean_x : mx;
        s_line[k][1] = good ? mean_y : my;
        s_line[k][2] = good ? vx / vn : ux;
        s_line[k][3] = good ? vy / vn : uy;
    }
    __syncthreads();
    // Corner k: edges k - 1 and k intersected, kept if finite and near.
    if (lane == 0) {
        const int j = (k + 3) & 3;
        float x, y;
        intersect(s_line[j][0], s_line[j][1], s_line[j][2], s_line[j][3], s_line[k][0],
                  s_line[k][1], s_line[k][2], s_line[k][3], x, y);
        const float mvx = x - x0, mvy = y - y0;
        const bool keep = is_finite(x) && is_finite(y) && sqrtf(mvx * mvx + mvy * mvy) < limit;
        out[q * 8 + 2 * k] = keep ? x : x0;
        out[q * 8 + 2 * k + 1] = keep ? y : y0;
    }
}

// finish_pose_kernel's pose: K ((3, 3), or one a frame with k_batched),
// the outputs, and the tag's half size.
struct FinishPose {
    const float* __restrict__ K;
    float* __restrict__ rot;
    float* __restrict__ t;
    float* __restrict__ q;
    int k_batched;
    float half;
    PoseConsts pc;
};

// One block a frame, thread j candidate j (N <= TAIL_THREADS). The valid
// candidates are the set bits of four warp ballots in shared memory, and
// both the dedupe and the rank walk set bits only: a bench frame holds a
// handful of valid candidates among its 2T. A score is -inf or a valid
// margin (>= min_margin, so never NaN), so a -inf candidate's rank in
// torch.sort(descending, stable) order is the count of scores above -inf
// plus the -inf candidates below it, and only the others compare. POSE
// (finish_pose_kernel): each top-T slot's thread then poses the tag it has
// just written (pose_one on its corners, with K^-1 of the frame's K,
// computed while the candidates load), so pose takes no launch of its own.
template <bool POSE, bool FIXED>
__device__ __forceinline__ void finish_block(
    const bool* __restrict__ dec_valid, const int* __restrict__ id,
    const int* __restrict__ hamming, const float* __restrict__ margin,
    const float* __restrict__ corners, const bool* __restrict__ pre_valid,
    const int* __restrict__ num_quads, const bool* __restrict__ overflow_in,
    bool* __restrict__ valid_out, int* __restrict__ id_out, int* __restrict__ ham_out,
    float* __restrict__ margin_out, float* __restrict__ center_out,
    float* __restrict__ corners_out, int* __restrict__ num_det, bool* __restrict__ overflow_out,
    int N, int K, float min_margin, const FinishPose& fp) {
    constexpr int MASKS = TAIL_THREADS / LANES;
    __shared__ float s_cx[TAIL_THREADS], s_cy[TAIL_THREADS], s_edge[TAIL_THREADS];
    __shared__ float s_margin[TAIL_THREADS];
    __shared__ int s_id[TAIL_THREADS];
    __shared__ unsigned s_valid[MASKS], s_ranked[MASKS];   // valid; valid with a score above -inf
    const int b = blockIdx.x, j = threadIdx.x, lane = j & 31, w = j >> 5;
    STAMP(0, j);
    const bool in = j < N;
    const size_t q = (size_t)b * N + j;
    float Kinv[9];
    if constexpr (POSE) {
        const float* Kp = fp.K + (fp.k_batched ? (size_t)b * 9 : 0);
        float Km[9];
#pragma unroll
        for (int k = 0; k < 9; ++k) Km[k] = Kp[k];
        inverse3x3(Km, Kinv);
    }
    float c[8], m = 0.0f, cx = 0.0f, cy = 0.0f;
    int my_id = 0;
    bool v = false;
    if (in) {
#pragma unroll
        for (int k = 0; k < 8; ++k) c[k] = corners[q * 8 + k];
        m = margin[q];
        my_id = id[q];
        v = pre_valid[q] && dec_valid[q] && m >= min_margin;
        cx = (((c[0] + c[2]) + c[4]) + c[6]) * 0.25f;
        cy = (((c[1] + c[3]) + c[5]) + c[7]) * 0.25f;
        s_cx[j] = cx;
        s_cy[j] = cy;
        s_edge[j] = edge_sum(c) * 0.25f;
        s_margin[j] = m;
        s_id[j] = my_id;
    }
    const unsigned vm = __ballot_sync(FULL, v);
    if (lane == 0) s_valid[w] = vm;
    __syncthreads();
    STAMP(1, s_valid[0]);
    // ops/tail.py::finish_detections' dedupe: a better valid candidate i of
    // the same id near j suppresses j (torch.maximum passes NaN).
    if (v) {
        const float ej = s_edge[j];
        for (int u = 0; u < MASKS && v; ++u) {
            for (unsigned bits = s_valid[u]; bits; bits &= bits - 1) {
                const int i = u * LANES + __ffs(bits) - 1;
                if (s_id[i] != my_id) continue;
                const float mi = s_margin[i];
                if (!(mi > m || (mi == m && i < j))) continue;
                const float dx = s_cx[i] - cx, dy = s_cy[i] - cy, ei = s_edge[i];
                const float reach = is_nan(ei) || is_nan(ej) ? ei + ej : (ei > ej ? ei : ej);
                if (sqrtf(dx * dx + dy * dy) < 0.75f * reach) {
                    v = false;
                    break;
                }
            }
        }
    }
    const float score = v ? m : -INFINITY;
    const bool ranked = score > -INFINITY;
    const unsigned rm = __ballot_sync(FULL, ranked);
    if (lane == 0) s_ranked[w] = rm;
    __syncthreads();
    STAMP(2, s_ranked[0]);
    // The rank in select_rank's order (precedes), no score being NaN.
    int rank = N;
    if (in) {
        int above = 0, below = 0;                // ranked candidates in all, below j
#pragma unroll
        for (int u = 0; u < MASKS; ++u) {
            const unsigned r = s_ranked[u];
            above += __popc(r);
            below += u < w ? __popc(r) : u == w ? __popc(r & ((1u << lane) - 1u)) : 0;
        }
        if (!ranked) {
            rank = above + j - below;
        } else {
            rank = 0;
            for (int u = 0; u < MASKS; ++u) {
                for (unsigned bits = s_ranked[u]; bits; bits &= bits - 1) {
                    const int i = u * LANES + __ffs(bits) - 1;
                    const float si = s_margin[i];
                    rank += si > score || (si == score && i < j);
                }
            }
        }
    }
    const bool fin = is_finite(score);
    const int n = __syncthreads_count(rank < K && fin);
    STAMP(3, n);
    if (j == 0) {
        num_det[b] = n;
        overflow_out[b] = overflow_in[b] || num_quads[b] > N;
    }
    if (rank < K) {
        const size_t o = (size_t)b * K + rank;
        valid_out[o] = fin;
        id_out[o] = fin ? my_id : -1;
        ham_out[o] = hamming[q];
        margin_out[o] = m;
#pragma unroll
        for (int k = 0; k < 8; ++k) corners_out[o * 8 + k] = c[k];
        float x, y;
        intersect(c[0], c[1], c[4] - c[0], c[5] - c[1], c[2], c[3], c[6] - c[2], c[7] - c[3], x,
                  y);
        center_out[o * 2] = x;
        center_out[o * 2 + 1] = y;
        if constexpr (POSE) {
            const float dx[4] = {c[0], c[2], c[4], c[6]}, dy[4] = {c[1], c[3], c[5], c[7]};
            float X[9], t[3], qv[4];
            pose_one<FIXED, false>(dx, dy, Kinv, fp.half, fp.pc, X, t, qv);
            pose_store(o, X, t, qv, fp.rot, fp.t, fp.q);
        }
    }
    STAMP(4, n);
    if constexpr (POSE) {
#ifdef KERNEL_STAMPS
        __syncthreads();                    // stamped builds: the block's last pose
#endif
        STAMP(5, n);
    }
}

__global__ void __launch_bounds__(TAIL_THREADS)
tail_finish_kernel(const bool* __restrict__ dec_valid, const int* __restrict__ id,
                   const int* __restrict__ hamming, const float* __restrict__ margin,
                   const float* __restrict__ corners, const bool* __restrict__ pre_valid,
                   const int* __restrict__ num_quads, const bool* __restrict__ overflow_in,
                   bool* __restrict__ valid_out, int* __restrict__ id_out,
                   int* __restrict__ ham_out, float* __restrict__ margin_out,
                   float* __restrict__ center_out, float* __restrict__ corners_out,
                   int* __restrict__ num_det, bool* __restrict__ overflow_out, int N, int K,
                   float min_margin) {
    finish_block<false, false>(dec_valid, id, hamming, margin, corners, pre_valid, num_quads,
                               overflow_in, valid_out, id_out, ham_out, margin_out, center_out,
                               corners_out, num_det, overflow_out, N, K, min_margin,
                               FinishPose{});
}

// The finish and the pose of its top-T tags in one launch (detector.py's
// detect path with pose).
template <bool FIXED>
__global__ void __launch_bounds__(TAIL_THREADS)
finish_pose_kernel(const bool* __restrict__ dec_valid, const int* __restrict__ id,
                   const int* __restrict__ hamming, const float* __restrict__ margin,
                   const float* __restrict__ corners, const bool* __restrict__ pre_valid,
                   const int* __restrict__ num_quads, const bool* __restrict__ overflow_in,
                   bool* __restrict__ valid_out, int* __restrict__ id_out,
                   int* __restrict__ ham_out, float* __restrict__ margin_out,
                   float* __restrict__ center_out, float* __restrict__ corners_out,
                   int* __restrict__ num_det, bool* __restrict__ overflow_out, int N, int K,
                   float min_margin, const FinishPose fp) {
    finish_block<true, FIXED>(dec_valid, id, hamming, margin, corners, pre_valid, num_quads,
                            overflow_in, valid_out, id_out, ham_out, margin_out, center_out,
                            corners_out, num_det, overflow_out, N, K, min_margin, fp);
}

}  // namespace

extern "C" int apriltag_decode(const void* gray, const void* corners, const void* ftab,
                               const void* itab, const void* codes, void* valid, void* id,
                               void* hamming, void* margin, void* rotation, void* corners_out,
                               int B, int C, int H, int W, int nb, int no, int nbits, int tw,
                               int ncodes, int max_hamming, int sharpen_on, int sharpen_bits,
                               void* stream) {
    const long long quads = (long long)B * C;
    if (quads < 1 || H < 1 || W < 1 || nb > MAX_CELLS || no > MAX_CELLS || nbits < 1
        || nbits > MAX_CELLS || tw * tw > MAX_GRID || ncodes < 1
        || ncodes >= (1 << CODE_BITS))
        return (int)cudaErrorInvalidValue;
    const long long blocks = (quads + DECODE_WARPS - 1) / DECODE_WARPS;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    float sharpen;
    memcpy(&sharpen, &sharpen_bits, sizeof(float));
    // The staged codes and the warps' sharpening grids: under 48 KB.
    const size_t smem = (size_t)min(ncodes, STAGED_CODES) * sizeof(unsigned long long)
                        + (size_t)DECODE_WARPS * MAX_GRID * sizeof(float);
    decode_kernel<<<(unsigned)blocks, DECODE_WARPS * LANES, smem, (cudaStream_t)stream>>>(
        (const float*)gray, (const float*)corners, (const float*)ftab, (const int*)itab,
        (const long long*)codes, (bool*)valid, (int*)id, (int*)hamming, (float*)margin,
        (int*)rotation, (float*)corners_out, B, C, H, W, nb, no, nbits, tw, ncodes,
        max_hamming, sharpen_on, sharpen);
    return (int)cudaGetLastError();
}

// consts: host memory holding the PoseConsts of the half size
// (ops/cuda/pose.py::pose_constants), copied into the launch's parameters,
// or null where the size has none (then pose_kernel<false> solves it all).
static PoseConsts pose_consts(const void* consts) {
    PoseConsts pc{};
    if (consts) memcpy(&pc, consts, sizeof(pc));
    return pc;
}

extern "C" int apriltag_pose(const void* corners, const void* K, void* rotation,
                             void* translation, void* quaternion, const void* consts, int N,
                             int per_frame, int k_batched, int half_bits, void* stream) {
    if (N < 1 || (k_batched && per_frame < 1)) return (int)cudaErrorInvalidValue;
    float half;
    memcpy(&half, &half_bits, sizeof(float));
    auto kernel = consts ? pose_kernel<true> : pose_kernel<false>;
    kernel<<<(N + POSE_THREADS - 1) / POSE_THREADS, POSE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)corners, (const float*)K, (float*)rotation, (float*)translation,
        (float*)quaternion, N, per_frame, k_batched, half, pose_consts(consts));
    return (int)cudaGetLastError();
}

// The top-2T pick and refine in one launch: (B, C) quads (corners, valid,
// dark, fit_err) -> (B, K, 4, 2) refined corners of the top K, (B, K)
// pre_valid and (B,) num_quads.
extern "C" int apriltag_select_refine(const void* gray, const void* corners, const void* valid,
                                      const void* dark, const void* fit_err, void* out,
                                      void* pre_valid, void* num_quads, int B, int C, int K,
                                      int H, int W, int P, int first_bits, int limit_bits,
                                      int want_dark, int decimate, void* stream) {
    const long long quads = (long long)B * K;
    if (B < 1 || C < 1 || C > TAIL_THREADS || K < 1 || K > C || decimate < 1
        || quads > 0x7fffffffLL || H < 1 || W < 1 || P < 0)
        return (int)cudaErrorInvalidValue;
    float first, limit;
    memcpy(&first, &first_bits, sizeof(float));
    memcpy(&limit, &limit_bits, sizeof(float));
    const Pick pk{(const bool*)valid, (const float*)fit_err, (bool*)pre_valid, (int*)num_quads,
                  K, want_dark, decimate};
    refine_kernel<<<(unsigned)quads, REFINE_THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)gray, (const float*)corners, (const bool*)dark, (float*)out, C, H, W, P,
        first, limit, pk);
    return (int)cudaGetLastError();
}

extern "C" int apriltag_tail_finish(const void* dec_valid, const void* id, const void* hamming,
                                    const void* margin, const void* corners,
                                    const void* pre_valid, const void* num_quads,
                                    const void* overflow_in, void* valid_out, void* id_out,
                                    void* ham_out, void* margin_out, void* center_out,
                                    void* corners_out, void* num_det, void* overflow_out, int B,
                                    int N, int K, int min_margin_bits, void* stream) {
    if (B < 1 || N < 1 || N > TAIL_THREADS || K < 1 || K > N) return (int)cudaErrorInvalidValue;
    float min_margin;
    memcpy(&min_margin, &min_margin_bits, sizeof(float));
    tail_finish_kernel<<<B, TAIL_THREADS, 0, (cudaStream_t)stream>>>(
        (const bool*)dec_valid, (const int*)id, (const int*)hamming, (const float*)margin,
        (const float*)corners, (const bool*)pre_valid, (const int*)num_quads,
        (const bool*)overflow_in, (bool*)valid_out, (int*)id_out, (int*)ham_out,
        (float*)margin_out, (float*)center_out, (float*)corners_out, (int*)num_det,
        (bool*)overflow_out, N, K, min_margin);
    return (int)cudaGetLastError();
}

extern "C" int apriltag_tail_finish_pose(
    const void* dec_valid, const void* id, const void* hamming, const void* margin,
    const void* corners, const void* pre_valid, const void* num_quads, const void* overflow_in,
    void* valid_out, void* id_out, void* ham_out, void* margin_out, void* center_out,
    void* corners_out, void* num_det, void* overflow_out, const void* K, void* rotation,
    void* translation, void* quaternion, const void* consts, int B, int N, int Kt,
    int min_margin_bits, int k_batched, int half_bits, void* stream) {
    if (B < 1 || N < 1 || N > TAIL_THREADS || Kt < 1 || Kt > N) return (int)cudaErrorInvalidValue;
    float min_margin, half;
    memcpy(&min_margin, &min_margin_bits, sizeof(float));
    memcpy(&half, &half_bits, sizeof(float));
    const FinishPose fp{(const float*)K, (float*)rotation, (float*)translation, (float*)quaternion,
                        k_batched, half, pose_consts(consts)};
    auto kernel = consts ? finish_pose_kernel<true> : finish_pose_kernel<false>;
    kernel<<<B, TAIL_THREADS, 0, (cudaStream_t)stream>>>(
        (const bool*)dec_valid, (const int*)id, (const int*)hamming, (const float*)margin,
        (const float*)corners, (const bool*)pre_valid, (const int*)num_quads,
        (const bool*)overflow_in, (bool*)valid_out, (int*)id_out, (int*)ham_out,
        (float*)margin_out, (float*)center_out, (float*)corners_out, (int*)num_det,
        (bool*)overflow_out, N, Kt, min_margin, fp);
    return (int)cudaGetLastError();
}
