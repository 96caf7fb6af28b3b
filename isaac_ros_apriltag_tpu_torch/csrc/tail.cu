// The detector's tail: decode of the top-2T candidate quads and pose of the
// top-T tags.
//
// Replaces: isaac_ros_apriltag_tpu/ops/decode.py:105 (decode_quads) and
// isaac_ros_apriltag_tpu/ops/pose.py:38 (estimate_poses), XLA code with no
// Pallas kernel there. On a TPU the whole tail is one jitted program; in
// PyTorch each of its steps on the (B, 2T) quads and (B, T) tags is a kernel
// of its own that does almost no work (~350 for decode and ~320 for pose a
// call), so here each stage is one launch that keeps every intermediate in
// registers or shared memory.
//
//   decode_kernel, one warp a quad (DECODE_WARPS quads a block):
//     every lane solves the quad's unit-square homography (the same 8x8
//     elimination, so no lane waits on another); lane l samples cell l and
//     cell l + 32 of the border ring, the outer ring and the bit cells
//     (bilinear, with bilinear_taps' clamps and NaN-to-index-0 rule, so no
//     lane reads outside its frame); the gray models' sums and the margin's
//     class sums are warp sums (a lane's two cells, then a butterfly), the
//     inverse normal matrices are family tables; sharpening reads the
//     (tw, tw) grid from the warp's shared memory, wrapping as torch.roll
//     does; the bits' ballot gives each rotation's code by a bit reversal,
//     the lanes stride over the codebook with __popcll and a warp min of
//     (hamming << 24 | code index) gives the first minimum.
//   pose_kernel, one thread a tag: the tag-plane homography, K^-1 (K shared
//     or one per frame), M = K^-1 H, the scale and its sign, the cross
//     product, 4 Newton polar steps and the quaternion.
//
// Against the plain versions (ops/decode.py::decode_quads, ops/pose.py::
// estimate_poses, utils/geometry.py): bit-exact. Every float step is theirs
// in their order (built with --fmad=false, IEEE division and square root;
// clamps, minimum and argmax treat NaN as torch does), a warp sum is their
// _warp_sum (zeros past the set, x[:32] + x[32:], then halves), and the
// elimination picks the first largest |pivot| of a column.
//
// What bounds them on an H100: bytes. decode reads each sample's four taps
// (124 samples a quad at most), the corners and the codebook (once) and
// writes ~60 bytes a quad: ~0.3 MB at B x 2T = 1024 quads, ~0.1 us at the
// card's memory rate. pose reads 32 bytes of corners a tag and writes 64.
// Both are far under a microsecond, so a launch is bound by its latency:
// one wave of warps covers a call, and a warp's steps run one after another.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int LANES = 32;
constexpr int MAX_CELLS = 2 * LANES;  // cells a sample set holds at most
constexpr int MAX_GRID = 128;         // total_width^2 at most (11^2 = 121)
constexpr int DECODE_WARPS = 4;       // quads a block
constexpr int POSE_THREADS = 128;
constexpr int CODE_BITS = 24;         // code index bits of a warp-min key

__device__ __forceinline__ bool is_nan(float v) { return v != v; }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }
// torch.clamp(v, min=lo): NaN passes through.
__device__ __forceinline__ float clamp_min(float v, float lo) {
    return is_nan(v) ? v : (v < lo ? lo : v);
}
// torch.clamp(v, lo, hi): min(max(v, lo), hi), NaN passes through.
__device__ __forceinline__ float clamp_lo_hi(float v, float lo, float hi) {
    if (is_nan(v)) return v;
    v = v < lo ? lo : v;
    return v > hi ? hi : v;
}
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

// utils/geometry.py::homography_from_correspondences: the 3x3 H (row-major)
// taking the src corners (sx, sy) to the dst corners (dx, dy).
__device__ __forceinline__ void homography(const float (&sx)[4], const float (&sy)[4],
                                           const float (&dx)[4], const float (&dy)[4],
                                           float (&Hm)[9]) {
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
    float A[8][8], b[8], h[8];
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

// ops/decode.py's bilinear sample of one frame at H (u, v): apply_homography,
// then refine.py::bilinear_taps (clamp, NaN to index 0, index clamps) and
// decode.py's association of the four taps.
__device__ __forceinline__ float sample(const float* __restrict__ img, int H, int W,
                                        float xmax, float ymax, const float (&Hm)[9],
                                        float u, float v) {
    const float qx = (Hm[0] * u + Hm[1] * v) + Hm[2];
    const float qy = (Hm[3] * u + Hm[4] * v) + Hm[5];
    const float qw = (Hm[6] * u + Hm[7] * v) + Hm[8];
    const float x = clamp_lo_hi(qx / qw, 0.0f, xmax);
    const float y = clamp_lo_hi(qy / qw, 0.0f, ymax);
    float x0f = floorf(x), y0f = floorf(y);
    if (is_nan(x0f)) x0f = 0.0f;
    if (is_nan(y0f)) y0f = 0.0f;
    const float fx = x - x0f, fy = y - y0f;
    const int x0 = clampi((int)x0f, 0, W - 1), y0 = clampi((int)y0f, 0, H - 1);
    const int x1 = min(x0 + 1, W - 1), y1 = min(y0 + 1, H - 1);
    const float v00 = __ldg(img + (size_t)y0 * W + x0), v01 = __ldg(img + (size_t)y0 * W + x1);
    const float v10 = __ldg(img + (size_t)y1 * W + x0), v11 = __ldg(img + (size_t)y1 * W + x1);
    return v00 * (1.0f - fx) * (1.0f - fy) + v01 * fx * (1.0f - fy)
           + v10 * (1.0f - fx) * fy + v11 * fx * fy;
}

// ops/decode.py::_warp_sum of a set whose cells lane and lane + 32 hold lo
// and hi (0 past the set): every lane gets the sum.
__device__ __forceinline__ float warp_sum(float lo, float hi) {
    float s = lo + hi;
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1) s = s + __shfl_xor_sync(FULL, s, off);
    return s;
}

// ops/decode.py::_fit_gray_model of the n cells at uv (n <= 64) with the
// set's inverse normal matrix minv: the model (a, b, c).
__device__ __forceinline__ void gray_model(const float* __restrict__ img, int H, int W,
                                           float xmax, float ymax, const float (&Hm)[9],
                                           const float* __restrict__ uv, int n,
                                           const float* __restrict__ minv, int lane,
                                           float (&m)[3]) {
    float t[2][3];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int i = lane + s * LANES;
        t[s][0] = t[s][1] = t[s][2] = 0.0f;
        if (i < n) {
            const float u = uv[2 * i], v = uv[2 * i + 1];
            const float val = sample(img, H, W, xmax, ymax, Hm, u, v);
            t[s][0] = val;
            t[s][1] = u * val;
            t[s][2] = v * val;
        }
    }
    const float atb[3] = {warp_sum(t[0][0], t[1][0]), warp_sum(t[0][1], t[1][1]),
                          warp_sum(t[0][2], t[1][2])};
#pragma unroll
    for (int i = 0; i < 3; ++i)
        m[i] = (minv[3 * i] * atb[0] + minv[3 * i + 1] * atb[1]) + minv[3 * i + 2] * atb[2];
}

__global__ void __launch_bounds__(DECODE_WARPS * LANES)
decode_kernel(const float* __restrict__ gray, const float* __restrict__ corners,
              const float* __restrict__ ftab, const int* __restrict__ itab,
              const long long* __restrict__ codes, bool* __restrict__ valid_out,
              int* __restrict__ id_out, int* __restrict__ ham_out,
              float* __restrict__ margin_out, int* __restrict__ rot_out,
              float* __restrict__ corners_out, int B, int C, int H, int W, int nb, int no,
              int nbits, int tw, int ncodes, int max_hamming, int sharpen_on,
              float sharpen) {
    __shared__ float sgrid[DECODE_WARPS][MAX_GRID];
    const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
    const long long q = (long long)blockIdx.x * DECODE_WARPS + warp;
    if (q >= (long long)B * C) return;       // the whole warp leaves together
    const float* img = gray + (size_t)(q / C) * H * W;
    const float* cq = corners + q * 8;
    const float sx[4] = {-1.0f, 1.0f, 1.0f, -1.0f}, sy[4] = {-1.0f, -1.0f, 1.0f, 1.0f};
    float dx[4], dy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        dx[k] = cq[2 * k];
        dy[k] = cq[2 * k + 1];
    }
    float Hm[9];
    homography(sx, sy, dx, dy, Hm);

    // The family's tables (ops/decode.py::_tables).
    const float* uv_border = ftab;
    const float* uv_outer = uv_border + 2 * nb;
    const float* uv_bits = uv_outer + 2 * no;
    const float* minv_in = uv_bits + 2 * nbits;
    const float* minv_out = minv_in + 9;
    const int* lin = itab;
    const int* perms = itab + nbits;
    // torch.clamp's bound W - 1.001, a double rounded to float.
    const float xmax = (float)((double)W - 1.001), ymax = (float)((double)H - 1.001);

    float m_in[3], m_out[3];
    gray_model(img, H, W, xmax, ymax, Hm, uv_border, nb, minv_in, lane, m_in);
    gray_model(img, H, W, xmax, ymax, Hm, uv_outer, no, minv_out, lane, m_out);

    // Lane l holds bits l and l + 32: their samples and thresholds.
    float vb[2] = {0.0f, 0.0f}, th[2] = {0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
        const int i = lane + s * LANES;
        if (i < nbits) {
            const float u = uv_bits[2 * i], v = uv_bits[2 * i + 1];
            vb[s] = sample(img, H, W, xmax, ymax, Hm, u, v);
            th[s] = 0.5f * (((m_in[0] + m_in[1] * u) + m_in[2] * v)
                            + ((m_out[0] + m_out[1] * u) + m_out[2] * v));
        }
    }
    if (sharpen_on) {
        float* g = sgrid[warp];
        for (int i = lane; i < tw * tw; i += LANES) g[i] = 0.0f;
        __syncwarp();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int i = lane + s * LANES;
            if (i < nbits) g[lin[i]] = vb[s];
        }
        __syncwarp();
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const int i = lane + s * LANES;
            if (i < nbits) {
                const int gi = lin[i], gy = gi / tw, gx = gi % tw;
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
        const int* pr = perms + r * nbits;
        const bool plo = lane < nbits && ((mask >> pr[lane]) & 1ull);
        const bool phi = lane + LANES < nbits && ((mask >> pr[lane + LANES]) & 1ull);
        const unsigned long long m = (unsigned long long)__ballot_sync(FULL, plo)
                                     | ((unsigned long long)__ballot_sync(FULL, phi) << 32);
        code[r] = __brevll(m) >> (64 - nbits);
    }
    // First minimum over the codes (torch.argmin), per rotation.
    unsigned key[4] = {~0u, ~0u, ~0u, ~0u};
    for (int j = lane; j < ncodes; j += LANES) {
        const unsigned long long cw = (unsigned long long)__ldg(codes + j);
#pragma unroll
        for (int r = 0; r < 4; ++r)
            key[r] = min(key[r], ((unsigned)__popcll(code[r] ^ cw) << CODE_BITS) | (unsigned)j);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) key[r] = __reduce_min_sync(FULL, key[r]);
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
}

__global__ void __launch_bounds__(POSE_THREADS)
pose_kernel(const float* __restrict__ corners, const float* __restrict__ K,
            float* __restrict__ rot_out, float* __restrict__ t_out, float* __restrict__ q_out,
            int N, int per_frame, int k_batched, float half) {
    const int n = blockIdx.x * POSE_THREADS + threadIdx.x;
    if (n >= N) return;
    const float* cq = corners + (size_t)n * 8;
    const float* Kp = K + (k_batched ? (size_t)(n / per_frame) * 9 : 0);
    // TAG_CORNERS * (tag_size / 2).
    const float sx[4] = {-1.0f * half, 1.0f * half, 1.0f * half, -1.0f * half};
    const float sy[4] = {-1.0f * half, -1.0f * half, 1.0f * half, 1.0f * half};
    float dx[4], dy[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        dx[k] = cq[2 * k];
        dy[k] = cq[2 * k + 1];
    }
    float Hm[9], Km[9], Kinv[9];
    homography(sx, sy, dx, dy, Hm);
#pragma unroll
    for (int k = 0; k < 9; ++k) Km[k] = Kp[k];
    inverse3x3(Km, Kinv);
    // M = K^-1 H (utils/geometry.py::matmul3).
    float M[9];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            M[3 * i + j] = (Kinv[3 * i] * Hm[j] + Kinv[3 * i + 1] * Hm[3 + j])
                           + Kinv[3 * i + 2] * Hm[6 + j];
    const float n1 = sqrtf((M[0] * M[0] + M[3] * M[3]) + M[6] * M[6]);
    const float n2 = sqrtf((M[1] * M[1] + M[4] * M[4]) + M[7] * M[7]);
    float scale = (1.0f / clamp_min(n1 + n2, 1e-12f)) * 2.0f;
    const float z = M[8];
    scale = scale * ((z > 0.0f ? 1.0f : 0.0f) - (z < 0.0f ? 1.0f : 0.0f));   // positive depth
    const float r1[3] = {M[0] * scale, M[3] * scale, M[6] * scale};
    const float r2[3] = {M[1] * scale, M[4] * scale, M[7] * scale};
    const float t[3] = {M[2] * scale, M[5] * scale, M[8] * scale};
    const float r3[3] = {r1[1] * r2[2] - r1[2] * r2[1], r1[2] * r2[0] - r1[0] * r2[2],
                         r1[0] * r2[1] - r1[1] * r2[0]};
    // Columns r1, r2, r3; then 4 Newton polar steps X <- (X + X^-T) / 2.
    float X[9] = {r1[0], r2[0], r3[0], r1[1], r2[1], r3[1], r1[2], r2[2], r3[2]};
#pragma unroll
    for (int it = 0; it < 4; ++it) {
        float Xi[9];
        inverse3x3(X, Xi);
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) X[3 * i + j] = 0.5f * (X[3 * i + j] + Xi[3 * j + i]);
    }
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
    for (int k = 0; k < 9; ++k) rot_out[(size_t)n * 9 + k] = X[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t_out[(size_t)n * 3 + k] = t[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) q_out[(size_t)n * 4 + k] = qv[k] * sign;
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
    decode_kernel<<<(unsigned)blocks, DECODE_WARPS * LANES, 0, (cudaStream_t)stream>>>(
        (const float*)gray, (const float*)corners, (const float*)ftab, (const int*)itab,
        (const long long*)codes, (bool*)valid, (int*)id, (int*)hamming, (float*)margin,
        (int*)rotation, (float*)corners_out, B, C, H, W, nb, no, nbits, tw, ncodes,
        max_hamming, sharpen_on, sharpen);
    return (int)cudaGetLastError();
}

extern "C" int apriltag_pose(const void* corners, const void* K, void* rotation,
                             void* translation, void* quaternion, int N, int per_frame,
                             int k_batched, int half_bits, void* stream) {
    if (N < 1 || (k_batched && per_frame < 1)) return (int)cudaErrorInvalidValue;
    float half;
    memcpy(&half, &half_bits, sizeof(float));
    pose_kernel<<<(N + POSE_THREADS - 1) / POSE_THREADS, POSE_THREADS, 0,
                  (cudaStream_t)stream>>>(
        (const float*)corners, (const float*)K, (float*)rotation, (float*)translation,
        (float*)quaternion, N, per_frame, k_batched, half);
    return (int)cudaGetLastError();
}
