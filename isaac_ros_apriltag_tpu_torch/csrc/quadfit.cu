// Quad fit search: (N, 6, K+1) circular prefix tables of the clusters'
// angular bin moments -> each cluster's best cyclic 4-subset of corner
// candidates and its four arcs' line fits.
//
// Replaces: the 4-subset search of isaac_ros_apriltag_tpu/ops/quadfit.py
// (XLA, no Pallas kernel): _arc_sums (:56) reads each arc's sum from the
// prefix tables by one {-1, 0, 1} (C, P, K+1) selector contraction a table
// (P = 64 windows, then 210 combos x 4 arcs), since per-element gathers
// serialise on a TPU, and the top-k, sort and argmin around it are XLA ops.
// At C = 1024 clusters the combos' selector alone is 224 MB built and read
// six times. Here one block of four warps a cluster keeps its six tables
// (6 x 65 f32, 1.5 KB) in shared memory and reads an arc's two or three
// entries from there, so nothing but the tables and the winner leaves or
// enters device memory. The reference's epilogue (:198-235: line
// directions, corner intersections, gates and winding on the (C, 4)
// winners, some 100 small XLA ops fused on a TPU) runs in the same block.
//
//   qf_search_kernel, one block of 128 threads a cluster, seven barriers:
//     phase A, thread k < 64: bin k's +-2-bin window's arc sums, line fit
//       and error (-inf under a weight of 4); the circular local maximum
//       test against its neighbours' errors; at most 10 maxima are all
//       candidates, else each is ranked by counting the maxima before it
//       (greater, or equal at a lower bin: the plain version's stable
//       descending sort) and the first 10 kept; the candidates' ascending
//       list by ballots, 2K past the last;
//     the arc table: a combo's arcs are direct arcs between two of its
//       candidates p < q (past c[p] to before c[q]) and one wrapped arc
//       (past c[q] to before c[p] + K), so the n candidates' n (n - 1)
//       arcs (90 at most, where each combo fitted its own four: 840) are
//       summed and fitted once, one a thread: the error and arc_ok in a
//       10 x 10 table (direct at (p, q), wrapped at (q, p));
//     combos t and t + 128 of _COMBOS (kCombos, itertools order): combo_ok
//       (every candidate valid) and the four arcs' arc_ok from the table,
//       the error ((e01 + e12) + e23) + e30 in the plain version's add
//       order; an arc's fit is a function of its bins alone, so each
//       combo's error is the plain version's bit for bit; then a warp
//       argmin (shuffles) and warp 0 over the four in torch.argmin's order
//       (NaN first, then the least, ties to the lower combo; inf at combo 0
//       where none is valid);
//     lanes 0-3 of warp 0 fit the winner's arcs again and write them; in
//       the fitting launch (FIT) they keep each arc's point, direction
//       (ops/quadfit.py::_line_dir) and error in shared memory instead,
//       then intersect adjacent arcs into the four corners (to pixels by
//       the cluster's scale and centroid), and lane 0 takes the gates (a
//       combo, the worst arc's MSE, the area, the corner angles, finite
//       corners, the point count, the cluster's validity), the winding and
//       the fit error and writes the Quads fields (ops/quadfit.py::
//       fit_epilogue), so no torch op runs on the (N, 4) winners.
//
// Against the plain versions (ops/quadfit.py::search_plain, and
// fit_epilogue after it for the fitting launch): bit-exact. Every
// float step is the plain version's in its order (built with --fmad=false,
// IEEE division and square root, clamps that pass NaN as torch.clamp does),
// and an arc's sum takes the same entries in the same order: S[ib] - S[ia]
// direct, (S[K] - S[ia]) + S[iw] wrapped, exactly S[iw] where ia == K and
// exactly S[K] where iw == ia.
//
// What bounds it on an H100: bytes (6 x 65 + 27 words a cluster, ~1.7 MB at
// C = 1024) and the f32 operations of 64 + 4 x (valid combos) line fits a
// cluster as the plain version counts them; both are far under a
// microsecond, so in practice a launch is bound by its latency: a block's
// steps run one after another. The arc table cuts a cluster's fits from
// 64 + 840 to 64 + 90 at most, and four warps a cluster keep a block's
// chain short at 128 clusters yet fill the card at 1024 (kernel ms,
// torch_resolve_times.py --stage quadfit, NVIDIA H100 80GB HBM3, 700.00 W:
// one warp a cluster 0.0100 at 720p b1 against four warps' 0.0077; a block
// of 256 0.0140 at b8 against one warp's 0.0106).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "torch_math.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int K = 64;                 // angular bins
constexpr int K1 = K + 1;             // prefix-table entries
constexpr int NT = 6;                 // tables: w, x, y, xx, xy, yy
constexpr int MAXIMA = 10;            // corner candidates
constexpr int NCOMB = 210;            // C(10, 4)
constexpr int WARPS = 4;              // a block: one cluster
constexpr int THREADS = WARPS * 32;
constexpr int ROUNDS = (NCOMB + THREADS - 1) / THREADS;   // combos a thread

// _COMBOS in itertools.combinations order, candidate j of combo t in byte j
// (device memory: a warp's lanes read 32 neighbouring words at once, where
// the constant cache would serve 32 different words one after another).
__device__ const uint32_t kCombos[NCOMB] = {
    0x03020100u, 0x04020100u, 0x05020100u, 0x06020100u, 0x07020100u, 0x08020100u, 0x09020100u,
    0x04030100u, 0x05030100u, 0x06030100u, 0x07030100u, 0x08030100u, 0x09030100u, 0x05040100u,
    0x06040100u, 0x07040100u, 0x08040100u, 0x09040100u, 0x06050100u, 0x07050100u, 0x08050100u,
    0x09050100u, 0x07060100u, 0x08060100u, 0x09060100u, 0x08070100u, 0x09070100u, 0x09080100u,
    0x04030200u, 0x05030200u, 0x06030200u, 0x07030200u, 0x08030200u, 0x09030200u, 0x05040200u,
    0x06040200u, 0x07040200u, 0x08040200u, 0x09040200u, 0x06050200u, 0x07050200u, 0x08050200u,
    0x09050200u, 0x07060200u, 0x08060200u, 0x09060200u, 0x08070200u, 0x09070200u, 0x09080200u,
    0x05040300u, 0x06040300u, 0x07040300u, 0x08040300u, 0x09040300u, 0x06050300u, 0x07050300u,
    0x08050300u, 0x09050300u, 0x07060300u, 0x08060300u, 0x09060300u, 0x08070300u, 0x09070300u,
    0x09080300u, 0x06050400u, 0x07050400u, 0x08050400u, 0x09050400u, 0x07060400u, 0x08060400u,
    0x09060400u, 0x08070400u, 0x09070400u, 0x09080400u, 0x07060500u, 0x08060500u, 0x09060500u,
    0x08070500u, 0x09070500u, 0x09080500u, 0x08070600u, 0x09070600u, 0x09080600u, 0x09080700u,
    0x04030201u, 0x05030201u, 0x06030201u, 0x07030201u, 0x08030201u, 0x09030201u, 0x05040201u,
    0x06040201u, 0x07040201u, 0x08040201u, 0x09040201u, 0x06050201u, 0x07050201u, 0x08050201u,
    0x09050201u, 0x07060201u, 0x08060201u, 0x09060201u, 0x08070201u, 0x09070201u, 0x09080201u,
    0x05040301u, 0x06040301u, 0x07040301u, 0x08040301u, 0x09040301u, 0x06050301u, 0x07050301u,
    0x08050301u, 0x09050301u, 0x07060301u, 0x08060301u, 0x09060301u, 0x08070301u, 0x09070301u,
    0x09080301u, 0x06050401u, 0x07050401u, 0x08050401u, 0x09050401u, 0x07060401u, 0x08060401u,
    0x09060401u, 0x08070401u, 0x09070401u, 0x09080401u, 0x07060501u, 0x08060501u, 0x09060501u,
    0x08070501u, 0x09070501u, 0x09080501u, 0x08070601u, 0x09070601u, 0x09080601u, 0x09080701u,
    0x05040302u, 0x06040302u, 0x07040302u, 0x08040302u, 0x09040302u, 0x06050302u, 0x07050302u,
    0x08050302u, 0x09050302u, 0x07060302u, 0x08060302u, 0x09060302u, 0x08070302u, 0x09070302u,
    0x09080302u, 0x06050402u, 0x07050402u, 0x08050402u, 0x09050402u, 0x07060402u, 0x08060402u,
    0x09060402u, 0x08070402u, 0x09070402u, 0x09080402u, 0x07060502u, 0x08060502u, 0x09060502u,
    0x08070502u, 0x09070502u, 0x09080502u, 0x08070602u, 0x09070602u, 0x09080602u, 0x09080702u,
    0x06050403u, 0x07050403u, 0x08050403u, 0x09050403u, 0x07060403u, 0x08060403u, 0x09060403u,
    0x08070403u, 0x09070403u, 0x09080403u, 0x07060503u, 0x08060503u, 0x09060503u, 0x08070503u,
    0x09070503u, 0x09080503u, 0x08070603u, 0x09070603u, 0x09080603u, 0x09080703u, 0x07060504u,
    0x08060504u, 0x09060504u, 0x08070504u, 0x09070504u, 0x09080504u, 0x08070604u, 0x09070604u,
    0x09080604u, 0x09080704u, 0x08070605u, 0x09070605u, 0x09080605u, 0x09080705u, 0x09080706u,
};

// The six tables' sums over the circular bin range [a, b] (ops/quadfit.py::
// _arc_sums): b < a is empty, b may pass K (wraps).
__device__ __forceinline__ void arc_sums(const float* S, int a, int b, float* out) {
    const int ia = clampi(a, 0, K), ib = clampi(b + 1, 0, K), iw = clampi(b - K + 1, 0, K);
    const bool wrap = b >= K;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
        const float* s = S + t * K1;
        float v;
        if (!wrap) v = s[ib] - s[ia];
        else if (ia == K) v = s[iw];
        else if (iw == ia) v = s[K];
        else v = (s[K] - s[ia]) + s[iw];
        out[t] = v;
    }
}

struct Line {
    float ex, ey, cxx, cxy, cyy, err;
};

// ops/quadfit.py::_line_fit on sums m = (w, x, y, xx, xy, yy), op for op.
__device__ __forceinline__ Line line_fit(const float* m) {
    const float Wf = clamp_min(m[0], 1e-6f);
    Line l;
    l.ex = m[1] / Wf;
    l.ey = m[2] / Wf;
    l.cxx = m[3] / Wf - l.ex * l.ex;
    l.cxy = m[4] / Wf - l.ex * l.ey;
    l.cyy = m[5] / Wf - l.ey * l.ey;
    const float d = l.cxx - l.cyy;
    const float disc = sqrtf(clamp_min(d * d + (4.0f * l.cxy) * l.cxy, 0.0f));
    l.err = 0.5f * ((l.cxx + l.cyy) - disc);
    return l;
}

// ops/quadfit.py::_line_dir: the principal direction of a line's covariance.
__device__ __forceinline__ void line_dir(const Line& l, float& dx, float& dy) {
    const float dd = l.cxx - l.cyy;
    const float disc = sqrtf(clamp_min(dd * dd + (4.0f * l.cxy) * l.cxy, 0.0f));
    const float lam = 0.5f * ((l.cxx + l.cyy) + disc);
    const float v1x = l.cxy, v1y = lam - l.cxx, v2x = lam - l.cyy, v2y = l.cxy;
    const bool pick = v1x * v1x + v1y * v1y > v2x * v2x + v2y * v2y;
    const float vx = pick ? v1x : v2x, vy = pick ? v1y : v2y;
    const float vn = sqrtf(clamp_min(vx * vx + vy * vy, 1e-12f));
    dx = vx / vn;
    dy = vy / vn;
}

// The fitting launch's clusters (N each), its Quads outputs and its gates.
struct FitArgs {
    const float* centroid;    // (N, 2)
    const float* scale;       // (N,)
    const int* count;         // (N,)
    const bool* valid;        // (N,)
    float* corners;           // (N, 4, 2)
    bool* quad_valid;         // (N,)
    float* fit_err;           // (N,)
    bool* gates;              // (N, 7)
    float max_mse, critical_cos, min_area;
};

// Arc j of a combo with candidate bins c: from past corner j to before
// corner j + 1, the last arc wrapping to the first corner + K.
__device__ __forceinline__ void arc_bounds(const int* c, int j, int& a, int& b) {
    a = c[j] + 1;
    b = (j < 3 ? c[j + 1] : c[0] + K) - 1;
}

__device__ __forceinline__ void combo_bins(const int* cand, int t, int* c) {
    const uint32_t packed = kCombos[t];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = cand[(packed >> (8 * j)) & 0xffu];
}

// torch.argmin's order: NaN first, then the least value, ties to the lower index.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
    const bool vn = is_nan(v), wn = is_nan(w);
    if (vn || wn) return vn && (!wn || i < j);
    return v < w || (v == w && i < j);
}

// A cluster's shared memory: its tables, the window errors and the maxima's,
// the maxima's and candidates' bit masks, the arc table, the warps'
// argmins and, in the fitting launch, the winner's arcs and corners.
struct ClusterMem {
    float S[NT * K1];
    float err[K];                      // bin k's window error
    float max_err[K];                  // the same where k is a local maximum
    uint32_t maxima[2], cands[2];      // bins 0-31 and 32-63
    float arc_err[MAXIMA][MAXIMA];     // (p, q), p < q: the direct arc; (q, p): the wrapped one
    uint8_t arc_ok[MAXIMA][MAXIMA];
    int cand[MAXIMA];
    float warp_v[WARPS];               // each warp's argmin
    int warp_i[WARPS];
    float arc[4][5];                   // FIT: arc j's point (x, y), direction (x, y), error
    float corner[4][2];                // FIT: corner j in pixels
};

// Arc u of the n candidates' n (n - 1) arcs: pair u of the first
// A = n (n - 1) / 2 in colex order ((0, 1), (0, 2), (1, 2), (0, 3), ...)
// direct, from past candidate p to before candidate q, and pair u - A past
// A wrapped, from past q to before p + K; its table cell and bins.
__device__ __forceinline__ void arc_of(const int* cand, int u, int A, int& row, int& col,
                                       int& a, int& b) {
    const bool wrapped = u >= A;
    const int t = wrapped ? u - A : u;
    int q = (int)((1.0f + sqrtf(1.0f + 8.0f * (float)t)) * 0.5f);
    q -= q * (q - 1) / 2 > t;
    q += (q + 1) * q / 2 <= t;
    const int p = t - q * (q - 1) / 2;
    row = wrapped ? q : p;
    col = wrapped ? p : q;
    a = cand[row] + 1;
    b = wrapped ? cand[p] + K - 1 : cand[q] - 1;
}

// Whether the maximum u at bin j ranks before v at bin k: the greater
// first, ties to the lower bin (candidates()' stable descending sort).
__device__ __forceinline__ int outranks(float u, int j, float v, int k) {
    return (u > v) || (u == v && j < k);
}

// FIT: the fitting launch, which writes the Quads fields (FitArgs) in
// place of the winner and its lines.
template <bool FIT>
__global__ void __launch_bounds__(THREADS)
qf_search_kernel(const float* __restrict__ tables, int64_t* __restrict__ best_out,
                 float* __restrict__ best_err_out, float* __restrict__ lines, int N,
                 FitArgs fit) {
    __shared__ ClusterMem w;
    const int c = blockIdx.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
    // The combos' candidate bytes, in flight while phase A runs.
    uint32_t combo[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const int u = t + THREADS * r;
        combo[r] = u < NCOMB ? __ldg(&kCombos[u]) : 0u;
    }
    const float* src = tables + (size_t)c * NT * K1;
#pragma unroll
    for (int r = 0; r < (NT * K1 + THREADS - 1) / THREADS; ++r) {
        const int i = t + THREADS * r;
        if (i < NT * K1) w.S[i] = src[i];
    }
    if (t < MAXIMA) w.cand[t] = 2 * K;
    __syncthreads();

    // --- phase A: bin t of warps 0-1; local maxima; the top 10 ---------------
    float e = -INFINITY;
    if (t < K) {
        const int a = (t + K - 2) % K;
        float m[NT];
        arc_sums(w.S, a, a + 4, m);
        const float err = line_fit(m).err;
        e = m[0] >= 4.0f ? err : -INFINITY;
        w.err[t] = e;
    }
    __syncthreads();
    const bool is_max = t < K && e > w.err[(t + K - 1) % K] && e >= w.err[(t + 1) % K]
                        && is_finite(e);
    if (is_max) w.max_err[t] = e;
    unsigned bits = __ballot_sync(FULL, is_max);
    if (lane == 0 && warp < 2) w.maxima[warp] = bits;
    __syncthreads();
    const uint64_t maxima = w.maxima[0] | (uint64_t)w.maxima[1] << 32;
    // At most 10 maxima are all candidates; else each is ranked by the
    // maxima before it (only maxima are finite, every other bin is -inf).
    bool is_cand = is_max;
    if (__popcll(maxima) > MAXIMA && is_max) {
        int rank = 0;
        for (uint64_t rest = maxima; rest; rest &= rest - 1) {
            const int j = __ffsll((long long)rest) - 1;
            rank += outranks(w.max_err[j], j, e, t);
        }
        is_cand = rank < MAXIMA;
    }
    bits = __ballot_sync(FULL, is_cand);
    if (lane == 0 && warp < 2) w.cands[warp] = bits;
    __syncthreads();
    const uint64_t cands = w.cands[0] | (uint64_t)w.cands[1] << 32;
    const int n = __popcll(cands);
    if (is_cand) w.cand[__popcll(cands & ((1ull << t) - 1))] = t;
    __syncthreads();

    // --- the arc table: each arc between two candidates, fitted once ---------
    const int A = n * (n - 1) / 2;
    if (t < 2 * A) {
        int row, col, a, b;
        arc_of(w.cand, t, A, row, col, a, b);
        float m[NT];
        arc_sums(w.S, a, b, m);
        w.arc_err[row][col] = line_fit(m).err;
        w.arc_ok[row][col] = b - a + 1 >= 1 && m[0] >= 3.0f;
    }
    __syncthreads();

    // --- every 4-subset from the table, then the argmin ----------------------
    // (inf, combo 0) is what a cluster without a valid combo returns.
    float v = INFINITY;
    int best = 0;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const int u = t + THREADS * r;
        const int i0 = combo[r] & 0xff, i1 = (combo[r] >> 8) & 0xff;
        const int i2 = (combo[r] >> 16) & 0xff, i3 = combo[r] >> 24;
        if (u < NCOMB && i3 < n) {
            const bool ok = w.arc_ok[i0][i1] && w.arc_ok[i1][i2] && w.arc_ok[i2][i3]
                            && w.arc_ok[i3][i0];
            const float err = ((w.arc_err[i0][i1] + w.arc_err[i1][i2]) + w.arc_err[i2][i3])
                              + w.arc_err[i3][i0];
            if (ok && before(err, u, v, best)) v = err, best = u;
        }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
        const float o = __shfl_xor_sync(FULL, v, off);
        const int j = __shfl_xor_sync(FULL, best, off);
        if (before(o, j, v, best)) v = o, best = j;
    }
    if (lane == 0) w.warp_v[warp] = v, w.warp_i[warp] = best;
    __syncthreads();
    if (warp) return;
#pragma unroll
    for (int k = 1; k < WARPS; ++k)
        if (before(w.warp_v[k], w.warp_i[k], v, best)) v = w.warp_v[k], best = w.warp_i[k];
    if (!FIT && lane == 0) {
        best_out[c] = best;
        best_err_out[c] = v;
    }

    // --- the winner's four arcs ----------------------------------------------
    if (lane < 4) {
        int cb[4], a, b;
        combo_bins(w.cand, best, cb);
        arc_bounds(cb, lane, a, b);
        float m[NT];
        arc_sums(w.S, a, b, m);
        const Line l = line_fit(m);
        if (FIT) {
            float dx, dy;
            line_dir(l, dx, dy);
            w.arc[lane][0] = l.ex;
            w.arc[lane][1] = l.ey;
            w.arc[lane][2] = dx;
            w.arc[lane][3] = dy;
            w.arc[lane][4] = l.err;
        } else {
            const float out[NT] = {l.ex, l.ey, l.cxx, l.cxy, l.cyy, l.err};
            const size_t plane = (size_t)N * 4;
#pragma unroll
            for (int f = 0; f < NT; ++f) lines[f * plane + (size_t)c * 4 + lane] = out[f];
        }
    }
    if (!FIT) return;

    // --- the epilogue (ops/quadfit.py::fit_epilogue) ------------------------
    const float s = clamp_min(fit.scale[c], 1e-6f);
    __syncwarp();
    if (lane < 4) {
        // Corner j: arcs j - 1 and j intersected, to pixels.
        const float* a = w.arc[(lane + 3) & 3];
        const float* b = w.arc[lane];
        float x, y;
        intersect(a[0], a[1], a[2], a[3], b[0], b[1], b[2], b[3], x, y);
        w.corner[lane][0] = x * s + fit.centroid[2 * c];
        w.corner[lane][1] = y * s + fit.centroid[2 * c + 1];
    }
    __syncwarp();
    if (lane == 0) {
        float x[4], y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = w.corner[j][0], y[j] = w.corner[j][1];
        const float scale2 = s * s;
        const float amax = nan_max(nan_max(nan_max(w.arc[0][4], w.arc[1][4]), w.arc[2][4]),
                                   w.arc[3][4]);
        float t[4];
        bool ang_ok = true, finite_ok = true;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int jn = (j + 1) & 3, jp = (j + 3) & 3;
            t[j] = x[j] * y[jn] - x[jn] * y[j];
            const float ix = x[j] - x[jp], iy = y[j] - y[jp], ox = x[jn] - x[j], oy = y[jn] - y[j];
            const float cosang = (ix * ox + iy * oy)
                                 / clamp_min(sqrtf(ix * ix + iy * iy) * sqrtf(ox * ox + oy * oy),
                                             1e-9f);
            ang_ok = ang_ok && fabsf(cosang) < fit.critical_cos;
            finite_ok = finite_ok && is_finite(x[j]) && is_finite(y[j]);
        }
        const float area2 = ((t[0] + t[1]) + t[2]) + t[3];
        const bool gates[7] = {is_finite(v), amax * scale2 <= fit.max_mse,
                               0.5f * fabsf(area2) >= fit.min_area, ang_ok, finite_ok,
                               fit.count[c] >= 8, fit.valid[c]};
        bool all = true;
#pragma unroll
        for (int g = 0; g < 7; ++g) {
            fit.gates[(size_t)c * 7 + g] = gates[g];
            all = all && gates[g];
        }
        fit.quad_valid[c] = all;
        fit.fit_err[c] = v * scale2;
        // Positive signed area (y-down CCW): where negative, corners 0, 3, 2, 1.
        const bool flip = area2 < 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int from = flip ? (4 - j) & 3 : j;
            fit.corners[(size_t)c * 8 + 2 * j] = x[from];
            fit.corners[(size_t)c * 8 + 2 * j + 1] = y[from];
        }
    }
}

}  // namespace

extern "C" int apriltag_quadfit_search(const void* tables, void* best, void* best_err,
                                       void* lines, int N, void* stream) {
    if (N < 1) return (int)cudaErrorInvalidValue;
    qf_search_kernel<false><<<N, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)tables, (int64_t*)best, (float*)best_err, (float*)lines, N, FitArgs{});
    return (int)cudaGetLastError();
}

extern "C" int apriltag_quadfit_fit(const void* tables, const void* centroid, const void* scale,
                                    const void* count, const void* valid, void* corners,
                                    void* quad_valid, void* fit_err, void* gates, int N,
                                    int mse_bits, int cos_bits, int area_bits, void* stream) {
    if (N < 1) return (int)cudaErrorInvalidValue;
    FitArgs fit{(const float*)centroid, (const float*)scale, (const int*)count,
                (const bool*)valid, (float*)corners, (bool*)quad_valid, (float*)fit_err,
                (bool*)gates, 0.0f, 0.0f, 0.0f};
    memcpy(&fit.max_mse, &mse_bits, sizeof(float));
    memcpy(&fit.critical_cos, &cos_bits, sizeof(float));
    memcpy(&fit.min_area, &area_bits, sizeof(float));
    qf_search_kernel<true><<<N, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)tables, nullptr, nullptr, nullptr, N, fit);
    return (int)cudaGetLastError();
}
