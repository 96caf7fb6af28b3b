// One connected-component-labeling scan round, as two kernels.
//
// Replaces: isaac_ros_apriltag_tpu/ops/pallas/ccl.py, `_row_kernel` (K2) and
// `_col_diag_kernel` (K3), launched once each per round by
// `connected_components_pallas` (through `ccl_scan_pallas`). Both are
// bit-exact with the plain versions in
// isaac_ros_apriltag_tpu_torch/ops/cuda/ccl.py.
//
// Semantics (tri is the u8 trinary image {0, 127, 255}, labels are int32):
//   K2: a forward then a backward segmented min-scan along each row. A
//       segment breaks where tri changes or tri == 127, so every maximal run
//       of equal non-127 values ends up holding the run's minimum label and
//       127 pixels keep their own.
//   K3: a white-only diagonal hop (a 255 pixel takes the min of its own
//       label and the labels of its diagonal neighbours that are also 255,
//       all read from the INPUT labels; out-of-image neighbours never
//       connect), then the same forward/backward segmented min-scan down each
//       column. Input and output are separate buffers.
//
// What bounds them on an H100: latency and the number of dependent steps,
// not bytes. At 540x960 a round moves ~4 MB (labels in and out of each kernel
// plus the u8 trinary), which is about a microsecond of HBM bandwidth and
// stays in the 50 MB L2 from round to round.
//
// Design: both kernels give one block to one scan line (a row for K2, a
// column for K3) and keep the line in shared memory (11 bytes a pixel, 45 KB
// at the 4096-pixel limit), where a Hillis-Steele segmented scan runs log2(n)
// steps forward and then backward, as the TPU kernel does over lane
// rotations. K3 does the diagonal hop while it loads its column, every pixel
// reading its neighbours from the input labels. Its global reads are strided
// by the row pitch, but 960 columns are read at once from L2. (A first
// version gave each column one thread that walked it row by row: 960 threads
// could not fill the card and took ~0.5 ms a call.) No padding is needed:
// the TPU version padded the image to 64x128 tiles with 127 pixels, which
// never join a segment.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Forward then backward segmented min-scan of n labels held in shared memory
// (la, with scratch lb, fa, fb), segments set by the trinary values in t:
// element i connects to i - 1 iff t[i] == t[i - 1] and t[i] != 127.
// Hillis-Steele, log2(n) steps each way. The result ends in `la`.
__device__ void seg_min_scan_pair(const uint8_t* t, int32_t*& la, int32_t*& lb,
                                  uint8_t*& fa, uint8_t*& fb, int n) {
    for (int dir = 0; dir < 2; ++dir) {
        // flag[i] = 1 where i does not connect to its predecessor in this
        // direction (i - 1 forward, i + 1 backward).
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const int j = dir == 0 ? i - 1 : i + 1;
            fa[i] = (j < 0) || (j >= n) || t[i] != t[j] || t[i] == 127;
        }
        __syncthreads();
        for (int s = 1; s < n; s <<= 1) {
            for (int i = threadIdx.x; i < n; i += blockDim.x) {
                const int j = dir == 0 ? i - s : i + s;
                int32_t l = la[i];
                uint8_t f = fa[i];
                if (j >= 0 && j < n) {
                    if (!f) l = min(l, la[j]);
                    f |= fa[j];
                } else {
                    f = 1;
                }
                lb[i] = l;
                fb[i] = f;
            }
            __syncthreads();
            int32_t* tl = la; la = lb; lb = tl;
            uint8_t* tf = fa; fa = fb; fb = tf;
        }
    }
}

// Shared memory of one scan line of n pixels: two label buffers, two flag
// buffers and the trinary values (11 bytes a pixel).
__device__ void carve(unsigned char* smem, int n, int32_t*& la, int32_t*& lb,
                      uint8_t*& fa, uint8_t*& fb, uint8_t*& t) {
    la = reinterpret_cast<int32_t*>(smem);
    lb = la + n;
    fa = reinterpret_cast<uint8_t*>(lb + n);
    fb = fa + n;
    t = fb + n;
}

__global__ void row_scan_kernel(const uint8_t* __restrict__ tri,
                                const int32_t* __restrict__ lab_in,
                                int32_t* __restrict__ lab_out, int W) {
    extern __shared__ unsigned char smem[];
    int32_t *la, *lb;
    uint8_t *fa, *fb, *t;
    carve(smem, W, la, lb, fa, fb, t);
    const size_t row = (size_t)blockIdx.x * W;
    for (int i = threadIdx.x; i < W; i += blockDim.x) {
        la[i] = lab_in[row + i];
        t[i] = tri[row + i];
    }
    __syncthreads();
    seg_min_scan_pair(t, la, lb, fa, fb, W);
    for (int i = threadIdx.x; i < W; i += blockDim.x) lab_out[row + i] = la[i];
}

__global__ void col_diag_kernel(const uint8_t* __restrict__ tri,
                                const int32_t* __restrict__ lab_in,
                                int32_t* __restrict__ lab_out, int H, int W) {
    extern __shared__ unsigned char smem[];
    int32_t *la, *lb;
    uint8_t *fa, *fb, *t;
    carve(smem, H, la, lb, fa, fb, t);
    const int x = blockIdx.x;
    // Load the column, doing the diagonal hop on the way in: every pixel
    // reads its neighbours from lab_in, so all four are pre-hop values.
    for (int y = threadIdx.x; y < H; y += blockDim.x) {
        const size_t o = (size_t)y * W + x;
        const uint8_t tc = tri[o];
        int32_t m = lab_in[o];
        if (tc == 255) {
            for (int dy = -1; dy <= 1; dy += 2) {
                const int ny = y + dy;
                if (ny < 0 || ny >= H) continue;
                for (int dx = -1; dx <= 1; dx += 2) {
                    const int nx = x + dx;
                    if (nx < 0 || nx >= W) continue;
                    const size_t n = (size_t)ny * W + nx;
                    if (tri[n] == 255) m = min(m, lab_in[n]);
                }
            }
        }
        la[y] = m;
        t[y] = tc;
    }
    __syncthreads();
    seg_min_scan_pair(t, la, lb, fa, fb, H);
    for (int y = threadIdx.x; y < H; y += blockDim.x) lab_out[(size_t)y * W + x] = la[y];
}

size_t line_smem(int n) { return (size_t)n * (2 * sizeof(int32_t) + 3 * sizeof(uint8_t)); }

int line_threads(int n) {
    const int t = ((n + 31) / 32) * 32;
    return t > 1024 ? 1024 : t;
}

}  // namespace

extern "C" int apriltag_ccl_row(const void* tri, const void* lab_in, void* lab_out,
                                int H, int W, void* stream) {
    row_scan_kernel<<<H, line_threads(W), line_smem(W), (cudaStream_t)stream>>>(
        (const uint8_t*)tri, (const int32_t*)lab_in, (int32_t*)lab_out, W);
    return (int)cudaGetLastError();
}

extern "C" int apriltag_ccl_col_diag(const void* tri, const void* lab_in, void* lab_out,
                                     int H, int W, void* stream) {
    col_diag_kernel<<<W, line_threads(H), line_smem(H), (cudaStream_t)stream>>>(
        (const uint8_t*)tri, (const int32_t*)lab_in, (int32_t*)lab_out, H, W);
    return (int)cudaGetLastError();
}
