// Adaptive threshold: (B, H, W) f32 grayscale -> (B, H, W) u8 trinary
// {0, 127, 255}, each frame on its own.
//
// Replaces: isaac_ros_apriltag_tpu/ops/pallas/threshold.py, `_kernel`
// (entry point `adaptive_threshold_pallas`). Bit-exact with the plain
// version in isaac_ros_apriltag_tpu_torch/ops/threshold.py and with
// isaac_ros_apriltag_tpu/ops/threshold.py: per ts x ts tile min and max,
// both dilated over the 3x3 tile neighbourhood (tile indices clamped at the
// image edge), then 127 where max - min < min_diff, else 255 where
// gray > min + (max - min) * 0.5 and 0 otherwise.
//
// What bounds it on an H100: memory traffic. At the detector's 540x960
// segmentation image one call reads ~2 MB of f32 and writes ~0.5 MB of u8;
// the arithmetic is a handful of compares per pixel.
//
// Design: one launch for the whole batch; blockIdx.z is the frame, whose
// base pointer is b*H*W, and the halo's tile indices clamp to that frame's
// edges, so no frame reads another's pixels. A block owns an 8x8-tile output
// region of its frame. Its threads
// first reduce the 10x10 tiles of that region plus a one-tile halo into
// shared memory (the halo tiles are recomputed by the neighbouring blocks;
// ~1.6x re-read of the input, served mostly from L2), then each thread
// thresholds pixels of the region with consecutive threads on consecutive
// x, so the second read and the u8 write are coalesced. The compare is
// written with round-to-nearest intrinsics (and the file is built with
// --fmad=false) so no fused multiply-add can change a rounding and break
// bit-exactness. Inputs are finite (the detector feeds uint8-derived
// values), so fminf/fmaxf agree with the reference's min/max.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTiles = 8;                 // output tiles per block edge
constexpr int kHalo = kTiles + 2;         // with the one-tile halo

__global__ void threshold_kernel(const float* __restrict__ gray,
                                 uint8_t* __restrict__ out,
                                 int H, int W, int ts, int min_diff) {
    __shared__ float smin[kHalo][kHalo];
    __shared__ float smax[kHalo][kHalo];
    const int Ht = H / ts, Wt = W / ts;
    const int ty0 = blockIdx.y * kTiles, tx0 = blockIdx.x * kTiles;
    const size_t frame = (size_t)blockIdx.z * H * W;
    gray += frame;
    out += frame;

    for (int k = threadIdx.x; k < kHalo * kHalo; k += blockDim.x) {
        const int ly = k / kHalo, lx = k % kHalo;
        const int ty = min(max(ty0 + ly - 1, 0), Ht - 1);
        const int tx = min(max(tx0 + lx - 1, 0), Wt - 1);
        const float* p = gray + (size_t)(ty * ts) * W + tx * ts;
        float mn = p[0], mx = p[0];
        for (int r = 0; r < ts; ++r) {
            for (int c = 0; c < ts; ++c) {
                const float v = p[(size_t)r * W + c];
                mn = fminf(mn, v);
                mx = fmaxf(mx, v);
            }
        }
        smin[ly][lx] = mn;
        smax[ly][lx] = mx;
    }
    __syncthreads();

    const int npy = min(kTiles, Ht - ty0) * ts;
    const int npx = min(kTiles, Wt - tx0) * ts;
    const float fdiff = (float)min_diff;
    for (int k = threadIdx.x; k < npy * npx; k += blockDim.x) {
        const int py = k / npx, px = k % npx;
        const int ly = py / ts + 1, lx = px / ts + 1;
        float mn = smin[ly][lx], mx = smax[ly][lx];
        for (int dy = -1; dy <= 1; ++dy) {
            for (int dx = -1; dx <= 1; ++dx) {
                mn = fminf(mn, smin[ly + dy][lx + dx]);
                mx = fmaxf(mx, smax[ly + dy][lx + dx]);
            }
        }
        const float contrast = __fsub_rn(mx, mn);
        const float thresh = __fadd_rn(mn, __fmul_rn(contrast, 0.5f));
        const size_t o = (size_t)(ty0 * ts + py) * W + (tx0 * ts + px);
        const float g = gray[o];
        out[o] = contrast < fdiff ? (uint8_t)127 : (g > thresh ? (uint8_t)255 : (uint8_t)0);
    }
}

}  // namespace

extern "C" int apriltag_threshold(const void* gray, void* out, int B, int H, int W,
                                  int ts, int min_diff, void* stream) {
    const dim3 grid((W / ts + kTiles - 1) / kTiles, (H / ts + kTiles - 1) / kTiles, B);
    threshold_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)gray, (uint8_t*)out, H, W, ts, min_diff);
    return (int)cudaGetLastError();
}
