// Adaptive threshold: (B, H, W) f32 grayscale -> (B, H, W) u8 trinary
// {0, 127, 255}, each frame on its own.
//
// Replaces: isaac_ros_apriltag_tpu/ops/pallas/threshold.py, `_kernel`
// (entry point `adaptive_threshold_pallas`). Bit-exact with the plain
// version in isaac_ros_apriltag_tpu_torch/ops/threshold.py and with
// isaac_ros_apriltag_tpu/ops/threshold.py: per ts x ts tile min and max,
// both dilated over the 3x3 tile neighbourhood (tile indices clamped at the
// frame's edge), then 127 where max - min < min_diff, else 255 where
// gray > min + (max - min) * 0.5 and 0 otherwise.
//
// What bounds it on an H100: bytes. A call must read 4 bytes and write 1 a
// pixel: 20.7 MB and 6.2 us at 3.35 TB/s for a batch of 8 x 540 x 960; the
// arithmetic is a few compares a pixel.
//
// Design. The kernel is a template on ts (2, 4, 8, 16, 32), so every
// division by ts is a shift and every loop over a tile unrolls. One launch
// takes the whole batch: blockIdx.z is the frame, whose base is b*H*W, and
// every tile index is tested against that frame's own edges, so no frame
// reads another's pixels. A block outputs a region of 32 px rows by 128 px
// columns (RT x CT tiles) and reads it with a ring of halo tiles around it:
// one tile row above and below and HT tile columns left and right (HT = 1,
// or 2 at ts = 2 so that every group of 4 pixels starts 16-byte aligned).
// One thread per "item": 4 adjacent pixels (a quad) of one read row of
// tiles, ts rows deep. Each thread
//   1. loads its item with ts 16-byte loads (a warp reads 512 contiguous
//      bytes a row) and keeps the pixels in registers;
//   2. reduces them to the min and max of its tile (at ts >= 8 a tile is
//      ts/4 neighbouring lanes: __shfl_xor_sync) and one lane a tile writes
//      them to shared memory. A tile outside the frame holds the identities
//      (+inf, -inf): the reference's clamped index names a tile that is
//      already inside the same 3x3 window, so leaving it out is exact;
// then, after a barrier, one thread per output tile dilates over its 3x3
// neighbourhood and computes the threshold and the low-contrast flag once
// for the tile; after a second barrier each thread of an output item
// compares its pixels, still in registers, and stores 4 pixels as one
// uchar4 (a warp stores 128 contiguous bytes). Each pixel is read from
// device memory by one block, plus the halo ring: (RT + 2) x (CT + 2 HT)
// tiles read for RT x CT written, 1.33x at ts = 4, most of it served by L2.
// The compare uses round-to-nearest intrinsics (and the file is built with
// --fmad=false), so no fused multiply-add can change a rounding. Inputs are
// finite (the detector feeds uint8-derived values), so fminf/fmaxf agree
// with the reference's min/max in any order.
//
// Per ts (threads a block = items rounded up to a warp; registers hold ts
// float4 a thread; shared memory is the read tiles' min/max, 8 bytes each,
// plus the output tiles' threshold and flag, 5 bytes each):
//   ts   RT x CT   read tiles   threads   pixel registers   shared memory
//    2   16 x 64     18 x 68       640          8             14,912 B
//    4    8 x 32     10 x 34       352         16              4,000 B
//    8    4 x 16      6 x 18       224         32              1,184 B
//   16    2 x 8       4 x 10       160         64                400 B
//   32    1 x 4       3 x 6        160        128                164 B
// all far under the 48 KB of static shared memory; a launch the card
// refuses is reported by cudaGetLastError, which the entry point returns.
//
// Unaligned rows: the 16-byte loads and 4-byte stores need W % 4 == 0 and
// 16-byte (input) and 4-byte (output) aligned base pointers; then every
// frame and row start is aligned too, since b*H*W and y*W are multiples of
// 4. Otherwise (W = 2 mod 4 at ts = 2, or a frame view that starts off a
// 16-byte boundary) the entry point launches the kernel's scalar instance,
// which loads and stores the same items one pixel at a time and masks each
// half of a quad by its own tile's validity.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int BLOCK_ROWS = 32;    // output pixel rows a block
constexpr int BLOCK_COLS = 128;   // output pixel columns a block

template <int TS>
struct Geom {
    static constexpr int RT = BLOCK_ROWS / TS;        // output tile rows
    static constexpr int CT = BLOCK_COLS / TS;        // output tile columns
    static constexpr int HT = TS < 4 ? 4 / TS : 1;    // halo tile columns a side
    static constexpr int ER = RT + 2;                 // tile rows read
    static constexpr int EC = CT + 2 * HT;            // tile columns read
    static constexpr int EQ = EC * TS / 4;            // quads across the read columns
    static constexpr int QT = TS < 4 ? 1 : TS / 4;    // quads a tile row
    static constexpr int ITEMS = ER * EQ;
    static constexpr int THREADS = (ITEMS + 31) / 32 * 32;
    static constexpr int SMEM = 2 * ER * EC * 4 + RT * CT * 5;
    static_assert(SMEM <= 48 * 1024, "static shared memory");
    static_assert(THREADS <= 1024, "threads a block");
};

__device__ __forceinline__ float min4(float4 v) {
    return fminf(fminf(v.x, v.y), fminf(v.z, v.w));
}

__device__ __forceinline__ float max4(float4 v) {
    return fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
}

__device__ __forceinline__ uint8_t trinary(float g, float thresh, bool low) {
    return low ? (uint8_t)127 : (g > thresh ? (uint8_t)255 : (uint8_t)0);
}

template <int TS, bool VEC>
__global__ void __launch_bounds__(Geom<TS>::THREADS)
threshold_kernel(const float* __restrict__ gray, uint8_t* __restrict__ out,
                 int H, int W, float min_diff) {
    using G = Geom<TS>;
    __shared__ float smin[G::ER][G::EC];
    __shared__ float smax[G::ER][G::EC];
    __shared__ float sthr[G::RT][G::CT];
    __shared__ uint8_t slow[G::RT][G::CT];

    const float inf = INFINITY;
    const int Ht = H / TS, Wt = W / TS;
    const int ty0 = blockIdx.y * G::RT, tx0 = blockIdx.x * G::CT;
    const size_t frame = (size_t)blockIdx.z * H * W;
    gray += frame;
    out += frame;

    // This thread's item: quad q of read tile row r. Its pixels lie in read
    // tile column ec (and ec + 1 at ts = 2, where a quad spans two tiles).
    const int item = threadIdx.x;
    const bool live = item < G::ITEMS;
    const int r = item / G::EQ, q = item % G::EQ;
    const int ec = TS < 4 ? 2 * q : q / G::QT;
    const int ty = ty0 - 1 + r;                      // tile row in the frame
    const int tx = tx0 - G::HT + ec;                 // tile column of the first half
    const int x = (tx0 - G::HT) * TS + 4 * q;        // first pixel column
    const bool row_ok = live && ty >= 0 && ty < Ht;
    const bool ok0 = row_ok && tx >= 0 && tx < Wt;
    const bool ok1 = TS < 4 ? row_ok && tx + 1 >= 0 && tx + 1 < Wt : ok0;

    float4 v[TS];
#pragma unroll
    for (int k = 0; k < TS; ++k) v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok0 || ok1) {
        const float* p = gray + (size_t)ty * TS * W + x;
#pragma unroll
        for (int k = 0; k < TS; ++k) {
            const float* pk = p + (size_t)k * W;
            if constexpr (VEC) {
                v[k] = *reinterpret_cast<const float4*>(pk);
            } else {
                if (ok0) { v[k].x = pk[0]; v[k].y = pk[1]; }
                if (ok1) { v[k].z = pk[2]; v[k].w = pk[3]; }
            }
        }
    }

    if constexpr (TS < 4) {
        float mn0 = fminf(v[0].x, v[0].y), mx0 = fmaxf(v[0].x, v[0].y);
        float mn1 = fminf(v[0].z, v[0].w), mx1 = fmaxf(v[0].z, v[0].w);
#pragma unroll
        for (int k = 1; k < TS; ++k) {
            mn0 = fminf(mn0, fminf(v[k].x, v[k].y));
            mx0 = fmaxf(mx0, fmaxf(v[k].x, v[k].y));
            mn1 = fminf(mn1, fminf(v[k].z, v[k].w));
            mx1 = fmaxf(mx1, fmaxf(v[k].z, v[k].w));
        }
        if (live) {
            smin[r][ec] = ok0 ? mn0 : inf;
            smax[r][ec] = ok0 ? mx0 : -inf;
            smin[r][ec + 1] = ok1 ? mn1 : inf;
            smax[r][ec + 1] = ok1 ? mx1 : -inf;
        }
    } else {
        float mn = min4(v[0]), mx = max4(v[0]);
#pragma unroll
        for (int k = 1; k < TS; ++k) {
            mn = fminf(mn, min4(v[k]));
            mx = fmaxf(mx, max4(v[k]));
        }
        if (!ok0) {
            mn = inf;
            mx = -inf;
        }
        // A tile's QT quads are QT adjacent lanes, aligned to QT (EQ is a
        // multiple of QT): every lane of the warp takes part.
#pragma unroll
        for (int s = 1; s < G::QT; s <<= 1) {
            mn = fminf(mn, __shfl_xor_sync(FULL, mn, s));
            mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, s));
        }
        if (live && q % G::QT == 0) {
            smin[r][ec] = mn;
            smax[r][ec] = mx;
        }
    }
    __syncthreads();

    // Output tile (ot, oc) is read tile (ot + 1, oc + HT).
    for (int i = threadIdx.x; i < G::RT * G::CT; i += G::THREADS) {
        const int ot = i / G::CT, oc = i % G::CT;
        float mn = inf, mx = -inf;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
                mn = fminf(mn, smin[ot + dy][oc + G::HT + dx]);
                mx = fmaxf(mx, smax[ot + dy][oc + G::HT + dx]);
            }
        }
        const float contrast = __fsub_rn(mx, mn);
        sthr[ot][oc] = __fadd_rn(mn, __fmul_rn(contrast, 0.5f));
        slow[ot][oc] = contrast < min_diff;
    }
    __syncthreads();

    const bool mine = row_ok && r >= 1 && r <= G::RT && ec >= G::HT && ec < G::HT + G::CT;
    if (!mine || !(ok0 || ok1)) return;
    const int ot = r - 1, oc = ec - G::HT;
    const float t0 = sthr[ot][oc];
    const bool l0 = slow[ot][oc];
    const float t1 = TS < 4 ? sthr[ot][oc + 1] : t0;
    const bool l1 = TS < 4 ? slow[ot][oc + 1] : l0;
    uint8_t* o = out + (size_t)ty * TS * W + x;
#pragma unroll
    for (int k = 0; k < TS; ++k) {
        const uchar4 c = make_uchar4(trinary(v[k].x, t0, l0), trinary(v[k].y, t0, l0),
                                     trinary(v[k].z, t1, l1), trinary(v[k].w, t1, l1));
        uint8_t* dst = o + (size_t)k * W;
        if constexpr (VEC) {
            *reinterpret_cast<uchar4*>(dst) = c;
        } else {
            if (ok0) { dst[0] = c.x; dst[1] = c.y; }
            if (ok1) { dst[2] = c.z; dst[3] = c.w; }
        }
    }
}

template <int TS, bool VEC>
int launch(const float* gray, uint8_t* out, int B, int H, int W, int min_diff,
           cudaStream_t stream) {
    using G = Geom<TS>;
    const dim3 grid((W / TS + G::CT - 1) / G::CT, (H / TS + G::RT - 1) / G::RT, B);
    threshold_kernel<TS, VEC><<<grid, G::THREADS, 0, stream>>>(gray, out, H, W,
                                                                (float)min_diff);
    return (int)cudaGetLastError();
}

template <int TS>
int dispatch(const void* gray, void* out, int B, int H, int W, int min_diff,
             cudaStream_t stream) {
    const bool vec = (uintptr_t)gray % 16 == 0 && (uintptr_t)out % 4 == 0 && W % 4 == 0;
    return vec ? launch<TS, true>((const float*)gray, (uint8_t*)out, B, H, W, min_diff, stream)
               : launch<TS, false>((const float*)gray, (uint8_t*)out, B, H, W, min_diff, stream);
}

}  // namespace

extern "C" int apriltag_threshold(const void* gray, void* out, int B, int H, int W,
                                  int ts, int min_diff, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (ts) {
        case 2: return dispatch<2>(gray, out, B, H, W, min_diff, s);
        case 4: return dispatch<4>(gray, out, B, H, W, min_diff, s);
        case 8: return dispatch<8>(gray, out, B, H, W, min_diff, s);
        case 16: return dispatch<16>(gray, out, B, H, W, min_diff, s);
        case 32: return dispatch<32>(gray, out, B, H, W, min_diff, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
