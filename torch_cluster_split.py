#!/usr/bin/env python3
"""Where the time of the cluster stage's pair count and moments kernels
goes, in their PR 12-21 forms, on the inputs a detect call gives them.

    python3 torch_cluster_split.py [--out FILE]

Builds SOURCE below (copies of csrc/cluster_moments.cu's
cm_edge_count_kernel and cm_moments_kernel as they stood before PR 22,
the moments kernel with timestamps) and prints one JSON line: the card's
nvidia-smi name and power limit, and for chip_smoke.py's 720p b1 and bench
b8 inputs and its "1080p b1, quad_decimate 1" frame:
- the count: device ms of the form with one atomic a block and of the same
  kernel storing its block sums (no atomic), the bytes it must move and
  the achieved rate;
- the moments kernel: its device ms, resident blocks an SM, the slots'
  resident pair counts (largest, median, mean of the nonzero slots), and,
  from %globaltimer and clock64 stamps of thread 0 in each block, each
  part's time (the slot prefix, zeroing the tables, pass 1, the centroid,
  pass 2, the table sum): mean and largest over blocks and for the largest
  slot's block; when the blocks start (a second wave) and end;
- the PR 22 moments kernel's work split on the same slots (numpy, from the
  slots' resident pairs): the 8-warp blocks a frame and the warps in all
  for pairs a warp `per` 64, 96 and 128, the warps a slot rounded up or
  down to a power of two.
Without a CUDA device it exits 1 and prints nothing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CASES = ("tag36h11-720p-node b1", "tag36h11-1080p-batch b8", "1080p b1, quad_decimate 1")
ITERS = 50
NSTAMP = 8   # stamps a block: entry, prefix, zeroed, first barrier, pass 1, centroid, pass 2, sum

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int KMAX = (1 << 15) - 1;
constexpr int NBINS = 64, NQ = 6;
constexpr int MOM_THREADS = 256, MOM_WARPS = MOM_THREADS / 32;
constexpr int PIX_THREADS = 256;
constexpr int NSTAMP = 8;

__device__ __forceinline__ long long gtime() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ bool pair_mask(const uint8_t* tri, const int32_t* dense, int H, int W,
                                          int y, int x, int v0, int32_t d0, int dx, int dy) {
    const int ny = y + dy, nx = x + dx;
    const bool in = nx >= 0 && nx < W && ny < H;
    const int v1 = in ? tri[(size_t)ny * W + nx] : 127;
    const int32_t d1 = in ? dense[(size_t)ny * W + nx] : KMAX;
    return v0 + v1 == 255 && d0 != KMAX && d1 != KMAX;
}

// The PR 12 pair count; ATOMIC false stores the block's sum in place of its atomic.
template <bool ATOMIC>
__global__ void __launch_bounds__(PIX_THREADS)
count_kernel(const uint8_t* __restrict__ tri, const int32_t* __restrict__ dense,
             int32_t* __restrict__ out, int H, int W) {
    const int b = blockIdx.y, HW = H * W;
    tri += (size_t)b * HW;
    dense += (size_t)b * HW;
    const int p = blockIdx.x * PIX_THREADS + threadIdx.x;
    int c = 0;
    if (p < HW) {
        const int y = p / W, x = p - y * W;
        const int v0 = tri[p];
        const int32_t d0 = dense[p];
        c += pair_mask(tri, dense, H, W, y, x, v0, d0, 1, 0);
        c += pair_mask(tri, dense, H, W, y, x, v0, d0, 0, 1);
        c += pair_mask(tri, dense, H, W, y, x, v0, d0, -1, 1);
        c += pair_mask(tri, dense, H, W, y, x, v0, d0, 1, 1);
    }
    __shared__ int warp_sum[PIX_THREADS / 32];
    c = __reduce_add_sync(FULL, c);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = c;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < PIX_THREADS / 32; ++w) c += warp_sum[w];
        if (ATOMIC) {
            if (c) atomicAdd(out + b, c);
        } else {
            out[gridDim.y + (size_t)b * gridDim.x + blockIdx.x] = c;
        }
    }
}

__device__ __forceinline__ void pair_terms(int32_t pv, float& x, float& y, float& gx, float& gy) {
    x = __fmul_rn((float)(pv & 0xFFF), 0.5f);
    y = __fmul_rn((float)((pv >> 12) & 0xFFF), 0.5f);
    const int gp = pv >> 24;
    gx = (float)((gp & 0x3) - 1);
    gy = (float)(((gp >> 2) & 0x3) - 1);
}

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

// The PR 16 moments kernel; with STAMP, thread 0 writes NSTAMP (globaltimer,
// clock64) pairs a block into stamps[(b, j)] and its SM into sm[(b, j)].
template <bool STAMP>
__global__ void __launch_bounds__(MOM_THREADS)
moments_kernel(const int32_t* __restrict__ pay_s, const int32_t* __restrict__ top_pos,
               const int32_t* __restrict__ count, float* __restrict__ table,
               float* __restrict__ centroid, float* __restrict__ scale,
               uint8_t* __restrict__ dark, long long* __restrict__ stamps,
               int32_t* __restrict__ sm, int row, int C, int E2) {
    __shared__ double wt[MOM_WARPS][NBINS * NQ];
    __shared__ float stage[MOM_WARPS][32][NQ];
    __shared__ double part[MOM_WARPS][7];
    __shared__ float s_cx, s_cy, s_inv;
    __shared__ int s_n, s_p;
    const int j = blockIdx.x, b = blockIdx.y, t = threadIdx.x, lane = t & 31, w = t >> 5;
    const size_t slot = (size_t)b * C + j;
    long long* st = stamps + slot * 2 * NSTAMP;
#define STAMP_AT(k) if (STAMP && t == 0) { st[2 * (k)] = gtime(); st[2 * (k) + 1] = clock64(); }
    STAMP_AT(0)
    if (STAMP && t == 0) {
        unsigned s;
        asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
        sm[slot] = (int)s;
    }
    if (w == 0) {
        int o = 0;
        for (int k = lane; k < j; k += 32) o += count[(size_t)b * C + k];
        o = __reduce_add_sync(FULL, o);
        if (lane == 0) {
            s_n = max(0, min(count[slot], E2 - o));
            s_p = top_pos[slot];
        }
    }
    STAMP_AT(1)
    for (int c = t; c < MOM_WARPS * NBINS * NQ; c += MOM_THREADS) (&wt[0][0])[c] = 0.0;
    STAMP_AT(2)
    __syncthreads();
    STAMP_AT(3)
    const int n = s_n;
    const int32_t* py = pay_s + (size_t)b * row + s_p;
    double acc[7] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    for (int i = t; i < n; i += MOM_THREADS) {
        float x, y, gx, gy;
        pair_terms(py[i], x, y, gx, gy);
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
    STAMP_AT(4)
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
    STAMP_AT(5)
    const float cx = s_cx, cy = s_cy, inv = s_inv;
    for (int base = 0; base < n; base += MOM_THREADS) {
        const int i = base + t;
        int bin = NBINS;
        if (i < n) {
            float x, y, gx, gy;
            pair_terms(py[i], x, y, gx, gy);
            const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy);
            bin = diamond_bin(dx, dy);
            const float sx = __fmul_rn(dx, inv), sy = __fmul_rn(dy, inv);
            float* sg = stage[w][lane];
            sg[0] = 1.0f;
            sg[1] = sx;
            sg[2] = sy;
            sg[3] = __fmul_rn(sx, sx);
            sg[4] = __fmul_rn(sx, sy);
            sg[5] = __fmul_rn(sy, sy);
        }
        __syncwarp();
        const unsigned grp = __match_any_sync(FULL, bin);
        if (bin < NBINS && lane == __ffs(grp) - 1) {
            double* cell = wt[w] + bin * NQ;
            for (unsigned m = grp; m; m &= m - 1) {
                const float* sg = stage[w][__ffs(m) - 1];
#pragma unroll
                for (int q = 0; q < NQ; ++q) cell[q] = __dadd_rn(cell[q], (double)sg[q]);
            }
        }
        __syncwarp();
    }
    __syncthreads();
    STAMP_AT(6)
    float* out = table + slot * NBINS * NQ;
    for (int c = t; c < NBINS * NQ; c += MOM_THREADS) {
        double s = wt[0][c];
        for (int u = 1; u < MOM_WARPS; ++u) s = __dadd_rn(s, wt[u][c]);
        out[c] = __double2float_rn(s);
    }
    __syncthreads();
    STAMP_AT(7)
#undef STAMP_AT
}

}  // namespace

extern "C" int split_count(const void* tri, const void* dense, void* out, int B, int H, int W,
                           int atomic, void* stream) {
    const dim3 grid((H * W + PIX_THREADS - 1) / PIX_THREADS, B);
    if (atomic)
        count_kernel<true><<<grid, PIX_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)tri, (const int32_t*)dense, (int32_t*)out, H, W);
    else
        count_kernel<false><<<grid, PIX_THREADS, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)tri, (const int32_t*)dense, (int32_t*)out, H, W);
    return (int)cudaGetLastError();
}

extern "C" int split_moments(const void* pay_s, const void* top_pos, const void* count,
                             void* table, void* centroid, void* scale, void* dark, void* stamps,
                             void* sm, int B, int row, int C, int E2, int stamp, void* stream) {
    const dim3 grid(C, B);
    auto kernel = stamp ? moments_kernel<true> : moments_kernel<false>;
    kernel<<<grid, MOM_THREADS, 0, (cudaStream_t)stream>>>(
        (const int32_t*)pay_s, (const int32_t*)top_pos, (const int32_t*)count, (float*)table,
        (float*)centroid, (float*)scale, (uint8_t*)dark, (long long*)stamps, (int32_t*)sm, row, C,
        E2);
    return (int)cudaGetLastError();
}

// Resident blocks an SM of the moments kernel (without stamps) and of the count.
extern "C" int split_occupancy(int* moments, int* count) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(moments, moments_kernel<false>,
                                                                  MOM_THREADS, 0);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(count, count_kernel<true>, PIX_THREADS,
                                                          0);
    return (int)e;
}
"""


def build(out_dir: str) -> ctypes.CDLL:
    """SOURCE compiled by nvcc with the package's flags into out_dir."""
    from isaac_ros_apriltag_tpu_torch.ops.cuda import _lib

    os.makedirs(out_dir, exist_ok=True)
    src, lib = os.path.join(out_dir, "split.cu"), os.path.join(out_dir, "libsplit.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_lib._nvcc(), *_lib.NVCC_FLAGS, "-shared", src, "-o", lib], check=True,
                   capture_output=True, text=True)
    so = ctypes.CDLL(lib)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    so.split_count.argtypes = [vp] * 3 + [ci] * 4 + [vp]
    so.split_moments.argtypes = [vp] * 9 + [ci] * 5 + [vp]
    so.split_occupancy.argtypes = [ctypes.POINTER(ci)] * 2
    for fn in (so.split_count, so.split_moments, so.split_occupancy):
        fn.restype = ci
    return so


def _check(status: int, what: str) -> None:
    if status:
        raise RuntimeError(f"{what}: cudaError {status}")


def stage_inputs(cfg, images):
    """The count's and the moments kernel's inputs of a detect call on the
    card: (tri, dense, pay rows, top_pos, count, E2)."""
    from isaac_ros_apriltag_tpu_torch.ops.cuda import cluster_moments as cmk

    from chip_smoke import cluster_inputs

    tri, dense, ovf, kw = cluster_inputs(cfg, images)
    B, H, W = tri.shape
    E = min(kw["max_edge_points"], 4 * H * W)
    E2 = min(cfg.max_clusters * cfg.max_cluster_points, E)
    ne = cmk.edge_count(tri, dense)
    rows, _ = cmk.sort_pairs(tri, dense, ne, E)
    seg = cmk.top_segments(rows.key, ne, ovf, E=E, E2=E2, max_clusters=cfg.max_clusters,
                           min_cluster_pixels=cfg.min_cluster_pixels, max_perimeter=4 * (W + H))
    return tri, dense, rows.pay, seg.top_pos, seg.count, E2


def resident(count, E2: int) -> np.ndarray:
    """(B, C) resident pairs a slot: its count cut at E2 less the slots before it."""
    c = count.cpu().numpy().astype(np.int64)
    start = np.cumsum(c, -1) - c
    return np.minimum(np.clip(E2 - start, 0, None), c)


def packing(n: np.ndarray, per: int, down: bool) -> tuple[int, int]:
    """(8-warp blocks, warps) of the PR 22 moments kernel's split of one
    frame's (C,) resident pairs: ceil(n / per) warps a slot, rounded to a
    power of two (at most 8), slots packed in order when the warps never
    grow, else a block a slot."""
    k = np.maximum(1, -(-n // per))
    p2 = np.floor(np.log2(k)) if down else np.ceil(np.log2(k))
    w = np.minimum(8, 2 ** p2).astype(np.int64)
    if (np.diff(w) <= 0).all():
        return int(-(-w.sum() // 8)), int(w.sum())
    return int(n.size), int(w.sum())


def packings(count, E2: int) -> dict:
    n = resident(count, E2)
    out = {}
    for per in (64, 96, 128):
        for down in (False, True):
            got = [packing(f, per, down) for f in n]
            out[f"{per} {'down' if down else 'up'}"] = dict(
                blocks=sum(g[0] for g in got), warps=sum(g[1] for g in got))
    return out


def count_split(so, tri, dense) -> dict:
    import torch

    from chip_smoke import HBM_BYTES_PER_S, _device_ms

    B, H, W = tri.shape
    nblk = -(-H * W // 256)
    out = torch.zeros(B + B * nblk, dtype=torch.int32, device=tri.device)
    stream = torch.cuda.current_stream().cuda_stream

    def run(atomic: int):
        return lambda: _check(so.split_count(tri.data_ptr(), dense.data_ptr(), out.data_ptr(),
                                             B, H, W, atomic, stream), "split_count")

    ms = {"atomic": _device_ms(run(1), ITERS), "no_atomic": _device_ms(run(0), ITERS)}
    ms["atomic_again"] = _device_ms(run(1), ITERS)
    nbytes = 5 * B * H * W + 4 * B
    return dict(ms=ms, blocks=B * nblk, atomics_a_frame=nblk, bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                gb_per_s=nbytes / (ms["atomic"] * 1e-3) / 1e9,
                atomic_share=(ms["atomic"] - ms["no_atomic"]) / ms["atomic"])


def moments_split(so, pay, top_pos, count, E2: int) -> dict:
    import torch

    from chip_smoke import _device_ms

    B, row = pay.shape
    C = count.shape[1]
    dev = pay.device
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [torch.empty((B, C, 64, 6), **f32), torch.empty((B, C, 2), **f32),
            torch.empty((B, C), **f32), torch.empty((B, C), dtype=torch.uint8, device=dev)]
    stamps = torch.zeros((B, C, NSTAMP, 2), dtype=torch.int64, device=dev)
    sm = torch.zeros((B, C), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run(stamp: int):
        return lambda: _check(so.split_moments(
            pay.data_ptr(), top_pos.data_ptr(), count.data_ptr(), *(o.data_ptr() for o in outs),
            stamps.data_ptr(), sm.data_ptr(), B, row, C, E2, stamp, stream), "split_moments")

    ms = {"plain_copy": _device_ms(run(0), ITERS), "stamped": _device_ms(run(1), ITERS)}
    run(1)()
    torch.cuda.synchronize()
    st = stamps.cpu().numpy().reshape(B * C, NSTAMP, 2)
    g, clk = st[..., 0].astype(np.float64), st[..., 1].astype(np.float64)
    life_ns = g[:, -1] - g[:, 0]
    life_clk = clk[:, -1] - clk[:, 0]
    long_lived = life_ns > 2000
    ghz = float(np.median(life_clk[long_lived] / life_ns[long_lived])) if long_lived.any() else None
    # Parts in microseconds from clock64 (one SM's clock), at the blocks' own rate.
    parts = np.diff(clk, axis=1) / (ghz or 1.0) / 1e3
    names = ("prefix", "zero", "barrier", "pass1", "centroid", "pass2", "table_sum")
    n = resident(count, E2).reshape(-1)
    big = int(np.argmax(n))
    t0 = g[:, 0].min()
    starts, ends = (g[:, 0] - t0) / 1e3, (g[:, -1] - t0) / 1e3
    first_end = ends.min()
    occ_m, occ_c = ctypes.c_int(), ctypes.c_int()
    _check(so.split_occupancy(ctypes.byref(occ_m), ctypes.byref(occ_c)), "split_occupancy")
    nz = n[n > 0]
    return dict(
        ms=ms, blocks=B * C, resident_blocks_per_sm=occ_m.value,
        count_resident_blocks_per_sm=occ_c.value, sm_ghz=ghz,
        slots=dict(nonzero=int(nz.size), largest=int(n.max()),
                   median=float(np.median(nz)) if nz.size else 0.0,
                   mean=float(nz.mean()) if nz.size else 0.0,
                   per_frame=[int(v) for v in n.reshape(B, C).sum(-1)],
                   largest_8=[int(v) for v in np.sort(n)[::-1][:8]]),
        parts_us={k: dict(mean=float(parts[:, i].mean()), max=float(parts[:, i].max()),
                          largest_slot=float(parts[big, i]))
                  for i, k in enumerate(names)},
        life_us=dict(mean=float(life_ns.mean() / 1e3), max=float(life_ns.max() / 1e3),
                     largest_slot=float(life_ns[big] / 1e3)),
        span_us=float(ends.max()), largest_slot_end_us=float(ends[big]),
        later_wave_blocks=int((starts > first_end).sum()),
        last_start_us=float(starts.max()), sms_used=int(np.unique(sm.cpu().numpy()).size))


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, help="also write the JSON line here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_cluster_split: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import _gpu_info, cluster_cases

    dev = torch.device("cuda")
    so = build(os.path.join(ROOT, "isaac_ros_apriltag_tpu_torch", "_build", "split"))
    cases = cluster_cases(dev)
    out = {"gpu": _gpu_info()}
    for name in CASES:
        cfg, images = cases[name]
        tri, dense, pay, top_pos, count, E2 = stage_inputs(cfg, images)
        out[name] = dict(shape=list(tri.shape), E2=E2, count=count_split(so, tri, dense),
                         moments=moments_split(so, pay, top_pos, count, E2),
                         packing=packings(count, E2))
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
