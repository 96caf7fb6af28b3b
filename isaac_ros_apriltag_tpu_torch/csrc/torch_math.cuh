// Device helpers with torch's float semantics, shared by quadfit.cu and
// tail.cu so that both kernels keep one bit-exact contract with their plain
// versions: NaN tests, clamps that pass NaN through as torch.clamp does,
// torch.maximum's NaN rule, and utils/geometry.py::line_intersection.
//
// Every helper is static inline, so each source that includes this header
// gets its own copy and the link sees no duplicate symbol.

#pragma once

#include <cmath>

static __device__ __forceinline__ bool is_nan(float v) { return v != v; }
static __device__ __forceinline__ bool is_finite(float v) { return fabsf(v) < INFINITY; }
static __device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return min(max(v, lo), hi);
}
// torch.clamp(v, min=lo): NaN passes through.
static __device__ __forceinline__ float clamp_min(float v, float lo) {
    return is_nan(v) ? v : (v < lo ? lo : v);
}
// torch.clamp(v, lo, hi): min(max(v, lo), hi), NaN passes through.
static __device__ __forceinline__ float clamp_lo_hi(float v, float lo, float hi) {
    if (is_nan(v)) return v;
    v = v < lo ? lo : v;
    return v > hi ? hi : v;
}
// torch.maximum: NaN if either is NaN.
static __device__ __forceinline__ float nan_max(float a, float b) {
    return is_nan(a) || is_nan(b) ? a + b : (a > b ? a : b);
}

// utils/geometry.py::line_intersection of the lines (p1, d1) and (p2, d2);
// a parallel pair gives the midpoint of p1 and p2.
static __device__ __forceinline__ void intersect(float p1x, float p1y, float d1x, float d1y,
                                                 float p2x, float p2y, float d2x, float d2y,
                                                 float& x, float& y) {
    const float det = d1x * (-d2y) - (-d2x) * d1y;
    const float rx = p2x - p1x, ry = p2y - p1y;
    const bool degenerate = fabsf(det) < 1e-9f;
    const float t = (rx * (-d2y) - (-d2x) * ry) / (degenerate ? 1.0f : det);
    x = degenerate ? 0.5f * (p1x + p2x) : p1x + t * d1x;
    y = degenerate ? 0.5f * (p1y + p2y) : p1y + t * d1y;
}
