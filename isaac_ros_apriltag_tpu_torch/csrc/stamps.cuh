// Step stamps of a kernel for torch_stamp_split.py, compiled in only with
// -DKERNEL_STAMPS (that script builds a source alone with it): thread 0 of
// block b < STAMP_BLOCKS (b = blockIdx.y gridDim.x + blockIdx.x) records
// (%globaltimer, clock64) at step k into kernel_stamps[b][k] once `anchor`
// (an int or float the step computes) is known; apriltag_read_stamps copies
// the table out and apriltag_clear_stamps zeroes it. Without the flag a
// stamp is nothing, so the package's kernels carry no instrumentation.

#pragma once

#ifdef KERNEL_STAMPS
constexpr int STAMP_BLOCKS = 8192, STAMP_STEPS = 8;
__device__ long long kernel_stamps[STAMP_BLOCKS][STAMP_STEPS][2];
#define STAMP(k, anchor)                                                              \
    do {                                                                              \
        asm volatile("" ::"r"((int)(anchor)));                                        \
        const unsigned b_ = blockIdx.y * gridDim.x + blockIdx.x;                      \
        if (threadIdx.x == 0 && b_ < STAMP_BLOCKS) {                                  \
            long long g_;                                                             \
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));                    \
            kernel_stamps[b_][k][0] = g_;                                             \
            kernel_stamps[b_][k][1] = clock64();                                      \
        }                                                                             \
    } while (0)
extern "C" int apriltag_read_stamps(void* out) {
    return (int)cudaMemcpyFromSymbol(out, kernel_stamps, sizeof(kernel_stamps));
}
extern "C" int apriltag_clear_stamps() {
    void* p = nullptr;
    const cudaError_t e = cudaGetSymbolAddress(&p, kernel_stamps);
    return (int)(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(kernel_stamps)));
}
#else
#define STAMP(k, anchor) \
    do {                 \
    } while (0)
#endif
