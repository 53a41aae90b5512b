// Linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t along
// the sequence axis of a, b (B, S, W), from h0 (B, W); everything fp32.
//
// Replaces the TPU kernel repro/kernels/linear_recurrence/linear_recurrence.py
// ::linear_recurrence (_kernel), the scan of the RG-LRU (recurrentgemma).
// The Pallas kernel walks S in chunks along a sequential grid axis and scans
// each chunk by doubling, because the TPU's vector unit wants wide
// elementwise passes; its h carry lives in VMEM scratch between grid steps.
// Here there is no sequential grid axis: each thread owns one (b, w)
// channel, carries h in a register and walks all S steps itself.  It takes
// any S >= 1 and W >= 1 (the TPU kernel needs S and W to divide its blocks).
//
// What bounds it on the H100: bytes.  Each step reads a and b and writes h,
// 12 bytes per element and 2 FLOPs: at the measure shape (1, 512, 2560)
// that is 15.7 MB, 4.7 us at 3.35 TB/s.  This design does not reach that:
// at B = 1 only W = 2560 threads (20 blocks on 132 SMs) walk S in sequence,
// so the time is S / U round trips to memory, each as long as the latency
// of a load, not the rate of the memory.  To hide part of that latency a
// thread keeps the next chunk of U timesteps' loads in flight while it runs
// the multiply-adds of the current one.  Splitting S across blocks (per-
// chunk (A, B) aggregates, a carry pass, a fix-up pass) is the next step,
// queued in ROADMAP.md.
//
// Loads and stores are coalesced: neighbouring threads own neighbouring w.

#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int NTHREADS = 128;  // channels per block
constexpr int U = 16;          // timesteps per register chunk

// Load steps [t, t + n) of one channel into registers; steps past n are
// the identity (a = 1, b = 0).
__device__ __forceinline__ void load_chunk(float (&ra)[U], float (&rb)[U],
                                           const float* __restrict__ a,
                                           const float* __restrict__ b, size_t off,
                                           int W, int n) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
        if (u < n) {
            ra[u] = __ldcs(a + off + size_t(u) * W);
            rb[u] = __ldcs(b + off + size_t(u) * W);
        } else {
            ra[u] = 1.f;
            rb[u] = 0.f;
        }
    }
}

__global__ void __launch_bounds__(NTHREADS)
linear_recurrence_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         const float* __restrict__ h0, float* __restrict__ h, int S,
                         int W) {
    const int w = blockIdx.x * NTHREADS + threadIdx.x;
    const int bi = blockIdx.y;
    if (w >= W) return;
    const size_t base = size_t(bi) * S * W + w;
    float hv = h0[size_t(bi) * W + w];

    float ca[U], cb[U], na[U], nb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        na[u] = 1.f;
        nb[u] = 0.f;
    }
    load_chunk(ca, cb, a, b, base, W, min(U, S));
    for (int t0 = 0; t0 < S; t0 += U) {
        const int n = min(U, S - t0);
        const int t1 = t0 + U;
        // the next chunk's loads go out before this chunk's multiply-adds
        if (t1 < S) load_chunk(na, nb, a, b, base + size_t(t1) * W, W, min(U, S - t1));
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (u < n) {
                hv = fmaf(ca[u], hv, cb[u]);
                __stcs(h + base + size_t(t0 + u) * W, hv);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            ca[u] = na[u];
            cb[u] = nb[u];
        }
    }
}

}  // namespace
}  // namespace repro_torch

// Launcher with a plain C interface (bound through ctypes).  Returns the
// CUDA status of the launch; 0 is success.
extern "C" int linear_recurrence_f32(const void* a, const void* b, const void* h0, void* h,
                                     int B, int S, int W, void* stream) {
    if (B < 1 || S < 1 || W < 1 || B > 65535) return int(cudaErrorInvalidValue);
    const dim3 grid((W + repro_torch::NTHREADS - 1) / repro_torch::NTHREADS, B);
    repro_torch::linear_recurrence_kernel<<<grid, repro_torch::NTHREADS, 0,
                                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(h0), static_cast<float*>(h), S, W);
    return int(cudaGetLastError());
}
