// Linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t along
// the sequence axis of a, b (B, S, W), from h0 (B, W); everything fp32.
//
// Replaces the TPU kernel repro/kernels/linear_recurrence/linear_recurrence.py
// ::linear_recurrence (_kernel), the scan of the RG-LRU (recurrentgemma).
// The Pallas kernel walks S in chunks along a sequential grid axis and scans
// each chunk by doubling, because the TPU's vector unit wants wide
// elementwise passes; its h carry lives in VMEM scratch between grid steps.
// Here blocks run in no order, so the carry crosses chunks in a second
// pass.  It takes any S >= 1 and W >= 1 (the TPU kernel needs S and W to
// divide its blocks).
//
// What bounds it on the H100: bytes, if enough of them are in flight.
// Each step reads a and b and writes h, 12 bytes per element and 2 FLOPs:
// at the measure shape (1, 512, 2560) that is 15.7 MB, 4.7 us at 3.35
// TB/s.  One thread per (b, w) channel walking all S steps puts only W =
// 2560 threads on the card at B = 1 (20 blocks on 132 SMs), each waiting
// one load round trip per few steps: ~0.3 TB/s.
//
// Split-S.  The wrapper cuts S into n_chunks chunks of `chunk` steps, from
// the shapes alone (about three blocks per SM, chunks of at least 32
// steps), and the kernels run on a grid of (W / 128, chunk, B):
//   * pass 1 (linear_recurrence_aggregate_kernel), on every chunk but the
//     last, scans its chunk from h = 0 and writes the chunk's aggregate:
//     A_c = prod a_t and B_c = the scan's last h, so the chunk maps h to
//     A_c * h + B_c;
//   * pass 2 (linear_recurrence_kernel) folds the aggregates of the chunks
//     before its own into h0, issuing those loads together, and scans its
//     chunk again from that h, writing h.
// The algebra is the Pallas kernel's within a chunk (h = A * h_carry + B),
// carried across blocks.  A_c may underflow to 0 for small a; that is
// exact here (no division, unlike a cumprod/cumsum closed form).  Padded
// steps (a = 1, b = 0) stay the identity.  a and b are read twice, 20
// bytes per element against the one-pass 12 (pass 1's reads go through
// the L2 cache, where pass 2 may find them).  With one chunk (S = 1 in
// decode, or when B * W / 128 blocks already fill the card) only pass 2
// runs, which is then the single-pass scan from h0.
//
// Within a chunk each thread keeps the next U timesteps' loads in flight
// while it runs the multiply-adds of the current ones.  Loads and stores
// are coalesced: neighbouring threads own neighbouring w.

#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int NTHREADS = 128;  // channels per block
constexpr int U = 16;          // timesteps per register chunk
constexpr int CARRY = 16;      // chunk aggregates loaded together in pass 2

// Load steps [0, n) of one channel from `off` into registers, through the
// L2 cache (STREAM false) or marked evict-first (STREAM true); steps past
// n are the identity (a = 1, b = 0).
template <bool STREAM>
__device__ __forceinline__ void load_chunk(float (&ra)[U], float (&rb)[U],
                                           const float* __restrict__ a,
                                           const float* __restrict__ b, size_t off,
                                           int W, int n) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
        if (u < n) {
            ra[u] = STREAM ? __ldcs(a + off + size_t(u) * W) : __ldg(a + off + size_t(u) * W);
            rb[u] = STREAM ? __ldcs(b + off + size_t(u) * W) : __ldg(b + off + size_t(u) * W);
        } else {
            ra[u] = 1.f;
            rb[u] = 0.f;
        }
    }
}

// Scan n >= 1 steps of one channel, the first at `base`, from hv; returns
// the last h.  AGGREGATE: nothing is stored and `prod` gathers prod a_t;
// else each h_t is stored to h.
template <bool AGGREGATE>
__device__ __forceinline__ float scan_steps(const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            float* __restrict__ h, size_t base, int W, int n,
                                            float hv, float& prod) {
    float ca[U], cb[U], na[U], nb[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        na[u] = 1.f;
        nb[u] = 0.f;
    }
    load_chunk<!AGGREGATE>(ca, cb, a, b, base, W, min(U, n));
    for (int t0 = 0; t0 < n; t0 += U) {
        const int m = min(U, n - t0);
        const int t1 = t0 + U;
        // the next register chunk's loads go out before this one's multiply-adds
        if (t1 < n) load_chunk<!AGGREGATE>(na, nb, a, b, base + size_t(t1) * W, W, min(U, n - t1));
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (u < m) {
                hv = fmaf(ca[u], hv, cb[u]);
                if (AGGREGATE)
                    prod *= ca[u];
                else
                    __stcs(h + base + size_t(t0 + u) * W, hv);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            ca[u] = na[u];
            cb[u] = nb[u];
        }
    }
    return hv;
}

// Pass 1: chunk c = blockIdx.y of row blockIdx.z (every chunk but the
// last) writes its aggregate at agg_a/agg_b[(row * n_chunks + c) * W + w].
__global__ void __launch_bounds__(NTHREADS)
linear_recurrence_aggregate_kernel(const float* __restrict__ a, const float* __restrict__ b,
                                   float* __restrict__ agg_a, float* __restrict__ agg_b, int S,
                                   int W, int chunk, int n_chunks) {
    const int w = blockIdx.x * NTHREADS + threadIdx.x;
    const int c = blockIdx.y, bi = blockIdx.z;
    if (w >= W) return;
    const size_t base = (size_t(bi) * S + size_t(c) * chunk) * W + w;
    float prod = 1.f;
    const float hv = scan_steps<true>(a, b, nullptr, base, W, chunk, 0.f, prod);
    const size_t out = (size_t(bi) * n_chunks + c) * W + w;
    agg_a[out] = prod;
    agg_b[out] = hv;
}

// Pass 2: chunk c = blockIdx.y of row blockIdx.z carries h0 across the
// aggregates of chunks 0 .. c - 1, then scans its own steps and writes h.
__global__ void __launch_bounds__(NTHREADS)
linear_recurrence_kernel(const float* __restrict__ a, const float* __restrict__ b,
                         const float* __restrict__ h0, float* __restrict__ h,
                         const float* __restrict__ agg_a, const float* __restrict__ agg_b,
                         int S, int W, int chunk, int n_chunks) {
    const int w = blockIdx.x * NTHREADS + threadIdx.x;
    const int c = blockIdx.y, bi = blockIdx.z;
    if (w >= W) return;
    float hv = h0[size_t(bi) * W + w];
    const size_t agg = size_t(bi) * n_chunks * W + w;
    for (int c0 = 0; c0 < c; c0 += CARRY) {
        float ra[CARRY], rb[CARRY];
#pragma unroll
        for (int j = 0; j < CARRY; ++j) {
            const bool in = c0 + j < c;
            ra[j] = in ? agg_a[agg + size_t(c0 + j) * W] : 1.f;
            rb[j] = in ? agg_b[agg + size_t(c0 + j) * W] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < CARRY; ++j) hv = fmaf(ra[j], hv, rb[j]);
    }
    const int t0 = c * chunk;
    float unused = 1.f;
    scan_steps<false>(a, b, h, (size_t(bi) * S + t0) * W + w, W, min(chunk, S - t0), hv,
                      unused);
}

}  // namespace
}  // namespace repro_torch

// Launcher with a plain C interface (bound through ctypes).  Returns the
// CUDA status of its launches; 0 is success.  agg_a, agg_b: B * n_chunks *
// W floats each (unused, and may be null, when n_chunks is 1).  The chunks
// must cover S and every one of them hold a step: chunk * (n_chunks - 1) <
// S <= chunk * n_chunks.
extern "C" int linear_recurrence_f32(const void* a, const void* b, const void* h0, void* h,
                                     void* agg_a, void* agg_b, int B, int S, int W, int chunk,
                                     int n_chunks, void* stream) {
    if (B < 1 || S < 1 || W < 1 || B > 65535 || chunk < 1 || n_chunks < 1 ||
        n_chunks > 65535 || size_t(chunk) * (n_chunks - 1) >= size_t(S) ||
        size_t(chunk) * n_chunks < size_t(S) || (n_chunks > 1 && (!agg_a || !agg_b)))
        return int(cudaErrorInvalidValue);
    using repro_torch::NTHREADS;
    const int wb = (W + NTHREADS - 1) / NTHREADS;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* pa = static_cast<const float*>(a);
    const float* pb = static_cast<const float*>(b);
    float* ga = static_cast<float*>(agg_a);
    float* gb = static_cast<float*>(agg_b);
    if (n_chunks > 1) {
        repro_torch::linear_recurrence_aggregate_kernel<<<dim3(wb, n_chunks - 1, B), NTHREADS,
                                                          0, st>>>(pa, pb, ga, gb, S, W, chunk,
                                                                   n_chunks);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return int(err);
    }
    repro_torch::linear_recurrence_kernel<<<dim3(wb, n_chunks, B), NTHREADS, 0, st>>>(
        pa, pb, static_cast<const float*>(h0), static_cast<float*>(h), ga, gb, S, W, chunk,
        n_chunks);
    return int(cudaGetLastError());
}
