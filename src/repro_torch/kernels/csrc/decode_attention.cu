// Decode attention for Hopper (sm_90a): one new query token per sequence
// over a contiguous or ring-buffer KV cache, split across the cache.
//
// Replaces the TPU kernel repro/kernels/decode_attention/decode_attention.py
// ::decode_attention (_kernel).  A key is valid when k_pos >= 0,
// k_pos <= q_pos and q_pos - k_pos < window (if a window is set), which is
// what lets ring buffers work unchanged.  The G query heads that share a KV
// head are handled together, so each K/V row is read once for all G.
// fp32 online-softmax statistics; a row with no valid key writes 0.
//
// What bounds it on the H100: reading the cache, 2 * L * Hkv * D elements
// per batch row, with ~4 * G * D FLOPs per key: memory, by far.  At B = 1,
// L ~ 545, Hkv = 8 that is ~2.2 MB, under a microsecond at 3.35 TB/s, so
// launches and the latency of a few tile loads set the time.  The TPU's
// grid, one program per (KV head, batch row) walking the whole cache, put
// B * Hkv blocks on 132 SMs (8 at B = 1, one at recurrentgemma's Hkv = 1).
//
// Split-KV.  Pass 1 (decode_attention_kernel) runs on a grid of (KV head,
// batch row, chunk): each block walks one chunk of `chunk` cache slots (a
// whole number of 64-key tiles) and writes its partial (m, l, acc[G, D])
// in fp32 to scratch the wrapper allocates.  Pass 2
// (common.cuh:decode_merge_kernel, shared with the paged kernel) rescales
// and sums the partials of each output column.  The wrapper picks the number of chunks from the
// shapes alone (about two blocks per SM), never from positions, so one
// CUDA graph replays correctly as q_pos advances.  With one chunk, pass 1
// writes the output itself and pass 2 is not launched.
//
// Per K/V tile of BK keys staged in shared memory as fp32
// (common.cuh:decode_tile, shared with the paged kernel): threads compute
// the G x BK scores as (head, key) pairs, one warp per head runs the
// online softmax, and each thread keeps fixed (head, column) outputs in
// registers across the key loop, reading each V element once for all its
// heads.

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BK = 64;
constexpr int NTHREADS = 256;

template <int D>
size_t da_smem_bytes(int G) {
    return sizeof(float) * (size_t(G) * (D + 4) + 2 * size_t(BK) * (D + 4) +
                            size_t(G) * (BK + 4) + 3 * size_t(G)) +
           sizeof(int) * BK;
}

// Pass 1 over cache slots [chunk * blockIdx.z, chunk * (blockIdx.z + 1)).
// One chunk (gridDim.z == 1): writes o.  Else: writes the partials of
// partial index p = (b * Hkv + h) * gridDim.z + blockIdx.z at m_ws/l_ws
// [p * G + g] and acc_ws[(p * G + g) * D + d].
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ q_pos,
                        const int* __restrict__ k_pos, T* __restrict__ o,
                        float* __restrict__ m_ws, float* __restrict__ l_ws,
                        float* __restrict__ acc_ws, int L, int Hkv, int G, int chunk,
                        int window, float softcap, float scale) {
    static_assert(D % 4 == 0, "head dim must be a multiple of 4");
    constexpr int DP = D + 4;
    constexpr int SP = BK + 4;
    constexpr int NA = (kMaxGroup * D + NTHREADS - 1) / NTHREADS;  // outputs per thread

    extern __shared__ float4 smem4[];
    float* q_s = reinterpret_cast<float*>(smem4);  // G x DP
    float* k_s = q_s + G * DP;                     // BK x DP
    float* v_s = k_s + BK * DP;                    // BK x DP
    float* s_s = v_s + BK * DP;                    // G x SP scores, then p
    float* m_s = s_s + G * SP;
    float* l_s = m_s + G;
    float* a_s = l_s + G;
    int* kp_s = reinterpret_cast<int*>(a_s + G);   // BK key positions

    const int tid = threadIdx.x;
    const int h = blockIdx.x, b = blockIdx.y;
    const int c0 = blockIdx.z * chunk, c1 = min(L, c0 + chunk);
    const size_t kv_stride = size_t(Hkv) * D;
    // the G query heads of KV head h are heads h*G .. h*G+G-1: contiguous
    const T* qb = q + (size_t(b) * Hkv + h) * G * D;
    const T* kb = k + size_t(b) * L * kv_stride + size_t(h) * D;
    const T* vb = v + size_t(b) * L * kv_stride + size_t(h) * D;
    const int* kpb = k_pos + size_t(b) * L;
    const int qp = q_pos[b];
    const int GD = G * D;

    for (int e = tid; e < GD; e += NTHREADS) q_s[(e / D) * DP + e % D] = to_float(qb[e]);
    if (tid < G) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    float acc[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] = 0.f;
    __syncthreads();

    for (int t0 = c0; t0 < c1; t0 += BK) {
        int seen = 0;
        if (tid < BK) {
            const int kp = t0 + tid < c1 ? kpb[t0 + tid] : -1;
            kp_s[tid] = kp;
            seen = key_visible(qp, kp, true, window);
        }
        if (!__syncthreads_or(seen)) continue;

        stage_kv<T, D, DP, BK, NTHREADS>(k_s, v_s, kb + size_t(t0) * kv_stride,
                                         vb + size_t(t0) * kv_stride, kv_stride, c1 - t0);
        __syncthreads();
        decode_tile<D, BK, NTHREADS>(q_s, k_s, v_s, s_s, m_s, l_s, a_s, acc, G, scale, softcap,
                                     [&](int c) { return key_visible(qp, kp_s[c], true, window); });
    }

    if (gridDim.z == 1) {
        T* ob = o + (size_t(b) * Hkv + h) * GD;
#pragma unroll
        for (int a = 0; a < NA; ++a) {
            const int e = tid + NTHREADS * a;
            if (e < GD) ob[e] = from_float<T>(acc[a] / fmaxf(l_s[e / D], 1e-30f));
        }
        return;
    }
    const size_t p = (size_t(b) * Hkv + h) * gridDim.z + blockIdx.z;
    if (tid < G) {
        m_ws[p * G + tid] = m_s[tid];
        l_ws[p * G + tid] = l_s[tid];
    }
#pragma unroll
    for (int a = 0; a < NA; ++a) {
        const int e = tid + NTHREADS * a;
        if (e < GD) acc_ws[p * GD + e] = acc[a];
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* k_pos, void* o, float* m_ws, float* l_ws, float* acc_ws, int B, int L,
           int Hkv, int G, int chunk, int n_split, int window, float softcap, float scale,
           cudaStream_t stream) {
    const size_t smem = da_smem_bytes<D>(G);
    static const cudaError_t attr = cudaFuncSetAttribute(
        decode_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(da_smem_bytes<D>(kMaxGroup)));
    if (attr != cudaSuccess) return int(attr);
    const dim3 grid(Hkv, B, n_split);
    decode_attention_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        q_pos, k_pos, static_cast<T*>(o), m_ws, l_ws, acc_ws, L, Hkv, G, chunk, window,
        softcap, scale);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 1) return int(err);
    return int(launch_decode_merge<T>(m_ws, l_ws, acc_ws, static_cast<T*>(o), B * Hkv * G, G,
                                      D, n_split, stream));
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* q_pos,
             const void* k_pos, void* o, void* m_ws, void* l_ws, void* acc_ws, int B, int L,
             int Hkv, int G, int D, int chunk, int n_split, int window, float softcap,
             float scale, void* stream) {
    if (G < 1 || G > kMaxGroup || !split_plan_ok(L, chunk, n_split, BK, m_ws, l_ws, acc_ws))
        return int(cudaErrorInvalidValue);
    const int* qp = static_cast<const int*>(q_pos);
    const int* kp = static_cast<const int*>(k_pos);
    float* m = static_cast<float*>(m_ws);
    float* l = static_cast<float*>(l_ws);
    float* acc = static_cast<float*>(acc_ws);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_DA_CASE(DIM)                                                                \
    case DIM:                                                                             \
        return launch<T, DIM>(q, k, v, qp, kp, o, m, l, acc, B, L, Hkv, G, chunk, n_split, \
                              window, softcap, scale, st);
    switch (D) {
        REPRO_DA_CASE(8)
        REPRO_DA_CASE(16)
        REPRO_DA_CASE(32)
        REPRO_DA_CASE(64)
        REPRO_DA_CASE(80)
        REPRO_DA_CASE(128)
        REPRO_DA_CASE(256)
        default:
            return int(cudaErrorInvalidValue);
    }
#undef REPRO_DA_CASE
}

}  // namespace
}  // namespace repro_torch

// Launchers with a plain C interface (bound through ctypes).  Each returns
// the CUDA status of its launches; 0 is success.  m_ws, l_ws: B * Hkv *
// n_split * G floats; acc_ws: that times D (unused, and may be null, when
// n_split is 1).  The chunks must cover the cache and every one of them
// hold a cache slot: chunk * (n_split - 1) < L <= chunk * n_split.
extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* q_pos, const void* k_pos, void* o,
                                     void* m_ws, void* l_ws, void* acc_ws, int B, int L,
                                     int Hkv, int G, int D, int chunk, int n_split, int window,
                                     float softcap, float scale, void* stream) {
    return repro_torch::dispatch<__nv_bfloat16>(q, k, v, q_pos, k_pos, o, m_ws, l_ws, acc_ws,
                                                B, L, Hkv, G, D, chunk, n_split, window,
                                                softcap, scale, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* q_pos, const void* k_pos, void* o,
                                    void* m_ws, void* l_ws, void* acc_ws, int B, int L,
                                    int Hkv, int G, int D, int chunk, int n_split, int window,
                                    float softcap, float scale, void* stream) {
    return repro_torch::dispatch<float>(q, k, v, q_pos, k_pos, o, m_ws, l_ws, acc_ws, B, L,
                                        Hkv, G, D, chunk, n_split, window, softcap, scale,
                                        stream);
}
