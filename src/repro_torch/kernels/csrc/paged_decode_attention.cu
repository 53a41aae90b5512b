// Paged decode attention for Hopper (sm_90a): one new query token per
// sequence over a global block pool of K/V, addressed through a per-row
// block table.
//
// Replaces the TPU kernel repro/kernels/decode_attention/decode_attention.py
// ::paged_decode_attention (_paged_kernel).  Key j of row b is absolute
// position j and lives at pool[table[b, j / bs], j % bs]; it is valid when
// j <= q_pos and q_pos - j < window (if a window is set).  Block 0 is the
// serving engine's garbage block: idle rows point their whole table at it.
// A row with no valid key writes 0.
//
// What bounds it on the H100: reading the valid keys' K and V, 2 * (q_pos
// + 1) * Hkv * D elements per row, with ~4 * G * D FLOPs per key: memory.
// The design keeps K3's (decode_attention.cu) structure and shares its
// tile step (common.cuh:decode_tile): one block per (KV head, batch row),
// the G query heads of a KV head as one tile, fp32 online softmax, and
// 16-byte staging of K/V.  What the pool changes:
//   * the key loop runs from the window's first key to q_pos and stops:
//     every key past q_pos is invalid, so skipping them is exact, and the
//     kernel never reads a pool block past the row's length (its
//     unwritten tail, or the garbage entries of the table);
//   * a tile of BK = 64 keys spans several pool blocks (4 at the default
//     block size of 16): its first BK threads resolve each key's pool row
//     through the table into shared memory, and the staging loads then
//     gather those rows directly, so the gathered K/V never exists in
//     device memory (the plain version materialises it);
//   * any block size works, not only divisors of BK.
// Splitting the cache across blocks (split-KV) is queued with K3's.

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BK = 64;
constexpr int NTHREADS = 256;

template <int D>
size_t pda_smem_bytes(int G) {
    return sizeof(float) * (size_t(G) * (D + 4) + 2 * size_t(BK) * (D + 4) +
                            size_t(G) * (BK + 4) + 3 * size_t(G)) +
           sizeof(int) * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool, const int* __restrict__ tables,
                              const int* __restrict__ q_pos, T* __restrict__ o, int nb, int bs,
                              int Hkv, int G, int window, float softcap, float scale) {
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
    int* row_s = reinterpret_cast<int*>(a_s + G);  // BK pool rows (block * bs + offset)

    const int tid = threadIdx.x;
    const int h = blockIdx.x, b = blockIdx.y;
    const size_t kv_stride = size_t(Hkv) * D;      // elements per pool row
    const T* qb = q + (size_t(b) * Hkv + h) * G * D;
    T* ob = o + (size_t(b) * Hkv + h) * G * D;
    const int* tb = tables + size_t(b) * nb;
    const int qp = q_pos[b];
    const int last = min(qp, nb * bs - 1);         // the row's last valid key
    const int first = window > 0 ? max(qp - window + 1, 0) : 0;
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

    // every tile of the loop holds at least one valid key
    for (int t0 = first - first % BK; t0 <= last; t0 += BK) {
        if (tid < BK) {
            const int j = t0 + tid;
            row_s[tid] = j <= last ? tb[j / bs] * bs + j % bs : 0;
        }
        __syncthreads();
        stage_kv_rows<T, D, DP, BK, NTHREADS>(
            k_s, v_s, k_pool + size_t(h) * D, v_pool + size_t(h) * D,
            [&](int r) { return size_t(row_s[r]) * kv_stride; }, last - t0 + 1);
        __syncthreads();
        decode_tile<D, BK, NTHREADS>(q_s, k_s, v_s, s_s, m_s, l_s, a_s, acc, G, scale, softcap,
                                     [&](int c) { return t0 + c >= first && t0 + c <= last; });
    }

#pragma unroll
    for (int a = 0; a < NA; ++a) {
        const int e = tid + NTHREADS * a;
        if (e < GD) ob[e] = from_float<T>(acc[a] / fmaxf(l_s[e / D], 1e-30f));
    }
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* q_pos, void* o, int B, int nb, int bs, int Hkv, int G, int window,
           float softcap, float scale, cudaStream_t stream) {
    const size_t smem = pda_smem_bytes<D>(G);
    static const cudaError_t attr = cudaFuncSetAttribute(
        paged_decode_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(pda_smem_bytes<D>(kMaxGroup)));
    if (attr != cudaSuccess) return int(attr);
    const dim3 grid(Hkv, B);
    paged_decode_attention_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool), static_cast<const T*>(v_pool),
        tables, q_pos, static_cast<T*>(o), nb, bs, Hkv, G, window, softcap, scale);
    return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
             const void* q_pos, void* o, int B, int nb, int bs, int Hkv, int G, int D,
             int window, float softcap, float scale, void* stream) {
    if (G < 1 || G > kMaxGroup || bs < 1) return int(cudaErrorInvalidValue);
    const int* tp = static_cast<const int*>(tables);
    const int* qp = static_cast<const int*>(q_pos);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PDA_CASE(DIM)                                                                \
    case DIM:                                                                              \
        return launch<T, DIM>(q, k_pool, v_pool, tp, qp, o, B, nb, bs, Hkv, G, window,     \
                              softcap, scale, st);
    switch (D) {
        REPRO_PDA_CASE(8)
        REPRO_PDA_CASE(16)
        REPRO_PDA_CASE(32)
        REPRO_PDA_CASE(64)
        REPRO_PDA_CASE(80)
        REPRO_PDA_CASE(128)
        REPRO_PDA_CASE(256)
        default:
            return int(cudaErrorInvalidValue);
    }
#undef REPRO_PDA_CASE
}

}  // namespace
}  // namespace repro_torch

// Launchers with a plain C interface (bound through ctypes).  Each returns
// the CUDA status of the launch; 0 is success.  It launches on `stream`
// and never synchronises, so a CUDA graph can capture it.
extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool,
                                           const void* v_pool, const void* tables,
                                           const void* q_pos, void* o, int B, int nb, int bs,
                                           int Hkv, int G, int D, int window, float softcap,
                                           float scale, void* stream) {
    return repro_torch::dispatch<__nv_bfloat16>(q, k_pool, v_pool, tables, q_pos, o, B, nb, bs,
                                                Hkv, G, D, window, softcap, scale, stream);
}

extern "C" int paged_decode_attention_f32(const void* q, const void* k_pool,
                                          const void* v_pool, const void* tables,
                                          const void* q_pos, void* o, int B, int nb, int bs,
                                          int Hkv, int G, int D, int window, float softcap,
                                          float scale, void* stream) {
    return repro_torch::dispatch<float>(q, k_pool, v_pool, tables, q_pos, o, B, nb, bs, Hkv,
                                        G, D, window, softcap, scale, stream);
}
