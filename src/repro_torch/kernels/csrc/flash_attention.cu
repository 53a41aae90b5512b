// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// ::flash_attention (_kernel): GQA attention with an online softmax in fp32,
// masks from absolute positions (-1 = empty key slot, causal, sliding
// window), tanh soft-capping, and a skip of key tiles that no query of the
// block can see.  A query row with no valid key writes 0, as the TPU kernel
// does (its l is clamped before the division).
//
// What bounds it on the H100: at prefill shapes (S = T = 512, D = 128) the
// work is ~2 GFLOP per call against ~10 MB of traffic, so the tensor-core
// rate would bound it.  This first version does its products with fp32
// FMAs from shared memory (no tensor cores), which makes it
// shared-memory-bandwidth bound instead: a simple kernel that is right
// first, with the same arithmetic in bf16 and fp32.  A wgmma/TMA version is
// queued in ROADMAP.md.
//
// Design: one block per (query tile of BQ rows, query head, batch row).
// The TPU's sequential kv grid axis becomes a loop inside the block over
// K/V tiles of BK keys staged in shared memory as fp32.  256 threads: in the
// score and P.V products each thread owns a 4-row slice of the tile
// (rows ty, ty+16, ty+32, ty+48), so its running output stays in registers
// across the whole key loop.  Rows are padded by 4 floats so the float4
// reads of a quarter warp fall in distinct banks.  Ragged S and T are masked
// here (the TPU kernel asserts S % bq == 0).

#include <climits>
#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NTHREADS = 256;

template <int D>
constexpr size_t fa_smem_bytes() {
    return sizeof(float) * (size_t(BQ) * (D + 4) + 2 * size_t(BK) * (D + 4) +
                            size_t(BQ) * (BK + 4) + 3 * BQ) +
           sizeof(int) * (BQ + BK + 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ q_pos,
                       const int* __restrict__ k_pos, T* __restrict__ o,
                       int S, int T_len, int Hq, int Hkv, int causal, int window,
                       float softcap, float scale) {
    static_assert(D % 4 == 0, "head dim must be a multiple of 4");
    constexpr int DP = D + 4;           // padded row stride of q/k/v tiles
    constexpr int SP = BK + 4;          // padded row stride of the score tile
    constexpr int NC = (D + 15) / 16;   // output columns per thread

    extern __shared__ float4 smem4[];
    float* q_s = reinterpret_cast<float*>(smem4);  // BQ x DP
    float* k_s = q_s + BQ * DP;                    // BK x DP
    float* v_s = k_s + BK * DP;                    // BK x DP
    float* s_s = v_s + BK * DP;                    // BQ x SP scores, then p
    float* m_s = s_s + BQ * SP;                    // running max per row
    float* l_s = m_s + BQ;                         // running sum per row
    float* a_s = l_s + BQ;                         // this tile's rescale per row
    int* qp_s = reinterpret_cast<int*>(a_s + BQ);  // BQ query positions
    int* kp_s = qp_s + BQ;                         // BK key positions
    int* range_s = kp_s + BK;                      // min, max query position

    const int tid = threadIdx.x;
    const int ty = tid / 16, tx = tid % 16;
    const int h = blockIdx.y, b = blockIdx.z;
    const int q0 = blockIdx.x * BQ;
    const int hk = h / (Hq / Hkv);
    const int rows = min(BQ, S - q0);
    const bool is_causal = causal != 0;
    const size_t q_stride = size_t(Hq) * D, kv_stride = size_t(Hkv) * D;
    const T* qb = q + (size_t(b) * S + q0) * q_stride + size_t(h) * D;
    const T* kb = k + size_t(b) * T_len * kv_stride + size_t(hk) * D;
    const T* vb = v + size_t(b) * T_len * kv_stride + size_t(hk) * D;
    const int* kpb = k_pos + size_t(b) * T_len;

    for (int e = tid; e < BQ * D; e += NTHREADS) {
        const int r = e / D, d = e % D;
        q_s[r * DP + d] = r < rows ? to_float(qb[size_t(r) * q_stride + d]) : 0.f;
    }
    if (tid < BQ) {
        qp_s[tid] = tid < rows ? q_pos[size_t(b) * S + q0 + tid] : 0;
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    __syncthreads();
    if (tid == 0) {
        int lo = INT_MAX, hi = INT_MIN;
        for (int r = 0; r < rows; ++r) {
            lo = min(lo, qp_s[r]);
            hi = max(hi, qp_s[r]);
        }
        range_s[0] = lo;
        range_s[1] = hi;
    }
    float acc[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
    __syncthreads();
    const int q_lo = range_s[0], q_hi = range_s[1];

    for (int t0 = 0; t0 < T_len; t0 += BK) {
        // Tile skip: a key is seen by some query of the block only if it is
        // filled, not after the latest query (causal) and inside the window
        // of the earliest one.  Skipping such a tile changes nothing: all
        // its probabilities would be 0 and the running max unchanged.
        int seen = 0;
        if (tid < BK) {
            const int kp = t0 + tid < T_len ? kpb[t0 + tid] : -1;
            kp_s[tid] = kp;
            seen = kp >= 0 && (!is_causal || q_hi >= kp) &&
                   (window <= 0 || q_lo - kp < window);
        }
        if (!__syncthreads_or(seen)) continue;

        stage_kv<T, D, DP, BK, NTHREADS>(k_s, v_s, kb + size_t(t0) * kv_stride,
                                         vb + size_t(t0) * kv_stride, kv_stride, T_len - t0);
        __syncthreads();

        // Scores: rows ty + 16i against keys tx + 16j.
        {
            float s[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
            for (int d = 0; d < D; d += 4) {
                float4 qv[4], kv[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    qv[i] = *reinterpret_cast<const float4*>(&q_s[(ty + 16 * i) * DP + d]);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    kv[j] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * j) * DP + d]);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kv[j], s[i][j]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = ty + 16 * i;
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int c = tx + 16 * j;
                    float x = s[i][j] * scale;
                    if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
                    s_s[r * SP + c] =
                        key_visible(qp_s[r], kp_s[c], is_causal, window) ? x : -INFINITY;
                }
            }
        }
        __syncthreads();

        // Online softmax: four threads per row, keys part, part+4, ...
        {
            const int r = tid >> 2, part = tid & 3;
            const float m_prev = m_s[r];
            float mx = -INFINITY;
#pragma unroll
            for (int kk = 0; kk < BK / 4; ++kk) mx = fmaxf(mx, s_s[r * SP + part + 4 * kk]);
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m_prev, mx);
            float sum = 0.f;
#pragma unroll
            for (int kk = 0; kk < BK / 4; ++kk) {
                const int idx = r * SP + part + 4 * kk;
                const float p = expf(s_s[idx] - m_new);
                s_s[idx] = p;
                sum += p;
            }
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            if (part == 0) {
                const float alpha = expf(m_prev - m_new);
                a_s[r] = alpha;
                l_s[r] = l_s[r] * alpha + sum;
                m_s[r] = m_new;
            }
        }
        __syncthreads();

        // acc = acc * alpha + P.V for this thread's rows and columns.
        {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float alpha = a_s[ty + 16 * i];
#pragma unroll
                for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
            }
            for (int c = 0; c < BK; c += 4) {
                float4 p[4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    p[i] = *reinterpret_cast<const float4*>(&s_s[(ty + 16 * i) * SP + c]);
#pragma unroll
                for (int cc = 0; cc < 4; ++cc) {
                    float vv[NC];
#pragma unroll
                    for (int j = 0; j < NC; ++j) {
                        const int d = tx + 16 * j;
                        vv[j] = d < D ? v_s[(c + cc) * DP + d] : 0.f;
                    }
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float pi = lane(p[i], cc);
#pragma unroll
                        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pi, vv[j], acc[i][j]);
                    }
                }
            }
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r >= rows) continue;
        const float l = fmaxf(l_s[r], 1e-30f);
        T* orow = o + (size_t(b) * S + q0 + r) * q_stride + size_t(h) * D;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
            const int d = tx + 16 * j;
            if (d < D) orow[d] = from_float<T>(acc[i][j] / l);
        }
    }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* k_pos, void* o, int B, int S, int T_len, int Hq, int Hkv,
           int causal, int window, float softcap, float scale, cudaStream_t stream) {
    constexpr size_t smem = fa_smem_bytes<D>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (attr != cudaSuccess) return int(attr);
    const dim3 grid((S + BQ - 1) / BQ, Hq, B);
    flash_attention_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        q_pos, k_pos, static_cast<T*>(o), S, T_len, Hq, Hkv, causal, window, softcap, scale);
    return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* q_pos,
             const void* k_pos, void* o, int B, int S, int T_len, int Hq, int Hkv, int D,
             int causal, int window, float softcap, float scale, void* stream) {
    const int* qp = static_cast<const int*>(q_pos);
    const int* kp = static_cast<const int*>(k_pos);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_CASE(DIM)                                                            \
    case DIM:                                                                         \
        return launch<T, DIM>(q, k, v, qp, kp, o, B, S, T_len, Hq, Hkv, causal, window, \
                              softcap, scale, st);
    switch (D) {
        REPRO_FA_CASE(8)
        REPRO_FA_CASE(16)
        REPRO_FA_CASE(32)
        REPRO_FA_CASE(64)
        REPRO_FA_CASE(80)
        REPRO_FA_CASE(128)
        REPRO_FA_CASE(256)
        default:
            return int(cudaErrorInvalidValue);
    }
#undef REPRO_FA_CASE
}

}  // namespace
}  // namespace repro_torch

// Launchers with a plain C interface (bound through ctypes).  Each returns
// the CUDA status of the launch; 0 is success.
extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    const void* q_pos, const void* k_pos, void* o, int B,
                                    int S, int T_len, int Hq, int Hkv, int D, int causal,
                                    int window, float softcap, float scale, void* stream) {
    return repro_torch::dispatch<__nv_bfloat16>(q, k, v, q_pos, k_pos, o, B, S, T_len, Hq,
                                                Hkv, D, causal, window, softcap, scale, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const void* q_pos, const void* k_pos, void* o, int B,
                                   int S, int T_len, int Hq, int Hkv, int D, int causal,
                                   int window, float softcap, float scale, void* stream) {
    return repro_torch::dispatch<float>(q, k, v, q_pos, k_pos, o, B, S, T_len, Hq, Hkv, D,
                                        causal, window, softcap, scale, stream);
}
