// Shared helpers of the port's attention kernels.
#pragma once

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Initial running maximum of the online softmax, the TPU kernels' NEG_INF.
// It is finite, so exp(s - m) never sees inf - inf; masked scores are -inf
// and contribute exp(-inf) = 0.
constexpr float kNegInf = -1073741824.0f;  // -2^30

// Most query heads per KV head the decode kernels take.
constexpr int kMaxGroup = 16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

__device__ __forceinline__ float lane(const float4& v, int i) {
    return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
}

template <typename T>
__device__ __forceinline__ void store16(float* dst, const uint4& raw) {
    const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 16 / int(sizeof(T)); i += 4)
        *reinterpret_cast<float4*>(dst + i) =
            make_float4(to_float(x[i]), to_float(x[i + 1]), to_float(x[i + 2]), to_float(x[i + 3]));
}

// Stage ROWS rows of D elements of K and of V into fp32 shared tiles with
// rows padded to DP floats; row r starts `row_offset(r)` elements past the
// sources.  16-byte loads, up to 4 per tensor in flight per thread, so a
// block keeps enough bytes in flight to stream the cache; rows at or past
// `valid` are zero and never read.  Needs 16-byte aligned rows:
// D * sizeof(T) % 16 == 0 and aligned base pointers (the wrappers check
// both).
template <typename T, int D, int DP, int ROWS, int NTHREADS, typename RowOffset>
__device__ __forceinline__ void stage_kv_rows(float* k_dst, float* v_dst, const T* k_src,
                                              const T* v_src, RowOffset row_offset,
                                              int valid) {
    constexpr int VEC = 16 / int(sizeof(T));
    static_assert(D % VEC == 0, "a row must be whole 16-byte vectors");
    constexpr int NV = D / VEC, TOTAL = ROWS * NV;
    constexpr int ITER = (TOTAL + NTHREADS - 1) / NTHREADS;
    constexpr int BATCH = ITER < 4 ? ITER : 4;
#pragma unroll
    for (int i0 = 0; i0 < ITER; i0 += BATCH) {
        uint4 rk[BATCH], rv[BATCH];
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
            const int e = threadIdx.x + (i0 + j) * NTHREADS;
            const bool in = i0 + j < ITER && e < TOTAL && e / NV < valid;
            const size_t off = in ? row_offset(e / NV) + (e % NV) * VEC : 0;
            rk[j] = in ? __ldg(reinterpret_cast<const uint4*>(k_src + off)) : make_uint4(0u, 0u, 0u, 0u);
            rv[j] = in ? __ldg(reinterpret_cast<const uint4*>(v_src + off)) : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < BATCH; ++j) {
            const int e = threadIdx.x + (i0 + j) * NTHREADS;
            if (i0 + j < ITER && e < TOTAL) {
                const int idx = (e / NV) * DP + (e % NV) * VEC;
                store16<T>(k_dst + idx, rk[j]);
                store16<T>(v_dst + idx, rv[j]);
            }
        }
    }
}

// stage_kv_rows over rows `stride` elements apart (a contiguous cache).
template <typename T, int D, int DP, int ROWS, int NTHREADS>
__device__ __forceinline__ void stage_kv(float* k_dst, float* v_dst, const T* k_src,
                                         const T* v_src, size_t stride, int valid) {
    stage_kv_rows<T, D, DP, ROWS, NTHREADS>(
        k_dst, v_dst, k_src, v_src, [stride](int r) { return size_t(r) * stride; }, valid);
}

// One K/V tile of the decode kernels (K3 and K4), after staging: the G x
// BK scores (G <= kMaxGroup) as (head, key) pairs, one warp per head for
// the online-softmax update of (m, l) and the rescale factor alpha, then
// P.V into each thread's fixed (head, column) accumulators: output a of
// thread t is element e = t + NTHREADS * a of the G x D tile.
// `visible(c)` says whether staged key c counts.  Shared layout: q_s
// G x (D+4), k_s and v_s BK x (D+4), s_s G x (BK+4), m_s, l_s, a_s G
// each.  Ends synchronised, so the caller may restage at once.
template <int D, int BK, int NTHREADS, int NA, typename Visible>
__device__ __forceinline__ void decode_tile(const float* q_s, const float* k_s, const float* v_s,
                                            float* s_s, float* m_s, float* l_s, float* a_s,
                                            float (&acc)[NA], int G, float scale, float softcap,
                                            Visible visible) {
    static_assert(BK == 64, "the softmax pass reads two keys per lane");
    constexpr int DP = D + 4;
    constexpr int SP = BK + 4;
    const int tid = threadIdx.x;
    const int warp = tid / 32, ln = tid % 32;
    const int GD = G * D;

    for (int e = tid; e < G * BK; e += NTHREADS) {
        const int g = e / BK, c = e % BK;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; d += 4)
            s = dot4(*reinterpret_cast<const float4*>(&q_s[g * DP + d]),
                     *reinterpret_cast<const float4*>(&k_s[c * DP + d]), s);
        s *= scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        s_s[g * SP + c] = visible(c) ? s : -INFINITY;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NTHREADS / 32) {
        const float m_prev = m_s[g];
        const float x0 = s_s[g * SP + ln], x1 = s_s[g * SP + ln + 32];
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_prev, mx);
        const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
        s_s[g * SP + ln] = p0;
        s_s[g * SP + ln + 32] = p1;
        float sum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (ln == 0) {
            const float alpha = expf(m_prev - m_new);
            a_s[g] = alpha;
            l_s[g] = l_s[g] * alpha + sum;
            m_s[g] = m_new;
        }
    }
    __syncthreads();

    if constexpr (NTHREADS % D == 0) {
        // Output a of this thread is column d of head g0 + a * HSTEP: each V
        // element is read once for all of them, P four keys at a time.
        constexpr int HSTEP = NTHREADS / D;
        const int d = tid % D, g0 = tid / D;
#pragma unroll
        for (int a = 0; a < NA; ++a)
            if (g0 + a * HSTEP < G) acc[a] *= a_s[g0 + a * HSTEP];
#pragma unroll 2
        for (int c = 0; c < BK; c += 4) {
            float vv[4];
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) vv[cc] = v_s[(c + cc) * DP + d];
#pragma unroll
            for (int a = 0; a < NA; ++a) {
                const int g = g0 + a * HSTEP;
                if (g < G) {
                    const float4 p = *reinterpret_cast<const float4*>(&s_s[g * SP + c]);
                    acc[a] = fmaf(p.w, vv[3], fmaf(p.z, vv[2], fmaf(p.y, vv[1],
                                  fmaf(p.x, vv[0], acc[a]))));
                }
            }
        }
    } else {
#pragma unroll
        for (int a = 0; a < NA; ++a) {
            const int e = tid + NTHREADS * a;
            if (e < GD) {
                const int g = e / D, d = e % D;
                const float* p = &s_s[g * SP];
                float x = acc[a] * a_s[g];
#pragma unroll 8
                for (int c = 0; c < BK; ++c) x = fmaf(p[c], v_s[c * DP + d], x);
                acc[a] = x;
            }
        }
    }
    __syncthreads();
}

// Split-KV merge of one output column (the decode kernels' second pass):
// the partials of n chunks, each chunk's running max m_i and sum l_i
// `stride` floats apart and its unnormalised output acc_i `acc_stride`
// apart, rescaled by exp(m_i - m) to the overall max m and summed.  A
// chunk with no visible key holds m = kNegInf, l = 0, acc = 0, so a row
// with no visible key anywhere writes 0.
template <typename T>
__device__ __forceinline__ T merge_partials(const float* m, const float* l, const float* acc,
                                            int n, int stride, size_t acc_stride) {
    float mx = kNegInf;
#pragma unroll 8
    for (int i = 0; i < n; ++i) mx = fmaxf(mx, m[i * stride]);
    float num = 0.f, den = 0.f;
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
        const float w = expf(m[i * stride] - mx);
        den = fmaf(w, l[i * stride], den);
        num = fmaf(w, acc[i * acc_stride], num);
    }
    return from_float<T>(num / fmaxf(den, 1e-30f));
}

// Split-KV partials of the decode kernels (K3 and K4): pass 1 on a grid of
// (KV head h, batch row b, chunk z) writes partial p = (b * Hkv + h) *
// n_split + z of its G heads at m_ws/l_ws[p * G + g] and
// acc_ws[(p * G + g) * D + d].
constexpr int kMergeThreads = 64;

// Pass 2: block (row, column block) merges output row = b * Hq + hq =
// (b * Hkv + h) * G + g over the n_split chunks.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ m_ws, const float* __restrict__ l_ws,
                    const float* __restrict__ acc_ws, T* __restrict__ o, int G, int D,
                    int n_split) {
    const int row = blockIdx.x;
    const int d = blockIdx.y * kMergeThreads + threadIdx.x;
    if (d >= D) return;
    const size_t first = (size_t(row / G) * n_split) * G + row % G;  // chunk 0's partial
    o[size_t(row) * D + d] = merge_partials<T>(m_ws + first, l_ws + first,
                                               acc_ws + first * D + d, n_split, G,
                                               size_t(G) * D);
}

// Launch pass 2 over the `rows` = B * Hq output rows of D columns.
template <typename T>
cudaError_t launch_decode_merge(const float* m_ws, const float* l_ws, const float* acc_ws,
                                T* o, int rows, int G, int D, int n_split,
                                cudaStream_t stream) {
    const dim3 grid(rows, (D + kMergeThreads - 1) / kMergeThreads);
    decode_merge_kernel<T><<<grid, kMergeThreads, 0, stream>>>(m_ws, l_ws, acc_ws, o, G, D,
                                                               n_split);
    return cudaGetLastError();
}

// The checks every split-KV entry point makes of its plan: `chunk` slots a
// chunk, a whole number of `tile`-key tiles; n_split chunks that cover the
// L slots with none empty; scratch for the partials when there are two or
// more.
inline bool split_plan_ok(int L, int chunk, int n_split, int tile, const void* m_ws,
                          const void* l_ws, const void* acc_ws) {
    return L >= 1 && chunk >= 1 && chunk % tile == 0 && n_split >= 1 &&
           size_t(chunk) * (n_split - 1) < size_t(L) && size_t(chunk) * n_split >= size_t(L) &&
           (n_split == 1 || (m_ws && l_ws && acc_ws));
}

// ---------------------------------------------------------------------------
// Tensor-core and asynchronous-copy helpers (K2's bf16 kernel and K4's)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(addr));
}

// c += a.b for one m16n8k16 tile: a 16x16 (row), b 16x8 (col), c 16x8 fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as a bf16 pair, the first in the low half (the lower index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float exp2_approx(float x) {  // 2^x; 2^-inf = 0
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// tanh from one exp: accurate to ~1e-7 absolute, and clamped where fp32
// tanh is +-1, so the fast division never sees an infinite divisor.
__device__ __forceinline__ float tanh_exp(float y) {
    const float e = __expf(2.f * fminf(fmaxf(y, -15.f), 15.f));
    return 1.f - __fdividef(2.f, e + 1.f);
}

constexpr float kLog2e = 1.4426950408889634f;

// Key visibility from absolute positions: -1 marks an empty slot; causal
// and window tests compare the query's position with the key's.
__device__ __forceinline__ bool key_visible(int qp, int kp, bool causal, int window) {
    return kp >= 0 && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

}  // namespace repro_torch
