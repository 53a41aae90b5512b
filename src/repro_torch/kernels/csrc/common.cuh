// Shared helpers of the port's attention kernels.
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Initial running maximum of the online softmax, the TPU kernels' NEG_INF.
// It is finite, so exp(s - m) never sees inf - inf; masked scores are -inf
// and contribute exp(-inf) = 0.
constexpr float kNegInf = -1073741824.0f;  // -2^30

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

// Stage ROWS rows of D elements of K and of V (row stride `stride`
// elements) into fp32 shared tiles with rows padded to DP floats.  16-byte
// loads, up to 4 per tensor in flight per thread, so a block keeps enough
// bytes in flight to stream the cache; rows at or past `valid` are zero.
// Needs 16-byte aligned rows: D * sizeof(T) % 16 == 0 and aligned base
// pointers (the wrappers check both).
template <typename T, int D, int DP, int ROWS, int NTHREADS>
__device__ __forceinline__ void stage_kv(float* k_dst, float* v_dst, const T* k_src,
                                         const T* v_src, size_t stride, int valid) {
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
            const size_t off = size_t(e / NV) * stride + (e % NV) * VEC;
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

// Key visibility from absolute positions: -1 marks an empty slot; causal
// and window tests compare the query's position with the key's.
__device__ __forceinline__ bool key_visible(int qp, int kp, bool causal, int window) {
    return kp >= 0 && (!causal || qp >= kp) && (window <= 0 || qp - kp < window);
}

}  // namespace repro_torch
