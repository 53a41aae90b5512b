// RMSNorm for Hopper (sm_90a), gemma-style, with an optional residual add
// fused in front:
//   s = x + r                                   (rounded to x's type)
//   y = s * rsqrt(mean(s^2) + eps) * (1 + scale)  (fp32 statistics)
// over the last dimension d of x, r (rows, d).  Without r, s is x and only
// y is written.
//
// Replaces the TPU kernel repro/kernels/rmsnorm/rmsnorm.py::rmsnorm
// (_kernel), which normalises a block of rows per grid step in VMEM.  The
// add is this port's: the model adds every branch output to the residual
// stream and normalises the sum right after, two passes over the row and
// two launches; here it is one of each.  The statistics come from the sum
// rounded to x's type, as the separate add and norm compute them (squaring
// the unrounded fp32 sum would break bf16 parity with the reference).
//
// What bounds it on the H100: bytes at prefill shapes, launch latency at
// decode shapes.  Each element is read once from x and r and written once
// to s and y, a handful of FLOPs against 8 bytes (bf16): at (512, 4096)
// fused that is 16 MB, 5.0 us at 3.35 TB/s, against a ~2 us launch floor
// that sets the time of a (1, 4096) row.  So the design keeps each row in
// registers for one pass over device memory, and folds the add into the
// same launch rather than making the norm itself faster.
//
// Design.  One block per row, one 16-byte vector of x (and of r) per
// thread and up to NV vectors a thread, held in registers through the
// whole pass: blockDim = ceil(d / VEC / NV) rounded up to whole warps, at
// most 1024, so d = 4096 in bf16 takes 512 threads with one vector each
// and 512 rows fill the card's 132 SMs in one wave, four blocks an SM.
// The sum of squares is reduced in fp32 by warp shuffles, then the warps'
// sums cross one shared-memory exchange and one barrier.  s and y go out
// in 16-byte stores.  A d that is not a whole number of vectors, or a
// pointer not 16-byte aligned, takes the same kernel one element a vector
// (VEC = 1).  The plan comes from d alone, so a CUDA graph replays it.
// s and y are new tensors (out of place): x and r may still be read by a
// captured graph or a parallel block's MLP.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxD = 16384;
constexpr int kMaxThreads = 1024;

// VEC elements of T, loaded and stored in one access where VEC * sizeof(T)
// is 16 bytes.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
    T e[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
    return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& v) {
    *reinterpret_cast<Pack<T, VEC>*>(p) = v;
}

// (1 + scale[c + i]) for the VEC columns from c; scale is fp32 or bf16,
// loaded in vectors where VEC > 1 (c is then a multiple of VEC and the
// base 16-byte aligned).
template <int VEC>
__device__ __forceinline__ void load_gain(float (&g)[VEC], const void* scale, bool scale_f32,
                                          int c) {
    if (scale_f32) {
        const float* sp = static_cast<const float*>(scale) + c;
        if constexpr (VEC % 4 == 0) {
#pragma unroll
            for (int k = 0; k < VEC / 4; ++k) {
                const float4 q = reinterpret_cast<const float4*>(sp)[k];
                g[4 * k] = 1.f + q.x;
                g[4 * k + 1] = 1.f + q.y;
                g[4 * k + 2] = 1.f + q.z;
                g[4 * k + 3] = 1.f + q.w;
            }
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) g[i] = 1.f + sp[i];
        }
    } else {
        const auto q = load<__nv_bfloat16, VEC>(static_cast<const __nv_bfloat16*>(scale) + c);
#pragma unroll
        for (int i = 0; i < VEC; ++i) g[i] = 1.f + __bfloat162float(q.e[i]);
    }
}

// Sum of v over the block, in every thread; `partial` holds 32 floats.
__device__ __forceinline__ float block_sum(float v, float* partial) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) partial[warp] = v;
    __syncthreads();
    v = lane < int(blockDim.x >> 5) ? partial[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Row blockIdx.x.  r and s may be null together (no residual).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const void* __restrict__ scale, bool scale_f32, T* __restrict__ s,
               T* __restrict__ y, int d, float eps) {
    __shared__ float partial[32];
    const size_t row = size_t(blockIdx.x) * d;
    float v[NV][VEC], g[NV][VEC];
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        const int c = (j * int(blockDim.x) + int(threadIdx.x)) * VEC;
        if (c < d) {  // d is a whole number of vectors
            // the gain's loads go out beside the row's, not after the
            // reduction: one memory round trip fewer on the critical path
            load_gain<VEC>(g[j], scale, scale_f32, c);
            Pack<T, VEC> a = load<T, VEC>(x + row + c);
            if (r != nullptr) {
                const Pack<T, VEC> b = load<T, VEC>(r + row + c);
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    a.e[i] = from_float<T>(to_float(a.e[i]) + to_float(b.e[i]));
                store<T, VEC>(s + row + c, a);
            }
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                v[j][i] = to_float(a.e[i]);
                ss = fmaf(v[j][i], v[j][i], ss);
            }
        }
    }
    const float inv = rsqrtf(block_sum(ss, partial) / float(d) + eps);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
        const int c = (j * int(blockDim.x) + int(threadIdx.x)) * VEC;
        if (c < d) {
            Pack<T, VEC> o;
#pragma unroll
            for (int i = 0; i < VEC; ++i) o.e[i] = from_float<T>(v[j][i] * inv * g[j][i]);
            store<T, VEC>(y + row + c, o);
        }
    }
}

template <typename T, int VEC, int NV>
cudaError_t launch(const void* x, const void* r, const void* scale, bool scale_f32, void* s,
                   void* y, int rows, int d, int threads, float eps, cudaStream_t st) {
    rmsnorm_kernel<T, VEC, NV><<<rows, threads, 0, st>>>(
        static_cast<const T*>(x), static_cast<const T*>(r), scale, scale_f32,
        static_cast<T*>(s), static_cast<T*>(y), d, eps);
    return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int dispatch(const void* x, const void* r, const void* scale, void* s, void* y, int rows,
             int d, int scale_f32, float eps, void* stream) {
    if (rows < 1 || d < 1 || d > kMaxD || !x || !scale || !y || (r == nullptr) != (s == nullptr))
        return int(cudaErrorInvalidValue);
    constexpr int kVec = 16 / int(sizeof(T));
    const bool vec = d % kVec == 0 && aligned16(x) && aligned16(y) && aligned16(scale) &&
                     (r == nullptr || (aligned16(r) && aligned16(s)));
    const int width = vec ? kVec : 1;
    const int nvec = d / width;  // exact: d % width == 0
    int nv = 1;
    while (nvec > nv * kMaxThreads) nv *= 2;
    const int threads = ((nvec + nv - 1) / nv + 31) / 32 * 32;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool f32 = scale_f32 != 0;
#define REPRO_RMSNORM_CASE(V, N) \
    if (width == V && nv == N)   \
        return int(launch<T, V, N>(x, r, scale, f32, s, y, rows, d, threads, eps, st));
    if (vec) {
        REPRO_RMSNORM_CASE(kVec, 1)
        REPRO_RMSNORM_CASE(kVec, 2)
        if constexpr (kMaxD / kVec > 2 * kMaxThreads) {  // fp32 only: bf16 needs 2 at most
            REPRO_RMSNORM_CASE(kVec, 4)
        }
    } else {
        REPRO_RMSNORM_CASE(1, 1)
        REPRO_RMSNORM_CASE(1, 2)
        REPRO_RMSNORM_CASE(1, 4)
        REPRO_RMSNORM_CASE(1, 8)
        REPRO_RMSNORM_CASE(1, 16)
    }
#undef REPRO_RMSNORM_CASE
    return int(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace repro_torch

// Launchers with a plain C interface (bound through ctypes).  Return the
// CUDA status of the launch; 0 is success.  x, y (and r, s when given):
// rows * d elements, contiguous; scale: d elements, fp32 if scale_f32
// else bf16.  r and s are both null (plain RMSNorm) or both given.
extern "C" int rmsnorm_bf16(const void* x, const void* r, const void* scale, void* s, void* y,
                            int rows, int d, int scale_f32, float eps, void* stream) {
    return repro_torch::dispatch<__nv_bfloat16>(x, r, scale, s, y, rows, d, scale_f32, eps,
                                                stream);
}

extern "C" int rmsnorm_f32(const void* x, const void* r, const void* scale, void* s, void* y,
                           int rows, int d, int scale_f32, float eps, void* stream) {
    return repro_torch::dispatch<float>(x, r, scale, s, y, rows, d, scale_f32, eps, stream);
}
