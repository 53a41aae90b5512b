// Flash attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py
// ::flash_attention (_kernel): GQA attention with an online softmax in fp32,
// masks from absolute positions (-1 = empty key slot, causal, sliding
// window), tanh soft-capping, and a skip of key tiles that no query of the
// block can see.  A query row with no valid key writes 0, as the TPU kernel
// does (its l is clamped before the division).  Ragged S and T are masked
// here (the TPU kernel asserts S % bq == 0).  Two kernels, routed by dtype:
//
// bf16, on the tensor cores (flash_attention_tc_kernel).  At prefill shapes
// (S = T = 512, D = 128) the work is ~2 GFLOP per call against ~10 MB of
// traffic, so the tensor-core rate would bound it.  One block of 4 warps
// per (64-row query tile, query head, batch row); each warp owns 16 query
// rows.  S = Q.K^T and O += P.V are mma.sync m16n8k16 bf16 products with
// fp32 accumulators, operands loaded by ldmatrix (.trans for V).  The
// scores never leave the accumulator fragments: scale, softcap and the
// position mask are applied there (the mask only on tiles that some query
// of the block sees in part), the row max and sum use the quad shuffles of
// the fragment layout, and P is repacked into bf16 A fragments in
// registers.  K/V tiles stay bf16 in shared memory, rows padded by 16
// bytes so ldmatrix is free of bank conflicts, and arrive by 16-byte
// cp.async into a ring of STAGES buffers, one barrier per tile.  Q stays in
// registers for D <= 128; at D = 256 it is re-read from shared memory per
// tile and key tiles are 32 keys, which keeps the accumulators in
// registers.  D = 8 is zero-padded to the mma depth of 16.  The longest
// causal query tiles are launched first.
//
// What bounds it now: not the tensor cores.  With the products removed
// most of its time remains: each warp pulls its own K/V fragments through
// ldmatrix (shared-memory bandwidth, two mma per ldmatrix), and at D = 128
// the 3-stage ring's ~120 KB of shared memory leaves one block of 4 warps
// per SM, one warp per sub-partition, so the softmax, copies and barriers
// of a tile are not hidden.  Neither a 2-stage ring (two blocks per SM)
// nor 32 rows per warp (each K/V fragment feeding two m-tiles) was faster.
// The next step is wgmma on the 64-row warpgroup tile, reading K/V from
// shared memory once per warpgroup in a 128-byte-swizzled layout, with K/V
// brought by TMA behind mbarriers and a producer warp, so softmax and
// loads overlap the products.  (An unswizzled wgmma version with a wait
// after each product was slower than this one.)
//
// fp32, FMA products (flash_attention_kernel): the first design, kept for
// fp32 callers because tensor-core products (tf32 or bf16) cannot hold
// fp32 to its 2e-5 tolerance.  One block per (query tile of BQ rows, query
// head, batch row); K/V tiles of BK keys staged in shared memory; 256
// threads, each owning a 4-row slice of the tile (rows ty, ty+16, ty+32,
// ty+48) so its running output stays in registers across the key loop.
// Rows are padded by 4 floats so the float4 reads of a quarter warp fall
// in distinct banks.  It is shared-memory-bandwidth bound.

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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// Tiling of the tensor-core kernel: 4 warps of 16 query rows each, key
// tiles of BK keys in a ring of STAGES shared buffers, Q fragments in
// registers (QREG) or re-read from shared memory per tile.
template <int D_, int BK_, bool QREG_, int STAGES_>
struct TcCfg {
    static constexpr int D = D_, BK = BK_, STAGES = STAGES_;
    static constexpr bool QREG = QREG_;
    static constexpr int NW = 4, NTHREADS = 32 * NW, BQ = 16 * NW;
    static constexpr int DK = D < 16 ? 16 : D;  // contraction padded to the mma depth
    static constexpr int RS = DK + 8;           // shared row stride: 16 bytes of padding
    // shared bytes besides the two per-tile flag bytes
    static constexpr size_t fixed_smem =
        sizeof(bf16) * (size_t(BQ) + 2 * size_t(STAGES) * BK) * RS +
        sizeof(int) * (size_t(STAGES) * BK + 2 * NW);
    static_assert(D % 16 == 0 || D == 8, "head dim must be 8 or a multiple of 16");
    static_assert(BK % 16 == 0, "key tiles are whole mma k-steps");
    static_assert(STAGES >= 2, "at least one tile in flight");
};

// The tiling each head dim runs.
template <int D>
struct TcTile : TcCfg<D, (D > 128 ? 32 : 64), (D <= 128), (D > 128 ? 2 : 3)> {};

template <typename Cfg>
__global__ void __launch_bounds__(Cfg::NTHREADS)
flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const int* __restrict__ q_pos,
                          const int* __restrict__ k_pos, bf16* __restrict__ o, int S,
                          int T_len, int Hq, int Hkv, int causal, int window, float softcap,
                          float scale) {
    constexpr int D = Cfg::D, DK = Cfg::DK, BKT = Cfg::BK, RS = Cfg::RS;
    constexpr int NT = Cfg::NTHREADS, BQT = Cfg::BQ, NSTAGE = Cfg::STAGES;
    constexpr int CH = D / 8;       // 16-byte chunks per source row
    constexpr int NKQ = DK / 16;    // k-steps of Q.K^T
    constexpr int NS = BKT / 8;     // score n-tiles (keys)
    constexpr int NO = D / 8;       // output n-tiles (columns)

    const int nT = (T_len + BKT - 1) / BKT;
    extern __shared__ uint4 smem_tc[];
    bf16* q_s = reinterpret_cast<bf16*>(smem_tc);      // BQT x RS
    bf16* k_s = q_s + BQT * RS;                        // NSTAGE x BKT x RS
    bf16* v_s = k_s + NSTAGE * BKT * RS;               // NSTAGE x BKT x RS
    int* kp_s = reinterpret_cast<int*>(v_s + NSTAGE * BKT * RS);  // NSTAGE x BKT positions
    int* red_s = kp_s + NSTAGE * BKT;                  // query range: min, max per warp
    // per key tile: some key seen by some query (seen_s); some key not seen
    // by every query, or the tile ragged (part_s), so the mask is needed
    unsigned char* seen_s = reinterpret_cast<unsigned char*>(red_s + 2 * Cfg::NW);
    unsigned char* part_s = seen_s + nT;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, tig = lane % 4;
    const int h = blockIdx.x % Hq, b = blockIdx.x / Hq;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * BQT;  // longest causal tiles first
    const int rows = min(BQT, S - q0);
    const int hk = h / (Hq / Hkv);
    const bool is_causal = causal != 0;
    const size_t q_stride = size_t(Hq) * D, kv_stride = size_t(Hkv) * D;
    const bf16* qb = q + (size_t(b) * S + q0) * q_stride + size_t(h) * D;
    const bf16* kb = k + size_t(b) * T_len * kv_stride + size_t(hk) * D;
    const bf16* vb = v + size_t(b) * T_len * kv_stride + size_t(hk) * D;
    const int* kpb = k_pos + size_t(b) * T_len;
    const int* qpb = q_pos + size_t(b) * S + q0;

    // Q tile, rows past S zero.  At D = 8 the pad columns of Q and of every
    // K buffer are zeroed once; the copies never touch them.
#pragma unroll
    for (int i = 0; i < (BQT * CH + NT - 1) / NT; ++i) {
        const int e = tid + i * NT, r = e / CH, c = e % CH;
        const bool in = r < rows;
        if (e < BQT * CH)
            cp_async16(smem_addr(q_s + r * RS + c * 8),
                       qb + (in ? size_t(r) * q_stride + c * 8 : 0), in ? 16 : 0);
    }
    cp_async_commit();
    if constexpr (DK > D) {
        for (int r = tid; r < BQT + NSTAGE * BKT; r += NT)
            *reinterpret_cast<uint4*>((r < BQT ? q_s + r * RS : k_s + (r - BQT) * RS) + D) =
                make_uint4(0u, 0u, 0u, 0u);
    }

    // The block's range of query positions, then which key tiles some query
    // of the block can see: filled, not after the latest query (causal),
    // inside the window of the earliest.  A skipped tile would add nothing.
    // A tile whose keys every query sees (not after the earliest, inside the
    // window of the latest) needs no mask.
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = tid; r < rows; r += NT) {
        lo = min(lo, qpb[r]);
        hi = max(hi, qpb[r]);
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
        red_s[warp] = lo;
        red_s[Cfg::NW + warp] = hi;
    }
    for (int j = tid; j < 2 * nT; j += NT) seen_s[j] = 0;
    __syncthreads();
    int q_lo = red_s[0], q_hi = red_s[Cfg::NW];
#pragma unroll
    for (int w = 1; w < Cfg::NW; ++w) {
        q_lo = min(q_lo, red_s[w]);
        q_hi = max(q_hi, red_s[Cfg::NW + w]);
    }
#pragma unroll 8
    for (int t = tid; t < T_len; t += NT) {
        const int kp = __ldg(kpb + t);
        if (kp >= 0 && (!is_causal || q_hi >= kp) && (window <= 0 || q_lo - kp < window))
            seen_s[t / BKT] = 1;
        if (!(kp >= 0 && (!is_causal || q_lo >= kp) && (window <= 0 || q_hi - kp < window)))
            part_s[t / BKT] = 1;
    }
    if (tid == 0 && T_len % BKT) part_s[nT - 1] = 1;
    __syncthreads();

    // This thread's first row and 16-byte chunk of a K/V tile; it copies
    // rows lr, lr + RSTEP, ... (when a row's chunks divide the threads).
    constexpr int RSTEP = NT % CH == 0 ? NT / CH : 1;
    const int lr = tid / CH, lc = tid % CH;
    const size_t src0 = size_t(lr) * kv_stride + lc * 8;
    const uint32_t k_dst0 = smem_addr(k_s + lr * RS + lc * 8);
    const uint32_t v_dst0 = smem_addr(v_s + lr * RS + lc * 8);
    auto load_tile = [&](int j, int st) {
        const int t0 = j * BKT;
        if constexpr (NT % CH == 0) {
            const bf16* ks = kb + size_t(t0) * kv_stride + src0;
            const bf16* vs = vb + size_t(t0) * kv_stride + src0;
            const uint32_t soff = st * BKT * RS * sizeof(bf16);
#pragma unroll
            for (int i = 0; i < (BKT + RSTEP - 1) / RSTEP; ++i) {
                const int r = lr + i * RSTEP;
                if (RSTEP * ((BKT + RSTEP - 1) / RSTEP) > BKT && r >= BKT) break;
                const bool in = t0 + r < T_len;
                const uint32_t doff = soff + i * RSTEP * RS * sizeof(bf16);
                cp_async16(k_dst0 + doff, in ? ks + size_t(i) * RSTEP * kv_stride : kb,
                           in ? 16 : 0);
                cp_async16(v_dst0 + doff, in ? vs + size_t(i) * RSTEP * kv_stride : vb,
                           in ? 16 : 0);
            }
        } else {
            bf16* kd = k_s + st * BKT * RS;
            bf16* vd = v_s + st * BKT * RS;
#pragma unroll
            for (int i = 0; i < (BKT * CH + NT - 1) / NT; ++i) {
                const int e = tid + i * NT, r = e / CH, c = e % CH;
                const bool in = t0 + r < T_len;
                const size_t off = in ? size_t(t0 + r) * kv_stride + c * 8 : 0;
                if (e < BKT * CH) {
                    cp_async16(smem_addr(kd + r * RS + c * 8), kb + off, in ? 16 : 0);
                    cp_async16(smem_addr(vd + r * RS + c * 8), vb + off, in ? 16 : 0);
                }
            }
        }
        for (int r = tid; r < BKT; r += NT) {
            if (t0 + r < T_len)
                cp_async4(smem_addr(kp_s + st * BKT + r), kpb + t0 + r);
            else
                kp_s[st * BKT + r] = -1;
        }
    };

    // The pipeline: the next NSTAGE - 1 tiles some query sees are in flight,
    // one commit group each (possibly empty).
    auto next_seen = [&](int j) {
        while (j < nT && !seen_s[j]) ++j;
        return j;
    };
    int cur = next_seen(0), ld = cur;
#pragma unroll
    for (int st = 0; st < NSTAGE - 1; ++st) {
        if (ld < nT) {
            load_tile(ld, st);
            ld = next_seen(ld + 1);
        }
        cp_async_commit();
    }
    cp_async_wait<NSTAGE - 1>();  // Q has landed
    __syncthreads();

    // ldmatrix row addresses of this lane: A tiles (Q) and B tiles (K) read
    // 8x8 blocks row-major, V's are transposed on the way.
    const int a_row = warp * 16 + (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
    const int k_row = (lane % 8) + 8 * (lane / 16), k_col = 8 * ((lane / 8) % 2);
    const int v_row = (lane % 8) + 8 * ((lane / 8) % 2), v_col = 8 * (lane / 16);
    uint32_t qf[Cfg::QREG ? NKQ : 1][4];
    if constexpr (Cfg::QREG) {
#pragma unroll
        for (int kk = 0; kk < NKQ; ++kk)
            ldmatrix_x4(qf[kk], smem_addr(q_s + a_row * RS + kk * 16 + a_col));
    }

    // S = Q.K^T of the tile in stage st, for the warp's 16 rows.
    auto qk = [&](float (&s)[NS][4], int st) {
        const bf16* kt = k_s + st * BKT * RS;
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NKQ; ++kk) {
            uint32_t a[4];
            if constexpr (Cfg::QREG) {
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
            } else {
                ldmatrix_x4(a, smem_addr(q_s + a_row * RS + kk * 16 + a_col));
            }
#pragma unroll
            for (int jn = 0; jn < NS / 2; ++jn) {
                uint32_t bk[4];
                ldmatrix_x4(bk, smem_addr(kt + (jn * 16 + k_row) * RS + kk * 16 + k_col));
                mma_bf16(s[2 * jn], a, bk[0], bk[1]);
                mma_bf16(s[2 * jn + 1], a, bk[2], bk[3]);
            }
        }
    };

    // This thread's rows: g and g + 8 of the warp's 16.
    const int r0 = warp * 16 + g, r1 = r0 + 8;
    const int qp0 = r0 < rows ? qpb[r0] : 0, qp1 = r1 < rows ? qpb[r1] : 0;
    float oacc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // log2 units; l per thread
    // scores in log2 units: s * scale * log2(e), or through the softcap
    // cap * tanh(s * scale / cap) * log2(e)
    const bool capped = softcap > 0.f;
    const float pre = capped ? scale / softcap : scale * kLog2e;
    const float post = capped ? softcap * kLog2e : 1.f;

    // Each step: the tile `cur` has landed once all but the newest NSTAGE - 2
    // groups are in; past the barrier every warp is done with the tile
    // before it, whose stage takes the next load.
    int sc = 0;  // stage of tile `cur`
    while (cur < nT) {
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();
        if (ld < nT) {
            load_tile(ld, sc == 0 ? NSTAGE - 1 : sc - 1);
            ld = next_seen(ld + 1);
        }
        cp_async_commit();

        float s[NS][4];
        qk(s, sc);

        // Scale, softcap and mask in the fragments; online softmax with the
        // row max over the quad.
        const int* kpt = kp_s + sc * BKT;
        const bool masked = part_s[cur];
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = s[j][e] * pre;
                s[j][e] = capped ? post * tanh_exp(x) : x;
            }
            if (masked) {
                const int2 kp2 = *reinterpret_cast<const int2*>(kpt + j * 8 + 2 * tig);
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (!key_visible(e < 2 ? qp0 : qp1, (e & 1) ? kp2.y : kp2.x, is_causal,
                                     window))
                        s[j][e] = -INFINITY;
            }
            mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
            mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = exp2_approx(m0 - mn0), al1 = exp2_approx(m1 - mn1);
        m0 = mn0;
        m1 = mn1;

        // P in bf16 A fragments: keys 16kk.. are n-tiles 2kk (a0, a1) and
        // 2kk+1 (a2, a3) of the score accumulators.
        uint32_t pa[NS / 2][4];
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            const float p0 = exp2_approx(s[j][0] - mn0), p1 = exp2_approx(s[j][1] - mn0);
            const float p2 = exp2_approx(s[j][2] - mn1), p3 = exp2_approx(s[j][3] - mn1);
            rs0 += p0 + p1;
            rs1 += p2 + p3;
            pa[j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
            pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
        l0 = l0 * al0 + rs0;
        l1 = l1 * al1 + rs1;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
            oacc[n][0] *= al0;
            oacc[n][1] *= al0;
            oacc[n][2] *= al1;
            oacc[n][3] *= al1;
        }

        // O += P.V
        const bf16* vt = v_s + sc * BKT * RS;
#pragma unroll
        for (int kk = 0; kk < BKT / 16; ++kk) {
            const bf16* vrow = vt + (kk * 16 + v_row) * RS;
#pragma unroll
            for (int nd = 0; nd < NO / 2; ++nd) {
                uint32_t bv[4];
                ldmatrix_x4_trans(bv, smem_addr(vrow + nd * 16 + v_col));
                mma_bf16(oacc[2 * nd], pa[kk], bv[0], bv[1]);
                mma_bf16(oacc[2 * nd + 1], pa[kk], bv[2], bv[3]);
            }
            if constexpr (NO % 2) {
                uint32_t bv[2];
                ldmatrix_x2_trans(bv, smem_addr(vrow + (NO - 1) * 8));
                mma_bf16(oacc[NO - 1], pa[kk], bv[0], bv[1]);
            }
        }
        cur = next_seen(cur + 1);
        sc = sc + 1 == NSTAGE ? 0 : sc + 1;
    }
    cp_async_wait<0>();

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
    bf16* ob = o + (size_t(b) * S + q0) * q_stride + size_t(h) * D + 2 * tig;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        if (r0 < rows)
            *reinterpret_cast<uint32_t*>(ob + size_t(r0) * q_stride + n * 8) =
                pack_bf16(oacc[n][0] * inv0, oacc[n][1] * inv0);
        if (r1 < rows)
            *reinterpret_cast<uint32_t*>(ob + size_t(r1) * q_stride + n * 8) =
                pack_bf16(oacc[n][2] * inv1, oacc[n][3] * inv1);
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr int kMaxSmem = 232448;  // a block's shared memory on Hopper

template <typename Cfg>
int launch_tc(const void* q, const void* k, const void* v, const int* q_pos,
              const int* k_pos, void* o, int B, int S, int T_len, int Hq, int Hkv,
              int causal, int window, float softcap, float scale, cudaStream_t stream) {
    const auto kernel = flash_attention_tc_kernel<Cfg>;
    static const cudaError_t attr =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (attr != cudaSuccess) return int(attr);
    const int nT = (T_len + Cfg::BK - 1) / Cfg::BK;
    const size_t smem = Cfg::fixed_smem + 2 * size_t(nT);
    if (smem > size_t(kMaxSmem)) return int(cudaErrorInvalidValue);
    const dim3 grid(Hq * B, (S + Cfg::BQ - 1) / Cfg::BQ);
    kernel<<<grid, Cfg::NTHREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        q_pos, k_pos, static_cast<bf16*>(o), S, T_len, Hq, Hkv, causal, window, softcap, scale);
    return int(cudaGetLastError());
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const int* q_pos,
               const int* k_pos, void* o, int B, int S, int T_len, int Hq, int Hkv,
               int causal, int window, float softcap, float scale, cudaStream_t stream) {
    constexpr size_t smem = fa_smem_bytes<D>();
    static const cudaError_t attr = cudaFuncSetAttribute(
        flash_attention_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (attr != cudaSuccess) return int(attr);
    const dim3 grid((S + BQ - 1) / BQ, Hq, B);
    flash_attention_kernel<float, D><<<grid, NTHREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), q_pos, k_pos, static_cast<float*>(o), S, T_len, Hq, Hkv,
        causal, window, softcap, scale);
    return int(cudaGetLastError());
}

template <bool TENSOR_CORES>
int dispatch(const void* q, const void* k, const void* v, const void* q_pos,
             const void* k_pos, void* o, int B, int S, int T_len, int Hq, int Hkv, int D,
             int causal, int window, float softcap, float scale, void* stream) {
    const int* qp = static_cast<const int*>(q_pos);
    const int* kp = static_cast<const int*>(k_pos);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FA_CASE(DIM)                                                                 \
    case DIM:                                                                              \
        return TENSOR_CORES ? launch_tc<TcTile<DIM>>(q, k, v, qp, kp, o, B, S, T_len, Hq, \
                                                     Hkv, causal, window, softcap, scale,  \
                                                     st)                                   \
                            : launch_f32<DIM>(q, k, v, qp, kp, o, B, S, T_len, Hq, Hkv,   \
                                              causal, window, softcap, scale, st);
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
    return repro_torch::dispatch<true>(q, k, v, q_pos, k_pos, o, B, S, T_len, Hq, Hkv, D,
                                       causal, window, softcap, scale, stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   const void* q_pos, const void* k_pos, void* o, int B,
                                   int S, int T_len, int Hq, int Hkv, int D, int causal,
                                   int window, float softcap, float scale, void* stream) {
    return repro_torch::dispatch<false>(q, k, v, q_pos, k_pos, o, B, S, T_len, Hq, Hkv, D,
                                        causal, window, softcap, scale, stream);
}
