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
// At the serving shape (B = 8, Hkv = 8, 5266 valid keys of D = 128 in
// bf16) that is 21.6 MB, 6.5 us at 3.35 TB/s.  The TPU's grid, one
// program per (KV head, batch row) walking the whole row, put B * Hkv = 64
// blocks on 132 SMs, and the longest row's ~15 tiles, each a round trip
// to memory, set the time.
//
// Split-KV, as K3 (decode_attention.cu).  Pass 1 runs on a grid of (KV
// head, batch row, chunk): each block walks the keys of its chunk of
// `chunk` positions (a whole number of 64-key tiles) that the row can
// see, from the window's first key to q_pos, and writes its fp32 partial
// (m, l, acc[G, D]) to scratch the wrapper allocates; a chunk with no
// visible key (past q_pos, before the window, or a row with none) writes
// (kNegInf, 0, 0) at once.  Pass 2 (common.cuh:decode_merge_kernel, K3's)
// merges the partials.  The wrapper picks the chunks from the shapes alone
// (B, Hkv, the table's nb * bs positions, the SM count), never from q_pos,
// so one CUDA graph replays correctly as the rows advance; with one chunk,
// pass 1 writes the output itself.  Two pass-1 kernels, routed by dtype:
//   * bf16 (paged_decode_attention_tc_kernel): the G <= 16 heads are the
//     rows of one m16 tile of mma.sync products, K/V stay bf16 in shared
//     memory and arrive by cp.async, each warp walking its own 16-key
//     tiles two in flight; the warps merge their partials in shared
//     memory.  With K3's FMA tile step (K/V staged as fp32, scores and
//     P.V out of shared memory) the split kernel spent most of its time in
//     that arithmetic, not in its loads; on the tensor cores a tile is a
//     few dozen instructions a warp.
//   * fp32 (paged_decode_attention_kernel): K3's FMA tile step
//     (common.cuh:decode_tile), which holds fp32 to its tolerance.
// What bounds it now (PERF.md): at the serving shape it takes ~3x its
// bound; the two launches, the table reads ahead of each copy and the
// merge's pass over the partials are left.
// What the pool changes against K3:
//   * the key loop stops at q_pos: every key past it is invalid, so
//     skipping them is exact, and the kernel never reads a pool block past
//     the row's length (its unwritten tail, or the garbage entries of the
//     table);
//   * a tile spans one or several pool blocks: the pool row of each key
//     is resolved through the table, and the copies gather those rows
//     directly into shared memory, so the gathered K/V never exists in
//     device memory (the plain version materialises it);
//   * any block size works, not only divisors of the tile.
// A tensor-parallel rank whose query heads are split over a pool that
// holds every KV head reads its group's head in place: the call's Hkv
// groups of G heads read pool heads head0 .. head0 + Hkv - 1 of the
// pool's pool_heads (a pool row is pool_heads * D elements); a plain call
// has head0 = 0 and pool_heads = Hkv.

#include <climits>
#include <cstdint>
#include <type_traits>

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

// fp32 pass 1 over key positions [chunk * blockIdx.z, chunk * (blockIdx.z
// + 1)).  One chunk (gridDim.z == 1): writes o.  Else: writes the partials
// in K3's layout (common.cuh, above decode_merge_kernel).
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool, const int* __restrict__ tables,
                              const int* __restrict__ q_pos, T* __restrict__ o,
                              float* __restrict__ m_ws, float* __restrict__ l_ws,
                              float* __restrict__ acc_ws, int nb, int bs, int Hkv,
                              int pool_heads, int head0, int G, int chunk, int window,
                              float softcap, float scale) {
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
    const int c0 = blockIdx.z * chunk;
    const size_t kv_stride = size_t(pool_heads) * D;  // elements per pool row
    const int* tb = tables + size_t(b) * nb;
    const int qp = q_pos[b];
    // the keys of this chunk the row sees: [first, last], empty if first > last
    const int last = min(min(qp, nb * bs - 1), c0 + chunk - 1);
    const int first = max(window > 0 ? qp - window + 1 : 0, c0);
    const int GD = G * D;

    if (tid < G) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
    }
    float acc[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] = 0.f;
    if (first <= last) {
        const T* qb = q + (size_t(b) * Hkv + h) * GD;
        for (int e = tid; e < GD; e += NTHREADS) q_s[(e / D) * DP + e % D] = to_float(qb[e]);
    }
    __syncthreads();

    // every tile of the loop holds at least one visible key; c0 is a whole
    // number of tiles, so the first tile starts inside the chunk
    for (int t0 = first - first % BK; t0 <= last; t0 += BK) {
        if (tid < BK) {
            const int j = t0 + tid;
            row_s[tid] = j <= last ? tb[j / bs] * bs + j % bs : 0;
        }
        __syncthreads();
        stage_kv_rows<T, D, DP, BK, NTHREADS>(
            k_s, v_s, k_pool + size_t(head0 + h) * D, v_pool + size_t(head0 + h) * D,
            [&](int r) { return size_t(row_s[r]) * kv_stride; }, last - t0 + 1);
        __syncthreads();
        decode_tile<D, BK, NTHREADS>(q_s, k_s, v_s, s_s, m_s, l_s, a_s, acc, G, scale, softcap,
                                     [&](int c) { return t0 + c >= first && t0 + c <= last; });
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

// ---------------------------------------------------------------------------
// bf16 pass 1 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TK = 16;      // keys of a warp's tile: one mma k-step of P.V
constexpr int TC_STAGES = 2;
constexpr float kLn2 = 0.6931471805599453f;

// Shared layout of the tensor-core pass 1: Q (16 rows, the G heads and
// zero rows), then each warp's ring of TC_STAGES (K, V) tiles of TK rows,
// bf16 rows padded by 16 bytes (ldmatrix without bank conflicts), then
// each warp's m and l.  After the key loop the rings hold each warp's
// unnormalised output (16 x D fp32) for the merge of the warps.
template <int D>
struct PagedTc {
    static constexpr int DK = D < 16 ? 16 : D;  // contraction padded to the mma depth
    static constexpr int RS = DK + 8;           // shared row stride, bf16
    static constexpr int CH = D / 8;            // 16-byte chunks of a pool row
    static constexpr int NKQ = DK / 16;         // k-steps of Q.K^T
    static constexpr int NO = D / 8;            // output n-tiles
    static constexpr bool QREG = D <= 128;      // Q fragments kept in registers
    static constexpr size_t ring = size_t(TC_STAGES) * 2 * TK * RS;  // a warp's, bf16
    static constexpr size_t smem =
        sizeof(bf16) * (16 * size_t(RS) + TC_WARPS * ring) + sizeof(float) * 2 * TC_WARPS * 16;
    static_assert(sizeof(float) * TC_WARPS * 16 * D <= sizeof(bf16) * TC_WARPS * ring,
                  "the warps' outputs fit in their rings");
};

// Pass 1 of the bf16 kernel over key positions [chunk * blockIdx.z, chunk *
// (blockIdx.z + 1)), as paged_decode_attention_kernel, with the G heads as
// the rows of one m16 tile: S = Q.K^T and O += P.V are mma.sync m16n8k16
// products.  Warp w takes the 16-key tiles w, w + 4, ... of the visible
// keys and walks them through its own ring, two tiles in flight by
// cp.async, the pool rows gathered through the table (looked up two tiles
// ahead); no block barrier inside the loop.  Scores, mask and the online
// softmax (log2 units) stay in the accumulator fragments, as in
// flash_attention_tc_kernel.  Then the four warps' (m, l, O) merge in
// shared memory into the block's partial.
template <int D>
__global__ void __launch_bounds__(TC_THREADS)
paged_decode_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                                 const bf16* __restrict__ v_pool,
                                 const int* __restrict__ tables, const int* __restrict__ q_pos,
                                 bf16* __restrict__ o, float* __restrict__ m_ws,
                                 float* __restrict__ l_ws, float* __restrict__ acc_ws, int nb,
                                 int bs, int Hkv, int pool_heads, int head0, int G, int chunk,
                                 int window, float softcap, float scale) {
    using Cfg = PagedTc<D>;
    constexpr int DK = Cfg::DK, RS = Cfg::RS, CH = Cfg::CH, NKQ = Cfg::NKQ, NO = Cfg::NO;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int h = blockIdx.x, b = blockIdx.y;
    const int c0 = blockIdx.z * chunk;
    const int qp = q_pos[b];
    const int last = min(min(qp, nb * bs - 1), c0 + chunk - 1);
    const int first = max(window > 0 ? qp - window + 1 : 0, c0);
    const int GD = G * D;
    const size_t part = (size_t(b) * Hkv + h) * gridDim.z + blockIdx.z;
    if (first > last) {  // no visible key: (kNegInf, 0, 0), or 0
        for (int e = tid; e < GD; e += TC_THREADS) {
            if (gridDim.z == 1) {
                o[(size_t(b) * Hkv + h) * GD + e] = __float2bfloat16(0.f);
            } else {
                acc_ws[part * GD + e] = 0.f;
                if (e < G) {
                    m_ws[part * G + e] = kNegInf;
                    l_ws[part * G + e] = 0.f;
                }
            }
        }
        return;
    }

    extern __shared__ uint4 smem_pda[];
    bf16* q_s = reinterpret_cast<bf16*>(smem_pda);                 // 16 x RS
    bf16* ring = q_s + 16 * RS + warp * Cfg::ring;                 // this warp's stages
    float* m_s = reinterpret_cast<float*>(q_s + 16 * RS + TC_WARPS * Cfg::ring);
    float* l_s = m_s + TC_WARPS * 16;
    float* o_s = reinterpret_cast<float*>(q_s + 16 * RS);          // after the loop

    const bf16* qb = q + (size_t(b) * Hkv + h) * GD;
    for (int e = tid; e < 16 * DK; e += TC_THREADS) {
        const int r = e / DK, c = e % DK;
        q_s[r * RS + c] = r < G && c < D ? qb[r * D + c] : __float2bfloat16(0.f);
    }
    if constexpr (DK > D) {  // D = 8: the copies never write K's pad columns
        for (int r = lane; r < TC_STAGES * 2 * TK; r += 32)
            *reinterpret_cast<uint4*>(ring + r * RS + D) = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();

    // This warp's tiles start at t_beg + (warp + TC_WARPS * k) * TK.
    const int t_beg = first - first % TK;
    const int n_tiles = (last - t_beg) / TK + 1;
    const int my_n = n_tiles > warp ? (n_tiles - warp + TC_WARPS - 1) / TC_WARPS : 0;
    auto tile_start = [&](int k) { return t_beg + (warp + TC_WARPS * k) * TK; };
    const int* tb = tables + size_t(b) * nb;
    // the pool block of key lane % TK of tile k, -1 past `last`
    auto lookup = [&](int k) {
        const int j = tile_start(k) + lane % TK;
        return k < my_n && j <= last ? __ldg(tb + j / bs) : -1;
    };
    const size_t kv_stride = size_t(pool_heads) * D;
    const bf16* kh = k_pool + size_t(head0 + h) * D;
    const bf16* vh = v_pool + size_t(head0 + h) * D;
    auto issue = [&](int k, int blk, int st) {
        const int t0 = tile_start(k);
        bf16* ks = ring + st * 2 * TK * RS;
        bf16* vs = ks + TK * RS;
#pragma unroll
        for (int i = 0; i < (TK * CH + 31) / 32; ++i) {
            const int e = lane + 32 * i, r = min(e / CH, TK - 1), c = e % CH;
            const int rb = __shfl_sync(0xffffffffu, blk, r);
            if (e < TK * CH) {
                const size_t src =
                    rb >= 0 ? (size_t(rb) * bs + (t0 + r) % bs) * kv_stride + c * 8 : 0;
                cp_async16(smem_addr(ks + r * RS + c * 8), kh + src, rb >= 0 ? 16 : 0);
                cp_async16(smem_addr(vs + r * RS + c * 8), vh + src, rb >= 0 ? 16 : 0);
            }
        }
    };

    // ldmatrix row addresses of this lane (as in flash_attention_tc_kernel)
    const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
    const int k_row = (lane % 8) + 8 * (lane / 16), k_col = 8 * ((lane / 8) % 2);
    const int v_row = (lane % 8) + 8 * ((lane / 8) % 2), v_col = 8 * (lane / 16);
    uint32_t qf[Cfg::QREG ? NKQ : 1][4];
    if constexpr (Cfg::QREG) {
#pragma unroll
        for (int kk = 0; kk < NKQ; ++kk)
            ldmatrix_x4(qf[kk], smem_addr(q_s + a_row * RS + kk * 16 + a_col));
    }
    const int tig = lane % 4;
    float oacc[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[n][e] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows lane / 4 and + 8
    const bool capped = softcap > 0.f;
    const float pre = capped ? scale / softcap : scale * kLog2e;
    const float post = capped ? softcap * kLog2e : 1.f;

    issue(0, lookup(0), 0);  // my_n >= 1 for warp 0; others may copy nothing
    cp_async_commit();
    issue(1, lookup(1), 1);
    cp_async_commit();
    for (int kt = 0; kt < my_n; ++kt) {
        const int st = kt & 1;
        const int blk2 = lookup(kt + 2);  // the table two tiles ahead
        cp_async_wait<1>();
        __syncwarp();
        const bf16* ks = ring + st * 2 * TK * RS;
        const bf16* vs = ks + TK * RS;

        float s[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < NKQ; ++kk) {
            uint32_t a[4];
            if constexpr (Cfg::QREG) {
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = qf[kk][i];
            } else {
                ldmatrix_x4(a, smem_addr(q_s + a_row * RS + kk * 16 + a_col));
            }
            uint32_t bk[4];
            ldmatrix_x4(bk, smem_addr(ks + k_row * RS + kk * 16 + k_col));
            mma_bf16(s[0], a, bk[0], bk[1]);
            mma_bf16(s[1], a, bk[2], bk[3]);
        }

        const int t0 = tile_start(kt);
        const bool masked = t0 < first || t0 + TK - 1 > last;
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float x = s[j][e] * pre;
                s[j][e] = capped ? post * tanh_exp(x) : x;
                const int key = t0 + j * 8 + 2 * tig + (e & 1);
                if (masked && (key < first || key > last)) s[j][e] = -INFINITY;
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
        uint32_t pa[4];
        float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const float p0 = exp2_approx(s[j][0] - mn0), p1 = exp2_approx(s[j][1] - mn0);
            const float p2 = exp2_approx(s[j][2] - mn1), p3 = exp2_approx(s[j][3] - mn1);
            rs0 += p0 + p1;
            rs1 += p2 + p3;
            pa[2 * j] = pack_bf16(p0, p1);
            pa[2 * j + 1] = pack_bf16(p2, p3);
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
        const bf16* vrow = vs + v_row * RS;
#pragma unroll
        for (int nd = 0; nd < NO / 2; ++nd) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, smem_addr(vrow + nd * 16 + v_col));
            mma_bf16(oacc[2 * nd], pa, bv[0], bv[1]);
            mma_bf16(oacc[2 * nd + 1], pa, bv[2], bv[3]);
        }
        if constexpr (NO % 2) {
            uint32_t bv[2];
            ldmatrix_x2_trans(bv, smem_addr(vrow + (NO - 1) * 8));
            mma_bf16(oacc[NO - 1], pa, bv[0], bv[1]);
        }
        __syncwarp();  // every lane is done with stage st before it refills
        if (kt + 2 < my_n) issue(kt + 2, blk2, st);
        cp_async_commit();
    }
    cp_async_wait<0>();
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }

    // Merge the warps: their (m, l) and O through shared memory (O over
    // the rings, once every warp is done with its own).
    __syncthreads();
    const int r0 = lane / 4;
    float* ow = o_s + warp * 16 * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
        *reinterpret_cast<float2*>(ow + r0 * D + n * 8 + 2 * tig) =
            make_float2(oacc[n][0], oacc[n][1]);
        *reinterpret_cast<float2*>(ow + (r0 + 8) * D + n * 8 + 2 * tig) =
            make_float2(oacc[n][2], oacc[n][3]);
    }
    if (tig == 0) {
        m_s[warp * 16 + r0] = m0;
        m_s[warp * 16 + r0 + 8] = m1;
        l_s[warp * 16 + r0] = l0;
        l_s[warp * 16 + r0 + 8] = l1;
    }
    __syncthreads();
    for (int e = tid; e < GD; e += TC_THREADS) {
        const int r = e / D, d = e % D;
        float mx = kNegInf;
#pragma unroll
        for (int w = 0; w < TC_WARPS; ++w) mx = fmaxf(mx, m_s[w * 16 + r]);
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int w = 0; w < TC_WARPS; ++w) {
            const float wt = exp2_approx(m_s[w * 16 + r] - mx);
            num = fmaf(wt, o_s[(w * 16 + r) * D + d], num);
            den = fmaf(wt, l_s[w * 16 + r], den);
        }
        if (gridDim.z == 1) {
            o[(size_t(b) * Hkv + h) * GD + e] = __float2bfloat16(num / fmaxf(den, 1e-30f));
        } else {
            acc_ws[part * GD + e] = num;
            if (d == 0) {  // the merge's m is in natural-log units
                m_ws[part * G + r] = mx * kLn2;
                l_ws[part * G + r] = den;
            }
        }
    }
}

template <typename T, int D>
int launch(const void* q, const void* k_pool, const void* v_pool, const int* tables,
           const int* q_pos, void* o, float* m_ws, float* l_ws, float* acc_ws, int B, int nb,
           int bs, int Hkv, int pool_heads, int head0, int G, int chunk, int n_split,
           int window, float softcap, float scale, cudaStream_t stream) {
    const dim3 grid(Hkv, B, n_split);
    if constexpr (std::is_same<T, bf16>::value) {
        static const cudaError_t attr = cudaFuncSetAttribute(
            paged_decode_attention_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            int(PagedTc<D>::smem));
        if (attr != cudaSuccess) return int(attr);
        paged_decode_attention_tc_kernel<D><<<grid, TC_THREADS, PagedTc<D>::smem, stream>>>(
            static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
            static_cast<const bf16*>(v_pool), tables, q_pos, static_cast<bf16*>(o), m_ws, l_ws,
            acc_ws, nb, bs, Hkv, pool_heads, head0, G, chunk, window, softcap, scale);
    } else {
        static const cudaError_t attr = cudaFuncSetAttribute(
            paged_decode_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            int(pda_smem_bytes<D>(kMaxGroup)));
        if (attr != cudaSuccess) return int(attr);
        paged_decode_attention_kernel<T, D><<<grid, NTHREADS, pda_smem_bytes<D>(G), stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k_pool),
            static_cast<const T*>(v_pool), tables, q_pos, static_cast<T*>(o), m_ws, l_ws,
            acc_ws, nb, bs, Hkv, pool_heads, head0, G, chunk, window, softcap, scale);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || n_split == 1) return int(err);
    return int(launch_decode_merge<T>(m_ws, l_ws, acc_ws, static_cast<T*>(o), B * Hkv * G, G,
                                      D, n_split, stream));
}

template <typename T>
int dispatch(const void* q, const void* k_pool, const void* v_pool, const void* tables,
             const void* q_pos, void* o, void* m_ws, void* l_ws, void* acc_ws, int B, int nb,
             int bs, int Hkv, int pool_heads, int head0, int G, int D, int chunk, int n_split,
             int window, float softcap, float scale, void* stream) {
    if (G < 1 || G > kMaxGroup || bs < 1 || nb < 1 || size_t(nb) * bs > size_t(INT_MAX) ||
        Hkv < 1 || head0 < 0 || head0 + Hkv > pool_heads ||
        !split_plan_ok(nb * bs, chunk, n_split, BK, m_ws, l_ws, acc_ws))
        return int(cudaErrorInvalidValue);
    const int* tp = static_cast<const int*>(tables);
    const int* qp = static_cast<const int*>(q_pos);
    float* m = static_cast<float*>(m_ws);
    float* l = static_cast<float*>(l_ws);
    float* acc = static_cast<float*>(acc_ws);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_PDA_CASE(DIM)                                                                \
    case DIM:                                                                              \
        return launch<T, DIM>(q, k_pool, v_pool, tp, qp, o, m, l, acc, B, nb, bs, Hkv,     \
                              pool_heads, head0, G, chunk, n_split, window, softcap,      \
                              scale, st);
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
// the CUDA status of its launches; 0 is success.  They launch on `stream`
// and never synchronise, so a CUDA graph can capture them.  m_ws, l_ws:
// B * Hkv * n_split * G floats; acc_ws: that times D (unused, and may be
// null, when n_split is 1).  q holds Hkv groups of G heads, which read
// pool heads head0 .. head0 + Hkv - 1 of the pool's pool_heads.  The
// chunks must cover the table's nb * bs positions and every one of them
// hold a position: chunk * (n_split - 1) < nb * bs <= chunk * n_split.
extern "C" int paged_decode_attention_bf16(const void* q, const void* k_pool,
                                           const void* v_pool, const void* tables,
                                           const void* q_pos, void* o, void* m_ws,
                                           void* l_ws, void* acc_ws, int B, int nb, int bs,
                                           int Hkv, int pool_heads, int head0, int G, int D,
                                           int chunk, int n_split, int window, float softcap,
                                           float scale, void* stream) {
    return repro_torch::dispatch<__nv_bfloat16>(q, k_pool, v_pool, tables, q_pos, o, m_ws,
                                                l_ws, acc_ws, B, nb, bs, Hkv, pool_heads,
                                                head0, G, D, chunk, n_split, window, softcap,
                                                scale, stream);
}

extern "C" int paged_decode_attention_f32(const void* q, const void* k_pool,
                                          const void* v_pool, const void* tables,
                                          const void* q_pos, void* o, void* m_ws, void* l_ws,
                                          void* acc_ws, int B, int nb, int bs, int Hkv,
                                          int pool_heads, int head0, int G, int D, int chunk,
                                          int n_split, int window, float softcap, float scale,
                                          void* stream) {
    return repro_torch::dispatch<float>(q, k_pool, v_pool, tables, q_pos, o, m_ws, l_ws,
                                        acc_ws, B, nb, bs, Hkv, pool_heads, head0, G, D, chunk,
                                        n_split, window, softcap, scale, stream);
}
