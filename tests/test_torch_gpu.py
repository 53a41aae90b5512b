"""The port's Hopper kernels against their plain PyTorch versions, on a GPU.

Every test here carries the ``gpu`` marker and skips (inside the ``cuda``
fixture) where there is no CUDA device; on the card run
``python -m pytest -m gpu tests/test_torch_*.py``.  This file imports
neither JAX nor the reference package, which the card's machine does not
have.  Tolerances are the reference's kernel tolerances: 2e-5 in fp32,
2e-2 in bf16.
"""

import zlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.linear_recurrence import ops as lr_ops  # noqa: E402
from repro_torch.kernels.linear_recurrence import ref as lr_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rn_ref  # noqa: E402

pytestmark = pytest.mark.gpu

DTYPES = ["float32", "bfloat16"]
# llava-next-34b's heads: G = 56 / 8 = 7
FLASH_SHAPES = [(128, 4, 4, 64), (128, 8, 2, 64), (256, 4, 1, 128), (96, 4, 2, 80),
                (100, 8, 2, 8), (512, 32, 8, 128), (70, 2, 1, 256), (200, 56, 8, 128)]
FLASH_MASKS = [(True, 0), (True, 32), (False, 0)]
DECODE_SHAPES = [(256, 8, 2, 64), (512, 4, 4, 128), (128, 16, 1, 64), (96, 4, 2, 80),
                 (545, 32, 8, 128), (300, 12, 1, 256), (1057, 56, 8, 128)]
# (G, D, bs) of the paged sweep; Hkv = 2
PAGED_SHAPES = [(g, d, bs) for g in (1, 4, 7, 12) for d in (64, 128) for bs in (16, 32)]
# (B, S, W) of K5: the measure prefill, a prompt past the 2048 window, the
# serving decode step, ragged shapes; serving admission of 8 prompts of 512
# (3 chunks), and 2 chunks of 32 steps
LINREC_SHAPES = [(1, 512, 2560), (1, 2304, 2560), (8, 1, 2560), (2, 37, 100), (3, 300, 129),
                 (8, 512, 2560), (4, 64, 200)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _on(dev, dtype, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev, getattr(torch, dtype))
            for a in arrays]


def _ints(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev) for a in arrays]


def _assert(got, want, dtype):
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(), rtol=tol, atol=tol)


def _flash_inputs(B, S, T, Hq, Hkv, D, k_offset=0):
    rng = _rng("flash", B, S, T, Hq, Hkv, D, k_offset)
    return (rng.standard_normal((B, S, Hq, D), np.float32),
            rng.standard_normal((B, T, Hkv, D), np.float32),
            rng.standard_normal((B, T, Hkv, D), np.float32),
            np.broadcast_to(np.arange(S), (B, S)).copy(),
            np.broadcast_to(np.arange(T) + k_offset, (B, T)).copy())


def _decode_inputs(B, L, Hq, Hkv, D):
    rng = _rng("decode", B, L, Hq, Hkv, D)
    return (rng.standard_normal((B, 1, Hq, D), np.float32),
            rng.standard_normal((B, L, Hkv, D), np.float32),
            rng.standard_normal((B, L, Hkv, D), np.float32))


@pytest.mark.parametrize("S,Hq,Hkv,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_kernel_matches_plain(cuda, S, Hq, Hkv, D, dtype, causal, window):
    q, k, v, qp, kp = _flash_inputs(2, S, S, Hq, Hkv, D)
    q, k, v = _on(cuda, dtype, q, k, v)
    qp, kp = _ints(cuda, qp, kp)
    kw = dict(q_positions=qp, k_positions=kp, causal=causal, window=window, softcap=0.0)
    n = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert fa_ops.flash_attention.launches == n + 1
    _assert(got, fa_ref.attention(q, k, v, **kw), dtype)


@pytest.mark.parametrize("S,T", [(96, 136), (512, 272), (1, 40)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_unmasked_cross_attention(cuda, S, T, dtype):
    """An encoder-decoder's cross attention: no causal mask, S queries at
    their own positions over T memory rows at 0, the last 16 (or 0) of
    them unfilled (-1), MHA at D = 64 (seamless-m4t-large-v2's heads)."""
    q, k, v, qp, _ = _flash_inputs(2, S, T, 16, 16, 64)
    kp = np.zeros((2, T), np.int64)
    kp[:, T - 16 if T > 40 else T:] = -1
    q, k, v = _on(cuda, dtype, q, k, v)
    qp, kp = _ints(cuda, qp, kp)
    kw = dict(q_positions=qp, k_positions=kp, causal=False, window=0, softcap=0.0)
    _assert(fa_ops.flash_attention(q, k, v, **kw), fa_ref.attention(q, k, v, **kw), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernel_softcap_cache_positions_and_empty_rows(cuda, dtype):
    """Keys at positions 10.. with every 7th slot empty (-1): rows 0..9 see
    no key and must be 0; softcap and window on."""
    q, k, v, qp, kp = _flash_inputs(2, 80, 96, 8, 2, 64, k_offset=10)
    kp[:, ::7] = -1
    q, k, v = _on(cuda, dtype, q, k, v)
    qp, kp = _ints(cuda, qp, kp)
    kw = dict(q_positions=qp, k_positions=kp, causal=True, window=40, softcap=30.0)
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert torch.all(got[:, :10] == 0)
    _assert(got, fa_ref.attention(q, k, v, **kw), dtype)


@pytest.mark.parametrize("L,Hq,Hkv,D", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_kernel_matches_plain(cuda, L, Hq, Hkv, D, dtype):
    q, kc, vc = _on(cuda, dtype, *_decode_inputs(3, L, Hq, Hkv, D))
    qp = np.asarray([[L // 3], [L // 2], [L - 1]])
    kp = np.broadcast_to(np.arange(L), (3, L))
    qp, kp = _ints(cuda, qp, np.where(kp <= qp, kp, -1))   # partially filled cache
    kw = dict(q_positions=qp, k_positions=kp, window=0, softcap=0.0)
    n = da_ops.decode_attention.launches
    got = da_ops.decode_attention(q, kc, vc, **kw)
    assert da_ops.decode_attention.launches == n + 1
    _assert(got, da_ref.decode_attention(q, kc, vc, **kw), dtype)


def test_decode_kernel_ring_softcap_and_empty_row(cuda):
    B, L, cur = 3, 64, 150
    q, kc, vc = _on(cuda, "float32", *_decode_inputs(B, L, 8, 2, 32))
    kp = np.broadcast_to(cur - ((cur - np.arange(L)) % L), (B, L)).copy()
    kp[0] = -1
    qp, kp = _ints(cuda, np.full((B, 1), cur), kp)
    kw = dict(q_positions=qp, k_positions=kp, window=L, softcap=30.0)
    got = da_ops.decode_attention(q, kc, vc, **kw)
    assert torch.all(got[0] == 0)
    _assert(got, da_ref.decode_attention(q, kc, vc, **kw), "float32")


def _flash_case(cuda, dtype, B, S, T, Hq, Hkv, D, q_offset=0, k_offset=0, **kw):
    """Queries at positions q_offset.., keys at k_offset..: with q_offset =
    T - S + k_offset, a chunk of S new tokens over a cache of T - S."""
    q, k, v, _, _ = _flash_inputs(B, S, T, Hq, Hkv, D, k_offset)
    qp = np.broadcast_to(np.arange(S) + q_offset, (B, S))
    kp = np.broadcast_to(np.arange(T) + k_offset, (B, T))
    q, k, v = _on(cuda, dtype, q, k, v)
    qp, kp = _ints(cuda, qp, kp)
    kw = dict(q_positions=qp, k_positions=kp, causal=True, **kw)
    return fa_ops.flash_attention(q, k, v, **kw), fa_ref.attention(q, k, v, **kw)


@pytest.mark.parametrize("D", fa_ops.HEAD_DIMS)
def test_flash_bf16_tensor_cores_every_head_dim(cuda, D):
    """The tensor-core kernel at every head dim it takes: D = 8 pads the
    contraction to 16, D = 80 is five k-steps, D = 256 uses 32-key tiles
    and re-reads Q from shared memory; S = 100 leaves a ragged tile."""
    got, want = _flash_case(cuda, "bfloat16", 2, 100, 100, 4, 2, D)
    _assert(got, want, "bfloat16")


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("window", [0, 100])
def test_flash_bf16_chunk_over_a_cache(cuda, D, window):
    """S != T: 96 queries at positions 320..415 over 400 keys at 16..415,
    as a prefill chunk over a cache passes them."""
    got, want = _flash_case(cuda, "bfloat16", 2, 96, 400, 8, 2, D, q_offset=320,
                            k_offset=16, window=window)
    _assert(got, want, "bfloat16")


@pytest.mark.parametrize("D", [128, 256])
def test_flash_bf16_softcap_window_and_empty_rows(cuda, D):
    """recurrentgemma's masks on the tensor cores: softcap 30, a window,
    keys from position 10 with every 7th slot empty; rows 0..9 see no key
    and must be exactly 0."""
    q, k, v, qp, kp = _flash_inputs(2, 80, 96, 10, 1, D, k_offset=10)
    kp[:, ::7] = -1
    q, k, v = _on(cuda, "bfloat16", q, k, v)
    qp, kp = _ints(cuda, qp, kp)
    kw = dict(q_positions=qp, k_positions=kp, causal=True, window=40, softcap=30.0)
    got = fa_ops.flash_attention(q, k, v, **kw)
    assert torch.all(got[:, :10] == 0)
    _assert(got, fa_ref.attention(q, k, v, **kw), "bfloat16")


@pytest.mark.parametrize("S", [70, 130])
def test_flash_bf16_ragged_d256(cuda, S):
    """D = 256 with a ragged last query tile and a ragged key tile, softcap
    and window as recurrentgemma runs them."""
    got, want = _flash_case(cuda, "bfloat16", 1, S, S, 10, 1, 256, window=48, softcap=30.0)
    _assert(got, want, "bfloat16")


def _ring_positions(B, L, cur):
    """A ring of L slots decoded up to position ``cur``: slot j holds the
    latest position = j (mod L)."""
    return np.broadcast_to(cur - ((cur - np.arange(L)) % L), (B, L)).copy()


def _decode_case(cuda, dtype, q, kc, vc, qp, kp, **kw):
    """The kernel's output and the plain version's; the kernel is also held
    to the split merge algebra at the chunks it splits the cache into."""
    q, kc, vc = _on(cuda, dtype, q, kc, vc)
    qp, kp = _ints(cuda, qp, kp)
    kw = dict(q_positions=qp, k_positions=kp, **kw)
    got = da_ops.decode_attention(q, kc, vc, **kw)
    B, L, Hkv = kc.shape[:3]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunk = da_ops.split_plan(B, Hkv, L, sms)[1]
    _assert(got, da_ref.decode_attention_split(q, kc, vc, chunk=chunk, **kw), dtype)
    return got, da_ref.decode_attention(q, kc, vc, **kw)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_split_full_ring_mqa(cuda, dtype):
    """recurrentgemma's MQA shape over its whole 2048-slot ring, wrapped
    (position 2304), window 2048, softcap 30: 32 chunks of one tile."""
    B, L, cur = 1, 2048, 2304
    got, want = _decode_case(cuda, dtype, *_decode_inputs(B, L, 10, 1, 256),
                             np.full((B, 1), cur), _ring_positions(B, L, cur),
                             window=2048, softcap=30.0)
    _assert(got, want, dtype)


@pytest.mark.parametrize("Hq,Hkv,D", [(10, 1, 256), (32, 8, 128)])
def test_decode_split_window_empties_middle_chunks(cuda, Hq, Hkv, D):
    """A wrapped ring whose window of 300 leaves slots 0..100 and
    1849..2047 visible: every chunk in between sees no key."""
    B, L, cur = 2, 2048, 2 * 2048 + 100
    got, want = _decode_case(cuda, "bfloat16", *_decode_inputs(B, L, Hq, Hkv, D),
                             np.full((B, 1), cur), _ring_positions(B, L, cur), window=300)
    _assert(got, want, "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_split_row_empty_everywhere(cuda, dtype):
    """Row 1's cache is empty over every chunk: exactly 0; rows 0 and 2
    are filled up to ragged positions, L = 1000 not a whole number of
    chunks."""
    B, L = 3, 1000
    kp = np.broadcast_to(np.arange(L), (B, L)).copy()
    qp = np.asarray([[999], [500], [613]])
    kp = np.where(kp <= qp, kp, -1)
    kp[1] = -1
    got, want = _decode_case(cuda, dtype, *_decode_inputs(B, L, 8, 2, 64), qp, kp)
    assert torch.all(got[1] == 0)
    _assert(got, want, dtype)


def test_decode_split_serving_shape(cuda):
    """recurrentgemma's serving step: B = 8 rows over 1024-slot rings at
    ragged positions, some wrapped, G = 10, D = 256, softcap 30."""
    B, L = 8, 1024
    cur = np.asarray([3, 64, 500, 1023, 1024, 1500, 2047, 3000])
    kp = np.stack([_ring_positions(1, L, c)[0] for c in cur])
    kp = np.where(kp >= 0, kp, -1)
    got, want = _decode_case(cuda, "bfloat16", *_decode_inputs(B, L, 10, 1, 256),
                             cur[:, None], kp, window=2048, softcap=30.0)
    _assert(got, want, "bfloat16")


def test_decode_split_in_a_cuda_graph(cuda):
    """One K3 call captured in a CUDA graph and replayed as q_pos advances
    across a chunk boundary (slots filled up to it): the same output as
    the eager call at every step."""
    B, L = 1, 2048
    q, kc, vc = _on(cuda, "bfloat16", *_decode_inputs(B, L, 10, 1, 256))
    qp = torch.zeros(B, 1, dtype=torch.int32, device=cuda)
    kp = torch.full((B, L), -1, dtype=torch.int32, device=cuda)
    slots = torch.arange(L, dtype=torch.int32, device=cuda)[None]
    kw = dict(q_positions=qp, k_positions=kp, window=2048, softcap=30.0)
    da_ops.decode_attention(q, kc, vc, **kw)  # build and load outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da_ops.decode_attention(q, kc, vc, **kw)
    for pos in (60, 63, 64, 65, 130, 1000, 2047):
        qp.fill_(pos)
        kp.copy_(torch.where(slots <= pos, slots, -1))
        graph.replay()
        torch.testing.assert_close(out, da_ops.decode_attention(q, kc, vc, **kw), rtol=0,
                                   atol=0)
        _assert(out, da_ref.decode_attention(q, kc, vc, **kw), "bfloat16")


def _paged_inputs(G, D, bs, q_pos, nb, window=0):
    """Rows with ragged q_pos over a shuffled pool; a row with q_pos 0 and
    an all-garbage table among them, and unused entries at block 0."""
    B, Hkv = len(q_pos), 2
    rng = _rng("paged", G, D, bs, tuple(q_pos), nb, window)
    N = B * nb + 5
    perm = rng.permutation(np.arange(1, N))
    tables = np.zeros((B, nb), np.int32)
    ptr = 0
    for b, p in enumerate(q_pos):
        need = 0 if b == 0 else p // bs + 1
        tables[b, :need] = perm[ptr:ptr + need]
        ptr += need
    return (rng.standard_normal((B, 1, G * Hkv, D), np.float32),
            rng.standard_normal((N, bs, Hkv, D), np.float32),
            rng.standard_normal((N, bs, Hkv, D), np.float32),
            tables, np.asarray(q_pos)[:, None])


@pytest.mark.parametrize("G,D,bs", PAGED_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_matches_plain(cuda, G, D, bs, dtype):
    q, kp, vp, tables, qp = _paged_inputs(G, D, bs, [0, 5, 63, 200, 17], nb=16)
    q, kp, vp = _on(cuda, dtype, q, kp, vp)
    tables, qp = _ints(cuda, tables, qp)
    kw = dict(block_tables=tables, q_positions=qp, window=0, softcap=0.0)
    n = da_ops.paged_decode_attention.launches
    got = da_ops.paged_decode_attention(q, kp, vp, **kw)
    assert da_ops.paged_decode_attention.launches == n + 1
    _assert(got, da_ref.paged_decode_attention(q, kp, vp, **kw), dtype)


@pytest.mark.parametrize("window,softcap", [(24, 0.0), (0, 30.0), (70, 30.0), (1, 0.0)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_window_and_softcap(cuda, window, softcap, dtype):
    q, kp, vp, tables, qp = _paged_inputs(8, 128, 16, [0, 9, 130, 255, 64, 300], nb=20,
                                          window=window)
    q, kp, vp = _on(cuda, dtype, q, kp, vp)
    tables, qp = _ints(cuda, tables, qp)
    kw = dict(block_tables=tables, q_positions=qp, window=window, softcap=softcap)
    _assert(da_ops.paged_decode_attention(q, kp, vp, **kw),
            da_ref.paged_decode_attention(q, kp, vp, **kw), dtype)


@pytest.mark.parametrize("q_head0", [0, 3, 6, 9])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernel_reads_the_rank_head_in_place(cuda, q_head0, dtype):
    """qwen2.5-1.5b's tensor-parallel rank at tp = 4: q (8, 1, 3, 128) over
    a pool (513, 16, 2, 128) that holds both KV heads; query head h reads
    pool head (q_head0 + h) // 6 in place, as the plain version does, one
    launch a call; the defaults read every pool head as before."""
    rng = _rng("paged head offset", q_head0)
    q_pos = [447, 768, 758, 604, 388, 823, 517, 953]
    tables = (rng.permutation(512)[:8 * 64] + 1).reshape(8, 64).astype(np.int32)
    q = rng.standard_normal((8, 1, 3, 128), np.float32)
    kp, vp = (rng.standard_normal((513, 16, 2, 128), np.float32) for _ in range(2))
    q, kp, vp = _on(cuda, dtype, q, kp, vp)
    tables, qp = _ints(cuda, tables, np.asarray(q_pos)[:, None])
    kw = dict(block_tables=tables, q_positions=qp, q_head0=q_head0, group=6)
    n = da_ops.paged_decode_attention.launches
    got = da_ops.paged_decode_attention(q, kp, vp, **kw)
    assert da_ops.paged_decode_attention.launches == n + 1
    _assert(got, da_ref.paged_decode_attention(q, kp, vp, **kw), dtype)
    head = q_head0 // 6
    _assert(got, da_ref.paged_decode_attention(q, kp[:, :, head:head + 1].contiguous(),
                                               vp[:, :, head:head + 1].contiguous(),
                                               block_tables=tables, q_positions=qp), dtype)
    with pytest.raises(ValueError, match="groups"):
        da_ops.paged_decode_attention(q, kp, vp, block_tables=tables, q_positions=qp,
                                      q_head0=4, group=6)


def test_paged_kernel_wrapper_raises_on_bad_inputs(cuda):
    q = torch.zeros(2, 1, 8, 64, device=cuda)
    pool = torch.zeros(9, 16, 2, 64, device=cuda)
    tables = torch.zeros(2, 4, dtype=torch.int32, device=cuda)
    qp = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    call = da_ops.paged_decode_attention
    with pytest.raises(TypeError):  # int64 tables
        call(q, pool, pool, block_tables=tables.long(), q_positions=qp)
    with pytest.raises(TypeError):  # pool dtype differs from q
        call(q, pool.bfloat16(), pool.bfloat16(), block_tables=tables, q_positions=qp)
    with pytest.raises(ValueError):  # non-contiguous pool
        call(q, pool.transpose(1, 2).contiguous().transpose(1, 2), pool,
             block_tables=tables, q_positions=qp)
    with pytest.raises(ValueError):  # tables for another batch
        call(q, pool, pool, block_tables=tables[:1], q_positions=qp)
    with pytest.raises(ValueError):  # 17 query heads per KV head
        call(torch.zeros(2, 1, 34, 64, device=cuda), pool, pool, block_tables=tables,
             q_positions=qp)
    with pytest.raises(ValueError):  # tables on the CPU
        call(q, pool, pool, block_tables=tables.cpu(), q_positions=qp)


def _paged_split_case(cuda, dtype, G, D, q_pos, bs=16, nb=64, Hkv=2, **kw):
    """K4 over rows at ``q_pos`` (a row at -1 has no valid key and an
    all-garbage table) through a shuffled pool: the kernel's output, held
    to the plain version and to the split merge algebra at the chunk the
    kernel itself splits into, and the plain output."""
    B = len(q_pos)
    rng = _rng("paged-split", G, D, bs, tuple(q_pos), nb, tuple(kw.items()))
    need = [max(p, -1) // bs + 1 for p in q_pos]
    N = sum(need) + 5
    perm = rng.permutation(np.arange(1, N))
    tables = np.zeros((B, nb), np.int32)
    ptr = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[ptr:ptr + n]
        ptr += n
    q, kp, vp = _on(cuda, dtype, rng.standard_normal((B, 1, G * Hkv, D), np.float32),
                    rng.standard_normal((N, bs, Hkv, D), np.float32),
                    rng.standard_normal((N, bs, Hkv, D), np.float32))
    tables, qp = _ints(cuda, tables, np.asarray(q_pos)[:, None])
    kw = dict(block_tables=tables, q_positions=qp, **kw)
    n = da_ops.paged_decode_attention.launches
    got = da_ops.paged_decode_attention(q, kp, vp, **kw)
    assert da_ops.paged_decode_attention.launches == n + 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunk = da_ops.split_plan(B, Hkv, nb * bs, sms)[1]
    _assert(got, da_ref.paged_decode_attention_split(q, kp, vp, chunk=chunk, **kw), dtype)
    want = da_ref.paged_decode_attention(q, kp, vp, **kw)
    _assert(got, want, dtype)
    return got


@pytest.mark.parametrize("D", da_ops.HEAD_DIMS)
@pytest.mark.parametrize("G", [1, 4, 12])
@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_split_every_head_dim(cuda, D, G, dtype):
    """Every head dim at G = 1, 4 and 12 (command-r-plus), bf16 and fp32,
    rows on the boundaries of 64-position chunks and of 256, the last
    position of the table, and a row with no valid key (exactly 0)."""
    got = _paged_split_case(cuda, dtype, G, D, [63, 64, 65, 255, 256, 1023, -1])
    assert torch.all(got[-1] == 0)


@pytest.mark.parametrize("window,softcap", [(100, 0.0), (300, 30.0), (1, 30.0)])
@pytest.mark.parametrize("bs", [16, 48])
def test_paged_split_window_empties_leading_chunks(cuda, window, softcap, bs):
    """A window leaves every chunk before q_pos - window + 1 with no
    visible key; block sizes 16 and 48 (not a divisor of the tile)."""
    _paged_split_case(cuda, "bfloat16", 4, 128, [1000, 700, 300, 64, 5], bs=bs,
                      nb=1023 // bs + 1, window=window, softcap=softcap)


def test_paged_split_in_a_cuda_graph(cuda):
    """One K4 call at llama3.1-8b's serving shape (8 rows of 64 blocks of
    16, G = 4, D = 128) captured in a CUDA graph and replayed as the rows'
    q_pos advance across chunk boundaries: the same output as the eager
    call at every step."""
    B, nb, bs, Hkv = 8, 64, 16, 8
    rng = _rng("paged-graph")
    tables = rng.permutation(np.arange(1, B * nb + 1)).reshape(B, nb)
    q, kp, vp = _on(cuda, "bfloat16", rng.standard_normal((B, 1, 32, 128), np.float32),
                    rng.standard_normal((B * nb + 1, bs, Hkv, 128), np.float32),
                    rng.standard_normal((B * nb + 1, bs, Hkv, 128), np.float32))
    (tables,) = _ints(cuda, tables)
    qp = torch.zeros(B, 1, dtype=torch.int32, device=cuda)
    kw = dict(block_tables=tables, q_positions=qp)
    da_ops.paged_decode_attention(q, kp, vp, **kw)  # build and load outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da_ops.paged_decode_attention(q, kp, vp, **kw)
    row = torch.arange(B, dtype=torch.int32, device=cuda)[:, None]
    for pos in (0, 62, 63, 64, 255, 256, 257, 700, 1015):
        qp.copy_(pos + row)  # rows one position apart, straddling each boundary
        graph.replay()
        torch.testing.assert_close(out, da_ops.paged_decode_attention(q, kp, vp, **kw),
                                   rtol=0, atol=0)
        _assert(out, da_ref.paged_decode_attention(q, kp, vp, **kw), "bfloat16")


def test_split_entry_points_refuse_bad_plans(cuda):
    """The C entry points of K4 and K5 return an error, and launch
    nothing, for a split without scratch, a chunk not a whole number of
    tiles, or chunks that do not cover the keys or steps."""
    from repro_torch.kernels import _build

    fns = _build.load()
    q = torch.zeros(2, 1, 8, 64, device=cuda)
    out = torch.full_like(q, 7.0)
    pool = torch.zeros(9, 16, 2, 64, device=cuda)
    tables = torch.zeros(2, 8, dtype=torch.int32, device=cuda)  # 128 positions a row
    qp = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    stats = torch.zeros(3, 4096, device=cuda)
    s = torch.cuda.current_stream().cuda_stream

    def paged(chunk, n_split, scratch):
        return fns["paged_decode_attention_f32"](
            q.data_ptr(), pool.data_ptr(), pool.data_ptr(), tables.data_ptr(), qp.data_ptr(),
            out.data_ptr(), *scratch, 2, 8, 16, 2, 2, 0, 4, 64, chunk, n_split, 0, 0.0, 0.125,
            s)

    full = [t.data_ptr() for t in stats]
    assert paged(64, 2, full) == 0       # two chunks of one tile: fine
    torch.cuda.synchronize()
    out.fill_(7.0)
    assert paged(32, 4, full) != 0       # chunk not a whole number of 64-key tiles
    assert paged(64, 2, [0, 0, 0]) != 0  # two chunks, no scratch
    assert paged(64, 3, full) != 0       # the third chunk is empty
    assert paged(64, 1, [0, 0, 0]) != 0  # stops short of the last 64 positions
    a = torch.ones(1, 100, 8, device=cuda)
    h = torch.full_like(a, 7.0)

    def scan(chunk, n_chunks, scratch):
        return fns["linear_recurrence_f32"](a.data_ptr(), a.data_ptr(), a[:, 0].data_ptr(),
                                            h.data_ptr(), *scratch, 1, 100, 8, chunk,
                                            n_chunks, s)

    agg = [stats[0].data_ptr(), stats[1].data_ptr()]
    assert scan(50, 2, [0, 0]) != 0      # two chunks, no scratch
    assert scan(32, 3, agg) != 0         # stops short of step 100
    assert scan(50, 3, agg) != 0         # the third chunk is empty
    torch.cuda.synchronize()
    assert torch.all(out == 7.0) and torch.all(h == 7.0)


def test_engine_cuda_graph_matches_eager(cuda):
    """A small engine's greedy streams through the captured decode step
    and through the same step run eagerly: identical, one dispatch per
    decode-only step, and the replays credited to the kernels' counts."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampling import SamplingParams

    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype="bfloat16",
                                                        param_dtype="bfloat16")
    model = model_lib.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    rng = _rng("engine")
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 30, 17, 9, 40)]
    outs = {}
    for graph in (True, False):
        eng = ServingEngine(model, max_batch=2, max_len=96, prompt_bucket=8,
                            cache_layout="paged", device=cuda, cuda_graph=graph)
        n0 = da_ops.paged_decode_attention.launches
        for i, p in enumerate(prompts):
            eng.submit(p, SamplingParams(max_new_tokens=6 + 3 * i))
        outs[graph] = {r.uid: r.output_tokens for r in eng.run()}
        n_attn = sum(k == "attn" for k in cfg.blocks())
        assert da_ops.paged_decode_attention.launches - n0 == n_attn * eng.decode_forwards
        assert eng.latency_summary()["dispatches_per_step_p50"] == 1
        assert eng.blocks_in_use == 0 and not eng._state["block_tables"].any()
    assert outs[True] == outs[False]
    assert [len(outs[True][i]) for i in range(5)] == [6 + 3 * i for i in range(5)]


def test_http_greedy_stream_matches_direct_engine(cuda):
    """Greedy requests through the HTTP server on the card, one at a time,
    stream exactly what the same engine settings emit driven directly:
    the engine thread replays the graphs the constructing thread captured,
    on the engine's device."""
    import asyncio

    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.client import stream_completion
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.serving.server import start_http_server

    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype="bfloat16",
                                                        param_dtype="bfloat16")
    model = model_lib.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    rng = _rng("http")
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (5, 30, 17)]
    kw = dict(max_batch=2, max_len=96, prompt_bucket=8, cache_layout="paged", device=cuda)
    direct = ServingEngine(model, **kw)
    want = []
    for p in prompts:
        direct.submit(np.asarray(p), SamplingParams(max_new_tokens=9))
        want.append(list(direct.run()[-1].output_tokens))
    with start_http_server(ServingEngine(model, **kw)) as handle:
        got = [asyncio.run(stream_completion(handle.url, p, max_tokens=9)) for p in prompts]
    assert all(not r.error for r in got)
    assert [r.tokens for r in got] == want
    assert all(r.client_ttft_s >= r.engine_ttft_s > 0 for r in got)


@pytest.mark.parametrize("shape", [(1, 4096), (512, 4096), (3, 7, 12288), (5, 100)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    rng = _rng("rmsnorm", shape)
    x, s = _on(cuda, dtype, rng.standard_normal(shape, np.float32),
               rng.standard_normal(shape[-1], np.float32) * 0.1)
    n = rn_ops.rmsnorm.launches
    got = rn_ops.rmsnorm(x, s)
    assert rn_ops.rmsnorm.launches == n + 1
    _assert(got, rn_ref.rmsnorm(x, s), dtype)


@pytest.mark.parametrize("shape", [(1, 4096), (8, 4096), (512, 4096), (3, 7, 12288), (5, 100)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rmsnorm_kernel_matches_plain(cuda, shape, dtype):
    """The fused mode: one launch; the sum bit for bit torch's ``x + r``,
    the norm within tolerance of the plain version."""
    rng = _rng("add_rmsnorm", shape)
    x, r, s = _on(cuda, dtype, rng.standard_normal(shape, np.float32),
                  rng.standard_normal(shape, np.float32) * 3.0,
                  rng.standard_normal(shape[-1], np.float32) * 0.1)
    n = rn_ops.rmsnorm.launches
    got_s, got_y = rn_ops.add_rmsnorm(x, r, s)
    assert rn_ops.rmsnorm.launches == n + 1
    assert torch.equal(got_s, x + r)
    _assert(got_y, rn_ref.add_rmsnorm(x, r, s)[1], dtype)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("rows", [1, 512])
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_rmsnorm_kernel_matches_the_whole_norm(cuda, rows, tp, dtype):
    """A width cut over ``tp`` ranks (xlstm-1.3b's mLSTM cell norm, W =
    4096): each slice's ``rmsnorm_sumsq``, their sum (the all-reduce),
    each slice normalised with it, two launches a slice; the slices side
    by side within tolerance of the plain norm of the whole rows, each
    launch within tolerance of its plain version."""
    rng = _rng("split rmsnorm", rows, tp)
    x, s = _on(cuda, dtype, rng.standard_normal((rows, 4096), np.float32),
               rng.standard_normal(4096, np.float32) * 0.1)
    parts = [t.contiguous() for t in x.chunk(tp, -1)]
    scales = [t.contiguous() for t in s.chunk(tp, -1)]
    n = rn_ops.rmsnorm.launches
    sums = [rn_ops.rmsnorm_sumsq(t) for t in parts]
    for got, t in zip(sums, parts):
        torch.testing.assert_close(got, rn_ref.sumsq(t), rtol=1e-5, atol=1e-3)
    stat = sum(sums)
    out = [rn_ops.rmsnorm(t, g, stat=stat, width=4096) for t, g in zip(parts, scales)]
    assert rn_ops.rmsnorm.launches == n + 2 * tp
    for got, t, g in zip(out, parts, scales):
        _assert(got, rn_ref.rmsnorm(t, g, stat=stat, width=4096), dtype)
    _assert(torch.cat(out, -1), rn_ref.rmsnorm(x, s), dtype)
    with pytest.raises(ValueError):
        rn_ops.rmsnorm(parts[0], scales[0], stat=stat, width=4096 // tp - 1)


@pytest.mark.parametrize("d", [4096, 100])
def test_rmsnorm_kernel_unaligned_rows_and_fp32_scale(cuda, d):
    """bf16 rows one element off 16-byte alignment (the one-element path)
    and an fp32 scale beside bf16 activations, plain and fused."""
    rng = _rng("rmsnorm unaligned", d)
    buf, rbuf = _on(cuda, "bfloat16", rng.standard_normal(8 * d + 1, np.float32),
                    rng.standard_normal(8 * d + 1, np.float32))
    x, r = buf[1:].view(8, d), rbuf[1:].view(8, d)
    (s,) = _on(cuda, "float32", rng.standard_normal(d, np.float32) * 0.1)
    _assert(rn_ops.rmsnorm(x, s), rn_ref.rmsnorm(x, s), "bfloat16")
    got_s, got_y = rn_ops.add_rmsnorm(x, r, s)
    assert torch.equal(got_s, x + r)
    _assert(got_y, rn_ref.add_rmsnorm(x, r, s)[1], "bfloat16")


def test_add_rmsnorm_raises_on_mismatched_inputs(cuda):
    x = torch.zeros(4, 64, device=cuda, dtype=torch.bfloat16)
    s = torch.zeros(64, device=cuda)
    n = rn_ops.rmsnorm.launches
    with pytest.raises(TypeError):
        rn_ops.add_rmsnorm(x, x.float(), s)
    with pytest.raises(ValueError):
        rn_ops.add_rmsnorm(x, x[:1], s)
    with pytest.raises(ValueError):
        rn_ops.add_rmsnorm(x, torch.zeros(64, 4, device=cuda, dtype=torch.bfloat16).t(), s)
    with pytest.raises(ValueError):
        rn_ops.add_rmsnorm(x, x.cpu(), s)
    assert rn_ops.rmsnorm.launches == n


def test_add_rmsnorm_replays_from_a_cuda_graph(cuda):
    """One fused call captured in a CUDA graph, replayed on new inputs
    written in place: equal to the eager call."""
    rng = _rng("add_rmsnorm graph")
    x, r, s = _on(cuda, "bfloat16", rng.standard_normal((8, 4096), np.float32),
                  rng.standard_normal((8, 4096), np.float32),
                  rng.standard_normal(4096, np.float32) * 0.1)
    rn_ops.add_rmsnorm(x, r, s)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_s, out_y = rn_ops.add_rmsnorm(x, r, s)
    for _ in range(3):
        x.copy_(torch.randn_like(x))
        r.copy_(torch.randn_like(r))
        graph.replay()
        want_s, want_y = rn_ops.add_rmsnorm(x, r, s)
        torch.cuda.synchronize()
        assert torch.equal(out_s, want_s) and torch.equal(out_y, want_y)


def test_dispatch_routes_cuda_tensors_to_the_kernels(cuda):
    x, s = torch.randn(4, 64, device=cuda), torch.zeros(64, device=cuda)
    n = rn_ops.rmsnorm.launches
    dispatch.rmsnorm(x, s)
    dispatch.add_rmsnorm(x, x, s)
    with dispatch.use_backend("torch"):
        dispatch.rmsnorm(x, s)
        dispatch.add_rmsnorm(x, x, s)
    assert rn_ops.rmsnorm.launches == n + 2


def test_kernel_wrappers_raise_on_bad_inputs(cuda):
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    pos = torch.arange(8, dtype=torch.int32, device=cuda)[None]
    with pytest.raises(ValueError):  # non-contiguous k
        fa_ops.flash_attention(q, q.transpose(1, 2).contiguous().transpose(1, 2), q,
                               q_positions=pos, k_positions=pos, causal=True)
    with pytest.raises(TypeError):  # int64 positions
        fa_ops.flash_attention(q, q, q, q_positions=pos.long(), k_positions=pos,
                               causal=True)
    with pytest.raises(ValueError):  # head dim the kernel does not take
        da_ops.decode_attention(torch.zeros(1, 1, 4, 12, device=cuda),
                                torch.zeros(1, 8, 4, 12, device=cuda),
                                torch.zeros(1, 8, 4, 12, device=cuda),
                                q_positions=pos[:, :1].contiguous(), k_positions=pos)


def _linrec_inputs(dev, shape, pad):
    """a in (0.8, 1), b ~ 0.1 N, h0 ~ N (the reference's sweep); ``pad``
    makes the last third of every row identity steps (a=1, b=0)."""
    Bn, S, W = shape
    rng = _rng("linrec", shape, pad)
    a = 1 / (1 + np.exp(-rng.standard_normal(shape))) * 0.2 + 0.8
    b = rng.standard_normal(shape) * 0.1
    if pad:
        a[:, S - S // 3:] = 1.0
        b[:, S - S // 3:] = 0.0
    return _on(dev, "float32", a, b, rng.standard_normal((Bn, W)))


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("shape", LINREC_SHAPES)
def test_linear_recurrence_kernel_matches_plain(cuda, shape, pad):
    """rtol 1e-4 / atol 1e-5, as the reference holds Pallas to its ref."""
    a, b, h0 = _linrec_inputs(cuda, shape, pad)
    n = lr_ops.linear_recurrence.launches
    got = lr_ops.linear_recurrence(a, b, h0)
    assert lr_ops.linear_recurrence.launches == n + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, lr_ref.linear_recurrence(a, b, h0), rtol=1e-4, atol=1e-5)
    _assert_chunked(cuda, got, a, b, h0)


def _assert_chunked(cuda, got, a, b, h0):
    """K5's output against the split algebra at the chunks it splits into."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunk = lr_ops.scan_plan(*a.shape, sms)[1]
    torch.testing.assert_close(got, lr_ref.linear_recurrence_chunked(a, b, h0, chunk),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 512, 2560), (8, 512, 2560)])
def test_linear_recurrence_split_decay_underflows(cuda, shape):
    """a in (0, 1e-3), as RG-LRU's gates can be: every chunk's decay
    product underflows to 0, which the split form takes exactly."""
    a, b, h0 = _linrec_inputs(cuda, shape, False)
    a = torch.from_numpy(_rng("underflow", shape).uniform(0.0, 1e-3, shape)).to(cuda, torch.float32)
    got = lr_ops.linear_recurrence(a, b, h0)
    torch.testing.assert_close(got, lr_ref.linear_recurrence(a, b, h0), rtol=1e-4, atol=1e-5)
    _assert_chunked(cuda, got, a, b, h0)


def test_linear_recurrence_wrapper_raises_on_bad_inputs(cuda):
    a, b, h0 = _linrec_inputs(cuda, (2, 8, 64), False)
    with pytest.raises(TypeError):  # bf16: the kernel takes fp32 only
        lr_ops.linear_recurrence(a.bfloat16(), b, h0)
    with pytest.raises(ValueError):  # non-contiguous
        lr_ops.linear_recurrence(a.transpose(1, 2).contiguous().transpose(1, 2), b, h0)
    with pytest.raises(ValueError):  # h0 not (B, W)
        lr_ops.linear_recurrence(a, b, h0[:1])
    with pytest.raises(ValueError):  # h0 on the CPU
        lr_ops.linear_recurrence(a, b, h0.cpu())


def test_rglru_decode_step_in_a_cuda_graph_matches_eager(cuda):
    """recurrentgemma's smoke decode step (RG-LRU and ring layers) captured
    once and replayed against the same steps run eagerly: the same logits
    and cache, and the row masked off by ``update_mask`` frozen, which is
    how the serving step gates idle slots inside its graph."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib

    cfg = get_config("recurrentgemma-2b", smoke=True)
    model = model_lib.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.from_numpy(_rng("rglru-graph").integers(0, cfg.vocab_size, (2, 20))).to(cuda)
    cache = model.init_cache(2, 40)
    logits, _ = model.prefill({"tokens": tokens}, cache)
    eager = [{k: t.clone() for k, t in e.items()} for e in cache]
    tok = logits.argmax(-1, keepdim=True)
    pos = torch.full((2,), 20, dtype=torch.int32, device=cuda)
    mask = torch.zeros(2, dtype=torch.bool, device=cuda)  # warm-up changes nothing
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        for _ in range(2):
            model.decode_step(tok, pos, cache, update_mask=mask)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = model.decode_step(tok, pos, cache, update_mask=mask)
    frozen = [{k: t[1].clone() for k, t in e.items() if t.dim()} for e in cache]

    mask.copy_(torch.tensor([True, False]))
    tok_e, pos_e = tok.clone(), pos.clone()
    for _ in range(5):
        graph.replay()
        want, _ = model.decode_step(tok_e, pos_e, eager, update_mask=mask)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        tok.copy_(out.argmax(-1, keepdim=True))
        tok_e = want.argmax(-1, keepdim=True)
        assert torch.equal(tok[0], tok_e[0])
        pos.add_(1)
        pos_e += 1
    torch.cuda.synchronize()
    assert (cache[2]["pos"][0] >= cfg.sliding_window).any()  # the ring wrapped
    for entry, ref, old in zip(cache, eager, frozen):
        for leaf, t in entry.items():
            torch.testing.assert_close(t, ref[leaf], rtol=1e-5, atol=1e-5)
            if t.dim():
                assert torch.equal(t[1], old[leaf]), leaf


@pytest.mark.parametrize("arch", ["nemotron-h-8b", "xlstm-1.3b"])
def test_xlstm_decode_step_in_a_cuda_graph_matches_eager(cuda, arch):
    """The xLSTM smoke decode step (mLSTM, and sLSTM for xlstm-1.3b, beside
    attention and FFN layers for nemotron-h-8b) captured once and replayed
    against the same steps run eagerly: the same logits and states, and the
    row masked off by ``update_mask`` frozen; then the cache reset in place
    (stabilizers back at -1e30) and the capture replayed from a fresh
    prefill, as the measured loop does."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.models.cache import M_INIT, reset_cache

    cfg = get_config(arch, smoke=True)
    model = model_lib.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.from_numpy(_rng("xlstm-graph", arch).integers(0, cfg.vocab_size, (2, 20)))
    tokens = tokens.to(cuda)
    cache = model.init_cache(2, 40)
    logits, _ = model.prefill({"tokens": tokens}, cache)
    eager = [{k: t.clone() for k, t in e.items()} for e in cache]
    tok = logits.argmax(-1, keepdim=True)
    pos = torch.full((2,), 20, dtype=torch.int32, device=cuda)
    mask = torch.zeros(2, dtype=torch.bool, device=cuda)  # warm-up changes nothing
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        for _ in range(2):
            model.decode_step(tok, pos, cache, update_mask=mask)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, _ = model.decode_step(tok, pos, cache, update_mask=mask)
    frozen = [{k: t[1].clone() for k, t in e.items() if t.dim()} for e in cache]

    mask.copy_(torch.tensor([True, False]))
    tok_e, pos_e = tok.clone(), pos.clone()
    for _ in range(5):
        graph.replay()
        want, _ = model.decode_step(tok_e, pos_e, eager, update_mask=mask)
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        tok.copy_(out.argmax(-1, keepdim=True))
        tok_e = want.argmax(-1, keepdim=True)
        assert torch.equal(tok[0], tok_e[0])
        pos.add_(1)
        pos_e += 1
    torch.cuda.synchronize()
    for entry, ref, old in zip(cache, eager, frozen):
        for leaf, t in entry.items():
            torch.testing.assert_close(t, ref[leaf], rtol=1e-5, atol=1e-5)
            if t.dim():
                assert torch.equal(t[1], old[leaf]), leaf

    reset_cache(cache)
    assert all((e["m"] == M_INIT).all() for e in cache if "m" in e)
    mask.fill_(True)
    logits, _ = model.prefill({"tokens": tokens}, cache)
    fresh = model.init_cache(2, 40)
    want, _ = model.prefill({"tokens": tokens}, fresh)
    tok.copy_(logits.argmax(-1, keepdim=True))
    pos.fill_(20)
    graph.replay()
    want, _ = model.decode_step(want.argmax(-1, keepdim=True), 20, fresh)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)


def _qwen_moe_layer(cuda, dtype, seed=0):
    """A MoE layer at qwen3-moe-30b-a3b's widths (d 2048, 128 experts of
    768, top-8) with weights drawn at the reference's scales."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_lib

    cfg = get_config("qwen3-moe-30b-a3b").replace(dtype=dtype, param_dtype=dtype)
    layer = moe_lib.MoE(cfg, getattr(torch, dtype), cuda)
    layer.init_(torch.Generator(device=cuda).manual_seed(seed))
    return cfg, layer


@pytest.mark.parametrize("T", [8, 2048])
def test_moe_layer_in_a_cuda_graph_matches_eager(cuda, T):
    """The routing, the stable sort, the capacity dispatch, the expert
    products and the combine captured once in a CUDA graph (which fails
    on any host sync) and replayed on new inputs: the eager results (fp32,
    so the products are exact to the order of their sums)."""
    from repro_torch.models import moe as moe_lib

    cfg, layer = _qwen_moe_layer(cuda, "float32")
    rng = _rng("moe-graph", T)
    xs = [_on(cuda, "float32", rng.standard_normal((1, T, cfg.d_model), np.float32))[0]
          for _ in range(3)]
    static = xs[0].clone()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        for _ in range(2):
            moe_lib.apply_moe(layer, static, cfg)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe_lib.apply_moe(layer, static, cfg)
    for x in xs[1:] + xs[:1]:
        static.copy_(x)
        graph.replay()
        torch.testing.assert_close(out, moe_lib.apply_moe(layer, x, cfg), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T", [8, 2048])
def test_moe_layer_bf16_matches_fp32(cuda, T):
    """The bf16 layer against the same weights and inputs in fp32, within
    the bf16 tolerance relative to the output's scale, on the tokens whose
    top-k experts and kept pairs agree (the router runs in fp32 on the
    same bf16 inputs, so all of them should)."""
    from repro_torch.models import moe as moe_lib

    cfg, layer = _qwen_moe_layer(cuda, "bfloat16")
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    layer32 = moe_lib.MoE(cfg32, torch.float32, cuda)
    with torch.no_grad():
        for p32, p in zip(layer32.parameters(), layer.parameters()):
            p32.copy_(p)
    rng = _rng("moe-bf16", T)
    x = _on(cuda, "bfloat16", rng.standard_normal((1, T, cfg.d_model), np.float32))[0]
    got = moe_lib.apply_moe(layer, x, cfg)[0].float()
    want = moe_lib.apply_moe(layer32, x.float(), cfg32)[0]
    C = moe_lib.capacity(T, cfg.num_experts, cfg.num_experts_per_tok, cfg.moe_capacity_factor)

    def kept(lyr, xf):
        _, idx = moe_lib.route(moe_lib.router_logits(lyr, xf), cfg.num_experts_per_tok)
        pos = moe_lib.positions_in_expert(idx.reshape(-1), cfg.num_experts)
        return idx, (pos < C).reshape(idx.shape)

    (i16, k16), (i32, k32) = kept(layer, x[0]), kept(layer32, x[0].float())
    rows = (i16 == i32).all(-1) & (k16 == k32).all(-1)
    assert int(rows.sum()) == T
    err = (got - want)[rows].abs().max().item() / want[rows].abs().max().item()
    assert torch.isfinite(got).all() and err <= 2e-2, err


def test_hybrid_engine_cuda_graph_matches_eager(cuda):
    """A small recurrentgemma engine (bf16) in both layouts: greedy streams
    through the captured decode step equal those of the eager step, and
    the replays credit K5 with one launch per RG-LRU layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampling import SamplingParams

    cfg = get_config("recurrentgemma-2b", smoke=True).replace(dtype="bfloat16",
                                                              param_dtype="bfloat16")
    model = model_lib.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    rng = _rng("hybrid-engine")
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 30, 17, 9, 40)]
    n_rec = sum(k == "rglru" for k in cfg.blocks())
    for layout in ("contiguous", "paged"):
        outs = {}
        for graph in (True, False):
            eng = ServingEngine(model, max_batch=2, max_len=96, prompt_bucket=8,
                                cache_layout=layout, device=cuda, cuda_graph=graph)
            n0 = lr_ops.linear_recurrence.launches
            for i, p in enumerate(prompts):
                eng.submit(p, SamplingParams(max_new_tokens=6 + 3 * i))
            outs[graph] = {r.uid: r.output_tokens for r in eng.run()}
            assert lr_ops.linear_recurrence.launches - n0 == \
                n_rec * (eng.prefills + eng.decode_forwards)
            assert eng.latency_summary()["dispatches_per_step_p50"] == 1
        assert outs[True] == outs[False], layout
        assert [len(outs[True][i]) for i in range(5)] == [6 + 3 * i for i in range(5)]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b", "nemotron-h-8b",
                                  "xlstm-1.3b", "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b",
                                  "llava-next-34b", "seamless-m4t-large-v2"])
def test_latency_profiler_graph_matches_eager(cuda, arch):
    """The measured decode loop replayed from its CUDA graph and run
    eagerly (bf16 smoke models): identical greedy tokens, the replays
    credited to every kernel's launch count as the eager calls count, and
    TPOT's samples taken through the same captured runner.  A vision
    prompt's patches count in its 40 positions; an encoder-decoder
    prompt's 20 frames feed its encoder (K2) and every decoder layer's
    cross attention (K2, then K3 each step)."""
    from repro_torch.configs import get_config
    from repro_torch.core.latency import LatencyProfiler
    from repro_torch.models import model as model_lib

    cfg = get_config(arch, smoke=True).replace(dtype="bfloat16", param_dtype="bfloat16")
    model = model_lib.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    with torch.no_grad():
        model.embed.table.mul_(0.05)  # streams that depend on the context
    S, gen, nv = 40, 12, cfg.num_vision_tokens
    rng = _rng("profiler", arch)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, S - nv))).to(cuda)
    embeds = {name: torch.from_numpy(0.1 * rng.standard_normal((2, n, cfg.d_model))).to(
        cuda, torch.bfloat16) for name, n in (("vision_embeds", nv),
                                              ("enc_embeds", S // 2 if cfg.is_encdec else 0)) if n}
    n_attn = sum(k in ("attn", "local_attn") for k in cfg.blocks())
    n_cross = n_attn if cfg.is_encdec else 0
    n_rec = sum(k == "rglru" for k in cfg.blocks())
    out, counts = {}, {}
    for graph in (True, False):
        lp = LatencyProfiler(cfg, model, device=cuda, cuda_graph=graph)
        run = lp.runner(2, S + gen + 1)
        assert (run.graph is not None) == graph
        before = {k: fn.launches for k, fn in dispatch.KERNELS.items()}
        out[graph] = lp.greedy(tokens, gen, **embeds)
        torch.cuda.synchronize()
        counts[graph] = {k: fn.launches - before[k] for k, fn in dispatch.KERNELS.items()}
        assert run.replays == (gen if graph else 0)
        st = lp.tpot(2, S, gen_len=gen, warmup=1)
        assert len(st.samples_s) == gen and len(lp.runners) == 1
        assert run.replays == (2 * gen + 1 if graph else 0)
    assert torch.equal(out[True], out[False])
    assert counts[True] == counts[False]
    assert counts[True]["decode_attention"] == (n_attn + n_cross) * gen
    assert counts[True]["flash_attention"] == n_attn + n_cross + cfg.num_encoder_layers
    assert counts[True]["linear_recurrence"] == n_rec * (gen + 1)


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, as a module."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke


def _unified_attention_case(cuda, layout, lengths, starts, W=256):
    """K2's inputs in the unified step (W = 256) or the verify step (W = 5),
    from ``chip_smoke.unified_flash_case`` (paged: llama3.1-8b over the
    gathered pool; ring: recurrentgemma-2b over its ring plus the chunk),
    q/k/v drawn from a seeded numpy rng."""
    rng = _rng("unified-k2", layout, W)

    def randn(*shape):
        return _on(cuda, "bfloat16", rng.standard_normal(shape, np.float32))[0]

    return _chip_smoke().unified_flash_case(cuda, randn, layout, starts, lengths, W=W)


@pytest.mark.parametrize("layout", ["paged", "ring"])
def test_flash_at_the_unified_step_shapes_in_a_cuda_graph(cuda, layout):
    """K2 at the unified step's shapes (llama3.1-8b paged: q (8,256,32,128)
    over 1024 gathered keys; recurrentgemma-2b: q (8,256,10,256) over a
    1024-slot ring + the chunk, T = 1280, keys unsorted), most rows of
    length 0, captured in a CUDA graph and replayed as the starts move:
    equal to the eager call, within bf16 tolerance of the plain version
    (rows with no valid key are 0 in both)."""
    lengths = [256, 0, 0, 77, 0, 0, 0, 0]
    q, k, v, kw = _unified_attention_case(cuda, layout, lengths, [0] * 8)
    fa_ops.flash_attention(q, k, v, **kw)  # build and load outside the capture
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa_ops.flash_attention(q, k, v, **kw)
    for starts in ([0, 0, 0, 512, 0, 0, 0, 0], [768, 3, 0, 100, 900, 0, 17, 0],
                   [256, 0, 1023, 767, 0, 5, 0, 1]):
        _, _, _, new = _unified_attention_case(cuda, layout, lengths, starts)
        kw["q_positions"].copy_(new["q_positions"])
        kw["k_positions"].copy_(new["k_positions"])
        graph.replay()
        torch.testing.assert_close(out, fa_ops.flash_attention(q, k, v, **kw), rtol=0, atol=0)
        _assert(out, fa_ref.attention(q, k, v, **kw), "bfloat16")


@pytest.mark.parametrize("arch,layout,prefix_cache", [("llama3.2-1b", "paged", True),
                                                      ("recurrentgemma-2b", "contiguous", False),
                                                      ("nemotron-h-8b", "paged", False),
                                                      ("qwen3-moe-30b-a3b", "paged", False),
                                                      ("moonshot-v1-16b-a3b", "contiguous",
                                                       False)])
def test_unified_engine_cuda_graph_matches_eager(cuda, arch, layout, prefix_cache):
    """A small bf16 engine with chunked prefill (chunk 8, budget 16) and the
    unified step, replayed from its CUDA graphs and run eagerly: identical
    streams, at most two dispatches a step, the unified replays credited
    (K2 once per attention layer per chunk pass), blocks drained."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.sampling import SamplingParams

    cfg = get_config(arch, smoke=True).replace(dtype="bfloat16", param_dtype="bfloat16")
    model = model_lib.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    with torch.no_grad():
        model.embed.table.mul_(0.05)  # streams that depend on the context
    rng = _rng("unified-engine", arch)
    shared = rng.integers(0, cfg.vocab_size, 24)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)])
               for n in (5, 30, 17, 9, 40)]
    n_attn = sum(k in ("attn", "local_attn") for k in cfg.blocks())
    outs = {}
    for graph in (True, False):
        eng = ServingEngine(model, max_batch=2, max_len=96, prompt_bucket=8,
                            cache_layout=layout, prefill_chunk=8, prefill_budget=16,
                            prefix_cache=prefix_cache, device=cuda, cuda_graph=graph)
        assert (eng._unified_graph is not None) == graph
        n0 = fa_ops.flash_attention.launches
        for i, p in enumerate(prompts):
            eng.submit(p, SamplingParams(max_new_tokens=6 + 3 * i))
        outs[graph] = {r.uid: r.output_tokens for r in eng.run()}
        torch.cuda.synchronize()
        assert fa_ops.flash_attention.launches - n0 == n_attn * eng.chunk_forwards
        assert max(eng._dispatch_samples) <= 2
        assert eng.blocks_in_use == 0
        if prefix_cache:
            assert eng.prefix_hits > 0
    assert outs[True] == outs[False]
    assert [len(outs[True][i]) for i in range(5)] == [6 + 3 * i for i in range(5)]


def test_flash_at_the_verify_window_shape_in_a_cuda_graph(cuda):
    """K2 at the speculative verify step's shape on llama3.1-8b (q
    (8, 5, 32, 128) over 1024 gathered keys, rows at their own positions,
    three idle), captured in a CUDA graph and replayed as the positions
    move: equal to the eager call and within bf16 tolerance of the plain
    version."""
    cs = _chip_smoke()
    VERIFY_LENGTHS, VERIFY_STARTS, VERIFY_W = cs.VERIFY_LENGTHS, cs.VERIFY_STARTS, cs.VERIFY_W
    q, k, v, kw = _unified_attention_case(cuda, "paged", VERIFY_LENGTHS, VERIFY_STARTS,
                                          W=VERIFY_W)
    _assert(fa_ops.flash_attention(q, k, v, **kw), fa_ref.attention(q, k, v, **kw), "bfloat16")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fa_ops.flash_attention(q, k, v, **kw)
    for starts in ([0, 1, 2, 63, 64, 511, 512, 1019], [1019, 800, 17, 0, 300, 0, 955, 64]):
        _, _, _, new = _unified_attention_case(cuda, "paged", VERIFY_LENGTHS, starts,
                                               W=VERIFY_W)
        kw["q_positions"].copy_(new["q_positions"])
        graph.replay()
        torch.testing.assert_close(out, fa_ops.flash_attention(q, k, v, **kw), rtol=0, atol=0)
        _assert(out, fa_ref.attention(q, k, v, **kw), "bfloat16")


def test_speculative_preempting_engine_cuda_graph_matches_eager(cuda):
    """A small bf16 engine with prompt-lookup speculation and preemption on
    a cut pool (chunk 8, budget 16, the unified step), replayed from its
    CUDA graphs and run eagerly: identical streams, drafts accepted,
    requests preempted, K2 launched once per attention layer per chunk
    pass (a verify step is one), no decode-step kernel, blocks drained."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_lib
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.workload import lookup_friendly_trace

    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype="bfloat16", param_dtype="bfloat16")
    model = model_lib.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    with torch.no_grad():
        model.embed.table.mul_(0.05)  # streams that depend on the context
    arrivals = lookup_friendly_trace(cfg.vocab_size, num_requests=6, motif_len=6, repeats=4,
                                     max_new=40, seed=1)
    n_attn = sum(k == "attn" for k in cfg.blocks())
    outs = {}
    for graph in (True, False):
        eng = ServingEngine(model, max_batch=3, max_len=96, prompt_bucket=8,
                            cache_layout="paged", kv_block_size=8, kv_num_blocks=19,
                            prefill_chunk=8, prefill_budget=16, preemption="recompute",
                            speculative="lookup", spec_tokens=4, device=cuda, cuda_graph=graph)
        n0 = {name: k.launches for name, k in dispatch.KERNELS.items()}
        for a in arrivals:
            eng.submit(a.prompt, a.params)
        outs[graph] = {r.uid: r.output_tokens for r in eng.run()}
        torch.cuda.synchronize()
        launched = {name: k.launches - n0[name] for name, k in dispatch.KERNELS.items()}
        assert launched["flash_attention"] == n_attn * eng.chunk_forwards
        assert launched["paged_decode_attention"] == 0 and eng.decode_forwards == 0
        assert eng.preemptions > 0 and eng._accepted_tokens > 0
        assert eng.latency_summary()["dispatches_per_step_p50"] == 1
        assert eng.blocks_in_use == 0 and not eng._state["block_tables"].any()
    assert outs[True] == outs[False]
    assert all(len(outs[True][i]) == 40 for i in range(6))


# -- tensor parallelism: the kernels at a shard's local heads, and ranks on one card

# (Hq, Hkv) of one rank: llama3.1-8b at tp = 2, command-r-plus-104b at tp = 4 (G = 12),
# qwen3-moe-30b-a3b at tp = 4 (G = 8), moonshot-v1-16b-a3b at tp = 2 (G = 1),
# llava-next-34b at tp = 2 (G = 7)
TP_LOCAL_HEADS = [(16, 4), (24, 2), (8, 1), (8, 8), (28, 4)]


@pytest.mark.parametrize("Hq,Hkv", TP_LOCAL_HEADS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_at_tensor_parallel_local_heads(cuda, Hq, Hkv, dtype):
    """K2 over a 512-token prefill, K3 over the measure path's (1, 545)
    cache and K4 over the serving pool (513 blocks of 16), each at one
    rank's heads, against their plain versions."""
    q, k, v, qp, kp = _flash_inputs(1, 512, 512, Hq, Hkv, 128)
    q, k, v = _on(cuda, dtype, q, k, v)
    qp, kp = _ints(cuda, qp, kp)
    kw = dict(q_positions=qp, k_positions=kp, causal=True, window=0, softcap=0.0)
    _assert(fa_ops.flash_attention(q, k, v, **kw), fa_ref.attention(q, k, v, **kw), dtype)
    q, kc, vc = _on(cuda, dtype, *_decode_inputs(1, 545, Hq, Hkv, 128))
    qp = np.asarray([[519]])
    kp = np.broadcast_to(np.arange(545), (1, 545))
    qp, kp = _ints(cuda, qp, np.where(kp <= qp, kp, -1))
    kw = dict(q_positions=qp, k_positions=kp, window=0, softcap=0.0)
    _assert(da_ops.decode_attention(q, kc, vc, **kw), da_ref.decode_attention(q, kc, vc, **kw),
            dtype)
    rng = _rng("tp paged", Hq, Hkv)
    q_pos = [447, 768, 758, 604, 388, 823, 517, 953]
    perm = rng.permutation(np.arange(1, 513))
    tables, ptr = np.zeros((8, 64), np.int32), 0
    for b, p in enumerate(q_pos):
        tables[b, :p // 16 + 1] = perm[ptr:ptr + p // 16 + 1]
        ptr += p // 16 + 1
    q, kp, vp = _on(cuda, dtype, rng.standard_normal((8, 1, Hq, 128), np.float32),
                    rng.standard_normal((513, 16, Hkv, 128), np.float32),
                    rng.standard_normal((513, 16, Hkv, 128), np.float32))
    tables, qp = _ints(cuda, tables, np.asarray(q_pos)[:, None])
    kw = dict(block_tables=tables, q_positions=qp, window=0, softcap=0.0)
    _assert(da_ops.paged_decode_attention(q, kp, vp, **kw),
            da_ref.paged_decode_attention(q, kp, vp, **kw), dtype)


def test_tp_ranks_sharing_the_card_match_tp1(cuda):
    """Two gloo ranks on one card (host-staged collectives, eager steps):
    bf16 logits of a prefill and decode steps within the bf16 kernel
    tolerance times the largest logit of tp = 1's on the same card, and
    greedy streams through the paged engine equal on both ranks.  NCCL,
    one GPU per rank, refuses two ranks on fewer cards."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_tp_mesh, spawn_tp
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.sharding import runs

    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="exceeds"):
            make_tp_mesh(2, "cuda", backend="nccl")
    cfg = get_config("llama3.2-1b", smoke=True).replace(dtype="bfloat16",
                                                          param_dtype="bfloat16")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 40))
    steps = rng.integers(0, cfg.vocab_size, (3, 2))
    arrivals = [(rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                 SamplingParams(max_new_tokens=6)) for n in (9, 30, 17)]
    plan = [(runs.Weights(cfg), [
        runs.Logits(tokens, steps, 48),
        runs.Serve("paged", dict(max_batch=2, max_len=64, prompt_bucket=8,
                                 cache_layout="paged", prefill_chunk=8, cuda_graph=False),
                   arrivals)])]
    base = runs.run_plan(None, plan, cuda)[0]
    ranks = spawn_tp(runs.run_plan, 2, "cuda", plan, backend="gloo")
    want = base[0]
    for rank in range(2):
        got = ranks[rank][0]
        assert np.abs(got[0] - want).max() <= 2e-2 * np.abs(want).max()
        assert got[1]["streams"] == ranks[0][0][1]["streams"]
    assert ranks[0][0][1]["summary"]["tp_devices"] == 2


def test_tp_moe_ranks_sharing_the_card_match_tp1(cuda):
    """moonshot-v1-16b-a3b's smoke config (8 experts, 4 on a rank, and a
    shared MLP) on two gloo ranks sharing the card, fp32: with tp = 1's
    routes imposed, the logits of a prefill and decode steps within 1e-4
    of the largest of tp = 1's on the same card; unforced, every rank
    routes every MoE call as rank 0 does, and the paged engine's streams
    are equal on both ranks."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_tp
    from repro_torch.serving.sampling import SamplingParams
    from repro_torch.sharding import runs

    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 40))
    steps = rng.integers(0, cfg.vocab_size, (3, 2))
    arrivals = [(rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32),
                 SamplingParams(max_new_tokens=6)) for n in (9, 30, 17)]
    serve = runs.Serve("paged", dict(max_batch=2, max_len=64, prompt_bucket=8,
                                     cache_layout="paged", prefill_chunk=8, cuda_graph=False),
                       arrivals, record=True)
    logits = runs.Logits(tokens, steps, 48, record=True)
    base = runs.run_plan(None, [(runs.Weights(cfg), [logits])], cuda)[0][0]
    forced = runs.Logits(tokens, steps, 48, routes=base["ids"])
    plan = [(runs.Weights(cfg), [forced, logits, serve])]
    ranks = spawn_tp(runs.run_plan, 2, "cuda", plan, backend="gloo")
    want = base["logits"]
    lead = ranks[0][0]
    for rank in range(2):
        got = ranks[rank][0]
        assert np.abs(got[0] - want).max() <= 1e-4 * np.abs(want).max(), rank
        assert np.array_equal(got[0], lead[0])
        for a, b in ((got[1], lead[1]), (got[2]["routes"], lead[2]["routes"])):
            assert len(a["ids"]) == len(b["ids"]) > 0
            assert all(np.array_equal(x, y) for x, y in zip(a["ids"], b["ids"])), rank
        assert got[2]["streams"] == lead[2]["streams"]
    assert lead[2]["summary"]["tp_devices"] == 2


def test_nccl_collectives_replay_from_a_cuda_graph(cuda):
    """NCCL ranks, one GPU each (as many as there are, at most 2): the
    mesh's sum and gather are exact eagerly and when replayed from a CUDA
    graph captured after the group was warmed, the steps' arrangement."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import spawn_tp
    from repro_torch.sharding import runs

    tp = min(torch.cuda.device_count(), 2)
    plan = [(runs.Weights(get_config("llama3.2-1b", smoke=True)), [runs.Collectives()])]
    for rank, out in enumerate(spawn_tp(runs.run_plan, tp, "cuda", plan)):
        assert out[0][0] == {"eager": [0.0, 0.0], "replayed": [0.0, 0.0]}, rank


def test_differentiable_collectives_on_a_one_rank_nccl_group(cuda):
    """``sharding.collectives`` on a (1, 1) mesh over NCCL: ``copy``,
    ``reduce``, ``gather`` and ``fsdp_gather`` (its reduce-scatter) run
    their NCCL collectives under autograd, and the loss and every gradient
    equal autograd's on the whole tensors."""
    from repro_torch.launch.mesh import spawn_mesh
    from repro_torch.sharding import runs

    (out,), = spawn_mesh(runs.train_plan, (1, 1), "cuda", [runs.CollectiveGrads()],
                         backend="nccl")
    assert set(out) == {f"{tag}_{k}" for tag in ("summed", "whole_rows")
                        for k in ("loss", "x", "w1", "w2", "w3")}
    for key, err in out.items():
        assert err <= 1e-5, (key, err)


# -- training: the kernels' autograd Functions ------------------------------------

def _grad_case(name, dtype, dev):
    """(inputs requiring grad, the wrapper call, the plain call, the
    wrapper whose ``launches`` counts the kernel)."""
    rng = _rng("grad", name, dtype)
    if name in ("rmsnorm", "add_rmsnorm"):
        x, r = _on(dev, dtype, rng.standard_normal((33, 4096)), rng.standard_normal((33, 4096)))
        (s,) = _on(dev, dtype, 0.1 * rng.standard_normal(4096))
        if name == "rmsnorm":
            return [x, s], lambda x, s: rn_ops.rmsnorm(x, s), rn_ref.rmsnorm, rn_ops.rmsnorm
        return ([x, r, s], lambda x, r, s: rn_ops.add_rmsnorm(x, r, s), rn_ref.add_rmsnorm,
                rn_ops.rmsnorm)
    if name == "rmsnorm_sumsq":
        (x,) = _on(dev, dtype, rng.standard_normal((33, 2048)))
        return [x], rn_ops.rmsnorm_sumsq, rn_ref.sumsq, rn_ops.rmsnorm
    if name == "rmsnorm_stat":  # one rank's half of a 4096 width, the reduced statistic
        x, s = _on(dev, dtype, rng.standard_normal((33, 2048)), 0.1 * rng.standard_normal(2048))
        (stat,) = _on(dev, "float32", 4096 * rng.uniform(0.5, 2.0, 33))
        return ([x, s, stat], lambda x, s, st: rn_ops.rmsnorm(x, s, stat=st, width=4096),
                lambda x, s, st: rn_ref.rmsnorm(x, s, 1e-6, st, 4096), rn_ops.rmsnorm)
    if name == "flash_attention":
        q, k, v, qp, kp = _flash_inputs(2, 160, 160, 8, 2, 64)
        q, k, v = _on(dev, dtype, q, k, v)
        qp, kp = _ints(dev, qp, kp)
        kw = dict(q_positions=qp, k_positions=kp, causal=True, window=48, softcap=30.0)
        return ([q, k, v], lambda q, k, v: fa_ops.flash_attention(q, k, v, **kw),
                lambda q, k, v: fa_ref.plain_attention(q, k, v, **kw), fa_ops.flash_attention)
    a = rng.uniform(0.8, 1.0, (2, 300, 256))
    a, b, h0 = _on(dev, "float32", a, 0.1 * rng.standard_normal(a.shape),
                   rng.standard_normal((2, 256)))
    return [a, b, h0], lr_ops.linear_recurrence, lr_ref.linear_recurrence, \
        lr_ops.linear_recurrence


GRAD_CASES = [("rmsnorm", "float32"), ("rmsnorm", "bfloat16"), ("add_rmsnorm", "bfloat16"),
              ("rmsnorm_sumsq", "bfloat16"), ("rmsnorm_stat", "bfloat16"),
              ("flash_attention", "float32"), ("flash_attention", "bfloat16"),
              ("linear_recurrence", "float32")]


@pytest.mark.parametrize("name,dtype", GRAD_CASES)
def test_kernel_function_launches_and_takes_the_plain_gradients(cuda, name, dtype):
    """With grad on, each wrapper launches its kernel inside its autograd
    Function (one launch), its output within the kernel tolerance of the
    plain version's, and every input's gradient equal to autograd through
    the plain version (the backward is that VJP)."""
    inputs, call, plain, counter = _grad_case(name, dtype, cuda)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    before = counter.launches
    outs = call(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    assert counter.launches == before + 1
    assert all("Backward" in type(o.grad_fn).__name__ for o in outs)
    g = torch.Generator(device=cuda).manual_seed(0)
    cots = [torch.randn(o.shape, generator=g, device=cuda, dtype=torch.float32).to(o.dtype)
            for o in outs]
    got = torch.autograd.grad(outs, leaves, cots)
    ref_leaves = [t.clone().requires_grad_(True) for t in inputs]
    ref_outs = plain(*ref_leaves)
    ref_outs = ref_outs if isinstance(ref_outs, tuple) else (ref_outs,)
    want = torch.autograd.grad(ref_outs, ref_leaves, cots)
    assert counter.launches == before + 1  # the backward launches nothing
    for o, ro in zip(outs, ref_outs):
        _assert(o, ro, dtype)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        _assert(a, b, dtype)


@pytest.mark.parametrize("name,dtype", GRAD_CASES)
def test_no_function_on_the_path_without_grad(cuda, name, dtype):
    """Under ``no_grad``, or with no input requiring grad, the wrapper makes
    its direct call: one launch, no graph."""
    inputs, call, _, counter = _grad_case(name, dtype, cuda)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    for run in (lambda: torch.no_grad()(call)(*leaves), lambda: call(*inputs)):
        before = counter.launches
        outs = run()
        assert counter.launches == before + 1
        assert all(o.grad_fn is None for o in (outs if isinstance(outs, tuple) else (outs,)))


def test_head_product_backward_runs_on_cuda(cuda):
    """``unembed``'s bf16 product on the card has gradients (``mm`` with
    ``out_dtype`` has none): dX and dW are the fp32 products of the fp32
    cotangent, rounded once to bf16 (rtol 4e-3 > 2^-8, half a bf16 ulp;
    atol 1e-3 for fp32 summation order)."""
    from repro_torch.models import layers

    rng = _rng("head")
    x, table = _on(cuda, "bfloat16", rng.standard_normal((2, 64, 256)),
                   rng.standard_normal((1000, 256)))
    emb = layers.Embedding(1000, 256, torch.bfloat16, cuda)
    with torch.no_grad():
        emb.table.copy_(table)
    emb.table.requires_grad_(True)
    x.requires_grad_(True)
    cot = torch.from_numpy(rng.standard_normal((2, 64, 1000)).astype(np.float32)).to(cuda)
    out = layers.unembed(emb, x)
    dx, dw = torch.autograd.grad(out, (x, emb.table), cot)
    xf, wf = x.detach().float(), table.float()
    assert out.dtype == torch.float32 and dx.dtype == dw.dtype == torch.bfloat16
    torch.testing.assert_close(out, xf @ wf.t(), rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(dx.float(), cot @ wf, rtol=4e-3, atol=1e-3)
    torch.testing.assert_close(dw.float(), cot.reshape(-1, 1000).t() @ xf.reshape(-1, 256),
                               rtol=4e-3, atol=1e-3)


def _train_launches(cfg, remat):
    """K1, K2 and K5 launches of one training forward: K1 per norm (an
    attention block's two, one more for an enc-dec block's ``norm_c``,
    one for a parallel block or ``ffn``; an RG-LRU block's two; an xLSTM
    block's norm and its cell's), K2 per self- and cross attention, K5 per
    RG-LRU layer, the final norms; an encoder's layers two K1 and one K2
    each.  With remat the decoder's grouped layers and every encoder layer
    again."""
    attn = ("attn", "local_attn")
    cross = 1 if cfg.is_encdec else 0

    def count(kinds, enc_layers):
        return {"rmsnorm": sum((1 if cfg.parallel_block else 2) + cross if k in attn
                               else 1 if k == "ffn" else 2 for k in kinds) + 2 * enc_layers,
                "flash_attention": sum(1 + cross for k in kinds if k in attn) + enc_layers,
                "linear_recurrence": sum(k == "rglru" for k in kinds)}

    kinds, enc = cfg.blocks(), cfg.num_encoder_layers
    plen, (n_groups, _) = len(cfg.block_pattern), cfg.layer_groups()
    want = count(kinds, enc)
    want["rmsnorm"] += 1 + (1 if enc else 0)
    if remat:
        again = count(kinds[:n_groups * plen], enc)
        want = {k: want[k] + again[k] for k in want}
    return want


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-2b", "moonshot-v1-16b-a3b",
                                  "xlstm-1.3b", "seamless-m4t-large-v2", "llava-next-34b"])
def test_forward_train_through_the_kernels(cuda, arch):
    """A smoke model's training forward on the card: K1 (every norm, the
    xLSTM cells' and the encoder's too), K2 (every self- and cross
    attention layer, the encoder's unmasked) and K5 (every RG-LRU layer)
    launch once per forward, again per group under remat (the encoder's
    layers included); its logits, loss and gradients agree with the plain
    versions' (``use_backend("torch")``) in fp32."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import batch_for_model
    from repro_torch.models import model as model_lib
    from repro_torch.training import step as step_lib

    cfg = get_config(arch, smoke=True)
    model = model_lib.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    for p in model.parameters():
        p.requires_grad_(True)
    rng = _rng("train", arch)
    tok = rng.integers(0, cfg.vocab_size, (2, 41)).astype(np.int32)
    host = batch_for_model(cfg, {"tokens": tok[:, :-1], "labels": tok[:, 1:]}, rng)
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in host.items()}
    want = {False: _train_launches(cfg, False), True: _train_launches(cfg, True)}
    params = dict(model.named_parameters())
    grads, logits = {}, {}
    for backend, remat in (("auto", False), ("auto", True), ("torch", False)):
        before = {k: dispatch.KERNELS[k].launches for k in want[False]}
        with dispatch.use_backend(backend):
            loss, _ = step_lib.make_loss_fn(cfg, remat=remat)(model, batch)
            grads[backend, remat] = torch.autograd.grad(loss, list(params.values()))
            with torch.no_grad():
                logits[backend, remat] = model.forward_train(batch, remat=False)
        launched = {k: dispatch.KERNELS[k].launches - before[k] for k in want[False]}
        if backend == "auto":  # the loss's forward (and recompute), then the logits'
            assert launched == {k: want[remat][k] + want[False][k] for k in want[False]}
        else:
            assert launched == {k: 0 for k in want[False]}
    ref = logits["torch", False]
    assert ref.shape[1] == cfg.num_vision_tokens + 40
    torch.testing.assert_close(logits["auto", False], ref, rtol=0,
                               atol=1e-4 * ref.abs().max().item())
    # an sLSTM cell's input-gate bias from a fresh state has a gradient of
    # zero in exact arithmetic (its shift moves the stabilizer, which
    # starts at -1e30, by as much): rounding noise on both paths, held to
    # 1e-6 of the largest gradient of all
    zero = {f"layers.{i}.cell.b_i" for i, k in enumerate(cfg.blocks()) if k == "slstm"}
    top = max(c.abs().max().item() for c in grads["torch", False])
    for name, a, b, c in zip(params, *grads.values()):
        scale = c.abs().max().item() + 1e-30
        assert (a - b).abs().max().item() <= 1e-6 * scale, name  # remat: the same math
        if name in zero:
            assert max(a.abs().max().item(), c.abs().max().item()) <= 1e-6 * top, name
        else:
            assert (a - c).abs().max().item() <= 1e-4 * scale, name


# ---------------------------------------------------------------------------
# the dry-run's timing helper and its bound, on the card
# ---------------------------------------------------------------------------

def test_time_callable_synchronizes_the_result_device(cuda, monkeypatch):
    """``time_callable`` waits for each call's CUDA result: one
    ``torch.cuda.synchronize`` on its device per call, and every sample at
    least the device time of the work (CUDA events around the same
    call)."""
    from repro_torch.core.latency import time_callable

    synced = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev) or real(dev))
    a = torch.randn(4096, 4096, device=cuda)
    stats = time_callable(lambda: (a @ a, {"x": [a.sum()]}), iters=5, warmup=2)
    assert len(synced) == 7 and {torch.device(d).type for d in synced} == {"cuda"}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    a @ a
    end.record()
    real()
    assert min(stats.samples_s) * 1e3 >= 0.9 * start.elapsed_time(end)


def test_prefill_time_is_at_least_the_dry_run_bound(cuda):
    """tinyllama-1.1b at full width, prefill of 1 x 2048 through the
    kernels: every sample of ``time_callable`` takes at least the dry-run's
    bound on one device, mesh (1, 1) (a time under it means the count or
    the bytes are wrong); the dry-run itself launched nothing."""
    from repro_torch.configs import get_config
    from repro_torch.core.latency import time_callable
    from repro_torch.launch import dryrun
    from repro_torch.models import model as model_lib
    from repro_torch.models.config import ShapeConfig

    cfg = get_config("tinyllama-1.1b")
    before = {k: fn.launches for k, fn in dispatch.KERNELS.items()}
    res = dryrun.run_cell(cfg.name, ShapeConfig("p", 2048, 1, "prefill"), mesh=(1, 1))
    assert {k: fn.launches for k, fn in dispatch.KERNELS.items()} == before
    gen = torch.Generator(device=cuda).manual_seed(0)
    model = model_lib.init(cfg, gen, cuda)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen, device=cuda)}
    cache = model.init_cache(1, 2048)
    stats = time_callable(lambda: model.prefill(batch, cache)[0], iters=5, warmup=2)
    assert min(stats.samples_s) >= res["roofline"]["bound_s"] > 0
