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
FLASH_SHAPES = [(128, 4, 4, 64), (128, 8, 2, 64), (256, 4, 1, 128), (96, 4, 2, 80),
                (100, 8, 2, 8), (512, 32, 8, 128), (70, 2, 1, 256)]
FLASH_MASKS = [(True, 0), (True, 32), (False, 0)]
DECODE_SHAPES = [(256, 8, 2, 64), (512, 4, 4, 128), (128, 16, 1, 64), (96, 4, 2, 80),
                 (545, 32, 8, 128), (300, 12, 1, 256)]
# (G, D, bs) of the paged sweep; Hkv = 2
PAGED_SHAPES = [(g, d, bs) for g in (1, 4, 12) for d in (64, 128) for bs in (16, 32)]
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
            out.data_ptr(), *scratch, 2, 8, 16, 2, 4, 64, chunk, n_split, 0, 0.0, 0.125, s)

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


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b"])
def test_latency_profiler_graph_matches_eager(cuda, arch):
    """The measured decode loop replayed from its CUDA graph and run
    eagerly (bf16 smoke models): identical greedy tokens, the replays
    credited to every kernel's launch count as the eager calls count, and
    TPOT's samples taken through the same captured runner."""
    from repro_torch.configs import get_config
    from repro_torch.core.latency import LatencyProfiler
    from repro_torch.models import model as model_lib

    cfg = get_config(arch, smoke=True).replace(dtype="bfloat16", param_dtype="bfloat16")
    model = model_lib.init(cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    with torch.no_grad():
        model.embed.table.mul_(0.05)  # streams that depend on the context
    S, gen = 40, 12
    tokens = torch.from_numpy(_rng("profiler", arch).integers(0, cfg.vocab_size, (2, S)))
    tokens = tokens.to(cuda)
    n_attn = sum(k in ("attn", "local_attn") for k in cfg.blocks())
    n_rec = sum(k == "rglru" for k in cfg.blocks())
    out, counts = {}, {}
    for graph in (True, False):
        lp = LatencyProfiler(cfg, model, device=cuda, cuda_graph=graph)
        run = lp.runner(2, S + gen + 1)
        assert (run.graph is not None) == graph
        before = {k: fn.launches for k, fn in dispatch.KERNELS.items()}
        out[graph] = lp.greedy(tokens, gen)
        torch.cuda.synchronize()
        counts[graph] = {k: fn.launches - before[k] for k, fn in dispatch.KERNELS.items()}
        assert run.replays == (gen if graph else 0)
        st = lp.tpot(2, S, gen_len=gen, warmup=1)
        assert len(st.samples_s) == gen and len(lp.runners) == 1
        assert run.replays == (2 * gen + 1 if graph else 0)
    assert torch.equal(out[True], out[False])
    assert counts[True] == counts[False]
    assert counts[True]["decode_attention"] == n_attn * gen
    assert counts[True]["flash_attention"] == n_attn
    assert counts[True]["linear_recurrence"] == n_rec * (gen + 1)
