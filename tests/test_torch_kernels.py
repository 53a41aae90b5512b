"""The port's kernels against the reference.

On the CPU: each plain PyTorch version in ``repro_torch.kernels`` against
the JAX Pallas kernel in interpret mode and against the JAX ``ref.py``, on
the sweeps of ``tests/test_kernels.py``, from numpy-seeded inputs.  The
JAX oracles return the mean of V for a query row with no valid key, where
the kernels return 0, so those rows are compared with Pallas only.

The Hopper kernels themselves are held against these plain versions on a
GPU in ``test_torch_gpu.py``.  Tolerances are the reference's: 2e-5 in
fp32, 2e-2 in bf16.
"""

import zlib

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.decode_attention import ops as jda_ops  # noqa: E402
from repro.kernels.decode_attention import ref as jda_ref  # noqa: E402
from repro.kernels.flash_attention import ops as jfa_ops  # noqa: E402
from repro.kernels.flash_attention import ref as jfa_ref  # noqa: E402
from repro.kernels.rmsnorm import ops as jrn_ops  # noqa: E402
from repro.kernels.rmsnorm import ref as jrn_ref  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rn_ref  # noqa: E402

DTYPES = ["float32", "bfloat16"]


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _pair(x: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor of ``dtype`` (both
    round fp32 to bf16 to nearest even)."""
    return jnp.asarray(x).astype(dtype), torch.from_numpy(np.ascontiguousarray(x)).to(
        getattr(torch, dtype))


def _ints(x: np.ndarray):
    x = np.ascontiguousarray(x, dtype=np.int32)
    return jnp.asarray(x), torch.from_numpy(x)


def _np(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _assert(got, want, dtype, rows=None):
    got, want = _np(got), _np(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    np.testing.assert_allclose(got, want, **_tol(dtype))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

FLASH_SHAPES = [
    (128, 4, 4, 64),     # MHA
    (128, 8, 2, 64),     # GQA 4:1
    (256, 4, 1, 128),    # MQA
    (96, 4, 2, 80),      # ragged block sizes + odd head dim
]
FLASH_MASKS = [(True, 0), (True, 32), (False, 0)]


def _flash_inputs(B, S, T, Hq, Hkv, D, k_offset=0, seed=0):
    rng = _rng("flash", B, S, T, Hq, Hkv, D, k_offset, seed)
    q = rng.standard_normal((B, S, Hq, D), np.float32)
    k = rng.standard_normal((B, T, Hkv, D), np.float32)
    v = rng.standard_normal((B, T, Hkv, D), np.float32)
    qp = np.broadcast_to(np.arange(S), (B, S)).copy()
    kp = np.broadcast_to(np.arange(T) + k_offset, (B, T)).copy()
    return q, k, v, qp, kp


def _flash_all(inputs, dtype, **kw):
    """(Pallas interpret, JAX ref, torch plain) outputs on the same inputs."""
    q, k, v, qp, kp = inputs
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    (jqp, tqp), (jkp, tkp) = _ints(qp), _ints(kp)
    pal = jfa_ops.flash_attention(jq, jk, jv, q_positions=jqp, k_positions=jkp,
                                  interpret=True, **kw)
    ref = jfa_ref.attention(jq, jk, jv, q_positions=jqp, k_positions=jkp, **kw)
    got = fa_ref.attention(tq, tk, tv, q_positions=tqp, k_positions=tkp, **kw)
    return pal, ref, got


@pytest.mark.parametrize("S,Hq,Hkv,D", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_plain_matches_jax(S, Hq, Hkv, D, dtype, causal, window):
    pal, ref, got = _flash_all(_flash_inputs(2, S, S, Hq, Hkv, D), dtype,
                               causal=causal, window=window)
    _assert(got, pal, dtype)
    _assert(got, ref, dtype)


def test_flash_plain_softcap():
    pal, ref, got = _flash_all(_flash_inputs(1, 64, 64, 2, 2, 32), "float32",
                               causal=True, softcap=30.0)
    _assert(got, pal, "float32")
    _assert(got, ref, "float32")


def test_flash_plain_no_valid_key_rows_are_zero():
    """Keys start at position 10, so causal queries 0..9 see none: the plain
    version returns 0 there, as Pallas does (the JAX oracle returns mean V)."""
    pal, ref, got = _flash_all(_flash_inputs(2, 64, 64, 4, 2, 16, k_offset=10),
                               "float32", causal=True)
    assert np.all(_np(got)[:, :10] == 0.0)
    _assert(got, pal, "float32")
    _assert(got, ref, "float32", rows=(slice(None), slice(10, None)))


def test_flash_chunked_matches_unchunked():
    q, k, v, qp, kp = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                       _flash_inputs(1, 70, 70, 4, 2, 16))
    kw = dict(q_positions=qp.int(), k_positions=kp.int(), causal=True, window=20)
    np.testing.assert_allclose(
        _np(fa_ref.attention_chunked(q, k, v, block_q=16, **kw)),
        _np(fa_ref.attention(q, k, v, **kw)), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

DECODE_SHAPES = [(256, 8, 2, 64), (512, 4, 4, 128), (128, 16, 1, 64), (96, 4, 2, 80)]


def _decode_all(q, kc, vc, qp, kp, dtype, **kw):
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(kc, dtype), _pair(vc, dtype)
    (jqp, tqp), (jkp, tkp) = _ints(qp), _ints(kp)
    pal = jda_ops.decode_attention(jq, jk, jv, q_positions=jqp, k_positions=jkp,
                                   interpret=True, **kw)
    ref = jda_ref.decode_attention(jq, jk, jv, q_positions=jqp, k_positions=jkp, **kw)
    got = da_ref.decode_attention(tq, tk, tv, q_positions=tqp, k_positions=tkp, **kw)
    return pal, ref, got


def _decode_inputs(B, L, Hq, Hkv, D, seed=0):
    rng = _rng("decode", B, L, Hq, Hkv, D, seed)
    return (rng.standard_normal((B, 1, Hq, D), np.float32),
            rng.standard_normal((B, L, Hkv, D), np.float32),
            rng.standard_normal((B, L, Hkv, D), np.float32))


@pytest.mark.parametrize("L,Hq,Hkv,D", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_plain_matches_jax(L, Hq, Hkv, D, dtype):
    q, kc, vc = _decode_inputs(3, L, Hq, Hkv, D)
    qp = np.asarray([[L // 3], [L // 2], [L - 1]])
    kp = np.broadcast_to(np.arange(L), (3, L))
    kp = np.where(kp <= qp, kp, -1)   # partially filled cache
    pal, ref, got = _decode_all(q, kc, vc, qp, kp, dtype)
    _assert(got, pal, dtype)
    _assert(got, ref, dtype)


def test_decode_plain_ring_buffer_window():
    """Ring layout: positions wrap modulo the window."""
    B, L = 2, 64
    q, kc, vc = _decode_inputs(B, L, 4, 2, 32)
    cur = 150  # decoded beyond the ring: slots hold positions 87..150
    kp = np.broadcast_to(cur - ((cur - np.arange(L)) % L), (B, L))
    qp = np.full((B, 1), cur)
    pal, ref, got = _decode_all(q, kc, vc, qp, kp, "float32", window=L)
    _assert(got, pal, "float32")
    _assert(got, ref, "float32")


def test_decode_plain_softcap_and_no_valid_key_row():
    """Row 0's cache is empty (all -1): 0 from the plain version and Pallas."""
    B, L = 3, 64
    q, kc, vc = _decode_inputs(B, L, 8, 2, 16)
    kp = np.broadcast_to(np.arange(L), (B, L)).copy()
    kp[0] = -1
    qp = np.asarray([[40], [20], [63]])
    pal, ref, got = _decode_all(q, kc, vc, qp, kp, "float32", softcap=30.0, window=16)
    assert np.all(_np(got)[0] == 0.0)
    _assert(got, pal, "float32")
    _assert(got, ref, "float32", rows=slice(1, None))


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_decode_split_merge_matches_unsplit_and_jax(chunk, softcap):
    """The split-KV merge algebra (``ref.decode_attention_split``, what the
    kernel's two passes compute) against the unsplit plain version and the
    JAX ref, 1e-5 in fp32.  Row 0 has no key at all (exactly 0; the JAX ref
    returns the mean of V there, so it is left out of that comparison);
    row 1's window of 40 leaves every chunk before slot 101 with no
    visible key; row 2's cache is filled up to its query at 70."""
    B, L, Hq, Hkv, D = 3, 150, 8, 2, 32
    q, kc, vc = _decode_inputs(B, L, Hq, Hkv, D, seed=chunk)
    kp = np.broadcast_to(np.arange(L), (B, L)).copy()
    kp[0] = -1
    kp[2, 71:] = -1
    qp = np.asarray([[149], [140], [70]])
    (jq, tq), (jk, tk), (jv, tv) = _pair(q), _pair(kc), _pair(vc)
    (jqp, tqp), (jkp, tkp) = _ints(qp), _ints(kp)
    window = np.asarray([0, 40, 0])
    got, want, jax_want = [], [], []
    for b in range(B):  # one window per row
        kw = dict(window=int(window[b]), softcap=softcap)
        rows = slice(b, b + 1)
        got.append(da_ref.decode_attention_split(
            tq[rows], tk[rows], tv[rows], q_positions=tqp[rows], k_positions=tkp[rows],
            chunk=chunk, **kw))
        want.append(da_ref.decode_attention(
            tq[rows], tk[rows], tv[rows], q_positions=tqp[rows], k_positions=tkp[rows], **kw))
        jax_want.append(_np(jda_ref.decode_attention(
            jq[rows], jk[rows], jv[rows], q_positions=jqp[rows], k_positions=jkp[rows], **kw)))
    got, want = torch.cat(got), torch.cat(want)
    assert torch.all(got[0] == 0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(got)[1:], np.concatenate(jax_want[1:]), rtol=1e-5,
                               atol=1e-5)


# (B, Hkv, L, SMs) -> (n_split, chunk): the table's shape, recurrentgemma's
# full ring and its serving shape, a batch whose chunks are 4 tiles with
# a ragged last one, and a batch that fills the card without a split
SPLIT_PLANS = [((1, 8, 545, 132), (9, 64)), ((1, 1, 2048, 132), (32, 64)),
               ((8, 1, 1024, 132), (16, 64)), ((8, 8, 1000, 132), (4, 256)),
               ((64, 8, 545, 132), (1, 576))]


@pytest.mark.parametrize("shape,plan", SPLIT_PLANS)
def test_decode_split_plan(shape, plan):
    """Chunks are whole tiles, none empty, they cover the cache, and the
    blocks of pass 1 come to about two per SM where the cache allows."""
    B, Hkv, L, sms = shape
    n_split, chunk = da_ops.split_plan(B, Hkv, L, sms)
    assert (n_split, chunk) == plan
    assert chunk % da_ops.TILE == 0
    assert (n_split - 1) * chunk < L <= n_split * chunk
    assert B * Hkv * n_split <= max(B * Hkv, 2 * sms)


@pytest.mark.parametrize("window", [0, 24])
def test_paged_plain_matches_jax(window):
    """The plain paged version (for the next slice) against the Pallas
    block-pool kernel over shuffled physical blocks."""
    B, Hq, Hkv, D, bs, nb, N = 3, 8, 2, 64, 16, 4, 14
    rng = _rng("paged", window)
    q = rng.standard_normal((B, 1, Hq, D), np.float32)
    kp_ = rng.standard_normal((N, bs, Hkv, D), np.float32)
    vp_ = rng.standard_normal((N, bs, Hkv, D), np.float32)
    q_lens = [5, 17, 63]
    perm = rng.permutation(np.arange(1, N))  # block 0 is the garbage block
    tables = np.zeros((B, nb), np.int32)
    ptr = 0
    for b, p in enumerate(q_lens):
        need = (p + 1 + bs - 1) // bs
        tables[b, :need] = perm[ptr:ptr + need]
        ptr += need
    qp = np.asarray([[p] for p in q_lens])
    (jq, tq), (jk, tk), (jv, tv) = _pair(q), _pair(kp_), _pair(vp_)
    (jt, tt), (jqp, tqp) = _ints(tables), _ints(qp)
    pal = jda_ops.paged_decode_attention(jq, jk, jv, block_tables=jt, q_positions=jqp,
                                         window=window, interpret=True)
    got = da_ref.paged_decode_attention(tq, tk, tv, block_tables=tt, q_positions=tqp,
                                        window=window)
    _assert(got, pal, "float32")


# rows at chunk boundaries +- 1 for chunks of 64 and 128, a garbage row
# (q_pos 0, every table entry the garbage block 0) and a long row
PAGED_SPLIT_Q_POS = [63, 64, 65, 127, 128, 129, 0, 250]


@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("bs", [16, 32, 48])
def test_paged_split_matches_unsplit_and_jax(bs, window):
    """The paged split-KV merge (``ref.paged_decode_attention_split``, what
    K4's two passes compute) at chunks of 64, 128 and 192 positions
    against the unsplit plain version, the JAX ref and the Pallas
    block-pool kernel in interpret mode, 1e-5 in fp32.  Block sizes 16,
    32 and 48 (not a divisor of the 64-key tile); window 40 leaves every
    chunk before position 211 of the long row with no visible key."""
    B, Hq, Hkv, D = len(PAGED_SPLIT_Q_POS), 8, 2, 32
    rng = _rng("paged-split", bs, window)
    nb = max(PAGED_SPLIT_Q_POS) // bs + 1
    need = [0 if b == 6 else p // bs + 1 for b, p in enumerate(PAGED_SPLIT_Q_POS)]
    N = sum(need) + 3
    perm = rng.permutation(np.arange(1, N))  # block 0 is the garbage block
    tables = np.zeros((B, nb), np.int32)
    ptr = 0
    for b, n in enumerate(need):
        tables[b, :n] = perm[ptr:ptr + n]
        ptr += n
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.standard_normal(s, np.float32)) for s in
                                    ((B, 1, Hq, D), (N, bs, Hkv, D), (N, bs, Hkv, D)))
    (jt, tt), (jqp, tqp) = _ints(tables), _ints(np.asarray(PAGED_SPLIT_Q_POS)[:, None])
    kw = dict(window=window, softcap=30.0 if window else 0.0)
    want = da_ref.paged_decode_attention(tq, tk, tv, block_tables=tt, q_positions=tqp, **kw)
    pal = jda_ops.paged_decode_attention(jq, jk, jv, block_tables=jt, q_positions=jqp,
                                         interpret=True, **kw)
    jax_want = jda_ref.paged_decode_attention(jq, jk, jv, block_tables=jt, q_positions=jqp,
                                              **kw)
    for chunk in (64, 128, 192):
        got = da_ref.paged_decode_attention_split(tq, tk, tv, block_tables=tt,
                                                  q_positions=tqp, chunk=chunk, **kw)
        for other in (want, pal, jax_want):
            np.testing.assert_allclose(_np(got), _np(other), rtol=1e-5, atol=1e-5)


# (B, Hkv, nb * bs, SMs) -> (n_split, chunk) of K4:
# llama3.1-8b's serving shape (the table's: 8 rows of 64 blocks of 16),
# command-r-plus's G = 12 at 3 rows of 32 blocks of 32, one row, 48-slot
# blocks (a ragged last chunk), and a batch that fills the card unsplit
PAGED_SPLIT_PLANS = [((8, 8, 1024, 132), (4, 256)), ((3, 8, 1024, 132), (8, 128)),
                     ((1, 8, 1024, 132), (16, 64)), ((4, 8, 288, 132), (5, 64)),
                     ((64, 8, 1024, 132), (1, 1024))]


@pytest.mark.parametrize("shape,plan", PAGED_SPLIT_PLANS)
def test_paged_split_plan(shape, plan):
    """K4's chunks: whole tiles, none empty, covering the table's
    positions, from shapes only."""
    B, Hkv, L, sms = shape
    n_split, chunk = da_ops.split_plan(B, Hkv, L, sms)
    assert (n_split, chunk) == plan
    da_ops.check_plan(L, n_split, chunk)


@pytest.mark.parametrize("L,n_split,chunk", [
    (1024, 4, 200),    # not a whole number of 64-key tiles
    (1024, 3, 256),    # the chunks stop short of the last slots
    (1024, 5, 256),    # the last chunk is empty
    (1024, 0, 1024),   # no chunk
])
def test_split_plan_check_raises(L, n_split, chunk):
    """The plan check the wrappers make before a launch (the C entry
    points refuse the same plans, and a split plan without scratch)."""
    with pytest.raises(ValueError):
        da_ops.check_plan(L, n_split, chunk)


# ---------------------------------------------------------------------------
# rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (2, 33, 384), (1, 7, 5, 256), (7, 4096)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_plain_matches_jax(shape, dtype):
    rng = _rng("rmsnorm", shape)
    (jx, tx) = _pair(rng.standard_normal(shape, np.float32), dtype)
    (js, ts) = _pair(rng.standard_normal(shape[-1], np.float32) * 0.1)
    got = rn_ref.rmsnorm(tx, ts)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert(got, jrn_ops.rmsnorm(jx, js, interpret=True), dtype)
    _assert(got, jrn_ref.rmsnorm(jx, js), dtype)


@pytest.mark.parametrize("shape", [(8, 128), (2, 33, 384), (1, 7, 5, 256), (7, 4096)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rmsnorm_plain_matches_jax(shape, dtype):
    """The fused mode: the sum bit for bit the reference's ``x + a``, and
    the norm of that rounded sum, as the reference's model computes
    ``apply_norm(p["norm2"], x + a)``."""
    rng = _rng("add_rmsnorm", shape)
    (jx, tx) = _pair(rng.standard_normal(shape, np.float32), dtype)
    (jr, tr) = _pair(rng.standard_normal(shape, np.float32) * 3.0, dtype)
    (js, ts) = _pair(rng.standard_normal(shape[-1], np.float32) * 0.1)
    s, y = rn_ref.add_rmsnorm(tx, tr, ts)
    assert s.dtype == y.dtype == tx.dtype and s.shape == y.shape == tx.shape
    js_sum = jx + jr
    np.testing.assert_array_equal(_np(s), _np(js_sum))
    assert torch.equal(y, rn_ref.rmsnorm(s, ts))
    _assert(y, jrn_ops.rmsnorm(js_sum, js, interpret=True), dtype)
    _assert(y, jrn_ref.rmsnorm(js_sum, js), dtype)


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_add_rmsnorm_refuses_mismatched_inputs(bad):
    """No silent promotion or broadcast: r must match x."""
    x, s = torch.zeros(4, 64, dtype=torch.bfloat16), torch.zeros(64)
    r = x.float() if bad == "dtype" else torch.zeros(1, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        rn_ops.add_rmsnorm(x, r, s)
    with pytest.raises(TypeError if bad == "dtype" else ValueError):
        dispatch.add_rmsnorm(x, r, s)


# ---------------------------------------------------------------------------
# wrappers and dispatch on the CPU
# ---------------------------------------------------------------------------

def test_wrappers_take_the_plain_version_on_cpu():
    """A CPU tensor goes to the plain version and launches nothing."""
    q, k, v, qp, kp = (torch.from_numpy(np.ascontiguousarray(a)) for a in
                       _flash_inputs(1, 32, 32, 4, 2, 16))
    kw = dict(q_positions=qp.int(), k_positions=kp.int(), causal=True)
    before = (fa_ops.flash_attention.launches, da_ops.decode_attention.launches,
              rn_ops.rmsnorm.launches)
    assert torch.equal(fa_ops.flash_attention(q, k, v, **kw), fa_ref.attention(q, k, v, **kw))
    assert torch.equal(dispatch.flash_attention(q, k, v, **kw), fa_ref.attention(q, k, v, **kw))
    q1, kv = q[:, :1].contiguous(), dict(q_positions=qp[:, -1:].int(), k_positions=kp.int())
    assert torch.equal(da_ops.decode_attention(q1, k, v, **kv),
                       da_ref.decode_attention(q1, k, v, **kv))
    x, s = q.reshape(-1, 16), torch.linspace(-0.1, 0.1, 16)
    assert torch.equal(rn_ops.rmsnorm(x, s), rn_ref.rmsnorm(x, s))
    r = x.roll(1, 0)
    for fused in (rn_ops.add_rmsnorm(x, r, s), dispatch.add_rmsnorm(x, r, s)):
        assert all(torch.equal(a, b) for a, b in zip(fused, rn_ref.add_rmsnorm(x, r, s)))
    assert (fa_ops.flash_attention.launches, da_ops.decode_attention.launches,
            rn_ops.rmsnorm.launches) == before
    with pytest.raises(ValueError):
        with dispatch.use_backend("pallas"):
            pass
