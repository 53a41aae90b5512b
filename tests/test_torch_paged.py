"""The port's paged KV layout against the reference's.

The reference's params (fp32 smoke configs, noise on the norm scales and
QKV biases) are bridged into the port.  A paged prefill and 8 greedy
decode steps over shuffled block tables must give the same logits as the
reference's paged model (``xla`` backend, and ``pallas`` in interpret mode,
which runs the reference's paged decode kernel), and the pool blocks the
tables name must hold the same K/V.  The fill/update functions and the
block pool's LIFO order are held to the reference's one by one.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.models import cache as jax_cache  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.decode_attention import ops as da_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402

# llama (GQA) and qwen1.5 (QKV bias, MHA: G=1)
ARCHS = ["llama3.1-8b", "qwen1.5-0.5b"]
B, PROMPT, GEN, BS = 3, 13, 8, 4
MAX_LEN = PROMPT + GEN + 1
# fp32 on both sides; the sums run in another order, ~1e-6 relative
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
KV_TOL = dict(rtol=1e-5, atol=1e-5)


def _reference_params(cfg, seed=0):
    params, _ = jax_model.init(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        arr = np.asarray(leaf)
        if str(getattr(path[-1], "key", "")) in ("scale", "bq", "bk", "bv"):
            arr = arr + 0.1 * rng.standard_normal(arr.shape).astype(arr.dtype)
        return arr

    return jax.tree_util.tree_map_with_path(perturb, params)


def _shuffled_tables(rng, rows, nb, num_blocks):
    """Each row owns ``nb`` distinct blocks of a shuffled pool (block 0,
    the garbage block, is never handed out)."""
    perm = rng.permutation(np.arange(1, num_blocks))[:rows * nb]
    return perm.reshape(rows, nb).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    arch = request.param
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    tree = _reference_params(jcfg)
    return arch, jcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(cfg, tree, "cpu")


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_paged_prefill_decode_match_reference(arch_pair, backend):
    arch, jcfg, jparams, model = arch_pair
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jcfg.vocab_size, (B, PROMPT), dtype=np.int32)
    nb = cache_lib.blocks_per_slot(MAX_LEN, BS)
    num_blocks = B * nb + 3  # spare blocks, so some of the pool stays unnamed
    tables = _shuffled_tables(rng, B, nb, num_blocks)

    kw = dict(layout="paged", block_size=BS, num_blocks=num_blocks)
    jt = jnp.asarray(tables)
    with jax_dispatch.use_backend(backend, interpret=backend == "pallas"):
        prefill = jax.jit(lambda p, b, c: jax_model.prefill(jcfg, p, b, c, block_tables=jt))
        decode = jax.jit(lambda p, t, pos, c: jax_model.decode_step(
            jcfg, p, t, pos, c, block_tables=jt))
        jcache = jax_model.init_cache(jcfg, B, MAX_LEN, jnp.float32, **kw)
        jlogits, jcache = prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache)
        j_logits = [np.asarray(jlogits)]
        tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        for i in range(GEN):
            jlogits, jcache = decode(jparams, tok, jnp.asarray(PROMPT + i, jnp.int32), jcache)
            j_logits.append(np.asarray(jlogits))
            tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)

    tt = torch.from_numpy(tables)
    cache = model.init_cache(B, MAX_LEN, **kw)
    logits, cache = model.prefill({"tokens": torch.from_numpy(tokens).long()}, cache,
                                  block_tables=tt)
    np.testing.assert_allclose(logits.numpy(), j_logits[0], **LOGITS_TOL)
    for i in range(GEN):  # the reference's greedy tokens, so both see the same inputs
        tok = torch.from_numpy(j_logits[i].argmax(-1)[:, None].astype(np.int32))
        logits, cache = model.decode_step(tok, PROMPT + i, cache, block_tables=tt)
        np.testing.assert_allclose(logits.numpy(), j_logits[i + 1], **LOGITS_TOL,
                                   err_msg=f"{arch}/{backend} step {i}")
    named = tables.reshape(-1)
    for layer, entry in enumerate(cache):
        for leaf in ("kp", "vp"):
            ref = np.asarray(jcache["groups"]["0"]["self"][leaf][layer])
            np.testing.assert_allclose(entry[leaf].numpy()[named], ref[named], **KV_TOL)


def test_fill_and_update_paged_cache_match_reference():
    """Prompt fill with S not a whole number of blocks (the pad lands as
    zeros), then an update where masked rows go to the garbage block."""
    rng = np.random.default_rng(5)
    Bq, S, H, D, bs, N, nb = 3, 10, 2, 8, 4, 16, 4
    tables = _shuffled_tables(rng, Bq, nb, N)
    k, v = (rng.standard_normal((Bq, S, H, D), np.float32) for _ in range(2))
    k1, v1 = (rng.standard_normal((Bq, 1, H, D), np.float32) for _ in range(2))
    pos = np.asarray([10, 3, 14], np.int32)
    mask = np.asarray([True, False, True])

    jc = jax_cache.init_paged_attn_cache(N, bs, H, D, jnp.float32)
    jc = jax_cache.fill_paged_cache(jc, jnp.asarray(k), jnp.asarray(v), None,
                                    jnp.asarray(tables))
    jc = jax_cache.update_paged_cache(jc, jnp.asarray(k1), jnp.asarray(v1),
                                      jnp.asarray(pos), jnp.asarray(tables),
                                      jnp.asarray(mask))
    tc = cache_lib.init_paged_attn_cache(N, bs, H, D, torch.float32, "cpu")
    tt = torch.from_numpy(tables)
    cache_lib.fill_paged_cache(tc, torch.from_numpy(k), torch.from_numpy(v), tt)
    cache_lib.update_paged_cache(tc, torch.from_numpy(k1), torch.from_numpy(v1),
                                 torch.from_numpy(pos), tt, torch.from_numpy(mask))
    for leaf in ("kp", "vp"):
        np.testing.assert_array_equal(tc[leaf].numpy(), np.asarray(jc[leaf]))
    # the masked row's token is in the garbage block, at its offset
    np.testing.assert_array_equal(tc["kp"][cache_lib.GARBAGE_BLOCK, 3 % bs].numpy(), k1[1, 0])
    # the prompt's pad (positions 10, 11 of the last prompt block) is zero
    # except where row 0's update wrote position 10
    last = tables[:, 2]
    assert np.all(tc["kp"].numpy()[last[1:], 2:] == 0)


def test_block_pool_lifo_order_matches_reference():
    ours, ref = cache_lib.BlockPool(12), jax_cache.BlockPool(12)
    script = [("a", 3), ("a", 2), ("f", 0), ("a", 4), ("f", 1), ("a", 1), ("f", 0),
              ("a", 5)]
    held_o, held_r = [], []
    for op, n in script:
        if op == "a":
            held_o.append(ours.allocate(n))
            held_r.append(ref.allocate(n))
        else:
            ours.free(held_o.pop(n))
            ref.free(held_r.pop(n))
        assert held_o == held_r
        assert ours.free_stack == ref.free_stack
        assert (ours.available, ours.in_use) == (ref.available, ref.in_use)
    with pytest.raises(ValueError):
        ours.allocate(ours.available + 1)


def test_pool_sizing_matches_reference():
    for max_len, bs, batch in [(64, 16, 2), (1024, 16, 8), (100, 32, 3), (1, 16, 1)]:
        assert (cache_lib.blocks_per_slot(max_len, bs)
                == jax_cache.blocks_per_slot(max_len, bs))
        assert (cache_lib.default_num_blocks(batch, max_len, bs)
                == jax_cache.default_num_blocks(batch, max_len, bs))
    assert cache_lib.default_num_blocks(8, 1024, 16) == 513


def test_paged_wrapper_takes_the_plain_version_on_cpu():
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 16), np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((9, 4, 2, 16), np.float32))
              for _ in range(2))
    kw = dict(block_tables=torch.tensor([[3, 1, 0], [5, 2, 7]], dtype=torch.int32),
              q_positions=torch.tensor([[6], [11]], dtype=torch.int32), window=5)
    n = da_ops.paged_decode_attention.launches
    want = da_ref.paged_decode_attention(q, kp, vp, **kw)
    assert torch.equal(da_ops.paged_decode_attention(q, kp, vp, **kw), want)
    assert torch.equal(dispatch.paged_decode_attention(q, kp, vp, **kw), want)
    assert da_ops.paged_decode_attention.launches == n
