"""The checks of ``tests/test_torch_tp.py`` at tp = 4: one group of 4 gloo
ranks against tp = 1, in a file of its own so that the tp = 2 and tp = 4
groups can run on two test workers (each group takes tens of seconds on
the CPU).  Besides the scenario matrix, the ledgers, the logits, the shards and the
refusals (an encoder, an uneven KV-group straddle), the dims tp = 4 does
not divide, replicated: qwen2.5-1.5b's, command-r-plus-104b's and
qwen3-moe-30b-a3b's smoke configs (2 KV heads: their pool replicated,
their contiguous cache L-sharded, each rank's query heads reading one KV
head) and recurrentgemma-2b's (2 query heads and 2 recurrent heads: its
attention whole on every rank, its width and gate rows split, its ring
L-sharded), on the reference's tree (``test_torch_xlstm._reference_params``)
under the {contiguous, paged} x {whole, chunked} x {greedy, sampled}
matrix, with logits, cache layouts and ledgers.  The same group
also serves moonshot-v1-16b-a3b's smoke config (8 routed experts, 2 on
each rank, and a shared one) on the bridged tree of
``tests/test_torch_tp_families.py``: a greedy and a sampled request,
paged, whole and in chunks of 8."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.cache import INIT_FILL  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.sharding import runs  # noqa: E402
from repro_torch.sharding.rules import local_slice, param_rules  # noqa: E402

from test_torch_tp import (ENGINE, SAMPLED, _arrivals, _results,  # noqa: E402,F401
                           test_shard_model_holds_the_tp1_weights,
                           test_tp_dispatch_bound, test_tp_every_rank_agrees_with_rank_0,
                           test_tp_collectives_are_exact, test_tp_ledgers,
                           test_tp_logits_match_tp1,
                           test_tp_preemption_equivalence, test_tp_prefix_cache_equivalence,
                           test_tp_refusals, test_tp_stream_equivalence)
from test_torch_tp_recurrent import _reference_cache_shards  # noqa: E402
from test_torch_xlstm import _reference_params  # noqa: E402

MOONSHOT = get_config("moonshot-v1-16b-a3b", smoke=True)
CHUNKS = (0, 8)
# the dims tp = 4 does not divide, each family's smoke config: (arch, what)
FAMILIES = ["qwen2.5-1.5b", "command-r-plus-104b", "qwen3-moe-30b-a3b", "recurrentgemma-2b"]
FCFGS = {arch: get_config(arch, smoke=True) for arch in FAMILIES}
MATRIX = [(layout, chunk) for layout in ("contiguous", "paged") for chunk in CHUNKS]
CACHE_LEN, RESET = 24, (1,)


def _moonshot_jobs():
    """Paged, whole and chunked: one greedy request and one sampled, the
    routing recorded; then the rank's parameters."""
    arrivals = _arrivals(MOONSHOT, n=2)
    return [runs.Serve(f"paged/{chunk}", dict(ENGINE, cache_layout="paged", prefill_chunk=chunk),
                       arrivals, record=True) for chunk in CHUNKS] + [runs.Params()]


def _family_serves(arch):
    """The matrix: 4 requests, greedy and sampled side by side."""
    return [runs.Serve(f"{layout}/{chunk}", dict(ENGINE, cache_layout=layout,
                                                 prefill_chunk=chunk),
                       _arrivals(FCFGS[arch], n=4), record=FCFGS[arch].is_moe)
            for layout, chunk in MATRIX]


def _family_jobs(arch):
    """The serving matrix; a batch of 2 x 20 prefilled whole and in chunks of
    8, contiguous and paged, then 3 decode steps; the cache leaves after a
    prefill, row 1 reset."""
    cfg = FCFGS[arch]
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, cfg.vocab_size, (2, 20))
    steps = rng.integers(0, cfg.vocab_size, (3, 2))
    tables = (rng.permutation(15)[:8] + 1).reshape(2, 4).astype(np.int32)
    paged = dict(layout="paged", block_size=8, num_blocks=16)
    logits = [runs.Logits(tokens, steps, CACHE_LEN, chunk=c, cache=lay,
                          tables=tables if lay else None)
              for lay in ({}, paged) for c in CHUNKS]
    return (_family_serves(arch) + logits
            + [runs.CacheLeaves(tokens, CACHE_LEN, reset=RESET)])


@pytest.fixture(scope="module")
def results():
    tree = _reference_params(jax_config(MOONSHOT.name, smoke=True))
    families = [(runs.Weights(FCFGS[arch], tree=_reference_params(jax_config(arch, smoke=True))),
                 _family_jobs(arch)) for arch in FAMILIES]
    return _results(4, extra=families + [(runs.Weights(MOONSHOT, tree=tree), _moonshot_jobs())])


def _family(res, tp, arch, rank=0):
    return res[tp][rank][FAMILIES.index(arch) - len(FAMILIES) - 1]


def _fserve(res, tp, arch, name, rank=0):
    return _family(res, tp, arch, rank)[[j.name for j in _family_serves(arch)].index(name)]


def _flogits(res, tp, arch, rank=0):
    n = len(MATRIX)
    return _family(res, tp, arch, rank)[n:n + len(MATRIX)]


@pytest.mark.parametrize("chunk", CHUNKS, ids=["whole", "chunked"])
def test_tp4_moonshot_streams_equal_tp1(results, chunk):
    """moonshot at tp = 4 (2 local experts, a quarter of the shared MLP):
    the greedy and the sampled stream equal tp = 1's on every rank, and
    every rank routes every MoE call as rank 0 does."""
    res, _ = results
    want = res[1][0][-1][CHUNKS.index(chunk)]
    assert len(want["streams"]) == 2
    lead = res[4][0][-1][CHUNKS.index(chunk)]
    for rank in range(4):
        got = res[4][rank][-1][CHUNKS.index(chunk)]
        assert got["streams"] == want["streams"], rank
        assert len(got["routes"]["ids"]) == len(want["routes"]["ids"]) > 0
        assert all(np.array_equal(a, b) for a, b in zip(got["routes"]["ids"],
                                                       lead["routes"]["ids"])), rank


def test_tp4_moonshot_shards_hold_the_tp1_weights(results):
    """Each of the 4 ranks holds 2 of the 8 experts, the router's matching
    columns and a quarter of the shared MLP: its slices of tp = 1's
    bridged weights."""
    res, _ = results
    full = res[1][0][-1][-1]
    rules = param_rules(Model(MOONSHOT, device="meta"))
    for rank in range(4):
        shard = res[4][rank][-1][-1]
        assert shard["layers.0.mlp.wg"].shape[0] == 2
        assert shard["layers.0.mlp.router"].shape[1] == 2
        assert shard["layers.0.mlp.shared.wd"].shape[0] == MOONSHOT.d_ff // 4
        for name, p in shard.items():
            assert np.array_equal(p, local_slice(rules[name], full[name], rank, 4)), name


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("temperature", [0.0, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout,chunk", MATRIX,
                         ids=[f"{lay}-{'chunked' if c else 'whole'}" for lay, c in MATRIX])
def test_tp4_undivided_stream_equivalence(results, arch, temperature, layout, chunk):
    """tp = 4's greedy and sampled streams equal tp = 1's byte for byte on
    every rank, where tp = 4 does not divide the KV heads (the pool
    replicated, the contiguous cache L-sharded) or the heads
    (recurrentgemma's attention whole on every rank)."""
    res, _ = results
    arrivals = _arrivals(FCFGS[arch], n=4)
    want = _fserve(res, 1, arch, f"{layout}/{chunk}")["streams"]
    picked = [uid for uid in want if arrivals[uid][1].temperature == temperature]
    assert len(want) == 4 and picked
    for rank in range(4):
        got = _fserve(res, 4, arch, f"{layout}/{chunk}", rank)["streams"]
        assert {u: got[u] for u in picked} == {u: want[u] for u in picked}, rank
    # the streams run through the blocks, not one repeated token each
    assert sum(len(set(want[u])) > 1 for u in want) >= 3, want


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp4_undivided_every_rank_agrees_with_rank_0(results, arch):
    """Each rank's streams, pool accounting, routing (qwen3-moe) and logits
    equal rank 0's bit for bit."""
    res, _ = results
    for job in _family_serves(arch):
        lead = _fserve(res, 4, arch, job.name)
        for rank in range(1, 4):
            other = _fserve(res, 4, arch, job.name, rank)
            assert other["streams"] == lead["streams"], (job.name, rank)
            assert other["pool_accounting"] == lead["pool_accounting"]
            if job.record:
                assert all(np.array_equal(a, b) for a, b in zip(other["routes"]["ids"],
                                                               lead["routes"]["ids"]))
    for i, lead in enumerate(_flogits(res, 4, arch)):
        for rank in range(1, 4):
            assert np.array_equal(_flogits(res, 4, arch, rank)[i], lead), (i, rank)


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp4_undivided_logits_match_tp1(results, arch):
    """Prefill and decode logits, whole and chunked, contiguous (L-sharded)
    and paged (replicated pool, K4 at the rank's query-head offset),
    within 1e-5 of the largest |logit| of tp = 1."""
    res, _ = results
    for i, (want, got) in enumerate(zip(_flogits(res, 1, arch), _flogits(res, 4, arch))):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (arch, i)


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp4_undivided_cache_follows_cache_shardings(results, arch):
    """Each rank's cache leaves have the shard shapes of the reference's
    ``cache_shardings`` (``k``/``v`` on their L slots when tp does not
    divide the KV heads, ``pos`` whole) and hold tp = 1's slots; a reset
    row is at its initial values."""
    res, _ = results
    want_shapes = _reference_cache_shards(jax_config(arch, smoke=True), 4, 2, CACHE_LEN)
    full = _family(res, 1, arch)[-1]
    for rank in range(4):
        got = _family(res, 4, arch, rank)[-1]
        for layer, (entry, shapes, whole) in enumerate(zip(got, want_shapes, full)):
            assert {k: v.shape for k, v in entry.items()} == shapes, (layer, rank)
            for leaf, t in entry.items():
                if t.ndim == 0:
                    continue
                want = whole[leaf]
                if t.shape != want.shape:  # the rank's slice of the one split dim
                    dim = next(d for d in range(t.ndim) if t.shape[d] != want.shape[d])
                    n = t.shape[dim]
                    want = np.take(want, range(rank * n, (rank + 1) * n), axis=dim)
                kept = np.delete(t, RESET, axis=0), np.delete(want, RESET, axis=0)
                scale = max(np.abs(kept[1][np.abs(kept[1]) < 1e29]).max(initial=0.0), 1.0)
                assert np.abs(kept[0] - kept[1]).max() <= 1e-5 * scale, (layer, leaf, rank)
                assert (t[list(RESET)] == INIT_FILL.get(leaf, 0)).all(), (layer, leaf, rank)
    attn = [e for e, kind in zip(got, FCFGS[arch].blocks()) if "k" in e]
    assert attn and all(e["k"].shape[1] < e["pos"].shape[1] for e in attn)  # L-sharded


@pytest.mark.parametrize("arch", FAMILIES)
def test_tp4_undivided_ledgers(results, arch):
    """Per-device KV bytes count what each rank holds, as the reference's
    ``kv_bytes_by_device`` ("replication is real memory"): a replicated
    pool in full on every rank (each the aggregate), a contiguous cache
    its L slices of every ``k``/``v`` leaf (rings included, as the
    reference counts them): the bytes of the reference's shard shapes."""
    res, _ = results
    cfg = FCFGS[arch]
    paged = _fserve(res, 4, arch, "paged/8")
    base = _fserve(res, 1, arch, "paged/8")["kv_bytes_peak"]
    assert (base > 0) == ("attn" in cfg.blocks())
    assert paged["kv_bytes_by_device"] == [base] * 4  # replicated
    contiguous = _fserve(res, 4, arch, "contiguous/0")
    shards = _reference_cache_shards(jax_config(arch, smoke=True), 4, ENGINE["max_batch"],
                                     ENGINE["max_len"])
    want = sum(4 * int(np.prod(e[leaf])) for e in shards for leaf in ("k", "v") if leaf in e)
    assert want > 0 and contiguous["kv_bytes_by_device"] == [want] * 4
    assert contiguous["summary"]["kv_bytes_peak_per_device"] == [want] * 4


@pytest.mark.parametrize("arch", ["command-r-plus-104b", "qwen3-moe-30b-a3b"])
def test_tp4_lifted_refusals_serve_as_tp1(results, arch):
    """command-r-plus-104b's and qwen3-moe-30b-a3b's smoke configs (2 KV
    heads), refused at tp = 4 before, are served: every run of the matrix
    gives tp = 1's streams on every rank."""
    res, _ = results
    for layout, chunk in MATRIX:
        want = _fserve(res, 1, arch, f"{layout}/{chunk}")["streams"]
        for rank in range(4):
            assert _fserve(res, 4, arch, f"{layout}/{chunk}", rank)["streams"] == want
