"""Block-level prefix caching and right padding in the port against the
reference: ``hash_token_blocks``, ``BlockPool`` and the engine with
``prefix_cache=True`` or ``pad_side="right"``.

The pool is held to the reference's under one seeded random sequence of
operations: equal free stacks, evictable LRU order, registry, refcounts
and per-hash stats after every operation.  The engines serve the
reference's prefix-cache suite workloads (tinyllama-1.1b smoke, fp32
bridged params, ``max_batch=2``, ``max_len=64``, bucket 8, blocks of 8):
greedy streams, dispatch counts and prefix counters must equal the JAX
engine's, and the streams must equal a cold engine's.
"""

import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import cache as jax_cache  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.sampling import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from test_torch_unified import one_thread, shared_jax_compiles  # noqa: E402,F401 (autouse)

ARCH = "tinyllama-1.1b"
BS = 8
ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8, cache_layout="paged",
              kv_block_size=BS)
COUNTERS = ("prefix_lookups", "prefix_hits", "prefix_blocks_reused", "prefill_tokens_skipped")
SUMMARY_KEYS = ("prefix_lookups", "prefix_hit_rate", "prefix_blocks_reused",
                "prefill_tokens_skipped", "prefix_block_hits", "prefix_block_misses",
                "prefix_block_evictions", "prefix_hashes_tracked", "prefix_blocks_resident")


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config(ARCH, smoke=True)
    params = jax.jit(lambda key: jax_model.init(jcfg, key)[0])(jax.random.PRNGKey(0))
    return jcfg, params, params_from_jax(get_config(ARCH, smoke=True),
                                         jax.tree.map(np.asarray, params), "cpu")


def _drive(engine, arrivals):
    for a in arrivals:
        engine.submit(a.prompt, a.params)
    return {r.uid: list(r.output_tokens) for r in engine.run()}


def _pair(models, arrivals_fn, **kw):
    """The JAX engine and the port's on the same workload; returns both
    engines and both streams."""
    jcfg, params, model = models
    jeng = JaxServingEngine(jcfg, params, **dict(ENGINE, **kw))
    jout = _drive(jeng, arrivals_fn(jax_workload))
    eng = ServingEngine(model, **dict(ENGINE, **kw), device="cpu")
    return jeng, jout, eng, _drive(eng, arrivals_fn(workload))


# -- hashing and the pool ---------------------------------------------------------

@pytest.mark.parametrize("n,bs", [(0, 8), (7, 8), (20, 8), (64, 16), (33, 1)])
def test_hash_token_blocks_matches_reference(n, bs):
    toks = np.random.default_rng(n).integers(0, 2 ** 31 - 1, n).astype(np.int32)
    assert cache_lib.hash_token_blocks(toks, bs) == jax_cache.hash_token_blocks(toks, bs)
    assert len(cache_lib.hash_token_blocks(toks, bs)) == n // bs


def _pool_state(pool):
    return (list(pool.free_stack), list(pool.evictable), dict(pool.refs), dict(pool.block_of),
            dict(pool.hash_of), set(pool.ready), pool.evictions,
            {h: list(v) for h, v in pool.prefix_stats.items()}, pool.available, pool.in_use)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_pool_matches_reference_under_random_ops(seed):
    """One seeded random sequence of allocate / register / mark_ready /
    peek / lookup / free over two pools: every read and the whole state
    equal after every operation (free stack and LRU order included)."""
    rng = np.random.default_rng(seed)
    ours, ref = cache_lib.BlockPool(13), jax_cache.BlockPool(13)
    owned = []                         # block lists of live "requests"
    hashes = [int(h) for h in rng.integers(1, 2 ** 62, 6)]
    for _ in range(400):
        op = rng.integers(0, 5)
        if op == 0 and ours.available:
            n = int(rng.integers(1, ours.available + 1))
            got = ours.allocate(n)
            assert got == ref.allocate(n)
            owned.append(got)
        elif op == 1 and owned:
            blocks = owned[int(rng.integers(0, len(owned)))]
            h, blk = hashes[int(rng.integers(0, 6))], blocks[int(rng.integers(0, len(blocks)))]
            if blk not in ours.hash_of:
                assert ours.register(h, blk) == ref.register(h, blk)
        elif op == 2 and owned:
            blk = owned[int(rng.integers(0, len(owned)))][0]
            ours.mark_ready(blk)
            ref.mark_ready(blk)
        elif op == 3:
            chain = [hashes[i] for i in rng.permutation(6)[:int(rng.integers(1, 4))]]
            assert ours.peek(chain) == ref.peek(chain)
            got = ours.lookup(chain)
            assert got == ref.lookup(chain)
            if got:
                owned.append(got)
        elif op == 4 and owned:
            blocks = owned.pop(int(rng.integers(0, len(owned))))
            ours.free(blocks)
            ref.free(blocks)
        assert _pool_state(ours) == _pool_state(ref)
    assert ours.evictions > 0 and sum(st[0] for st in ours.prefix_stats.values()) > 0


def test_block_pool_refuses_overdraft():
    pool = cache_lib.BlockPool(4)
    with pytest.raises(ValueError, match="allocate"):
        pool.allocate(4)


# -- the engine ---------------------------------------------------------------------

def _shared(vocab, temperature=0.0):
    return lambda lib: lib.shared_prefix_trace(
        vocab, num_requests=6, shared_prefix_len=24, num_prefixes=2, suffix_len=8, max_new=6,
        temperature=temperature, top_k=8, seed=3)


def test_shared_prefix_trace_matches_reference():
    for kw in (dict(), dict(arrival_rate=2.0, temperature=0.7, top_k=5, seed=9)):
        ours = workload.shared_prefix_trace(500, num_requests=7, **kw)
        ref = jax_workload.shared_prefix_trace(500, num_requests=7, **kw)
        for a, b in zip(ours, ref):
            assert a.time_s == b.time_s
            np.testing.assert_array_equal(a.prompt, b.prompt)
            assert (a.params.temperature, a.params.top_k, a.params.max_new_tokens) == \
                (b.params.temperature, b.params.top_k, b.params.max_new_tokens)


@pytest.mark.parametrize("chunk,unified", [(0, True), (8, True), (8, False)],
                         ids=["whole", "chunk8-unified", "chunk8-per-chunk"])
def test_prefix_cached_engine_matches_reference_and_cold(models, chunk, unified):
    arrivals = _shared(models[0].vocab_size)
    jeng, jout, eng, out = _pair(models, arrivals, kv_num_blocks=64,
                                 prefill_chunk=chunk, unified_step=unified, prefix_cache=True)
    assert len(out) == 6 and out == jout
    assert eng._dispatch_samples == jeng._dispatch_samples
    assert eng.peak_blocks_in_use == jeng.peak_blocks_in_use
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    ours, ref = eng.latency_summary(), jeng.latency_summary()
    assert set(ours) == set(ref)
    for key in SUMMARY_KEYS:
        assert ours[key] == ref[key], key
    assert eng.prefix_hits > 0 and eng.blocks_in_use == 0
    assert eng.prefill_tokens_skipped == BS * eng.prefix_blocks_reused
    assert _pool_state(eng._pool) == _pool_state(jeng._pool)
    cold = ServingEngine(models[2], **ENGINE, kv_num_blocks=64, prefill_chunk=chunk,
                         unified_step=unified, device="cpu")
    assert _drive(cold, arrivals(workload)) == out


def test_sampled_prefix_streams_equal_cold(models):
    _, _, model = models
    arrivals = _shared(model.cfg.vocab_size, temperature=0.7)(workload)
    outs = []
    for prefix_cache in (False, True):
        eng = ServingEngine(model, **ENGINE, kv_num_blocks=64, prefill_chunk=8,
                            prefix_cache=prefix_cache, device="cpu")
        outs.append(_drive(eng, arrivals))
    assert outs[0] == outs[1] and eng.prefix_hits > 0


def _sequence(models, scenario, lib):
    """Run one of the reference suite's request sequences on an engine of
    ``lib``; returns the engine."""
    jcfg, params, model = models
    rng = np.random.default_rng({"cow": 12, "evict": 13, "tail": 15, "share": 14}[scenario])
    sp = JaxSamplingParams if lib == "jax" else SamplingParams
    kw = dict(ENGINE, prefix_cache=True,
              kv_num_blocks=64 if scenario in ("cow", "share") else 9,
              prefill_chunk=8 if scenario == "share" else 0)
    eng = (JaxServingEngine(jcfg, params, **kw) if lib == "jax"
           else ServingEngine(model, **kw, device="cpu"))
    V = jcfg.vocab_size
    if scenario == "cow":  # a block-aligned prompt twice
        prompt = rng.integers(0, V, 32).astype(np.int32)
        for _ in range(2):
            eng.submit(prompt, sp(max_new_tokens=4))
            eng.run()
    elif scenario == "evict":  # distinct prompts through a minimal pool
        for _ in range(4):
            eng.submit(rng.integers(0, V, 32), sp(max_new_tokens=2))
        eng.run()
    elif scenario == "tail":  # evict a cached chain from the tail, hit its head
        prompt = rng.integers(0, V, 32).astype(np.int32)
        for p in (prompt, rng.integers(0, V, 32), prompt):
            eng.submit(p, sp(max_new_tokens=2))
            eng.run()
    else:  # a sharer joins while the first request still prefills
        prefix = rng.integers(0, V, 24).astype(np.int32)
        eng.submit(np.concatenate([prefix, rng.integers(0, V, 8)]), sp(max_new_tokens=30))
        for _ in range(2):  # the first chunks land; the prompt is not finished
            eng.step()
        eng.submit(np.concatenate([prefix, rng.integers(0, V, 8)]), sp(max_new_tokens=30))
        eng.peak_refs = 0
        while eng.busy:
            eng.step()
            eng.peak_refs = max([eng.peak_refs, *eng._pool.refs.values()])
    return eng


@pytest.mark.parametrize("scenario,against_jax", [("cow", True), ("share", True),
                                                  ("evict", False), ("tail", False)])
def test_prefix_scenarios_match_reference(models, scenario, against_jax):
    """The reference suite's sequences: the copy-on-write tail block is
    never shared (a 32-token prompt twice reuses 3 of its 4 blocks); a
    sharer admitted while the prefix is still being prefilled joins the
    blocks already written, with two live readers (both: streams,
    counters and the pool equal the JAX engine's); distinct prompts
    through a minimal pool evict without false hits; an evicted chain
    degrades from the tail, so its head still hits (both: the values the
    reference suite asserts for its engine)."""
    ours = _sequence(models, scenario, "torch")
    if against_jax:
        ref = _sequence(models, scenario, "jax")
        assert [r.output_tokens for r in ours.finished] == \
            [r.output_tokens for r in ref.finished]
        for name in COUNTERS:
            assert getattr(ours, name) == getattr(ref, name), name
        assert _pool_state(ours._pool) == _pool_state(ref._pool)
    assert ours.blocks_in_use == 0 and all(r == 0 for r in ours._pool.refs.values())
    if scenario == "cow":
        assert (ours.prefix_blocks_reused, ours.prefill_tokens_skipped) == (3, 24)
        assert ours.finished[0].output_tokens == ours.finished[1].output_tokens
    elif scenario == "evict":
        assert ours._pool.evictions > 0 and ours.prefix_hits == 0
        assert len(ours._pool.free_stack) + len(ours._pool.evictable) == 8
    elif scenario == "tail":
        assert ours._pool.evictions >= 1 and ours.prefix_blocks_reused == 3
    else:
        assert ours.prefix_hits == 1 and ours.peak_refs == 2
        assert 0 < ours.prefix_blocks_reused < 3  # joined before the prefix was all written


def test_prefix_cache_refuses_contiguous_and_per_slot_state(models):
    _, _, model = models
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, max_batch=2, max_len=64, prefix_cache=True, device="cpu")
    hybrid = model_lib.init(get_config("recurrentgemma-2b", smoke=True),
                            torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="rglru"):
        ServingEngine(hybrid, **ENGINE, prefix_cache=True, device="cpu")


# -- right padding ---------------------------------------------------------------------

@pytest.mark.parametrize("layout,chunk,unified", [("contiguous", 0, True), ("paged", 8, False)])
def test_pad_right_streams_match_reference(models, layout, chunk, unified):
    """Right-padded rows (each computed only as far as its prompt): the
    reference's streams and dispatch counts."""
    def arrivals(lib):
        return lib.poisson_trace(lib.WorkloadSpec(
            arrival_rate=0.0, num_requests=6, temperature=0.0, top_k=8, seed=11,
            prompt_len=lib.LengthDist(kind="lognormal", mean=16.0, low=2, high=48),
            output_len=lib.LengthDist(kind="uniform", mean=0.0, low=2, high=9)),
            models[0].vocab_size)

    jeng, jout, eng, out = _pair(models, arrivals, cache_layout=layout, kv_block_size=16,
                                 prefill_chunk=chunk, unified_step=unified, pad_side="right")
    assert len(out) == 6 and out == jout
    assert eng._dispatch_samples == jeng._dispatch_samples


def test_pad_right_shares_blocks_across_suffix_lengths(models):
    """Two prompts sharing 12 tokens with suffixes of 2 and 3 tokens:
    right padding keeps the shared tokens on the same blocks of 4, so the
    second reuses them; left padding misaligns them.  As the reference."""
    shared = np.arange(1, 13)
    reused = {}
    for pad_side in ("right", "left"):
        engines = []
        for lib in ("torch", "jax"):
            kw = dict(ENGINE, kv_block_size=4, prefill_chunk=4, prefix_cache=True,
                      pad_side=pad_side)
            eng = (ServingEngine(models[2], **kw, device="cpu") if lib == "torch"
                   else JaxServingEngine(models[0], models[1], **kw))
            sp = SamplingParams if lib == "torch" else JaxSamplingParams
            for suffix in ([60, 61], [70, 71, 72]):
                eng.submit(np.concatenate([shared, suffix]), sp(max_new_tokens=4))
                eng.run()
            engines.append(eng)
        ours, ref = engines
        assert [r.output_tokens for r in ours.finished] == \
            [r.output_tokens for r in ref.finished]
        assert ours.latency_summary()["prefix_block_hits"] == \
            ref.latency_summary()["prefix_block_hits"]
        reused[pad_side] = ours.prefix_blocks_reused
        assert reused[pad_side] == ref.prefix_blocks_reused
    assert reused["right"] >= 2 and reused["left"] == 0


def test_serve_cli_chunked_prefix_cached_on_the_cpu(capsys):
    from repro_torch.launch import serve as serve_cli

    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--cache-layout",
                           "paged", "--prefill-chunk", "16", "--prefix-cache",
                           "--shared-prefix-len", "32", "--requests", "6", "--max-new", "4",
                           "--max-len", "128", "--temperature", "0"]) == 0
    out, _ = json.JSONDecoder().raw_decode(capsys.readouterr().out)
    assert out["requests"] == 6 and out["output_tokens"] == 24
    for key in SUMMARY_KEYS + ("prefill_tokens_per_sec",):
        assert key in out, key
    assert out["prefix_blocks_reused"] > 0 and out["dispatches_per_step_p95"] <= 2
    with pytest.raises(SystemExit):
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--prefix-cache"])
