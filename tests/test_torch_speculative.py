"""Prompt-lookup speculative decoding in the port against the reference:
``prompt_lookup_draft``, ``sampling.verify_slots_keyed``,
``Model.prefill_chunk(overwrite_from=, all_logits=True)`` and
``ServingEngine(speculative="lookup")``.

The engine matrix is the reference suite's (``tests/test_speculative.py``):
qwen1.5-0.5b smoke, fp32 bridged params, ``max_batch=2``, ``max_len=64``,
bucket 8.  A speculative engine's streams must equal the same engine's
without speculation, greedy and sampled, for both layouts, whole-prompt
and chunked; greedy runs must also equal the JAX engine's streams,
drafted and accepted counts and per-step dispatch counts.  Logits are held
to the reference's at 2e-5 (fp32).
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving import sampling as jax_sampling  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.engine import prompt_lookup_draft as jax_draft  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import ServingEngine, prompt_lookup_draft  # noqa: E402
from test_torch_unified import one_thread, shared_jax_compiles  # noqa: E402,F401 (autouse)

ARCH = "qwen1.5-0.5b"
ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config(ARCH, smoke=True)
    params = jax.jit(lambda key: jax_model.init(jcfg, key)[0])(jax.random.PRNGKey(0))
    return jcfg, params, params_from_jax(get_config(ARCH, smoke=True),
                                         jax.tree.map(np.asarray, params), "cpu")


def _arrivals(lib, vocab, n=5, temperature=0.0, seed=3, out_hi=24):
    """The reference suite's trace: lognormal prompts 2..40, 4..23 new
    tokens, top-k 8."""
    return lib.poisson_trace(lib.WorkloadSpec(
        arrival_rate=0.0, num_requests=n, temperature=temperature, top_k=8, seed=seed,
        prompt_len=lib.LengthDist(kind="lognormal", mean=16.0, low=2, high=40),
        output_len=lib.LengthDist(kind="uniform", low=4, high=out_hi)), vocab)


def _drive(eng, arrivals):
    for a in arrivals:
        eng.submit(a.prompt, a.params)
    return {r.uid: list(r.output_tokens) for r in eng.run()}


def _engine(model, speculative="off", spec_tokens=4, **kw):
    return ServingEngine(model, **dict(ENGINE, **kw), speculative=speculative,
                         spec_tokens=spec_tokens, device="cpu")


def _assert_matches_reference(jeng, jout, eng, out):
    assert out == jout
    for name in ("_drafted_tokens", "_accepted_tokens", "_spec_verifies", "_decode_tokens",
                 "_decode_dispatches", "preemptions", "recompute_tokens"):
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng._dispatch_samples == jeng._dispatch_samples


# -- the drafter ------------------------------------------------------------------------

@pytest.mark.parametrize("hist,k,ngram_max,want", [
    ([1, 2, 3, 1, 2], 3, 3, [3, 1, 2]),      # the trailing [1, 2] at 0
    ([5, 5, 5, 5], 2, 3, [5]),               # [5, 5, 5] at 0, one token after it
    ([1, 2, 9, 1, 2, 7, 1, 2], 1, 2, [7]),   # the recent full continuation wins
    ([1, 2, 3], 2, 3, []), ([], 4, 3, []), ([1, 2, 3, 1, 2], 0, 3, [])])
def test_prompt_lookup_draft_cases(hist, k, ngram_max, want):
    """The reference suite's cases."""
    assert prompt_lookup_draft(hist, k, ngram_max) == want == jax_draft(hist, k, ngram_max)


def test_prompt_lookup_draft_matches_reference_on_random_histories():
    rng = np.random.default_rng(0)
    for _ in range(300):
        hist = [int(t) for t in rng.integers(0, int(rng.integers(2, 6)), rng.integers(0, 30))]
        k, n = int(rng.integers(0, 7)), int(rng.integers(1, 4))
        assert prompt_lookup_draft(hist, k, n) == jax_draft(hist, k, n)


# -- the pieces of the verify step ----------------------------------------------------

def test_verify_slots_keyed_matches_reference_greedy():
    """Fixed logits (B = 6, k = 4): drafts that match the greedy picks for
    a few positions, then miss; a short draft; EOS, the budget and the
    length bound cutting the chain mid-window; an inactive row.  Greedy:
    every output equals the reference's."""
    rng = np.random.default_rng(1)
    B, K, V, max_len = 6, 4, 50, 40
    logits = rng.standard_normal((B, K + 1, V)).astype(np.float32)
    greedy = logits.argmax(-1).astype(np.int32)
    draft = rng.integers(0, V, (B, K)).astype(np.int32)
    draft[0] = greedy[0, :K]                 # all accepted
    draft[1, :2] = greedy[1, :2]             # two accepted, then a miss
    draft[2] = greedy[2, :K]                 # accepted, but EOS at position 2
    draft[3] = greedy[3, :K]                 # accepted, but 2 tokens of budget left
    draft[4] = greedy[4, :K]                 # accepted, but near max_len
    draft_len = np.array([4, 4, 4, 4, 4, 3], np.int32)
    active = np.array([1, 1, 1, 1, 1, 0], bool)
    tokens0 = rng.integers(0, V, B).astype(np.int32)
    positions = np.array([10, 3, 7, 20, max_len - 4, 5], np.int32)
    remaining = np.array([30, 30, 30, 2, 30, 30], np.int32)
    eos = np.array([-1, -1, greedy[2, 2], -1, -1, -1], np.int32)
    temperature, top_k = np.zeros(B, np.float32), np.zeros(B, np.int32)
    ref = jax_sampling.verify_slots_keyed(
        jnp.asarray(logits), jnp.asarray(draft), jnp.asarray(draft_len),
        jnp.asarray(temperature), jnp.asarray(top_k),
        jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(0), i))(jnp.arange(B)),
        active=jnp.asarray(active), tokens0=jnp.asarray(tokens0),
        positions=jnp.asarray(positions), remaining=jnp.asarray(remaining),
        eos=jnp.asarray(eos), max_len=max_len)
    t = torch.from_numpy
    counts = torch.arange(B, dtype=torch.int64) + 1
    ours = sampling.verify_slots_keyed(
        t(logits), t(draft), t(draft_len), t(temperature), t(top_k),
        torch.arange(B, dtype=torch.int64) * 7919, counts, active=t(active), tokens0=t(tokens0),
        positions=t(positions), remaining=t(remaining), eos=t(eos), max_len=max_len)
    for key in ("tokens", "emit", "done", "last_token", "positions", "remaining", "active"):
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]), key)
    emitted = ours["emit"].sum(dim=1)
    assert emitted.tolist() == [5, 3, 3, 2, 3, 0]
    assert (ours["counts"] - counts).tolist() == emitted.tolist()  # one draw per token


def test_verify_slots_keyed_draws_as_the_decode_step():
    """Sampled rows: position 0 is the decode step's draw at the row's
    index, and each later position the draw at the next index."""
    rng = np.random.default_rng(2)
    B, K, V = 4, 3, 64
    logits = torch.from_numpy(rng.standard_normal((B, K + 1, V)).astype(np.float32))
    temperature = torch.full((B,), 0.8)
    top_k = torch.tensor([0, 5, 64, 8], dtype=torch.int32)
    keys = torch.tensor([11, 22, 33, 44], dtype=torch.int64)
    counts = torch.tensor([1, 4, 9, 2], dtype=torch.int64)
    draws = [sampling.sample_slots_keyed(logits[:, i], temperature, top_k, keys, counts + i)
             for i in range(K + 1)]
    draft = torch.stack(draws[:K], dim=1).int()
    draft[2, 1] = (draft[2, 1] + 1) % V       # row 2 misses at position 2
    res = sampling.verify_slots_keyed(
        logits, draft, torch.full((B,), K, dtype=torch.int32), temperature, top_k, keys, counts,
        active=torch.ones(B, dtype=torch.bool), tokens0=torch.zeros(B, dtype=torch.int32),
        positions=torch.zeros(B, dtype=torch.int32), remaining=torch.full((B,), 99,
                                                                          dtype=torch.int32),
        eos=torch.full((B,), -1, dtype=torch.int32), max_len=1000)
    assert res["emit"].sum(dim=1).tolist() == [4, 4, 2, 4]
    for i in range(K + 1):
        rows = res["emit"][:, i]
        assert torch.equal(res["tokens"][rows, i], draws[i][rows].int())


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_chunk_overwrite_from_all_logits_matches_reference(models, layout):
    """A prompt, then two verify windows at per-row starts, the second
    writing again over the first's last positions (a rejected suffix):
    every column's logits (fp32, 2e-5) equal the reference's, with
    ``overwrite_from`` at the window's start; rows of length 0 write
    nothing (the third window leaves the logits of the others as they
    were)."""
    jcfg, jparams, model = models
    rng = np.random.default_rng(3)
    B, prefix, C, max_len, bs = 3, 12, 5, 64, 8
    toks = rng.integers(0, jcfg.vocab_size, (B, prefix + 2 * C)).astype(np.int32)
    kw, tables = {}, None
    if layout == "paged":
        nb = max_len // bs
        tables = (rng.permutation(B * nb) + 1).astype(np.int32).reshape(B, nb)
        kw = dict(layout="paged", block_size=bs, num_blocks=B * nb + 1)
    jt = None if tables is None else jnp.asarray(tables)
    tt = None if tables is None else torch.from_numpy(tables)
    jc = jax_model.init_cache(jcfg, B, max_len, jnp.float32, **kw)
    _, jc = jax.jit(lambda p, b, c, t: jax_model.prefill(jcfg, p, b, c, block_tables=t))(
        jparams, {"tokens": jnp.asarray(toks[:, :prefix])}, jc, jt)
    cache = model.init_cache(B, max_len, **kw)
    model.prefill({"tokens": torch.from_numpy(toks[:, :prefix])}, cache, block_tables=tt)
    window = jax.jit(lambda p, b, c, s, t, n: jax_model.prefill_chunk(
        jcfg, p, b, c, s, block_tables=t, lengths=n, overwrite_from=s, all_logits=True))
    starts = ([prefix] * B, [prefix + 2, prefix + 1, prefix + 3], [prefix + 4] * B)
    lengths = ([C, C, 3], [C, 2, C], [0, 0, 0])
    for i, (st, ln) in enumerate(zip(starts, lengths)):
        st, ln = np.asarray(st, np.int32), np.asarray(ln, np.int32)
        w = toks[:, prefix + i * C:prefix + (i + 1) * C] if i < 2 else toks[:, -C:]
        jl, jc = window(jparams, {"tokens": jnp.asarray(w)}, jc, jnp.asarray(st), jt,
                        jnp.asarray(ln))
        st_t = torch.from_numpy(st)
        logits, cache = model.prefill_chunk(torch.from_numpy(w), cache, st_t, block_tables=tt,
                                            lengths=torch.from_numpy(ln), overwrite_from=st_t,
                                            all_logits=True)
        assert logits.shape == (B, C, jcfg.vocab_size) and logits.dtype == torch.float32
        valid = np.arange(C)[None] < ln[:, None]
        np.testing.assert_allclose(logits.numpy()[valid], np.asarray(jl)[valid], rtol=2e-5,
                                   atol=2e-5)


# -- the engine -----------------------------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("chunk", [0, 8])
def test_speculative_matches_plain(models, layout, temperature, chunk):
    """Streams with speculation == without, every layout, greedy and
    sampled, whole-prompt and chunked (unified step); drafts are accepted
    and steps emit more than one token.  Greedy: the JAX engine's streams,
    drafter counts and dispatch counts."""
    jcfg, params, model = models
    arrivals = _arrivals(workload, jcfg.vocab_size, temperature=temperature)
    base = _drive(_engine(model, cache_layout=layout, prefill_chunk=chunk), arrivals)
    eng = _engine(model, "lookup", cache_layout=layout, prefill_chunk=chunk)
    spec = _drive(eng, arrivals)
    assert spec == base and len(spec) == len(arrivals)
    if temperature == 0.0:
        jeng = JaxServingEngine(jcfg, params, **ENGINE, cache_layout=layout,
                                prefill_chunk=chunk, speculative="lookup")
        jout = _drive(jeng, _arrivals(jax_workload, jcfg.vocab_size))
        _assert_matches_reference(jeng, jout, eng, spec)
        assert set(eng.latency_summary()) == set(jeng.latency_summary())
    s = eng.latency_summary()
    assert s["drafted_tokens"] > 0 and s["accepted_tokens"] > 0
    assert 0.0 <= s["spec_accept_rate"] <= 1.0 and s["tokens_per_dispatch"] > 1.0
    if layout == "paged":
        assert eng.blocks_in_use == 0


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_rejections_fire_and_do_not_corrupt(models, layout, monkeypatch):
    """A drafter that always proposes [3, 1, 4, 1]: drafts are rejected,
    and the sampled streams stay those without speculation (the emitted
    token is the model's own draw, and a rejected suffix's writes are
    written again or masked before any read)."""
    model = models[2]
    arrivals = _arrivals(workload, model.cfg.vocab_size, temperature=0.7)
    base = _drive(_engine(model, cache_layout=layout, prefill_chunk=8), arrivals)
    monkeypatch.setattr(engine_mod, "prompt_lookup_draft",
                        lambda hist, k, ngram_max=3: [3, 1, 4, 1][:k])
    eng = _engine(model, "lookup", cache_layout=layout, prefill_chunk=8)
    assert _drive(eng, arrivals) == base
    s = eng.latency_summary()
    assert s["drafted_tokens"] > 0 and s["accepted_tokens"] < s["drafted_tokens"]
    assert s["spec_accept_rate"] < 1.0


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "sampled"])
def test_speculative_under_preemption(models, temperature):
    """Overcommit with lazy growth: the verify window's blocks are grown
    before the step, a rejected suffix's blocks given back, preempted
    requests recomputed and resumed mid-stream; the streams equal the
    preempting engine's without speculation.  Greedy: also the JAX
    engine's streams and counters."""
    jcfg, params, model = models
    arrivals = _arrivals(workload, jcfg.vocab_size, temperature=temperature, n=6, seed=11,
                         out_hi=30)
    kw = dict(cache_layout="paged", prefill_chunk=8, preemption="recompute", kv_num_blocks=10,
              kv_block_size=8, max_batch=3)
    base = _drive(_engine(model, **kw), arrivals)
    eng = _engine(model, "lookup", **kw)
    spec = _drive(eng, arrivals)
    assert spec == base
    assert eng.preemptions > 0 and eng._accepted_tokens > 0
    assert eng.blocks_in_use == 0 and len(eng._pool.free_stack) == eng.num_blocks - 1
    if temperature == 0.0:
        jeng = JaxServingEngine(jcfg, params, **dict(ENGINE, **kw), speculative="lookup")
        jout = _drive(jeng, _arrivals(jax_workload, jcfg.vocab_size, n=6, seed=11, out_hi=30))
        _assert_matches_reference(jeng, jout, eng, spec)


def test_speculative_dispatch_bound(models):
    """At most two dispatches a step (the verify step replaces the decode
    step one for one), and the emission balance: each verify emits its
    accepted tokens and one more."""
    model = models[2]
    eng = _engine(model, "lookup", cache_layout="paged", prefill_chunk=8)
    _drive(eng, _arrivals(workload, model.cfg.vocab_size))
    assert max(eng._dispatch_samples) <= 2
    assert eng._decode_tokens == eng._spec_verifies + eng._accepted_tokens
    assert eng.decode_forwards == 0 and eng.chunk_forwards > eng._spec_verifies


def test_speculative_validation(models):
    model = models[2]
    with pytest.raises(ValueError, match="speculative"):
        _engine(model, "banana")
    with pytest.raises(ValueError, match="spec-tokens"):
        _engine(model, "lookup", spec_tokens=0)
    hybrid = model_lib.init(get_config("recurrentgemma-2b", smoke=True),
                            torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="rewind"):
        ServingEngine(hybrid, **ENGINE, speculative="lookup", device="cpu")
    eng = _engine(model, "off", spec_tokens=0)  # 'off' ignores spec_tokens
    assert eng.spec_k == 0 and "drafts" not in eng._state


def test_lookup_friendly_trace_accepts(models):
    """Tiled motifs: the trace equals the reference's, and greedy decoding
    cycles the motif, so most drafts are accepted and a step emits more
    than two tokens on average."""
    model = models[2]
    kw = dict(num_requests=4, motif_len=8, repeats=3, max_new=24)
    arrivals = workload.lookup_friendly_trace(model.cfg.vocab_size, **kw)
    for ours, ref in zip(arrivals, jax_workload.lookup_friendly_trace(model.cfg.vocab_size,
                                                                      **kw)):
        np.testing.assert_array_equal(ours.prompt, ref.prompt)
        assert (ours.time_s, ours.params.max_new_tokens) == (ref.time_s,
                                                             ref.params.max_new_tokens)
    assert all(len(a.prompt) == 24 for a in arrivals)
    base = _drive(_engine(model, prefill_chunk=8), arrivals)
    eng = _engine(model, "lookup", spec_tokens=6, prefill_chunk=8)
    assert _drive(eng, arrivals) == base
    s = eng.latency_summary()
    assert s["spec_accept_rate"] > 0.5 and s["tokens_per_dispatch"] > 2.0
