"""Preemption with recompute and workload-sized pools in the port against
the reference: ``ServingEngine(preemption="recompute")`` on an overcommitted
pool, ``cache.suggest_num_blocks`` and ``workload.estimate_concurrency``.

The matrix is the reference suite's (``tests/test_preemption.py``):
tinyllama-1.1b smoke, fp32 bridged params, ``max_batch=2``, ``max_len=64``,
bucket 8, blocks of 8, a pool of 9 blocks (about half the worst case of
17).  Greedy runs must equal the JAX engine's: streams, ``preemptions``,
``recompute_tokens``, per-step dispatch counts and pool occupancy.
Sampled runs are held to the port's own uncontended run (the port's
counter-based draws are not threefry): a resumed request draws where it
would have drawn without the preemption, so the streams are the same.
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
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from test_torch_serving_hybrid import _params as hybrid_params  # noqa: E402
from test_torch_unified import one_thread, shared_jax_compiles  # noqa: E402,F401 (autouse)

ARCH = "tinyllama-1.1b"
BS = 8            # blocks of 8: max_len 64 is 8 blocks per worst-case slot
HALF_POOL = 9     # about half the 2-slot worst case (17), and the legal minimum
ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8, cache_layout="paged",
              kv_block_size=BS)


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config(ARCH, smoke=True)
    params = jax.jit(lambda key: jax_model.init(jcfg, key)[0])(jax.random.PRNGKey(0))
    return jcfg, params, params_from_jax(get_config(ARCH, smoke=True),
                                         jax.tree.map(np.asarray, params), "cpu")


def _colliding_prompts(vocab, n=6, plen=24, seed=0):
    """24-token prompts reserve 4 of the 8 free blocks each under lazy
    reservation, so two admit together and their growth past position 32
    collides on the half pool (the reference suite's prompts)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, plen).astype(np.int32) for _ in range(n)]


def _run(eng, prompts, params):
    """Submit every prompt with ``params``, drive to the end; returns the
    streams by uid."""
    for p in prompts:
        eng.submit(p, params)
    eng.run()
    return {r.uid: list(r.output_tokens) for r in eng.finished}


def _jax_params(sp):
    return JaxSamplingParams(temperature=sp.temperature, top_k=sp.top_k,
                             eos_token=sp.eos_token, max_new_tokens=sp.max_new_tokens)


def _pair(models, prompts, sp, **kw):
    """The port's engine and the JAX engine on the same prompts (greedy);
    returns both engines and both streams."""
    jcfg, params, model = models
    jeng = JaxServingEngine(jcfg, params, **dict(ENGINE, **kw))
    jout = _run(jeng, prompts, _jax_params(sp))
    eng = ServingEngine(model, **dict(ENGINE, **kw), device="cpu")
    return jeng, jout, eng, _run(eng, prompts, sp)


def _assert_matches_reference(jeng, jout, eng, out):
    assert out == jout
    for name in ("preemptions", "recompute_tokens", "peak_blocks_in_use"):
        assert getattr(eng, name) == getattr(jeng, name), name
    assert eng._dispatch_samples == jeng._dispatch_samples
    assert eng._occ_samples == pytest.approx(jeng._occ_samples)
    assert eng._pool.free_stack == jeng._pool.free_stack


# -- streams under overcommit ----------------------------------------------------------

@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "sampled"])
@pytest.mark.parametrize("chunk", [0, 8])
def test_overcommit_streams_match_uncontended(models, chunk, temperature):
    """The half pool under preemption: every request finishes with the
    streams of the contiguous and the full-pool paged runs, preemptions
    happened, and the pool drains.  Greedy: also the JAX engine's streams,
    counters, dispatch counts, occupancy samples and free stack."""
    model = models[2]
    prompts = _colliding_prompts(model.cfg.vocab_size)
    sp = SamplingParams(temperature=temperature, top_k=8, max_new_tokens=16)
    base = {}
    for layout in ("contiguous", "paged"):
        eng = ServingEngine(model, **dict(ENGINE, cache_layout=layout), prefill_chunk=chunk,
                            device="cpu")
        base[layout] = _run(eng, prompts, sp)
    kw = dict(prefill_chunk=chunk, kv_num_blocks=HALF_POOL, preemption="recompute")
    if temperature == 0.0:
        jeng, jout, eng, over = _pair(models, prompts, sp, **kw)
        _assert_matches_reference(jeng, jout, eng, over)
    else:
        eng = ServingEngine(model, **ENGINE, **kw, device="cpu")
        over = _run(eng, prompts, sp)
    assert over == base["contiguous"] == base["paged"] and len(over) == len(prompts)
    assert eng.preemptions > 0 and eng.recompute_tokens > 0
    assert eng.blocks_in_use == 0 and len(eng._pool.free_stack) == HALF_POOL - 1
    assert not eng._state["block_tables"].any()
    s = eng.latency_summary()
    assert (s["preemptions"], s["recompute_tokens"]) == (eng.preemptions, eng.recompute_tokens)
    assert 0.0 < s["pool_occupancy_p50"] <= s["pool_occupancy_p95"] <= 1.0
    assert sum(r.preemptions for r in eng.finished) == eng.preemptions


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "sampled"])
def test_preemption_with_prefix_cache_keeps_shared_blocks(models, temperature):
    """Overcommit on a shared-prefix trace: the streams of the uncontended
    prefix-cached run, sharers still hit, references balance (a preempted
    sharer's shared blocks lose a reference, never get reclaimed).
    Greedy: also the JAX engine's streams and counters."""
    model = models[2]
    arrivals = workload.shared_prefix_trace(
        model.cfg.vocab_size, num_requests=6, shared_prefix_len=16, num_prefixes=1,
        suffix_len=8, max_new=16, temperature=temperature, top_k=8, seed=3)
    prompts, sp = [a.prompt for a in arrivals], arrivals[0].params
    base = _run(ServingEngine(model, **ENGINE, prefill_chunk=8, kv_num_blocks=64,
                              prefix_cache=True, device="cpu"), prompts, sp)
    kw = dict(prefill_chunk=8, kv_num_blocks=HALF_POOL, prefix_cache=True,
              preemption="recompute")
    if temperature == 0.0:
        jeng, jout, eng, over = _pair(models, prompts, sp, **kw)
        _assert_matches_reference(jeng, jout, eng, over)
        for name in ("prefix_lookups", "prefix_hits", "prefix_blocks_reused",
                     "prefill_tokens_skipped"):
            assert getattr(eng, name) == getattr(jeng, name), name
    else:
        eng = ServingEngine(model, **ENGINE, **kw, device="cpu")
        over = _run(eng, prompts, sp)
    assert over == base
    assert eng.preemptions > 0 and eng.prefix_hits > 0
    assert eng.blocks_in_use == 0 and all(r == 0 for r in eng._pool.refs.values())


@pytest.mark.parametrize("temperature", [0.0, 0.7], ids=["greedy", "sampled"])
def test_preempted_mid_prefill_restarts_cold(models, temperature):
    """Chunks of one token keep cursors open for many steps, so growth
    preempts slots mid-prefill: such a victim had emitted nothing and is
    re-admitted as a fresh request; the streams still match."""
    model = models[2]
    prompts = _colliding_prompts(model.cfg.vocab_size, n=4)
    sp = SamplingParams(temperature=temperature, top_k=8, max_new_tokens=16)
    base = _run(ServingEngine(model, **ENGINE, prefill_chunk=1, device="cpu"), prompts, sp)
    mid_prefill = []

    class Spy(ServingEngine):
        def _preempt(self, slot):
            mid_prefill.append(self._cursors[slot] is not None)
            super()._preempt(slot)

    kw = dict(prefill_chunk=1, kv_num_blocks=HALF_POOL, preemption="recompute")
    eng = Spy(model, **ENGINE, **kw, device="cpu")
    over = _run(eng, prompts, sp)
    assert over == base and len(over) == len(prompts)
    assert any(mid_prefill) and eng.preemptions == len(mid_prefill)
    if temperature == 0.0:
        jeng = JaxServingEngine(models[0], models[1], **ENGINE, **kw)
        _assert_matches_reference(jeng, _run(jeng, prompts, _jax_params(sp)), eng, over)


# -- scheduler invariants ------------------------------------------------------------

def test_head_of_line_never_preempted(models):
    """Victims are the newest admitted request, never the oldest in
    flight: the guarantee that the engine drains under any overcommit."""
    victims = []

    class Spy(ServingEngine):
        def _preempt(self, slot):
            live = [r.admit_seq for r in self.slots if r is not None]
            victims.append((self.slots[slot].admit_seq, sorted(live)))
            super()._preempt(slot)

    eng = Spy(models[2], **ENGINE, kv_num_blocks=HALF_POOL, preemption="recompute",
              device="cpu")
    _run(eng, _colliding_prompts(models[0].vocab_size), SamplingParams(max_new_tokens=16))
    assert victims, "the overcommit never preempted"
    for seq, live in victims:
        assert seq == max(live) and seq != min(live)
    assert len(eng.finished) == 6


def test_preempted_requests_block_new_admissions(models):
    """A parked request re-admits ahead of the queue: no queued request is
    admitted while one is parked, and every request finishes."""
    parked_seen = []

    class Spy(ServingEngine):
        def _admit_batch(self, reqs, slots_for, plen):
            assert not self._preempted, "queue admission bypassed parked requests"
            super()._admit_batch(reqs, slots_for, plen)

        def _try_readmit(self):
            parked_seen.append(len(self._preempted))
            return super()._try_readmit()

    eng = Spy(models[2], **ENGINE, kv_num_blocks=HALF_POOL, preemption="recompute",
              device="cpu")
    _run(eng, _colliding_prompts(models[0].vocab_size, n=8), SamplingParams(max_new_tokens=16))
    assert parked_seen
    assert sorted(r.uid for r in eng.finished) == list(range(8))


# -- pool sizing -------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    ([40] * 20, 8, 64, 2, 0), ([8], 8, 64, 2, 0), ([10_000] * 4, 8, 64, 2, 0),
    ([], 8, 64, 2, 0), ([40] * 20, 8, 64, 4, 1), ([40] * 20, 8, 64, 4, 0),
    (list(range(1, 300, 7)), 16, 1024, 8, 3), ([700, 50, 1024, 900], 16, 1024, 8, 0)])
def test_suggest_num_blocks_matches_reference(args):
    lens, bs, max_len, batch, conc = args
    want = jax_cache.suggest_num_blocks(lens, bs, max_len, batch, concurrency=conc)
    assert cache_lib.suggest_num_blocks(lens, bs, max_len, batch, concurrency=conc) == want
    floor = cache_lib.blocks_per_slot(max_len, bs) + 1
    assert floor <= want <= cache_lib.default_num_blocks(batch, max_len, bs)


@pytest.mark.parametrize("trace", ["burst", "spread", "poisson", "empty"])
def test_estimate_concurrency_matches_reference(trace):
    """The reference's traces (its ``bursty_trace`` has no port yet) and a
    Poisson one of each package: equal estimates."""
    if trace == "burst":
        ref = ours = jax_workload.bursty_trace(128, bursts=1, burst_size=6, prompt_len=16,
                                               max_new=8)
    elif trace == "spread":
        ref = ours = jax_workload.bursty_trace(128, bursts=6, burst_size=1, gap_s=100.0,
                                               prompt_len=16, max_new=8)
    elif trace == "poisson":
        spec = dict(arrival_rate=3.0, num_requests=40, seed=5)
        ref = jax_workload.poisson_trace(jax_workload.WorkloadSpec(**spec), 128)
        ours = workload.poisson_trace(workload.WorkloadSpec(**spec), 128)
    else:
        ref = ours = []
    for batch in (1, 4, 8):
        assert workload.estimate_concurrency(ours, batch) == \
            jax_workload.estimate_concurrency(ref, batch)
    if trace != "poisson":  # the reference suite's values
        assert workload.estimate_concurrency(ours, 4) == {"burst": 4, "spread": 1,
                                                          "empty": 1}[trace]


def test_auto_sized_pool_with_preemption_completes(models):
    """``--kv-num-blocks auto`` with preemption on the reference suite's
    bursty trace: a pool below the worst case, the uncontended streams and
    the JAX engine's."""
    arrivals = jax_workload.bursty_trace(models[0].vocab_size, bursts=2, burst_size=3,
                                         prompt_len=24, max_new=16, seed=1)
    prompts = [a.prompt for a in arrivals]
    sp = SamplingParams(temperature=arrivals[0].params.temperature,
                        top_k=arrivals[0].params.top_k, max_new_tokens=16)
    n = cache_lib.suggest_num_blocks([len(p) + 16 for p in prompts], BS, 64, 2,
                                     concurrency=workload.estimate_concurrency(arrivals, 2))
    assert n < cache_lib.default_num_blocks(2, 64, BS)
    base = _run(ServingEngine(models[2], **ENGINE, device="cpu"), prompts, sp)
    jeng, jout, eng, got = _pair(models, prompts, sp, kv_num_blocks=n, preemption="recompute")
    assert got == base and len(got) == len(prompts)
    _assert_matches_reference(jeng, jout, eng, got)


def test_preemption_validation(models):
    model = models[2]
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, preemption="recompute", device="cpu")
    with pytest.raises(ValueError, match="preemption"):
        ServingEngine(model, **ENGINE, preemption="swap", device="cpu")
    eng = ServingEngine(model, **ENGINE, device="cpu")
    assert eng.preemption == "off" and eng._blocks_for(24, 16) == 5
    eng = ServingEngine(model, **ENGINE, preemption="recompute", device="cpu")
    assert eng._blocks_for(24, 16) == 4  # the prompt and its first decode write


# -- the RG-LRU hybrid (K5) ---------------------------------------------------------------

def test_hybrid_preemption_matches_reference():
    """recurrentgemma-2b smoke (rings and RG-LRU states per slot, reset and
    replayed on re-admission) on the half pool: greedy streams,
    ``preemptions`` and ``recompute_tokens`` equal the JAX engine's, and
    the streams equal the uncontended run's."""
    jcfg, tree = hybrid_params()
    model = params_from_jax(get_config("recurrentgemma-2b", smoke=True), tree, device="cpu")
    prompts = _colliding_prompts(jcfg.vocab_size, n=4)
    sp = SamplingParams(max_new_tokens=16)
    kw = dict(prefill_chunk=8, kv_num_blocks=HALF_POOL, preemption="recompute")
    jeng = JaxServingEngine(jcfg, jax.tree.map(jax.numpy.asarray, tree), **ENGINE, **kw)
    jout = _run(jeng, prompts, _jax_params(sp))
    eng = ServingEngine(model, **ENGINE, **kw, device="cpu")
    out = _run(eng, prompts, sp)
    _assert_matches_reference(jeng, jout, eng, out)
    assert eng.preemptions > 0
    assert out == _run(ServingEngine(model, **ENGINE, prefill_chunk=8, device="cpu"),
                       prompts, sp)
    assert sum(len(set(t)) > 1 for t in out.values()) >= 3, out


# -- the CLI --------------------------------------------------------------------------------

def test_serve_cli_auto_blocks_preemption_and_speculation(capsys):
    from repro_torch.launch import serve as serve_cli

    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--cache-layout",
                           "paged", "--preemption", "recompute", "--kv-num-blocks", "auto",
                           "--speculative", "lookup", "--lookup-friendly", "--requests", "6",
                           "--max-new", "16", "--max-batch", "2", "--max-len", "64",
                           "--kv-block-size", "8", "--temperature", "0"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("# --kv-num-blocks auto -> ")
    out, _ = json.JSONDecoder().raw_decode("\n".join(lines[1:]))
    assert out["requests"] == 6 and out["output_tokens"] == 96
    for key in ("preemptions", "recompute_tokens", "spec_accept_rate", "tokens_per_dispatch",
                "drafted_tokens", "accepted_tokens"):
        assert key in out, key
    assert out["dispatches_per_step_p95"] <= 2
    for bad in (["--preemption", "recompute"], ["--kv-num-blocks", "auto"],
                ["--cache-layout", "paged", "--kv-num-blocks", "many"]):
        with pytest.raises(SystemExit):
            serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", *bad])
