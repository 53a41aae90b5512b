"""Tensor-parallel serving of the port on the CPU, the counterpart of
``tests/test_sharded_serving.py``.

Sharding heads, FFN hidden and vocabulary over gloo ranks changes where
the arithmetic runs, never which tokens come out: greedy and sampled
streams at tp = 2 and tp = 4 must equal tp = 1's for {contiguous, paged} x
{whole, chunked} x {speculation off, prompt lookup}, with preemption under
recompute and with the prefix cache, and every rank's streams must equal
rank 0's.  Two smoke models: qwen1.5-0.5b (the reference suite's; QKV
biases, tied table, G = 1) and command-r-plus-104b (parallel block, tied
table) with 16 heads over 4 KV heads, G = 4 as in its smoke config, so
that tp = 4 divides its KV heads too (its own 8 over 2, whose KV heads tp
= 4 replicates, run in ``tests/test_torch_tp4.py``'s family matrix).  This file runs tp = 2 and
``tests/test_torch_tp4.py`` the same checks at tp = 4, so that the two
groups can run on two test workers: each spawns one group of ranks
(``launch.mesh.spawn_tp``) that serves every scenario
(``sharding.runs.run_plan``); tp = 1 runs in the test's process.  The ledgers
(per-device KV bytes and block accounting, the summary keys), fp32 logits
within 1e-5 of the largest, the shards' weights, the JAX engine's tp = 1
streams against the port's tp = 2, the refusals (an encoder, an uneven
KV-group straddle), the families refused before (recurrentgemma-2b and
xlstm-1.3b at tp = 2) served against tp = 1, and the per-device energy
ledger of ``DeviceMonitorGroup`` ride along.  The MoE and vision-prefix
families have a file of their own (``tests/test_torch_tp_families.py``),
the recurrent ones too (``tests/test_torch_tp_recurrent.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.sampling import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.energy import (DeviceMonitorGroup, PowerReader,  # noqa: E402
                                     SyntheticReader)
from repro_torch.launch.mesh import make_tp_mesh, spawn_tp  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from repro_torch.serving.workload import LengthDist, WorkloadSpec, poisson_trace  # noqa: E402
from repro_torch.sharding import runs  # noqa: E402
from repro_torch.sharding.rules import local_slice, param_rules  # noqa: E402

ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8, cuda_graph=False)
QWEN = get_config("qwen1.5-0.5b", smoke=True)
# command-r-plus-104b's smoke config with 16 heads over 4 KV heads (G = 4,
# as its own 8 over 2): tp = 4 divides them
COMMAND_R = get_config("command-r-plus-104b", smoke=True).replace(num_heads=16, num_kv_heads=4)
MODELS = {"qwen1.5-0.5b": QWEN, "command-r-plus-104b": COMMAND_R}
MATRIX = [(layout, chunk, spec) for layout in ("contiguous", "paged") for chunk in (0, 8)
          for spec in ("off", "lookup")]
SAMPLED = 0.7  # the odd requests' temperature; the even ones are greedy
# what tp refuses: an encoder, and query heads that straddle two KV groups
# unevenly (12 heads over 3 KV heads: 6 a rank at tp = 2)
STRADDLE = get_config("llama3.2-1b", smoke=True).replace(num_heads=12, num_kv_heads=3)
REFUSED = {
    "seamless-m4t-large-v2": (get_config("seamless-m4t-large-v2", smoke=True), 2, "encoder"),
    "straddle": (STRADDLE, 2, "straddle two groups"),
}
# the families refused before tensor parallelism replicated the dims it does
# not divide, served at their tp against tp = 1 (command-r-plus-104b's and
# qwen3-moe-30b-a3b's smoke configs, 2 KV heads, at tp = 4 in
# tests/test_torch_tp4.py's matrix)
LIFTED = {2: ["recurrentgemma-2b", "xlstm-1.3b"]}


def _arrivals(cfg, n=6, seed=2, greedy_only=False):
    """The reference suite's trace: lognormal prompts of mean 16 (2..48),
    2..8 new tokens, top-k 8; even uids greedy, odd ones sampled at
    ``SAMPLED`` (or all greedy), so one run holds both kinds of stream."""
    spec = WorkloadSpec(arrival_rate=0.0, num_requests=n, temperature=SAMPLED, top_k=8,
                        seed=seed, prompt_len=LengthDist(kind="lognormal", mean=16.0, low=2,
                                                         high=48),
                        output_len=LengthDist(kind="uniform", low=2, high=9))
    return [(a.prompt, a.params if i % 2 and not greedy_only
             else dataclasses.replace(a.params, temperature=0.0))
            for i, a in enumerate(poisson_trace(spec, cfg.vocab_size))]


def _preemption_arrivals(cfg):
    rng = np.random.default_rng(1)
    return [(rng.integers(1, cfg.vocab_size, size=int(rng.integers(10, 25))).astype(np.int32),
             SamplingParams(max_new_tokens=10, temperature=0.8)) for _ in range(8)]


def _prefix_arrivals():
    shared = np.arange(1, 17, dtype=np.int32)
    return [(np.concatenate([shared, [60 + i, 70 + i]]).astype(np.int32),
             SamplingParams(max_new_tokens=4, temperature=0.7)) for i in range(4)]


def _serve_jobs(cfg, tp):
    """The serving scenarios of a tp group; the uncontended preemption
    baselines run at tp = 1 only."""
    jobs = [runs.Serve(f"{layout}/{chunk}/{spec}",
                       dict(ENGINE, cache_layout=layout, prefill_chunk=chunk, speculative=spec),
                       _arrivals(cfg))
            for layout, chunk, spec in MATRIX]
    preempt = dict(ENGINE, max_batch=3, seed=3, cache_layout="paged", prefill_chunk=4,
                   kv_block_size=8)
    for spec in ("off", "lookup"):
        if tp == 1:
            jobs.append(runs.Serve(f"uncontended/{spec}", dict(preempt, speculative=spec),
                                   _preemption_arrivals(cfg)))
        jobs.append(runs.Serve(f"preempted/{spec}", dict(preempt, speculative=spec,
                                                         preemption="recompute",
                                                         kv_num_blocks=10),
                               _preemption_arrivals(cfg)))
    jobs.append(runs.Serve("prefix", dict(ENGINE, cache_layout="paged", prefill_chunk=4,
                                          kv_block_size=4, prefix_cache=True),
                           _prefix_arrivals()))
    return jobs


def _logits_jobs(cfg):
    """A prompt of 20 prefilled whole (contiguous, paged with shuffled
    tables) and in chunks of 8 (paged), then 3 decode steps."""
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int64)
    steps = rng.integers(0, cfg.vocab_size, (3, 2)).astype(np.int64)
    tables = (rng.permutation(15)[:6] + 1).reshape(2, 3).astype(np.int32)
    paged = dict(layout="paged", block_size=8, num_blocks=16)
    return [runs.Logits(tokens, steps, 24),
            runs.Logits(tokens, steps, 24, paged, tables),
            runs.Logits(tokens, steps, 24, paged, tables, chunk=8)]


def _jax_tree():
    jcfg = jax_config("qwen1.5-0.5b", smoke=True)
    params = jax.jit(lambda key: jax_model.init(jcfg, key)[0])(jax.random.PRNGKey(0))
    return jcfg, params, jax.tree.map(np.asarray, params)


JAX_ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8, cache_layout="paged",
                  prefill_chunk=8)


def _lifted_jobs(cfg):
    """A greedy and a sampled request, paged, in chunks of 8."""
    return [runs.Serve("lifted", dict(ENGINE, cache_layout="paged", prefill_chunk=8),
                       _arrivals(cfg, n=2))]


def _plan(tree, tp, group):
    """The plan of a tp group's ranks (``tp`` = ``group``) or of its tp = 1
    run (``tp`` = 1)."""
    plan = []
    for cfg in MODELS.values():
        plan.append((runs.Weights(cfg, seed=0),
                     _serve_jobs(cfg, tp) + _logits_jobs(cfg) + [runs.Params()]))
    plan.append((runs.Weights(QWEN, tree=tree),
                 [runs.Serve("jax", dict(JAX_ENGINE, cuda_graph=False),
                             _arrivals(QWEN, greedy_only=True)),
                  runs.Refusal(dict(device="cuda", cuda_graph=True))]
                 + ([runs.Collectives()] if tp > 1 else [])))
    plan += [(runs.Weights(cfg), []) for cfg, _, _ in REFUSED.values()]
    plan += [(runs.Weights(get_config(arch, smoke=True)), _lifted_jobs(get_config(arch,
                                                                              smoke=True)))
             for arch in LIFTED.get(group, [])]
    return plan


def _results(tp, extra=()):
    """{1: [the plan's results], tp: [rank 0's, rank 1's, ...]}: tp = 1 in
    this process, tp on one group of spawned gloo ranks; and the
    reference's tree.  ``extra`` entries join the end of the plan."""
    jcfg, params, tree = _jax_tree()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as each rank: smoke shapes gain nothing from more
    try:
        out = {1: [runs.run_plan(None, _plan(tree, 1, tp) + list(extra), "cpu")],
               tp: spawn_tp(runs.run_plan, tp, "cpu", _plan(tree, tp, tp) + list(extra),
                            threads=1)}
    finally:
        torch.set_num_threads(threads)
    return out, (jcfg, params)


@pytest.fixture(scope="module")
def results():
    return _results(2)


def _group(res):
    """The tp of a ``results`` fixture's group."""
    return max(res)


def _index(name):
    return list(MODELS).index(name)


def _job(results, tp, model, name, rank=0):
    jobs = _serve_jobs(MODELS[model], tp)
    return results[tp][rank][_index(model)][[j.name for j in jobs].index(name)]


def _first_divergence(cfg, arrival, want, got):
    """The first differing token of a stream and the top-2 margin of the
    tp = 1 logits at that decision (the prompt left-padded to its bucket,
    the stream before it as one chunk), for the failure message."""
    j = next(i for i, (x, y) in enumerate(zip(want, got)) if x != y)
    model = runs.Weights(cfg).build(None, torch.device("cpu"))
    b = ENGINE["prompt_bucket"]
    prompt = arrival[0]
    plen = -(-len(prompt) // b) * b
    toks = np.concatenate([np.zeros(plen - len(prompt), np.int64), prompt,
                           np.asarray(want[:j], np.int64)])
    cache = model.init_cache(1, len(toks) + 1)
    logits = model.prefill({"tokens": torch.from_numpy(toks)[None]}, cache)[0][0]
    top2 = logits.topk(2).values
    return j, float(top2[0] - top2[1])


def _check_streams(results, tp, model, name, arrivals, temperature=None):
    """tp's streams on every rank against tp = 1's (those of the requests
    at ``temperature`` only, where given)."""
    base = _job(results, 1, model, name)["streams"]
    assert len(base) == len(arrivals)
    for rank in range(tp):
        got = _job(results, tp, model, name, rank)["streams"]
        for uid, want in base.items():
            if temperature is not None and arrivals[uid][1].temperature != temperature:
                continue
            if got[uid] != want:
                j, margin = _first_divergence(MODELS[model], arrivals[uid], want, got[uid])
                pytest.fail(f"tp={tp} rank {rank} {model} {name}: request {uid} first differs "
                            f"at token {j}, where tp=1's top-2 margin is {margin:.3g}")


# -- the stream matrix ----------------------------------------------------------

@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("temperature", [0.0, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout,chunk,spec", MATRIX,
                         ids=[f"{lay}-chunk{c}-{s}" for lay, c, s in MATRIX])
def test_tp_stream_equivalence(results, model, temperature, layout, chunk, spec):
    """tp = 2 and tp = 4 greedy and sampled streams (served side by side
    in one run) equal tp = 1's, on every rank."""
    res, _ = results
    _check_streams(res, _group(res), model, f"{layout}/{chunk}/{spec}", _arrivals(MODELS[model]),
                   temperature)


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("spec", ["off", "lookup"])
def test_tp_preemption_equivalence(results, model, spec):
    """An overcommitted pool preempts and recomputes alike at every tp:
    the streams equal tp = 1's uncontended run, and preemptions fire."""
    res, _ = results
    base = _job(res, 1, model, f"uncontended/{spec}")["streams"]
    for tp in res:
        run = _job(res, tp, model, f"preempted/{spec}")
        assert run["preemptions"] > 0, "the pool never ran dry: the test lost its teeth"
        for rank in range(tp):
            assert _job(res, tp, model, f"preempted/{spec}", rank)["streams"] == base, (tp, rank)


@pytest.mark.parametrize("model", list(MODELS))
def test_tp_prefix_cache_equivalence(results, model):
    """Prefix hits reuse the same sharded pool blocks: streams equal tp = 1's."""
    res, _ = results
    _check_streams(res, _group(res), model, "prefix", _prefix_arrivals())
    for tp in res:
        assert _job(res, tp, model, "prefix")["summary"]["prefix_blocks_reused"] > 0


@pytest.mark.parametrize("model", list(MODELS))
def test_tp_every_rank_agrees_with_rank_0(results, model):
    """Each rank's streams, and its own pool's accounting after the run,
    equal rank 0's in every scenario."""
    res, _ = results
    tp, cfg = _group(res), MODELS[model]
    for job in _serve_jobs(cfg, tp):
        lead = _job(res, tp, model, job.name)
        for rank in range(1, tp):
            other = _job(res, tp, model, job.name, rank)
            assert other["streams"] == lead["streams"], (job.name, rank)
            assert other["pool_accounting"] == lead["pool_accounting"]


@pytest.mark.parametrize("model", list(MODELS))
def test_tp_dispatch_bound(results, model):
    """Sharding keeps the step economics: the same dispatches per step as
    tp = 1, and at most 2 a step on the unified step's runs."""
    res, _ = results
    tp = _group(res)
    for job in _serve_jobs(MODELS[model], tp):
        got = _job(res, tp, model, job.name)["dispatch_samples"]
        assert got == _job(res, 1, model, job.name)["dispatch_samples"], job.name
        if job.engine.get("prefill_chunk") and "preemption" not in job.engine:
            assert max(got) <= 2, (job.name, got)


@pytest.mark.parametrize("model", list(MODELS))
def test_tp_ledgers(results, model):
    """Per-device KV bytes come from each rank's cache leaves and sum to
    the aggregate (equal shares: the KV heads divide); each device's pool
    partitions its allocatable blocks as the host's pool does; the
    summary carries the reference's per-device keys."""
    res, _ = results
    tp = _group(res)
    paged = _job(res, tp, model, "paged/8/off")
    per = paged["kv_bytes_by_device"]
    assert len(per) == tp and len(set(per)) == 1
    assert sum(per) == paged["kv_bytes_peak"] == _job(res, 1, model,
                                                     "paged/8/off")["kv_bytes_peak"]
    for view in paged["pool_accounting_by_device"]:
        assert view["free"] + view["in_use"] + view["evictable"] == view["allocatable"]
        assert view["in_use"] == 0  # drained
    s = paged["summary"]
    assert s["tp_devices"] == tp
    assert s["kv_bytes_peak_per_device"] == per
    assert s["pool_blocks_in_use_per_device"] == [0] * tp
    assert s["tp_broadcast_us_p50"] > 0.0
    contiguous = _job(res, tp, model, "contiguous/0/off")
    assert sum(contiguous["kv_bytes_by_device"]) == contiguous["kv_bytes_worst_case"]
    assert "pool_blocks_in_use_per_device" not in contiguous["summary"]
    base = set(_job(res, 1, model, "paged/8/off")["summary"])
    assert set(s) - base == {"tp_devices", "kv_bytes_peak_per_device",
                             "pool_blocks_in_use_per_device", "tp_broadcast_us_p50",
                             "tp_broadcast_us_p95"}


@pytest.mark.parametrize("model", list(MODELS))
def test_tp_logits_match_tp1(results, model):
    """Prefill and decode logits, whole and chunked, contiguous and paged,
    within 1e-5 of the largest |logit| of tp = 1 (fp32; the partial sums
    are added in another order), on every rank bit for bit alike."""
    res, _ = results
    tp = _group(res)
    n1, n = (len(_serve_jobs(MODELS[model], t)) for t in (1, tp))
    for i in range(3):
        want = res[1][0][_index(model)][n1 + i]
        for rank in range(tp):
            got = res[tp][rank][_index(model)][n + i]
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (model, i, rank)
            assert np.array_equal(got, res[tp][0][_index(model)][n + i])


@pytest.mark.parametrize("model", list(MODELS))
def test_shard_model_holds_the_tp1_weights(results, model):
    """``shard_model`` draws every parameter at full shape in init's order:
    each rank's shard is its slice of tp = 1's weights, exactly, by the
    rule of the module that owns each leaf."""
    res, _ = results
    tp, cfg = _group(res), MODELS[model]
    full = res[1][0][_index(model)][-1]
    rules = param_rules(model_lib.Model(cfg, device="meta"))
    for rank in range(tp):
        shard = res[tp][rank][_index(model)][-1]
        assert set(shard) == set(full)
        for name, p in shard.items():
            assert np.array_equal(p, local_slice(rules[name], full[name], rank, tp)), name
        assert shard["embed.table"].shape[0] == cfg.vocab_size // tp


def test_tp2_streams_equal_the_jax_engine(results):
    """The port at tp = 2 on the reference's bridged parameters (each rank
    its slice) gives the greedy streams of the JAX engine at tp = 1 on the
    same tree (paged, chunks of 8)."""
    res, (jcfg, params) = results
    jeng = JaxServingEngine(jcfg, params, **JAX_ENGINE)
    for prompt, p in _arrivals(QWEN, greedy_only=True):
        jeng.submit(prompt, JaxSamplingParams(max_new_tokens=p.max_new_tokens,
                                              temperature=0.0, top_k=p.top_k))
    want = {r.uid: list(r.output_tokens) for r in jeng.run()}
    assert len(want) == 6
    bridged = len(MODELS)
    for rank in range(2):
        assert res[2][rank][bridged][0]["streams"] == want, rank
    assert res[1][0][bridged][0]["streams"] == want


def test_tp_refusals(results):
    """An encoder, and query heads that straddle two KV groups unevenly, at
    tp > 1, and cuda_graph=True on a gloo mesh are refused, naming the
    reason; so is a mesh larger than the process group."""
    res, _ = results
    group, first = _group(res), len(MODELS) + 1
    for i, (name, (_, tp, reason)) in enumerate(REFUSED.items()):
        got = res[group][0][first + i]
        assert got[0] == "ValueError" and reason in got[1], (name, got)
        assert isinstance(res[1][0][first + i], list), name  # tp = 1 serves it
    kind, msg = res[group][1][len(MODELS)][1]
    assert kind == "ValueError" and "cuda_graph" in msg and "gloo" in msg
    no_mesh = res[1][0][len(MODELS)][1]  # nothing to capture: no GPU is the only fault
    assert no_mesh is None or "cuda_graph" not in no_mesh[1]
    with pytest.raises(ValueError, match="process group has 1 rank"):
        make_tp_mesh(4, "cpu")
    with pytest.raises(ValueError, match="nccl"):
        make_tp_mesh(2, "cpu", backend="nccl")


@pytest.mark.parametrize("arch", LIFTED[2])
def test_tp_lifted_refusals_serve_as_tp1(results, arch):
    """recurrentgemma-2b (1 KV head, replicated) and xlstm-1.3b (an sLSTM
    FFN of 85, replicated), refused at tp = 2 before, serve a greedy and a
    sampled request at tp = 2 exactly as at tp = 1, on every rank."""
    res, _ = results
    i = len(MODELS) + 1 + len(REFUSED) + LIFTED[2].index(arch)
    want = res[1][0][i][0]["streams"]
    assert len(want) == 2
    for rank in range(2):
        assert res[2][rank][i][0]["streams"] == want, rank


def test_tp_collectives_are_exact(results):
    """The mesh's sum and its gather of the last dim, on every rank, give
    exactly the sums and rows of the ranks' inputs (gloo: eager only)."""
    res, _ = results
    tp = _group(res)
    for rank in range(tp):
        assert res[tp][rank][len(MODELS)][2] == {"eager": [0.0, 0.0]}, rank


def test_engine_mesh_needs_the_shard():
    """An engine refuses a mesh its model was not sharded over."""
    model = model_lib.init(QWEN, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="shard"):
        ServingEngine(model, mesh=object(), device="cpu")


# -- per-device energy (the reference suite's three monitor-group tests) --------

class _DeadReader(PowerReader):
    """Every read raises: a device whose power sensor is offline."""

    def read_watts(self):
        raise RuntimeError("sensor offline")


def _run_with_monitor(monitor, expect_warning):
    model = model_lib.init(QWEN, torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(model, **ENGINE, monitor=monitor, cache_layout="paged",
                        prefill_chunk=8, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        eng.submit(rng.integers(1, QWEN.vocab_size, 12), SamplingParams(max_new_tokens=6))
    if expect_warning:
        with pytest.warns(RuntimeWarning, match="dropped"):
            with monitor:
                eng.run()
    else:
        with monitor:
            eng.run()
    return eng


def test_tp_per_device_joules_tile_to_total():
    """Each device's windowed integral over the group's window; they sum
    to ``result().joules`` exactly, and request windows tile it."""
    group = DeviceMonitorGroup(
        [SyntheticReader(lambda t, w=20.0 + 10.0 * i: w) for i in range(4)], interval_s=0.01)
    s = _run_with_monitor(group, expect_warning=False).latency_summary()
    total = group.result().joules
    assert len(s["joules_per_device"]) == 4
    assert sum(s["joules_per_device"]) == pytest.approx(total, rel=1e-9, abs=1e-12)
    assert all(j > 0.0 for j in s["joules_per_device"])
    t0, t1 = group.window
    mid = (t0 + t1) / 2.0
    tiled = (sum(group.joules_between_by_device(t0, mid))
             + sum(group.joules_between_by_device(mid, t1)))
    assert tiled == pytest.approx(total, rel=1e-9, abs=1e-12)


def test_tp_summary_survives_dead_device():
    """One device dropping every read: 0 J for it, its drops counted, the
    live device's ledger and the tiling exact."""
    group = DeviceMonitorGroup([SyntheticReader(lambda t: 25.0), _DeadReader()],
                               interval_s=0.01)
    s = _run_with_monitor(group, expect_warning=True).latency_summary()
    assert s["power_reads_dropped"] >= 1
    assert s["power_reads_dropped_per_device"][1] == s["power_reads_dropped"]
    assert s["joules_per_device"][1] == 0.0
    assert s["joules_per_device"][0] > 0.0
    assert s["power_samples_per_sec_per_device"][1] == 0.0
    assert sum(s["joules_per_device"]) == pytest.approx(group.result().joules, rel=1e-9,
                                                        abs=1e-12)
    assert s["joules_total"] >= 0.0


def test_tp_all_devices_dead_summary_does_not_crash():
    """Every reader failing still gives a well-formed summary: zero joules,
    every drop counted."""
    group = DeviceMonitorGroup([_DeadReader(), _DeadReader()], interval_s=0.01)
    s = _run_with_monitor(group, expect_warning=True).latency_summary()
    assert s["joules_total"] == 0.0
    assert s["joules_per_token"] == 0.0
    assert s["joules_per_device"] == [0.0, 0.0]
    assert s["power_reads_dropped"] >= 2


def test_serve_cli_tp(capfd):
    """``launch.serve --tp 2`` on the CPU: rank 0 prints the summary with
    the per-device ledgers; one monitor reads the host the ranks share."""
    import json

    from repro_torch.launch import serve

    assert serve.main(["--smoke", "--arch", "qwen1.5-0.5b", "--device", "cpu", "--tp", "2",
                       "--requests", "3", "--max-new", "4", "--max-len", "64",
                       "--cache-layout", "paged", "--power-reader", "synthetic"]) == 0
    out = capfd.readouterr().out
    assert "per-device energy is not split" in out
    summary, _ = json.JSONDecoder().raw_decode(out[out.index("{"):])
    assert summary["requests"] == 3 and summary["tp_devices"] == 2
    assert sum(summary["kv_bytes_peak_per_device"]) == summary["kv_bytes_peak"]
    assert "joules_per_device" not in summary and summary["joules_total"] > 0.0
