"""Tensor-parallel serving of the MoE and vision-prefix families on the
CPU: qwen3-moe-30b-a3b (8 routed experts, top-2; 8/2 heads), moonshot-v1-16b-a3b
(8 routed experts and a shared one; 4/4 heads) and llava-next-34b (4 patch
embeddings before the tokens; 8/2 heads), smoke configs in fp32, at tp = 2.

Each rank of a MoE layer holds E / tp experts and the router's matching
columns, gathers the router logits of every rank into the whole row and
routes over all E experts with tp = 1's capacity, so the same pairs are
kept and dropped on every rank and as at tp = 1; the routed and the shared
partials are reduced once.  A vision model's patches are an input, the
same on every rank.  One group of 2 gloo ranks (``launch.mesh.spawn_tp``)
runs the whole plan (``sharding.runs.run_plan``); tp = 1 runs in the
test's process.  Held: greedy and sampled streams byte for byte against
tp = 1 for {contiguous, paged} x {whole, chunked} and under preemption with
recompute (its own schedule at both tp: capacity counts the rows beside
a token); every rank's streams and routing ids against rank 0's; the
dropped pairs of a batch that drops some; fp32 logits within 1e-5 of the
largest, with and without a non-zero patch prefix; each rank's shard
against tp = 1's weights (drawn by ``shard_model`` and bridged); the
ledgers; and the reference: the JAX engine's greedy streams at tp = 1 on
the same tree for the MoE models (same schedule), and for llava, whose
reference engine decodes a vision request from the prompt's length (ROADMAP
queue 3), the reference's model-level loop the port's engine is held to
at tp = 1 (``tests/test_torch_vlm.py``).  ``check_tp`` at full configs,
accepted (a dim tp does not divide replicated, each shard's shapes the
reference's) and refused (an encoder, an uneven KV-group straddle), rides
along.
"""

import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import spawn_tp  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.sharding import runs  # noqa: E402
from repro_torch.sharding.rules import check_tp, local_slice, param_rules  # noqa: E402

from test_torch_tp import STRADDLE, _arrivals, _preemption_arrivals, SAMPLED  # noqa: E402
from test_torch_tp_recurrent import _Mesh, check_shard_layout  # noqa: E402
from test_torch_unified import (_drive, _trace, one_thread,  # noqa: E402,F401 (autouse)
                                shared_jax_compiles)
from test_torch_vlm import _padded, _reference_greedy  # noqa: E402
from test_torch_xlstm import _reference_params  # noqa: E402

TP = 2
QWEN_MOE, MOONSHOT, LLAVA = "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b", "llava-next-34b"
ARCHS = (QWEN_MOE, MOONSHOT, LLAVA)
MOE = (QWEN_MOE, MOONSHOT)
CFGS = {arch: get_config(arch, smoke=True) for arch in ARCHS}
ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8, cuda_graph=False)
MATRIX = [(layout, chunk) for layout in ("contiguous", "paged") for chunk in (0, 8)]
PREEMPT = dict(ENGINE, max_batch=3, seed=3, cache_layout="paged", prefill_chunk=4,
               kv_block_size=8, preemption="recompute", kv_num_blocks=10)
# the JAX engine's schedule for the MoE models (paged, chunks of 8 through
# the unified step, the greedy trace of tests/test_torch_serving_moe.py)
JAX_ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8, cache_layout="paged",
                  prefill_chunk=8, unified_step=True)


def _serve_jobs(arch):
    """The serving runs: the matrix (greedy and sampled requests side by
    side), for a MoE model the greedy trace on the JAX engine's schedule
    and a preempted run; every MoE run records its routing."""
    cfg, moe = CFGS[arch], arch in MOE
    jobs = [runs.Serve(f"{layout}/{chunk}", dict(ENGINE, cache_layout=layout,
                                                 prefill_chunk=chunk),
                       _arrivals(cfg), record=moe)
            for layout, chunk in MATRIX]
    if moe:
        jobs.append(runs.Serve("jax", dict(JAX_ENGINE, cuda_graph=False),
                               [(a.prompt, a.params) for a in _trace(workload, cfg.vocab_size)],
                               record=True))
        jobs.append(runs.Serve("preempted", PREEMPT, _preemption_arrivals(cfg), record=True))
    return jobs


def _logits_jobs(arch):
    """A batch of 2 x 20 prefilled whole (contiguous, paged with shuffled
    tables) and in chunks of 8 (paged), then 3 decode steps, routing
    recorded; llava's after seeded non-zero patches, and once more whole
    without them.  qwen3's prefill drops pairs at tp = 1."""
    cfg = CFGS[arch]
    rng = np.random.default_rng(5)
    nv = cfg.num_vision_tokens
    tokens = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int64)
    steps = rng.integers(0, cfg.vocab_size, (3, 2)).astype(np.int64)
    tables = (rng.permutation(15)[:8] + 1).reshape(2, 4).astype(np.int32)
    vision = rng.standard_normal((2, nv, cfg.d_model)).astype(np.float32) if nv else None
    paged = dict(layout="paged", block_size=8, num_blocks=16)
    max_len = nv + 24
    jobs = [runs.Logits(tokens, steps, max_len, vision=vision, record=True),
            runs.Logits(tokens, steps, max_len, paged, tables, vision=vision, record=True),
            runs.Logits(tokens, steps, max_len, paged, tables, chunk=8, vision=vision,
                        record=True)]
    if nv:
        jobs.append(runs.Logits(tokens, steps, max_len, record=True))
    return jobs


def _trees():
    return {arch: _reference_params(jax_config(arch, smoke=True)) for arch in ARCHS}


def _plan(trees):
    """Per arch: the bridged tree's serving, logits and parameters; then
    seed 0's draw (``shard_model`` at tp > 1) and its parameters."""
    plan = []
    for arch in ARCHS:
        plan.append((runs.Weights(CFGS[arch], tree=trees[arch]),
                     _serve_jobs(arch) + _logits_jobs(arch) + [runs.Params()]))
        plan.append((runs.Weights(CFGS[arch], seed=0), [runs.Params()]))
    return plan


@pytest.fixture(scope="module")
def results():
    """({1: [the plan's results], 2: [rank 0's, rank 1's]}, the trees)."""
    trees = _trees()
    plan = _plan(trees)
    return {1: [runs.run_plan(None, plan, "cpu")],
            TP: spawn_tp(runs.run_plan, TP, "cpu", plan, threads=1)}, trees


def _model(res, tp, arch, rank=0, seeded=False):
    return res[tp][rank][2 * ARCHS.index(arch) + seeded]


def _serve(res, tp, arch, name, rank=0):
    names = [j.name for j in _serve_jobs(arch)]
    return _model(res, tp, arch, rank)[names.index(name)]


def _logits(res, tp, arch, rank=0):
    n = len(_serve_jobs(arch))
    return _model(res, tp, arch, rank)[n:n + len(_logits_jobs(arch))]


def _same_routes(a, b):
    return len(a["ids"]) == len(b["ids"]) and all(
        np.array_equal(x, y) for x, y in zip(a["ids"], b["ids"]))


# -- streams --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("temperature", [0.0, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout,chunk", MATRIX,
                         ids=[f"{lay}-{'chunked' if c else 'whole'}" for lay, c in MATRIX])
def test_tp_family_stream_equivalence(results, arch, temperature, layout, chunk):
    """tp = 2's greedy and sampled streams (served side by side in one run)
    equal tp = 1's byte for byte, on every rank."""
    res, _ = results
    arrivals = _arrivals(CFGS[arch])
    want = _serve(res, 1, arch, f"{layout}/{chunk}")["streams"]
    assert len(want) == len(arrivals)
    picked = [uid for uid in want if arrivals[uid][1].temperature == temperature]
    assert picked
    for rank in range(TP):
        got = _serve(res, TP, arch, f"{layout}/{chunk}", rank)["streams"]
        assert {u: got[u] for u in picked} == {u: want[u] for u in picked}, rank
    # the streams run through the blocks, not one repeated token each
    assert sum(len(set(want[u])) > 1 for u in want) >= 3, want


@pytest.mark.parametrize("arch", MOE)
def test_tp_family_preemption_equivalence(results, arch):
    """An overcommitted pool preempts and recomputes alike at tp = 2: the
    streams and the routing equal tp = 1's run of the same schedule, and
    preemptions fire."""
    res, _ = results
    want = _serve(res, 1, arch, "preempted")
    assert want["preemptions"] > 0, "the pool never ran dry: the test lost its teeth"
    got = _serve(res, TP, arch, "preempted")
    assert got["preemptions"] == want["preemptions"]
    for rank in range(TP):
        got = _serve(res, TP, arch, "preempted", rank)
        assert got["streams"] == want["streams"], rank
        assert _same_routes(got["routes"], want["routes"]), rank


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_family_every_rank_agrees_with_rank_0(results, arch):
    """Each rank's streams, pool accounting and, on every MoE call, routing
    ids equal rank 0's in every run."""
    res, _ = results
    for job in _serve_jobs(arch):
        lead = _serve(res, TP, arch, job.name)
        for rank in range(1, TP):
            other = _serve(res, TP, arch, job.name, rank)
            assert other["streams"] == lead["streams"], (job.name, rank)
            assert other["pool_accounting"] == lead["pool_accounting"]
            if job.record:
                assert lead["routes"]["ids"], job.name
                assert _same_routes(other["routes"], lead["routes"]), (job.name, rank)
    for i, lead in enumerate(_logits(res, TP, arch)):
        for rank in range(1, TP):
            other = _logits(res, TP, arch, rank)[i]
            assert np.array_equal(other["logits"], lead["logits"]), (i, rank)
            assert _same_routes(other, lead), (i, rank)
            assert all(np.array_equal(a, b) for a, b in zip(other["kept"], lead["kept"]))


@pytest.mark.parametrize("arch", MOE)
def test_tp_family_dispatch_matches_tp1(results, arch):
    """Routing over the gathered logits with tp = 1's capacity: every MoE
    call's expert ids and kept pairs equal tp = 1's, and qwen3's prefill
    drops pairs, the same ones at both tp (a capacity taken from the
    rank's E / tp experts would keep them)."""
    res, _ = results
    for want, got in zip(_logits(res, 1, arch), _logits(res, TP, arch)):
        assert _same_routes(got, want)
        assert all(np.array_equal(a, b) for a, b in zip(got["kept"], want["kept"]))
    if arch == QWEN_MOE:
        dropped = sum(int((~k).sum()) for k in _logits(res, 1, arch)[0]["kept"])
        assert dropped > 0, "no pair dropped: the test lost its teeth"


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_family_logits_match_tp1(results, arch):
    """Prefill and decode logits, whole and chunked, contiguous and paged
    (llava's also without patches), within 1e-5 of the largest |logit| of
    tp = 1."""
    res, _ = results
    for i, (want, got) in enumerate(zip(_logits(res, 1, arch), _logits(res, TP, arch))):
        want, got = want["logits"], got["logits"]
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (arch, i)
    if arch == LLAVA:  # the patches move the logits
        with_patches, without = _logits(res, 1, arch)[0], _logits(res, 1, arch)[-1]
        assert np.abs(with_patches["logits"] - without["logits"]).max() > 1e-2


@pytest.mark.parametrize("seeded", [False, True], ids=["bridged", "shard_model"])
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_family_shards_hold_the_tp1_weights(results, arch, seeded):
    """Each rank's parameters are its slices of tp = 1's, by the rule of
    the module that owns each leaf: E / tp experts (``wg``/``wu``/``wd``
    on dim 0) and the router's matching columns, the shared MLP's hidden
    split as a dense MLP's; drawn by ``shard_model`` and bridged alike."""
    res, _ = results
    cfg = CFGS[arch]
    full = _model(res, 1, arch, seeded=seeded)[-1]
    rules = param_rules(Model(cfg, device="meta"))
    for rank in range(TP):
        shard = _model(res, TP, arch, rank, seeded)[-1]
        assert set(shard) == set(full)
        for name, p in shard.items():
            assert np.array_equal(p, local_slice(rules[name], full[name], rank, TP)), name
    if cfg.is_moe:
        E, n = cfg.num_experts, cfg.num_experts // TP
        for rank in range(TP):
            shard = _model(res, TP, arch, rank, seeded)[-1]
            mine = slice(rank * n, (rank + 1) * n)
            assert np.array_equal(shard["layers.0.mlp.router"], full["layers.0.mlp.router"][:, mine])
            for leaf in ("wg", "wu", "wd"):
                assert shard[f"layers.0.mlp.{leaf}"].shape[0] == n
                assert np.array_equal(shard[f"layers.0.mlp.{leaf}"],
                                      full[f"layers.0.mlp.{leaf}"][mine])
            assert full["layers.0.mlp.router"].shape[1] == E
        if cfg.num_shared_experts:
            width = cfg.d_ff * cfg.num_shared_experts
            assert full["layers.0.mlp.shared.wg"].shape == (cfg.d_model, width)
            assert shard["layers.0.mlp.shared.wg"].shape == (cfg.d_model, width // TP)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_family_ledgers(results, arch):
    """Per-device KV bytes sum to tp = 1's, equal shares; each device's
    pool partitions its blocks and is drained; the summary carries the
    per-device keys."""
    res, _ = results
    paged = _serve(res, TP, arch, "paged/8")
    per = paged["kv_bytes_by_device"]
    assert len(per) == TP and len(set(per)) == 1
    assert sum(per) == paged["kv_bytes_peak"] == _serve(res, 1, arch, "paged/8")["kv_bytes_peak"]
    for view in paged["pool_accounting_by_device"]:
        assert view["free"] + view["in_use"] + view["evictable"] == view["allocatable"]
        assert view["in_use"] == 0
    s = paged["summary"]
    assert s["tp_devices"] == TP and s["kv_bytes_peak_per_device"] == per
    assert s["pool_blocks_in_use_per_device"] == [0] * TP
    contiguous = _serve(res, TP, arch, "contiguous/0")
    assert sum(contiguous["kv_bytes_by_device"]) == contiguous["kv_bytes_worst_case"]
    for job in _serve_jobs(arch):  # the step economics of tp = 1
        assert (_serve(res, TP, arch, job.name)["dispatch_samples"]
                == _serve(res, 1, arch, job.name)["dispatch_samples"]), job.name


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_family_streams_equal_the_reference(results, arch):
    """The port at tp = 2 on the reference's tree (each rank its slice):
    a MoE model's greedy streams are the JAX engine's at tp = 1 on the
    same schedule; llava's, in every run of the matrix, are the
    reference's model-level loop over each request's bucketed prompt and
    zero patches, decoding at nv + bucket + i."""
    res, trees = results
    cfg, jcfg = CFGS[arch], jax_config(arch, smoke=True)
    params = jax.tree.map(jnp.asarray, trees[arch])
    if arch in MOE:
        want = _drive(JaxServingEngine(jcfg, params, **JAX_ENGINE),
                      _trace(jax_workload, cfg.vocab_size))
        assert len(want) == 6
        for rank in range(TP):
            assert _serve(res, TP, arch, "jax", rank)["streams"] == want, rank
        return
    jitted = dict(
        prefill=jax.jit(lambda p, b, c, bt: jax_model.prefill(jcfg, p, b, c, block_tables=bt)),
        decode=jax.jit(lambda p, t, pos, c, bt: jax_model.decode_step(
            jcfg, p, t, pos, c, block_tables=bt)))
    bridged = (jcfg, cfg, params, None, jitted)
    eng = ServingEngine(runs.Weights(cfg, tree=trees[arch]).build(None, torch.device("cpu")),
                        device="cpu", **ENGINE)
    arrivals = _arrivals(cfg)
    zeros = np.zeros((1, cfg.num_vision_tokens, cfg.d_model), np.float32)
    want = {}
    for uid, (prompt, p) in enumerate(arrivals):
        if p.temperature == 0.0:
            row = _padded(prompt, eng._bucketed(len(prompt)))[None]
            want[uid] = _reference_greedy(bridged, row, zeros, gen=p.max_new_tokens - 1)[0].tolist()
    for layout, chunk in MATRIX:
        got = _serve(res, TP, arch, f"{layout}/{chunk}")["streams"]
        assert {u: got[u] for u in want} == want, (layout, chunk)


# -- check_tp at the full configs ---------------------------------------------------

@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_check_tp_accepts_the_full_configs(arch, tp):
    """qwen3-moe, moonshot and llava at their full configs shard at tp = 2
    and 4: every rank holds E / tp experts, and routes over all E."""
    cfg = get_config(arch)
    check_tp(cfg, tp)
    shard = Model(cfg, device="meta", mesh=_Mesh(tp))
    assert shard.layers[0].attn.wq.shape[1] == cfg.num_heads // tp
    if cfg.is_moe:
        assert shard.layers[0].mlp.wg.shape[0] == cfg.num_experts // tp
        assert shard.layers[0].mlp.router.shape[1] == cfg.num_experts // tp


# what tp does not divide, replicated: (id, arch, config change, tp, a
# parameter that is then whole on every rank)
UNDIVIDED = [
    ("rglru", "recurrentgemma-2b", {}, 2, "layers.2.attn.wk"),
    ("xlstm", "xlstm-1.3b", {}, 2, "layers.7.cell.r_z"),
    ("mlstm-hybrid", "nemotron-h-8b", {}, 2, "layers.0.cell.b_i"),
    ("heads", "llama3.1-8b", {}, 3, "layers.0.attn.wq"),
    ("kv_heads", "command-r-plus-104b", {}, 16, "layers.0.attn.wk"),
    ("d_ff", "llama3.1-8b", dict(d_ff=14330), 4, "layers.0.mlp.wg"),
    ("vocab", "qwen3-moe-30b-a3b", dict(vocab_size=151937), 2, "embed.table"),
    ("experts", "qwen3-moe-30b-a3b", dict(num_experts=126), 4, "layers.0.mlp.wg"),
    ("shared-width", "moonshot-v1-16b-a3b", dict(d_ff=1407, num_shared_experts=1), 2,
     "layers.0.mlp.shared.wg"),
]


@pytest.mark.parametrize("arch,change,tp,leaf", [r[1:] for r in UNDIVIDED],
                         ids=[r[0] for r in UNDIVIDED])
def test_check_tp_replicates_what_tp_does_not_divide(arch, change, tp, leaf):
    """RG-LRU and xLSTM blocks shard, and a dim tp does not divide (heads,
    KV heads, FFN hidden, vocabulary, experts, a shared MLP's width) is
    whole on every rank, as the reference's ``logical_to_pspec`` drops its
    mapping: ``check_tp`` accepts the config, and each shard's parameter
    and cache shapes on meta are the reference's shards of the same
    config."""
    cfg = get_config(arch).replace(**change)
    check_tp(cfg, tp)
    shard = check_shard_layout(cfg, dataclasses.replace(jax_config(arch), **change), tp)
    whole = dict(Model(cfg, device="meta").named_parameters())[leaf]
    assert dict(shard.named_parameters())[leaf].shape == whole.shape


# (id, config, tp, what the refusal names)
REFUSALS = [
    ("encoder", get_config("seamless-m4t-large-v2"), 2, "an encoder"),
    ("straddle", STRADDLE, 2, "straddle two groups of the 3 KV heads"),
]


@pytest.mark.parametrize("cfg,tp,reason", [r[1:] for r in REFUSALS],
                         ids=[r[0] for r in REFUSALS])
def test_check_tp_refuses_by_name(cfg, tp, reason):
    """What tp cannot serve is refused with its name: an encoder, and query
    heads whose rank straddles two KV groups unevenly."""
    with pytest.raises(ValueError, match=re.escape(reason)):
        check_tp(cfg, tp)


def test_moe_expert_width_never_shards():
    """The experts' hidden is ``expert_ffn``, which never shards: a MoE
    config whose d_ff tp does not divide is served, its experts whole."""
    cfg = get_config(QWEN_MOE).replace(d_ff=770)
    check_tp(cfg, 4)
    shard = Model(cfg, device="meta", mesh=_Mesh(4))
    assert shard.layers[0].mlp.wg.shape == (cfg.num_experts // 4, cfg.d_model, 770)


@pytest.mark.parametrize("module", ["serve", "bench_serve"])
def test_tp_cli_refuses_before_any_rank_starts(module, capsys):
    """``--tp`` on an architecture it cannot shard exits with
    ``check_tp``'s reason before a rank is spawned; the help names what
    it serves and what it refuses."""
    import importlib

    cli = importlib.import_module(f"repro_torch.launch.{module}")
    with pytest.raises(SystemExit) as exc:
        cli.main(["--arch", "seamless-m4t-large-v2", "--smoke", "--device", "cpu", "--tp",
                  "2"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "tp=2 refuses an encoder" in err
    help_text = " ".join(cli.build_parser().format_help().split())
    assert "every decoder" in help_text and "refused" in help_text
