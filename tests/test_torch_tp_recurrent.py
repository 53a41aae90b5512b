"""Tensor-parallel serving of the recurrent families on the CPU, at tp = 2:
recurrentgemma-2b (RG-LRU width and gates over the ranks, its one KV head
replicated and its sliding-window ring L-sharded), xlstm-1.3b (mLSTM
width and heads over the ranks, the sLSTM cell whole on every rank with
its state gathered once a call, its FFN of 85 replicated) and
nemotron-h-8b (mLSTM, FFN and attention blocks), smoke configs in fp32 on
the reference's tree (``test_torch_xlstm._reference_params``: the table
shrunk, the norm scales perturbed, so streams run through the blocks).

One group of 2 gloo ranks (``launch.mesh.spawn_tp``) runs the whole plan
(``sharding.runs.run_plan``); tp = 1 runs in the test's process.  Held:
greedy and sampled streams byte for byte against tp = 1 for {contiguous,
paged} x {whole, chunked}; every rank's streams, logits and cache against
rank 0's; fp32 logits within 1e-5 of the largest; each rank's shard
against tp = 1's weights; each rank's cache leaves at the shard shapes of
the reference's ``cache_shardings``, their values tp = 1's slices, and a
reset row at its initial values (``m`` at -1e30); the ledgers; and the
JAX engine's greedy streams at tp = 1 on the same tree and schedule.

Without a group: ``check_tp`` accepts every decoder of the registry at
tp = 2 and 4, and a shard's parameter and cache shapes on ``meta`` are
the reference's ``param_pspecs`` / ``cache_shardings`` shards on an
``AbstractMesh((tp,), ("tp",))``, undivided dims whole; K4's plain
version with a query-head offset (``q_head0``) reads the right pool head.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.sharding.partition import cache_shardings, param_pspecs  # noqa: E402
from repro.sharding.rules import TP_SERVE_RULES  # noqa: E402
from repro_torch.bridge import reference_by_port_name  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.launch.mesh import spawn_tp  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models.cache import INIT_FILL  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.sharding import runs  # noqa: E402
from repro_torch.sharding.rules import (cache_dim, check_tp, local_slice,  # noqa: E402
                                        param_rules)

from test_torch_tp import SAMPLED, _arrivals  # noqa: E402
from test_torch_unified import _trace, one_thread, shared_jax_compiles  # noqa: E402,F401 (autouse)
from test_torch_xlstm import _reference_params  # noqa: E402

TP = 2
RGEMMA, XLSTM, NEMOTRON = "recurrentgemma-2b", "xlstm-1.3b", "nemotron-h-8b"
ARCHS = (RGEMMA, XLSTM, NEMOTRON)
CFGS = {arch: get_config(arch, smoke=True) for arch in ARCHS}
ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8, cuda_graph=False)
MATRIX = [(layout, chunk) for layout in ("contiguous", "paged") for chunk in (0, 8)]
# the JAX engine's schedule: paged, chunks of 8 through the unified step
JAX_ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8, cache_layout="paged",
                  prefill_chunk=8, unified_step=True)
# the cache job: a 20-token prompt (past recurrentgemma's 16-slot ring) in a
# cache of 24 positions, row 1 reset after the prefill
CACHE_LEN, RESET = 24, (1,)
DECODERS = [a for a in list_archs() if not get_config(a).is_encdec]
# xlstm-1.3b's smoke config with one head: tp = 2 divides its width but not
# its heads, so the mLSTM cell runs whole from its state gathered once a
# call (``C`` and ``n`` split on Dk, ``m`` whole, as ``cache_shardings``)
ONE_HEAD = CFGS[XLSTM].replace(num_heads=1, num_kv_heads=1)


def _serve_jobs(arch):
    """The matrix (greedy and sampled requests side by side), then the
    greedy trace on the JAX engine's schedule."""
    cfg = CFGS[arch]
    jobs = [runs.Serve(f"{layout}/{chunk}", dict(ENGINE, cache_layout=layout,
                                                 prefill_chunk=chunk), _arrivals(cfg))
            for layout, chunk in MATRIX]
    jobs.append(runs.Serve("jax", dict(JAX_ENGINE, cuda_graph=False),
                           [(a.prompt, a.params) for a in _trace(workload, cfg.vocab_size)]))
    return jobs


def _tokens(cfg, batch=2, length=20, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (batch, length))


def _logits_jobs(arch):
    """A batch of 2 x 20 prefilled whole (contiguous, paged with shuffled
    tables) and in chunks of 8 (contiguous and paged), then 3 decode
    steps."""
    cfg = CFGS[arch]
    rng = np.random.default_rng(6)
    tokens = _tokens(cfg)
    steps = rng.integers(0, cfg.vocab_size, (3, 2))
    tables = (rng.permutation(15)[:8] + 1).reshape(2, 4).astype(np.int32)
    paged = dict(layout="paged", block_size=8, num_blocks=16)
    return [runs.Logits(tokens, steps, CACHE_LEN),
            runs.Logits(tokens, steps, CACHE_LEN, chunk=8),
            runs.Logits(tokens, steps, CACHE_LEN, paged, tables),
            runs.Logits(tokens, steps, CACHE_LEN, paged, tables, chunk=8)]


def _plan(trees):
    plan = [(runs.Weights(CFGS[arch], tree=trees[arch]),
             _serve_jobs(arch) + _logits_jobs(arch)
             + [runs.CacheLeaves(_tokens(CFGS[arch]), CACHE_LEN, reset=RESET), runs.Params()])
            for arch in ARCHS]
    plan.append((runs.Weights(ONE_HEAD, seed=0),
                 _logits_jobs(XLSTM)[:2] + [runs.CacheLeaves(_tokens(ONE_HEAD), CACHE_LEN)]))
    return plan


@pytest.fixture(scope="module")
def results():
    """({1: [the plan's results], 2: [rank 0's, rank 1's]}, the trees)."""
    trees = {arch: _reference_params(jax_config(arch, smoke=True)) for arch in ARCHS}
    plan = _plan(trees)
    return {1: [runs.run_plan(None, plan, "cpu")],
            TP: spawn_tp(runs.run_plan, TP, "cpu", plan, threads=1)}, trees


def _model(res, tp, arch, rank=0):
    return res[tp][rank][ARCHS.index(arch)]


def _serve(res, tp, arch, name, rank=0):
    return _model(res, tp, arch, rank)[[j.name for j in _serve_jobs(arch)].index(name)]


def _logits(res, tp, arch, rank=0):
    n = len(_serve_jobs(arch))
    return _model(res, tp, arch, rank)[n:n + len(_logits_jobs(arch))]


def _cache(res, tp, arch, rank=0):
    return _model(res, tp, arch, rank)[-2]


# -- streams --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("temperature", [0.0, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout,chunk", MATRIX,
                         ids=[f"{lay}-{'chunked' if c else 'whole'}" for lay, c in MATRIX])
def test_tp_recurrent_stream_equivalence(results, arch, temperature, layout, chunk):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_recurrent_streams_equal_the_jax_engine(results, arch):
    """The port at tp = 2 on the reference's tree (each rank its slice)
    gives the greedy streams of the JAX engine at tp = 1 on the same tree
    and schedule (paged, chunks of 8 through the unified step)."""
    res, trees = results
    jcfg = jax_config(arch, smoke=True)
    jeng = JaxServingEngine(jcfg, jax.tree.map(jnp.asarray, trees[arch]), **JAX_ENGINE)
    for a in _trace(jax_workload, jcfg.vocab_size):
        jeng.submit(a.prompt, a.params)
    want = {r.uid: list(r.output_tokens) for r in jeng.run()}
    assert len(want) == 6
    for rank in range(TP):
        assert _serve(res, TP, arch, "jax", rank)["streams"] == want, rank
    assert _serve(res, 1, arch, "jax")["streams"] == want


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_recurrent_every_rank_agrees_with_rank_0(results, arch):
    """Each rank's streams and pool accounting in every run, and its
    logits, equal rank 0's bit for bit."""
    res, _ = results
    for job in _serve_jobs(arch):
        lead = _serve(res, TP, arch, job.name)
        for rank in range(1, TP):
            other = _serve(res, TP, arch, job.name, rank)
            assert other["streams"] == lead["streams"], (job.name, rank)
            assert other["pool_accounting"] == lead["pool_accounting"]
    for i, lead in enumerate(_logits(res, TP, arch)):
        for rank in range(1, TP):
            assert np.array_equal(_logits(res, TP, arch, rank)[i], lead), (i, rank)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_recurrent_logits_match_tp1(results, arch):
    """Prefill and decode logits, whole and chunked, contiguous and paged,
    within 1e-5 of the largest |logit| of tp = 1 (fp32; the partial sums
    are added in another order)."""
    res, _ = results
    for i, (want, got) in enumerate(zip(_logits(res, 1, arch), _logits(res, TP, arch))):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (arch, i)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_recurrent_shards_hold_the_tp1_weights(results, arch):
    """Each rank's parameters are its slices of tp = 1's, by the rule of
    the module that owns each leaf: the RG-LRU's width and the gates'
    input rows, the mLSTM's width and block-diagonal rows, the sLSTM's
    FFN where tp divides it; the rest whole."""
    res, _ = results
    cfg = CFGS[arch]
    full = _model(res, 1, arch)[-1]
    rules = param_rules(Model(cfg, device="meta"))
    for rank in range(TP):
        shard = _model(res, TP, arch, rank)[-1]
        assert set(shard) == set(full)
        for name, p in shard.items():
            assert np.array_equal(p, local_slice(rules[name], full[name], rank, TP)), name
    shard = _model(res, TP, arch)[-1]
    kinds = cfg.blocks()
    if "rglru" in kinds:
        i = kinds.index("rglru")
        W, H = cfg.resolved_lru_width, cfg.resolved_rec_heads
        assert shard[f"layers.{i}.rec.gate_a"].shape == (H, W // H // TP, W // H)
        assert shard[f"layers.{i}.rec.lambda"].shape == (W // TP,)
    if "slstm" in kinds:
        i = kinds.index("slstm")
        ff = int(cfg.d_model * cfg.slstm_proj_factor)
        assert ff % TP  # 85: replicated
        assert shard[f"layers.{i}.cell.ff_up"].shape == (cfg.d_model, ff)
        assert shard[f"layers.{i}.cell.r_z"].shape == full[f"layers.{i}.cell.r_z"].shape


def _reference_cache_shards(jcfg, tp, batch, max_len, layout="contiguous", block_size=16,
                            num_blocks=0):
    """The reference's cache leaves' per-device shapes under
    ``cache_shardings`` on a ("tp",) mesh, by the port's layer index: a
    list of {leaf: shape}."""
    cache = jax.eval_shape(lambda: jax_model.init_cache(
        jcfg, batch, max_len, jnp.float32, layout=layout, block_size=block_size,
        num_blocks=num_blocks))
    shardings = cache_shardings(cache, AbstractMesh((tp,), ("tp",)))
    plen = len(jcfg.block_pattern)
    n_groups, _ = jcfg.layer_groups()
    out = [None] * jcfg.num_layers

    def leaves(entry, sh):
        entry, sh = entry.get("self", entry), sh.get("self", sh)
        return {k: sh[k].shard_shape(v.shape) for k, v in entry.items()}

    for i, entry in cache.get("groups", {}).items():
        per = leaves(entry, shardings["groups"][i])
        for g in range(n_groups):
            out[g * plen + int(i)] = {k: s[1:] for k, s in per.items()}
    for i, entry in cache.get("rest", {}).items():
        out[n_groups * plen + int(i)] = leaves(entry, shardings["rest"][i])
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_recurrent_cache_follows_cache_shardings(results, arch):
    """Each rank's cache leaves after a prefill have the shard shapes of the
    reference's ``cache_shardings`` (RG-LRU ``h``/``conv`` on the width,
    the ring's ``k``/``v`` on its L slots, mLSTM ``C``/``n``/``m`` on heads,
    sLSTM ``c``/``n``/``m``/``h`` on heads and ``conv`` on d), hold tp = 1's
    values in their slices (within 1e-5 of the largest), and a reset row
    holds the initial values (positions -1, stabilizers -1e30, the rest
    0) on every rank."""
    res, _ = results
    cfg = CFGS[arch]
    want_shapes = _reference_cache_shards(jax_config(arch, smoke=True), TP, 2, CACHE_LEN)
    full = _cache(res, 1, arch)
    for rank in range(TP):
        got = _cache(res, TP, arch, rank)
        for layer, (entry, ref_shapes, whole) in enumerate(zip(got, want_shapes, full)):
            assert {k: v.shape for k, v in entry.items()} == ref_shapes, (layer, rank)
            for leaf, t in entry.items():
                if t.ndim == 0:
                    assert t == whole[leaf]
                    continue
                dim = cache_dim(leaf, whole[leaf].shape, TP)
                want = whole[leaf]
                if dim is not None:
                    n = want.shape[dim] // TP
                    want = np.take(want, range(rank * n, (rank + 1) * n), axis=dim)
                kept = np.delete(t, RESET, axis=0), np.delete(want, RESET, axis=0)
                scale = max(np.abs(kept[1][np.abs(kept[1]) < 1e29]).max(initial=0.0), 1.0)
                assert np.abs(kept[0] - kept[1]).max() <= 1e-5 * scale, (layer, leaf, rank)
                assert (t[list(RESET)] == INIT_FILL.get(leaf, 0)).all(), (layer, leaf, rank)
    kinds = {k: v for k, v in zip(cfg.blocks(), _cache(res, TP, arch))}
    if "mlstm" in kinds:
        assert kinds["mlstm"]["m"].shape[1] == cfg.resolved_rec_heads // TP
    if "local_attn" in kinds:  # the ring's slots split, its one KV head whole
        assert kinds["local_attn"]["k"].shape[1:3] == (cfg.sliding_window // TP, 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_recurrent_ledgers(results, arch):
    """Per-device KV bytes from each rank's own leaves: full-context
    attention's (nemotron's heads split) sum to tp = 1's in equal shares,
    rings and recurrent states count none, as the reference's ledger; each
    device's pool partitions its blocks and is drained; the summary carries
    the per-device keys; the step economics are tp = 1's."""
    res, _ = results
    paged = _serve(res, TP, arch, "paged/8")
    per = paged["kv_bytes_by_device"]
    want = _serve(res, 1, arch, "paged/8")["kv_bytes_peak"]
    assert len(per) == TP and len(set(per)) == 1 and sum(per) == want
    assert (want > 0) == ("attn" in CFGS[arch].blocks())
    for view in paged["pool_accounting_by_device"]:
        assert view["free"] + view["in_use"] + view["evictable"] == view["allocatable"]
        assert view["in_use"] == 0
    s = paged["summary"]
    assert s["tp_devices"] == TP and s["kv_bytes_peak_per_device"] == per
    for job in _serve_jobs(arch):
        assert (_serve(res, TP, arch, job.name)["dispatch_samples"]
                == _serve(res, 1, arch, job.name)["dispatch_samples"]), job.name


# -- layouts against the reference, without a group ------------------------------------

class _Mesh:
    """A mesh stand-in for building a shard's shapes on meta."""

    def __init__(self, size, rank=0):
        self.size, self.rank, self.device = size, rank, torch.device("meta")


def reference_param_shards(cfg, jcfg, tp):
    """The reference's per-device parameter shapes of ``jcfg`` under
    ``TP_SERVE_RULES`` (``param_pspecs`` on an ``AbstractMesh((tp,),
    ("tp",))``), by the port's parameter names (``cfg``, the port's same
    config, unstacks the groups)."""
    shapes, axes = jax_model.param_axes(jcfg)
    specs = param_pspecs(axes, shapes, AbstractMesh((tp,), ("tp",)), TP_SERVE_RULES)

    def local(spec, s):
        shape = tuple(n // tp if i < len(spec) and spec[i] is not None else n
                      for i, n in enumerate(s.shape))
        return np.broadcast_to(np.empty((), np.int8), shape)

    tree = jax.tree.map(local, specs, shapes, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {name: a.shape for name, a in reference_by_port_name(cfg, tree).items()}


def check_shard_layout(cfg, jcfg, tp, max_len=4096):
    """A rank's parameter and cache shapes (both layouts) on meta equal the
    reference's shards of ``jcfg`` at ``tp``; returns the shard."""
    shard = Model(cfg, device="meta", mesh=_Mesh(tp))
    want = reference_param_shards(cfg, jcfg, tp)
    got = {name: tuple(p.shape) for name, p in shard.named_parameters()}
    assert got == want
    for layout in ("contiguous", "paged"):
        cache = shard.init_cache(2, max_len, layout=layout, num_blocks=33)
        ref = _reference_cache_shards(jcfg, tp, 2, max_len, layout, num_blocks=33)
        assert [{k: tuple(v.shape) for k, v in e.items()} for e in cache] == ref, layout
    return shard


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", DECODERS)
def test_check_tp_accepts_every_decoder(arch, tp):
    """Every decoder of the registry shards at its full config at tp = 2
    and 4; each rank's parameter and cache shapes are the reference's
    ``param_pspecs`` / ``cache_shardings`` shards, a dim tp does not
    divide whole (recurrentgemma-2b's 10 heads and 1 KV head at tp = 4,
    qwen2.5-1.5b's 2 KV heads at tp = 4, xlstm-1.3b's sLSTM FFN of 2730 at
    tp = 4)."""
    cfg = get_config(arch)
    check_tp(cfg, tp)
    check_shard_layout(cfg, jax_config(arch), tp)


def test_undivided_dims_are_whole_at_full_width():
    """The named undivided dims of the full configs are whole on a rank."""
    rg = Model(get_config(RGEMMA), device="meta", mesh=_Mesh(4))
    attn = rg.layers[2].attn
    assert attn.wq.shape[1] == 10 and attn.wk.shape[1] == 1 and not attn.partial
    assert rg.layers[0].rec.in_x.shape[1] == 2560 // 4
    qwen = Model(get_config("qwen2.5-1.5b"), device="meta", mesh=_Mesh(4))
    assert qwen.layers[0].attn.wq.shape[1] == 3 and qwen.layers[0].attn.wk.shape[1] == 2
    assert qwen.layers[0].attn.bk.shape[0] == 2
    xl = Model(get_config(XLSTM), device="meta", mesh=_Mesh(4))
    assert xl.layers[7].cell.ff_up.shape == (2048, 2730) and not xl.layers[7].cell.partial
    assert Model(get_config(XLSTM), device="meta", mesh=_Mesh(2)).layers[7].cell.partial


def test_check_tp_refuses_an_uneven_kv_straddle():
    """12 query heads over 3 KV heads (G = 4): at tp = 2 each rank's 6
    heads read one and a half groups, at tp = 4 rank 1's heads 3..5 two
    groups, both refused by name; tp = 3 splits the KV heads, and tp = 6
    gives each rank 2 heads inside one group."""
    cfg = get_config("llama3.2-1b").replace(num_heads=12, num_kv_heads=3)
    for tp in (2, 4):
        with pytest.raises(ValueError, match="straddle two groups"):
            check_tp(cfg, tp)
    for tp in (3, 6):
        check_tp(cfg, tp)


# -- the L-sharded contiguous cache's writes, without a group -------------------------------

class _Gather(_Mesh):
    """A rank's stand-in mesh whose ``gather`` reads every rank's entry."""

    def __init__(self, size, rank, shards):
        super().__init__(size, rank)
        self.shards = shards

    def gather(self, t, dim):
        return torch.cat([torch.stack([e["k"], e["v"]]) for e in self.shards], dim)


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("window", [0, 8], ids=["full", "ring"])
@pytest.mark.parametrize("tp", [2, 4])
def test_l_sharded_writes_hold_the_whole_cache_slices(tp, window, masked):
    """Each of ``tp`` ranks writes only its slots of an L-sharded entry,
    and the ranks' slices side by side are the whole entry's after every
    write: a prefill, a ragged chunk, a chunk longer than a ring with
    ragged rows, and decode steps with rows masked off; ``read_kv`` gives
    every rank the whole entry back."""
    B, H, D = 3, 1, 4
    L = 8 if window else 32
    g = torch.Generator().manual_seed(tp + window + masked)
    whole = cache_lib.init_attn_cache(B, 32, H, D, torch.float32, "cpu", window=window)
    for leaf in ("k", "v"):  # live entries the masked writes must leave alone
        whole[leaf].copy_(torch.randn(whole[leaf].shape, generator=g))
    n = L // tp
    shards = [{leaf: t[:, r * n:(r + 1) * n].clone() if leaf in ("k", "v") else t.clone()
               for leaf, t in whole.items()} for r in range(tp)]
    meshes = [_Gather(tp, r, shards) for r in range(tp)]

    def write(fn, *args):
        fn(whole, *args)
        for r in range(tp):
            fn(shards[r], *args, meshes[r])
        for leaf in ("k", "v"):
            torch.testing.assert_close(torch.cat([e[leaf] for e in shards], 1), whole[leaf],
                                       rtol=0, atol=0)
        for e in shards:
            assert torch.equal(e["pos"], whole["pos"])

    def kv(c):
        return (torch.randn(B, c, H, D, generator=g), torch.randn(B, c, H, D, generator=g))

    S = 11 if window else 6
    write(cache_lib.fill_attn_cache, *kv(S), torch.arange(S).expand(B, S).int())
    C, start = 5, torch.tensor([S, S + 2, S + 4])
    valid = torch.arange(C)[None] < torch.tensor([5, 3, 0])[:, None] if masked else None
    write(cache_lib.append_attn_cache, *kv(C), (start[:, None] + torch.arange(C)).int(), valid)
    if window:  # a chunk past the ring, ragged rows keep their last valid entries
        C, start = 10, start + 5
        valid = torch.arange(C)[None] < torch.tensor([10, 9, 2])[:, None]
        write(cache_lib.append_attn_cache, *kv(C), (start[:, None] + torch.arange(C)).int(),
              valid if masked else None)
    mask = torch.tensor([True, False, True]) if masked else None
    for step in range(3):
        write(cache_lib.update_attn_cache, *kv(1), (start + C + step).int(), mask)
    for r in range(tp):
        k, v = cache_lib.read_kv(shards[r], slice(None), meshes[r])
        assert torch.equal(k, whole["k"]) and torch.equal(v, whole["v"])


# -- K4's head offset, plain version ------------------------------------------------------

@pytest.mark.parametrize("q_head0", [0, 3, 6, 9])
def test_paged_decode_head_offset_reads_its_group(q_head0):
    """qwen2.5-1.5b's rank at tp = 4: q (8, 1, 3, 128) over a pool (513,
    16, 2, 128) that holds both KV heads; query head h reads pool head
    (q_head0 + h) // 6, as the whole model's head q_head0 + h does."""
    g = torch.Generator().manual_seed(q_head0)
    q = torch.randn(8, 1, 3, 128, generator=g)
    kp, vp = (torch.randn(513, 16, 2, 128, generator=g) for _ in range(2))
    tables = (torch.randperm(512, generator=g)[:8 * 12] + 1).reshape(8, 12).int()
    qp = torch.randint(0, 192, (8, 1), generator=g, dtype=torch.int32)
    kw = dict(block_tables=tables, q_positions=qp, softcap=30.0)
    got = da_ref.paged_decode_attention(q, kp, vp, q_head0=q_head0, group=6, **kw)
    whole = torch.zeros(8, 1, 12, 128)
    whole[:, :, q_head0:q_head0 + 3] = q
    want = da_ref.paged_decode_attention(whole, kp, vp, **kw)[:, :, q_head0:q_head0 + 3]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert da_ref.pool_heads(3, 2, q_head0, 6) == slice(q_head0 // 6, q_head0 // 6 + 1)


def test_paged_decode_head_offset_refuses_a_straddle():
    """Query heads 4..9 in groups of 6 read two pool heads unevenly."""
    with pytest.raises(ValueError, match="groups"):
        da_ref.pool_heads(6, 2, 4, 6)
    assert da_ref.pool_heads(12, 2) == slice(0, 2)


def test_tp_mlstm_cell_whole_where_tp_does_not_divide_its_heads(results):
    """One mLSTM head at tp = 2: the width splits, the cell runs whole from
    its gathered state; logits within 1e-5 of tp = 1's, every rank alike,
    and the cache the reference's layout (``C`` and ``n`` on Dk, ``m``
    whole)."""
    res, _ = results
    want, got = res[1][0][-1], [res[TP][rank][-1] for rank in range(TP)]
    for i in range(2):
        assert np.abs(got[0][i] - want[i]).max() <= 1e-5 * np.abs(want[i]).max(), i
        assert np.array_equal(got[1][i], got[0][i])
    jcfg = dataclasses.replace(jax_config(XLSTM, smoke=True), num_heads=1, num_kv_heads=1)
    shapes = _reference_cache_shards(jcfg, TP, 2, CACHE_LEN)
    for rank in range(TP):
        assert [{k: v.shape for k, v in e.items()} for e in got[rank][-1]] == shapes
    W = int(ONE_HEAD.d_model * ONE_HEAD.mlstm_proj_factor)
    assert got[0][-1][0]["C"].shape == (2, 1, W // TP, W) and got[0][-1][0]["m"].shape == (2, 1)
