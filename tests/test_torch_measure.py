"""The port's measured mode beyond the reference's keys: the cache reset the
replayed decode step relies on, the profiler's decode loop, the energy
windows of ``Elana.measure`` and the readers the reference also has."""

import time

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import energy as jax_energy  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import energy  # noqa: E402
from repro_torch.core.latency import LatencyProfiler  # noqa: E402
from repro_torch.core.profiler import Elana  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models.cache import reset_cache  # noqa: E402
from test_torch_unified import one_thread  # noqa: E402,F401 (autouse)


def _model(arch, seed=0):
    cfg = get_config(arch, smoke=True)
    model = model_lib.init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    # tied, sqrt(d)-scaled embeddings make the smoke models repeat one token;
    # a smaller table and perturbed norm scales and decays let the streams
    # depend on the whole context, as in test_torch_recurrent.py
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        model.embed.table.mul_(0.05)
        for name, p in model.named_parameters():
            if name.endswith(("scale", "lambda")):
                p.add_(2.0 * torch.randn(p.shape, generator=gen))
    return cfg, model


def _tokens(cfg, batch, n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, n))).long()


@pytest.mark.parametrize("arch,layout", [("llama3.2-1b", "contiguous"),
                                         ("llama3.2-1b", "paged"),
                                         ("recurrentgemma-2b", "contiguous"),
                                         ("nemotron-h-8b", "paged"),
                                         ("xlstm-1.3b", "contiguous")])
def test_reset_cache_equals_a_fresh_cache(arch, layout):
    """After a prefill and decode steps wrote every kind of leaf, a reset
    cache equals a fresh ``init_cache`` leaf by leaf, in the same tensors."""
    cfg, model = _model(arch)
    B, S, max_len = 2, 9, 20
    kw = dict(layout="paged", block_size=4, num_blocks=12) if layout == "paged" else {}
    tables = torch.arange(1, 11, dtype=torch.int32).reshape(B, 5) if kw else None
    cache = model.init_cache(B, max_len, **kw)
    logits, _ = model.prefill({"tokens": _tokens(cfg, B, S, 0)}, cache, block_tables=tables)
    for i in range(3):
        logits, _ = model.decode_step(logits.argmax(-1, keepdim=True), S + i, cache,
                                      block_tables=tables)
    fresh = model.init_cache(B, max_len, **kw)
    assert any(not torch.equal(a[k], b[k]) for a, b in zip(cache, fresh) for k in a)
    ptrs = [t.data_ptr() for entry in cache for t in entry.values()]
    assert reset_cache(cache) is cache
    assert [t.data_ptr() for entry in cache for t in entry.values()] == ptrs
    for got, want in zip(cache, fresh):
        assert got.keys() == want.keys()
        for leaf in want:
            assert got[leaf].dtype == want[leaf].dtype and torch.equal(got[leaf], want[leaf]), leaf


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b", "nemotron-h-8b",
                                  "xlstm-1.3b"])
def test_profiler_greedy_loop_reuses_one_reset_cache(arch):
    """The decode loop TTLT times runs on one cache per (batch, max_len),
    reset before each prompt: its streams equal a fresh cache's, prompt
    after prompt."""
    cfg, model = _model(arch)
    lp = LatencyProfiler(cfg, model, device="cpu")
    assert not lp.cuda_graph
    a, b = _tokens(cfg, 2, 7, 1), _tokens(cfg, 2, 7, 2)
    first = lp.greedy(a, 6)
    lp.greedy(b, 6)
    again = lp.greedy(a, 6)
    assert len(lp.runners) == 1 and first.shape == (2, 7)
    cache = model.init_cache(2, 7 + 6 + 1)
    logits, _ = model.prefill({"tokens": a}, cache)
    want = [logits.argmax(-1, keepdim=True)]
    for i in range(6):
        logits, _ = model.decode_step(want[-1], 7 + i, cache)
        want.append(logits.argmax(-1, keepdim=True))
    want = torch.cat(want, dim=1)
    assert torch.equal(first, want) and torch.equal(again, want)
    assert len(set(want[0].tolist())) > 1  # the stream is not one repeated token


def test_profiler_greedy_loop_matches_reference():
    """The loop's stream on bridged reference weights equals the
    reference's jitted prefill + decode steps (fp32, CPU)."""
    jcfg, cfg = jax_config("llama3.2-1b", smoke=True), get_config("llama3.2-1b", smoke=True)
    params, _ = jax_model.init(jcfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, params)
    model = params_from_jax(cfg, tree, device="cpu")
    tokens = _tokens(cfg, 2, 10, 3)
    got = LatencyProfiler(cfg, model, device="cpu").greedy(tokens, 8).numpy()

    jcache = jax_model.init_cache(jcfg, 2, 10 + 8 + 1, jnp.float32)
    logits, jcache = jax_model.prefill(jcfg, params, {"tokens": jnp.asarray(tokens.numpy())},
                                       jcache)
    want = [np.asarray(jnp.argmax(logits, -1))]
    for i in range(8):
        tok = jnp.asarray(want[-1])[:, None].astype(jnp.int32)
        logits, jcache = jax_model.decode_step(jcfg, params, tok, jnp.asarray(10 + i, jnp.int32),
                                               jcache)
        want.append(np.asarray(jnp.argmax(logits, -1)))
    np.testing.assert_array_equal(got, np.stack(want, axis=1))


@pytest.mark.parametrize("batch", [1, 2])
def test_measure_energy_windows_are_the_timed_samples(batch, monkeypatch):
    """With a constant 42 W reader, each joule figure is 42 W times its
    metric's recorded timed window over the units the window holds; every
    window lies inside its monitor's and after that metric's warm-up."""
    stats = {}
    for name in ("ttft", "tpot", "ttlt"):
        orig = getattr(LatencyProfiler, name)

        def record(self, *a, _orig=orig, _name=name, **kw):
            t_call = time.perf_counter()
            st = _orig(self, *a, **kw)
            stats.setdefault(_name, (st, t_call))  # ttlt's warm-up calls ttft again
            return st

        monkeypatch.setattr(LatencyProfiler, name, record)
    iters, gen = 3, 5
    out = Elana("llama3.2-1b", smoke=True, device="cpu").measure(
        batch=batch, prompt_len=6, gen_len=gen, iters=iters,
        power_reader=energy.SyntheticReader(lambda t: 42.0))
    counts = {"ttft": iters * batch, "tpot": gen * batch, "ttlt": 2 * batch}
    keys = {"ttft": "j_per_prompt", "tpot": "j_per_token", "ttlt": "j_per_request"}
    for name, count in counts.items():
        st, t_call = stats[name]
        t0, t1 = st.window
        assert t_call < t0 < t1
        assert t1 - t0 >= sum(st.samples_s)
        assert out[keys[name]] == pytest.approx(42.0 * (t1 - t0) / count, rel=1e-9)
    # the warm-up prefills and the decode runner's warm-up are outside
    assert stats["ttft"][0].compile_s > 0 and stats["tpot"][0].compile_s > 0


def test_latency_windows_cover_only_timed_samples():
    cfg, model = _model("qwen1.5-0.5b")
    lp = LatencyProfiler(cfg, model, device="cpu")
    for st in (lp.ttft(1, 6, iters=3, warmup=2), lp.tpot(1, 6, gen_len=4, warmup=2),
               lp.ttlt(1, 6, 4, iters=2)):
        t0, t1 = st.window
        assert 0 < t1 - t0 >= sum(st.samples_s)
        # samples only, with no more than the host's bookkeeping between them
        assert t1 - t0 < sum(st.samples_s) + 0.5


@pytest.mark.parametrize("util", [0.0, 0.37, 1.0, 1.7, -0.2])
def test_model_reader_matches_reference(util):
    ours = energy.ModelReader(30.0, 700.0, lambda: util, n_devices=2)
    ref = jax_energy.ModelReader(30.0, 700.0, lambda: util, n_devices=2)
    assert list(ours.read_watts()) == list(ref.read_watts())
    assert list(energy.ModelReader(22.0, 300.0).read_watts()) == \
        list(jax_energy.ModelReader(22.0, 300.0).read_watts())


def test_proc_stat_reader_matches_reference(monkeypatch):
    """The same /proc/stat readings give the same watts."""
    stats = [(100.0, 400.0), (130.0, 500.0), (130.0, 500.0), (180.0, 520.0), (250.0, 600.0)]
    real = energy.ProcStatReader()
    w = real.read_watts()
    assert len(w) == 1 and 10.0 <= w[0] <= 65.0
    for cls in (energy.ProcStatReader, jax_energy.ProcStatReader):
        it = iter(stats)
        monkeypatch.setattr(cls, "_read_stat", staticmethod(lambda it=it: next(it)))
    ours = energy.ProcStatReader(10.0, 65.0)
    ref = jax_energy.ProcStatReader(10.0, 65.0)
    for _ in range(len(stats) - 1):
        assert list(ours.read_watts()) == list(ref.read_watts())


def test_measure_energy_integrates_the_call():
    reader = energy.SyntheticReader(lambda t: 50.0)
    res = energy.measure_energy(lambda: time.sleep(0.03), reader, interval_s=0.01)
    assert res.duration_s >= 0.03
    assert res.joules == pytest.approx(50.0 * res.duration_s, rel=1e-6)


def test_elana_custom_builder_hook():
    """The paper's ``_build_model_and_tokenizer`` extension point, the twin
    of the reference's ``test_system.py::test_elana_custom_builder_hook``:
    ``builder()`` returns (config, model); the size report counts that
    model's parameters and ``measure`` runs it."""
    def builder():
        cfg = get_config("tinyllama-1.1b", smoke=True)
        return cfg, model_lib.init(cfg, torch.Generator().manual_seed(7), device="cpu")

    e = Elana(builder=builder, device="cpu")
    assert e.size_report().param_count == sum(p.numel() for p in e.model.parameters())
    m = e.measure(batch=1, prompt_len=8, gen_len=2, iters=1)
    assert m["ttft_ms"] > 0


def test_elana_takes_a_config_or_refuses_without_one():
    """``config=`` draws the model from the seed, as an arch does; a
    builder's model must live on the profiler's device."""
    cfg = get_config("qwen1.5-0.5b", smoke=True).replace(name="custom", num_layers=2)
    e = Elana(config=cfg, device="cpu", seed=3)
    assert e.cfg is cfg and len(e.model.layers) == 2
    assert e.size_report().param_count == sum(p.numel() for p in e.model.parameters())
    want = model_lib.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(e.model.parameters(), want.parameters()))
    assert e.measure(batch=1, prompt_len=6, gen_len=2, iters=1)["tpot_ms"] > 0
    with pytest.raises(ValueError):
        Elana(device="cpu")
    with pytest.raises(ValueError):
        Elana(builder=lambda: (cfg, model_lib.Model(cfg, device="meta")), device="cpu")
