"""The port's serving engine against the reference's on the xLSTM family:
nemotron-h-8b (mLSTM cells beside attention layers) and xlstm-1.3b (mLSTM
and sLSTM cells, no attention at all), whose slots carry a matrix memory
``C``, normalizers and stabilizers besides K/V.

Smoke params (fp32, in the reference's tree and perturbed as in
``test_torch_xlstm.py`` so that greedy streams are not one repeated
token) are bridged into the port, and both engines serve the same six
greedy requests at t = 0 (prompts 2..48, queue pressure at two slots),
whole-prompt and chunked (chunks of 8 through the unified step).  Greedy
streams, per-step dispatch counts and the summary's keys must be
identical: a row admitted with a zeroed stabilizer (``m = 0`` where a
fresh state holds -1e30), or a state an idle slot's decode advanced,
would change the streams.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

from test_torch_unified import _trace, one_thread, shared_jax_compiles  # noqa: E402,F401 (autouse)
from test_torch_xlstm import _reference_params  # noqa: E402

ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8)
CHUNK = dict(prefill_chunk=8, unified_step=True)
# (arch, layout, chunked)
RUNS = [(arch, layout, chunked)
        for arch, layouts in (("nemotron-h-8b", ("contiguous", "paged")),
                              ("xlstm-1.3b", ("contiguous", "paged")))
        for layout in layouts for chunked in (False, True)]


def _drive(engine, arrivals):
    for a in arrivals:
        engine.submit(a.prompt, a.params)
    return {r.uid: list(r.output_tokens) for r in engine.run()}


@pytest.fixture(scope="module")
def runs():
    out, models = {}, {}
    for arch, layout, chunked in RUNS:
        if arch not in models:
            jcfg = jax_config(arch, smoke=True)
            tree = _reference_params(jcfg)
            models[arch] = (jcfg, jax.tree.map(jax.numpy.asarray, tree),
                            params_from_jax(get_config(arch, smoke=True), tree, device="cpu"))
        jcfg, jparams, model = models[arch]
        kw = dict(ENGINE, cache_layout=layout, **(CHUNK if chunked else {}))
        jeng = JaxServingEngine(jcfg, jparams, **kw)
        jout = _drive(jeng, _trace(jax_workload, jcfg.vocab_size))
        eng = ServingEngine(model, **kw, device="cpu")
        out[arch, layout, chunked] = (jeng, jout, eng, _drive(eng, _trace(workload,
                                                                          jcfg.vocab_size)))
    return out


def _ids(run):
    arch, layout, chunked = run
    return f"{arch}-{layout}-{'chunked' if chunked else 'whole'}"


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_xlstm_greedy_streams_match_reference_engine(runs, run):
    jeng, jout, eng, out = runs[run]
    assert len(out) == 6 and out == jout
    assert eng._dispatch_samples == jeng._dispatch_samples
    assert eng.peak_blocks_in_use == jeng.peak_blocks_in_use
    assert eng.blocks_in_use == 0
    # the streams run through the cells, not one repeated token each
    assert sum(len(set(toks)) > 1 for toks in out.values()) >= 4, out


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_xlstm_latency_summary_matches_reference(runs, run):
    jeng, _, eng, _ = runs[run]
    ours, ref = eng.latency_summary(), jeng.latency_summary()
    assert set(ours) == set(ref)
    for key in ("requests", "output_tokens", "truncated", "kv_bytes_peak",
                "kv_bytes_worst_case", "dispatches_per_step_p50",
                "dispatches_per_step_p95", "tokens_per_dispatch"):
        assert ours[key] == ref[key], key
    assert ours["dispatches_per_step_p50"] == 1


@pytest.mark.parametrize("arch", ["nemotron-h-8b", "xlstm-1.3b"])
def test_chunked_admission_resets_a_reused_slot_to_initial_values(runs, arch):
    """After the chunked run drained, a request served alone through the
    same engine (its slot reused, reset by ``reset_rows``) emits what it
    emitted in the busy run and what the whole-prompt engine emitted."""
    _, _, eng, out = runs[arch, "contiguous", True]
    _, whole = runs[arch, "contiguous", False][2:]
    trace = _trace(workload, eng.cfg.vocab_size)
    for uid in (0, 5):
        eng.submit(trace[uid].prompt, trace[uid].params)
        eng.run()
        assert eng.finished[-1].output_tokens == out[uid] == whole[uid]
