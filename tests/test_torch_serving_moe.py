"""The port's serving engine against the reference's on the MoE family:
qwen3-moe-30b-a3b (routed experts) and moonshot-v1-16b-a3b (routed and
shared experts), smoke configs.

A MoE layer's capacity counts every row of a call (left padding of a
whole-prompt admission, the unified step's pad columns, idle decode
slots), so whether a token is dropped depends on the rows beside it, and
the streams are not scheduling-invariant.  Both engines therefore serve
the same schedule: six greedy requests at t = 0 (prompts 2..48, queue
pressure at two slots), whole-prompt and chunked (chunks of 8 through the
unified step), over a contiguous and a paged cache.  Smoke params (fp32,
the port's init carried into the reference's tree, perturbed as in
``test_torch_xlstm.py`` so that greedy streams are not one repeated
token) are bridged into the port.  Greedy streams, per-step dispatch
counts and the summary's keys must be identical.
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

from test_torch_unified import (_drive, _trace, one_thread,  # noqa: E402,F401 (autouse)
                                shared_jax_compiles)
from test_torch_xlstm import _reference_params  # noqa: E402

ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8)
CHUNK = dict(prefill_chunk=8, unified_step=True)
# (arch, layout, chunked)
RUNS = [(arch, layout, chunked)
        for arch in ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
        for layout in ("contiguous", "paged") for chunked in (False, True)]


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
def test_moe_greedy_streams_match_reference_engine(runs, run):
    jeng, jout, eng, out = runs[run]
    assert len(out) == 6 and out == jout
    assert eng._dispatch_samples == jeng._dispatch_samples
    assert eng.peak_blocks_in_use == jeng.peak_blocks_in_use
    assert eng.blocks_in_use == 0
    # the streams run through the experts, not one repeated token each
    assert sum(len(set(toks)) > 1 for toks in out.values()) >= 4, out


@pytest.mark.parametrize("run", RUNS, ids=_ids)
def test_moe_latency_summary_matches_reference(runs, run):
    jeng, _, eng, _ = runs[run]
    ours, ref = eng.latency_summary(), jeng.latency_summary()
    assert set(ours) == set(ref)
    for key in ("requests", "output_tokens", "truncated", "kv_bytes_peak",
                "kv_bytes_worst_case", "dispatches_per_step_p50",
                "dispatches_per_step_p95", "tokens_per_dispatch"):
        assert ours[key] == ref[key], key
    assert ours["dispatches_per_step_p50"] == 1
