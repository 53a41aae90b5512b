"""The port's serving engine against the reference's on the RG-LRU hybrid
(recurrentgemma-2b), whose slots carry more than K/V: a sliding-window
ring per local-attention layer and an RG-LRU state per recurrent layer.

The reference's smoke params (fp32; the embedding table shrunk and the
norm scales and ``lambda`` perturbed as in ``test_torch_recurrent.py``, so
that greedy streams are not one repeated token) are bridged into the
port, and both engines serve the same Poisson trace under queue pressure
on the CPU, for both layouts and a pool small enough to backpressure.
Greedy streams, per-step dispatch counts and the keys of
``latency_summary`` must be identical: an admitted row that did not start
from a fresh state, or a state that an idle slot's decode advanced, would
change the streams.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCH = "recurrentgemma-2b"
ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8)
LAYOUTS = [("contiguous", 0), ("paged", 0), ("paged", 6)]


def _params():
    jcfg = jax_config(ARCH, smoke=True)
    params, _ = jax_model.init(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        arr = np.asarray(leaf)
        key = str(getattr(path[-1], "key", ""))
        if key == "table":
            return arr * np.float32(0.05)
        if key in ("scale", "lambda"):
            arr = arr + 2.0 * rng.standard_normal(arr.shape).astype(arr.dtype)
        return arr

    return jcfg, jax.tree_util.tree_map_with_path(perturb, params)


def _traces(vocab):
    """Six greedy requests at t = 0: prompts 2..48 (lognormal, mean 16),
    2..8 new tokens; prompts past the 16-token window wrap the rings."""
    kw = dict(arrival_rate=0.0, num_requests=6, temperature=0.0, top_k=8, seed=2)
    dists = dict(prompt_len=("lognormal", 16.0, 2, 48), output_len=("uniform", 0.0, 2, 9))
    specs = []
    for lib in (jax_workload, workload):
        specs.append(lib.poisson_trace(lib.WorkloadSpec(**kw, **{
            k: lib.LengthDist(kind=d[0], mean=d[1], low=d[2], high=d[3])
            for k, d in dists.items()}), vocab))
    return specs


def _drive(engine, arrivals):
    for a in arrivals:
        engine.submit(a.prompt, a.params)
    return {r.uid: list(r.output_tokens) for r in engine.run()}


@pytest.fixture(scope="module")
def runs():
    jcfg, tree = _params()
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    model = params_from_jax(get_config(ARCH, smoke=True), tree, device="cpu")
    jtrace, trace = _traces(jcfg.vocab_size)
    assert max(len(a.prompt) for a in trace) > jcfg.sliding_window
    out = {}
    for layout, blocks in LAYOUTS:
        kw = dict(ENGINE, cache_layout=layout, kv_num_blocks=blocks)
        jeng = JaxServingEngine(jcfg, jparams, **kw)
        jout = _drive(jeng, jtrace)
        eng = ServingEngine(model, **kw, device="cpu")
        out[layout, blocks] = (jeng, jout, eng, _drive(eng, trace))
    return out


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}-{x[1]}")
def test_hybrid_greedy_streams_match_reference_engine(runs, layout):
    jeng, jout, eng, out = runs[layout]
    assert len(out) == 6 and out == jout
    assert eng._dispatch_samples == jeng._dispatch_samples
    assert eng.peak_blocks_in_use == jeng.peak_blocks_in_use
    assert eng.blocks_in_use == 0
    # the streams run through the blocks, not one repeated token each
    assert sum(len(set(toks)) > 1 for toks in out.values()) >= 4, out


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}-{x[1]}")
def test_hybrid_latency_summary_matches_reference(runs, layout):
    jeng, _, eng, _ = runs[layout]
    ours, ref = eng.latency_summary(), jeng.latency_summary()
    assert set(ours) == set(ref)
    for key in ("requests", "output_tokens", "truncated", "kv_bytes_peak",
                "kv_bytes_worst_case", "dispatches_per_step_p50",
                "dispatches_per_step_p95", "tokens_per_dispatch"):
        assert ours[key] == ref[key], key
    assert ours["dispatches_per_step_p50"] == 1


def test_admission_gives_each_row_a_fresh_state(runs):
    """After a drain, a request served alone emits what it emitted in the
    busy run: nothing of an earlier slot occupant leaked into its state."""
    _, _, eng, out = runs["paged", 0]
    _, trace = _traces(eng.cfg.vocab_size)
    for uid in (0, 5):
        eng.submit(trace[uid].prompt, trace[uid].params)
        eng.run()
        assert eng.finished[-1].output_tokens == out[uid]
