"""The port's serving engine against the reference's.

The reference's ``tinyllama-1.1b`` smoke params (fp32) are bridged into
the port, and both engines serve the same Poisson trace under queue
pressure (``max_batch=2``, 6 requests) on the CPU.  Greedy streams must be
byte-identical for both layouts and a pool small enough to backpressure;
so must the per-step dispatch counts, the pool occupancy samples and the
keys of ``latency_summary``.  The port's sampled draws come from its own
counter-based hash (the reference's threefry cannot be matched): they
must not depend on scheduling, and they must follow the softmax of the
masked logits (chi-square).
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.energy import PowerMonitor as JaxPowerMonitor  # noqa: E402
from repro.core.energy import SyntheticReader as JaxSyntheticReader  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.energy import PowerMonitor, SyntheticReader  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "tinyllama-1.1b"
ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8)
# (layout, pool blocks): 0 is the worst case; 6 blocks of 16 hold one
# worst-case request plus a little, so admission backpressures
LAYOUTS = [("contiguous", 0), ("paged", 0), ("paged", 6)]


def _spec(temperature, seed=2, n=6):
    """The reference's paged-suite workload (tests/test_paged.py)."""
    kw = dict(arrival_rate=0.0, num_requests=n, temperature=temperature, top_k=8,
              seed=seed)
    dists = dict(prompt_len=("lognormal", 16.0, 2, 48), output_len=("uniform", 0.0, 2, 9))
    jax_spec = jax_workload.WorkloadSpec(**kw, **{
        k: jax_workload.LengthDist(kind=d[0], mean=d[1], low=d[2], high=d[3])
        for k, d in dists.items()})
    spec = workload.WorkloadSpec(**kw, **{
        k: workload.LengthDist(kind=d[0], mean=d[1], low=d[2], high=d[3])
        for k, d in dists.items()})
    return jax_spec, spec


def _drive(engine, arrivals, monitor=None):
    for a in arrivals:
        engine.submit(a.prompt, a.params)
    if monitor is None:
        finished = engine.run()
    else:
        engine.attach_monitor(monitor)
        with monitor:
            finished = engine.run()
    return {r.uid: list(r.output_tokens) for r in finished}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config(ARCH, smoke=True)
    params, _ = jax_model.init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, params_from_jax(get_config(ARCH, smoke=True), tree, "cpu")


@pytest.fixture(scope="module")
def greedy_runs(models):
    """Both engines on the greedy trace, per layout, with a monitor."""
    jcfg, params, model = models
    jax_spec, spec = _spec(temperature=0.0)
    runs = {}
    for layout, blocks in LAYOUTS:
        kw = dict(ENGINE, cache_layout=layout, kv_num_blocks=blocks)
        jeng = JaxServingEngine(jcfg, params, **kw)
        jout = _drive(jeng, jax_workload.poisson_trace(jax_spec, jcfg.vocab_size),
                      JaxPowerMonitor(JaxSyntheticReader(lambda t: 50.0), interval_s=0.02))
        eng = ServingEngine(model, **kw, device="cpu")
        out = _drive(eng, workload.poisson_trace(spec, jcfg.vocab_size),
                     PowerMonitor(SyntheticReader(lambda t: 50.0), interval_s=0.02))
        runs[layout, blocks] = (jeng, jout, eng, out)
    return runs


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}-{x[1]}")
def test_greedy_streams_match_reference_engine(greedy_runs, layout):
    jeng, jout, eng, out = greedy_runs[layout]
    assert len(out) == 6 and out == jout
    # the same admissions, batches and decode steps in the same order
    assert eng._dispatch_samples == jeng._dispatch_samples
    assert eng._occ_samples == pytest.approx(jeng._occ_samples)
    assert eng.peak_blocks_in_use == jeng.peak_blocks_in_use
    assert eng.blocks_in_use == 0
    if layout[0] == "paged":  # every table row back at the garbage block
        assert not eng._state["block_tables"].any()
        assert eng._pool.free_stack == jeng._pool.free_stack


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda x: f"{x[0]}-{x[1]}")
def test_latency_summary_keys_match_reference(greedy_runs, layout):
    jeng, _, eng, _ = greedy_runs[layout]
    ours, ref = eng.latency_summary(), jeng.latency_summary()
    assert set(ours) == set(ref)
    for key in ("requests", "output_tokens", "truncated", "kv_bytes_peak",
                "kv_bytes_worst_case", "dispatches_per_step_p50",
                "dispatches_per_step_p95", "tokens_per_dispatch"):
        assert ours[key] == ref[key], key
    if layout[0] == "paged":
        assert ours["preemptions"] == ours["recompute_tokens"] == 0
    assert ours["dispatches_per_step_p50"] == 1


def test_energy_attribution_sums_to_monitor_total(greedy_runs):
    for layout in LAYOUTS:
        eng = greedy_runs[layout][2]
        total = sum(r.joules for r in eng.finished)
        assert all(r.joules > 0.0 for r in eng.finished)
        assert total == pytest.approx(eng.attributed_joules, rel=1e-9)
        # up to the tail between the engine's last flush and the monitor's exit
        assert total == pytest.approx(eng.monitor.result().joules, rel=0.1)
        summary = eng.latency_summary()
        assert summary["joules_total"] == pytest.approx(total)
        assert summary["power_samples_per_sec"] > 0 and summary["power_reads_dropped"] == 0


def test_sampled_streams_are_scheduling_invariant(models):
    """The same sampled trace through 1, 2 and 4 slots and both layouts:
    byte-identical streams (each draw depends on its request and token
    index only)."""
    _, _, model = models
    _, spec = _spec(temperature=0.7, seed=4, n=8)
    arrivals = workload.poisson_trace(spec, model.cfg.vocab_size)
    outs = {}
    for layout in ("contiguous", "paged"):
        for mb in (1, 2, 4):
            eng = ServingEngine(model, **dict(ENGINE, max_batch=mb), cache_layout=layout,
                                seed=11, device="cpu")
            outs[layout, mb] = _drive(eng, arrivals)
    ref = outs["contiguous", 1]
    assert len(ref) == 8
    for key, out in outs.items():
        assert out == ref, key
    # and they are draws: another engine seed gives other streams
    eng = ServingEngine(model, **ENGINE, seed=12, device="cpu")
    assert _drive(eng, arrivals) != ref


@pytest.mark.parametrize("temperature,top_k", [(0.8, 5), (1.3, 0), (0.5, 64)])
def test_sample_slots_keyed_follows_masked_softmax(temperature, top_k):
    """Draws 0..N-1 of one stream against the softmax of the temperature-
    scaled, top-k-masked logits: a chi-square test at p = 0.001, and no
    token outside the top-k set."""
    V, N = 24, 24000
    rng = np.random.default_rng(int(temperature * 10) + top_k)
    row = torch.from_numpy(rng.standard_normal(V).astype(np.float32) * 2.0)
    logits = row.expand(N, V)
    got = sampling.sample_slots_keyed(
        logits, torch.full((N,), temperature), torch.full((N,), top_k, dtype=torch.int32),
        torch.full((N,), sampling.request_key(3, 7), dtype=torch.int64),
        torch.arange(N, dtype=torch.int64), k_max=64)
    scaled = row.double() / temperature
    if 0 < top_k < V:
        scaled[scaled < torch.topk(scaled, top_k).values[-1]] = -torch.inf
    probs = torch.softmax(scaled, 0).numpy()
    counts = np.bincount(got.numpy(), minlength=V)
    assert counts[probs == 0].sum() == 0
    keep = probs * N >= 5  # the chi-square approximation needs >= 5 expected
    expected = probs[keep] * N
    observed = counts[keep]
    rest_e, rest_o = N - expected.sum(), N - observed.sum()
    chi2 = ((observed - expected) ** 2 / expected).sum()
    df = keep.sum() - 1
    if rest_e >= 5:
        chi2 += (rest_o - rest_e) ** 2 / rest_e
        df += 1
    # 0.999 quantiles of chi-square for the df that occur here
    crit = {4: 18.47, 5: 20.52, 6: 22.46, 7: 24.32, 8: 26.12, 9: 27.88, 10: 29.59,
            11: 31.26, 12: 32.91, 13: 34.53, 14: 36.12, 15: 37.70, 16: 39.25,
            17: 40.79, 18: 42.31, 19: 43.82, 20: 45.31, 21: 46.80, 22: 48.27, 23: 49.73}
    assert chi2 < crit[df], (chi2, df)


def test_sample_greedy_rows_and_stream_purity():
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    temps = torch.tensor([0.0, 0.9, 0.0, 0.9])
    top_k = torch.tensor([0, 10, 3, 10], dtype=torch.int32)
    keys = torch.tensor([sampling.request_key(0, u) for u in (0, 1, 2, 1)])
    counts = torch.tensor([5, 3, 0, 3])
    tok = sampling.sample_slots_keyed(logits, temps, top_k, keys, counts)
    assert tok[0] == logits[0].argmax() and tok[2] == logits[2].argmax()
    # rows 1 and 3: the same logits would give the same draw; their own
    # logits give each the draw of (key, count) alone
    again = sampling.sample_slots_keyed(logits[[3, 1]], temps[[3, 1]], top_k[[3, 1]],
                                        keys[[3, 1]], counts[[3, 1]])
    assert torch.equal(again, tok[[3, 1]])
    params = sampling.SamplingParams(temperature=0.9, top_k=10)
    assert sampling.sample(logits[1:2], params, sampling.request_key(0, 1), 3)[0] == tok[1]
    assert sampling.sample(logits, sampling.SamplingParams(), 0).tolist() == \
        logits.argmax(-1).tolist()


@pytest.mark.parametrize("dist", [("uniform", 24.0, 6, 48), ("lognormal", 256.0, 32, 768),
                                  ("fixed", 40.0, 1, 4096)])
def test_poisson_trace_matches_reference(dist):
    kw = dict(arrival_rate=3.0, num_requests=9, temperature=0.7, top_k=50, seed=5)
    out = dict(kind="uniform", mean=0.0, low=16, high=64)
    ours = workload.poisson_trace(workload.WorkloadSpec(
        **kw, prompt_len=workload.LengthDist(*dist), output_len=workload.LengthDist(**out)),
        32000)
    ref = jax_workload.poisson_trace(jax_workload.WorkloadSpec(
        **kw, prompt_len=jax_workload.LengthDist(*dist),
        output_len=jax_workload.LengthDist(**out)), 32000)
    assert len(ours) == len(ref) == 9
    for a, b in zip(ours, ref):
        assert a.time_s == b.time_s
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert dataclass_fields(a.params) == dataclass_fields(b.params)


def dataclass_fields(params):
    return (params.temperature, params.top_k, params.eos_token, params.max_new_tokens)


def test_truncation_keeps_the_tail_and_stream_hook_order(models):
    _, _, model = models
    rng = np.random.default_rng(5)
    long = rng.integers(0, model.cfg.vocab_size, 40).astype(np.int32)
    eng = ServingEngine(model, max_batch=1, max_len=32, prompt_bucket=8, device="cpu")
    events = []
    eng.stream_hook = lambda uid, toks, fin: events.append((uid, list(toks), fin))
    eng.submit(long, sampling.SamplingParams(max_new_tokens=3))
    finished = eng.run()
    assert finished[0].truncated and eng.latency_summary()["truncated"] == 1
    tail = ServingEngine(model, max_batch=1, max_len=32, prompt_bucket=8, device="cpu")
    tail.submit(long[-31:], sampling.SamplingParams(max_new_tokens=3))
    assert tail.run()[0].output_tokens == finished[0].output_tokens
    streamed = [t for _, toks, _ in events for t in toks]
    assert streamed == finished[0].output_tokens and events[-1] == (0, [], True)


def test_engine_rejects_bad_settings(models):
    _, _, model = models
    with pytest.raises(ValueError, match="kv-num-blocks"):
        ServingEngine(model, **ENGINE, cache_layout="paged", kv_num_blocks=4, device="cpu")
    with pytest.raises(ValueError, match="cache_layout"):
        ServingEngine(model, **ENGINE, cache_layout="ring", device="cpu")
    with pytest.raises(ValueError, match="model is on"):
        ServingEngine(model, **ENGINE, device="meta")


def test_serve_cli_runs_on_the_cpu(capsys):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", "3",
                           "--max-new", "4", "--max-len", "128", "--cache-layout", "paged",
                           "--power-reader", "synthetic"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["requests"] == 3 and out["output_tokens"] == 12
    assert out["device"] == "cpu" and out["joules_total"] > 0


def test_serve_cli_help_runs_without_a_gpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--help"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    for flag in ("--cache-layout", "--kv-block-size", "--kv-num-blocks", "--power-reader",
                 "--cuda-graph", "--prompt-len-dist"):
        assert flag in proc.stdout
