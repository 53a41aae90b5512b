"""The port's traffic and open-loop driver against the reference's.

``replay_trace``, ``interference_trace`` and ``bursty_trace`` must draw
the same arrivals as the reference's for the same arguments (numpy only
on both sides).  ``OpenLoopDriver`` must submit no request before its
time, and on a virtual clock (advanced only by sleeps and by a fixed
amount per engine step, so both drivers see the same schedule) the port's
engine must emit the JAX engine's greedy streams on bridged parameters,
both layouts.  The serve CLI runs with ``--arrival-rate``, ``--replay``
and ``--bursty`` and rejects a bad ``--replay`` item with the
reference's message.
"""

import dataclasses
import json
import time

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import model as jax_model  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

ARCH = "tinyllama-1.1b"
TINY = dict(name="srv", num_layers=2, d_model=32, num_heads=2, num_kv_heads=2, d_ff=64,
            vocab_size=128, dtype="float32", param_dtype="float32")
ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8)
SCHEDULE = [(0.0, 5, 6), (0.0, 12, 4), (0.015, 7, 5), (0.03, 20, 3), (0.05, 3, 7),
            (0.12, 9, 4)]


@pytest.fixture(scope="module")
def tiny():
    """The reference server suite's tiny model (2 layers, d = 32), its
    parameters bridged into the port."""
    jcfg = JaxModelConfig(**TINY).validate()
    params, _ = jax_model.init(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(ModelConfig(**TINY).validate(),
                            jax.tree.map(np.asarray, params), "cpu")
    return jcfg, params, model


TRACES = [
    ("replay", dict(schedule=SCHEDULE, vocab_size=128)),
    ("replay", dict(schedule=[(0.5, 30, 2), (0.1, 1, 9)], vocab_size=32000, seed=7,
                    temperature=0.8, top_k=20, eos_token=2)),
    ("interference", dict(vocab_size=128)),
    ("interference", dict(vocab_size=32000, n_victims=5, victim_plen=16, victim_new=64,
                          long_plen=300, long_new=8, t_long=0.25, seed=3, temperature=0.7)),
    ("bursty", dict(vocab_size=128)),
    ("bursty", dict(vocab_size=32000, bursts=3, burst_size=5, gap_s=0.1, prompt_len=33,
                    max_new=12, seed=11, temperature=0.8, top_k=20, eos_token=7)),
]


@pytest.mark.parametrize("kind, kw", TRACES,
                         ids=[f"{k}-{i}" for i, (k, _) in enumerate(TRACES)])
def test_traces_match_reference(kind, kw):
    ours = getattr(workload, f"{kind}_trace")(**kw)
    ref = getattr(jax_workload, f"{kind}_trace")(**kw)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        assert a.time_s == b.time_s
        assert a.prompt.dtype == b.prompt.dtype and np.array_equal(a.prompt, b.prompt)
        assert dataclasses.asdict(a.params) == dataclasses.asdict(b.params)


def test_open_loop_driver_submits_no_request_early(tiny):
    _, _, model = tiny
    eng = ServingEngine(model, **ENGINE, device="cpu")
    arrivals = workload.replay_trace(SCHEDULE, 128)
    submitted, steps = [], []  # (time, steps run before it) per submission
    submit, step = eng.submit, eng.step

    def stamped(prompt, params=None):
        submitted.append((time.perf_counter(), len(steps)))
        return submit(prompt, params)

    def counted():
        steps.append(1)
        return step()

    eng.submit, eng.step = stamped, counted
    driver = workload.OpenLoopDriver(eng, arrivals)
    finished = driver.run()
    assert len(finished) == len(arrivals) and not eng.busy
    assert [len(r.output_tokens) for r in sorted(finished, key=lambda r: r.uid)] == \
        [a.params.max_new_tokens for a in arrivals]
    for (t, _), a in zip(submitted, arrivals):
        assert t - driver.t0 >= a.time_s
    # the requests of one instant go in together, before any step
    assert submitted[0][1] == submitted[1][1] == 0 < submitted[-1][1]


class _VirtualClock:
    """``time`` as the driver sees it: moved only by its sleeps and by
    ``STEP_S`` per engine step."""
    STEP_S = 0.01

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def sleep(self, dt):
        self.now += dt


def _open_loop(lib, engine, arrivals, monkeypatch):
    clock = _VirtualClock()
    monkeypatch.setattr(lib, "time", clock)
    step = engine.step

    def timed_step():
        clock.now += clock.STEP_S
        return step()

    engine.step = timed_step
    finished = lib.OpenLoopDriver(engine, arrivals).run()
    return {r.uid: list(r.output_tokens) for r in finished}


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_open_loop_streams_match_reference_engine(tiny, layout, monkeypatch):
    jcfg, params, model = tiny
    jeng = JaxServingEngine(jcfg, params, **ENGINE, cache_layout=layout)
    jout = _open_loop(jax_workload, jeng, jax_workload.replay_trace(SCHEDULE, 128), monkeypatch)
    eng = ServingEngine(model, **ENGINE, cache_layout=layout, device="cpu")
    out = _open_loop(workload, eng, workload.replay_trace(SCHEDULE, 128), monkeypatch)
    assert out == jout and len(out) == len(SCHEDULE)
    # the same admissions and steps, in the same order
    assert eng._dispatch_samples == jeng._dispatch_samples
    assert len(eng._dispatch_samples) > len(SCHEDULE)


def _serve(capsys, *flags):
    assert serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--max-len", "64",
                           "--max-new", "3", "--power-reader", "synthetic", *flags]) == 0
    out = capsys.readouterr().out
    summary, end = json.JSONDecoder().raw_decode(out)
    return summary, out[end:]


@pytest.mark.parametrize("flags, n", [
    (("--arrival-rate", "40", "--requests", "3"), 3),
    (("--replay", "0:8:3,0.05:12:2,0.05:5:4"), 3),
    (("--bursty", "--requests", "5", "--burst-size", "3", "--burst-gap", "0.05",
      "--prompt-len-mean", "10"), 5),
], ids=["arrival-rate", "replay", "bursty"])
def test_serve_cli_open_loop(capsys, flags, n):
    summary, tables = _serve(capsys, *flags)
    assert summary["requests"] == n and summary["device"] == "cpu"
    assert summary["joules_total"] > 0
    for heading in ("## Latency percentiles", "## Step economics",
                    "## Per-request (energy attributed per token window)"):
        assert heading in tables
    assert tables.count("\n| ") >= n + 3 + 9  # header rows + requests + metrics
    if flags[0] == "--replay":
        assert summary["output_tokens"] == 3 + 2 + 4


def test_serve_cli_rejects_a_bad_replay_item(capsys):
    from repro.launch.serve import _parse_replay as jax_parse_replay

    with pytest.raises(ValueError) as ref:
        jax_parse_replay("0:8:3,0.1:x:4")
    with pytest.raises(SystemExit) as exit_:
        serve_cli.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--replay", "0:8:3,0.1:x:4"])
    assert exit_.value.code == 2
    assert str(ref.value) in capsys.readouterr().err
    assert serve_cli._parse_replay("0:8:3,0.5:2:1") == jax_parse_replay("0:8:3,0.5:2:1")
