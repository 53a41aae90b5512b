"""The port's estimator mode, estimated timeline, chrome trace and report
rendering against the reference's, on every hardware spec both registries
hold, and the port's ``h100`` spec."""

import dataclasses
import functools
import json
import types

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import estimator as jax_est  # noqa: E402
from repro.core import hardware as jax_hw  # noqa: E402
from repro.core import report as jax_report  # noqa: E402
from repro.core import size as jax_size  # noqa: E402
from repro.core import trace as jax_trace  # noqa: E402
from repro.core.profiler import Elana as JaxElana  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core import estimator, hardware, report, trace  # noqa: E402
from repro_torch.core.profiler import Elana  # noqa: E402
from repro_torch.core.size import profile_size  # noqa: E402

SHARED = ["a6000", "jetson-orin-nano", "jetson-agx-thor", "cpu"]
ARCHS = sorted(list_archs())


@pytest.fixture(scope="module", autouse=True)
def _reference_size_once_per_config():
    """The reference traces a model's init for every size profile, and its
    estimator asks for one per call: profile each config once (the
    function is pure, so the results are the same)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_size, "profile_size", functools.lru_cache(maxsize=None)(
            jax_size.profile_size))
        yield


def test_registries_share_the_papers_platforms():
    """The port keeps the paper's platforms and the CPU rig unchanged,
    drops the TPU entry and adds the H100."""
    assert set(hardware.REGISTRY) == set(SHARED) | {"h100"}
    assert set(jax_hw.REGISTRY) == set(SHARED) | {"tpu-v5e"}
    for name in SHARED:
        assert dataclasses.asdict(hardware.get_hardware(name)) == \
            dataclasses.asdict(jax_hw.get_hardware(name))
        for u in (-1.0, 0.0, 0.4, 1.0, 2.0):
            assert hardware.get_hardware(name).power_at(u) == jax_hw.get_hardware(name).power_at(u)
    with pytest.raises(KeyError, match="h100"):
        hardware.get_hardware("tpu-v5e")


def test_h100_is_the_published_card():
    hw = hardware.get_hardware("h100")
    assert (hw.kind, hw.peak_flops_bf16, hw.hbm_bw, hw.tdp_watts, hw.mem_bytes) == \
        ("gpu", 989e12, 3.35e12, 700.0, 80 * 1000**3)
    assert (hw.link_bw, hw.num_links) == (25e9, 18)
    assert 0 < hw.idle_watts < hw.tdp_watts
    assert 0 < hw.eta_compute <= 1 and 0 < hw.eta_memory <= 1


def _assert_rows_equal(ours, ref):
    assert ours.keys() == ref.keys()
    for k, v in ref.items():
        if isinstance(v, float):
            assert ours[k] == pytest.approx(v, rel=1e-12), k
        else:
            assert ours[k] == v, k


@pytest.mark.parametrize("hw", SHARED)
@pytest.mark.parametrize("arch", ARCHS)
def test_estimate_matches_reference(arch, hw):
    """``estimate_workload(...).row()`` and each phase's bound equal the
    reference's, in every mode at 1, 2 and 4 devices."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    for mode in ("tp", "dp", "naive_pp"):
        for n in (1, 2, 4):
            kw = dict(hardware=hw, n_devices=n, mode=mode, batch=2, prompt_len=384,
                      gen_len=96)
            ours, ref = estimator.estimate_workload(cfg, **kw), jax_est.estimate_workload(jcfg, **kw)
            _assert_rows_equal(ours.row(), ref.row())
            for phase in ("ttft", "tpot", "ttlt"):
                a, b = getattr(ours, phase), getattr(ref, phase)
                assert a.bound == b.bound
                _assert_rows_equal(dataclasses.asdict(a), dataclasses.asdict(b))


@pytest.mark.parametrize("arch", ARCHS)
def test_h100_tpot_reads_the_weights_at_least_once(arch):
    cfg = get_config(arch)
    est = Elana(arch, device="cpu").estimate(batch=1, prompt_len=512, gen_len=32)
    assert est.hardware == "h100"
    assert est.tpot.latency_s >= profile_size(cfg).param_bytes / 3.35e12
    assert est.tpot.bound == "memory"
    assert est.ttlt.latency_s == pytest.approx(est.ttft.latency_s + 31 * est.tpot.latency_s)


@pytest.mark.parametrize("phase", ["decode", "prefill"])
@pytest.mark.parametrize("hw", SHARED)
@pytest.mark.parametrize("arch", ARCHS)
def test_timeline_and_chrome_trace_match_reference(arch, hw, phase, tmp_path):
    kw = dict(hardware=hw, phase=phase, batch=2, seq_len=700)
    ours = trace.estimated_timeline(get_config(arch), **kw)
    ref = jax_trace.estimated_timeline(jax_config(arch), **kw)
    assert [dataclasses.asdict(e) for e in ours] == [dataclasses.asdict(e) for e in ref]
    assert trace.timeline_summary(ours) == jax_trace.timeline_summary(ref)
    meta = {"arch": arch, "hardware": hw, "phase": phase}
    trace.to_chrome_trace(ours, str(tmp_path / "ours.json"), meta=meta)
    jax_trace.to_chrome_trace(ref, str(tmp_path / "ref.json"), meta=meta)
    assert (tmp_path / "ours.json").read_text() == (tmp_path / "ref.json").read_text()


def test_elana_trace_writes_the_h100_timeline(tmp_path):
    path = tmp_path / "t.json"
    summary = Elana("recurrentgemma-2b", device="cpu").trace(str(path), seq_len=512)
    data = json.loads(path.read_text())
    assert data["metadata"]["hardware"] == "h100"
    assert len(data["traceEvents"]) > 26 and summary["total_s"] > 0
    assert summary["scan_s"] > 0  # the RG-LRU scans are on the timeline


def test_capture_torch_trace_writes_perfetto_json(tmp_path):
    path = tmp_path / "torch_trace.json"
    x = torch.randn(64, 64)
    out = trace.capture_torch_trace(str(path), lambda a: (a @ a).sum(), x)
    assert torch.equal(out, (x @ x).sum())
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def _summary():
    return {"ttft_ms": 12.3456, "ttft_p50_ms": 11.0, "ttft_p95_ms": 20.5, "ttft_p99_ms": 21.0,
            "tpot_ms": 8.25, "tpot_p50_ms": 8.0, "tpot_p95_ms": 9.0, "tpot_p99_ms": 9.5,
            "steady_requests": 12, "achieved_qps": 3.333333, "joules_total": 1234.5678,
            "tokens_per_sec": 150.123, "steps_per_sec": 40.5, "dispatches_per_step_p50": 1.0,
            "dispatches_per_step_p95": 2.0, "joules_per_device": [1.234, 5.6789],
            "kv_bytes_peak_per_device": [1024, 2048]}


def test_report_renders_like_the_reference():
    """The same rows give the same markdown and CSV, for every table-row function."""
    ests = [(estimator.estimate_workload(get_config(a), hardware="a6000"),
             jax_est.estimate_workload(jax_config(a), hardware="a6000"))
            for a in ("llama3.1-8b", "recurrentgemma-2b")]
    elanas = [(Elana(a, device="cpu"), JaxElana(a)) for a in ("llama3.2-1b", "qwen2.5-1.5b")]
    caches = [{e.cfg.name: {(b, L): e.cache_report(b, L) for b, L in ((1, 1024), (128, 2048))}
               for e in side} for side in zip(*elanas)]
    reqs = [types.SimpleNamespace(uid=i, prompt=[0] * (5 + i), output_tokens=[1] * (3 * i),
                                  ttft_s=0.01234 * i, ttlt_s=0.1 + i, joules=0.5 * i,
                                  truncated=i == 2) for i in range(3)]
    pairs = [
        (report.table3_rows([o for o, _ in ests]), jax_report.table3_rows([r for _, r in ests])),
        (report.table2_rows([o.size_report() for o, _ in elanas], caches[0]),
         jax_report.table2_rows([r.size_report() for _, r in elanas], caches[1])),
        (report.serving_summary_rows(_summary()), jax_report.serving_summary_rows(_summary())),
        (report.serving_client_rows(_summary()), jax_report.serving_client_rows(_summary())),
        (report.serving_throughput_rows(_summary()),
         jax_report.serving_throughput_rows(_summary())),
        (report.serving_request_rows(reqs), jax_report.serving_request_rows(reqs)),
    ]
    for ours, ref in pairs:
        assert ours == ref
        assert report.to_markdown(ours) == jax_report.to_markdown(ref)
        assert report.to_markdown(ours, floatfmt=".4f") == jax_report.to_markdown(ref, floatfmt=".4f")
        assert report.to_csv(ours) == jax_report.to_csv(ref)
    assert report.to_markdown([]) == jax_report.to_markdown([])
    assert report.to_csv([]) == jax_report.to_csv([])
