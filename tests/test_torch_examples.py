"""The port's examples (``examples/torch_*.py``) run in-process on the
CPU (``--device cpu``: the reduced configs where weights are drawn), each
printing what its reference example prints: the size and cache reports
equal to the reference's text, the estimator lines and the trace, the
measured metrics, the served requests and their summary."""

import importlib.util
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import cache as jax_cache_prof  # noqa: E402
from repro.core import size as jax_size  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reports(arch, smoke, batch, seq_len, unit):
    cfg = jax_config(arch, smoke=smoke)
    return (jax_size.profile_size(cfg).fmt(),
            jax_cache_prof.profile_cache(cfg, batch, seq_len).fmt(unit))


def test_quickstart_prints_the_reference_reports(capsys, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    _example("torch_quickstart").main(["--device", "cpu"])
    out = capsys.readouterr().out
    size, cache = _reports("llama3.1-8b", False, 128, 2048, "GB")
    assert out.startswith(f"{size}\n\n{cache}\n\n")
    assert "A6000 bsize=1 L=512+512:" in out and "H100 x8 bsize=8:" in out
    assert json.loads((tmp_path / "quickstart_trace.json").read_text())["traceEvents"]
    assert "measured (reduced qwen1.5-0.5b on cpu): TTFT" in out


@pytest.mark.parametrize("arch,builder", [("qwen1.5-0.5b", False),
                                          ("qwen3-moe-30b-a3b", True),
                                          ("moonshot-v1-16b-a3b", False)])
def test_profile_model_prints_the_reference_reports(capsys, monkeypatch, tmp_path, arch,
                                                    builder):
    """Option A (the registry) or B (``Elana(builder=)``): the same reports;
    a MoE arch prints the active-parameter line."""
    monkeypatch.chdir(tmp_path)
    _example("torch_profile_model").main(["--arch", arch, "--device", "cpu"]
                                         + (["--builder"] if builder else []))
    out = capsys.readouterr().out
    size, cache = _reports(arch, True, 2, 256, "MB")
    assert out.startswith(f"== size ==\n{size}\n\n== cache ==\n{cache}\n")
    assert ("active params/token" in out) == ("moe" in arch or "moonshot" in arch)
    metrics = json.loads(out.split("ProcStatReader) ==\n")[1].split("\n\n")[0])
    assert set(metrics) == {"ttft_ms", "j_per_prompt", "tpot_ms", "j_per_token", "ttlt_ms",
                            "j_per_request"}
    assert all(np.isfinite(v) and v > 0 for v in metrics.values())
    for hw in ("a6000", "jetson-agx-thor", "jetson-orin-nano", "h100"):
        assert f"\n{hw:18s} TTFT" in out
    trace = tmp_path / f"trace_{arch.replace('.', '_')}.json"
    assert json.loads(trace.read_text())["traceEvents"]


def test_serve_batch_serves_the_reference_requests(capsys):
    """The reference example's ten requests (the same numpy draws): every
    one finishes with its budget of new tokens."""
    _example("torch_serve_batch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    rng = np.random.default_rng(0)
    budgets = []
    for _ in range(10):
        rng.integers(0, 256, int(rng.integers(4, 40)))
        budgets.append(int(rng.integers(8, 24)))
    assert "finished 10 requests" in out
    summary = json.loads(out.split("ELANA request metrics:\n")[1])
    assert summary["requests"] == 10 and summary["output_tokens"] == sum(budgets)
    assert summary["dispatches_per_step_p50"] == 1


def _reference_train_keys():
    """The keys the reference's ``launch.train.train`` returns, read from
    its source (the reference driver fails under JAX 0.9.0: ROADMAP
    "Reference caveat")."""
    import inspect
    import re

    from repro.launch import train as jax_train

    src = inspect.getsource(jax_train.train)
    return (set(re.findall(r'"(\w+)": ', src[src.index("out = {"):]))
            | set(re.findall(r'out\["(\w+)"\] =', src)))


def test_train_100m_tiny_trains_and_checkpoints(capsys, tmp_path):
    """``--tiny --device cpu``: 30 steps of the reduced llama-100m through
    the port's driver; the loss falls, the printed keys are the reference
    driver's (``--energy`` on), the last step is checkpointed."""
    ck = tmp_path / "ck"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # small ops: workers would oversubscribe the cores
    try:
        out = _example("torch_train_100m").main(["--tiny", "--device", "cpu",
                                                 "--ckpt-dir", str(ck)])
    finally:
        torch.set_num_threads(threads)
    printed = capsys.readouterr().out
    assert set(out) == _reference_train_keys() == set(
        json.loads(printed[printed.index("{"):printed.index("}") + 1]))
    assert out["steps"] == 30 and out["loss_last"] < out["loss_first"]
    assert (ck / "LATEST").read_text() == "step_00000030"
    assert (ck / "step_00000030" / "arrays.npz").exists()


def test_examples_default_to_the_gpu():
    for name in ("torch_quickstart", "torch_profile_model", "torch_serve_batch",
                 "torch_train_100m"):
        mod = _example(name)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no GPU"):
                mod.main([])
