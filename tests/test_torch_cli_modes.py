"""The port's ``estimate``, ``trace`` and ``report`` subcommands print the
reference CLI's text (``--device cpu``: shapes on the meta device, no
weights), and ``energy --device cpu`` reads the host CPU's power."""

import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import cli as jax_cli  # noqa: E402
from repro.configs import PAPER as JAX_PAPER  # noqa: E402
from repro_torch import cli  # noqa: E402
from repro_torch.configs import PAPER  # noqa: E402
from repro_torch.core import energy  # noqa: E402


def _run(capsys, main, argv):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("arch,extra", [
    ("llama3.1-8b", []),
    ("recurrentgemma-2b", ["--batch", "4", "--prompt", "1024", "--gen", "128"]),
    ("command-r-plus-104b", ["--n-devices", "4", "--mode", "naive_pp"]),
    ("qwen2.5-7b", ["--n-devices", "2", "--mode", "tp", "--smoke"]),
])
def test_estimate_prints_the_reference_text(capsys, arch, extra):
    argv = ["estimate", "--arch", arch, "--hardware", "a6000", *extra]
    ours = _run(capsys, cli.main, argv + ["--device", "cpu"])
    assert ours == _run(capsys, jax_cli.main, argv)
    assert "TPOT(ms)" in ours and "bound=memory" in ours


@pytest.mark.parametrize("arch,phase", [("llama3.1-8b", "decode"),
                                        ("recurrentgemma-2b", "prefill")])
def test_trace_prints_and_writes_the_reference_timeline(capsys, tmp_path, arch, phase):
    path = str(tmp_path / "trace.json")
    argv = ["trace", "--arch", arch, "--hardware", "a6000", "--phase", phase,
            "--seq-len", "512", "--out", path]
    ours = _run(capsys, cli.main, argv + ["--device", "cpu"])
    with open(path) as f:
        ours_file = f.read()
    assert ours == _run(capsys, jax_cli.main, argv)
    with open(path) as f:
        assert ours_file == f.read()
    assert json.loads(ours_file)["traceEvents"]


def test_report_prints_the_reference_tables_for_the_ported_paper_models(capsys):
    """Default: the paper's models, every one ported, so the tables equal
    the reference's over all of them; so do the tables over the last two
    families ported, with nothing left out."""
    assert PAPER == JAX_PAPER
    ours = _run(capsys, cli.main, ["report", "--hardware", "a6000", "--device", "cpu"])
    ref = _run(capsys, jax_cli.main, ["report", "--hardware", "a6000"])
    assert ours == ref and "nemotron-h-8b" in ours and "left out" not in ours
    archs = "llava-next-34b,seamless-m4t-large-v2,llama3.2-1b"
    few = _run(capsys, cli.main, ["report", "--hardware", "a6000", "--device", "cpu",
                                  "--archs", archs])
    assert few == _run(capsys, jax_cli.main, ["report", "--hardware", "a6000",
                                              "--archs", archs])
    assert "llava-next-34b" in few and "seamless-m4t-large-v2" in few
    assert "left out" not in few


def test_new_subcommands_default_to_the_h100():
    ap = cli.build_parser()
    for argv in (["estimate", "--arch", "llama3.1-8b"], ["trace", "--arch", "llama3.1-8b"],
                 ["report"]):
        args = ap.parse_args(argv)
        assert args.hardware == "h100" and args.device == "cuda"
    with pytest.raises(KeyError):
        cli.main(["estimate", "--arch", "llama3.1-8b", "--device", "cpu",
                  "--hardware", "tpu-v5e"])


def test_estimate_on_the_h100_by_default(capsys):
    out = _run(capsys, cli.main, ["estimate", "--arch", "llama3.1-8b", "--device", "cpu",
                                  "--prompt", "512", "--gen", "32"])
    assert "h100 x1" in out and "bsize=1, L=512+32" in out


def test_energy_on_the_cpu_reads_proc_stat(capsys, monkeypatch):
    reads = []
    orig = energy.ProcStatReader.read_watts

    def counted(self):
        reads.append(1)
        return orig(self)

    monkeypatch.setattr(energy.ProcStatReader, "read_watts", counted)
    out = json.loads(_run(capsys, cli.main, [
        "energy", "--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--prompt", "8",
        "--gen", "4", "--iters", "2"]))
    assert reads
    assert {"j_per_prompt", "j_per_token", "j_per_request", "ttft_ms", "tpot_ms",
            "ttlt_ms"} <= set(out)
    assert all(v > 0 for v in out.values())


@pytest.mark.parametrize("hardware", ["a6000", "cpu"])
def test_energy_hardware_picks_the_reference_reader(capsys, monkeypatch, hardware):
    """``energy --hardware <platform>`` reads what the reference CLI reads:
    ``ModelReader`` over the platform's idle and TDP watts, or, for
    ``cpu``, ``ProcStatReader``; the port's measure then integrates it."""
    from repro.core import energy as jax_energy
    from repro.core.profiler import Elana as JaxElana

    seen = {}

    def record(self, *a, **kw):  # the reference's run stops at its reader
        seen["ref"] = self
        seen["reader"] = kw["power_reader"]
        return {}

    monkeypatch.setattr(JaxElana, "measure", record)
    argv = ["energy", "--arch", "qwen1.5-0.5b", "--smoke", "--hardware", hardware,
            "--prompt", "8", "--gen", "4", "--iters", "2"]
    _run(capsys, jax_cli.main, argv)
    ref = seen["reader"]
    reads = []
    for cls in (energy.ModelReader, energy.ProcStatReader):
        orig = cls.read_watts
        monkeypatch.setattr(cls, "read_watts",
                            lambda self, orig=orig: reads.append(self) or orig(self))
    out = json.loads(_run(capsys, cli.main, argv + ["--device", "cpu"]))
    assert reads and {type(r).__name__ for r in reads} == {type(ref).__name__}
    assert type(ref) is {"a6000": jax_energy.ModelReader, "cpu": jax_energy.ProcStatReader}[
        hardware]
    assert (reads[0].idle, reads[0].tdp) == (ref.idle, ref.tdp)
    assert all(v > 0 for v in out.values())


def test_latency_takes_hardware_and_energy_defaults_by_device():
    args = cli.build_parser().parse_args(["latency", "--arch", "llama3.1-8b",
                                          "--hardware", "a6000"])
    assert args.hardware == "a6000"
    assert isinstance(cli.power_reader(None, "cpu"), energy.ProcStatReader)
    assert isinstance(cli.power_reader("h100", "cuda"), energy.ModelReader)
    with pytest.raises(KeyError):
        cli.power_reader("tpu-v5e", "cpu")
