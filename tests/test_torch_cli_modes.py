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
from repro_torch.configs import NOT_PORTED, PAPER  # noqa: E402
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
    """Default: the paper's models; the one not ported is named after the
    tables, which equal the reference's over the ported ones."""
    assert PAPER == JAX_PAPER
    ported = [a for a in PAPER if a not in NOT_PORTED]
    assert ported != PAPER
    ours = _run(capsys, cli.main, ["report", "--hardware", "a6000", "--device", "cpu"])
    ref = _run(capsys, jax_cli.main, ["report", "--hardware", "a6000",
                                      "--archs", ",".join(ported)])
    assert ours == ref + "not ported yet, left out: nemotron-h-8b (hybrid)\n"
    few = _run(capsys, cli.main, ["report", "--hardware", "a6000", "--device", "cpu",
                                  "--archs", "nemotron-h-8b,llama3.2-1b"])
    assert "llama3.2-1b" in few and few.endswith("left out: nemotron-h-8b (hybrid)\n")


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
