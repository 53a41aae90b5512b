"""The port's ELANA core against the reference: size and cache reports byte
for byte at full width, ``measure``'s keys, the energy integral, units and
the command line."""

import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.core import energy as jax_energy  # noqa: E402
from repro.core import units as jax_units  # noqa: E402
from repro.core.profiler import Elana as JaxElana  # noqa: E402
from repro_torch.configs import list_archs  # noqa: E402
from repro_torch.core import energy, units  # noqa: E402
from repro_torch.core.latency import LatencyProfiler  # noqa: E402
from repro_torch.core.profiler import Elana  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference_field_by_field(smoke):
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config

    for arch in list_archs():
        assert dataclasses.asdict(get_config(arch, smoke)) == \
            dataclasses.asdict(jax_config(arch, smoke)), arch


@pytest.mark.parametrize("arch", sorted(list_archs()))
def test_size_and_cache_reports_match_reference(arch):
    """Full width, from shapes alone: every field equal, byte for byte."""
    ours, ref = Elana(arch, device="cpu"), JaxElana(arch)
    assert dataclasses.asdict(ours.size_report()) == dataclasses.asdict(ref.size_report())
    for batch, seq_len in ((1, 1024), (128, 2048)):
        assert dataclasses.asdict(ours.cache_report(batch, seq_len)) == \
            dataclasses.asdict(ref.cache_report(batch, seq_len))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "command-r-plus-104b"])
def test_allocated_cache_bytes_match_reference(arch):
    """The cache a smoke model allocates, counted leaf by leaf."""
    from repro.configs import get_config as jax_config
    from repro.models import cache as jax_cache
    from repro.models import model as jax_model
    from repro_torch.configs import get_config
    from repro_torch.models.cache import cache_bytes

    cfg = get_config(arch, smoke=True)
    model = model_lib.Model(cfg, device="cpu")
    ref = jax_model.init_cache(jax_config(arch, smoke=True), 3, 40, np.float32)
    assert cache_bytes(model.init_cache(3, 40)) == jax_cache.cache_bytes(ref)


def test_llama31_8b_reads_16_06_gb():
    size = Elana("llama3.1-8b", device="cpu").size_report()
    assert "16.06 GB" in size.fmt()
    assert size.param_count == 8_030_261_248


@pytest.mark.parametrize("with_energy", [False, True])
def test_measure_returns_the_reference_keys(with_energy):
    kw = dict(batch=1, prompt_len=8, gen_len=4, iters=2)
    reader = (lambda: energy.SyntheticReader(lambda t: 42.0)) if with_energy else (lambda: None)
    jreader = jax_energy.SyntheticReader(lambda t: 42.0) if with_energy else None
    ours = Elana("qwen1.5-0.5b", smoke=True, device="cpu").measure(power_reader=reader(), **kw)
    ref = JaxElana("qwen1.5-0.5b", smoke=True).measure(power_reader=jreader, **kw)
    assert set(ours) == set(ref)
    assert all(np.isfinite(v) and v > 0 for v in ours.values())


def test_latency_profiler_checks_its_device():
    cfg = Elana("llama3.2-1b", smoke=True, device="cpu").cfg
    model = model_lib.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    lp = LatencyProfiler(cfg, model, device="cpu")
    stats = lp.tpot(1, 6, gen_len=3, warmup=1)
    assert len(stats.samples_s) == 3 and stats.compile_s > 0
    with pytest.raises(ValueError):
        LatencyProfiler(cfg, model, device="meta")


@pytest.mark.parametrize("seed", range(3))
def test_energy_integral_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ts = np.cumsum(rng.uniform(0.01, 0.2, 40))
    samples = [(float(t), list(rng.uniform(50, 700, 2))) for t in ts]
    for t0, t1 in ((ts[0] - 0.5, ts[-1] + 0.5), (ts[3], ts[17]), (ts[5] + 0.01, ts[6])):
        assert energy.integrate_joules(samples, t0, t1) == \
            jax_energy.integrate_joules(samples, t0, t1)


def test_power_monitor_with_synthetic_reader():
    with energy.PowerMonitor(energy.SyntheticReader(lambda t: 100.0), interval_s=0.01) as mon:
        torch.ones(64, 64) @ torch.ones(64, 64)
        import time
        time.sleep(0.05)
    r = mon.result()
    assert r.joules == pytest.approx(100.0 * r.duration_s, rel=1e-6)
    assert r.samples_per_sec > 0 and r.dropped_reads == 0


def test_nvml_reader_raises_or_reads_watts():
    """NVML is there only beside a GPU; without it the reader raises, never
    reporting 0 W."""
    try:
        reader = energy.NvmlReader()
    except RuntimeError:
        assert not torch.cuda.is_available()
        return
    try:
        assert all(w > 0 for w in reader.read_watts())
    finally:
        reader.close()


@pytest.mark.parametrize("n", [0, 999, 16_060_000_000, 5 * 1024 ** 3])
def test_units_match_reference(n):
    for unit in ("B", "MB", "GB", "GiB"):
        assert units.fmt_bytes(n, unit) == jax_units.fmt_bytes(n, unit)
    assert units.fmt_auto(n) == jax_units.fmt_auto(n)


def test_cli_help_runs_without_a_gpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for args in ([], ["latency"], ["energy"]):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.cli", *args, "--help"],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout


def test_cli_size_cache_archs(capsys):
    from repro_torch.cli import main

    assert main(["size", "--arch", "llama3.1-8b", "--device", "cpu"]) == 0
    assert "16.06 GB" in capsys.readouterr().out
    assert main(["cache", "--arch", "llama3.1-8b", "--device", "cpu",
                 "--batch", "128", "--seq-len", "2048"]) == 0
    assert "kv 34.36 GB" in capsys.readouterr().out
    assert main(["archs"]) == 0
    out = capsys.readouterr().out
    assert "llama3.1-8b" in out and "  llava-next-34b\n" in out and "not ported" not in out
