"""The port's chunked and unified serving engine against the reference's
on the reference's chunked-prefill suite trace (tinyllama-1.1b smoke, fp32
bridged params, ``max_batch=2``, ``max_len=64``, bucket 8, 6 greedy
requests): for both layouts, chunks {1, 16, 999 (one chunk per prompt)}
and the unified step on and off, the greedy streams, per-step dispatch
counts, pool occupancy samples, peak blocks, final free stack and the
summary's keys must equal the JAX engine's.
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

ARCH = "tinyllama-1.1b"
ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8)
CHUNKS = (1, 16, 999)  # 999 >= every bucketed prompt: one chunk each


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """A step of a smoke model is hundreds of small ops: at torch's default
    intra-op threads the test run's workers (and a file's gloo ranks)
    oversubscribe the cores.  One thread for the module (this one, and
    each that imports the fixture), restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def shared_jax_compiles(tmp_path_factory):
    """Each JAX engine jits its own closures, so every instance compiles
    the same executables again: a persistent compilation cache, for the
    module only (this one, and each that imports the fixture), compiles
    each once.  The settings are restored after."""
    from jax.experimental.compilation_cache import compilation_cache

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in keys}
    for k, v in zip(keys, (str(tmp_path_factory.mktemp("jax_compiles")), 0.0, -1)):
        jax.config.update(k, v)
    compilation_cache.reset_cache()
    yield
    for k, v in saved.items():
        jax.config.update(k, v)
    compilation_cache.reset_cache()


def _trace(lib, vocab):
    """The reference's chunked-prefill suite trace (tests/test_paged.py's)."""
    return lib.poisson_trace(lib.WorkloadSpec(
        arrival_rate=0.0, num_requests=6, temperature=0.0, top_k=8, seed=2,
        prompt_len=lib.LengthDist(kind="lognormal", mean=16.0, low=2, high=48),
        output_len=lib.LengthDist(kind="uniform", mean=0.0, low=2, high=9)), vocab)


def _drive(engine, arrivals):
    for a in arrivals:
        engine.submit(a.prompt, a.params)
    return {r.uid: list(r.output_tokens) for r in engine.run()}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config(ARCH, smoke=True)
    params = jax.jit(lambda key: jax_model.init(jcfg, key)[0])(jax.random.PRNGKey(0))
    return jcfg, params, params_from_jax(get_config(ARCH, smoke=True),
                                         jax.tree.map(np.asarray, params), "cpu")


@pytest.fixture(scope="module")
def engine_runs(models):
    jcfg, params, model = models
    runs = {}
    for layout in ("contiguous", "paged"):
        for chunk in CHUNKS:
            for unified in (True, False):
                kw = dict(ENGINE, cache_layout=layout, prefill_chunk=chunk,
                          unified_step=unified)
                jeng = JaxServingEngine(jcfg, params, **kw)
                jout = _drive(jeng, _trace(jax_workload, jcfg.vocab_size))
                eng = ServingEngine(model, **kw, device="cpu")
                runs[layout, chunk, unified] = (jeng, jout, eng,
                                                _drive(eng, _trace(workload, jcfg.vocab_size)))
    return runs


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("unified", [True, False], ids=["unified", "per-chunk"])
def test_chunked_engine_matches_reference_engine(engine_runs, layout, chunk, unified):
    jeng, jout, eng, out = engine_runs[layout, chunk, unified]
    assert len(out) == 6 and out == jout
    assert eng._dispatch_samples == jeng._dispatch_samples
    assert eng._occ_samples == pytest.approx(jeng._occ_samples)
    assert eng.peak_blocks_in_use == jeng.peak_blocks_in_use
    if unified:  # a row reset and the step
        assert max(eng._dispatch_samples) <= 2
    assert eng.blocks_in_use == 0 and not eng._prefill_order
    if layout == "paged":
        assert not eng._state["block_tables"].any()
        assert eng._pool.free_stack == jeng._pool.free_stack
    ours, ref = eng.latency_summary(), jeng.latency_summary()
    assert set(ours) == set(ref)
    for key in ("requests", "output_tokens", "dispatches_per_step_p50",
                "dispatches_per_step_p95", "tokens_per_dispatch", "kv_bytes_peak"):
        assert ours[key] == ref[key], key


