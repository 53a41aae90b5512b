"""``core/cache.py``'s cache sizing in both layouts and its closed forms,
and ``core/latency.py``'s ``time_callable``, against the reference:

* ``profile_cache`` contiguous and paged (the worst-case pool and a
  given block count), ``analytic_kv_bytes`` and ``paged_kv_bytes`` (with
  and without ``max_len``) for every architecture at a small batch and
  length, field for field;
* the reference's own checks of them (``tests/test_paged.py``,
  ``tests/test_core.py``) on the port;
* ``time_callable`` on the CPU: the calls it makes, its stats and window.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core import cache as jax_cache  # noqa: E402
from repro.core import latency as jax_latency  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.core import cache as cache_prof  # noqa: E402
from repro_torch.core import latency  # noqa: E402

LENGTHS = [24, 16, 40, 8]


@pytest.mark.parametrize("arch", list_archs())
def test_cache_sizes_match_the_reference(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    for layout, num_blocks in (("contiguous", 0), ("paged", 0), ("paged", 7)):
        for block_size in (16, 32):
            kw = dict(layout=layout, block_size=block_size, num_blocks=num_blocks)
            ours = cache_prof.profile_cache(cfg, 4, 96, **kw)
            ref = jax_cache.profile_cache(jcfg, 4, 96, **kw)
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref), kw
    for batch, seq in ((1, 1024), (4, 96), (2, 5000)):
        assert cache_prof.analytic_kv_bytes(cfg, batch, seq) == \
            jax_cache.analytic_kv_bytes(jcfg, batch, seq)
    for block_size in (8, 16):
        for max_len in (0, 64, 4096):
            assert cache_prof.paged_kv_bytes(cfg, LENGTHS, block_size, max_len=max_len) == \
                jax_cache.paged_kv_bytes(jcfg, LENGTHS, block_size, max_len=max_len)
    assert cache_prof.analytic_kv_bytes(cfg, 2, 64, itemsize=4) == \
        jax_cache.analytic_kv_bytes(jcfg, 2, 64, itemsize=4)


def test_paged_cache_size_reporting():
    """The reference's ``test_paged_cache_size_reporting`` on the port:
    pool leaves count as kv, the worst-case pool is at least the
    contiguous cache (one garbage block more per layer), and the paged
    closed form undercuts the contiguous worst case for short-heavy
    lengths."""
    cfg = get_config("tinyllama-1.1b", smoke=True)
    rep = cache_prof.profile_cache(cfg, 4, 128, layout="paged", block_size=16)
    assert rep.kv_bytes > 0
    contig = cache_prof.profile_cache(cfg, 4, 128)
    assert rep.kv_bytes >= contig.kv_bytes
    assert cache_prof.paged_kv_bytes(cfg, LENGTHS, 16) * 2 <= \
        cache_prof.analytic_kv_bytes(cfg, len(LENGTHS), 128)


def test_cache_analytic_matches_the_built_cache():
    """The reference's ``test_cache_analytic_matches_eval_shape`` and
    ``test_cache_sliding_window_caps`` on the port."""
    for arch in ("llama3.1-8b", "recurrentgemma-2b", "nemotron-h-8b"):
        cfg = get_config(arch)
        assert cache_prof.profile_cache(cfg, 4, 4096).kv_bytes == \
            cache_prof.analytic_kv_bytes(cfg, 4, 4096, itemsize=2), arch
    cfg = get_config("recurrentgemma-2b")
    small = cache_prof.profile_cache(cfg, 1, 1024)
    big = cache_prof.profile_cache(cfg, 1, 524_288)
    assert big.kv_bytes == cache_prof.analytic_kv_bytes(cfg, 1, 524_288)
    assert big.kv_bytes <= small.kv_bytes * 2 + 1
    assert big.state_bytes == small.state_bytes


def test_time_callable_times_each_call_after_warmup():
    calls = []

    def fn():
        calls.append(1)
        return {"out": [torch.ones(4), (torch.zeros(2),)], "n": 3}

    stats = latency.time_callable(fn, iters=5, warmup=2, name="ones")
    assert len(calls) == 7
    assert stats.name == "ones" and len(stats.samples_s) == 5
    assert stats.compile_s > 0 and all(s > 0 for s in stats.samples_s)
    assert stats.window[0] > 0 and stats.window[1] - stats.window[0] >= sum(stats.samples_s)
    assert set(stats.summary()) == set(jax_latency.LatencyStats("x", [1.0]).summary())
    # at least one warm-up call, as the reference
    calls.clear()
    latency.time_callable(fn, iters=1, warmup=0)
    assert len(calls) == 2


def test_time_callable_waits_for_each_cuda_device_of_the_result(monkeypatch):
    """A result on CUDA is waited for through ``torch.cuda.synchronize``
    once per call, on each device it lives on; a CPU result is not."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: synced.append(dev))
    monkeypatch.setattr(latency, "_cuda_devices", lambda out: (
        {torch.device("cuda", 0), torch.device("cuda", 1)} if out == "on two" else set()))
    latency.time_callable(lambda: "on two", iters=3, warmup=1)
    assert len(synced) == 8 and set(synced) == {torch.device("cuda", i) for i in (0, 1)}
    synced.clear()
    latency.time_callable(lambda: torch.ones(2), iters=3, warmup=1)
    assert synced == []
