"""Chunked prefill in the port against the reference: the chunk writes
into the caches, ``prefill_chunk`` and the engine's chunked and unified
paths (the engine's full matrix against the reference is in
``test_torch_unified.py``).

The cache writes are held to the reference's at 0 tolerance (the pool's
garbage block 0 aside: pad columns all land there, in an order neither
package fixes).  ``prefill_chunk`` logits are held to the reference's at
2e-5 (fp32, bridged smoke params).  The recurrentgemma engine's greedy
streams and dispatch counts equal the JAX engine's; sampled streams do
not depend on the schedule; the budget bounds each step's prompt work.
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import cache as jax_cache  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402
from test_torch_unified import one_thread  # noqa: E402,F401 (autouse)

ARCH = "tinyllama-1.1b"
ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _trace(lib, vocab, temperature=0.0, seed=2, n=6):
    """The reference's chunked-prefill suite trace (tests/test_paged.py's)."""
    return lib.poisson_trace(lib.WorkloadSpec(
        arrival_rate=0.0, num_requests=n, temperature=temperature, top_k=8, seed=seed,
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


# -- the chunk writes ----------------------------------------------------------

def _contig_case(rng, B, L, C, ring_at=None):
    """A cache of L slots holding positions 0..start-1 (a ring wrapped up
    to ``ring_at``), and a chunk of C at per-row starts."""
    H, D = 2, 4
    k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(2))
    pos = np.full((B, L), -1, np.int32)
    start = rng.integers(0, L, B).astype(np.int32) if ring_at is None else \
        np.full(B, ring_at, np.int32)
    for b in range(B):
        for p in range(max(0, start[b] - L), start[b]):
            pos[b, p % L] = p
    kn, vn = (rng.standard_normal((B, C, H, D)).astype(np.float32) for _ in range(2))
    positions = (start[:, None] + np.arange(C)[None]).astype(np.int32)
    lengths = rng.integers(0, C + 1, B)
    lengths[0] = C
    return (k, v, pos), (kn, vn, positions), np.arange(C)[None] < lengths[:, None]


@pytest.mark.parametrize("B,L,C,ring_at", [(3, 16, 5, None), (3, 8, 8, 21), (4, 8, 13, 30),
                                           (2, 8, 13, None)])
@pytest.mark.parametrize("masked", [False, True])
def test_append_attn_cache_matches_reference(B, L, C, ring_at, masked):
    """Contiguous and ring caches, chunks shorter than, as long as and
    longer than the ring (C > L keeps each row's last <= L valid entries
    when ragged), with and without the valid mask: exact."""
    rng = np.random.default_rng(B * 100 + L + C)
    (k, v, pos), (kn, vn, positions), valid = _contig_case(rng, B, L, C, ring_at)
    if not masked:
        valid = None
    ring = np.int32(1)
    want = jax_cache.append_attn_cache(
        {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos),
         "ring": jnp.asarray(ring)},
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(positions),
        None if valid is None else jnp.asarray(valid))
    ours = {"k": _t(k.copy()), "v": _t(v.copy()), "pos": _t(pos.copy()),
            "ring": _t(ring)}
    live = dict(ours)
    got = cache_lib.append_attn_cache(ours, _t(kn), _t(vn), _t(positions),
                                      None if valid is None else _t(valid))
    for leaf in ("k", "v", "pos"):
        assert got[leaf] is live[leaf]  # written in place
        np.testing.assert_array_equal(got[leaf].numpy(), np.asarray(want[leaf]), leaf)


@pytest.mark.parametrize("masked", [False, True])
def test_append_paged_cache_and_gather_match_reference(masked):
    """A chunk per row at ragged starts through shuffled block tables (pad
    columns past the table when masked), then the gathered pool: exact
    outside the garbage block, and the gathered keys read the pool."""
    rng = np.random.default_rng(7)
    B, C, bs, M, N, H, D = 3, 11, 4, 6, 20, 2, 4
    kp, vp = (rng.standard_normal((N, bs, H, D)).astype(np.float32) for _ in range(2))
    tables = np.zeros((B, M), np.int32)
    perm = rng.permutation(np.arange(1, N))
    for b in range(B):
        tables[b] = perm[b * M:(b + 1) * M]
    start = np.array([0, 7, 13], np.int32)
    positions = (start[:, None] + np.arange(C)[None]).astype(np.int32)
    valid = np.arange(C)[None] < np.array([[C], [9], [0]])
    if masked:
        positions[1] += 5  # row 1's pads run past its 6 * 4 positions
    else:
        valid = None
    kn, vn = (rng.standard_normal((B, C, H, D)).astype(np.float32) for _ in range(2))
    jc = jax_cache.append_paged_cache(
        {"kp": jnp.asarray(kp), "vp": jnp.asarray(vp)}, jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(positions), jnp.asarray(tables),
        None if valid is None else jnp.asarray(valid))
    ours = cache_lib.append_paged_cache(
        {"kp": _t(kp.copy()), "vp": _t(vp.copy())}, _t(kn), _t(vn), _t(positions),
        _t(tables), None if valid is None else _t(valid))
    for leaf in ("kp", "vp"):
        np.testing.assert_array_equal(ours[leaf].numpy()[1:], np.asarray(jc[leaf])[1:])
    ours["kp"][0] = ours["vp"][0] = 0.0  # compare the gather on equal pools
    jc = {"kp": jnp.asarray(ours["kp"].numpy()), "vp": jnp.asarray(ours["vp"].numpy())}
    for got, want in zip(cache_lib.gather_paged_kv(ours, _t(tables)),
                         jax_cache.gather_paged_kv(jc, jnp.asarray(tables))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_reset_rows_returns_rows_to_init_in_place(models):
    _, _, model = models
    cache = model.init_cache(3, 16)
    for entry in cache:
        for leaf, t in entry.items():
            if t.dim():
                t.fill_(5)
    live = [dict(e) for e in cache]
    cache_lib.reset_rows(cache, torch.tensor([0, 2]))
    fresh = model.init_cache(3, 16)
    for entry, old, new in zip(cache, live, fresh):
        for leaf, t in entry.items():
            assert t is old[leaf]
            if t.dim():
                assert torch.equal(t[[0, 2]], new[leaf][[0, 2]]), leaf
                assert (t[1] == 5).all(), leaf


# -- prefill_chunk ---------------------------------------------------------------

def _hybrid_params():
    """recurrentgemma-2b smoke, fp32, perturbed as test_torch_serving_hybrid.py
    does so its streams and logits depend on the context."""
    jcfg = jax_config("recurrentgemma-2b", smoke=True)
    params = jax.jit(lambda key: jax_model.init(jcfg, key)[0])(jax.random.PRNGKey(0))
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


@pytest.fixture(scope="module")
def hybrid():
    jcfg, tree = _hybrid_params()
    return jcfg, jax.tree.map(jnp.asarray, tree), params_from_jax(
        get_config("recurrentgemma-2b", smoke=True), tree, device="cpu")


def _chunk_pair(jcfg, jparams, model, layout, B, prefix, chunk, start, lengths):
    """Prefill ``prefix`` tokens whole, then one chunk at ``start`` (an int
    or per-row) with ``lengths``, in both packages; returns both logits."""
    rng = np.random.default_rng(B + prefix + chunk)
    max_len, bs = 64, 8
    toks = rng.integers(0, jcfg.vocab_size, (B, prefix + chunk)).astype(np.int32)
    kw, tables = {}, None
    if layout == "paged":
        nb = max_len // bs
        tables = (rng.permutation(B * nb) + 1).astype(np.int32).reshape(B, nb)
        kw = dict(layout="paged", block_size=bs, num_blocks=B * nb + 1)
    jc = jax_model.init_cache(jcfg, B, max_len, jnp.float32, **kw)
    jt = None if tables is None else jnp.asarray(tables)
    # jitted, as the reference's engine runs them (eager dispatch is slow)
    _, jc = jax.jit(lambda p, b, c, t: jax_model.prefill(jcfg, p, b, c, block_tables=t))(
        jparams, {"tokens": jnp.asarray(toks[:, :prefix])}, jc, jt)
    jl, jc = jax.jit(lambda p, b, c, s, t, n: jax_model.prefill_chunk(
        jcfg, p, b, c, s, block_tables=t, lengths=n))(
        jparams, {"tokens": jnp.asarray(toks[:, prefix:])}, jc, jnp.asarray(start), jt,
        None if lengths is None else jnp.asarray(lengths))
    cache = model.init_cache(B, max_len, **kw)
    tt = None if tables is None else _t(tables)
    model.prefill({"tokens": _t(toks[:, :prefix])}, cache, block_tables=tt)
    start_t = start if np.ndim(start) == 0 else _t(np.asarray(start, np.int32))
    logits, cache = model.prefill_chunk(_t(toks[:, prefix:]), cache, start_t, block_tables=tt,
                                        lengths=None if lengths is None else _t(lengths))
    return logits, jl


@pytest.mark.parametrize("arch,layout,case", [
    ("tinyllama", "contiguous", "scalar"), ("tinyllama", "paged", "per-row ragged"),
    ("recurrentgemma", "paged", "per-row ragged"),
    ("recurrentgemma", "contiguous", "longer than the window")])
def test_prefill_chunk_matches_reference(models, hybrid, arch, layout, case):
    """Logits of each row's last valid position (fp32, 2e-5) for a scalar
    start, per-row starts with ragged
    lengths (a row of length 0 among them), and a chunk longer than
    recurrentgemma's 16-token window (its ring keeps each row's tail)."""
    jcfg, jparams, model = models if arch == "tinyllama" else hybrid
    B, prefix, chunk = 3, 12, 8
    start, lengths = prefix, None
    if case == "per-row ragged":
        start, lengths = np.array([12, 12, 12], np.int32), np.array([8, 3, 0], np.int32)
    elif case == "longer than the window":
        chunk, lengths = 24, np.array([24, 20, 17], np.int32)
        start = np.array([12, 12, 12], np.int32)
    logits, jl = _chunk_pair(jcfg, jparams, model, layout, B, prefix, chunk,
                                        start, lengths)
    rows = slice(None) if lengths is None else lengths > 0
    np.testing.assert_allclose(logits.numpy()[rows], np.asarray(jl)[rows], rtol=2e-5,
                               atol=2e-5)


# -- the engine -------------------------------------------------------------------

@pytest.mark.parametrize("layout,chunk,unified", [("contiguous", 8, True),
                                                  ("paged", 16, False)])
def test_hybrid_chunked_engine_matches_reference_engine(hybrid, layout, chunk, unified):
    """recurrentgemma (rings wrap past the 16-token window, RG-LRU states
    resume across chunks): greedy streams, dispatch counts and peak
    blocks equal the reference's."""
    jcfg, jparams, model = hybrid
    kw = dict(ENGINE, cache_layout=layout, prefill_chunk=chunk, unified_step=unified)
    jeng = JaxServingEngine(jcfg, jparams, **kw)
    jout = _drive(jeng, _trace(jax_workload, jcfg.vocab_size))
    eng = ServingEngine(model, **kw, device="cpu")
    out = _drive(eng, _trace(workload, jcfg.vocab_size))
    assert len(out) == 6 and out == jout
    assert eng._dispatch_samples == jeng._dispatch_samples
    assert eng.peak_blocks_in_use == jeng.peak_blocks_in_use
    assert sum(len(set(t)) > 1 for t in out.values()) >= 4, out


def test_sampled_streams_do_not_depend_on_the_schedule(models):
    """Sampled draws depend on (request, token index) only: whole-prompt,
    per-chunk and unified engines (the unified step draws each first
    token on the device) emit the same streams."""
    _, _, model = models
    arrivals = _trace(workload, model.cfg.vocab_size, temperature=0.7, seed=4, n=8)
    outs = {}
    for layout in ("contiguous", "paged"):
        for chunk, budget, unified in ((0, 0, True), (8, 0, False), (8, 0, True),
                                       (4, 16, True), (16, 0, True)):
            eng = ServingEngine(model, **ENGINE, cache_layout=layout, prefill_chunk=chunk,
                                prefill_budget=budget, unified_step=unified, seed=11,
                                device="cpu")
            outs[layout, chunk, budget, unified] = _drive(eng, arrivals)
    ref = outs["contiguous", 0, 0, True]
    assert len(ref) == 8
    for key, out in outs.items():
        assert out == ref, key


def test_budget_bounds_prompt_work_per_step(models):
    """No step advances more prompt tokens than the budget, on either path,
    and every step makes at most two dispatches on the unified path (a
    row reset and the step)."""
    _, _, model = models
    rng = np.random.default_rng(3)
    for unified in (True, False):
        eng = ServingEngine(model, **ENGINE, prefill_chunk=4, prefill_budget=10,
                            unified_step=unified, device="cpu")
        for n in (30, 21, 9, 40):
            eng.submit(rng.integers(0, model.cfg.vocab_size, n),
                       SamplingParams(max_new_tokens=5))
        work = []
        while eng.busy:
            before = sum(c.next for c in eng._cursors if c is not None)
            done_before = {id(c.req): c.plen for c in eng._cursors if c is not None}
            eng.step()
            after = sum(c.next for c in eng._cursors if c is not None)
            finished = sum(plen for rid, plen in done_before.items()
                           if rid not in {id(c.req) for c in eng._cursors if c is not None})
            work.append(after + finished - before)
        assert max(work) <= 10 and sum(work) > 0
        if unified:
            assert max(eng._dispatch_samples) <= 2
        assert len(eng.finished) == 4 and all(len(r.output_tokens) == 5 for r in eng.finished)


def test_engine_refuses_what_is_not_ported(models):
    """The reference's ``shard_rules``/``param_axes`` place a JAX tree by
    logical axes, which the port's hand-made shards have no use for
    (tensor parallelism takes ``mesh=`` and the rank's shard); nor are
    padding sides, preemption policies or drafters the reference lacks."""
    _, _, model = models
    with pytest.raises(TypeError, match="param_axes"):
        ServingEngine(model, **ENGINE, param_axes={}, device="cpu")
    with pytest.raises(TypeError, match="shard_rules"):
        ServingEngine(model, **ENGINE, shard_rules={}, device="cpu")
    with pytest.raises(ValueError, match="preemption"):
        ServingEngine(model, **ENGINE, cache_layout="paged", preemption="swap", device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        ServingEngine(model, **ENGINE, speculative="draft-model", device="cpu")
    with pytest.raises(ValueError, match="pad_side"):
        ServingEngine(model, **ENGINE, pad_side="middle", device="cpu")
