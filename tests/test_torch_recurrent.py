"""The port's RG-LRU family (recurrentgemma-2b) against the reference.

* K5's plain version against the JAX ``ref.py`` and the Pallas kernel in
  interpret mode on the sweep of ``tests/test_kernels.py``, and against a
  sequential Python loop.
* The RG-LRU block (``apply_rglru_seq`` / ``apply_rglru_step``) on bridged
  smoke params: output, ``h`` and ``conv``.
* The whole smoke model in fp32 (window 16, so a 24-token prompt and 32
  decode steps wrap the ring): prefill logits, every cache leaf and the
  greedy stream, under the reference's ``xla`` kernels and Pallas
  interpret.
* ``update_mask``, and the size and cache reports at full width.

The smoke model's embeddings are tied and scaled by sqrt(d), so with the
reference's init the residual stream of its 4 random layers is the input
token's own embedding and greedy decoding repeats one token.  The tests
shrink the embedding table (x0.05) and perturb the norm scales and
``lambda`` (N(0, 2^2)) so that the blocks decide the next token and the
streams run through every path.
"""

import dataclasses
import warnings
import zlib

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.profiler import Elana as JaxElana  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.kernels.linear_recurrence import ops as jlr_ops  # noqa: E402
from repro.kernels.linear_recurrence import ref as jlr_ref  # noqa: E402
from repro.models import cache as jax_cache  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import recurrent as jax_rec  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.profiler import Elana  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels.linear_recurrence import ops as lr_ops  # noqa: E402
from repro_torch.kernels.linear_recurrence import ref as lr_ref  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import recurrent as rec_lib  # noqa: E402
from repro_torch.models.cache import cache_bytes  # noqa: E402

ARCH = "recurrentgemma-2b"
B, PROMPT, GEN = 2, 24, 32
# fp32 on both sides; the sums run in another order, ~1e-6 relative
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
# states and cache leaves: 1e-5 relative to the leaf's largest value (a sum
# in another order errs relative to its summands, not to its result)
STATE_RTOL = 1e-5
# the reference's tolerance of Pallas against its ref (tests/test_kernels.py)
SCAN_TOL = dict(rtol=1e-4, atol=1e-5)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


# ---------------------------------------------------------------------------
# K5: linear recurrence
# ---------------------------------------------------------------------------

def _scan_inputs(Bn, S, W, pad):
    """The reference sweep's inputs (a in (0.8, 1), b ~ 0.1 N, h0 ~ N);
    ``pad`` turns a ragged tail of row 1 into identity steps (a=1, b=0),
    as the reference feeds padded chunk positions."""
    rng = _rng("scan", Bn, S, W, pad)
    a = (1 / (1 + np.exp(-rng.standard_normal((Bn, S, W))))) * 0.2 + 0.8
    b = rng.standard_normal((Bn, S, W)) * 0.1
    h0 = rng.standard_normal((Bn, W))
    if pad:
        a[1, S - S // 3:] = 1.0
        b[1, S - S // 3:] = 0.0
    return a.astype(np.float32), b.astype(np.float32), h0.astype(np.float32)


@pytest.mark.parametrize("pad", [False, True])
@pytest.mark.parametrize("S,W", [(256, 128), (512, 160), (64, 512), (100, 96), (1, 96)])
def test_linear_recurrence_plain_matches_reference(S, W, pad):
    a, b, h0 = _scan_inputs(2, S, W, pad)
    got = lr_ref.linear_recurrence(*map(torch.from_numpy, (a, b, h0))).numpy()
    ja, jb, jh0 = map(jnp.asarray, (a, b, h0))
    np.testing.assert_allclose(got, np.asarray(jlr_ref.linear_recurrence(ja, jb, jh0)),
                               **SCAN_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jlr_ops.linear_recurrence(ja, jb, jh0, interpret=True)), **SCAN_TOL)
    if pad:  # identity steps hold the state (to rounding: the scan combines
        # each step along another path)
        tail = got[1, S - S // 3 - 1:]
        np.testing.assert_allclose(tail, np.broadcast_to(tail[:1], tail.shape),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S", [1, 37])
def test_linear_recurrence_plain_matches_sequential(S):
    rng = _rng("sequential", S)
    a = rng.uniform(0.8, 1.0, (1, S, 8)).astype(np.float32)
    b = (rng.standard_normal((1, S, 8)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((1, 8)).astype(np.float32)
    h, expected = h0.copy(), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        expected.append(h.copy())
    got = lr_ref.linear_recurrence(*map(torch.from_numpy, (a, b, h0))).numpy()
    np.testing.assert_allclose(got, np.stack(expected, axis=1), rtol=1e-5, atol=1e-6)


# the split scan's edges: S not a multiple of the chunk, a chunk >= S,
# a in (0, 1e-3) (chunk products underflow to 0), identity pad steps
CHUNKED_CASES = [
    ("ragged", 100, 96, 32),
    ("chunk at least S", 40, 64, 64),
    ("chunk of one step", 37, 24, 1),
    ("underflow", 130, 128, 32),
    ("pad steps", 150, 160, 64),
]
# fp32, the recurrence reassociated across chunks: another rounding
CHUNKED_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,S,W,chunk", CHUNKED_CASES)
def test_linear_recurrence_chunked_matches_unsplit_and_jax(name, S, W, chunk):
    """The split-S algebra (``ref.linear_recurrence_chunked``, what K5's two
    passes compute) against the unsplit plain version, the JAX ref and the
    Pallas kernel in interpret mode."""
    a, b, h0 = _scan_inputs(2, S, W, pad=name == "pad steps")
    if name == "underflow":
        a = _rng("underflow", S, W).uniform(0.0, 1e-3, a.shape).astype(np.float32)
    got = lr_ref.linear_recurrence_chunked(*map(torch.from_numpy, (a, b, h0)), chunk).numpy()
    ja, jb, jh0 = map(jnp.asarray, (a, b, h0))
    for want in (lr_ref.linear_recurrence(*map(torch.from_numpy, (a, b, h0))).numpy(),
                 np.asarray(jlr_ref.linear_recurrence(ja, jb, jh0)),
                 np.asarray(jlr_ops.linear_recurrence(ja, jb, jh0, interpret=True))):
        np.testing.assert_allclose(got, want, **CHUNKED_TOL)
    if name == "underflow":  # a chunk's decay product is exactly 0 there
        assert np.prod(a[0, :chunk, 0]) == 0.0


# (B, S, W, SMs) -> (n_chunks, chunk): recurrentgemma-2b's measure prefill
# (the table's shape), its prompt past the window, the serving decode step
# (S = 1: one pass), serving admission of 8 prompts of 512 and of 64, a
# batch whose channels fill the card, and a ragged shape
SCAN_PLANS = [((1, 512, 2560, 132), (16, 32)), ((1, 2304, 2560, 132), (20, 116)),
              ((8, 1, 2560, 132), (1, 1)), ((8, 512, 2560, 132), (3, 171)),
              ((8, 64, 2560, 132), (2, 32)), ((64, 512, 2560, 132), (1, 512)),
              ((3, 300, 129, 132), (9, 34))]


@pytest.mark.parametrize("shape,plan", SCAN_PLANS)
def test_scan_plan(shape, plan):
    """K5's chunks: at least MIN_CHUNK steps unless there is one, none
    empty, covering S, from shapes only."""
    B, S, W, sms = shape
    n_chunks, chunk = lr_ops.scan_plan(B, S, W, sms)
    assert (n_chunks, chunk) == plan
    lr_ops.check_plan(S, n_chunks, chunk)
    assert n_chunks == 1 or chunk >= lr_ops.MIN_CHUNK


@pytest.mark.parametrize("S,n_chunks,chunk", [(512, 15, 32), (512, 17, 32), (512, 0, 512),
                                              (512, 2, 0)])
def test_scan_plan_check_raises(S, n_chunks, chunk):
    """Chunks that stop short of S, leave one empty, or do not exist: the
    wrapper refuses them before a launch, as the C entry point does."""
    with pytest.raises(ValueError):
        lr_ops.check_plan(S, n_chunks, chunk)


def test_linear_recurrence_wrapper_takes_the_plain_version_on_the_cpu():
    a, b, h0 = map(torch.from_numpy, _scan_inputs(2, 40, 24, False))
    n = lr_ops.linear_recurrence.launches
    want = lr_ref.linear_recurrence(a, b, h0)
    assert torch.equal(lr_ops.linear_recurrence(a, b, h0), want)
    assert torch.equal(dispatch.linear_recurrence(a, b, h0), want)
    assert lr_ops.linear_recurrence.launches == n
    assert dispatch.KERNELS["linear_recurrence"] is lr_ops.linear_recurrence


# ---------------------------------------------------------------------------
# the RG-LRU block and the whole smoke model
# ---------------------------------------------------------------------------

def _reference_params(cfg, seed=0):
    params, _ = jax_model.init(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        arr = np.asarray(leaf)
        key = str(getattr(path[-1], "key", ""))
        if key == "table":
            return arr * np.float32(0.05)
        if key in ("scale", "lambda"):
            arr = arr + 2.0 * rng.standard_normal(arr.shape).astype(arr.dtype)
        return arr

    return jax.tree_util.tree_map_with_path(perturb, params)


@pytest.fixture(scope="module")
def bridged():
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    tree = _reference_params(jcfg)
    return jcfg, cfg, tree, params_from_jax(cfg, tree, device="cpu")


def _state_pair(cfg, Bn, seed):
    rng = _rng("state", Bn, seed)
    W, K = cfg.resolved_lru_width, cfg.rglru_conv_width
    h = rng.standard_normal((Bn, W)).astype(np.float32)
    conv = rng.standard_normal((Bn, K - 1, W)).astype(np.float32)
    return ({"h": jnp.asarray(h), "conv": jnp.asarray(conv)},
            {"h": torch.from_numpy(h), "conv": torch.from_numpy(conv)})


def _assert_close(got, want, **kw):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=STATE_RTOL,
                               atol=STATE_RTOL * max(1.0, float(np.abs(want).max())), **kw)


def _assert_state(got, want):
    for leaf in ("h", "conv"):
        _assert_close(got[leaf].numpy(), want[leaf], err_msg=leaf)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_rglru_seq_and_step_match_reference(bridged, backend):
    """Layer 0's block from a nonzero state: a 24-step sequence, then one
    decode step from the state it left."""
    jcfg, cfg, tree, model = bridged
    jp = jax.tree.map(lambda a: jnp.asarray(a[0]), tree["decoder"]["groups"]["0"]["rec"])
    p = model.layers[0].rec
    x = _rng("rglru-x").standard_normal((B, PROMPT + 1, cfg.d_model)).astype(np.float32)
    jstate, state = _state_pair(cfg, B, 0)
    with jax_dispatch.use_backend(backend, interpret=backend == "pallas"):
        jy, jst = jax_rec.apply_rglru_seq(jp, jnp.asarray(x[:, :PROMPT]), jcfg, jstate)
        jy1, jst1 = jax_rec.apply_rglru_step(jp, jnp.asarray(x[:, PROMPT:]), jcfg, jst)
    y, st = rec_lib.apply_rglru_seq(p, torch.from_numpy(x[:, :PROMPT]), cfg, state)
    _assert_close(y.numpy(), jy)
    _assert_state(st, jst)
    y1, st1 = rec_lib.apply_rglru_step(p, torch.from_numpy(x[:, PROMPT:]), cfg, st)
    _assert_close(y1.numpy(), jy1)
    _assert_state(st1, jst1)


def _ref_entry(jcache, cfg, i):
    """The reference cache entry of port layer ``i`` (groups are stacked
    on a leading axis, the remainder is not; attention sits under
    ``self``)."""
    plen = len(cfg.block_pattern)
    n_groups, _ = cfg.layer_groups()
    g, j = divmod(i, plen)
    entry = (jax.tree.map(lambda a: a[g], jcache["groups"][str(j)]) if g < n_groups
             else jcache["rest"][str(j)])
    return entry.get("self", entry)


def _assert_cache(cache, jcache, cfg):
    for i, entry in enumerate(cache):
        ref = _ref_entry(jcache, cfg, i)
        assert set(entry) == set(ref), i
        for leaf, t in entry.items():
            if t.dtype in (torch.int32, torch.int64):
                np.testing.assert_array_equal(t.numpy(), np.asarray(ref[leaf]),
                                              err_msg=f"layer {i} {leaf}")
            else:
                _assert_close(t.numpy(), ref[leaf], err_msg=f"layer {i} {leaf}")


def _close_margin(logits: np.ndarray) -> bool:
    """True if some row's top-2 logits are closer than the tolerance, so a
    greedy pick could flip on rounding alone."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    tol = LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * np.abs(top2[:, 1])
    return bool(np.any(top2[:, 1] - top2[:, 0] <= tol))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_smoke_model_matches_reference(bridged, backend):
    jcfg, cfg, tree, model = bridged
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = _rng("prompt").integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32)
    max_len = PROMPT + GEN + 1
    assert cfg.sliding_window < max_len  # the local layers keep a ring

    with jax_dispatch.use_backend(backend, interpret=backend == "pallas"):
        prefill = jax.jit(lambda p, b, c: jax_model.prefill(jcfg, p, b, c))
        decode = jax.jit(lambda p, t, pos, c: jax_model.decode_step(jcfg, p, t, pos, c))
        jcache = jax_model.init_cache(jcfg, B, max_len, jnp.float32)
        jlogits, jcache = prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache)
        j_steps, j_caches = [np.asarray(jlogits)], [jcache]
        tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        for i in range(GEN):
            jlogits, jcache = decode(jparams, tok, jnp.asarray(PROMPT + i, jnp.int32), jcache)
            j_steps.append(np.asarray(jlogits))
            j_caches.append(jcache)
            tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)

    cache = model.init_cache(B, max_len)
    logits, cache = model.prefill({"tokens": torch.from_numpy(tokens).long()}, cache)
    np.testing.assert_allclose(logits.numpy(), j_steps[0], **LOGITS_TOL)
    _assert_cache(cache, j_caches[0], cfg)

    stream, j_stream = [], []
    for i in range(GEN):
        if _close_margin(j_steps[i]):
            warnings.warn(f"{backend}: top-2 logits within tolerance at step {i}; "
                          f"streams compared up to it")
            break
        tok = logits.argmax(-1, keepdim=True)
        stream.append(tok[:, 0].numpy())
        j_stream.append(j_steps[i].argmax(-1))
        logits, cache = model.decode_step(tok, PROMPT + i, cache)
        np.testing.assert_allclose(logits.numpy(), j_steps[i + 1], **LOGITS_TOL)
        _assert_cache(cache, j_caches[i + 1], cfg)
    assert len(stream) > GEN // 2, f"only {len(stream)} decisive steps"
    stream = np.stack(stream)
    np.testing.assert_array_equal(stream, np.stack(j_stream))
    # the ring wrapped, and the stream is not one repeated token
    assert (cache[2]["pos"] >= cfg.sliding_window).any()
    assert all(len(set(stream[:, b].tolist())) > 1 for b in range(B)), stream.T


def test_bridge_names_the_rglru_leaves(bridged):
    _, cfg, tree, model = bridged
    names = dict(model.named_parameters())
    for leaf in ("in_x", "in_g", "conv_w", "gate_a", "gate_x", "lambda", "out"):
        assert f"layers.0.rec.{leaf}" in names and f"layers.3.rec.{leaf}" in names
    np.testing.assert_array_equal(names["layers.1.rec.lambda"].numpy(),
                                  tree["decoder"]["groups"]["1"]["rec"]["lambda"][0])
    np.testing.assert_array_equal(names["layers.3.rec.lambda"].numpy(),
                                  tree["decoder"]["rest"]["0"]["rec"]["lambda"])


def test_init_lambda_is_the_reference_formula():
    """``lambda`` is not drawn from the seed: the port's init gives the
    reference's values, and a = exp(-8 softplus(lambda)) in [0.9, 0.999]."""
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    ref = np.asarray(jax_model.init(jcfg, jax.random.PRNGKey(7))[0]
                     ["decoder"]["rest"]["0"]["rec"]["lambda"])
    model = model_lib.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    lam = getattr(model.layers[3].rec, "lambda")
    np.testing.assert_array_equal(lam.numpy(), ref)
    a = torch.exp(-8.0 * torch.nn.functional.softplus(lam))
    assert a.min() >= 0.9 - 1e-6 and a.max() <= 0.999 + 1e-6


def test_update_mask_freezes_state_and_ring():
    cfg = get_config(ARCH, smoke=True)
    model = model_lib.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    cache = model.init_cache(2, 30)
    _, cache = model.prefill({"tokens": tokens}, cache)
    before = [{k: t.clone() for k, t in e.items()} for e in cache]
    model.decode_step(tokens[:, :1], 20, cache, update_mask=torch.tensor([True, False]))
    kinds = cfg.blocks()
    assert set(kinds) == {"rglru", "local_attn"}
    for kind, old, new in zip(kinds, before, cache):
        leaves = ("h", "conv") if kind == "rglru" else ("k", "v", "pos")
        for leaf in leaves:
            assert torch.equal(old[leaf][1], new[leaf][1]), (kind, leaf)
            assert not torch.equal(old[leaf][0], new[leaf][0]), (kind, leaf)


# ---------------------------------------------------------------------------
# ELANA's reports and the measured path
# ---------------------------------------------------------------------------

def test_size_report_reads_5_36_gb_like_the_reference():
    ours, ref = Elana(ARCH, device="cpu").size_report(), JaxElana(ARCH).size_report()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert "5.36 GB" in ours.fmt() and ours.param_count == ref.param_count
    assert ours.by_component["decoder.rec"] > 0


@pytest.mark.parametrize("batch,seq_len", [(1, 544), (8, 1024), (1, 4096)])
def test_cache_report_matches_reference(batch, seq_len):
    ours = Elana(ARCH, device="cpu").cache_report(batch, seq_len)
    ref = JaxElana(ARCH).cache_report(batch, seq_len)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.kv_bytes > 0 and ours.state_bytes > 0 and ours.meta_bytes > 0


def test_allocated_cache_bytes_match_reference():
    cfg = get_config(ARCH, smoke=True)
    ref = jax_model.init_cache(jax_config(ARCH, smoke=True), 3, 40, np.float32)
    assert cache_bytes(model_lib.Model(cfg, device="cpu").init_cache(3, 40)) == \
        jax_cache.cache_bytes(ref)


def test_measure_and_cli_run_on_the_cpu(capsys):
    from repro_torch.cli import main

    out = Elana(ARCH, smoke=True, device="cpu").measure(batch=1, prompt_len=20, gen_len=4,
                                                        iters=2)
    assert set(out) == {"ttft_ms", "tpot_ms", "ttlt_ms", "ttft_p95_ms", "tpot_p95_ms"}
    assert all(np.isfinite(v) and v > 0 for v in out.values())
    assert main(["size", "--arch", ARCH, "--device", "cpu"]) == 0
    assert "5.36 GB" in capsys.readouterr().out
    assert main(["cache", "--arch", ARCH, "--device", "cpu", "--batch", "8",
                 "--seq-len", "1024"]) == 0
    assert "state" in capsys.readouterr().out
    assert main(["archs"]) == 0
    ported = capsys.readouterr().out.split("not ported yet:")[0]
    assert ARCH in ported
