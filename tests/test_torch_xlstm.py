"""The port's xLSTM family against the reference: nemotron-h-8b (mLSTM
cells, FFN-only and attention layers) and xlstm-1.3b (mLSTM and sLSTM).

* The mLSTM and sLSTM cells (``apply_*_seq`` / ``apply_*_step``) on the
  same smoke params in both packages (the port's init, carried into the
  reference's tree and back through the bridge), fp32: S a multiple of the chunk, S not one (the
  identity-step pad), S under the chunk, with and without ragged
  ``valid`` rows, from a fresh state and from a carried one; output and
  every state leaf.
* ``init_block_cache`` for every block kind against the reference's, and
  ``reset_cache`` / ``reset_rows`` against fresh entries leaf by leaf
  (the stabilizers ``m`` start at -1e30, not 0).
* The bridge's leaf names at full depth (nemotron-h-8b's two 26-slot
  groups, xlstm-1.3b's six 8-slot groups, narrow widths).
* Both smoke models: prefill, chunked prefill with ragged rows and decode
  logits, cache leaves and greedy streams against the reference's jitted
  ``prefill`` / ``prefill_chunk`` / ``decode_step``; the measured loop's
  greedy stream; ``update_mask``.
* Size (16.38 GB, 3.77 GB) and cache reports equal to the reference's.
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
from repro.models import cache as jax_cache  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import recurrent as jax_rec  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.latency import LatencyProfiler  # noqa: E402
from repro_torch.core.profiler import Elana  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import recurrent as rec_lib  # noqa: E402
from repro_torch.models.config import BLOCK_KINDS  # noqa: E402
from test_torch_unified import one_thread  # noqa: E402,F401 (autouse)

NEMOTRON, XLSTM = "nemotron-h-8b", "xlstm-1.3b"
B, PROMPT, GEN = 2, 24, 12
# fp32 on both sides; the sums run in another order, ~1e-6 relative
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)
# states and outputs: 1e-5 relative to the leaf's largest value (a sum in
# another order errs relative to its summands, not to its result)
STATE_RTOL = 1e-5


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _assert_close(got, want, **kw):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=STATE_RTOL,
                               atol=STATE_RTOL * max(1.0, float(np.abs(want).max())), **kw)


def _reference_tree(jcfg, model):
    """The reference's parameter tree (its structure from ``jax.eval_shape``
    of the reference's init: nothing is compiled) filled from the port's
    ``model``, the bridge's naming run backwards: group ``g``'s slot ``i``
    is port layer ``g * len(pattern) + i``."""
    shapes = jax.eval_shape(lambda k: jax_model.init(jcfg, k)[0], jax.random.PRNGKey(0))
    params = {n: p.detach().numpy() for n, p in model.named_parameters()}
    plen = len(jcfg.block_pattern)
    n_groups, _ = jcfg.layer_groups()

    def fill(path, shape):
        keys = [str(getattr(k, "key", k)) for k in path]
        if keys[:2] == ["decoder", "groups"]:
            leaf = ".".join(keys[3:])
            arr = np.stack([params[f"layers.{g * plen + int(keys[2])}.{leaf}"]
                            for g in range(n_groups)])
        elif keys[:2] == ["decoder", "rest"]:
            arr = params[f"layers.{n_groups * plen + int(keys[2])}.{'.'.join(keys[3:])}"]
        else:
            arr = params[".".join(keys[1:] if keys[0] == "decoder" else keys)]
        assert arr.shape == shape.shape and arr.dtype == shape.dtype, keys
        return arr

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _reference_params(jcfg, seed=0):
    """Smoke params in the reference's tree: the port's init from ``seed``
    with the embedding table shrunk (x0.05) and the norm scales perturbed
    (N(0, 2^2)), so that the smoke models' greedy streams depend on the
    blocks, not on the input token alone."""
    model = model_lib.init(get_config(jcfg.name, smoke=True),
                           torch.Generator().manual_seed(seed), device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        model.embed.table.mul_(0.05)
        for name, p in model.named_parameters():
            if name.endswith("scale"):
                p.add_(2.0 * torch.randn(p.shape, generator=gen))
    return _reference_tree(jcfg, model)


@pytest.fixture(scope="module")
def bridged():
    """Per arch: (reference cfg, port cfg, reference params, the port model
    the bridge builds from them)."""
    out = {}
    for arch in (NEMOTRON, XLSTM):
        jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
        tree = _reference_params(jcfg)
        out[arch] = (jcfg, cfg, tree, params_from_jax(cfg, tree, device="cpu"))
    return out


def _ref_layer(stack, cfg, i):
    """Port layer ``i``'s part of a reference stack (params under
    ``decoder``, or the cache): groups are stacked on a leading axis, the
    remainder is not."""
    plen = len(cfg.block_pattern)
    n_groups, _ = cfg.layer_groups()
    g, j = divmod(i, plen)
    if g < n_groups:
        return jax.tree.map(lambda a: a[g], stack["groups"][str(j)])
    return stack["rest"][str(j)]


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

# (arch, port layer): nemotron's first mLSTM, xlstm's first mLSTM and its sLSTM
CELLS = [(NEMOTRON, 0), (XLSTM, 0), (XLSTM, 7)]


def _carried_state(kind, cfg, Bn, seed):
    """A state as a cell leaves it: C, c, h, conv N(0, 1); normalizers
    positive; stabilizers O(1)."""
    rng = _rng("state", kind, Bn, seed)
    fresh = cache_lib.init_block_cache(cfg, kind, Bn, 8, torch.float32, "cpu")
    out = {}
    for leaf, t in fresh.items():
        arr = rng.standard_normal(tuple(t.shape)).astype(np.float32)
        if leaf == "n":
            arr = np.abs(arr) + 0.5
        out[leaf] = arr
    return out


@pytest.mark.parametrize("start,ragged", [("fresh", False), ("carried", True)],
                         ids=["fresh-full", "carried-ragged"])
@pytest.mark.parametrize("S", [32, 21, 9], ids=["S=2chunks", "S=pad", "S<chunk"])
@pytest.mark.parametrize("arch,layer", CELLS, ids=["nemotron-mlstm", "xlstm-mlstm",
                                                   "xlstm-slstm"])
def test_cell_seq_and_step_match_reference(bridged, arch, layer, S, start, ragged):
    """S steps from a fresh state (every row full) or a carried one (row 1
    ragged: its last third are pad steps, which must leave the state as
    after its last valid step), then one decode step from the state they
    left."""
    jcfg, cfg, tree, model = bridged[arch]
    kind = cfg.blocks()[layer]
    assert cfg.recurrent_chunk == 16
    jp = jax.tree.map(jnp.asarray, _ref_layer(tree["decoder"], cfg, layer)["cell"])
    p = model.layers[layer].cell
    x = _rng("x", arch, layer, S).standard_normal((B, S + 1, cfg.d_model)).astype(np.float32)
    if start == "fresh":
        jstate = jax_cache.init_block_cache(jcfg, kind, B, 8, jnp.float32)
        state = cache_lib.init_block_cache(cfg, kind, B, 8, torch.float32, "cpu")
    else:
        arrs = _carried_state(kind, cfg, B, S)
        jstate = {k: jnp.asarray(a) for k, a in arrs.items()}
        state = {k: torch.from_numpy(a) for k, a in arrs.items()}
    valid = np.ones((B, S), bool)
    if ragged:
        valid[1, S - S // 3:] = False
    seq = {"mlstm": (jax_rec.apply_mlstm_seq, rec_lib.apply_mlstm_seq),
           "slstm": (jax_rec.apply_slstm_seq, rec_lib.apply_slstm_seq)}[kind]
    step = {"mlstm": (jax_rec.apply_mlstm_step, rec_lib.apply_mlstm_step),
            "slstm": (jax_rec.apply_slstm_step, rec_lib.apply_slstm_step)}[kind]
    kw = dict(valid=jnp.asarray(valid)) if ragged else {}
    jy, jst = seq[0](jp, jnp.asarray(x[:, :S]), jcfg, jstate, **kw)
    y, st = seq[1](p, torch.from_numpy(x[:, :S]), cfg, state,
                   torch.from_numpy(valid) if ragged else None)
    rows = valid  # pad outputs are garbage in both packages
    _assert_close(y.numpy()[rows], np.asarray(jy)[rows])
    assert set(st) == set(jst)
    for leaf in jst:
        _assert_close(st[leaf].numpy(), jst[leaf], err_msg=leaf)
    jy1, jst1 = step[0](jp, jnp.asarray(x[:, S:]), jcfg, jst)
    y1, st1 = step[1](p, torch.from_numpy(x[:, S:]), cfg, st)
    _assert_close(y1.numpy(), jy1)
    for leaf in jst1:
        _assert_close(st1[leaf].numpy(), jst1[leaf], err_msg=leaf)
    if ragged:  # row 1's state equals a run over its valid prefix alone
        n = int(valid[1].sum())
        one = {k: v[1:2].clone() for k, v in state.items()}
        _, st_alone = seq[1](p, torch.from_numpy(x[1:2, :n]), cfg, one)
        for leaf, t in st_alone.items():
            _assert_close(st[leaf][1:2].numpy(), t.numpy(), err_msg=leaf)


@pytest.mark.parametrize("S", [32, 21], ids=["S=2chunks", "S=pad"])
@pytest.mark.parametrize("arch", [NEMOTRON, XLSTM])
def test_norms_get_contiguous_rows(monkeypatch, arch, S):
    """K1 takes contiguous rows only (``rmsnorm/ops.py:_check``): every
    norm of an fp32 prefill, the cells' over their width included, is
    handed one, also when the chunk scan padded the tail."""
    from repro_torch.kernels import dispatch

    seen = []
    for name in ("rmsnorm", "add_rmsnorm"):
        orig = getattr(dispatch, name)
        monkeypatch.setattr(dispatch, name, lambda x, *a, _o=orig, **kw: (
            seen.append(x.is_contiguous()), _o(x, *a, **kw))[1])
    cfg = get_config(arch, smoke=True)
    model = model_lib.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(_rng("contig", arch).integers(0, cfg.vocab_size, (B, S)))
    model.prefill({"tokens": tokens}, model.init_cache(B, S + 1))
    assert len(seen) == sum(1 if k == "ffn" else 2 for k in cfg.blocks()) + 1
    assert all(seen)


# ---------------------------------------------------------------------------
# cache entries and their resets
# ---------------------------------------------------------------------------

# each block kind, from a smoke config that has it
KIND_ARCH = {"attn": NEMOTRON, "local_attn": "recurrentgemma-2b", "ffn": NEMOTRON,
             "rglru": "recurrentgemma-2b", "mlstm": NEMOTRON, "slstm": XLSTM}
ENTRY_CASES = [(k, "contiguous") for k in BLOCK_KINDS] + [("attn", "paged")]


def _entry(kind, layout, batch=3):
    arch = KIND_ARCH[kind]
    cfg, jcfg = get_config(arch, smoke=True), jax_config(arch, smoke=True)
    kw = dict(layout=layout, block_size=4, num_blocks=9)
    return (cache_lib.init_block_cache(cfg, kind, batch, 20, torch.float32, "cpu", **kw),
            jax_cache.init_block_cache(jcfg, kind, batch, 20, jnp.float32, **kw))


def _scribble(entry, seed):
    """Every leaf but the ring flag overwritten with garbage, in place."""
    gen = torch.Generator().manual_seed(seed)
    for leaf, t in entry.items():
        if leaf == "ring":
            continue
        if t.dtype.is_floating_point:
            t.copy_(torch.randn(t.shape, generator=gen) * 7)
        else:
            t.copy_(torch.randint(-1, 50, t.shape, generator=gen))


def _assert_same_entry(got, want):
    assert got.keys() == want.keys()
    for leaf in want:
        assert got[leaf].dtype == want[leaf].dtype, leaf
        assert torch.equal(got[leaf], want[leaf]), leaf


@pytest.mark.parametrize("kind,layout", ENTRY_CASES, ids=lambda v: str(v))
def test_init_block_cache_matches_reference(kind, layout):
    ours, ref = _entry(kind, layout)
    assert set(ours) == set(ref)
    for leaf, t in ours.items():
        want = np.asarray(ref[leaf])
        assert tuple(t.shape) == want.shape, leaf
        assert str(t.dtype).split(".")[-1] == want.dtype.name, leaf
        np.testing.assert_array_equal(t.numpy(), want, err_msg=leaf)
    if kind in ("mlstm", "slstm"):
        assert (ours["m"] == cache_lib.M_INIT).all() and cache_lib.M_INIT == -1e30


@pytest.mark.parametrize("kind,layout", ENTRY_CASES, ids=lambda v: str(v))
def test_reset_cache_and_rows_equal_fresh_entries(kind, layout):
    """``reset_cache`` returns a scribbled entry to ``init_block_cache``'s
    values leaf by leaf, in the same tensors; ``reset_rows`` does so for
    the rows named (pools belong to no row and are left alone) and leaves
    the others as they were."""
    fresh, _ = _entry(kind, layout)
    entry, _ = _entry(kind, layout)
    _scribble(entry, 0)
    ptrs = {leaf: t.data_ptr() for leaf, t in entry.items()}
    assert cache_lib.reset_cache([entry])[0] is entry
    _assert_same_entry(entry, fresh)
    assert {leaf: t.data_ptr() for leaf, t in entry.items()} == ptrs

    _scribble(entry, 1)
    before = {leaf: t.clone() for leaf, t in entry.items()}
    cache_lib.reset_rows([entry], torch.tensor([0, 2]))
    for leaf, t in entry.items():
        if leaf in ("kp", "vp") or t.dim() == 0:
            assert torch.equal(t, before[leaf]), leaf
            continue
        assert torch.equal(t[[0, 2]], fresh[leaf][[0, 2]]), leaf
        assert torch.equal(t[1], before[leaf][1]), leaf


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,groups", [(NEMOTRON, 2), (XLSTM, 6)])
def test_bridge_carries_the_cells_at_full_depth(arch, groups):
    """The full config's depth and pattern at narrow widths: every
    ``cell.*`` leaf of every group lands in its layer, and an xLSTM block
    has a norm and its cell only (no MLP)."""
    full = jax_config(arch)
    narrow = dict(d_model=32, num_heads=2, num_kv_heads=2, head_dim=16,
                  d_ff=64 if full.d_ff else 0, vocab_size=64, rec_heads=2,
                  dtype="float32", param_dtype="float32")
    jcfg = full.replace(**narrow)
    cfg = get_config(arch).replace(**narrow)
    assert jcfg.layer_groups() == (groups, 0) and cfg.num_layers == full.num_layers
    # the reference's tree from shapes alone, each leaf filled at random
    shapes = jax.eval_shape(lambda k: jax_model.init(jcfg, k)[0], jax.random.PRNGKey(1))
    rng = _rng("bridge", arch)
    tree = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = params_from_jax(cfg, tree, device="cpu")
    names = dict(model.named_parameters())
    plen = len(cfg.block_pattern)
    for i, kind in enumerate(cfg.blocks()):
        if kind not in ("mlstm", "slstm"):
            continue
        ref = tree["decoder"]["groups"][str(i % plen)]
        assert set(ref) == {"norm", "cell"}
        assert not any(n.startswith(f"layers.{i}.mlp") for n in names)
        for leaf, arr in ref["cell"].items():
            np.testing.assert_array_equal(names[f"layers.{i}.cell.{leaf}"].numpy(),
                                          arr[i // plen], err_msg=f"{i} {leaf}")
    leaves = {"mlstm": {"up_u", "up_z", "conv_w", "wq", "wk", "wv", "w_i", "b_i", "w_f",
                        "b_f", "norm_scale", "down"},
              "slstm": {f"{w}_{g}" for w in "wrb" for g in "zifo"} | {
                  "conv_w", "norm_scale", "ff_up", "ff_down"}}
    for kind in set(cfg.blocks()) & set(leaves):
        i = cfg.blocks().index(kind)
        assert {n.split(".")[-1] for n in names if n.startswith(f"layers.{i}.cell.")} \
            == leaves[kind]


def test_init_draws_the_reference_scales_and_biases():
    """The port's own init: forget biases the reference's linspace(3, 6)
    (per head for mLSTM, over d for sLSTM), input biases and norm scales
    0, gate weights at scale 0.01."""
    cfg = get_config(XLSTM, smoke=True)
    model = model_lib.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    mcell, scell = model.layers[0].cell, model.layers[7].cell
    H, d = cfg.resolved_rec_heads, cfg.d_model
    np.testing.assert_allclose(mcell.b_f.numpy(), np.asarray(jnp.linspace(3.0, 6.0, H)),
                               rtol=1e-6)
    np.testing.assert_allclose(scell.b_f.numpy(),
                               np.asarray(jnp.linspace(3.0, 6.0, d)).reshape(H, d // H),
                               rtol=1e-6)
    assert not mcell.b_i.any() and not scell.norm_scale.any() and not scell.b_z.any()
    assert 0.005 < float(mcell.w_i.std()) < 0.015


# ---------------------------------------------------------------------------
# the whole smoke models
# ---------------------------------------------------------------------------

def _assert_cache(cache, jcache, cfg):
    for i, entry in enumerate(cache):
        ref = _ref_layer(jcache, cfg, i)
        ref = ref.get("self", ref)  # attention sits under "self"
        assert set(entry) == set(ref), i
        for leaf, t in entry.items():
            if t.dtype in (torch.int32, torch.int64):
                np.testing.assert_array_equal(t.numpy(), np.asarray(ref[leaf]),
                                              err_msg=f"layer {i} {leaf}")
            else:
                _assert_close(t.numpy(), ref[leaf], err_msg=f"layer {i} {leaf}")


def _close_margin(logits: np.ndarray) -> bool:
    top2 = np.sort(logits, axis=-1)[:, -2:]
    tol = LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * np.abs(top2[:, 1])
    return bool(np.any(top2[:, 1] - top2[:, 0] <= tol))


@pytest.fixture(scope="module")
def jitted():
    """The reference's prefill, chunk and decode entry points, jitted once
    per arch for the module."""
    out = {}
    for arch in (NEMOTRON, XLSTM):
        jcfg = jax_config(arch, smoke=True)
        out[arch] = (
            jax.jit(lambda p, b, c, cfg=jcfg: jax_model.prefill(cfg, p, b, c)),
            jax.jit(lambda p, b, c, s, n, cfg=jcfg: jax_model.prefill_chunk(
                cfg, p, b, c, s, lengths=n)),
            jax.jit(lambda p, t, pos, c, cfg=jcfg: jax_model.decode_step(cfg, p, t, pos, c)))
    return out


@pytest.mark.parametrize("arch", [NEMOTRON, XLSTM])
def test_smoke_model_matches_reference(bridged, jitted, arch):
    """Prefill (24 tokens: one chunk of 16 and a padded one) and 12 greedy
    decode steps: logits, every cache leaf and the greedy stream."""
    jcfg, cfg, tree, model = bridged[arch]
    prefill, _, decode = jitted[arch]
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = _rng("prompt", arch).integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32)
    max_len = PROMPT + GEN + 1
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
            warnings.warn(f"{arch}: top-2 logits within tolerance at step {i}; "
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
    assert all(len(set(stream[:, b].tolist())) > 1 for b in range(B)), stream.T


@pytest.mark.parametrize("arch", [NEMOTRON, XLSTM])
def test_smoke_model_chunked_prefill_matches_reference(bridged, jitted, arch):
    """The prompt in chunks of 10 with ragged rows (the unified step's
    packing: row 1 ends early, then idles at length 0): the chunk logits of
    every row that has a token, and every cache leaf."""
    jcfg, cfg, tree, model = bridged[arch]
    _, chunk, _ = jitted[arch]
    jparams = jax.tree.map(jnp.asarray, tree)
    C = 10
    tokens = _rng("chunked", arch).integers(0, cfg.vocab_size, (B, 3 * C), dtype=np.int32)
    lengths = [(C, C), (C, 4), (C, 0)]
    jcache = jax_model.init_cache(jcfg, B, 3 * C + 1, jnp.float32)
    cache = model.init_cache(B, 3 * C + 1)
    for c, lens in enumerate(lengths):
        part = tokens[:, c * C:(c + 1) * C]
        n = np.asarray(lens, np.int32)
        start = np.asarray([c * C, c * C], np.int32)
        jlogits, jcache = chunk(jparams, {"tokens": jnp.asarray(part)}, jcache,
                                jnp.asarray(start), jnp.asarray(n))
        logits, cache = model.prefill_chunk(torch.from_numpy(part).long(), cache,
                                            torch.from_numpy(start),
                                            lengths=torch.from_numpy(n))
        has = n > 0
        np.testing.assert_allclose(logits.numpy()[has], np.asarray(jlogits)[has],
                                   **LOGITS_TOL)
        _assert_cache(cache, jcache, cfg)


@pytest.mark.parametrize("arch", [NEMOTRON, XLSTM])
def test_measured_loop_greedy_stream_matches_reference(bridged, jitted, arch):
    """The profiler's greedy loop (the one TTLT times, its cache reset
    between prompts) on the bridged weights equals the reference's
    prefill + decode steps, twice on one reset cache."""
    jcfg, cfg, tree, model = bridged[arch]
    prefill, _, decode = jitted[arch]
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = _rng("loop", arch).integers(0, cfg.vocab_size, (B, 10), dtype=np.int32)
    lp = LatencyProfiler(cfg, model, device="cpu")
    got = lp.greedy(torch.from_numpy(tokens).long(), 8).numpy()
    jcache = jax_model.init_cache(jcfg, B, 10 + 8 + 1, jnp.float32)
    logits, jcache = prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache)
    want = [np.asarray(jnp.argmax(logits, -1))]
    for i in range(8):
        tok = jnp.asarray(want[-1])[:, None].astype(jnp.int32)
        logits, jcache = decode(jparams, tok, jnp.asarray(10 + i, jnp.int32), jcache)
        want.append(np.asarray(jnp.argmax(logits, -1)))
    np.testing.assert_array_equal(got, np.stack(want, axis=1))
    other = _rng("loop2", arch).integers(0, cfg.vocab_size, (B, 10))
    lp.greedy(torch.from_numpy(other).long(), 8)
    np.testing.assert_array_equal(lp.greedy(torch.from_numpy(tokens).long(), 8).numpy(), got)
    assert len(lp.runners) == 1


@pytest.mark.parametrize("arch", [NEMOTRON, XLSTM])
def test_update_mask_freezes_the_cell_states(arch):
    cfg = get_config(arch, smoke=True)
    model = model_lib.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 20), generator=torch.Generator().manual_seed(1))
    cache = model.init_cache(2, 30)
    _, cache = model.prefill({"tokens": tokens}, cache)
    before = [{k: t.clone() for k, t in e.items()} for e in cache]
    model.decode_step(tokens[:, :1], 20, cache, update_mask=torch.tensor([True, False]))
    for kind, old, new in zip(cfg.blocks(), before, cache):
        if kind not in ("mlstm", "slstm"):
            continue
        for leaf in old:
            assert torch.equal(old[leaf][1], new[leaf][1]), (kind, leaf)
            assert not torch.equal(old[leaf][0], new[leaf][0]), (kind, leaf)


# ---------------------------------------------------------------------------
# ELANA's reports and the measured path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,gb", [(NEMOTRON, "16.38"), (XLSTM, "3.77")])
def test_size_report_matches_reference(arch, gb):
    ours, ref = Elana(arch, device="cpu").size_report(), JaxElana(arch).size_report()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert f"{gb} GB" in ours.fmt() and ours.by_component["decoder.cell"] > 0


@pytest.mark.parametrize("batch,seq_len", [(1, 1024), (128, 2048)])
@pytest.mark.parametrize("arch", [NEMOTRON, XLSTM])
def test_cache_report_matches_reference(arch, batch, seq_len):
    ours = Elana(arch, device="cpu").cache_report(batch, seq_len)
    assert dataclasses.asdict(ours) == dataclasses.asdict(JaxElana(arch).cache_report(
        batch, seq_len))
    assert ours.state_bytes > 0 and (ours.kv_bytes > 0) == (arch == NEMOTRON)


@pytest.mark.parametrize("arch", [NEMOTRON, XLSTM])
def test_allocated_cache_bytes_match_reference(arch):
    cfg = get_config(arch, smoke=True)
    ref = jax_model.init_cache(jax_config(arch, smoke=True), 3, 40, np.float32)
    assert cache_lib.cache_bytes(model_lib.Model(cfg, device="cpu").init_cache(3, 40)) == \
        jax_cache.cache_bytes(ref)


@pytest.mark.parametrize("arch", [NEMOTRON, XLSTM])
def test_measure_and_cli_run_on_the_cpu(capsys, arch):
    from repro_torch.cli import main

    out = Elana(arch, smoke=True, device="cpu").measure(batch=1, prompt_len=20, gen_len=4,
                                                        iters=2)
    assert set(out) == {"ttft_ms", "tpot_ms", "ttlt_ms", "ttft_p95_ms", "tpot_p95_ms"}
    assert all(np.isfinite(v) and v > 0 for v in out.values())
    assert main(["size", "--arch", arch, "--device", "cpu"]) == 0
    assert {NEMOTRON: "16.38 GB", XLSTM: "3.77 GB"}[arch] in capsys.readouterr().out
    assert main(["archs"]) == 0
    assert arch in capsys.readouterr().out.split("not ported yet:")[0]
