"""The port's encoder-decoder family against the reference:
seamless-m4t-large-v2, smoke config, fp32 on the CPU.

The reference's ``model.init`` params are bridged into the port
(``encoder.groups`` and each decoder block's ``norm_c``/``cross``
included).  Held to the reference:

* the encoder's output (``_encode`` against the reference's encoder
  stack);
* one block's cross attention alone, over a prompt (K2 without the causal
  mask) and in a decode step over a memory of 272 rows of which 256 are
  filled (K3), against the reference's over exactly the 256;
* prefill logits, whole and in chunks (the encoder run again with each
  chunk, as the reference does), over a contiguous and a paged cache,
  then decode steps whose memory holds fewer rows than the cache has;
* 8-token greedy streams through the model and through ``Elana.measure``'s
  decode loop (``LatencyProfiler.greedy``) against the reference's
  ``prefill`` + ``decode_step`` loop;
* size, cache, estimate and trace text for the full config, and the cache
  report byte for byte with ``cross_pos`` left out.

The reference's serving engine cannot serve an encoder-decoder model;
one test pins that, and the port's engine refuses the model.
Tolerance: fp32 sums in another order, 1e-5 relative to the largest
value compared (``_close``; the perturbed norms make logits of ~50).
"""

import dataclasses
import zlib

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import cli as jax_cli  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.profiler import Elana as JaxElana  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro_torch import cli  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.latency import LatencyProfiler  # noqa: E402
from repro_torch.core.profiler import Elana  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402

from test_torch_unified import one_thread, shared_jax_compiles  # noqa: E402,F401 (autouse)

ARCH = "seamless-m4t-large-v2"
B, PROMPT, STEPS, GEN = 2, 16, 4, 8
ENC = PROMPT // 2  # frames, as the profiler draws them
TOL = 1e-5


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _close(got, want):
    """fp32 against fp32: within ``TOL`` of the largest value compared."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(want).max())))


def _embeds(seed, b, n, d):
    return (0.1 * np.random.default_rng(seed).standard_normal((b, n, d))).astype(np.float32)


def _reference_params(jcfg):
    """The reference's ``model.init`` params (numpy) with the tied
    embedding table shrunk (x0.05) and the norm scales perturbed (N(0,
    2^2)), so that greedy streams depend on the blocks and the memory, not
    on the input token alone (``test_torch_xlstm._reference_params``)."""
    params = jax.jit(lambda key: jax_model.init(jcfg, key)[0])(jax.random.PRNGKey(0))
    rng = _rng("params")

    def perturb(path, a):
        a = np.array(a)
        if str(getattr(path[-1], "key", "")) == "scale":
            a = a + 2.0 * rng.standard_normal(a.shape).astype(a.dtype)
        return a

    tree = jax.tree_util.tree_map_with_path(perturb, params)
    tree["embed"]["table"] *= 0.05
    return tree


@pytest.fixture(scope="module")
def bridged():
    """(reference cfg, port cfg, reference params, the bridged port model,
    the reference's jitted prefill / chunk / decode / encoder)."""
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    tree = _reference_params(jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_jax(cfg, tree, device="cpu")
    enc_cfg = jax_model._enc_cfg(jcfg)
    jitted = dict(
        prefill=jax.jit(lambda p, b, c, bt: jax_model.prefill(jcfg, p, b, c, block_tables=bt)),
        chunk=jax.jit(lambda p, b, c, s, bt: jax_model.prefill_chunk(
            jcfg, p, b, c, s, block_tables=bt)),
        decode=jax.jit(lambda p, t, pos, c, bt: jax_model.decode_step(
            jcfg, p, t, pos, c, block_tables=bt)),
        encode=jax.jit(lambda p, x: jax_model._apply_stack_seq(
            p["encoder"], enc_cfg, x, jnp.broadcast_to(jnp.arange(x.shape[1])[None],
                                                       x.shape[:2]),
            None, None, causal=False, remat=False)[0]))
    return jcfg, cfg, params, model, jitted


def test_bridge_carries_the_encoder_and_cross_leaves(bridged):
    jcfg, cfg, params, model, _ = bridged
    names = {n for n, _ in model.named_parameters()}
    for i in range(cfg.num_encoder_layers):
        assert {f"encoder.layers.{i}.attn.wq", f"encoder.layers.{i}.mlp.wd"} <= names
    for i in range(cfg.num_layers):
        assert {f"layers.{i}.norm_c.scale", f"layers.{i}.cross.wq",
                f"layers.{i}.cross.wo"} <= names
    assert not any(n.startswith(f"layers.{i}.cross.b") for n in names)
    np.testing.assert_array_equal(model.encoder.layers[1].attn.wk.numpy(),
                                  np.asarray(params["encoder"]["groups"]["0"]["attn"]["wk"][1]))
    np.testing.assert_array_equal(model.layers[0].cross.wv.numpy(),
                                  np.asarray(params["decoder"]["groups"]["0"]["cross"]["wv"][0]))


def test_encoder_memory_matches_reference(bridged):
    jcfg, _, params, model, jitted = bridged
    x = _embeds(1, B, 24, jcfg.d_model)
    memory, frames = model._encode(torch.from_numpy(x))
    _close(memory.numpy(), jitted["encode"](params, x))
    assert frames.tolist() == [list(range(24))] * B


def test_cross_attention_matches_reference(bridged):
    """One block's cross attention over a memory of 256 rows: for a prompt
    (K2's plain version, no causal mask) and for one decode step over an
    entry of 272 memory rows, the last 16 masked (K3's plain version),
    against the reference's ``sdpa`` over the 256 rows."""
    jcfg, cfg, params, model, _ = bridged
    p, jp = model.layers[1].cross, jax.tree.map(
        lambda a: a[1], params["decoder"]["groups"]["0"]["cross"])
    T, rows, S = 256, 272, 12
    memory = _embeds(2, B, T, cfg.d_model) * 10
    x = _embeds(3, B, S, cfg.d_model) * 10
    mem_kv = jax_attn.precompute_cross_kv(jp, jnp.asarray(memory), jcfg)
    want = np.asarray(jax_attn.apply_cross_attention(jp, jnp.asarray(x), jcfg, mem_kv))
    entry = cache_lib.init_cross_cache(B, 2 * rows + 1, cfg.num_kv_heads,
                                       cfg.resolved_head_dim, torch.float32, "cpu")
    assert entry["cross_k"].shape[1] == rows
    positions = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    frames = torch.arange(T, dtype=torch.int32).expand(B, T).contiguous()
    got = attn_lib.apply_cross_attention_seq(p, torch.from_numpy(x), positions,
                                             torch.from_numpy(memory), frames, entry)
    _close(got.numpy(), want)
    assert entry["cross_pos"][:, :T].eq(0).all() and entry["cross_pos"][:, T:].eq(-1).all()
    _close(entry["cross_k"][:, :T].numpy(), np.asarray(mem_kv[0]))
    got = attn_lib.apply_cross_attention_decode(
        p, torch.from_numpy(x[:, -1:]), torch.tensor([300, 7], dtype=torch.int32), entry)
    _close(got.numpy(), want[:, -1:])


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_smoke_model_matches_reference(bridged, layout, chunked):
    """Prefill of 16 tokens with 8 frames (whole, or in chunks of 8 with
    the frames passed to each) and 4 greedy decode steps: every step's
    logits.  The cache's memory holds 10 rows, the reference's the
    prompt's 8."""
    jcfg, cfg, params, model, jitted = bridged
    tokens = _rng("prompt", layout).integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32)
    enc = _embeds(4, B, ENC, cfg.d_model)
    max_len = PROMPT + STEPS + 1
    kw, bt = {}, None
    if layout == "paged":
        kw = dict(layout="paged", block_size=4, num_blocks=12)
        bt = np.asarray([[3, 7, 1, 9, 5, 11], [2, 10, 4, 8, 6, 0]], np.int32)
    jbt = None if bt is None else jnp.asarray(bt)
    tbt = None if bt is None else torch.from_numpy(bt)
    jcache = jax_model.init_cache(jcfg, B, max_len, jnp.float32, **kw)
    cache = model.init_cache(B, max_len, **kw)
    assert cache[0]["cross_k"].shape[1] == max_len // 2 > ENC
    if chunked:
        for start in range(0, PROMPT, 8):
            part = tokens[:, start:start + 8]
            jlogits, jcache = jitted["chunk"](params, {"tokens": jnp.asarray(part),
                                                       "enc_embeds": jnp.asarray(enc)},
                                              jcache, jnp.asarray(start, jnp.int32), jbt)
            logits, cache = model.prefill_chunk(torch.from_numpy(part).long(), cache, start,
                                                block_tables=tbt,
                                                enc_embeds=torch.from_numpy(enc))
    else:
        jlogits, jcache = jitted["prefill"](params, {"tokens": jnp.asarray(tokens),
                                                     "enc_embeds": jnp.asarray(enc)},
                                            jcache, jbt)
        logits, cache = model.prefill({"tokens": torch.from_numpy(tokens).long(),
                                       "enc_embeds": torch.from_numpy(enc)}, cache,
                                      block_tables=tbt)
    _close(logits.numpy(), np.asarray(jlogits))
    assert jcache["groups"]["0"]["cross_k"].shape[2] == ENC
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        jlogits, jcache = jitted["decode"](params, jnp.asarray(tok),
                                           jnp.asarray(PROMPT + i, jnp.int32), jcache, jbt)
        logits, cache = model.decode_step(torch.from_numpy(tok).long(), PROMPT + i, cache,
                                          block_tables=tbt)
        _close(logits.numpy(), np.asarray(jlogits))


def _reference_greedy(bridged, tokens, enc):
    """The reference's ``prefill`` + ``decode_step`` loop, GEN steps."""
    jcfg, _, params, _, jitted = bridged
    b, s = tokens.shape
    jcache = jax_model.init_cache(jcfg, b, s + GEN + 1, jnp.float32)
    logits, jcache = jitted["prefill"](params, {"tokens": jnp.asarray(tokens),
                                                "enc_embeds": jnp.asarray(enc)}, jcache, None)
    out = [np.asarray(jnp.argmax(logits, -1))]
    for i in range(GEN):
        logits, jcache = jitted["decode"](params, jnp.asarray(out[-1][:, None]),
                                          jnp.asarray(s + i, jnp.int32), jcache, None)
        out.append(np.asarray(jnp.argmax(logits, -1)))
    return np.stack(out, axis=1)


def test_greedy_streams_match_reference(bridged):
    """8 greedy tokens after the prompt's pick, through the model's own loop
    and through ``Elana.measure``'s decode loop."""
    _, cfg, _, model, _ = bridged
    tokens = _rng("greedy").integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32)
    enc = _embeds(5, B, ENC, cfg.d_model)
    want = _reference_greedy(bridged, tokens, enc)
    assert len(set(want.ravel().tolist())) > 3, want
    cache = model.init_cache(B, PROMPT + GEN + 1)
    logits, _ = model.prefill({"tokens": torch.from_numpy(tokens).long(),
                               "enc_embeds": torch.from_numpy(enc)}, cache)
    out = [logits.argmax(-1)]
    for i in range(GEN):
        logits, _ = model.decode_step(out[-1][:, None], PROMPT + i, cache)
        out.append(logits.argmax(-1))
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(), want)
    lp = LatencyProfiler(cfg, model, device="cpu")
    got = lp.greedy(torch.from_numpy(tokens).long(), GEN, enc_embeds=torch.from_numpy(enc))
    np.testing.assert_array_equal(got.numpy(), want)


def test_measure_draws_frames_and_runs():
    e = Elana(ARCH, smoke=True, device="cpu")
    batch = e._latency_profiler()._random_batch(2, 9)
    assert batch["tokens"].shape == (2, 9) and batch["enc_embeds"].shape == (2, 4, 64)
    assert 0.05 < float(batch["enc_embeds"].std()) < 0.2
    m = e.measure(batch=1, prompt_len=9, gen_len=4, iters=2)
    assert all(v > 0 for v in m.values()), m


def test_cache_entries_reset_the_memory():
    cfg = get_config(ARCH, smoke=True)
    model = Elana(ARCH, smoke=True, device="cpu").model
    cache = model.init_cache(3, 20)
    assert set(cache[0]) == {"k", "v", "pos", "ring", "cross_k", "cross_v", "cross_pos"}
    assert cache[0]["cross_k"].shape == (3, 10, cfg.num_kv_heads, cfg.resolved_head_dim)
    for entry in cache:
        cache_lib.fill_cross_cache(entry, torch.ones(3, 6, 4, 16), torch.ones(3, 6, 4, 16))
    cache_lib.reset_rows(cache, torch.tensor([1]))
    assert cache[1]["cross_pos"][1].eq(-1).all() and cache[1]["cross_k"][1].eq(0).all()
    assert cache[1]["cross_pos"][0, :6].eq(0).all() and cache[1]["cross_k"][2].eq(1).any()
    cache_lib.reset_cache(cache)
    assert all(e["cross_pos"].eq(-1).all() and e["cross_v"].eq(0).all() for e in cache)
    with pytest.raises(ValueError, match="does not fit"):
        cache_lib.fill_cross_cache(cache[0], torch.ones(3, 11, 4, 16), torch.ones(3, 11, 4, 16))


def test_engine_refuses_encdec_and_the_reference_engine_cannot_serve_it():
    """The reference's engine sizes the cross memory at max_len // 2, the
    prefill replaces it with the prompt's plen // 2 rows, and the merge
    into the slots fails; the port's engine refuses the model outright."""
    jcfg = jax_config(ARCH, smoke=True)
    params = jax.jit(lambda key: jax_model.init(jcfg, key)[0])(jax.random.PRNGKey(0))
    jeng = JaxServingEngine(jcfg, params, max_batch=2, max_len=64, prompt_bucket=8)
    jeng.submit(np.arange(1, 9, dtype=np.int32))
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        jeng.run()
    model = Elana(ARCH, smoke=True, device="cpu").model
    with pytest.raises(ValueError, match="cannot serve"):
        ServingEngine(model, max_batch=2, max_len=64, prompt_bucket=8, device="cpu")


def _run(capsys, main, argv):
    assert main(argv) == 0
    return capsys.readouterr().out


def test_reports_print_the_reference_text(capsys, tmp_path):
    """size (1.370 B, 2.74 GB), cache, estimate and trace of the full
    config."""
    ours, ref = Elana(ARCH, device="cpu").size_report(), JaxElana(ARCH).size_report()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    text = _run(capsys, cli.main, ["size", "--arch", ARCH, "--device", "cpu"])
    assert text == _run(capsys, jax_cli.main, ["size", "--arch", ARCH])
    assert "params: 1.370 B (2.74 GB, bfloat16)" in text and "encoder.attn" in text
    for argv in (["cache", "--arch", ARCH, "--batch", "8", "--seq-len", "1024"],
                 ["estimate", "--arch", ARCH, "--hardware", "a6000"]):
        assert _run(capsys, cli.main, argv + ["--device", "cpu"]) == \
            _run(capsys, jax_cli.main, argv)
    for phase in ("prefill", "decode"):
        path = str(tmp_path / f"{phase}.json")
        argv = ["trace", "--arch", ARCH, "--hardware", "a6000", "--phase", phase, "--out", path]
        ours = _run(capsys, cli.main, argv + ["--device", "cpu"])
        ours_file = open(path).read()
        assert ours == _run(capsys, jax_cli.main, argv) and ours_file == open(path).read()
    ours = Elana(ARCH, device="cpu").cache_report(4, 545)
    assert dataclasses.asdict(ours) == dataclasses.asdict(JaxElana(ARCH).cache_report(4, 545))
    assert ours.cross_bytes == 24 * 2 * 4 * 272 * 16 * 64 * 2
