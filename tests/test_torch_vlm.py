"""The port's vision-prefix family against the reference: llava-next-34b,
smoke config (4 patch embeddings before the tokens), fp32 on the CPU.

The reference's ``model.init`` params (tied table shrunk, norm scales
perturbed, as ``test_torch_encdec.py`` does) are bridged into the port.
Held to the reference:

* prefill logits, whole and in chunks (the patches with the first chunk,
  later starts past them), over a contiguous and a paged cache, then
  decode steps at positions nv + prompt + i;
* 8-token greedy streams through the model and through
  ``Elana.measure``'s decode loop (``LatencyProfiler.greedy``) against the
  reference's ``prefill`` + ``decode_step`` loop at nv + prompt + i;
* the serving engine's greedy streams, whole-prompt and chunked, over a
  contiguous and a paged cache, against that same reference loop over
  each request's bucketed prompt with zero patches, as the engines pass
  them;
* size, cache, estimate and trace text for the full config.

Two findings about the reference are pinned: its engine decodes a vision
request from position ``plen``, not nv + plen (its stream is the
reference loop's at plen + i), and its profiler keeps one token when a
prompt is no longer than the patches, which the port refuses.
Tolerance: ``test_torch_encdec._close``, 1e-5 relative to the largest
value compared.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import cli as jax_cli  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.latency import LatencyProfiler as JaxLatencyProfiler  # noqa: E402
from repro.core.profiler import Elana as JaxElana  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.serving.engine import ServingEngine as JaxServingEngine  # noqa: E402
from repro.serving.sampling import SamplingParams as JaxSamplingParams  # noqa: E402
from repro_torch import cli  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.latency import LatencyProfiler  # noqa: E402
from repro_torch.core.profiler import Elana  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

from test_torch_encdec import _close, _embeds, _reference_params, _rng, _run  # noqa: E402
from test_torch_unified import (_drive, _trace, one_thread,  # noqa: E402,F401 (autouse)
                                shared_jax_compiles)

ARCH = "llava-next-34b"
NV = 4  # the smoke config's patches
B, PROMPT, STEPS, GEN = 2, 12, 4, 8
ENGINE = dict(max_batch=2, max_len=64, prompt_bucket=8)


@pytest.fixture(scope="module")
def bridged():
    """(reference cfg, port cfg, reference params, the bridged port model,
    the reference's jitted prefill / chunk / decode)."""
    jcfg, cfg = jax_config(ARCH, smoke=True), get_config(ARCH, smoke=True)
    assert cfg.num_vision_tokens == NV
    tree = _reference_params(jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_jax(cfg, tree, device="cpu")
    jitted = dict(
        prefill=jax.jit(lambda p, b, c, bt: jax_model.prefill(jcfg, p, b, c, block_tables=bt)),
        chunk=jax.jit(lambda p, b, c, s, bt: jax_model.prefill_chunk(
            jcfg, p, b, c, s, block_tables=bt)),
        decode=jax.jit(lambda p, t, pos, c, bt: jax_model.decode_step(
            jcfg, p, t, pos, c, block_tables=bt)))
    return jcfg, cfg, params, model, jitted


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_smoke_model_matches_reference(bridged, layout, chunked):
    """Prefill of 4 patches and 12 tokens (whole, or in chunks of 6 tokens,
    the patches with the first) and 4 greedy decode steps at nv + 12 + i:
    every step's logits."""
    jcfg, cfg, params, model, jitted = bridged
    tokens = _rng("prompt", layout).integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32)
    vision = _embeds(6, B, NV, cfg.d_model)
    max_len = NV + PROMPT + STEPS + 1
    kw, bt = {}, None
    if layout == "paged":
        kw = dict(layout="paged", block_size=4, num_blocks=14)
        bt = np.asarray([[3, 7, 1, 9, 5, 11], [2, 10, 4, 8, 6, 12]], np.int32)
    jbt = None if bt is None else jnp.asarray(bt)
    tbt = None if bt is None else torch.from_numpy(bt)
    jcache = jax_model.init_cache(jcfg, B, max_len, jnp.float32, **kw)
    cache = model.init_cache(B, max_len, **kw)
    if chunked:
        for i in range(0, PROMPT, 6):
            part, batch, start = tokens[:, i:i + 6], {}, i + NV
            if i == 0:
                batch, start = {"vision_embeds": jnp.asarray(vision)}, 0
            jlogits, jcache = jitted["chunk"](params, {"tokens": jnp.asarray(part), **batch},
                                              jcache, jnp.asarray(start, jnp.int32), jbt)
            logits, cache = model.prefill_chunk(
                torch.from_numpy(part).long(), cache, start, block_tables=tbt,
                vision_embeds=torch.from_numpy(vision) if i == 0 else None)
    else:
        jlogits, jcache = jitted["prefill"](params, {"tokens": jnp.asarray(tokens),
                                                     "vision_embeds": jnp.asarray(vision)},
                                            jcache, jbt)
        logits, cache = model.prefill({"tokens": torch.from_numpy(tokens).long(),
                                       "vision_embeds": torch.from_numpy(vision)}, cache,
                                      block_tables=tbt)
    _close(logits.numpy(), np.asarray(jlogits))
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        pos = NV + PROMPT + i
        jlogits, jcache = jitted["decode"](params, jnp.asarray(tok), jnp.asarray(pos, jnp.int32),
                                           jcache, jbt)
        logits, cache = model.decode_step(torch.from_numpy(tok).long(), pos, cache,
                                          block_tables=tbt)
        _close(logits.numpy(), np.asarray(jlogits))


def _reference_greedy(bridged, tokens, vision, gen=GEN, offset=NV):
    """The reference's ``prefill`` + ``decode_step`` loop, decoding at
    ``offset`` + prompt + i (the model's convention is offset = nv)."""
    jcfg, _, params, _, jitted = bridged
    b, s = tokens.shape
    jcache = jax_model.init_cache(jcfg, b, NV + s + gen + 1, jnp.float32)
    logits, jcache = jitted["prefill"](params, {"tokens": jnp.asarray(tokens),
                                                "vision_embeds": jnp.asarray(vision)},
                                       jcache, None)
    out = [np.asarray(jnp.argmax(logits, -1))]
    for i in range(gen):
        logits, jcache = jitted["decode"](params, jnp.asarray(out[-1][:, None]),
                                          jnp.asarray(offset + s + i, jnp.int32), jcache, None)
        out.append(np.asarray(jnp.argmax(logits, -1)))
    return np.stack(out, axis=1)


def test_greedy_streams_match_reference(bridged):
    """8 greedy tokens after the prompt's pick, through the model's own loop
    and through ``Elana.measure``'s decode loop, which starts at nv +
    prompt."""
    _, cfg, _, model, _ = bridged
    tokens = _rng("greedy").integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32)
    vision = _embeds(7, B, NV, cfg.d_model)
    want = _reference_greedy(bridged, tokens, vision)
    assert len(set(want.ravel().tolist())) > 3, want
    batch = {"tokens": torch.from_numpy(tokens).long(), "vision_embeds": torch.from_numpy(vision)}
    cache = model.init_cache(B, NV + PROMPT + GEN + 1)
    logits, _ = model.prefill(batch, cache)
    out = [logits.argmax(-1)]
    for i in range(GEN):
        logits, _ = model.decode_step(out[-1][:, None], NV + PROMPT + i, cache)
        out.append(logits.argmax(-1))
    np.testing.assert_array_equal(torch.stack(out, 1).numpy(), want)
    lp = LatencyProfiler(cfg, model, device="cpu")
    got = lp.greedy(batch["tokens"], GEN, vision_embeds=batch["vision_embeds"])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (NV + PROMPT + GEN + 1) in {max_len for _, max_len in lp.runners}


def _padded(prompt, plen):
    """The engine's bucketed row: left zero padding, the newest tokens."""
    row = np.zeros(plen, np.int32)
    use = prompt[-plen:]
    row[plen - len(use):] = use
    return row


ENGINE_RUNS = [(layout, chunk) for layout in ("contiguous", "paged") for chunk in (0, 8)]


@pytest.mark.parametrize("layout,chunk", ENGINE_RUNS,
                         ids=[f"{la}-{'chunked' if c else 'whole'}" for la, c in ENGINE_RUNS])
def test_engine_streams_match_the_reference_loop(bridged, layout, chunk):
    """Six greedy requests (prompts 2..48, two slots) through the port's
    engine: each stream is the reference's model-level loop over the
    request's bucketed prompt and zero patches, decoding at nv + bucket
    + i.  Chunked admission runs the per-chunk path (chunks of 8, the
    patches with the first), never the unified step."""
    jcfg, cfg, _, model, _ = bridged
    arrivals = _trace(workload, cfg.vocab_size)
    eng = ServingEngine(model, **ENGINE, cache_layout=layout, prefill_chunk=chunk, device="cpu")
    assert not eng.unified
    got = _drive(eng, arrivals)
    assert len(got) == 6 and eng.blocks_in_use == 0
    for uid, a in enumerate(arrivals):
        row = _padded(a.prompt, eng._bucketed(len(a.prompt)))[None]
        n = a.params.max_new_tokens
        want = _reference_greedy(bridged, row, np.zeros((1, NV, cfg.d_model), np.float32),
                                 gen=n - 1)[0]
        assert got[uid] == want.tolist(), (uid, got[uid], want)
    if chunk:
        assert eng.chunk_forwards > len(arrivals) and eng.decode_forwards > 0


def test_reference_engine_decodes_vision_requests_at_plen(bridged):
    """The reference's engine starts decode at the prompt's length, so its
    greedy stream is the reference loop's at plen + i, not at nv + plen +
    i, where the port's engine decodes."""
    jcfg, cfg, params, model, _ = bridged
    prompt = _rng("finding 2").integers(1, cfg.vocab_size, 8, dtype=np.int32)
    jeng = JaxServingEngine(jcfg, params, **ENGINE)
    jeng.submit(prompt, JaxSamplingParams(max_new_tokens=6, temperature=0.0))
    ref_stream = list(jeng.run()[0].output_tokens)
    zeros = np.zeros((1, NV, cfg.d_model), np.float32)
    assert ref_stream == _reference_greedy(bridged, prompt[None], zeros, gen=5, offset=0)[0].tolist()
    port = _reference_greedy(bridged, prompt[None], zeros, gen=5)[0].tolist()
    assert ref_stream != port
    eng = ServingEngine(model, **ENGINE, device="cpu")
    assert _drive(eng, [jax_workload.Arrival(0.0, prompt, jeng.finished[0].params)]) == {0: port}


def test_engine_needs_room_after_the_vision_prefix(bridged):
    """A max_len of nv + 1 leaves no prompt token and decode position after
    the patches and is refused at construction; nv + 2 serves a one-token
    bucket and its one greedy token."""
    _, cfg, _, model, _ = bridged
    kw = dict(ENGINE, cache_layout="paged")
    with pytest.raises(ValueError, match="vision prefix"):
        ServingEngine(model, **dict(kw, max_len=NV + 1), device="cpu")
    eng = ServingEngine(model, **dict(kw, max_len=NV + 2), device="cpu")
    prompt = _rng("room").integers(1, cfg.vocab_size, 3, dtype=np.int32)
    got = _drive(eng, [workload.Arrival(0.0, prompt, SamplingParams(max_new_tokens=4,
                                                                     temperature=0.0))])
    want = _reference_greedy(bridged, prompt[None, -1:], np.zeros((1, NV, cfg.d_model),
                                                                  np.float32), gen=0)[0]
    assert eng._bucketed(len(prompt)) == 1 and got == {0: want.tolist()}


def test_vision_prompt_must_exceed_the_patches(bridged):
    """The reference's profiler keeps one token when the prompt is no longer
    than the patches (its prefill then fills nv + 1 positions of a
    prompt + 1 cache); the port's refuses."""
    jcfg, cfg, params, model, _ = bridged
    assert JaxLatencyProfiler(jcfg, params)._random_batch(1, NV)["tokens"].shape == (1, 1)
    lp = LatencyProfiler(cfg, model, device="cpu")
    with pytest.raises(ValueError, match="no token"):
        lp._random_batch(1, NV)
    batch = lp._random_batch(2, NV + 3)
    assert batch["tokens"].shape == (2, 3) and batch["vision_embeds"].shape == (2, NV, 64)
    m = Elana(ARCH, smoke=True, device="cpu").measure(batch=1, prompt_len=NV + 5, gen_len=4,
                                                      iters=2)
    assert all(v > 0 for v in m.values()), m


@pytest.mark.parametrize("kw", [dict(speculative="lookup"), dict(pad_side="right"),
                                dict(cache_layout="paged", preemption="recompute"),
                                dict(cache_layout="paged", prefix_cache=True)],
                         ids=["speculative", "right-pad", "preemption", "prefix-cache"])
def test_engine_refuses_what_the_reference_refuses(bridged, kw):
    with pytest.raises(ValueError, match="vision prefix"):
        ServingEngine(bridged[3], **ENGINE, **kw, device="cpu")


def test_reports_print_the_reference_text(capsys, tmp_path):
    """size (34.389 B, 68.78 GB), cache, estimate and trace of the full
    config."""
    ours, ref = Elana(ARCH, device="cpu").size_report(), JaxElana(ARCH).size_report()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    text = _run(capsys, cli.main, ["size", "--arch", ARCH, "--device", "cpu"])
    assert text == _run(capsys, jax_cli.main, ["size", "--arch", ARCH])
    assert "params: 34.389 B (68.78 GB, bfloat16)" in text
    for argv in (["cache", "--arch", ARCH, "--batch", "8", "--seq-len", "2048"],
                 ["estimate", "--arch", ARCH, "--hardware", "a6000"]):
        assert _run(capsys, cli.main, argv + ["--device", "cpu"]) == \
            _run(capsys, jax_cli.main, argv)
    for phase in ("prefill", "decode"):
        path = str(tmp_path / f"{phase}.json")
        argv = ["trace", "--arch", ARCH, "--hardware", "a6000", "--phase", phase, "--out", path]
        ours = _run(capsys, cli.main, argv + ["--device", "cpu"])
        ours_file = open(path).read()
        assert ours == _run(capsys, jax_cli.main, argv) and ours_file == open(path).read()
