"""The port's dense decoder against the reference model.

The reference's ``model.init`` params, with numpy noise on the norm scales
and the QKV biases (zeros at init) so that every parameter matters, are
bridged into the port.  Both sides run in fp32 on the CPU: prefill
logits, the cache leaves and 16-step greedy streams must agree, once with
the reference's kernels in their jnp form (``xla``) and once through the
Pallas kernels in interpret mode.
"""

import warnings

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402

# llama (GQA), qwen1.5 (QKV bias, MHA: G=1), minitron (relu2, non-gated
# MLP), command-r-plus (parallel attention/MLP block)
ARCHS = ["llama3.1-8b", "qwen1.5-0.5b", "minitron-4b", "command-r-plus-104b"]
B, PROMPT, GEN = 2, 12, 16
# fp32 on both sides; the sums run in another order, ~1e-6 relative
LOGITS_TOL = dict(rtol=1e-5, atol=1e-4)


def _reference_params(cfg, seed=0):
    params, _ = jax_model.init(cfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        arr = np.asarray(leaf)
        if str(getattr(path[-1], "key", "")) in ("scale", "bq", "bk", "bv"):
            arr = arr + 0.1 * rng.standard_normal(arr.shape).astype(arr.dtype)
        return arr

    return jax.tree_util.tree_map_with_path(perturb, params)


def _close_margin(logits: np.ndarray) -> bool:
    """True if some row's top-2 logits are closer than the tolerance, so a
    greedy pick could flip on rounding alone."""
    top2 = np.sort(logits, axis=-1)[:, -2:]
    tol = LOGITS_TOL["atol"] + LOGITS_TOL["rtol"] * np.abs(top2[:, 1])
    return bool(np.any(top2[:, 1] - top2[:, 0] <= tol))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_reference(arch, backend):
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    tree = _reference_params(jcfg)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = params_from_jax(cfg, tree, device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32)
    max_len = PROMPT + GEN + 1

    with jax_dispatch.use_backend(backend, interpret=backend == "pallas"):
        prefill = jax.jit(lambda p, b, c: jax_model.prefill(jcfg, p, b, c))
        decode = jax.jit(lambda p, t, pos, c: jax_model.decode_step(jcfg, p, t, pos, c))
        jcache = jax_model.init_cache(jcfg, B, max_len, jnp.float32)
        jlogits, jcache = prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache)
        j_steps = [np.asarray(jlogits)]
        tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        for i in range(GEN):
            jlogits, jcache_end = decode(jparams, tok, jnp.asarray(PROMPT + i, jnp.int32),
                                         jcache if i == 0 else jcache_end)
            j_steps.append(np.asarray(jlogits))
            tok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)

    cache = model.init_cache(B, max_len)
    logits, cache = model.prefill({"tokens": torch.from_numpy(tokens).long()}, cache)
    np.testing.assert_allclose(logits.numpy(), j_steps[0], **LOGITS_TOL)
    for i, entry in enumerate(cache):   # the cache right after prefill
        ref = {leaf: np.asarray(jcache["groups"]["0"]["self"][leaf][i])
               for leaf in ("k", "v", "pos")}
        np.testing.assert_allclose(entry["k"].numpy(), ref["k"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(entry["v"].numpy(), ref["v"], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(entry["pos"].numpy(), ref["pos"])

    stream, j_stream = [], []
    for i in range(GEN):
        if _close_margin(j_steps[i]):
            warnings.warn(f"{arch}/{backend}: top-2 logits within tolerance at step "
                          f"{i}; streams compared up to it")
            break
        tok = logits.argmax(-1, keepdim=True)
        stream.append(tok[:, 0].numpy())
        j_stream.append(j_steps[i].argmax(-1))
        logits, cache = model.decode_step(tok, PROMPT + i, cache)
        np.testing.assert_allclose(logits.numpy(), j_steps[i + 1], **LOGITS_TOL)
    else:
        for i, entry in enumerate(cache):   # the cache after GEN decode steps
            np.testing.assert_array_equal(
                entry["pos"].numpy(), np.asarray(jcache_end["groups"]["0"]["self"]["pos"][i]))
            np.testing.assert_allclose(
                entry["k"].numpy(), np.asarray(jcache_end["groups"]["0"]["self"]["k"][i]),
                rtol=1e-5, atol=1e-5)
    assert len(stream) > GEN // 2, f"{arch}: only {len(stream)} decisive steps"
    np.testing.assert_array_equal(np.stack(stream), np.stack(j_stream))


def test_bridge_rejects_a_mismatched_tree():
    jcfg, cfg = jax_config("llama3.2-1b", smoke=True), get_config("llama3.2-1b", smoke=True)
    tree = _reference_params(jcfg)
    del tree["decoder"]["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_jax(cfg, tree, device="cpu")
    tree = _reference_params(jcfg)
    tree["embed"]["table"] = tree["embed"]["table"][:, :-1]
    with pytest.raises(ValueError, match="embed.table"):
        params_from_jax(cfg, tree, device="cpu")


def test_bridge_keeps_bf16_bits():
    """bf16 leaves cross through a uint16 view, bit for bit."""
    jcfg = jax_config("tinyllama-1.1b", smoke=True).replace(
        dtype="bfloat16", param_dtype="bfloat16")
    cfg = get_config("tinyllama-1.1b", smoke=True).replace(
        dtype="bfloat16", param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jax_model.init(jcfg, jax.random.PRNGKey(3))[0])
    model = params_from_jax(cfg, tree, device="cpu")
    wq = model.layers[1].attn.wq
    assert wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(wq.view(torch.int16).numpy().view(np.uint16),
                                  tree["decoder"]["groups"]["0"]["attn"]["wq"][1].view(np.uint16))


def test_init_is_seeded_at_reference_scales():
    cfg = get_config("llama3.2-1b", smoke=True)
    a = model_lib.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    b = model_lib.init(cfg, torch.Generator().manual_seed(5), device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    d, hd = cfg.d_model, cfg.resolved_head_dim
    assert abs(a.layers[0].attn.wq.std().item() * d ** 0.5 - 1) < 0.1
    assert abs(a.layers[0].attn.wo.std().item() * (cfg.num_heads * hd) ** 0.5 - 1) < 0.1
    assert abs(a.layers[0].mlp.wd.std().item() * cfg.d_ff ** 0.5 - 1) < 0.1
    assert abs(a.embed.table.std().item() - 1) < 0.1
    assert torch.all(a.final_norm.scale == 0)


def test_update_mask_freezes_masked_rows():
    cfg = get_config("qwen2.5-1.5b", smoke=True)
    model = model_lib.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    cache = model.init_cache(2, 10)
    _, cache = model.prefill({"tokens": tokens}, cache)
    before = [{k: t.clone() for k, t in e.items()} for e in cache]
    model.decode_step(tokens[:, :1], 6, cache, update_mask=torch.tensor([True, False]))
    for old, new in zip(before, cache):
        assert torch.equal(old["k"][1], new["k"][1]) and torch.equal(old["pos"][1], new["pos"][1])
        assert new["pos"][0, 6] == 6 and not torch.equal(old["k"][0], new["k"][0])


@pytest.mark.parametrize("arch,fused_per_layer", [
    ("llama3.1-8b", 2), ("command-r-plus-104b", 1), ("recurrentgemma-2b", 2)])
def test_norms_fold_the_residual_add(arch, fused_per_layer, monkeypatch):
    """Every norm after the first block's first one takes the pending
    residual add with it: 2 fused calls a layer (1 for a parallel block,
    whose ``x + a`` stays a plain add), the final norm among them, and one
    plain norm, per prefill and per decode step."""
    from repro_torch.kernels import dispatch

    calls = {"rmsnorm": 0, "add_rmsnorm": 0}
    for name in calls:
        def counted(*a, _fn=getattr(dispatch, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(dispatch, name, counted)
    cfg = get_config(arch, smoke=True)
    model = model_lib.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    L = len(cfg.blocks())
    tokens = torch.randint(0, cfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    cache = model.init_cache(2, 10)
    logits, cache = model.prefill({"tokens": tokens}, cache)
    assert calls == {"rmsnorm": 1, "add_rmsnorm": fused_per_layer * L}
    model.decode_step(logits.argmax(-1, keepdim=True), 6, cache)
    assert calls == {"rmsnorm": 2, "add_rmsnorm": 2 * fused_per_layer * L}


def test_unported_blocks_raise():
    from repro_torch.configs import get_config as port_config

    with pytest.raises(KeyError, match="not ported"):
        port_config("xlstm-1.3b")
    cfg = get_config("llama3.2-1b", smoke=True).replace(block_pattern=("mlstm",))
    with pytest.raises(NotImplementedError):
        model_lib.Model(cfg, device="meta")
