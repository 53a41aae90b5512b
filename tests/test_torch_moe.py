"""The port's mixture of experts against the reference (fp32, the
reference's kernel tolerance 2e-5):

* ``capacity``, ``route``, ``apply_moe`` (with capacity pressure, where
  pairs are dropped and the kept positions are the stable sort's; with no
  drops; with a shared expert), ``apply_moe_blocked`` and
  ``aux_load_balance_loss`` on the same numpy-seeded inputs and params;
* the smoke models of qwen3-moe-30b-a3b and moonshot-v1-16b-a3b, their
  params from the reference's ``model.init`` through
  ``bridge.params_from_jax``: prefill and 4 decode steps, whole and in
  chunks, over a contiguous and a paged cache, logits against the
  reference's jitted ``prefill`` / ``prefill_chunk`` / ``decode_step``;
* ``init`` at the reference's scales (wg and wu at 1/sqrt(E));
* size (61.06 GB and 57.11 GB with the active split), cache, estimate,
  trace and report output equal to the reference's (shapes only).
"""

import dataclasses
import json
import math
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
from repro.models import model as jax_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch import cli  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.profiler import Elana  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402

QWEN, MOONSHOT = "qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b"
ARCHS = (QWEN, MOONSHOT)
TOL = dict(rtol=2e-5, atol=2e-5)   # fp32, tests/test_kernels.py
B, PROMPT, STEPS = 2, 12, 4
# the reference's layer, jitted (eager dispatch of its ops takes seconds)
jax_apply_moe = jax.jit(jax_moe.apply_moe, static_argnums=2)
jax_apply_moe_blocked = jax.jit(jax_moe.apply_moe_blocked, static_argnums=2)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _moe_params(cfg, seed):
    """A MoE layer's params as numpy arrays at the reference's scales."""
    rng = _rng("moe", seed)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p = {"router": normal(d, E, scale=1 / math.sqrt(d)),
         "wg": normal(E, d, ff, scale=1 / math.sqrt(E)),
         "wu": normal(E, d, ff, scale=1 / math.sqrt(E)),
         "wd": normal(E, ff, d, scale=1 / math.sqrt(ff))}
    if cfg.num_shared_experts:
        w = ff * cfg.num_shared_experts
        p["shared"] = {"wg": normal(d, w, scale=1 / math.sqrt(d)),
                       "wu": normal(d, w, scale=1 / math.sqrt(d)),
                       "wd": normal(w, d, scale=1 / math.sqrt(w))}
    return p


def _port_moe(cfg, params):
    layer = moe_lib.MoE(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for name, t in layer.named_parameters():
            arr = params
            for key in name.split("."):
                arr = arr[key]
            t.copy_(torch.from_numpy(arr))
    return layer


def _case(arch, T_shape, seed, **replace):
    jcfg = jax_config(arch, smoke=True).replace(**replace)
    cfg = get_config(arch, smoke=True).replace(**replace)
    params = _moe_params(cfg, seed)
    x = _rng("x", arch, T_shape, seed).standard_normal(T_shape).astype(np.float32)
    return jcfg, cfg, params, x


def _stable_positions(e_flat, E):
    """Each pair's position within its expert in flat order: the stable
    sort's, counted directly."""
    seen, out = np.zeros(E, np.int64), np.empty_like(e_flat)
    for i, e in enumerate(e_flat):
        out[i], seen[e] = seen[e], seen[e] + 1
    return out


@pytest.mark.parametrize("T,E,k,factor", [(1, 128, 8, 1.25), (8, 128, 8, 1.25),
                                          (512, 128, 8, 1.25), (2048, 128, 8, 1.25),
                                          (2048, 64, 6, 1.25), (3, 8, 2, 4.0),
                                          (1000, 8, 2, 0.5)])
def test_capacity_matches_reference(T, E, k, factor):
    assert moe_lib.capacity(T, E, k, factor) == jax_moe.capacity(T, E, k, factor)


@pytest.mark.parametrize("normalize", [True, False])
def test_route_matches_reference(normalize):
    logits = _rng("route").standard_normal((37, 16)).astype(np.float32) * 3
    w, idx = moe_lib.route(torch.from_numpy(logits), 4, normalize)
    jw, jidx = jax_moe.route(jnp.asarray(logits), 4, normalize)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **TOL)


# (arch, x shape, config changes): capacity pressure (8 experts top-2 at
# factor 0.5: C = 40 for 160 pairs over 8 experts, uneven routing drops),
# no drops (factor E / k: C >= T), a shared expert under pressure
MOE_CASES = {"pressure": (QWEN, (4, 40, 64), dict(moe_capacity_factor=0.5)),
             "no-drops": (QWEN, (2, 9, 64), dict(moe_capacity_factor=4.0)),
             "shared": (MOONSHOT, (3, 16, 64), dict(moe_capacity_factor=0.5))}


@pytest.mark.parametrize("name", list(MOE_CASES))
def test_apply_moe_matches_reference(name):
    arch, shape, replace = MOE_CASES[name]
    jcfg, cfg, params, x = _case(arch, shape, 0, **replace)
    layer = _port_moe(cfg, params)
    got = moe_lib.apply_moe(layer, torch.from_numpy(x), cfg).numpy()
    want = np.asarray(jax_apply_moe(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jcfg))
    np.testing.assert_allclose(got, want, **TOL)

    # the dispatch: positions are the stable sort's; drops where it says
    T = shape[0] * shape[1]
    xf = torch.from_numpy(x.reshape(T, -1))
    _, idx = moe_lib.route(moe_lib.router_logits(layer, xf), cfg.num_experts_per_tok)
    _, jidx = jax_moe.route(jnp.einsum("td,de->te", jnp.asarray(x.reshape(T, -1)),
                                       jnp.asarray(params["router"])),
                            cfg.num_experts_per_tok)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    e_flat = idx.reshape(-1)
    pos = moe_lib.positions_in_expert(e_flat, cfg.num_experts)
    np.testing.assert_array_equal(pos.numpy(), _stable_positions(e_flat.numpy(),
                                                                 cfg.num_experts))
    C = moe_lib.capacity(T, cfg.num_experts, cfg.num_experts_per_tok,
                         cfg.moe_capacity_factor)
    dropped = int((pos >= C).sum())
    if name == "no-drops":
        assert C >= T and dropped == 0
    else:
        assert dropped > 0, f"no pair dropped at C = {C}"


def test_apply_moe_blocked_matches_reference():
    """One block: the reference's blocked and plain functions; two blocks:
    the reference's ``apply_moe`` on each half of the tokens (each block
    with its own capacity)."""
    jcfg, cfg, params, x = _case(MOONSHOT, (4, 20, 64), 1, moe_capacity_factor=0.5)
    layer = _port_moe(cfg, params)
    jp = jax.tree.map(jnp.asarray, params)
    one = moe_lib.apply_moe_blocked(layer, torch.from_numpy(x), cfg, shards=1).numpy()
    np.testing.assert_allclose(one, np.asarray(jax_apply_moe_blocked(jp, jnp.asarray(x),
                                                                         jcfg)), **TOL)
    np.testing.assert_allclose(one, np.asarray(jax_apply_moe(jp, jnp.asarray(x), jcfg)),
                               **TOL)
    two = moe_lib.apply_moe_blocked(layer, torch.from_numpy(x), cfg, shards=2).numpy()
    halves = [np.asarray(jax_apply_moe(jp, jnp.asarray(h), jcfg)) for h in (x[:2], x[2:])]
    np.testing.assert_allclose(two, np.concatenate(halves), **TOL)
    assert np.abs(two - one).max() > 1e-3   # capacity per block drops other pairs
    # an uneven split falls back to one block, as the reference's does
    odd = moe_lib.apply_moe_blocked(layer, torch.from_numpy(x[:3]), cfg, shards=2).numpy()
    np.testing.assert_allclose(odd, np.asarray(jax_apply_moe(jp, jnp.asarray(x[:3]), jcfg)),
                               **TOL)


def test_aux_load_balance_loss_matches_reference():
    rng = _rng("aux")
    logits = rng.standard_normal((50, 8)).astype(np.float32) * 2
    idx = np.argsort(-logits, axis=-1)[:, :2]
    got = moe_lib.aux_load_balance_loss(torch.from_numpy(logits), torch.from_numpy(idx), 8)
    want = jax_moe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(idx), 8)
    np.testing.assert_allclose(got.item(), float(want), **TOL)


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bridged():
    """Per arch: (reference cfg, port cfg, the reference's init params as
    numpy, the port model the bridge builds from them, the reference's
    jitted prefill / chunk / decode)."""
    out = {}
    for arch in ARCHS:
        jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
        tree = jax.tree.map(np.asarray, jax.jit(
            lambda key, c=jcfg: jax_model.init(c, key)[0])(jax.random.PRNGKey(0)))
        jitted = (
            jax.jit(lambda p, b, c, bt, cfg=jcfg: jax_model.prefill(
                cfg, p, b, c, block_tables=bt)),
            jax.jit(lambda p, b, c, s, n, bt, cfg=jcfg: jax_model.prefill_chunk(
                cfg, p, b, c, s, lengths=n, block_tables=bt)),
            jax.jit(lambda p, t, pos, c, bt, cfg=jcfg: jax_model.decode_step(
                cfg, p, t, pos, c, block_tables=bt)))
        out[arch] = (jcfg, cfg, tree, params_from_jax(cfg, tree, device="cpu"), jitted)
    return out


def test_bridge_carries_every_moe_leaf(bridged):
    for arch in ARCHS:
        _, cfg, tree, model, _ = bridged[arch]
        names = {n for n, _ in model.named_parameters()}
        want = {"router", "wg", "wu", "wd"} | (
            {"shared.wg", "shared.wu", "shared.wd"} if cfg.num_shared_experts else set())
        for i in range(cfg.num_layers):
            assert {f"layers.{i}.mlp.{leaf}" for leaf in want} <= names
        np.testing.assert_array_equal(model.layers[1].mlp.wg.numpy(),
                                      tree["decoder"]["groups"]["0"]["mlp"]["wg"][1])


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_model_matches_reference(bridged, arch, layout, chunked):
    """Prefill of 12 tokens (whole, or in chunks of 5 with row 1 ragged)
    and 4 greedy decode steps: every step's logits."""
    jcfg, cfg, tree, model, (prefill, chunk, decode) = bridged[arch]
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = _rng("prompt", arch).integers(0, cfg.vocab_size, (B, PROMPT), dtype=np.int32)
    max_len = PROMPT + STEPS + 1
    kw, bt = {}, None
    if layout == "paged":
        kw = dict(layout="paged", block_size=4, num_blocks=12)
        bt = np.asarray([[3, 7, 1, 9, 5], [2, 10, 4, 8, 6]], np.int32)
    jbt = None if bt is None else jnp.asarray(bt)
    tbt = None if bt is None else torch.from_numpy(bt)
    jcache = jax_model.init_cache(jcfg, B, max_len, jnp.float32, **kw)
    cache = model.init_cache(B, max_len, **kw)
    if chunked:  # chunks of 5 with row 1 ragged: (5, 5), (5, 3), (2, 4) columns
        for starts, lens in (((0, 0), (5, 5)), ((5, 5), (5, 3)), ((10, 8), (2, 4))):
            part = np.zeros((B, max(lens)), np.int32)
            for b in range(B):
                part[b, :lens[b]] = tokens[b, starts[b]:starts[b] + lens[b]]
            s, n = np.asarray(starts, np.int32), np.asarray(lens, np.int32)
            jlogits, jcache = chunk(jparams, {"tokens": jnp.asarray(part)}, jcache,
                                    jnp.asarray(s), jnp.asarray(n), jbt)
            logits, cache = model.prefill_chunk(torch.from_numpy(part).long(), cache,
                                                torch.from_numpy(s), block_tables=tbt,
                                                lengths=torch.from_numpy(n))
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    else:
        jlogits, jcache = prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache, jbt)
        logits, cache = model.prefill({"tokens": torch.from_numpy(tokens).long()}, cache,
                                      block_tables=tbt)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(jlogits, -1))[:, None].astype(np.int32)
        jlogits, jcache = decode(jparams, jnp.asarray(tok), jnp.asarray(PROMPT + i, jnp.int32),
                                 jcache, jbt)
        logits, cache = model.decode_step(torch.from_numpy(tok).long(), PROMPT + i, cache,
                                          block_tables=tbt)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_init_draws_the_reference_scales():
    cfg = get_config(MOONSHOT, smoke=True).replace(num_experts=64, d_model=256, d_ff=128)
    model = model_lib.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    mlp = model.layers[0].mlp
    E, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    for t, scale in ((mlp.router, 1 / math.sqrt(d)), (mlp.wg, 1 / math.sqrt(E)),
                     (mlp.wu, 1 / math.sqrt(E)), (mlp.wd, 1 / math.sqrt(ff)),
                     (mlp.shared.wg, 1 / math.sqrt(d)),
                     (mlp.shared.wd, 1 / math.sqrt(ff * cfg.num_shared_experts))):
        assert abs(float(t.std()) / scale - 1) < 0.05, (t.shape, float(t.std()), scale)


def test_only_attention_blocks_take_experts():
    """ffn blocks keep the dense MLP in a MoE config, as the reference's
    ``_make_block``; so do an enc-dec model's encoder blocks (the
    reference's ``_enc_cfg``), while its decoder blocks take experts."""
    cfg = get_config(QWEN, smoke=True).replace(block_pattern=("attn", "ffn"))
    model = model_lib.Model(cfg, device="meta")
    assert isinstance(model.layers[0].mlp, moe_lib.MoE)
    assert not isinstance(model.layers[1].mlp, moe_lib.MoE)
    model = model_lib.Model(get_config(QWEN, smoke=True).replace(family="encdec",
                                                                 num_encoder_layers=1),
                            device="meta")
    assert isinstance(model.layers[0].mlp, moe_lib.MoE)
    assert not isinstance(model.encoder.layers[0].mlp, moe_lib.MoE)


# ---------------------------------------------------------------------------
# ELANA's reports, analytic (shapes only)
# ---------------------------------------------------------------------------

def _run(capsys, main, argv):
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("arch,gb,active", [(QWEN, "61.06", "3.353"),
                                            (MOONSHOT, "57.11", "4.469")])
def test_size_report_matches_reference(capsys, arch, gb, active):
    ours, ref = Elana(arch, device="cpu").size_report(), JaxElana(arch).size_report()
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    text = _run(capsys, cli.main, ["size", "--arch", arch, "--device", "cpu"])
    assert text == _run(capsys, jax_cli.main, ["size", "--arch", arch])
    assert f"({gb} GB, bfloat16)" in text and f"active params/token: {active} B" in text


def test_qwen_split_matches_the_reference_test():
    """The reference's own check (tests/test_core.py): active well under
    total, near 3.3 B."""
    rep = Elana(QWEN, device="cpu").size_report()
    assert rep.active_param_count < rep.param_count / 5
    assert 2.5e9 < rep.active_param_count < 4.5e9


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_estimate_print_the_reference_text(capsys, arch):
    for argv in (["cache", "--arch", arch, "--batch", "8", "--seq-len", "1024"],
                 ["estimate", "--arch", arch, "--hardware", "a6000"]):
        assert _run(capsys, cli.main, argv + ["--device", "cpu"]) == \
            _run(capsys, jax_cli.main, argv)


@pytest.mark.parametrize("arch,phase", [(QWEN, "decode"), (MOONSHOT, "prefill")])
def test_trace_prints_and_writes_the_reference_timeline(capsys, tmp_path, arch, phase):
    path = str(tmp_path / "trace.json")
    argv = ["trace", "--arch", arch, "--hardware", "a6000", "--phase", phase,
            "--seq-len", "512", "--out", path]
    ours = _run(capsys, cli.main, argv + ["--device", "cpu"])
    ours_file = open(path).read()
    assert ours == _run(capsys, jax_cli.main, argv)
    assert ours_file == open(path).read()
    names = {ev["name"] for ev in json.loads(ours_file)["traceEvents"]}
    assert any(n.endswith("/moe_experts") for n in names), sorted(names)[:20]


def test_report_and_archs_list_the_moe_models(capsys):
    argv = ["report", "--hardware", "a6000", "--archs", ",".join(ARCHS)]
    ours = _run(capsys, cli.main, argv + ["--device", "cpu"])
    assert ours == _run(capsys, jax_cli.main, argv)
    assert "left out" not in ours and all(a in ours for a in ARCHS)
    ported = _run(capsys, cli.main, ["archs"]).split("not ported yet:")[0]
    assert all(a in ported for a in ARCHS)
