"""The dry-run's per-device program on the production mesh
(``launch/dryrun.py:rank_arguments``, ``run_cell(mesh=)``,
``sharding/record.py``, ``core/cost.py:LiveBytes``) against the
reference's shardings, on the CPU and the meta device:

* (a) for every ``ASSIGNED`` x ``SHAPES`` cell that is not skipped, at
  16 x 16 and at the reference's (pod 2, data 16, model 16): rank 0's
  argument bytes (parameters, moments, cache, batch rows) equal, byte for
  byte, the shard bytes of the reference's ``param_pspecs`` under
  ``DEFAULT_RULES``, ``opt_state_shardings``, ``cache_shardings`` and
  ``batch_shardings`` on an ``AbstractMesh``.  Two leaves are left out by
  name: the reference's int32 step counters (the optimizer's ``count`` and
  the state's ``step``, which the port keeps as Python ints on the host)
  and the port's ``cross_pos`` (its cross memory's mask,
  ``core/cache.py``).  Nothing is compiled;
* (b) the reference's fallback of ``embed`` to the pod axis where the data
  axis of 32 does not divide it, on a config of d = 48: the rank's shapes,
  the axis it gathers over, and the dry-run's collectives on it;
* (c) the live-bytes tracker by hand on a chain of products, and K2's
  forward counted as its kernel allocates (its output, not the plain
  version's scores), K3's split workspace, K2's backward's plain VJP;
* (d) ``--opt shard_grads`` accepted and equal to the default,
  ``serve_repl`` counting train and prefill cells as without it and
  refusing the blocks it does not run by name, and every per-device field
  filled;
* (e) ``serve_repl``'s weight-stationary decode for every ``decode_32k``
  cell of the attention and dense-MLP families, at 16 x 16 and (pod 2,
  data 16, model 16): rank 0's argument bytes are the reference's under
  ``SERVE_RULES``, no collective moves a parameter, and the all-gathers
  fall from the FSDP decode's by at least the weights it gathers; the
  MoE and recurrent configs are refused by name; on the pod fallback
  (d = 48) the residual splits over the pods.
"""

import dataclasses
import functools
import json
import math

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.sharding.partition import batch_shardings, cache_shardings, param_pspecs  # noqa: E402
from repro.sharding.rules import DEFAULT_RULES, SERVE_RULES  # noqa: E402
from repro_torch.configs import ASSIGNED, SHAPES, get_config  # noqa: E402
from repro_torch.core import cost  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.sharding import partition, record, rules  # noqa: E402
from test_torch_sharded_train import reference_mesh, reference_train_shards  # noqa: E402
from test_torch_unified import one_thread  # noqa: E402,F401 (autouse)

MESHES = {"16x16": (16, 16, 1), "2x16x16": (32, 16, 2)}
CELLS = [(arch, name) for arch in ASSIGNED for name in SHAPES
         if not dryrun.should_skip(get_config(arch), SHAPES[name])]


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * jnp.dtype(dtype).itemsize


def _sharded_bytes(tree, shardings) -> int:
    return sum(_bytes(sh.shard_shape(s.shape), s.dtype)
               for s, sh in zip(jax.tree.leaves(tree), jax.tree.leaves(shardings)))


@functools.lru_cache(maxsize=None)
def _param_axes(arch):
    return jax_model.param_axes(jax_config(arch))


def reference_rank_bytes(arch, shape, dp, tp, pods, rules_=DEFAULT_RULES):
    """The reference's per-device bytes of the cell's arguments by part, as
    ``repro/launch/dryrun.py:_build_cell`` shards them (its parameters
    under ``rules_``)."""
    jcfg = jax_config(arch)
    mesh = reference_mesh(dp, tp, pods)
    shapes, axes = _param_axes(arch)
    specs = param_pspecs(axes, shapes, mesh, rules_)
    local = jax.tree.map(lambda sp, s: _bytes(NamedSharding(mesh, sp).shard_shape(s.shape),
                                              s.dtype),
                         specs, shapes, is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = {"params": sum(jax.tree.leaves(local)), "opt": 0, "cache": 0}
    if shape.kind == "train":
        # opt_state_shardings: mu and nu (fp32) shard like the parameters
        moments = jax.tree.map(lambda sp, s: 2 * _bytes(NamedSharding(mesh, sp).shard_shape(
            s.shape), jnp.float32), specs, shapes,
            is_leaf=lambda x: isinstance(x, PartitionSpec))
        out["opt"] = sum(jax.tree.leaves(moments))
    batch = dryrun_reference_specs(jcfg, shape)
    if shape.kind != "train":
        cache = jax.eval_shape(lambda: jax_model.init_cache(
            jcfg, shape.global_batch, shape.seq_len, jnp.dtype(jcfg.dtype)))
        out["cache"] = _sharded_bytes(cache, cache_shardings(cache, mesh))
    out["batch"] = _sharded_bytes(batch, batch_shardings(batch, mesh))
    return out


def dryrun_reference_specs(jcfg, shape):
    """The reference's ``input_specs`` of the cell without its cache (its
    module sets ``XLA_FLAGS`` on import: the batch keys are rebuilt here,
    held to it by ``tests/test_torch_dryrun.py``)."""
    B, S = shape.global_batch, shape.seq_len
    dt = jnp.dtype(jcfg.dtype)
    sds = jax.ShapeDtypeStruct
    if shape.kind == "decode":
        return {"token": sds((B, 1), jnp.int32), "positions": sds((B,), jnp.int32)}
    tok_len, batch = S, {}
    if jcfg.num_vision_tokens:
        tok_len = S - jcfg.num_vision_tokens
        batch["vision_embeds"] = sds((B, jcfg.num_vision_tokens, jcfg.d_model), dt)
    if jcfg.is_encdec:
        tok_len = S // 2
        batch["enc_embeds"] = sds((B, S // 2, jcfg.d_model), dt)
    batch["tokens"] = sds((B, tok_len), jnp.int32)
    if shape.kind == "train":
        batch["labels"] = sds((B, tok_len), jnp.int32)
    return batch


def _port_shape(arch, name, dp):
    """The cell's shape as ``run_cell`` takes it (a train cell's
    microbatches capped by the data axis; they do not move the bytes)."""
    shape = SHAPES[name]
    if shape.kind == "train":
        mb = dryrun.TRAIN_MICROBATCHES.get(arch, dryrun.TRAIN_MICROBATCHES["default"])
        shape = dataclasses.replace(shape, microbatches=min(mb, shape.global_batch // dp))
    return shape


# -- (a) rank 0's arguments against the reference's shardings ----------------------------

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,name", CELLS)
def test_rank_argument_bytes_are_the_reference_shardings(arch, name, mesh):
    """Parameters, moments, cache and batch rows of rank 0, built on meta
    without a weight drawn, byte for byte the reference's per-device
    shards of the same cell (its step counters and the port's memory mask
    left out by name)."""
    dp, tp, pods = MESHES[mesh]
    cfg, shape = get_config(arch), _port_shape(arch, name, dp)
    args = dryrun.rank_arguments(cfg, shape, (pods, dp // pods, tp) if pods > 1 else (dp, tp))
    assert all(t.device.type == "meta" for t in args.model.parameters())
    got = dict(args.bytes)
    if args.cache is not None:  # the port's cross memory mask: no reference leaf
        got["cache"] -= sum(e["cross_pos"].numel() * e["cross_pos"].element_size()
                            for e in args.cache if "cross_pos" in e)
    assert got == reference_rank_bytes(arch, shape, dp, tp, pods)


# -- (b) the pod fallback ---------------------------------------------------------------------

POD_CFG = get_config("tinyllama-1.1b", smoke=True).replace(d_model=48)


def test_embed_falls_back_to_the_pod_axis():
    """d = 48 at (pod 2, data 16, model 16): 32 does not divide it, so each
    ``embed`` dim splits over the two pods only (24 a rank), as the
    reference's ``logical_to_pspec`` falls back to the first of ``("pod",
    "data")`` that divides the dim; at d = 64 the whole data axis does.
    FSDP then gathers those leaves over ``pod``: the dry-run's collectives
    say so, and the argument bytes equal the reference's."""
    jcfg = jax_config("tinyllama-1.1b", smoke=True).replace(d_model=48)
    rec = record.RecordingMesh((32, 16), pods=2)
    model = partition._rank_model(POD_CFG, rec)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == reference_train_shards(POD_CFG, jcfg, 32, 16, pods=2)
    assert got["layers.0.attn.wq"][0] == 24 and got["embed.table"][1] == 24
    assert model.placement.data_axis("layers.0.attn.wq") is rec.pod
    assert model.placement.data_replicas("layers.0.attn.wq") == 16
    wide = partition._rank_model(get_config("tinyllama-1.1b", smoke=True), rec)
    assert wide.layers[0].attn.wq.shape[0] == 2          # 64 / 32: the data axis
    shape = ShapeConfig("pod", 16, 64, "train", 1)
    res = dryrun.run_cell("tinyllama-1.1b", shape, mesh=(2, 16, 16), cfg=POD_CFG)
    by_axis = res["collectives"]["bytes_by_axis_perdev"]
    assert by_axis["pod"] > 0 and by_axis["data"] > 0    # gathers on pod, sums on data
    bytes_ = res["memory"]["argument_bytes_by_part"]
    shapes, axes = jax_model.param_axes(jcfg)
    mesh = reference_mesh(32, 16, 2)
    specs = param_pspecs(axes, shapes, mesh, DEFAULT_RULES)
    local = [(NamedSharding(mesh, sp).shard_shape(s.shape), s.dtype) for sp, s in zip(
        jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec)),
        jax.tree.leaves(shapes))]
    assert bytes_["params"] == sum(_bytes(sh, dt) for sh, dt in local)
    assert bytes_["opt"] == sum(2 * _bytes(sh, jnp.float32) for sh, _ in local)


# -- (c) the live-bytes tracker -------------------------------------------------------------

def _meta(*shape, grad=False):
    return torch.empty(shape, device="meta", requires_grad=grad)


def test_tracker_counts_a_chain_of_products_by_hand():
    """(x @ w).relu() @ w2 on (4, 8) x (8, 16) x (16, 8) fp32: x @ w (256
    B) and its relu (256 B) are live together, then the relu and the
    output (128 B): the peak is 512 B beyond the arguments, the output 128
    B; views count nothing; the arguments are not counted."""
    x, w, w2 = _meta(4, 8), _meta(8, 16), _meta(16, 8)
    s = cost.summarize_call(lambda x, w, w2: (x @ w).relu() @ w2, x, w, w2, track=True)
    assert (s.temp_bytes, s.output_bytes) == (512, 128)
    s = cost.summarize_call(lambda x: x.view(8, 4).t()[:2], x, track=True)
    assert s.temp_bytes == 0
    s = cost.summarize_call(lambda x: x.add_(1.0), x, track=True)
    assert s.temp_bytes == 0


def test_tracker_counts_a_kernel_as_the_card_allocates():
    """K2's plain forward builds fp32 (B, Hq, S, T) scores (64 KiB here),
    which ``flash_attention.cu`` never allocates: through the dispatch
    its forward counts its output alone (16 KiB).  K3 with a split plan
    counts its output and its fp32 workspace; K2's backward counts its
    plain VJP, scores included."""
    B, S, Hq, Hkv, D = 1, 64, 4, 2, 16
    q, k, v = _meta(B, S, Hq, D), _meta(B, S, Hkv, D), _meta(B, S, Hkv, D)
    pos = torch.zeros((B, S), dtype=torch.int32, device="meta")
    out_bytes = B * S * Hq * D * 4
    kw = dict(q_positions=pos, k_positions=pos, causal=True)
    s = cost.summarize_call(lambda q, k, v: dispatch.flash_attention(q, k, v, **kw), q, k, v,
                            track=True)
    assert s.temp_bytes == out_bytes
    from repro_torch.kernels.flash_attention import ref as flash_ref
    plain = cost.summarize_call(lambda q, k, v: flash_ref.plain_attention(q, k, v, **kw),
                                q, k, v, track=True)
    assert plain.temp_bytes >= B * Hq * S * S * 4 > out_bytes

    L, rows = 4096, 2
    qd, kc = _meta(rows, 1, Hq, D), _meta(rows, L, Hkv, D)
    qp = torch.zeros((rows, 1), dtype=torch.int32, device="meta")
    kp = torch.zeros((rows, L), dtype=torch.int32, device="meta")
    from repro_torch.kernels.decode_attention import ops as decode_ops
    work = decode_ops.workspace_bytes(rows, Hq, Hkv, L, D, cost.CARD_SMS)
    assert work > 0
    s = cost.summarize_call(lambda q, k: dispatch.decode_attention(
        q, k, k, q_positions=qp, k_positions=kp), qd, kc, track=True)
    assert s.temp_bytes == rows * Hq * D * 4 + work

    qg, kg, vg = _meta(B, S, Hq, D, grad=True), _meta(B, S, Hkv, D, grad=True), \
        _meta(B, S, Hkv, D, grad=True)

    def fwd_bwd(q, k, v):
        y = dispatch.flash_attention(q, k, v, **kw)
        return torch.autograd.grad(y.sum(), (q, k, v))

    s = cost.summarize_call(fwd_bwd, qg, kg, vg, track=True)
    assert s.temp_bytes >= B * Hq * S * S * 4 + out_bytes


# -- (d) the options and the filled fields ----------------------------------------------

SMALL = get_config("tinyllama-1.1b", smoke=True)


def test_shard_grads_is_the_default_program_and_serve_repl_is_refused():
    """``shard_grads`` counts the one program the port runs (its FSDP
    always reduce-scatters), so its result equals the default's but for
    ``opts``; so does ``serve_repl`` on a train and a prefill cell, as the
    reference's serve rules change only a decode cell's step.
    ``serve_repl`` is refused by name, before anything runs, for a config
    with a block the serve rules do not run."""
    for kind in ("train", "prefill"):
        shape = ShapeConfig("t", 16, 8, kind, 2 if kind == "train" else 1)
        base = dryrun.run_cell("tinyllama-1.1b", shape, mesh=(2, 2), cfg=SMALL)
        for opt in ("shard_grads", "serve_repl"):
            other = dryrun.run_cell("tinyllama-1.1b", shape, mesh=(2, 2), cfg=SMALL,
                                    opts={opt})
            assert other["opts"] == [opt] and base["opts"] == []
            for part in ("memory", "collectives", "cost"):
                assert other[part] == base[part], (kind, opt, part)
        if kind == "train":
            assert base["collectives"]["counts"]["reduce-scatter"] > 0
    assert any("shard_grads" in n for n in base["notes"])
    assert any("serve_repl" in n for n in base["notes"])
    decode = ShapeConfig("d", 16, 8, "decode")
    fsdp = dryrun.run_cell("tinyllama-1.1b", decode, mesh=(2, 2), cfg=SMALL)
    repl = dryrun.run_cell("tinyllama-1.1b", decode, mesh=(2, 2), cfg=SMALL,
                           opts={"serve_repl"})
    assert repl["cost"]["flops_global"] == fsdp["cost"]["flops_global"]
    assert (repl["collectives"]["bytes_by_kind_perdev_once"]["all-gather"]
            < fsdp["collectives"]["bytes_by_kind_perdev_once"]["all-gather"])
    with pytest.raises(ValueError, match="serve_repl.*item 4d"):
        dryrun.run_cell("qwen3-moe-30b-a3b", "decode_32k", opts={"serve_repl"})


@pytest.mark.parametrize("mesh", [(2, 2), (2, 2, 2)])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_every_per_device_field_is_filled(kind, mesh):
    """Every per-device key of the reference's result is a number: the
    memory (peak = arguments + temp), the rank's FLOPs, the collectives
    by kind (once = corrected), and the collective term over the H100's
    18 x 25 GB/s; the bound is the largest term."""
    res = dryrun.run_cell("tinyllama-1.1b", ShapeConfig("s", 16, 8, kind, 1), mesh=mesh,
                          cfg=SMALL)
    mem, coll, r = res["memory"], res["collectives"], res["roofline"]
    assert res["mesh"] == "x".join(map(str, mesh)) and res["chips"] == math.prod(mesh)
    assert mem["peak_bytes_estimate"] == (mem["argument_bytes_per_device"]
                                          + mem["temp_bytes_per_device"])
    assert all(isinstance(v, int) and v > 0 for k, v in mem.items() if k.endswith("device"))
    assert res["cost"]["flops_perdev_corrected"] > 0
    assert coll["bytes_perdev_once"] == coll["bytes_perdev_corrected"] == sum(
        coll["bytes_by_kind_perdev_once"].values()) > 0
    assert set(coll["counts"]) == set(coll["bytes_by_kind_perdev_once"])
    assert r["link_bw"] == 25e9 * 18
    assert r["collective_term_s"] == coll["bytes_perdev_corrected"] / r["link_bw"]
    assert r["memory_term_s"] == mem["argument_bytes_per_device"] / 3.35e12
    terms = {k: r[f"{k}_term_s"] for k in ("compute", "memory", "collective")}
    assert r["bound_s"] == max(terms.values()) and r["dominant"] == max(terms, key=terms.get)


# -- (e) the weight-stationary decode (serve_repl) -------------------------------------

SERVE_ARCHS = ["minitron-4b", "tinyllama-1.1b", "qwen1.5-0.5b", "command-r-plus-104b",
               "llava-next-34b", "seamless-m4t-large-v2"]
REFUSED = {"qwen3-moe-30b-a3b": "moe", "moonshot-v1-16b-a3b": "moe",
           "recurrentgemma-2b": "rglru", "xlstm-1.3b": "mlstm, slstm",
           "nemotron-h-8b": "mlstm"}


def _mesh_arg(mesh):
    dp, tp, pods = MESHES[mesh]
    return (pods, dp // pods, tp) if pods > 1 else (dp, tp)


@functools.lru_cache(maxsize=None)
def _decode_steps(arch, mesh):
    """Rank 0's ``decode_32k`` step on ``mesh``, counted on meta under the
    serve rules and under FSDP alone: (the serve step's arguments, its
    collectives one by one, the FSDP step's arguments, its summary)."""
    cfg, shape = get_config(arch), SHAPES["decode_32k"]
    with rules.use_serve_rules():
        args, _, _ = dryrun.count_rank_step(cfg, shape, _mesh_arg(mesh))
    fsdp, _, summary = dryrun.count_rank_step(cfg, shape, _mesh_arg(mesh))
    return args, list(args.mesh.log.entries), fsdp, summary


def test_serve_archs_are_the_assigned_attention_and_dense_mlp_families():
    """The six ``ASSIGNED`` architectures ``serve_repl`` runs; the other four
    are refused."""
    ran = []
    for arch in ASSIGNED:
        try:
            rules.check_serve(get_config(arch))
            ran.append(arch)
        except rules.ServeRefusal:
            assert arch in REFUSED
    assert sorted(ran) == sorted(SERVE_ARCHS)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_repl_rank_arguments_are_the_reference_serve_shardings(arch, mesh):
    """A weight-stationary decode cell's rank-0 arguments, byte for byte the
    reference's ``param_pspecs`` under ``SERVE_RULES`` (``DEFAULT_RULES``'
    parameter rules, and the norm scales' ``act_embed`` over data),
    ``cache_shardings`` and the token's and positions' ``batch_shardings``.
    On the mesh of pods the norm scales split over pod x data (32), as the
    residual stream and the weights do, where the reference's bare
    ``"data"`` splits them over 16: a named divergence of half a slice
    each."""
    dp, tp, pods = MESHES[mesh]
    args = _decode_steps(arch, mesh)[0]
    got = dict(args.bytes)
    got["cache"] -= sum(e["cross_pos"].numel() * e["cross_pos"].element_size()
                        for e in args.cache if "cross_pos" in e)
    scales = [p for name, p in args.model.named_parameters() if name.endswith("norm1.scale")
              or name.endswith("norm2.scale") or name.endswith("norm_c.scale")
              or name.endswith("norm.scale")]
    assert all(p.shape[0] == get_config(arch).d_model // dp for p in scales)
    if pods > 1:  # the reference's slices of 16 are twice the port's of 32
        got["params"] += sum(p.numel() * p.element_size() for p in scales)
    assert got == reference_rank_bytes(arch, SHAPES["decode_32k"], dp, tp, pods, SERVE_RULES)


def _split_cache_gather(cfg, mesh) -> int:
    """The bytes of one L-sharded K/V entry's gather (0: model divides the
    KV heads): the rank's rows of k and v over every slot."""
    dp, tp, _ = MESHES[mesh]
    if cfg.num_kv_heads % tp == 0:
        return 0
    shape = SHAPES["decode_32k"]
    rows = shape.global_batch // dp if shape.global_batch % dp == 0 else shape.global_batch
    return 2 * rows * shape.seq_len * cfg.num_kv_heads * cfg.resolved_head_dim * 2


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_repl_moves_no_parameter(arch, mesh):
    """No collective of the weight-stationary step moves a parameter: each
    moves at most B x the step's widest activation x 4 bytes, but for an
    L-sharded cache's gather; the data axis gathers only the inputs (once)
    and each attention's outputs, the model axis only the logits and those
    caches."""
    cfg = get_config(arch)
    _, entries, _, _ = _decode_steps(arch, mesh)
    hd = cfg.resolved_head_dim
    widest = max(cfg.vocab_size, cfg.d_ff, cfg.d_model,
                 (cfg.num_heads + 2 * cfg.num_kv_heads) * hd)
    bound = SHAPES["decode_32k"].global_batch * widest * 4
    cache = _split_cache_gather(cfg, mesh)
    for axis, kind, n in entries:
        assert n <= bound or (axis, kind, n) == ("model", "all-gather", cache), (axis, kind, n)
    gathers = [(axis, n) for axis, kind, n in entries if kind == "all-gather"]
    attns = sum(k in ("attn", "local_attn") for k in cfg.blocks()) * (2 if cfg.is_encdec else 1)
    assert sum(axis == "data" for axis, _ in gathers) == 1 + attns
    split = sum(n == cache for axis, n in gathers if axis == "model") if cache else 0
    assert split == (cfg.num_layers if cache else 0)
    vocab = cfg.vocab_size % MESHES[mesh][1] == 0  # the logits gathered over model
    assert sum(axis == "model" for axis, _ in gathers) == split + vocab


def _gathers(entries):
    """All-gather bytes of a collective log's entries by axis."""
    out = {"data": 0, "model": 0}
    for axis, kind, n in entries:
        if kind == "all-gather":
            out[axis] += n
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serve_repl_drops_the_weight_gathers(arch, mesh):
    """The FSDP decode gathers every data-sharded weight's model shard over
    data each step (a tied table twice; an encoder's none); the weight-stationary step
    gathers none: over data only the inputs (B x 2 int32) and each
    attention's outputs (B x its heads x hd), over model what FSDP does
    but the whole batch's logits where FSDP gathers the rank's rows.  So
    its all-gathers fall by the weights' bytes less those activations."""
    cfg = get_config(arch)
    dp, tp, _ = MESHES[mesh]
    B = SHAPES["decode_32k"].global_batch
    _, serve, fsdp, _ = _decode_steps(arch, mesh)
    placement = fsdp.model.placement
    params = dict(fsdp.model.named_parameters())

    def whole(name):  # a leaf's model shard, as FSDP gathers it
        leaf = placement.leaves[name]
        return math.prod(rules.local_shape(leaf.shape, leaf.model_dim, tp)) * \
            params[name].element_size()

    weights = sum(whole(n) for n, leaf in placement.leaves.items()  # the encoder's: no decode
                  if leaf.data_dim is not None and not n.startswith("encoder."))
    again = whole("embed.table") if cfg.tie_embeddings else 0  # the head's gather
    fsdp = list(fsdp.mesh.log.entries)
    before, after = _gathers(fsdp), _gathers(serve)
    assert before["data"] == weights + again > 0
    heads = cfg.num_heads // tp if cfg.num_heads % tp == 0 else cfg.num_heads
    attns = sum(k in ("attn", "local_attn") for k in cfg.blocks()) * (2 if cfg.is_encdec else 1)
    itemsize = torch.empty(0, dtype=getattr(torch, cfg.dtype)).element_size()
    assert after["data"] == B * 2 * 4 + attns * B * heads * cfg.resolved_head_dim * itemsize
    logits = (B - B // dp) * cfg.vocab_size * 4 if cfg.vocab_size % tp == 0 else 0
    assert after["model"] == before["model"] + logits
    assert sum(before.values()) - sum(after.values()) == (
        weights + again - after["data"] - logits)


@pytest.mark.parametrize("arch", list(REFUSED))
def test_serve_repl_refuses_moe_and_recurrent_blocks_by_name(arch):
    """A config with a MoE, RG-LRU, mLSTM or sLSTM block is refused under
    ``serve_repl`` with a ``ValueError`` naming the block kinds and ROADMAP
    item 4d, on every kind of cell."""
    for shape in ("decode_32k", "prefill_32k"):
        with pytest.raises(ValueError, match=f"its {REFUSED[arch]} block.*item 4d"):
            dryrun.run_cell(arch, shape, opts={"serve_repl"})


def test_serve_repl_sweep_skips_the_refused_cells(tmp_path, monkeypatch, capsys):
    """``--all --opt serve_repl`` records a refused config's cells as
    skipped with the refusal's reason and goes on (exit 0)."""
    monkeypatch.setattr(dryrun, "ASSIGNED", ["qwen3-moe-30b-a3b", "xlstm-1.3b"])
    assert dryrun.main(["--all", "--shapes", "decode_32k,train_4k", "--opt", "serve_repl",
                        "--out-dir", str(tmp_path)]) == 0
    for arch in ("qwen3-moe-30b-a3b", "xlstm-1.3b"):
        for shape in ("decode_32k", "train_4k"):
            res = json.loads((tmp_path / f"{arch}__{shape}__16x16__opt-serve_repl.json")
                             .read_text())
            assert res["status"] == "skipped" and "item 4d" in res["reason"]
    assert "4 cells" in capsys.readouterr().out


def test_serve_repl_on_the_pod_fallback_splits_the_residual_over_the_pods():
    """d = 48 at (pod 2, data 16, model 16): only the pods divide the
    weights' ``embed`` dim, so the residual stream splits over ``pod``
    (its sums all-reduced there, none on ``data``); at d = 64 over
    ``data``."""
    shape = ShapeConfig("pod", 16, 64, "decode")
    for cfg, axis, other in ((POD_CFG, "pod", "data"), (SMALL, "data", "pod")):
        res = dryrun.run_cell("tinyllama-1.1b", shape, mesh=(2, 16, 16), cfg=cfg,
                              opts={"serve_repl"})
        counted = res["collectives"]["by_axis_kind_perdev"]
        assert f"{axis} all-reduce" in counted and f"{other} all-reduce" not in counted
        assert counted["data all-gather"][0] == 1 + cfg.num_layers
