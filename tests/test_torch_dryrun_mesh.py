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
  ``serve_repl`` refused by name, and every per-device field filled.
"""

import dataclasses
import functools
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
from repro.sharding.rules import DEFAULT_RULES  # noqa: E402
from repro_torch.configs import ASSIGNED, SHAPES, get_config  # noqa: E402
from repro_torch.core import cost  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.sharding import partition, record  # noqa: E402
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


def reference_rank_bytes(arch, shape, dp, tp, pods):
    """The reference's per-device bytes of the cell's arguments by part, as
    ``repro/launch/dryrun.py:_build_cell`` shards them."""
    jcfg = jax_config(arch)
    mesh = reference_mesh(dp, tp, pods)
    shapes, axes = _param_axes(arch)
    specs = param_pspecs(axes, shapes, mesh, DEFAULT_RULES)
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
    ``opts``; ``serve_repl`` is refused by name, before anything runs."""
    shape = ShapeConfig("t", 16, 8, "train", 2)
    base = dryrun.run_cell("tinyllama-1.1b", shape, mesh=(2, 2), cfg=SMALL)
    grads = dryrun.run_cell("tinyllama-1.1b", shape, mesh=(2, 2), cfg=SMALL,
                            opts={"shard_grads"})
    assert grads["opts"] == ["shard_grads"] and base["opts"] == []
    for part in ("memory", "collectives", "cost"):
        assert grads[part] == base[part], part
    assert base["collectives"]["counts"]["reduce-scatter"] > 0
    assert any("shard_grads" in n for n in base["notes"])
    with pytest.raises(ValueError, match="serve_repl"):
        dryrun.run_cell("tinyllama-1.1b", "decode_32k", opts={"serve_repl"})


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
