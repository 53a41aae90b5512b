"""The port's dry-run (``launch/dryrun.py``, ``core/cost.py``) against the
reference's ``repro/launch/dryrun.py``:

* ``SHAPES``, ``ASSIGNED``, ``should_skip``, ``input_specs`` (the cache
  held to the reference's bytes per kind: the stacking differs) and
  ``model_flops``, exactly, for every architecture and shape;
* the counted FLOPs of small configs of every family and each kind (train
  with 1 and 2 microbatches, prefill, decode; MoE also blocked) against
  the matrix products of the reference's lowered step: 2 x result
  elements x contracted size of each ``stablehlo.dot_general`` of the
  ``_unrolled_flops`` lowering, under ``use_unroll``.  Equal, or equal
  after the divergences ``divergence`` names, each exact;
* the folded sLSTM and mLSTM loops count what the loops do;
* a dry-run allocates nothing off ``meta`` and fills the per-device keys
  (``tests/test_torch_dryrun_mesh.py`` holds them to the reference's
  shardings); the CLI writes its JSON, takes ``--opt shard_grads`` and
  refuses ``serve_repl``; ``--opt moe_block`` reaches the blocked MoE.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices,
and the reference's dry-run sets its kernel backend to ``xla``; the
``jdry`` fixture restores both, so no other test in the worker sees them.
"""

import dataclasses
import functools
import json
import math
import os
import re

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import ASSIGNED as JAX_ASSIGNED  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs as jax_list_archs  # noqa: E402
from repro.core import cache as jax_cache  # noqa: E402
from repro.kernels import dispatch as jax_dispatch  # noqa: E402
from repro.models import flags as jax_flags  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models.config import ShapeConfig as JaxShape  # noqa: E402
from repro.training import step as jax_step  # noqa: E402
from repro.training.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro.training.optimizer import constant_schedule as jax_constant  # noqa: E402
from repro_torch import cli  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ASSIGNED, SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.core import cache as cache_prof  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import cache as model_cache  # noqa: E402
from repro_torch.models import flags  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from test_torch_unified import one_thread  # noqa: E402,F401 (autouse)

ARCHS = list_archs()


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module, imported with ``XLA_FLAGS`` put back
    (JAX's CPU backend is up before the import, so the flag never takes
    effect) and its kernel backend at ``xla`` (its ``run_cell`` sets it;
    the lowerings here need it) until the module's tests end."""
    jax.devices()
    prev_flags = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as mod
    if prev_flags is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = prev_flags
    prev = (jax_dispatch._STATE.backend, jax_dispatch._STATE.interpret)
    jax_dispatch.set_backend("xla")
    # its size report traces the reference's init: once per config here
    size = mod.size_prof.profile_size
    mod.size_prof.profile_size = functools.lru_cache(maxsize=None)(size)
    yield mod
    mod.size_prof.profile_size = size
    jax_dispatch.set_backend(*prev)


# ---------------------------------------------------------------------------
# shapes, skips, input specs, model FLOPs
# ---------------------------------------------------------------------------

def test_shapes_match_the_reference():
    assert ([f.name for f in dataclasses.fields(ShapeConfig)]
            == [f.name for f in dataclasses.fields(JaxShape)])
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


def test_assigned_is_the_reference_sweep():
    assert ASSIGNED == jax_list_archs()[:10] == JAX_ASSIGNED
    assert set(ASSIGNED) <= set(ARCHS)


def _jax_cache_bytes(tree):
    """The reference cache's bytes per ``core.cache`` kind."""
    out = {"kv": 0, "state": 0, "cross": 0, "meta": 0}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[jax_cache._classify(path)] += int(leaf.size) * jnp.dtype(leaf.dtype).itemsize
    return out


def _port_cache_bytes(cache):
    out = {"kv": 0, "state": 0, "cross": 0, "meta": 0}
    for entry in cache:
        for leaf, t in entry.items():
            if leaf != "cross_pos":  # the port's memory mask (core/cache.py)
                out[cache_prof._classify(leaf)] += t.numel() * t.element_size()
    return out


def _spec(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_skip_specs_and_model_flops_match_the_reference(jdry, arch):
    """Every shape: ``should_skip``, ``model_flops`` and ``input_specs``
    (keys, shapes, dtypes; a decode cache's bytes by kind)."""
    jcfg, cfg = jax_config(arch), get_config(arch)
    for name, shape in SHAPES.items():
        jshape = JAX_SHAPES[name]
        assert dryrun.should_skip(cfg, shape) == jdry.should_skip(jcfg, jshape), name
        assert dryrun.model_flops(cfg, shape) == jdry.model_flops(jcfg, jshape), name
        ours, ref = dryrun.input_specs(cfg, shape), jdry.input_specs(jcfg, jshape)
        assert set(ours) == set(ref), name
        for key in ref:
            if key == "cache":
                assert all(t.device.type == "meta" for e in ours[key] for t in e.values())
                assert _port_cache_bytes(ours[key]) == _jax_cache_bytes(ref[key]), name
            else:
                assert ours[key].device.type == "meta"
                assert _spec(ours[key]) == (tuple(ref[key].shape), str(ref[key].dtype)), \
                    (name, key)


# ---------------------------------------------------------------------------
# counted FLOPs against the reference's lowered dot_generals
# ---------------------------------------------------------------------------

_FUNC = re.compile(r"func\.func (?:public |private )?@([\w.$-]+)\(")
_CALL = re.compile(r"call @([\w.$-]+)\(")
_DOT = re.compile(r"stablehlo\.dot_general.*?contracting_dims = \[([\d, ]*)\] x \[[\d, ]*\]"
                  r".*?:\s*\(tensor<([^>]*)>,\s*tensor<[^>]*>\)\s*->\s*tensor<([^>]*)>")


def _dims(t):
    return [int(x) for x in t.split("x")[:-1]]


def dot_general_flops(text: str) -> int:
    """2 x result elements x contracted size, summed over the
    ``stablehlo.dot_general`` ops of a lowered module, each function's
    counted once per call from ``main``."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [0, []])
            continue
        if cur is None:
            continue
        c = _CALL.search(line)
        if c:
            cur[1].append(c.group(1))
        if "stablehlo.dot_general" in line:
            d = _DOT.search(line)
            assert d, line
            lhs, out = _dims(d.group(2)), _dims(d.group(3))
            con = [int(i) for i in d.group(1).split(",") if i.strip()]
            cur[0] += 2 * math.prod(out) * math.prod(lhs[i] for i in con)
    memo = {}

    def total(name):
        if name not in memo:
            own, calls = funcs[name]
            memo[name] = own + sum(total(c) for c in calls)
        return memo[name]

    return total("main")


def reference_lowered(jdry, jcfg, shape):
    """The reference's ``_unrolled_flops`` lowering of this cell, its
    module returned instead of its cost analysis."""
    specs = jdry.input_specs(jcfg, shape)
    with jax_flags.use_unroll():
        params = jax_model.param_axes(jcfg)[0]
        if shape.kind == "train":
            opt = JaxAdamW(schedule=jax_constant(1e-4))
            state = jax.eval_shape(lambda: jax_step.TrainState(
                params=params, opt=opt.init(params), step=jnp.zeros((), jnp.int32)))
            fn = jax_step.make_train_step(jcfg, opt, remat=True,
                                          microbatches=shape.microbatches)
            return jax.jit(fn).lower(state, specs)
        if shape.kind == "prefill":
            cache = jax.eval_shape(lambda: jax_model.init_cache(
                jcfg, shape.global_batch, shape.seq_len, jnp.dtype(jcfg.dtype)))
            return jax.jit(lambda p, b, c: jax_model.prefill(jcfg, p, b, c)).lower(
                params, specs, cache)
        return jax.jit(lambda p, t, pos, c: jax_model.decode_step(jcfg, p, t, pos, c)).lower(
            params, specs["token"], specs["positions"], specs["cache"])


def divergence(cfg, shape) -> int:
    """Port minus reference, in FLOPs, of the products the two programs
    form differently (every other product is the same):

    * mLSTM: the reference forms three reductions of each chunk as
      ``dot_general``s that the port computes elementwise (the denominator
      q . n, the normalizer update sum_l w k, the w (x) k factor of the C
      update): 6 B S W per layer and forward pass; in a train step with
      remat 24 B S W (the forward twice, the six products of their
      backward once), and its backward also differentiates the first
      chunk's carried-in C (a constant) and the last chunk's C update
      (whose output no loss reads), three (L, D) x (D, D) products per
      head, 6 B H L D^2, which autograd never forms.  One decode step: the
      denominator, 2 B W.
    * sLSTM: the reference's time loop stays a ``while`` even under
      ``use_unroll``, so its body counts once: 4 gates x 2 B H Dh^2 per
      step forward; the port counts all S steps.  Prefill: 8 B d Dh (S - 1)
      per layer.  Train with remat: the port's 2 x S forward steps and S
      steps of backward (8 products, the first step's 4: h_0 needs no
      gradient) against the reference's 2 forward bodies and one backward
      body: (32 S - 40) B H Dh^2.
    * A parallel block under remat: the port's recompute runs every
      product up to the last one the backward reads, the attention's
      output projection among them (it precedes the MLP), where the
      reference recomputes only what the backward reads: 2 B S d (Hq hd)
      per remat'ed layer.
    """
    B, S = shape.global_batch, shape.seq_len
    kinds = cfg.blocks()
    n_ml, n_sl = kinds.count("mlstm"), kinds.count("slstm")
    W = int(cfg.d_model * cfg.mlstm_proj_factor)
    H = cfg.resolved_rec_heads
    D, Dh = W // H, cfg.d_model // H
    L = min(cfg.recurrent_chunk, S)
    S_pad = -(-S // L) * L
    if shape.kind == "decode":
        return -2 * B * W * n_ml
    if shape.kind == "prefill":
        return -6 * B * S_pad * W * n_ml + 8 * B * cfg.d_model * Dh * (S - 1) * n_sl
    groups = cfg.layer_groups()[0] * len(cfg.block_pattern)
    par = sum(k in ("attn", "local_attn") for k in kinds[:groups]) if cfg.parallel_block else 0
    return (-(24 * B * S_pad * W + 6 * B * H * L * D * D) * n_ml
            + (32 * S - 40) * B * H * Dh * Dh * n_sl
            + 2 * B * S * cfg.d_model * cfg.num_heads * cfg.resolved_head_dim * par)


def _small(arch):
    """A small config of each family, cut so the reference lowers fast."""
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    kw = {"xlstm-1.3b": dict(num_layers=2, block_pattern=("mlstm", "slstm")),
          "nemotron-h-8b": dict(num_layers=4)}.get(arch)  # one group of its pattern
    return (jcfg.replace(**kw), cfg.replace(**kw)) if kw else (jcfg, cfg)


FAMILIES = ["tinyllama-1.1b",        # dense decoder
            "command-r-plus-104b",   # parallel block, tied
            "qwen3-moe-30b-a3b",     # MoE
            "moonshot-v1-16b-a3b",   # MoE with shared experts
            "recurrentgemma-2b",     # RG-LRU hybrid with local attention
            "xlstm-1.3b",            # mLSTM + sLSTM
            "nemotron-h-8b",         # mLSTM hybrid
            "seamless-m4t-large-v2",  # encoder-decoder
            "llava-next-34b"]        # vision prefix
KINDS = [("prefill", 1), ("decode", 1), ("train", 1), ("train", 2)]
B, S = 2, 32


@pytest.mark.parametrize("kind,mb", KINDS, ids=["prefill", "decode", "train", "train_mb2"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_counted_flops_match_the_reference_lowering(jdry, arch, kind, mb):
    jcfg, cfg = _small(arch)
    shape = ShapeConfig("small", S, B, kind, mb)
    ref = dot_general_flops(reference_lowered(jdry, jcfg, JaxShape(*dataclasses.astuple(shape)))
                            .as_text())
    with flags.use_fold_loops():
        ours = dryrun.count_step(cfg, shape).flops
    assert ours - ref == divergence(cfg, shape), (ours, ref)


@pytest.mark.parametrize("kind,mb", [("prefill", 1), ("train", 2)])
def test_counted_flops_of_the_blocked_moe_match_the_reference(jdry, kind, mb):
    """``moe_block``: the blocked dispatch on both sides (one block: no
    mesh on either), with a capacity factor that drops pairs."""
    jcfg, cfg = (c.replace(moe_capacity_factor=0.5) for c in _small("qwen3-moe-30b-a3b"))
    shape = ShapeConfig("small", S, B, kind, mb)
    with jax_flags.use_moe_blocked():
        ref = dot_general_flops(
            reference_lowered(jdry, jcfg, JaxShape(*dataclasses.astuple(shape))).as_text())
    with flags.use_moe_blocked(), flags.use_fold_loops():
        ours = dryrun.count_step(cfg, shape).flops
    assert ours == ref


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_folded_loops_count_what_the_loops_do(kind):
    """The sLSTM's time loop and the mLSTM's chunk loop folded into one
    pass each (``flags.fold_loops``) count the same products as the loops
    run step by step, forward and backward, at lengths of 1, 2 and 5
    chunks (one ragged); off ``meta`` the folds refuse."""
    cfg = get_config("xlstm-1.3b", smoke=True).replace(
        num_layers=2, block_pattern=("slstm", "mlstm"), recurrent_chunk=8)
    for seq in (1, 11, 40):
        shape = ShapeConfig("small", seq, 3, kind, 1)
        full = dryrun.count_step(cfg, shape)
        with flags.use_fold_loops():
            folded = dryrun.count_step(cfg, shape)
        assert folded.flops == full.flops and folded.ops == full.ops, seq
    from repro_torch.models import recurrent as rec_lib
    for kind_, cell in (("slstm", rec_lib.SLSTM), ("mlstm", rec_lib.MLSTM)):
        one = cfg.replace(block_pattern=(kind_,), num_layers=1)
        state = model_cache.init_cache(one, 2, 20, torch.float32, "cpu")[0]
        fn = rec_lib.apply_slstm_seq if kind_ == "slstm" else rec_lib.apply_mlstm_seq
        with flags.use_fold_loops(), pytest.raises(ValueError, match="meta"):
            fn(cell(cfg, torch.float32, "cpu"), torch.zeros(2, 20, cfg.d_model), cfg, state)


# ---------------------------------------------------------------------------
# run_cell, the CLI, the blocked MoE
# ---------------------------------------------------------------------------

REFERENCE_KEYS = {  # the reference's run_cell result, an ``ok`` cell
    "": {"arch", "shape", "mesh", "chips", "kind", "status", "opts", "lower_s",
         "compile_s", "memory", "cost", "collectives", "roofline"},
    "memory": {"argument_bytes_per_device", "output_bytes_per_device",
               "temp_bytes_per_device", "peak_bytes_estimate"},
    "cost": {"flops_perdev_compiled_once", "flops_unrolled_global", "flops_global",
             "flops_perdev_corrected", "bytes_perdev_compiled_once", "bytes_perdev_corrected",
             "microbatches"},
    "collectives": {"counts", "bytes_by_kind_perdev_once", "bytes_perdev_once",
                    "bytes_perdev_corrected"},
    "roofline": {"compute_term_s", "memory_term_s", "collective_term_s", "dominant",
                 "model_flops", "useful_flops_ratio"},
}


def test_run_cell_allocates_nothing_off_meta_and_keeps_the_reference_keys(monkeypatch):
    """Every output of every op a cell runs (train with AdamW, prefill,
    decode; the sLSTM folded; smoke configs), the whole program's and the
    (2, 2) mesh's rank 0's, lives on ``meta``; the result has the
    reference's keys, the per-device and collective ones filled from the
    rank's program."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Devices(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in jax.tree_util.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.seen.add(t.device.type)
            return out

    monkeypatch.setattr(dryrun, "get_config", lambda arch: get_config(arch, smoke=True))
    cells = [("xlstm-1.3b", ShapeConfig("t", 32, 2, "train", 2)),
             ("tinyllama-1.1b", "decode_32k"),
             ("qwen3-moe-30b-a3b", ShapeConfig("p", 256, 1, "prefill"))]
    for arch, shape in cells:
        mode = Devices()
        with mode:
            res = dryrun.run_cell(arch, shape, mesh=(2, 2))
        assert res["status"] == "ok" and mode.seen == {"meta"}, (arch, mode.seen)
        for part, keys in REFERENCE_KEYS.items():
            assert keys <= set(res[part] if part else res), part
        assert res["chips"] == 4 and res["mesh"] == "2x2"
        assert all(v is not None for v in res["collectives"].values())
        assert res["collectives"]["bytes_perdev_corrected"] > 0
        mem = res["memory"]
        assert all(mem[k] > 0 for k in REFERENCE_KEYS["memory"])
        assert mem["argument_bytes_per_device"] < mem["argument_bytes_global"]
        assert mem["peak_bytes_estimate"] == (mem["argument_bytes_per_device"]
                                              + mem["temp_bytes_per_device"])
        assert res["cost"]["flops_perdev_corrected"] > 0
        r = res["roofline"]
        assert r["compute_term_s"] == res["cost"]["flops_global"] / (4 * 67e12)  # fp32
        assert r["memory_term_s"] == mem["argument_bytes_per_device"] / 3.35e12
        assert r["collective_term_s"] == (res["collectives"]["bytes_perdev_corrected"]
                                          / (18 * 25e9))
        assert r["useful_flops_ratio"] == r["model_flops"] / res["cost"]["flops_global"]


def test_train_cell_microbatches_follow_the_reference(monkeypatch):
    """A named train cell takes the reference's microbatches, capped by
    the data axis (16, or 32 on the multi-pod mesh, 1 on one device), in
    the whole program's count and the rank's; a skipped cell says why."""
    seen = []
    monkeypatch.setattr(dryrun, "count_step", lambda cfg, shape, remat=True: seen.append(
        shape.microbatches) or dryrun.cost_lib.CostSummary(1.0, 1, {}))
    rank = dryrun.cost_lib.CostSummary(1.0, 1, {}, output_bytes=1, temp_bytes=1)
    monkeypatch.setattr(dryrun, "count_rank_step", lambda cfg, shape, mesh, remat=True: (
        seen.append(shape.microbatches) or dryrun.RankArguments(None, None, None, {}, {}, None,
                                                                  {"params": 1}),
        rank, dryrun.record.CollectiveLog().summary()))
    for arch, mesh, mb in (("minitron-4b", (16, 16), 8), ("command-r-plus-104b", (16, 16), 16),
                           ("command-r-plus-104b", (2, 16, 16), 8), ("xlstm-1.3b", (1, 1), 8)):
        res = dryrun.run_cell(arch, "train_4k", mesh=mesh)
        assert res["cost"]["microbatches"] == mb and res["chips"] == math.prod(mesh)
    assert seen == [8, 8, 16, 16, 8, 8, 8, 8]
    skipped = dryrun.run_cell("tinyllama-1.1b", "long_500k")
    assert skipped["status"] == "skipped" and "sub-quadratic" in skipped["reason"]


def test_cli_dryrun_writes_its_json_and_refuses_mesh_options(tmp_path, capsys):
    """The CLI writes each cell's JSON, 16 x 16 by default and (pod 2,
    data 16, model 16) under ``--multi-pod``; ``--opt shard_grads`` is
    taken (the port's one program) and so is ``serve_repl`` (the
    weight-stationary decode); ``serve_repl`` on a config with a block it
    does not run is refused by name, a skipped cell on the command line."""
    assert cli.main(["dryrun", "--arch", "tinyllama-1.1b", "--shape", "decode_32k",
                     "--out-dir", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "tinyllama-1.1b__decode_32k__16x16.json").read_text())
    assert res["status"] == "ok" and res["chips"] == 256 and res["device"] == "meta"
    assert res["mesh"] == "16x16" and res["memory"]["peak_bytes_estimate"] > 0
    assert res["cost"]["flops_global"] > 0 and "tinyllama-1.1b__decode_32k" in \
        capsys.readouterr().out
    assert dryrun.main(["--arch", "xlstm-1.3b", "--shape", "decode_32k", "--multi-pod",
                        "--opt", "moe_block", "--out-dir", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "xlstm-1.3b__decode_32k__2x16x16__opt-moe_block.json")
                     .read_text())
    assert res["chips"] == 512 and res["opts"] == ["moe_block"] and res["mesh"] == "2x16x16"
    assert cli.main(["dryrun", "--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--opt",
                     "shard_grads", "--out-dir", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "tinyllama-1.1b__decode_32k__16x16__opt-shard_grads.json")
                     .read_text())
    assert res["status"] == "ok" and res["opts"] == ["shard_grads"]
    assert cli.main(["dryrun", "--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--opt",
                     "serve_repl", "--out-dir", str(tmp_path)]) == 0
    repl = json.loads((tmp_path / "tinyllama-1.1b__decode_32k__16x16__opt-serve_repl.json")
                      .read_text())
    assert repl["status"] == "ok" and repl["opts"] == ["serve_repl"]
    assert repl["cost"]["flops_global"] == res["cost"]["flops_global"]
    assert (repl["collectives"]["bytes_perdev_corrected"]
            < res["collectives"]["bytes_perdev_corrected"])
    assert cli.main(["dryrun", "--arch", "xlstm-1.3b", "--shape", "decode_32k", "--opt",
                     "serve_repl", "--out-dir", str(tmp_path)]) == 0
    skipped = json.loads((tmp_path / "xlstm-1.3b__decode_32k__16x16__opt-serve_repl.json")
                         .read_text())
    assert skipped["status"] == "skipped" and "item 4d" in skipped["reason"]
    capsys.readouterr()
    with pytest.raises(SystemExit):
        cli.main(["dryrun", "--arch", "tinyllama-1.1b", "--opt", "serve_all",
                  "--out-dir", str(tmp_path)])
    assert "serve_all" in capsys.readouterr().err
    with pytest.raises(ValueError, match="serve_repl.*item 4d"):
        dryrun.run_cell("recurrentgemma-2b", "decode_32k", opts={"serve_repl"})
    with pytest.raises(SystemExit):
        dryrun.main(["--shape", "decode_32k"])  # neither --arch nor --all


def test_moe_block_reaches_the_blocked_dispatch_and_matches_the_reference(jdry, monkeypatch):
    """Under ``use_moe_blocked`` every MoE layer goes through
    ``apply_moe_blocked``; the smoke model's prefill and two decode steps
    (capacity 0.5, so pairs drop) match the reference's blocked path."""
    arch = "qwen3-moe-30b-a3b"
    jcfg, cfg = (c.replace(moe_capacity_factor=0.5)
                 for c in (jax_config(arch, smoke=True), get_config(arch, smoke=True)))
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_model.init(jcfg, key)[0])(jax.random.PRNGKey(0)))
    model = params_from_jax(cfg, tree, device="cpu")
    calls = []
    blocked = moe_lib.apply_moe_blocked
    monkeypatch.setattr(moe_lib, "apply_moe_blocked",
                        lambda *a, **kw: calls.append(1) or blocked(*a, **kw))
    tokens = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 12), dtype=np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    with jax_flags.use_moe_blocked():
        prefill = jax.jit(lambda p, b, c: jax_model.prefill(jcfg, p, b, c))
        decode = jax.jit(lambda p, t, pos, c: jax_model.decode_step(jcfg, p, t, pos, c))
        jcache = jax_model.init_cache(jcfg, 2, 16, jnp.float32)
        jlogits, jcache = prefill(jparams, {"tokens": jnp.asarray(tokens)}, jcache)
        steps = [jlogits]
        for i in range(2):
            tok = jnp.argmax(steps[-1], -1)[:, None].astype(jnp.int32)
            jl, jcache = decode(jparams, tok, jnp.asarray(12 + i, jnp.int32), jcache)
            steps.append(jl)
    with flags.use_moe_blocked():
        cache = model.init_cache(2, 16)
        logits, cache = model.prefill({"tokens": torch.from_numpy(tokens).long()}, cache)
        ours = [logits]
        for i in range(2):
            tok = torch.from_numpy(np.array(jnp.argmax(steps[i], -1)))[:, None].long()
            ours.append(model.decode_step(tok, 12 + i, cache)[0])
    for a, b in zip(ours, steps):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)
    n_moe = sum(k in ("attn", "local_attn") for k in cfg.blocks())
    assert len(calls) == 3 * n_moe
    assert not flags.moe_blocked()
