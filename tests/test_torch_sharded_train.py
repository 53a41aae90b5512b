"""Sharded training of the port against the reference, on the CPU: a
``("data", "model")`` mesh of gloo ranks (``launch.mesh.spawn_mesh``)
with FSDP over data and tensor parallelism over model
(``sharding/fsdp.py``, ``sharding/partition.py``,
``sharding/collectives.py``, ``training/step.py(mesh=)``).

The reference's sharded driver cannot run under JAX 0.9 (ROADMAP
"Reference caveat": ``rules.py`` ``with_sharding_constraint`` on Explicit
axes), so the port is held to what that driver computes: the reference's
mesh-free ``make_train_step`` (the same function) and its
``param_pspecs`` under ``DEFAULT_RULES`` on an ``AbstractMesh``.

One spawn of 4 gloo ranks, each on one intra-op thread, runs every rank
job of the file (``runs.train_plan``), the meshes (2, 2) and (4, 1) made
from the same ranks, while this process computes the reference's runs:

* (a) without ranks: every rank's parameter and moment shapes, for every
  decoder of the registry and seamless-m4t-large-v2, on (2, 2), (2, 4)
  and (4, 1), equal the reference's shards;
* (b) tinyllama-1.1b's smoke config at (2, 2), fp32: the 12-step
  trajectory within rtol 1e-4 of the reference's, step 1's gathered
  gradients within 2e-5 of each leaf's largest entry; again at 2
  microbatches and on a batch of 3 that data does not divide;
* (c) one smoke model per family at (2, 2), 2 steps: RG-LRU, xLSTM
  (the one-device tests' two measured exceptions: the sLSTM ``b_i`` and
  the chaotic bounds), MoE (its drops those of the global batch's capacity),
  encoder-decoder and vision prefix;
* (d) elastic: a checkpoint saved at (2, 2) restores at (4, 1) and on
  one device bit for bit, its files equal a one-device save's, and the
  run resumed at (2, 2) equals the uninterrupted one;
* (e) the differentiable collectives' gradients against whole-tensor
  autograd;
* (f) prefill and decode on the (2, 2) mesh (``Model.prefill`` and
  ``decode_step`` under FSDP, ``partition.rank_rows``/``rank_cache``), fp32,
  for tinyllama-1.1b's smoke config, a MoE, an RG-LRU and the
  encoder-decoder model: the ranks' logits within 1e-5 of the largest
  |logit| of the reference's ``prefill``/``decode_step`` on the same
  parameters;
* (g) the collectives each rank counted (``Mesh.count``) in a train step
  past the first (the training driver's), that prefill and a decode step
  equal ``launch.dryrun.run_cell(..., mesh=(2, 2))``'s counts and bytes
  by kind exactly;
* (h) the weight-stationary decode (``rules.use_serve_rules``, the
  reference's ``SERVE_RULES``) after that prefill, fp32, for
  tinyllama-1.1b, command-r-plus-104b (parallel block), llava-next-34b,
  seamless-m4t-large-v2 (cross attention) and tinyllama with one KV head
  (an L-sharded cache): every rank's whole-batch logits equal rank 0's
  and lie within 1e-5 of the largest |logit| of the reference's
  ``decode_step``; each rank's collectives by axis and kind equal
  ``run_cell(mesh=(2, 2), opts={"serve_repl"})``'s, and gather no weight;
  and on (data 4 as 2 pods x 2, model 1) at d = 54, where only the pods
  divide the weights' ``embed`` dim, the residual splits over the pods
  and the logits are the one-device model's.
"""

import concurrent.futures
import dataclasses
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.sharding.partition import param_pspecs  # noqa: E402
from repro.sharding.rules import DEFAULT_RULES  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import step as jax_step  # noqa: E402
from repro_torch.bridge import reference_by_port_name  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import spawn_mesh  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.sharding import partition, runs  # noqa: E402
from repro_torch.training import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402

from test_torch_train_families import (  # noqa: E402
    PERTURBED, _one_ulp, _reference_run, family_batch, reference_params, zero_gradients,
)
from test_torch_training import GRAD_TOL, LR, STEPS, WARMUP, _by_name  # noqa: E402
from test_torch_unified import one_thread  # noqa: E402,F401 (autouse)

MESH = (2, 2)
TINY = "tinyllama-1.1b"
# the families' smoke models, 2 steps each at (2, 2)
FAMILIES = ["recurrentgemma-2b", "xlstm-1.3b", "qwen3-moe-30b-a3b", "seamless-m4t-large-v2",
            "llava-next-34b"]
FAMILY_STEPS, FAMILY_B = 2, 4
SAVE_AT = 2
# tinyllama's runs: (batch, microbatches)
TINY_RUNS = {"b8": (8, 1), "mb2": (8, 2), "b3": (3, 1)}
CHAOTIC = {"xlstm-1.3b"}
# prefill and decode on the mesh: (batch, prompt positions, decode steps);
# an encoder-decoder's prompt is half frames, half tokens, as input_specs
SERVED = ["tinyllama-1.1b", "qwen3-moe-30b-a3b", "recurrentgemma-2b", "seamless-m4t-large-v2"]
SERVE_B, SERVE_S, SERVE_STEPS = 4, 16, 3
SERVE_LEN = SERVE_S + SERVE_STEPS + 1
# d = 54 on (data 4 = 2 pods x 2, model 1): 4 does not divide the embed dims,
# 2 does, so they split over the pods (the reference's fallback)
POD_CFG = get_config(TINY, smoke=True).replace(d_model=54)
# the weight-stationary decode after the prefill on the mesh: name -> (arch,
# config changes); one KV head, which model does not divide, L-shards the cache
SERVE_REPL = {TINY: (TINY, {}), "command-r-plus-104b": ("command-r-plus-104b", {}),
              "llava-next-34b": ("llava-next-34b", {}),
              "seamless-m4t-large-v2": ("seamless-m4t-large-v2", {}),
              f"{TINY} kv1": (TINY, {"num_kv_heads": 1})}
# the training driver's steps, each rank's collectives counted
DRIVER = ["--arch", TINY, "--smoke", "--device", "cpu", "--steps", "2", "--batch", "8",
          "--seq-len", "32", "--log-every", "100"]


def _full(arch):
    """The reference's perturbed smoke parameters by the port's names."""
    cfg = get_config(arch, smoke=True)
    return {k: np.asarray(v) for k, v in _by_name(cfg, reference_params(arch)).items()}


@functools.lru_cache(maxsize=None)
def _serve_repl_case(name):
    """(the port's config, the reference's, the reference's perturbed
    parameters) of a ``SERVE_REPL`` case; a changed config's parameters
    from the reference's own init, perturbed as ``reference_params``."""
    arch, changes = SERVE_REPL[name]
    cfg = get_config(arch, smoke=True).replace(**changes)
    jcfg = jax_config(arch, smoke=True).replace(**changes)
    if not changes:
        return cfg, jcfg, reference_params(arch)
    tree = jax.tree.map(np.asarray, jax.jit(lambda k: jax_model.init(jcfg, k)[0])(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)

    def leaf(path, arr):
        if str(getattr(path[-1], "key", "")) in PERTURBED:
            arr = arr + 0.1 * rng.standard_normal(arr.shape).astype(arr.dtype)
        return arr

    return cfg, jcfg, jax.tree_util.tree_map_with_path(leaf, tree)


def _batches(arch, B, steps):
    cfg = get_config(arch, smoke=True)
    return [family_batch(cfg, B, i) for i in range(steps)]


def _jobs(ckpt):
    jobs = {}
    for name, (B, mb) in TINY_RUNS.items():
        jobs[name] = runs.Train(cfg=get_config(TINY, smoke=True), batches=_batches(TINY, B, STEPS),
                                shape=MESH, params=_full(TINY), lr=LR, warmup=WARMUP,
                                total=STEPS, microbatches=mb,
                                ckpt_dir=ckpt if name == "b8" else "",
                                save_at=SAVE_AT if name == "b8" else 0)
    jobs["remat"] = runs.Train(cfg=get_config(TINY, smoke=True), batches=_batches(TINY, 8, 2),
                               shape=MESH, params=_full(TINY), lr=LR, warmup=WARMUP,
                               total=STEPS, remat=True)
    for shape, name in (((4, 1), "resume41"), (MESH, "resume22")):
        jobs[name] = runs.Train(cfg=get_config(TINY, smoke=True),
                                batches=_batches(TINY, 8, STEPS), shape=shape,
                                params=_full(TINY), lr=LR, warmup=WARMUP, total=STEPS,
                                ckpt_dir=ckpt, resume=True)
    for arch in FAMILIES:
        jobs[arch] = runs.Train(cfg=get_config(arch, smoke=True),
                                batches=_batches(arch, FAMILY_B, FAMILY_STEPS), shape=MESH,
                                params=_full(arch), lr=LR, warmup=WARMUP, total=STEPS,
                                routes=get_config(arch, smoke=True).is_moe)
    for shape in (MESH, (4, 1), (1, 4)):
        jobs[f"collectives{shape}"] = runs.CollectiveGrads(shape=shape)
    for arch in SERVED:
        jobs[f"served {arch}"] = runs.MeshLogits(shape=MESH, params=_full(arch),
                                                 max_len=SERVE_LEN, **_served_inputs(arch))
    for name in SERVE_REPL:
        cfg, _, tree = _serve_repl_case(name)
        jobs[f"serve_repl {name}"] = runs.MeshLogits(
            shape=MESH, params={k: np.asarray(v) for k, v in _by_name(cfg, tree).items()},
            max_len=SERVE_LEN, serve=True, **_served_inputs(SERVE_REPL[name][0], cfg))
    jobs["serve_repl pods"] = runs.MeshLogits(shape=(4, 1), pods=2, max_len=SERVE_LEN,
                                              serve=True, **_served_inputs(TINY, POD_CFG))
    jobs["driver"] = runs.DriverTrain(DRIVER, shape=MESH, count=True)
    jobs["pods"] = runs.Train(cfg=POD_CFG, batches=_batches(TINY, 8, STEPS), shape=(4, 1), pods=2,
                              lr=LR, warmup=WARMUP, total=STEPS)
    return jobs


def _served_inputs(arch, cfg=None):
    """The prompt (and frames) and decode tokens of ``arch``'s mesh job
    (``cfg``: its smoke config, or one changed from it)."""
    cfg = cfg or get_config(arch, smoke=True)
    rng = np.random.default_rng(5)
    text = SERVE_S // 2 if cfg.is_encdec else SERVE_S
    out = dict(cfg=cfg, tokens=rng.integers(0, cfg.vocab_size, (SERVE_B, text)),
               steps=rng.integers(0, cfg.vocab_size, (SERVE_STEPS, SERVE_B)))
    if cfg.is_encdec:
        out["enc"] = (0.1 * rng.standard_normal((SERVE_B, SERVE_S // 2, cfg.d_model))
                      ).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _reference_step(arch, microbatches=1):
    """(config, optimizer, the jitted reference step), compiled once."""
    jcfg = jax_config(arch, smoke=True)
    jo = jax_opt.AdamW(schedule=jax_opt.warmup_cosine_schedule(LR, WARMUP, STEPS))
    return jcfg, jo, jax.jit(jax_step.make_train_step(jcfg, jo, remat=False,
                                                      microbatches=microbatches))


def _reference(arch, B, steps, microbatches=1, params=None):
    """The jitted reference step's (loss, grad_norm, lr) per step from
    ``params`` (the perturbed smoke parameters by default), and its final
    state."""
    params = reference_params(arch) if params is None else params
    return _reference_run(*_reference_step(arch, microbatches), params, B, steps)


@pytest.fixture(scope="module")
def results(tmp_path_factory, one_thread):
    """Every rank job's result (rank order) by name, the references by
    name, the checkpoint's directory, and the mesh-free port's run of each
    family."""
    ckpt = str(tmp_path_factory.mktemp("sharded_ckpt"))
    jobs = _jobs(ckpt)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn_mesh, runs.train_plan, MESH, "cpu", list(jobs.values()),
                            threads=1)
        refs = {name: _reference(TINY, B, STEPS, mb) for name, (B, mb) in TINY_RUNS.items()}
        for arch in FAMILIES:
            refs[arch] = _reference(arch, FAMILY_B, FAMILY_STEPS)
        alone = FAMILIES + ["pods", "serve_repl pods"]
        whole = runs.train_plan(None, [dataclasses.replace(jobs[name], shape=(1, 1))
                                       for name in alone])
        out = ranks.result()
    by_name = {name: [r[i] for r in out] for i, name in enumerate(jobs)}
    return by_name, refs, ckpt, dict(zip(alone, whole))


def _reference_served(arch, jcfg=None, params=None):
    """The reference's prefill and decode steps on the mesh job's inputs:
    fp32 logits (steps + 1, B, vocab); ``jcfg`` and ``params`` in place of
    ``arch``'s smoke config and perturbed parameters."""
    inputs = _served_inputs(arch)
    jcfg = jcfg or jax_config(arch, smoke=True)
    params = reference_params(arch) if params is None else params
    batch = {"tokens": jnp.asarray(inputs["tokens"], jnp.int32)}
    if "enc" in inputs:
        batch["enc_embeds"] = jnp.asarray(inputs["enc"])
    cache = jax_model.init_cache(jcfg, SERVE_B, SERVE_LEN, jnp.float32)
    logits, cache = jax.jit(lambda p, b, c: jax_model.prefill(jcfg, p, b, c))(params, batch,
                                                                             cache)
    out = [logits]
    decode = jax.jit(lambda p, t, pos, c: jax_model.decode_step(jcfg, p, t, pos, c))
    start = inputs["tokens"].shape[1]
    for i, tok in enumerate(inputs["steps"]):
        logits, cache = decode(params, jnp.asarray(tok, jnp.int32)[:, None],
                               jnp.asarray(start + i, jnp.int32), cache)
        out.append(logits)
    return np.stack([np.asarray(x) for x in out])


def _assert_close(got, ref, rel, skip=()):
    """Each leaf of ``got`` within ``rel`` of its reference leaf's largest
    entry."""
    assert set(got) == set(ref)
    for k, a in ref.items():
        if k in skip:
            continue
        tol = rel * max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(got[k], a, rtol=0, atol=tol, err_msg=k)


# -- (a) the rank shapes against the reference's param_pspecs -----------------------------

class _Axis:
    def __init__(self, size):
        self.size, self.rank, self.device = size, 0, torch.device("meta")


class _MetaMesh:
    """A (dp, tp) mesh stand-in for building a rank's shapes on meta."""

    def __init__(self, dp, tp):
        self.shape, self.data, self.model = (dp, tp), _Axis(dp), _Axis(tp)
        self.device, self.rank, self.size = torch.device("meta"), 0, dp * tp


def reference_mesh(dp, tp, pods=1):
    """The reference's ``AbstractMesh`` of (dp, tp): ``("data", "model")``,
    or with ``pods`` > 1 ``("pod", "data", "model")``, dp over pod x data."""
    if pods > 1:
        return AbstractMesh((pods, dp // pods, tp), ("pod", "data", "model"))
    return AbstractMesh((dp, tp), ("data", "model"))


def reference_train_shards(cfg, jcfg, dp, tp, pods=1):
    """The reference's per-device parameter shapes of ``jcfg`` under
    ``DEFAULT_RULES`` on ``reference_mesh(dp, tp, pods)``, by the port's
    names (the stacked ``layers`` axis split away)."""
    mesh = reference_mesh(dp, tp, pods)
    shapes, axes = jax_model.param_axes(jcfg)
    specs = param_pspecs(axes, shapes, mesh, DEFAULT_RULES)

    def local(spec, s):
        out = []
        for i, n in enumerate(s.shape):
            names = spec[i] if i < len(spec) else None
            names = (names,) if isinstance(names, str) else (names or ())
            for a in names:
                n //= mesh.shape[a]
            out.append(n)
        return np.broadcast_to(np.empty((), np.int8), tuple(out))

    tree = jax.tree.map(local, specs, shapes, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {name: a.shape for name, a in reference_by_port_name(cfg, tree).items()}


TRAINED = [a for a in list_archs() if not get_config(a).is_encdec] + ["seamless-m4t-large-v2"]


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (4, 1)])
@pytest.mark.parametrize("arch", TRAINED)
def test_rank_shapes_are_the_reference_param_pspecs_shards(arch, shape):
    """Every rank's parameters and moments at the full config, on meta,
    have the reference's per-device shapes under ``DEFAULT_RULES``: the
    model dims of the serving rules, each leaf's ``embed`` over data,
    the norm scales, gates, biases and convolutions of a width whole over
    data, an axis that does not divide a dim dropped."""
    cfg = get_config(arch)
    model = partition._rank_model(cfg, _MetaMesh(*shape))
    want = reference_train_shards(cfg, jax_config(arch), *shape)
    got = {name: tuple(p.shape) for name, p in model.named_parameters()}
    assert got == want
    moments = opt_lib.AdamW(schedule=opt_lib.constant_schedule(1e-3)).init(
        dict(model.named_parameters()))
    assert {k: tuple(t.shape) for k, t in moments.mu.items()} == want
    assert {k: tuple(t.shape) for k, t in moments.nu.items()} == want


def test_data_split_reaches_the_sharded_leaves():
    """At (2, 2) tinyllama-1.1b's projections split over data on ``embed``
    and its norm scales do not; seamless's encoder and cross attention
    split over model."""
    cfg = get_config(TINY)
    model = partition._rank_model(cfg, _MetaMesh(2, 2))
    placement = model.placement
    assert model.layers[0].attn.wq.shape == (1024, 16, 64)
    assert model.layers[0].attn.wo.shape == (16, 64, 1024)
    assert model.layers[0].norm1.scale.shape == (2048,)
    assert placement.sharded("layers.0.attn.wq") == (True, True)
    assert placement.sharded("layers.0.norm1.scale") == (False, False)
    seamless = partition._rank_model(get_config("seamless-m4t-large-v2"), _MetaMesh(1, 2))
    assert seamless.encoder.layers[0].attn.wq.shape == (1024, 8, 64)
    assert seamless.layers[0].cross.wk.shape == (1024, 8, 64)


# -- (b) tinyllama's trajectory and gradients ---------------------------------------------

def _check_trajectory(got, ref, slack=None):
    """loss and grad_norm within rtol 1e-4 at every step (or ``slack``)."""
    steps = len(ref[0])
    for i in range(steps):
        for j, key in enumerate(("loss", "grad_norm")):
            bound = 1e-4 * abs(ref[0][i][j])
            if slack is not None:
                bound = max(bound, slack[i][j])
            assert abs(got[key][i] - ref[0][i][j]) <= bound, (i, key, got[key][i], ref[0][i][j])


@pytest.mark.parametrize("run", list(TINY_RUNS))
def test_tinyllama_trajectory_matches_the_reference(results, run):
    """12 fp32 steps at (2, 2): every step's loss and grad_norm within
    rtol 1e-4 of the reference's mesh-free step (one microbatch, two,
    and a batch of 3 that data does not divide, so every data rank runs
    it whole); every rank reports the same metrics; the final parameters
    within 5 % of the peak learning rate and the moments within 1e-4 of
    each leaf's largest entry, as the one-device trajectory test."""
    by_name, refs, _, _ = results
    ranks, ref = by_name[run], refs[run]
    _check_trajectory(ranks[0], ref)
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"] and r["grad_norm"] == ranks[0]["grad_norm"]
    cfg = get_config(TINY, smoke=True)
    final = ranks[0]["final"]
    jstate = ref[1]
    want = _by_name(cfg, jax.tree.map(np.asarray, jstate.params))
    for k, a in want.items():
        np.testing.assert_allclose(final["params"][k], a, rtol=0, atol=0.05 * LR, err_msg=k)
    for part, tree in (("mu", jstate.opt.mu), ("nu", jstate.opt.nu)):
        _assert_close(final[part], _by_name(cfg, jax.tree.map(np.asarray, tree)), 1e-4)


@pytest.mark.parametrize("run", list(TINY_RUNS))
def test_tinyllama_first_step_gradients_match_the_reference(results, run):
    """Step 1's gradients, gathered over both axes, within ``GRAD_TOL`` of
    each leaf's largest entry of the reference's ``value_and_grad`` on the
    same global batch (its microbatches' mean)."""
    by_name = results[0]
    B, mb = TINY_RUNS[run]
    jcfg = jax_config(TINY, smoke=True)
    loss_fn = jax_step.make_loss_fn(jcfg, remat=False)
    batch = _batches(TINY, B, 1)[0]
    grad = jax.jit(jax.grad(lambda p, b: loss_fn(p, b)[0]))
    b = B // mb
    total = None
    for i in range(mb):
        g = grad(reference_params(TINY), {k: v[i * b:(i + 1) * b] for k, v in batch.items()})
        total = g if total is None else jax.tree.map(lambda x, y: x + y, total, g)
    want = _by_name(get_config(TINY, smoke=True), jax.tree.map(lambda x: np.asarray(x) / mb, total))
    _assert_close(by_name[run][0]["grads"], want, GRAD_TOL)


def test_remat_regathers_and_changes_nothing(results):
    """With remat each group's forward, its FSDP gathers among it, runs
    again in the backward on every rank in the same order: the first two
    steps' losses, grad norms and step 1's gradients equal the run
    without remat bit for bit."""
    by_name = results[0]
    whole, remat = by_name["b8"][0], by_name["remat"][0]
    assert remat["loss"] == whole["loss"][:2] and remat["grad_norm"] == whole["grad_norm"][:2]
    for k, g in whole["grads"].items():
        np.testing.assert_array_equal(remat["grads"][k], g, err_msg=k)


# -- (c) one smoke model per family ------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_family_trajectory_matches_the_reference(results, arch):
    """Two fp32 steps at (2, 2) within rtol 1e-4 of the reference's step
    (xlstm-1.3b within twice the distance the reference moved by one ulp
    gives, as its one-device test); step 1's gathered gradients within
    ``GRAD_TOL`` of the mesh-free port's own on the same batch (which the
    one-device tests hold to the reference's), the sLSTM ``b_i`` (zero in
    exact arithmetic) within 1e-7 of the largest gradient."""
    by_name, refs, _, _ = results
    rank0 = by_name[arch][0]
    slack = None
    if arch in CHAOTIC:
        moved, _ = _reference(arch, FAMILY_B, FAMILY_STEPS,
                              params=_one_ulp(reference_params(arch)))
        slack = 2 * np.maximum.accumulate(np.abs(np.subtract(moved, refs[arch][0]))[:, :2],
                                          axis=0)
    _check_trajectory(rank0, refs[arch], slack)
    cfg = get_config(arch, smoke=True)
    want = results[3][arch]["grads"]
    zero = zero_gradients(cfg)
    top = max(float(np.abs(a).max()) for a in want.values())
    for k in zero:
        assert np.abs(rank0["grads"][k]).max() <= 1e-7 * top, k
    _assert_close(rank0["grads"], want, GRAD_TOL, skip=zero)


def test_moe_drops_are_the_global_batchs(results):
    """qwen3-moe-30b-a3b at (2, 2): each data rank's routes of the first
    step, its rows' part of the global batch in rank order, equal the
    mesh-free run's over the whole batch, expert ids and kept pairs alike;
    pairs were dropped, so the global capacity decided which."""
    by_name, _, _, whole = results
    ranks, whole = by_name["qwen3-moe-30b-a3b"], whole["qwen3-moe-30b-a3b"]
    want = whole["routes"]
    for call, (ids, kept) in enumerate(zip(want["ids"], want["kept"])):
        got_ids = np.concatenate([ranks[r]["routes"]["ids"][call] for r in (0, 2)])
        got_kept = np.concatenate([ranks[r]["routes"]["kept"][call] for r in (0, 2)])
        np.testing.assert_array_equal(got_ids, ids, err_msg=str(call))
        np.testing.assert_array_equal(got_kept, kept, err_msg=str(call))
        for r in (1, 3):  # a data rank's model ranks route alike
            np.testing.assert_array_equal(ranks[r]["routes"]["kept"][call],
                                          ranks[r - 1]["routes"]["kept"][call])
    assert not all(k.all() for k in want["kept"])


# -- (d) elastic restore ---------------------------------------------------------------------

def _checkpoint(ckpt):
    d = os.path.join(ckpt, f"step_{SAVE_AT:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return manifest, arrays


def test_restore_at_another_mesh_is_bit_for_bit(results):
    """The (2, 2) checkpoint restored at (4, 1) and at (2, 2) gathers back
    to its arrays bit for bit; at (4, 1) every rank holds a quarter of
    each data-split leaf."""
    by_name, _, ckpt, _ = results
    _, arrays = _checkpoint(ckpt)
    for name in ("resume41", "resume22"):
        restored = by_name[name][0]["restored"]
        for k, a in restored.items():
            saved = arrays[f"params/{k}"]
            np.testing.assert_array_equal(a, saved.astype(np.float32), err_msg=f"{name} {k}")
    shapes = by_name["resume41"][1]["shapes"]
    assert shapes["layers.0.attn.wq"][0] == get_config(TINY, smoke=True).d_model // 4


def test_restore_on_one_device_and_its_save_equal_the_sharded_files(results, tmp_path):
    """On one device the checkpoint restores into a whole model's tree bit
    for bit, and a one-device save of that state writes the same arrays,
    dtypes, shapes and manifest keys as the sharded save did."""
    _, _, ckpt, _ = results
    manifest, arrays = _checkpoint(ckpt)
    cfg = get_config(TINY, smoke=True)
    from repro_torch.models import model as model_lib
    model = model_lib.Model(cfg, device="cpu")
    opt = opt_lib.AdamW(schedule=opt_lib.constant_schedule(1e-3))
    state = opt.init(dict(model.named_parameters()))
    tree = {"params": dict(model.named_parameters()), "opt_mu": state.mu, "opt_nu": state.nu}
    restored, got = ckpt_lib.restore(ckpt, tree, step=SAVE_AT)
    for part, leaves in restored.items():
        for k, t in leaves.items():
            np.testing.assert_array_equal(t.numpy(), arrays[f"{part}/{k}"], err_msg=k)
    again = str(tmp_path / "one")
    ckpt_lib.save(again, SAVE_AT, restored, metadata={"data_offset": SAVE_AT})
    manifest1, arrays1 = _checkpoint(again)
    assert set(arrays1) == set(arrays)
    for k, a in arrays.items():
        assert a.dtype == arrays1[k].dtype
        np.testing.assert_array_equal(arrays1[k], a, err_msg=k)
    drop = ("time",)
    assert ({k: v for k, v in manifest.items() if k not in drop}
            == {k: v for k, v in manifest1.items() if k not in drop})


def test_resumed_runs_continue_the_trajectory(results):
    """Resumed at (2, 2) the steps after the checkpoint equal the
    uninterrupted run's bit for bit, and its final state too; resumed at
    (4, 1) they agree within rtol 1e-4 (the sums run in another order)."""
    by_name = results[0]
    whole = by_name["b8"][0]
    same = by_name["resume22"][0]
    assert same["loss"] == whole["loss"][SAVE_AT:]
    assert same["grad_norm"] == whole["grad_norm"][SAVE_AT:]
    for part in ("params", "mu", "nu"):
        for k, a in whole["final"][part].items():
            np.testing.assert_array_equal(same["final"][part][k], a, err_msg=f"{part} {k}")
    other = by_name["resume41"][0]
    np.testing.assert_allclose(other["loss"], whole["loss"][SAVE_AT:], rtol=1e-4)
    np.testing.assert_allclose(other["grad_norm"], whole["grad_norm"][SAVE_AT:], rtol=1e-4)


# -- (e) the differentiable collectives ---------------------------------------------------

@pytest.mark.parametrize("shape", [MESH, (4, 1), (1, 4)])
def test_collectives_gradients_match_whole_tensor_autograd(results, shape):
    """``copy``, ``reduce``, ``gather`` over model and ``fsdp_gather`` over
    data (rows split, and whole on every data rank): every rank's loss and
    gradients equal autograd's on the whole tensors within fp32 rounding."""
    for rank, out in enumerate(results[0][f"collectives{shape}"]):
        for key, err in out.items():
            assert err <= 1e-5, (shape, rank, key, err)


# -- (f) prefill and decode on the mesh --------------------------------------------------

@pytest.mark.parametrize("arch", SERVED)
def test_sharded_prefill_and_decode_match_the_reference(results, arch):
    """The (2, 2) ranks' prefill and 3 decode steps, each data rank its
    half of the rows, its cache the reference's ``cache_shardings`` on the
    mesh: their fp32 logits, rows in data-rank order, within 1e-5 of the
    largest |logit| of the reference's ``prefill``/``decode_step`` on the
    same parameters and tokens (the tp tests' bound); a data rank's two
    model ranks give the same logits."""
    ranks = results[0][f"served {arch}"]
    for r in (1, 3):
        np.testing.assert_array_equal(ranks[r]["logits"], ranks[r - 1]["logits"])
    assert [ranks[r]["row"] for r in (0, 2)] == [0, SERVE_B // 2]
    got = np.concatenate([ranks[r]["logits"] for r in (0, 2)], axis=1)
    want = _reference_served(arch)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


# -- (g) the counted collectives against the dry-run -----------------------------------------

def _counted(summary):
    return summary["counts"], summary["bytes_by_kind"]


@pytest.mark.parametrize("what", ["train"] + SERVED)
def test_counted_collectives_equal_the_dry_run(results, what):
    """Each rank's collectives (``Mesh.count``) equal, kind by kind in
    count and bytes, what ``dryrun.run_cell`` at mesh (2, 2) counts for
    rank 0 of the same step on meta: the training driver's second step
    (8 x 32, no remat, as the driver runs), and each model's prefill and
    first decode step; every rank counts the same."""
    by_name = results[0]
    if what == "train":
        got = [_counted(r["steps"][1]["collectives"]) for r in by_name["driver"]]
        assert all(r["steps"][1]["step"] == 1 for r in by_name["driver"])
        res = dryrun.run_cell(TINY, ShapeConfig("driver", 32, 8, "train", 1), mesh=MESH,
                              cfg=get_config(TINY, smoke=True), remat=False)
        wants = [res]
        phases = [[g] for g in got]
    else:
        cfg = get_config(what, smoke=True)
        wants = [dryrun.run_cell(what, ShapeConfig(kind, seq, SERVE_B, kind), mesh=MESH, cfg=cfg)
                 for kind, seq in (("prefill", SERVE_S), ("decode", SERVE_LEN))]
        phases = [[_counted(p["collectives"]) for p in r["phases"][:2]]
                  for r in by_name[f"served {what}"]]
    for rank, mine in enumerate(phases):
        for phase, res in zip(mine, wants):
            c = res["collectives"]
            assert phase == (c["counts"], c["bytes_by_kind_perdev_once"]), (rank, res["kind"])


def test_pod_split_leaves_train_as_the_whole_model(results):
    """d = 54 on (data 4 as 2 pods x 2, model 1): each ``embed`` dim splits
    over the pods only (27 a rank; ``rules.data_split``), is gathered over
    the pod axis and its gradient summed over the whole data axis; the
    global norm counts each pod shard once.  The 12 steps equal the
    one-device run from the same seed within rtol 1e-4, and the final
    parameters, gathered over the pods, within 5 % of the learning rate."""
    by_name, _, _, whole = results
    ranks, want = by_name["pods"], whole["pods"]
    assert ranks[0]["shapes"]["layers.0.attn.wq"][0] == 27
    assert ranks[0]["shapes"]["layers.0.norm1.scale"] == (54,)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(ranks[0][key], want[key], rtol=1e-4, err_msg=key)
    for k, a in want["final"]["params"].items():
        np.testing.assert_allclose(ranks[0]["final"]["params"][k], a, rtol=0, atol=0.05 * LR,
                                   err_msg=k)


# -- (h) the weight-stationary decode (serve_repl) ------------------------------------------

def _serve_repl_cell(name):
    """``run_cell``'s count of the (2, 2) rank's decode step under the
    serve rules, for ``SERVE_REPL`` case ``name``."""
    cfg = _serve_repl_case(name)[0]
    return dryrun.run_cell(SERVE_REPL[name][0], ShapeConfig("decode", SERVE_LEN, SERVE_B, "decode"),
                           mesh=MESH, cfg=cfg, opts={"serve_repl"})


@pytest.mark.parametrize("name", list(SERVE_REPL))
def test_serve_repl_decode_matches_the_reference(results, name):
    """The (2, 2) ranks' prefill (each data rank its rows, as (f)), then 3
    weight-stationary decode steps on the same cache, each given the
    rank's rows of the token and positions: every rank returns the whole
    batch's logits, equal to rank 0's bit for bit, within 1e-5 of the
    largest |logit| of the reference's ``prefill``/``decode_step``."""
    ranks = results[0][f"serve_repl {name}"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])
    _, jcfg, params = _serve_repl_case(name)
    want = _reference_served(SERVE_REPL[name][0], jcfg, params)
    got = ranks[0]["logits"]
    assert got.shape == want.shape == (SERVE_STEPS + 1, SERVE_B, jcfg.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", list(SERVE_REPL))
def test_serve_repl_counted_collectives_equal_the_dry_run(results, name):
    """Each rank's collectives in each weight-stationary decode step, by
    axis and kind in count and bytes, equal ``run_cell(mesh=(2, 2),
    opts={"serve_repl"})``'s for rank 0 on meta; no weight is gathered:
    the data axis's all-gathers are the inputs' one and one for each
    attention's outputs, and the model axis gathers only the logits (and
    an L-sharded cache)."""
    want = _serve_repl_cell(name)["collectives"]["by_axis_kind_perdev"]
    for rank, r in enumerate(results[0][f"serve_repl {name}"]):
        for phase in r["phases"][1:]:
            assert phase["collectives"]["by_axis_kind"] == want, (rank, phase["phase"])
    cfg = _serve_repl_case(name)[0]
    attns = sum(k in ("attn", "local_attn") for k in cfg.blocks()) * (2 if cfg.is_encdec else 1)
    assert want["data all-gather"][0] == 1 + attns
    split_cache = cfg.num_kv_heads % MESH[1] != 0
    assert want["model all-gather"][0] == 1 + (cfg.num_layers if split_cache else 0)


def test_serve_repl_on_pods_splits_the_residual_as_the_weights(results):
    """d = 54 on (data 4 as 2 pods x 2, model 1): only the pods divide the
    weights' ``embed`` dim, so the residual stream splits over the pods
    (its sums all-reduced on ``pod``, nothing summed on ``data``, which
    gathers the rows); every rank's logits equal rank 0's, within 1e-5 of
    the largest |logit| of the one-device model's from the same seed, and
    the counts equal the dry-run's on (pod 2, data 2, model 1)."""
    ranks, want = results[0]["serve_repl pods"], results[3]["serve_repl pods"]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["logits"], ranks[0]["logits"])
    ref = want["logits"]
    np.testing.assert_allclose(ranks[0]["logits"], ref, rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))
    res = dryrun.run_cell(TINY, ShapeConfig("decode", SERVE_LEN, SERVE_B, "decode"),
                          mesh=(2, 2, 1), cfg=POD_CFG, opts={"serve_repl"})
    counted = res["collectives"]["by_axis_kind_perdev"]
    assert "pod all-reduce" in counted and "data all-reduce" not in counted
    for r in ranks:
        for phase in r["phases"][1:]:
            assert phase["collectives"]["by_axis_kind"] == counted
