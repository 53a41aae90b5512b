"""Training of the MoE, vision-prefix and encoder-decoder families against
the reference's, on the CPU: moonshot-v1-16b-a3b (64 routed experts top-6
and shared experts, at its smoke size 8 top-2 and 1 shared),
llava-next-34b (the patch embeddings before the tokens, the loss over the
text positions) and seamless-m4t-large-v2 (the unmasked encoder over the
frame embeddings, each decoder block's cross attention over its output).

For each, at its smoke config in fp32 on the reference's parameters
(``bridge.params_from_jax``): one step's loss and every gradient against
``jax.value_and_grad`` of the reference's ``make_loss_fn``; the same with
remat (the decoder's and the encoder's groups recomputed), bit for bit;
the 12-step trajectory against the jitted reference ``make_train_step``
(moonshot at 1 and 2 microbatches: the capacity counts one microbatch's
rows, as the reference's scan over microbatches does); the driver end to
end (with qwen3-moe-30b-a3b); the vision loss over the text positions and
the encoder-decoder forward writing no cache entry.  The helpers here
serve ``test_torch_train_xlstm.py`` too.
"""

import functools
import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import step as jax_step  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    SyntheticConfig, SyntheticDataset, batch_for_model,
)
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training import step as step_lib  # noqa: E402

from test_torch_training import (  # noqa: E402,F401 (one_thread: autouse)
    GRAD_TOL, LR, STEPS, WARMUP, _assert_tree, _by_name, _port_grads, _reference_init,
    one_thread,
)

# the zero-initialised leaves perturbed, so that every parameter matters
# and decaying a norm scale or not shows in the trajectory
PERTURBED = ("scale", "norm_scale", "bq", "bk", "bv", "b_i", "b_z", "b_o")
SEQ = 16


@functools.lru_cache(maxsize=None)
def reference_params(arch):
    rng = np.random.default_rng(0)

    def leaf(path, arr):
        if str(getattr(path[-1], "key", "")) in PERTURBED:
            arr = arr + 0.1 * rng.standard_normal(arr.shape).astype(arr.dtype)
        return arr

    return jax.tree_util.tree_map_with_path(leaf, _reference_init(arch))


def family_batch(cfg, B, index=0):
    """Synthetic tokens of ``SEQ`` positions and the patch or frame
    embeddings the config needs, all drawn from ``index``."""
    data = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                            batch_size=B, seed=3)).batch_at(index)
    return batch_for_model(cfg, data, np.random.default_rng(index))


@functools.lru_cache(maxsize=None)
def reference_grads(arch, B=2):
    """(params, batch, loss, aux, grads) of the reference's loss, remat off."""
    jcfg = jax_config(arch, smoke=True)
    params, batch = reference_params(arch), family_batch(jcfg, B)
    fn = jax.jit(jax.value_and_grad(jax_step.make_loss_fn(jcfg, remat=False), has_aux=True))
    (loss, aux), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return params, batch, float(loss), {k: float(v) for k, v in aux.items()}, grads


def zero_gradients(cfg):
    """The leaves whose gradient is zero in exact arithmetic: an sLSTM
    cell's input-gate bias from a fresh state.  A shift of a unit's
    ``log_i`` at every step shifts its stabilizer ``m`` (which starts at
    -1e30) by as much and leaves ``c / n`` as it was, so both packages
    give rounding noise there (~1e-9 of the largest gradient)."""
    return {f"layers.{i}.cell.b_i" for i, k in enumerate(cfg.blocks()) if k == "slstm"}


def check_one_step(arch):
    """The loss, accuracy and token count of one step, and each gradient
    within ``GRAD_TOL`` of its leaf's largest entry; a gradient that is
    zero in exact arithmetic (``zero_gradients``) within 1e-7 of the
    largest entry of all on both sides."""
    params, batch, jloss, jaux, jgrads = reference_grads(arch)
    cfg = get_config(arch, smoke=True)
    loss, aux, grads = _port_grads(cfg, params, batch, remat=False)
    assert loss.item() == pytest.approx(jloss, rel=1e-6)
    for k in ("accuracy", "tokens"):
        assert float(aux[k]) == pytest.approx(jaux[k], rel=1e-6)
    zero = zero_gradients(cfg)
    ref = _by_name(cfg, jgrads)
    top = max(float(np.abs(a).max()) for a in ref.values())
    for k in zero:
        assert max(np.abs(ref[k]).max(), grads[k].abs().max().item()) <= 1e-7 * top, k
    _assert_tree(cfg, {k: a for k, a in ref.items() if k not in zero},
                 {k: g for k, g in grads.items() if k not in zero}, rel=GRAD_TOL, flat=True)


def check_remat(arch):
    """Recomputing each group (the decoder's and the encoder's) in the
    backward changes nothing."""
    params, batch = reference_grads(arch)[:2]
    cfg = get_config(arch, smoke=True)
    l0, _, g0 = _port_grads(cfg, params, batch, remat=False)
    l1, _, g1 = _port_grads(cfg, params, batch, remat=True)
    assert l0.item() == l1.item()
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)


def _reference_run(jcfg, jo, jfn, params, B, steps):
    """The jitted reference step ``jfn`` from ``params``: each step's
    (loss, grad_norm, lr) and the final state."""
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_step.TrainState(params=jparams, opt=jo.init(jparams),
                                 step=jnp.zeros((), jnp.int32))
    metrics = []
    for i in range(steps):
        batch = family_batch(jcfg, B, index=i)
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append((float(jm["loss"]), float(jm["grad_norm"]), float(jm["lr"])))
    return metrics, jstate


def _one_ulp(params):
    """``params`` with a third of each leaf's elements moved one ulp up and
    a third one ulp down."""
    rng = np.random.default_rng(11)

    def move(a):
        way = rng.choice([-1.0, 0.0, 1.0], a.shape)
        return np.where(way == 0, a, np.nextafter(a, np.copysign(np.inf, way).astype(a.dtype)))

    return jax.tree.map(move, params)


def check_trajectory(arch, B, microbatches=1, steps=STEPS, chaotic=False):
    """``steps`` fp32 steps of batch ``B`` against the jitted reference
    step: loss and grad_norm within rtol 1e-4 at every step; then every
    parameter within 5 % of the peak learning rate and every moment within
    1e-4 of its leaf's largest entry, the bounds of the dense decoders'
    trajectory test.

    ``chaotic``, for a model whose trajectory one ulp moves by more than
    that: Adam's first steps move an element by about the learning rate
    whatever its gradient's size, so an element whose gradient is at
    rounding level takes the sign of its rounding.  The reference run
    again from its parameters moved by one ulp gives its own sensitivity:
    each step's bound is at least twice that run's largest distance so
    far, each moment leaf's twice that run's distance at the end.  And at
    most one parameter element in 1000 of a leaf (one in a
    smaller leaf) may end past 5 % of the learning rate, none past twice
    it: a fault (a decay set, a gradient) moves whole leaves."""
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jo = jax_opt.AdamW(schedule=jax_opt.warmup_cosine_schedule(LR, WARMUP, steps))
    to = opt_lib.AdamW(schedule=opt_lib.warmup_cosine_schedule(LR, WARMUP, steps))
    params = reference_params(arch)
    jfn = jax.jit(jax_step.make_train_step(jcfg, jo, remat=False, microbatches=microbatches))
    ref, jstate = _reference_run(jcfg, jo, jfn, params, B, steps)
    state = step_lib.train_state(params_from_jax(cfg, params, device="cpu"), to)
    tfn = step_lib.make_train_step(cfg, to, remat=False, microbatches=microbatches)
    ours = []
    for i in range(steps):
        tm = tfn(state, {k: torch.from_numpy(v) for k, v in family_batch(cfg, B, i).items()})
        ours.append((float(tm["loss"]), float(tm["grad_norm"]), tm["lr"]))
    slack = np.zeros((steps, 2))
    if chaotic:
        moved, mstate = _reference_run(jcfg, jo, jfn, _one_ulp(params), B, steps)
        slack = 2 * np.maximum.accumulate(np.abs(np.subtract(moved, ref))[:, :2], axis=0)
    for i, (r, o) in enumerate(zip(ref, ours)):
        for j, k in enumerate(("loss", "grad_norm")):
            assert abs(o[j] - r[j]) <= max(1e-4 * abs(r[j]), slack[i, j]), (i, k, o[j], r[j])
        assert o[2] == pytest.approx(r[2], rel=1e-6)
    assert state.step == state.opt.count == int(jstate.opt.count) == steps
    if not chaotic:
        _assert_tree(cfg, jstate.params, state.params(), atol=0.05 * LR)
        _assert_tree(cfg, jstate.opt.mu, state.opt.mu, rel=1e-4)
        _assert_tree(cfg, jstate.opt.nu, state.opt.nu, rel=1e-4)
        return state
    want = _by_name(cfg, jax.tree.map(np.asarray, jstate.params))
    for k, t in state.params().items():
        d = np.abs(t.detach().numpy() - want[k])
        assert (d > 0.05 * LR).sum() <= max(1, d.size // 1000) and d.max() <= 2 * LR, k
    for name in ("mu", "nu"):
        want, other = (_by_name(cfg, jax.tree.map(np.asarray, getattr(st.opt, name)))
                       for st in (jstate, mstate))
        for k, t in getattr(state.opt, name).items():
            tol = max(1e-4 * float(np.abs(want[k]).max()),
                      2 * float(np.abs(other[k] - want[k]).max()))
            np.testing.assert_allclose(t.numpy(), want[k], rtol=0, atol=tol, err_msg=k)
    return state


def check_driver(arch, capsys):
    """``launch.train`` on the smoke config for 2 steps: the reference's
    output keys, finite losses."""
    assert train_lib.main(["--arch", arch, "--smoke", "--steps", "2", "--device", "cpu",
                           "--batch", "2", "--seq-len", str(SEQ)]) == 0
    printed = capsys.readouterr().out
    out = json.loads(printed[printed.index("{"):])
    assert out["steps"] == out["final_step"] == 2
    assert np.isfinite(out["loss_first"]) and np.isfinite(out["loss_last"])


ARCHS = ["moonshot-v1-16b-a3b", "llava-next-34b", "seamless-m4t-large-v2"]


@pytest.mark.parametrize("arch", ARCHS)
def test_one_step_loss_and_gradients_match_the_reference(arch):
    check_one_step(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_equals_no_remat(arch):
    check_remat(arch)


@pytest.mark.parametrize("arch,microbatches", [("moonshot-v1-16b-a3b", 1),
                                               ("moonshot-v1-16b-a3b", 2),
                                               ("llava-next-34b", 1),
                                               ("seamless-m4t-large-v2", 1)])
def test_trajectory_matches_the_reference_train_step(arch, microbatches):
    check_trajectory(arch, 4, microbatches)


def test_vision_loss_counts_the_text_positions_only():
    """The training forward's logits cover the patches and the tokens; the
    loss is the cross entropy of the text positions alone, and counts B * S
    of them."""
    arch = "llava-next-34b"
    params, batch = reference_grads(arch)[:2]
    cfg = get_config(arch, smoke=True)
    model = params_from_jax(cfg, params, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        logits = model.forward_train(tb, remat=False)
        loss, aux = step_lib.make_loss_fn(cfg, remat=False)(model, tb)
    B, S = batch["tokens"].shape
    assert logits.shape == (B, cfg.num_vision_tokens + S, cfg.vocab_size)
    want, _ = step_lib.cross_entropy(logits[:, cfg.num_vision_tokens:], tb["labels"])
    assert loss.item() == want.item() and float(aux["tokens"]) == B * S


def test_encdec_training_forward_writes_no_cache_entry(monkeypatch):
    """The encoder and every cross attention run with no cache: a write
    into one fails the forward, and the backward reaches the encoder."""
    def refuse(*args, **kwargs):
        raise AssertionError("the training forward wrote a cache entry")

    for name in ("fill_cross_cache", "fill_attn_cache", "fill_paged_cache"):
        monkeypatch.setattr(cache_lib, name, refuse)
    arch = "seamless-m4t-large-v2"
    params, batch = reference_grads(arch)[:2]
    cfg = get_config(arch, smoke=True)
    model = params_from_jax(cfg, params, device="cpu")
    enc = model.encoder.layers[0].attn.wq.requires_grad_(True)
    loss, _ = step_lib.make_loss_fn(cfg, remat=True)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    (g,) = torch.autograd.grad(loss, [enc])
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen3-moe-30b-a3b", "llava-next-34b",
                                  "seamless-m4t-large-v2"])
def test_train_driver_runs_the_family(arch, capsys):
    check_driver(arch, capsys)
