"""The port's training path against the reference's, on the CPU.

AdamW, its schedules and clipping on random trees; the decay set on the
reference's stacked tree; the masked cross entropy; one step's loss and
every gradient against ``jax.value_and_grad`` of the reference's
``make_loss_fn`` on bridged parameters (qwen1.5-0.5b: QKV bias and a tied
table; tinyllama-1.1b; command-r-plus-104b: the parallel block;
recurrentgemma-2b: window, softcap, RG-LRU through K5's plain version);
the 12-step fp32 trajectory against ``jax.jit(make_train_step(...))``;
remat; the differentiable head product; the kernels' autograd Functions
(their forward swapped for the plain version: the kernels run on a GPU only);
and ``launch.train.main`` end to end with a resume, its energy window
holding the end-of-run checkpoint.  The reference's own driver is not
called (ROADMAP "Reference caveat").  The other families' training is held
in ``test_torch_train_families.py`` and ``test_torch_train_xlstm.py``.
"""

import functools
import json
import time

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import step as jax_step  # noqa: E402
from repro_torch.bridge import params_from_jax, reference_by_port_name  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import energy as energy_lib  # noqa: E402
from repro_torch.data.synthetic import SyntheticConfig, SyntheticDataset  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.kernels.linear_recurrence import ops as lr_ops  # noqa: E402
from repro_torch.kernels.linear_recurrence import ref as lr_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rn_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import ref as rn_ref  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.training import optimizer as opt_lib  # noqa: E402
from repro_torch.training import step as step_lib  # noqa: E402

from test_torch_unified import shared_jax_compiles  # noqa: E402,F401 (autouse)

GRAD_ARCHS = ["qwen1.5-0.5b", "tinyllama-1.1b", "command-r-plus-104b", "recurrentgemma-2b"]
# fp32 on both sides, sums in another order: each gradient within this
# share of its largest entry (~2e-6 measured)
GRAD_TOL = 2e-5
# the trajectory: warm-up to 3e-3 over 4 of 12 steps, then cosine
LR, WARMUP, STEPS = 3e-3, 4, 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """A step of a smoke model is hundreds of small ops: at torch's default
    intra-op threads the test run's workers oversubscribe the cores and
    such a test took 15-30x its serial time (a 6-worker run).  One
    thread for the module, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seq_len(cfg):
    """Past a sliding window where the config has one, so it shows."""
    return cfg.sliding_window + 8 if cfg.sliding_window else 16


def _batch(cfg, B, index=0, seed=3):
    ds = SyntheticDataset(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=_seq_len(cfg),
                                          batch_size=B, seed=seed))
    return ds.batch_at(index)


@functools.lru_cache(maxsize=None)
def _reference_init(arch):
    """Parameters of ``arch``'s smoke config in the reference's tree
    (the decoder's and an encoder's groups stacked), drawn by the port's
    ``init`` at the reference initializer's scales: the shapes come from
    ``jax.eval_shape``, so no reference init is compiled."""
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    shapes = jax.eval_shape(lambda k: jax_model.init(jcfg, k)[0], jax.random.PRNGKey(0))
    port = {k: p.detach().numpy() for k, p in model_lib.init(
        cfg, torch.Generator().manual_seed(0), device="cpu").named_parameters()}
    stacks = {"decoder": (cfg, ""), "encoder": (model_lib._enc_cfg(cfg), "encoder.")}

    def leaf(path, s):
        keys = [str(getattr(p, "key", p)) for p in path]
        if keys[0] not in stacks:
            name = ".".join(keys)
        else:
            c, pre = stacks[keys[0]]
            plen, (n_groups, _) = len(c.block_pattern), c.layer_groups()
            if keys[1] == "groups":
                i, rest = int(keys[2]), ".".join(keys[3:])
                return np.stack([port[f"{pre}layers.{g * plen + i}.{rest}"]
                                 for g in range(n_groups)])
            if keys[1] == "rest":
                name = f"{pre}layers.{n_groups * plen + int(keys[2])}." + ".".join(keys[3:])
            else:
                name = pre + ".".join(keys[1:])
        assert port[name].shape == s.shape, name
        return port[name]

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _reference_params(arch):
    """The reference's init, norm scales and QKV biases (zeros there)
    perturbed so every parameter matters."""
    rng = np.random.default_rng(0)

    def leaf(path, arr):
        if str(getattr(path[-1], "key", "")) in ("scale", "bq", "bk", "bv"):
            arr = arr + 0.1 * rng.standard_normal(arr.shape).astype(arr.dtype)
        return arr

    return jax.tree_util.tree_map_with_path(leaf, _reference_init(arch))


def _by_name(cfg, tree):
    return reference_by_port_name(cfg, jax.tree.map(np.asarray, tree))


def _assert_tree(cfg, ref_tree, port: dict, rel=None, atol=None, flat=False):
    """Each leaf within ``rel`` of its largest reference entry, or ``atol``;
    ``flat``: ``ref_tree`` is already by port name."""
    ref = ref_tree if flat else _by_name(cfg, ref_tree)
    assert set(ref) == set(port)
    for k, t in port.items():
        a, b = ref[k].astype(np.float32), t.detach().float().numpy()
        tol = atol if atol is not None else rel * max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(b, a, rtol=0, atol=tol, err_msg=k)


# -- (a) AdamW, schedules, clipping -------------------------------------------

def _random_tree(rng, dtype=np.float32):
    shapes = {"w": (6, 5), "stack": (3, 4, 2), "norm": (5,), "bias": (4,), "scalar": ()}
    return {k: rng.standard_normal(s).astype(dtype) for k, s in shapes.items()}


@pytest.mark.parametrize("schedule", ["constant", "warmup_cosine"])
def test_adamw_matches_the_reference_on_random_trees(schedule):
    """fp32 params and moments, decay on leaves of 2+ dims, over 6 steps."""
    make = {"constant": lambda lib: lib.constant_schedule(0.05),
            "warmup_cosine": lambda lib: lib.warmup_cosine_schedule(0.05, 2, 6)}[schedule]
    rng = np.random.default_rng(1)
    params, grads = _random_tree(rng), [_random_tree(rng) for _ in range(6)]
    jo, to = jax_opt.AdamW(schedule=make(jax_opt)), opt_lib.AdamW(schedule=make(opt_lib))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jo.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = to.init(tp)
    for g in grads:
        jp, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        to.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp,
                  {k: v.dim() for k, v in tp.items()})
    assert ts.count == int(js.count) == 6
    for ours, theirs in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
        for k in params:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_adamw_rounds_a_bf16_parameter_once():
    """fp32 moments beside a bf16 parameter; the new value rounded once."""
    rng = np.random.default_rng(2)
    p = rng.standard_normal((8, 8)).astype(np.float32)
    gs = [rng.standard_normal((8, 8)).astype(np.float32) for _ in range(3)]
    jo = jax_opt.AdamW(schedule=jax_opt.constant_schedule(0.01))
    to = opt_lib.AdamW(schedule=opt_lib.constant_schedule(0.01))
    jp = {"w": jnp.asarray(p, jnp.bfloat16)}
    js = jo.init(jp)
    tp = {"w": torch.from_numpy(p).to(torch.bfloat16)}
    ts = to.init(tp)
    for g in gs:
        jp, js = jo.update({"w": jnp.asarray(g, jnp.bfloat16)}, js, jp)
        to.update({"w": torch.from_numpy(g).to(torch.bfloat16)}, ts, tp, {"w": 2})
    assert ts.mu["w"].dtype == torch.float32 and tp["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["w"].float().numpy(),
                                  np.asarray(jp["w"].astype(jnp.float32)))
    np.testing.assert_allclose(ts.nu["w"].numpy(), np.asarray(js.nu["w"]), rtol=1e-6)


def test_schedules_match_the_reference():
    for make in (lambda lib: lib.constant_schedule(3e-4),
                 lambda lib: lib.warmup_cosine_schedule(3e-4, 20, 100, min_ratio=0.1)):
        ours, theirs = make(opt_lib), make(jax_opt)
        for step in range(0, 131, 3):
            assert ours(step) == pytest.approx(float(theirs(jnp.asarray(step))), rel=1e-6)


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    """The norm in fp32 and each gradient cast back to its dtype (a bf16
    leaf stays bf16), clipped or left alone."""
    rng = np.random.default_rng(3)
    tree = _random_tree(rng)
    bf = rng.standard_normal((7,)).astype(np.float32)
    jt = {**{k: jnp.asarray(v) for k, v in tree.items()}, "bf": jnp.asarray(bf, jnp.bfloat16)}
    tt = {**{k: torch.from_numpy(v.copy()) for k, v in tree.items()},
          "bf": torch.from_numpy(bf).to(torch.bfloat16)}
    jc, jn = jax_opt.clip_by_global_norm(jt, max_norm)
    tc, tn = opt_lib.clip_by_global_norm(tt, max_norm)
    assert float(tn) == pytest.approx(float(jn), rel=1e-6)
    assert tc["bf"].dtype == torch.bfloat16
    for k in jt:
        np.testing.assert_allclose(tc[k].float().numpy(), np.asarray(jc[k], np.float32),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def _reference_leaf_ndims(jcfg, cfg):
    """Each port parameter's dimension count in the reference's tree (a
    leaf under ``decoder.groups`` carries the group axis)."""
    shapes = jax.eval_shape(lambda k: jax_model.init(jcfg, k)[0], jax.random.PRNGKey(0))

    def leaf(path, s):
        if any(getattr(p, "key", None) == "groups" for p in path):
            return np.full((s.shape[0],), len(s.shape))
        return np.int64(len(s.shape))

    tree = jax.tree_util.tree_map_with_path(leaf, shapes)
    return {k: int(v) for k, v in reference_by_port_name(cfg, tree).items()}


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "tinyllama-1.1b", "moonshot-v1-16b-a3b",
                                  "xlstm-1.3b", "seamless-m4t-large-v2", "llava-next-34b"])
def test_decay_set_is_read_on_the_reference_tree(arch):
    """recurrentgemma's smoke config has a remainder layer (``decoder.rest``):
    its norm scales and ``lambda`` do not decay, the grouped layers' do;
    the port's own tensors are all 1-D there.  The reference stacks the
    encoder's layers too (``encoder.groups``), so seamless's encoder norm
    scales decay and its encoder's final norm does not."""
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    model = model_lib.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    params = dict(model.named_parameters())
    ndims = opt_lib.reference_ndims(cfg, params)
    assert ndims == _reference_leaf_ndims(jcfg, cfg)
    own = {k for k, p in params.items() if p.dim() >= 2}
    ref = {k for k, n in ndims.items() if n >= 2}
    assert own < ref and "final_norm.scale" not in ref
    if cfg.layer_groups()[1]:
        assert "layers.3.norm1.scale" not in ref and "layers.0.norm1.scale" in ref
    if cfg.is_encdec:
        assert "encoder.layers.1.norm2.scale" in ref and "encoder.final_norm.scale" not in ref


# -- (b) the loss ---------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_the_reference(masked):
    rng = np.random.default_rng(4)
    logits = (3 * rng.standard_normal((3, 5, 11))).astype(np.float32)
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    labels[0, :3] = logits[0, :3].argmax(-1)  # some hits for the accuracy
    mask = (rng.random((3, 5)) < 0.6).astype(np.float32) if masked else None
    jl, jm = jax_step.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    None if mask is None else jnp.asarray(mask))
    tl, tm = step_lib.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                    None if mask is None else torch.from_numpy(mask))
    assert float(tl) == pytest.approx(float(jl), rel=1e-6)
    for k in ("loss", "accuracy", "tokens"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6), k
    assert float(tm["accuracy"]) > 0


# -- (c) one step's loss and gradients ---------------------------------------------

@pytest.fixture(scope="module")
def reference_grads():
    """(loss, aux, grads) of the reference's ``make_loss_fn`` per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_config(arch, smoke=True)
            params = _reference_params(arch)
            batch = _batch(jcfg, 2)
            fn = jax.jit(jax.value_and_grad(jax_step.make_loss_fn(jcfg, remat=False),
                                            has_aux=True))
            (loss, aux), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
            cache[arch] = params, batch, float(loss), {k: float(v) for k, v in aux.items()}, grads
        return cache[arch]

    return get


def _port_grads(cfg, params, batch, remat):
    model = params_from_jax(cfg, params, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    loss, aux = step_lib.make_loss_fn(cfg, remat=remat)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    named = dict(model.named_parameters())
    return loss, aux, dict(zip(named, torch.autograd.grad(loss, list(named.values()))))


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_one_step_loss_and_gradients_match_the_reference(arch, reference_grads):
    params, batch, jloss, jaux, jgrads = reference_grads(arch)
    cfg = get_config(arch, smoke=True)
    loss, aux, grads = _port_grads(cfg, params, batch, remat=False)
    assert loss.item() == pytest.approx(jloss, rel=1e-6)
    for k in ("accuracy", "tokens"):
        assert float(aux[k]) == pytest.approx(jaux[k], rel=1e-6)
    _assert_tree(cfg, jgrads, grads, rel=GRAD_TOL)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "command-r-plus-104b"])
def test_remat_equals_no_remat(arch, reference_grads):
    """Recomputing each group in the backward changes nothing."""
    params, batch = reference_grads(arch)[:2]
    cfg = get_config(arch, smoke=True)
    l0, _, g0 = _port_grads(cfg, params, batch, remat=False)
    l1, _, g1 = _port_grads(cfg, params, batch, remat=True)
    assert l0.item() == l1.item()
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0, msg=k)


# -- (d) the 12-step trajectory ------------------------------------------------------

@pytest.mark.parametrize("microbatches", [1, 4])
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-2b"])
def test_trajectory_matches_the_reference_train_step(arch, microbatches):
    """12 fp32 steps of batch 8 on synthetic data from perturbed norm
    scales (so that decaying them or not shows): loss and grad_norm
    within rtol 1e-4 at every step (~1e-7 measured); after step 12 every
    parameter within 5 % of the peak learning rate and every moment within
    1e-4 of its leaf's largest entry (~4e-6 measured).  An Adam step moves
    an element by about lr whatever its gradient's size, so where a
    gradient is near zero, rounding can turn the step: one element of
    qwen's 8192 in a ``wu`` ends 1.1 % of lr away, the others below
    0.3 %."""
    jcfg, cfg = jax_config(arch, smoke=True), get_config(arch, smoke=True)
    jo = jax_opt.AdamW(schedule=jax_opt.warmup_cosine_schedule(LR, WARMUP, STEPS))
    to = opt_lib.AdamW(schedule=opt_lib.warmup_cosine_schedule(LR, WARMUP, STEPS))
    params = _reference_params(arch)
    jparams = jax.tree.map(jnp.asarray, params)
    jstate = jax_step.TrainState(params=jparams, opt=jo.init(jparams),
                                 step=jnp.zeros((), jnp.int32))
    state = step_lib.train_state(params_from_jax(cfg, params, device="cpu"), to)
    jfn = jax.jit(jax_step.make_train_step(jcfg, jo, remat=False, microbatches=microbatches))
    tfn = step_lib.make_train_step(cfg, to, remat=False, microbatches=microbatches)
    for i in range(STEPS):
        batch = _batch(cfg, 8, index=i)
        jstate, jm = jfn(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tm = tfn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-4), (i, k)
        assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert state.step == state.opt.count == int(jstate.opt.count) == STEPS
    _assert_tree(cfg, jstate.params, state.params(), atol=0.05 * LR)
    _assert_tree(cfg, jstate.opt.mu, state.opt.mu, rel=1e-4)
    _assert_tree(cfg, jstate.opt.nu, state.opt.nu, rel=1e-4)


# -- (f) the head product --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_head_product_gradients_match_the_reference_unembed(dtype, softcap):
    """The differentiable ``matmul_fp32`` behind ``unembed``: its forward
    as before, dX and dW equal to the reference's VJP (fp32 products on
    the CPU; bf16 within one rounding)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    table = rng.standard_normal((40, 16)).astype(np.float32)
    cot = rng.standard_normal((2, 3, 40)).astype(np.float32)
    jdt = jnp.dtype(dtype)
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(table, jdt)
    jout, vjp = jax.vjp(lambda x, w: jax_layers.unembed({"table": w}, x, softcap), jx, jw)
    jdx, jdw = vjp(jnp.asarray(cot))
    tdt = getattr(torch, dtype)
    emb = layers.Embedding(40, 16, tdt, "cpu")
    with torch.no_grad():
        emb.table.copy_(torch.from_numpy(table).to(tdt))
    emb.table.requires_grad_(True)
    tx = torch.from_numpy(x).to(tdt).requires_grad_(True)
    out = layers.unembed(emb, tx, softcap)
    assert "MatmulFP32" in type(out.grad_fn).__name__ or softcap
    dx, dw = torch.autograd.grad(out, (tx, emb.table), torch.from_numpy(cot))
    tol = 1e-5 if dtype == "float32" else 1e-2
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    for ours, theirs in ((dx, jdx), (dw, jdw)):
        assert ours.dtype == tdt
        np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32),
                                   rtol=tol, atol=tol)


# -- the kernels' autograd Functions --------------------------------------------------------

def _flash_case(rng):
    q = rng.standard_normal((2, 20, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 20, 2, 8)).astype(np.float32) for _ in range(2))
    pos = torch.arange(20, dtype=torch.int32).expand(2, 20).contiguous()
    kw = dict(q_positions=pos, k_positions=pos, causal=True, window=6, softcap=5.0)
    args = [torch.from_numpy(t) for t in (q, k, v)]
    return (args,
            lambda q, k, v: fa_ops._FlashAttention.apply(q, k, v, pos, pos, True, 6, 5.0),
            lambda q, k, v: fa_ref.plain_attention(q, k, v, **kw))


def _kernel_cases():
    """(name, inputs, the Function, the plain version, the kernel
    function the Function launches, its plain stand-in)."""
    rng = np.random.default_rng(6)
    x, r = (torch.from_numpy(rng.standard_normal((3, 16)).astype(np.float32)) for _ in "xr")
    s = torch.from_numpy(0.1 * rng.standard_normal(16).astype(np.float32))
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 9, 5)).astype(np.float32))
    b, h0 = (torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
             for sh in ((2, 9, 5), (2, 5)))
    fa_args, fa_fn, fa_plain = _flash_case(rng)
    return {
        "rmsnorm": ([x, s], lambda x, s: rn_ops._RMSNorm.apply(x, s, 1e-6),
                    lambda x, s: rn_ref.rmsnorm(x, s, 1e-6),
                    (rn_ops, "_rmsnorm_kernel", rn_ref.rmsnorm)),
        "add_rmsnorm": ([x, r, s], lambda x, r, s: rn_ops._AddRMSNorm.apply(x, r, s, 1e-6),
                        lambda x, r, s: rn_ref.add_rmsnorm(x, r, s, 1e-6),
                        (rn_ops, "_add_rmsnorm_kernel", rn_ref.add_rmsnorm)),
        "flash_attention": (fa_args, fa_fn, fa_plain,
                            (fa_ops, "_flash_kernel",
                             lambda q, k, v, qp, kp, c, w, sc: fa_ref.attention(
                                 q, k, v, q_positions=qp, k_positions=kp, causal=c, window=w,
                                 softcap=sc))),
        "linear_recurrence": ([a, b, h0], lr_ops._LinearRecurrence.apply,
                              lr_ref.linear_recurrence,
                              (lr_ops, "_linear_recurrence_kernel", lr_ref.linear_recurrence)),
    }


@pytest.mark.parametrize("name", ["rmsnorm", "add_rmsnorm", "flash_attention",
                                  "linear_recurrence"])
def test_kernel_functions_backward_is_the_plain_vjp(name, monkeypatch):
    """Each wrapper's ``autograd.Function`` with the kernel swapped for its
    plain version (the kernel runs on the card only): every input's
    gradient equals autograd through the plain version, both outputs'
    cotangents summed for the fused K1."""
    inputs, fn, plain, (mod, attr, stand_in) = _kernel_cases()[name]
    monkeypatch.setattr(mod, attr, stand_in)
    rng = np.random.default_rng(7)
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = [torch.from_numpy(rng.standard_normal(o.shape).astype(np.float32)) for o in outs]
    got = torch.autograd.grad(outs, leaves, cots)
    ref_leaves = [t.clone().requires_grad_(True) for t in inputs]
    ref_outs = plain(*ref_leaves)
    ref_outs = ref_outs if isinstance(ref_outs, tuple) else (ref_outs,)
    want = torch.autograd.grad(ref_outs, ref_leaves, cots)
    for o, ro in zip(outs, ref_outs):
        torch.testing.assert_close(o, ro, rtol=0, atol=0)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


# -- (i) the driver ----------------------------------------------------------------------

DRIVER = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--batch", "4",
          "--seq-len", "32", "--lr", "3e-3", "--warmup", "2", "--log-every", "100"]
OUT_KEYS = {"steps", "final_step", "loss_first", "loss_last", "mean_step_ms", "stragglers",
            "wall_s", "preempted"}


def test_train_driver_end_to_end_with_a_resume(tmp_path, capsys, monkeypatch):
    """10 steps in one run; then the same run preempted before step 6
    (checkpoints at 3 and 6) and resumed for the last 4: the resumed
    losses equal the uninterrupted run's bit for bit on the CPU.  The
    output keys are the reference driver's."""
    whole = train_lib.run(train_lib.build_argparser().parse_args(
        DRIVER + ["--steps", "10"]))[1].losses
    ck = str(tmp_path / "ck")

    class PreemptedAtSix(train_lib.PreemptionHandler):
        polls = 0

        @property
        def preemption_requested(self):  # polled once before each step
            PreemptedAtSix.polls += 1
            return PreemptedAtSix.polls > 6

    with monkeypatch.context() as m:
        m.setattr(train_lib, "PreemptionHandler", PreemptedAtSix)
        assert train_lib.main(DRIVER + ["--steps", "10", "--ckpt-dir", ck,
                                        "--ckpt-every", "3"]) == 0
    printed = capsys.readouterr().out
    first = json.loads(printed[printed.index("{"):])
    assert set(first) == OUT_KEYS and first["steps"] == 6 and first["preempted"]
    assert first["loss_last"] < first["loss_first"]
    out, rec = train_lib.run(train_lib.build_argparser().parse_args(
        DRIVER + ["--steps", "10", "--ckpt-dir", ck, "--energy"]))
    assert "resumed from step 6" in capsys.readouterr().out
    assert set(out) == OUT_KEYS | {"avg_watts", "joules", "j_per_step"}
    assert out["final_step"] == 10 and out["steps"] == 4 and rec.steps == [6, 7, 8, 9]
    assert not out["preempted"] and rec.losses == whole[6:]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == [
        "LATEST", "step_00000003", "step_00000006", "step_00000010"]


def test_train_driver_energy_window_holds_the_final_checkpoint(tmp_path, monkeypatch):
    """``--energy`` with ``--ckpt-dir``: the power monitor is still open
    while the end-of-run checkpoint is written, as the reference's window
    is, so ``joules`` counts the samples the write took (a stub reader at
    a constant 100 W, the write slowed by 0.3 s)."""
    WATTS, PAUSE = 100.0, 0.3

    class Constant(energy_lib.PowerReader):
        def read_watts(self):
            return [WATTS]

    saves = []
    real_save = train_lib.ckpt_lib.save

    def slow_save(*args, **kwargs):
        t0 = time.perf_counter()
        time.sleep(PAUSE)
        real_save(*args, **kwargs)
        saves.append((t0, time.perf_counter()))

    monkeypatch.setattr(train_lib.energy_lib, "ProcStatReader", Constant)
    monkeypatch.setattr(train_lib.ckpt_lib, "save", slow_save)
    out, rec = train_lib.run(train_lib.build_argparser().parse_args(
        DRIVER + ["--steps", "2", "--energy", "--ckpt-dir", str(tmp_path / "ck")]))
    (s0, s1), = saves  # the end-of-run checkpoint alone
    t0, t1 = rec.monitor.window
    assert t0 < s0 and s1 <= t1
    assert len([t for t, _ in rec.monitor._samples if s0 <= t <= s1]) >= 2
    assert rec.monitor.joules_between(s0, s1) == pytest.approx(WATTS * (s1 - s0), rel=1e-6)
    assert out["joules"] == pytest.approx(WATTS * (t1 - t0), rel=1e-3)
    assert out["joules"] >= WATTS * (s1 - t0) * (1 - 1e-3)


def test_train_driver_refuses_sharded_training():
    """``--mesh production`` is the reference's 16 x 16 mesh: with fewer
    than its 256 ranks (here the one process) the driver refuses before
    any process group starts, naming both counts."""
    with pytest.raises(ValueError, match=r"= 256 ranks .* the world has 1"):
        train_lib.main(DRIVER + ["--steps", "1", "--mesh", "production"])
