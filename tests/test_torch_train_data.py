"""The port's training data and run bookkeeping against the reference's:
synthetic batches and modality stubs byte for byte, ``.tokbin`` files
written by either package read by the other, ``Prefetcher``; checkpoints
(a bf16 leaf round trip, garbage collection, atomicity, the reference's
layout read by the reference's ``restore``, resume of ``RunPosition``);
the preemption handler and the straggler watchdog."""

import os
import signal
import time

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.data import synthetic as jax_synthetic  # noqa: E402
from repro.data import tokenbin as jax_tokenbin  # noqa: E402
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import pipeline, synthetic, tokenbin  # noqa: E402
from repro_torch.training import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.training.fault import (PreemptionHandler, RunPosition,  # noqa: E402
                                        StragglerWatchdog)


def _equal_batches(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,index,rank", [(0, 0, 0), (1, 3, 0), (1, 3, 1), (7, 250, 2)])
def test_synthetic_batches_equal_the_reference(seed, index, rank):
    kw = dict(vocab_size=300, seq_len=24, batch_size=4, seed=seed)
    ours = synthetic.SyntheticDataset(synthetic.SyntheticConfig(**kw))
    theirs = jax_synthetic.SyntheticDataset(jax_synthetic.SyntheticConfig(**kw))
    _equal_batches(ours.batch_at(index, rank), theirs.batch_at(index, rank))


@pytest.mark.parametrize("arch", ["llava-next-34b", "seamless-m4t-large-v2", "tinyllama-1.1b"])
def test_modality_stubs_equal_the_reference(arch):
    kw = dict(vocab_size=64, seq_len=10, batch_size=2, seed=1)
    data = synthetic.SyntheticDataset(synthetic.SyntheticConfig(**kw)).batch_at(0)
    ours = synthetic.batch_for_model(get_config(arch, smoke=True), data,
                                     np.random.default_rng(5))
    theirs = jax_synthetic.batch_for_model(jax_config(arch, smoke=True), data,
                                           np.random.default_rng(5))
    _equal_batches(ours, theirs)


@pytest.mark.parametrize("vocab", [97, 70_000])  # uint16 and uint32 bodies
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_tokbin_files_read_the_same_in_both_packages(tmp_path, vocab, writer):
    path = str(tmp_path / "data.tokbin")
    tokens = (np.arange(3000) * 7919) % vocab
    (tokenbin if writer == "port" else jax_tokenbin).write_tokenbin(path, tokens, vocab)
    for rank in (0, 1):
        ours = tokenbin.TokenBinDataset(path, seq_len=16, batch_size=3, rank=rank, world=2)
        theirs = jax_tokenbin.TokenBinDataset(path, seq_len=16, batch_size=3, rank=rank,
                                              world=2)
        assert ours.header == theirs.header
        assert ours.batches_per_epoch == theirs.batches_per_epoch
        got = [b for _, (e, o, b) in zip(range(ours.batches_per_epoch + 2),
                                          ours.iter_from(0, ours.batches_per_epoch - 1))]
        want = [b for _, (e, o, b) in zip(range(theirs.batches_per_epoch + 2),
                                           theirs.iter_from(0, theirs.batches_per_epoch - 1))]
        for a, b in zip(got, want):
            _equal_batches(a, b)


def test_prefetcher_equals_the_reference_and_raises_late():
    ds = synthetic.SyntheticDataset(synthetic.SyntheticConfig(vocab_size=50, seq_len=8,
                                                              batch_size=2))
    ours = pipeline.Prefetcher((ds.batch_at(i) for i in range(6)), depth=2)
    theirs = jax_pipeline.Prefetcher((ds.batch_at(i) for i in range(6)), depth=3)
    for a, b in zip(ours, theirs):
        _equal_batches(a, b)

    def boom():
        yield 1
        raise RuntimeError("boom")

    it = pipeline.Prefetcher(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 3, generator=g).to(torch.bfloat16),
                       "b": torch.randn(3, generator=g)},
            "opt_mu": {"w": torch.randn(4, 3, generator=g)}}


def test_checkpoint_round_trip_with_a_bf16_leaf(tmp_path):
    d = str(tmp_path)
    tree = _tree()
    final = ckpt_lib.save(d, 7, tree, metadata=RunPosition(7, 0, 7, 3).to_metadata())
    assert sorted(os.listdir(final)) == ["arrays.npz", "manifest.json"]
    template = {k: {n: torch.zeros_like(t) for n, t in v.items()} for k, v in tree.items()}
    restored, manifest = ckpt_lib.restore(d, template)
    assert manifest["arrays"]["params/w"] == {"shape": [4, 3], "dtype": "bfloat16"}
    for k, v in tree.items():
        for n, t in v.items():
            assert restored[k][n].dtype == t.dtype
            assert torch.equal(restored[k][n], t)
    pos = RunPosition.from_metadata(manifest)
    assert (pos.step, pos.data_offset, pos.rng_seed) == (7, 7, 3)
    with pytest.raises(KeyError, match="missing array"):
        ckpt_lib.restore(d, {"params": {"gone": torch.zeros(1)}})


def test_checkpoint_gc_atomicity_and_the_reference_layout(tmp_path):
    """``keep`` keeps the newest steps; a ``.tmp`` left by a crash never
    shadows a durable step; the reference's ``restore`` reads an fp32
    checkpoint the port wrote, and the port reads the reference's."""
    d = str(tmp_path / "port")
    for step in (10, 20, 30, 40):
        ckpt_lib.save(d, step, {"w": np.arange(5, dtype=np.float32) * step}, keep=2,
                      metadata=RunPosition(step, 0, step, 0).to_metadata())
    assert ckpt_lib.latest_step(d) == 40
    assert sorted(x for x in os.listdir(d) if x.startswith("step_")) == [
        "step_00000030", "step_00000040"]
    os.makedirs(os.path.join(d, "step_00000050.tmp"))  # a crash mid-write
    assert ckpt_lib.latest_step(d) == 40
    theirs, manifest = jax_ckpt.restore(d, {"w": np.zeros(5, np.float32)})
    np.testing.assert_array_equal(np.asarray(theirs["w"]), np.arange(5) * 40.0)
    assert RunPosition.from_metadata(manifest).data_offset == 40
    r = str(tmp_path / "reference")
    jax_ckpt.save(r, 3, {"w": np.ones(4, np.float32), "n": {"c": np.arange(3)}})
    ours, _ = ckpt_lib.restore(r, {"w": torch.zeros(4), "n": {"c": torch.zeros(3)}})
    assert torch.equal(ours["w"], torch.ones(4)) and ours["n"]["c"].tolist() == [0, 1, 2]
    assert ckpt_lib.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ckpt_lib.restore(str(tmp_path / "none"), {})


def test_preemption_handler_and_straggler_watchdog():
    h = PreemptionHandler().install()
    try:
        assert not h.preemption_requested
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.05)
        assert h.preemption_requested
    finally:
        h.uninstall()
    wd = StragglerWatchdog(alpha=0.5, threshold=2.0)
    flagged = []
    wd.on_straggler = lambda t: flagged.append(t.step)
    for i, pause in enumerate([0.02] * 4 + [0.2, 0.02]):
        wd.start_step()
        time.sleep(pause)
        wd.end_step(i)
    assert flagged == [4] and wd.straggler_count == 1
    assert not wd.history[-1].is_straggler
