"""The checks of ``tests/test_torch_tp.py`` at tp = 4: one group of 4 gloo
ranks against tp = 1, in a file of its own so that the tp = 2 and tp = 4
groups can run on two test workers (each group takes tens of seconds on
the CPU).  Besides the scenario matrix, the ledgers, the logits and the
shards, the refusals of command-r-plus-104b's and qwen3-moe-30b-a3b's
smoke configs, whose 2 KV heads tp = 4 does not divide.  The same group
also serves moonshot-v1-16b-a3b's smoke config (8 routed experts, 2 on
each rank, and a shared one) on the bridged tree of
``tests/test_torch_tp_families.py``: a greedy and a sampled request,
paged, whole and in chunks of 8."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.configs import get_config as jax_config  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.sharding import runs  # noqa: E402
from repro_torch.sharding.rules import local_slice, param_rules  # noqa: E402

from test_torch_tp import (ENGINE, _arrivals, _results,  # noqa: E402,F401
                           test_shard_model_holds_the_tp1_weights,
                           test_tp_dispatch_bound, test_tp_every_rank_agrees_with_rank_0,
                           test_tp_collectives_are_exact, test_tp_ledgers,
                           test_tp_logits_match_tp1,
                           test_tp_preemption_equivalence, test_tp_prefix_cache_equivalence,
                           test_tp_refusals, test_tp_stream_equivalence)
from test_torch_xlstm import _reference_params  # noqa: E402

MOONSHOT = get_config("moonshot-v1-16b-a3b", smoke=True)
CHUNKS = (0, 8)


def _moonshot_jobs():
    """Paged, whole and chunked: one greedy request and one sampled, the
    routing recorded; then the rank's parameters."""
    arrivals = _arrivals(MOONSHOT, n=2)
    return [runs.Serve(f"paged/{chunk}", dict(ENGINE, cache_layout="paged", prefill_chunk=chunk),
                       arrivals, record=True) for chunk in CHUNKS] + [runs.Params()]


@pytest.fixture(scope="module")
def results():
    tree = _reference_params(jax_config(MOONSHOT.name, smoke=True))
    return _results(4, extra=[(runs.Weights(MOONSHOT, tree=tree), _moonshot_jobs())])


@pytest.mark.parametrize("chunk", CHUNKS, ids=["whole", "chunked"])
def test_tp4_moonshot_streams_equal_tp1(results, chunk):
    """moonshot at tp = 4 (2 local experts, a quarter of the shared MLP):
    the greedy and the sampled stream equal tp = 1's on every rank, and
    every rank routes every MoE call as rank 0 does."""
    res, _ = results
    want = res[1][0][-1][CHUNKS.index(chunk)]
    assert len(want["streams"]) == 2
    lead = res[4][0][-1][CHUNKS.index(chunk)]
    for rank in range(4):
        got = res[4][rank][-1][CHUNKS.index(chunk)]
        assert got["streams"] == want["streams"], rank
        assert len(got["routes"]["ids"]) == len(want["routes"]["ids"]) > 0
        assert all(np.array_equal(a, b) for a, b in zip(got["routes"]["ids"],
                                                       lead["routes"]["ids"])), rank


def test_tp4_moonshot_shards_hold_the_tp1_weights(results):
    """Each of the 4 ranks holds 2 of the 8 experts, the router's matching
    columns and a quarter of the shared MLP: its slices of tp = 1's
    bridged weights."""
    res, _ = results
    full = res[1][0][-1][-1]
    rules = param_rules(Model(MOONSHOT, device="meta"))
    for rank in range(4):
        shard = res[4][rank][-1][-1]
        assert shard["layers.0.mlp.wg"].shape[0] == 2
        assert shard["layers.0.mlp.router"].shape[1] == 2
        assert shard["layers.0.mlp.shared.wd"].shape[0] == MOONSHOT.d_ff // 4
        for name, p in shard.items():
            assert np.array_equal(p, local_slice(rules[name], full[name], rank, 4)), name
