"""The checks of ``tests/test_torch_tp.py`` at tp = 4: one group of 4 gloo
ranks against tp = 1, in a file of its own so that the tp = 2 and tp = 4
groups can run on two test workers (each group takes tens of seconds on
the CPU).  Besides the scenario matrix, the ledgers, the logits and the
shards, the refusal of command-r-plus-104b's smoke config, whose 2 KV
heads tp = 4 does not divide."""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_tp import (_results, test_shard_model_holds_the_tp1_weights,  # noqa: E402,F401
                           test_tp_dispatch_bound, test_tp_every_rank_agrees_with_rank_0,
                           test_tp_collectives_are_exact, test_tp_ledgers,
                           test_tp_logits_match_tp1,
                           test_tp_preemption_equivalence, test_tp_prefix_cache_equivalence,
                           test_tp_refusals, test_tp_stream_equivalence)


@pytest.fixture(scope="module")
def results():
    return _results(4)
