"""Training of the xLSTM family against the reference's, on the CPU:
xlstm-1.3b (mLSTM and sLSTM cells from a fresh state, the mLSTM chunk scan
and the sLSTM loop under autograd, the cells' norms through K1's
Function), with the checks of ``test_torch_train_families.py``: one
step's loss and every gradient against ``jax.value_and_grad`` of the
reference's loss, remat bit for bit, the 12-step trajectory against the
jitted reference step at batch 2 (its sLSTM is a loop over the positions
on both sides), and the driver end to end (with nemotron-h-8b's mLSTM
hybrid).
"""

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models import recurrent as rec_lib  # noqa: E402

from test_torch_train_families import (  # noqa: E402,F401 (one_thread: autouse)
    check_driver, check_one_step, check_remat, check_trajectory, one_thread, reference_grads,
)

ARCH = "xlstm-1.3b"


def test_one_step_loss_and_gradients_match_the_reference():
    check_one_step(ARCH)


def test_remat_equals_no_remat():
    check_remat(ARCH)


def test_trajectory_matches_the_reference_train_step():
    """The trajectory is ``chaotic``: the reference's own run from its
    parameters moved by one ulp has a grad_norm 2e-4 off by step 4 and
    3e-3 by step 8, and 4 of the embedding table's 16384 elements end
    0.05-1 learning rates from the reference's."""
    check_trajectory(ARCH, 2, chaotic=True)


def test_cells_start_from_the_initial_state(monkeypatch):
    """Each cell of the training forward starts from the state a fresh
    cache holds (``cache.INIT_FILL``: the stabilizers at -1e30, the rest
    0), as the reference's ``cache=None`` does, and nothing writes into
    it.  A zeroed stabilizer moves the loss by ~1e-5 only, below what the
    gradient tests see."""
    seen = []
    for name in ("apply_mlstm_seq", "apply_slstm_seq"):
        def spy(p, x, cfg, state, valid=None, _real=getattr(rec_lib, name)):
            before = {k: v.clone() for k, v in state.items()}
            out = _real(p, x, cfg, state, valid)
            seen.append((before, state))
            return out
        monkeypatch.setattr(rec_lib, name, spy)
    params, batch = reference_grads(ARCH)[:2]
    cfg = get_config(ARCH, smoke=True)
    model = params_from_jax(cfg, params, device="cpu")
    with torch.no_grad():
        model.forward_train({k: torch.from_numpy(v) for k, v in batch.items()}, remat=False)
    assert len(seen) == cfg.num_layers
    for before, after in seen:
        for k, v in before.items():
            assert torch.equal(v, torch.full_like(v, cache_lib.INIT_FILL.get(k, 0))), k
            assert torch.equal(after[k], v), k


@pytest.mark.parametrize("arch", [ARCH, "nemotron-h-8b"])
def test_train_driver_runs_the_family(arch, capsys):
    check_driver(arch, capsys)
