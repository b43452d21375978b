"""The port's dry run (``quip_for_all_tpu_torch/tools/dryrun_multichip.py``,
the counterpart of the JAX package's ``__graft_entry__.py``
``dryrun_multichip``) on gloo ranks on the CPU (``device="cpu"``; the
tool runs on the card by default): at n = 8 phases 1-5 pass, phase 1 (a
finetune step over dp 2 x tp 4) printing the JAX dry run's line; each n
selects the phases the JAX dry run's conditions select (at n = 2 phases 1
and 5); the card is refused where there is none; a failing phase makes
the command exit 1 and print no phase's line."""
import re

import pytest
import torch

from quip_for_all_tpu_torch.tools import dryrun_multichip as D

pytestmark = pytest.mark.fast


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread a test worker (the spawned ranks set their own),
    so that a parallel test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dryrun_multichip_8_passes_phases_2_to_5():
    lines = D.dryrun_multichip(8, device="cpu")
    assert re.fullmatch(r"dryrun_multichip\(8\): mesh=\{'dp': 2, 'tp': 4\} "
                        r"loss=\d+\.\d{4} trainable_leaves=\d+", lines[0])
    assert lines[1].startswith("dryrun_multichip hybrid: "
                               "dcn[dp=2] x ici[tp=4] decode logits (2, 512)")
    assert lines[2].startswith("dryrun_multichip pp(2) and sp(4) logits "
                               "(2, 16, 512) agree ok")
    assert lines[3].startswith("dryrun_multichip ep: mixtral ep=4 x tp=2 "
                               "decode parity vs sparse loop ok (2, 512)")
    assert lines[4].startswith("dryrun_multichip serving: tp=2 engine "
                               "served 2 requests ok (9,9) tokens")
    assert len(lines) == 5


def test_dryrun_multichip_2_runs_phase_5_only():
    """Phase 5's body is the one the n = 8 run passes; here only which
    phases n = 2 selects (no second group of ranks): phase 5 and, as at
    every n, phase 1."""
    assert D.phases_for(2) == [1, 5]


# __graft_entry__.py's conditions: phase 1 every n, phase 2 n even and
# >= 4, phase 3 n >= 4, phase 4 n >= 8, phase 5 n >= 2
@pytest.mark.parametrize("n,want", [(1, [1]), (3, [1, 5]),
                                    (4, [1, 2, 3, 5]), (5, [1, 3, 5]),
                                    (6, [1, 2, 3, 5]), (8, [1, 2, 3, 4, 5]),
                                    (9, [1, 3, 4, 5])])
def test_phases_follow_the_jax_dry_runs_conditions(n, want):
    assert D.phases_for(n) == want


def test_dryrun_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.main(["2"])


def test_failing_phase_exits_nonzero(monkeypatch, capsys):
    def fail(n, device):
        raise AssertionError("dryrun_multichip failed:\nrank 0 phase 4: x")
    monkeypatch.setattr(D, "dryrun_multichip", fail)
    assert D.main(["8", "--device", "cpu"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "phase 4" in out.err
