"""A CUDA graph replays the kernels of its capture, so ``StepRunner``
(``runtime/graphs.py``) captures a key again when a layer switch changed
after its capture (``set_ksplit``, ``set_right_in_kernel``,
``set_combine_planes``; ``nn/qlinear.py`` ``switch_epoch``). On the CPU
the runner runs eagerly; here its capture is stood in for by a recorder
(the same control flow: capture on a key's first run and on a changed
switch, replay otherwise), so the rule is checked without a card.
"""
import pytest
import torch

from quip_for_all_tpu_torch.models import llama as TM
from quip_for_all_tpu_torch.models.config import tiny_config
from quip_for_all_tpu_torch.nn.qlinear import switch_epoch
from quip_for_all_tpu_torch.runtime import graphs
from quip_for_all_tpu_torch.utils.random_quantized import \
    random_quantized_model

pytestmark = pytest.mark.fast


class _Recorded:
    """A stand-in CUDA graph: replay runs the captured body."""

    def __init__(self, body, switches):
        self.body, self.switches = body, switches

    def replay(self):
        self.body()


def _runner(monkeypatch, model):
    r = graphs.StepRunner(torch.device("cpu"), [], graphs=False)
    r.graphed = True
    seen = []

    def capture(body):
        lin = model.layers[0]["self_attn"]["o_proj"]
        seen.append((lin.right_in_kernel, lin.combine, lin.ksplit))
        r.captures += 1
        return _Recorded(body, seen[-1]), {k: 0 for k in graphs._counts()}
    monkeypatch.setattr(r, "_capture", capture)
    return r, seen


@pytest.mark.parametrize("setter,value", [
    (TM.set_right_in_kernel, True), (TM.set_combine_planes, 8),
    (TM.set_ksplit, 2)])
def test_a_changed_switch_recaptures(monkeypatch, setter, value):
    cfg = tiny_config()
    model = random_quantized_model(cfg, "E8P12RVQ4B", device="cpu",
                                   dtype=torch.float32)
    r, seen = _runner(monkeypatch, model)
    steps = []
    r.run("decode", lambda: steps.append(1), 2)
    r.run("decode", lambda: steps.append(1), 3)
    assert r.captures == 1 and r.replays == 5 and len(steps) == 5
    before = switch_epoch()
    setter(model, value)
    assert switch_epoch() > before
    r.run("decode", lambda: steps.append(1), 1)
    assert r.captures == 2 and len(seen) == 2
    assert seen[0] != seen[1]
    # the same value again changes nothing: the graph replays
    setter(model, value)
    r.run("decode", lambda: steps.append(1), 1)
    assert r.captures == 2
    # and back: a third capture, with the first one's switches
    setter(model, type(value)(0))
    r.run("decode", lambda: steps.append(1), 1)
    assert r.captures == 3 and seen[2] == seen[0]
