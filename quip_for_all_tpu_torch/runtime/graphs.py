"""CUDA graphs for the decode loops, shared by ``runtime/generate.py``
(``generate``, ``generate_stream``) and ``runtime/serving.py``
(``ServingEngine``).

A step body is a Python function that reads its inputs from static device
buffers and writes its results into static device buffers (tokens,
positions and indices advance on the device). ``StepRunner.run(key, body,
n)`` runs it n times: on a card as one CUDA graph per key, captured at the
key's first use and replayed; on the CPU eagerly, the same body. The KV
caches and every static buffer are allocated outside the graphs; the
graphs of one runner share one memory pool, and each leaves nothing live
in it between replays, so they may replay in any order.

Launch counts: a kernel's wrapper counts its launches on the host
(``ops/*.py`` ``.launches``), which a replay does not call. At capture the
runner records what the capture added to each counter (the capture
launches nothing, so it takes that back), and adds it once per replay.
The warm-up step before a capture runs eagerly and is counted by the
wrappers themselves. ``captures``, ``warmups`` and ``replays`` count what
the runner did, so a caller can reckon the launches it expects.
``tests/test_torch_hygiene.py`` holds ``kernel_wrappers`` to every
counting wrapper in ``ops/``; on a card, ``chip_smoke.py`` and
``tests/test_torch_serving_cuda.py`` hold the counts to the kernels a
profiler trace sees.

A capture or a replay that fails raises; nothing falls back to the eager
loop on a card. A graph replays the kernels its capture launched, with
the switches of that moment (split-K, the right epilogue, the combined
decode: ``nn/qlinear.py`` ``switch_epoch``); a key whose graph was
captured before a switch changed is captured again at its next run.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Sequence

import numpy as np
import torch


def kernel_wrappers() -> Dict[str, Callable]:
    """Every wrapper of a decode kernel the model's forward can reach,
    by kernel name; each carries a ``.launches`` count."""
    from ..ops import fused_matmul as fm
    from ..ops import layout_matmul as lm
    from ..ops import moe_matmul as mm
    from ..ops import rowpair_matmul as rm
    return {"fused_decode_matmul": fm.fused_decode_matmul,
            "fused_decode_matmul_tc": fm.fused_decode_matmul_tc,
            "fused_decode_matmul_bwd": fm.fused_decode_matmul_bwd,
            "moe_decode_matmul": mm.moe_fused_matmul,
            "rowpair_u3_decode_matmul": rm.rowpair_u3_matmul,
            "rowpair_pb_decode_matmul": rm.rowpair_pb_matmul,
            "paired_decode_matmul": rm.paired_decode_matmul,
            "bfp_decode_matmul": lm.bfp_decode_matmul,
            "sw_decode_matmul": lm.sw_decode_matmul,
            "ksplit_decode_matmul": lm.ksplit_decode_matmul}


def _counts() -> Dict[str, int]:
    return {k: f.launches for k, f in kernel_wrappers().items()}


def _add_counts(delta: Dict[str, int], times: int) -> None:
    for k, f in kernel_wrappers().items():
        f.launches += delta[k] * times


class StepRunner:
    """Runs step bodies n times each: captured and replayed on a card,
    eagerly on the CPU (``graphs`` overrides the choice: ``False`` runs a
    card eagerly too, which checks hold the graphs against).

    ``state`` lists the static buffers a step advances (token, position,
    index): the warm-up step before a capture changes them, and they are
    put back, so the first replay takes the step the warm-up took. The
    warm-up's other writes (a cache slot, an output row) are the ones the
    replay writes again."""

    def __init__(self, device: torch.device, state: Sequence[torch.Tensor],
                 graphs=None):
        self.graphed = device.type == "cuda" if graphs is None else graphs
        if self.graphed and device.type != "cuda":
            raise ValueError("CUDA graphs need a CUDA device")
        self.state = list(state)
        self.graphs: Dict[Hashable, tuple] = {}
        # the layer switches' epoch at each key's capture
        self.epochs: Dict[Hashable, int] = {}
        self.pool = torch.cuda.graph_pool_handle() if self.graphed else None
        self.captures = self.warmups = self.replays = self.eager_steps = 0
        self.runs_by_key: Dict[Hashable, int] = {}

    def run(self, key: Hashable, body: Callable[[], None], n: int) -> None:
        if n <= 0:
            return
        self.runs_by_key[key] = self.runs_by_key.get(key, 0) + n
        if not self.graphed:
            for _ in range(n):
                body()
            self.eager_steps += n
            return
        from ..nn.qlinear import switch_epoch
        epoch = switch_epoch()
        if key not in self.graphs or self.epochs[key] != epoch:
            self.graphs[key] = self._capture(body)
            self.epochs[key] = epoch
        graph, delta = self.graphs[key]
        for _ in range(n):
            graph.replay()
        self.replays += n
        _add_counts(delta, n)

    def _capture(self, body: Callable[[], None]) -> tuple:
        saved = [t.clone() for t in self.state]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()                      # builds kernels, fills lazy caches
        torch.cuda.current_stream().wait_stream(side)
        self.warmups += 1
        for t, v in zip(self.state, saved):
            t.copy_(v)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            body()
        after = _counts()
        delta = {k: after[k] - before[k] for k in after}
        _add_counts(delta, -1)          # captured, not launched
        self.captures += 1
        return graph, delta


class HostFetch:
    """A copy of a device tensor into host memory, started when made (on
    a card: pinned memory, non-blocking, in stream order, with an event)
    and waited for by ``numpy()``."""

    def __init__(self, t: torch.Tensor):
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = t.detach().clone(), None

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()
