"""The microbenchmark kernels (csrc/mb_kernel.cu, mb_tn.cu, mb_decode.cu,
mb_bfp_probe.cu) against their plain twins, and each microbenchmark's
``run`` entry point, on a card. This file imports neither JAX nor the JAX
package (the card's machine has no JAX), so it runs there without
tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_microbench_cuda.py

Without a card every test skips. Tolerance: f32 outputs within
1e-5 * max|twin| (sums run in another order); bf16 outputs within that
plus one bf16 ulp of the element (``tools/_timing.compare``). Shapes
include ragged row counts (no multiple of a block's rows) and every x-row
tile (m = 1, 2, 3, 8, 11).
"""
import pytest
import torch

from quip_for_all_tpu_torch.tools import _timing
from quip_for_all_tpu_torch.tools import microbench_bfp as tb
from quip_for_all_tpu_torch.tools import microbench_decode as td
from quip_for_all_tpu_torch.tools import microbench_kernel as tk
from quip_for_all_tpu_torch.tools import microbench_split as ts
from quip_for_all_tpu_torch.tools import microbench_tn as tt

pytestmark = [pytest.mark.fast, pytest.mark.cuda]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, want):
    torch.cuda.synchronize()
    ok, err, _, tol = _timing.compare(got, want)
    assert ok, (err, tol)


@pytest.mark.parametrize("m", [1, 2, 3, 8, 11])
@pytest.mark.parametrize("N,K", [(4096, 4096), (200, 1024), (36, 512)])
@pytest.mark.parametrize("variant", list(tk.VARIANTS))
def test_t1_kernels_match_their_twins(cuda, variant, N, K, m):
    x, w = tk.make_inputs(N, K, m, cuda, seed=N + m)
    fn = tk.WRAPPERS[variant]
    before = fn.launches
    if variant == "stream":
        _check(tk.stream(w), tk.stream_ref(w))
    else:
        _check(fn(x, w), tk.TWINS[variant](x, w))
    assert fn.launches == before + 1


@pytest.mark.parametrize("m", [1, 3, 8, 11])
@pytest.mark.parametrize("rpb", list(tt.ROWS_PER_BLOCK))
@pytest.mark.parametrize("N,K", [(12288, 4096), (22016, 4096),
                                 (4096, 11264), (200, 1024)])
@pytest.mark.parametrize("variant", ["nib", "dma"])
def test_t4_kernels_match_their_twins(cuda, variant, N, K, rpb, m):
    """Every rows-per-block value; 22016 and 200 rows leave a ragged last
    block at some of them."""
    x, w = tt.make_inputs(N, K, m, cuda, seed=rpb + m)
    fn = tt.WRAPPERS[variant]
    before = fn.launches
    _check(fn(x, w, rpb), tt.TWINS[variant](x, w))
    assert fn.launches == before + 1


@pytest.mark.parametrize("m", [1, 2, 3, 8, 11])
@pytest.mark.parametrize("N,K", [(4096, 4096), (200, 1024)])
@pytest.mark.parametrize("strategy", list(td.STRATEGIES))
def test_t2_kernels_match_their_twins(cuda, strategy, N, K, m):
    x, codes, W, cols, lohi = td.make_inputs(N, K, m, cuda, seed=N + m)
    args = {"lane": (x, codes, cols), "lane_b": (x, codes, lohi),
            "stream": (codes,), "dense": (x, W)}[strategy]
    fn = td.WRAPPERS[strategy]
    before = fn.launches
    _check(fn(*args), td.TWINS[strategy](*args))
    assert fn.launches == before + 1


def test_t5_probe_reports_the_k10_order(cuda):
    w = torch.from_numpy(tb.probe_words()).to(cuda)
    got = tb.bitcast_probe(w)
    assert torch.equal(got, tb.bitcast_probe_ref(w))
    assert tb.discover_bitcast_order() == tb.K10_ORDER


@pytest.mark.parametrize("tool,kw", [
    (tk, dict(N=512, K=1024, m=3)), (td, dict(N=512, K=1024, m=3)),
    (ts, dict(shapes="512x1024", m=3)),
    (tt, dict(shapes="512x1024,200x1024", m=3)),
    (tb, dict(shapes="512x1024", m=3))])
def test_run_checks_and_times_every_variant(cuda, tool, kw):
    recs = tool.run(iters=8, **kw)
    assert recs and all(r["ok"] for r in recs), [
        (r["variant"], r["max_abs_err"]) for r in recs if not r["ok"]]
    for r in recs:
        assert r["us"] > 0 and r["plain_us"] > 0 and r["bound_us"] > 0
        assert r["launches"] >= 1 and r["device"] == \
            torch.cuda.get_device_name(0)
