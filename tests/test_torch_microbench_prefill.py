"""The fused/dense crossover tool (``quip_for_all_tpu_torch/tools/
microbench_prefill.py``) held to the JAX package: its layer (random E8P12
code indices from seed 0) and its two routes on the CPU against the JAX
package's ``ops/quant_matmul.py`` ``quant_matmul`` with ``impl="pallas"``
(the Pallas kernel in interpret mode) and ``impl="dequant"``, on the same
codes and x, at K1's rows (m <= 32) and K2's; and its command line on
``--device cpu``, one JSON row an m with no times.

Tolerance: each route within one bf16 ulp plus 1e-5 of the max of JAX's
(``tools/_timing.py`` ``compare``: f32 sums in another order, one bf16
rounding).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.ops import quant_matmul as jqm
from quip_for_all_tpu.ops.qtensor import from_raw_idxs as jfrom_raw_idxs

from quip_for_all_tpu_torch.tools import microbench_prefill as MP
from quip_for_all_tpu_torch.tools._timing import compare

pytestmark = pytest.mark.fast

N, K = 256, 512


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def layers():
    """The tool's layer and the JAX package's layer of the same codes."""
    qt, _ = MP.make_layer(N, K, "cpu")
    idxs = np.random.default_rng(0).integers(
        0, 2 ** 16, size=(N, K // 8), dtype=np.int64).astype(np.uint16)
    jqt = jfrom_raw_idxs(jget_codebook("E8P12"), idxs.astype(np.int32), N, K)
    return qt, jqt


@pytest.mark.parametrize("m", [8, 32, 40])
def test_routes_match_jax(layers, m):
    qt, jqt = layers
    x = np.random.default_rng(m).standard_normal((m, K)).astype(np.float32)
    xt = torch.as_tensor(x, dtype=torch.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    for name, impl in (("fused", "pallas"), ("dense", "dequant")):
        got = MP.route(name)(xt, qt)
        want = torch.from_numpy(np.array(
            jqm.quant_matmul(xj, jqt, impl=impl).astype(jnp.float32))
        ).to(torch.bfloat16)
        ok, err, _, tol = compare(got, want)
        assert ok, (name, m, err, tol)


def test_cli_prints_one_row_an_m(capsys):
    assert MP.main(["--device", "cpu", "--shapes", f"{N}x{K}",
                    "--ms", "8,40"]) == 0
    rows = [json.loads(line) for line in
            capsys.readouterr().out.strip().splitlines()]
    assert [(r["N"], r["K"], r["m"], r["kernel"]) for r in rows] == [
        (N, K, 8, "K1"), (N, K, 40, "K2")]
    for r in rows:
        assert r["ok"] and r["device"] == "cpu"
        assert r["fused_us"] is None and r["dense_us"] is None
        assert r["routes_max_abs_diff"] <= 0.01 * r["routes_scale"]
        assert 0 < r["bound_us"] < r["dense_bound_us"]
