"""``tools/_timing.py``'s tolerance of a kernel against its twin, on the
CPU: one bf16 ulp, masked out of the f32 exponent's bits, is exact at
every binade's edge (where ``exp2(floor(log2(a)) - 7)`` rounds log2 up),
bounds a bf16 rounding, and ``compare`` takes one such step and not two.
"""
import math

import numpy as np
import pytest
import torch

from quip_for_all_tpu_torch.tools import _timing as tm

pytestmark = pytest.mark.fast

TINY = float(np.finfo(np.float32).tiny)


def _ulp(v: float) -> float:
    """2^(floor(log2|v|) - 7) in exact arithmetic (|v| floored at TINY)."""
    return math.ldexp(1.0, math.frexp(max(abs(v), TINY))[1] - 8)


def test_bf16_ulp_is_exact_at_each_binade_edge():
    vals = [0.0, -0.0, TINY / 4]
    for k in range(-30, 30):
        p = np.float32(2.0 ** k)
        vals += [p, -p, np.nextafter(p, np.float32(0)),
                 np.nextafter(p, np.float32(np.inf))]
    rng = np.random.default_rng(0)
    vals += list(rng.standard_normal(512).astype(np.float32) * 300)
    x = torch.tensor(np.array(vals, dtype=np.float32))
    want = torch.tensor([_ulp(float(v)) for v in x], dtype=torch.float32)
    got = tm._bf16_ulp(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    # bf16 and f16 inputs: their values' ulp, in f32
    xb = x.to(torch.bfloat16)
    assert torch.equal(tm._bf16_ulp(xb), torch.tensor(
        [_ulp(float(v)) for v in xb.float()], dtype=torch.float32))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0, 7e4])
def test_bf16_ulp_bounds_a_bf16_rounding(scale):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(8192, generator=g) * scale
    r = x.to(torch.bfloat16).float()
    assert bool(((x - r).abs() <= tm._bf16_ulp(
        torch.maximum(x.abs(), r.abs()))).all())


def test_compare_takes_one_bf16_step_and_not_two():
    g = torch.Generator().manual_seed(3)
    want = (torch.randn(64, 256, generator=g) * 100).to(torch.bfloat16)
    one = want.float() + tm._bf16_ulp(want)
    assert tm.compare(one.to(torch.bfloat16), want)[0]
    two = (want.float() + 2 * tm._bf16_ulp(want)).to(torch.bfloat16)
    ok, err, _, text = tm.compare(two, want)
    assert not ok and text == "1 bf16 ulp + 1e-5 max" and err > 0
