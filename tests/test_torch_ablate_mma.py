"""The ablation tool of the tensor-core kernels
(quip_for_all_tpu_torch/tools/ablate_mma.py) on the CPU: every variant's
rules still find what they cut in the current sources, so a change to the
kernels cannot silently turn an ablation into the unchanged kernel. The
timing itself needs a card."""
import os

import pytest

from quip_for_all_tpu_torch.ops import _build
from quip_for_all_tpu_torch.tools import ablate_mma

pytestmark = pytest.mark.fast


@pytest.mark.parametrize("variant", sorted(ablate_mma.CUTS))
def test_every_variant_applies_to_the_sources(variant, tmp_path):
    d = ablate_mma.write_variant(variant, str(tmp_path))
    changed = []
    for f in ablate_mma.SOURCES:
        with open(os.path.join(_build.CSRC, f)) as a, \
                open(os.path.join(d, f)) as b:
            changed.append(a.read() != b.read())
    assert any(changed) == (variant != "base")


def test_unknown_variant_and_no_card_raise(tmp_path):
    with pytest.raises(ValueError):
        ablate_mma.write_variant("nothing", str(tmp_path))
    if not ablate_mma.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            ablate_mma.run(["base"], ["bfloat16"])
