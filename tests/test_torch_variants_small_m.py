"""The design-variants tool of K1 and K11's small-m body
(quip_for_all_tpu_torch/tools/variants_small_m.py) on the CPU: every
variant's rules still find what they change in the current header, so an
edit of the kernel cannot silently turn a variant into the unchanged
body; the SIMT variant's entry points still name the SIMT body's
dispatch. The timing itself needs a card."""
import os

import pytest

from quip_for_all_tpu_torch.ops import _build
from quip_for_all_tpu_torch.tools import variants_small_m as vs

pytestmark = pytest.mark.fast


@pytest.mark.parametrize("variant", sorted(vs.RULES))
def test_every_variant_applies_to_the_sources(variant, tmp_path):
    d = vs.write_variant(variant, str(tmp_path))
    changed = []
    for f in vs.SOURCES:
        with open(os.path.join(_build.CSRC, f)) as a, \
                open(os.path.join(d, f)) as b:
            changed.append(a.read() != b.read())
    assert any(changed) == (variant != "base")
    # the headers the sources include come along
    assert os.path.isfile(os.path.join(d, "nibble_decode.cuh"))
    assert os.path.isfile(os.path.join(d, "nibble_mma.cuh"))


def test_simt_entries_call_the_simt_body(tmp_path):
    d = vs.write_variant("simt", str(tmp_path))
    with open(os.path.join(_build.CSRC, "nibble_decode.cuh")) as f:
        body = f.read()
    assert "int dispatch(const NibbleArgs& a" in body
    for src in vs.SOURCES[1:]:
        with open(os.path.join(d, src)) as f:
            text = f.read()
        assert '#include "nibble_decode.cuh"' in text
        assert "dispatch<" in text and "nibble_mma_small" not in text


def test_unknown_variant_and_no_card_raise(tmp_path):
    with pytest.raises(ValueError):
        vs.write_variant("nothing", str(tmp_path))
    if not vs.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            vs.run(["base"], [1], ["nibble"])
