"""The design-variants tool of the small-m tensor-core body of K1, K11,
K6, K8, K9 and K7 (quip_for_all_tpu_torch/tools/variants_small_m.py) on
the CPU: every variant's rules still find what they change in the current headers,
so an edit of the kernel cannot silently turn a variant into the
unchanged body; the SIMT variant's entry points still name the SIMT
body's dispatch; the parent variant copies another csrc directory. The
timing itself needs a card."""
import os

import pytest

from quip_for_all_tpu_torch.ops import _build
from quip_for_all_tpu_torch.tools import variants_small_m as vs

pytestmark = pytest.mark.fast


@pytest.mark.parametrize("variant", sorted(vs.RULES))
def test_every_variant_applies_to_the_sources(variant, tmp_path):
    d = vs.write_variant(variant, str(tmp_path))
    changed = []
    for f in sorted(set(vs.SOURCES + vs.UCODE_SOURCES + vs.RULE_HEADERS)):
        with open(os.path.join(_build.CSRC, f)) as a, \
                open(os.path.join(d, f)) as b:
            changed.append(a.read() != b.read())
    assert any(changed) == (variant != "base")
    # the headers the sources include come along
    assert os.path.isfile(os.path.join(d, "nibble_decode.cuh"))
    assert os.path.isfile(os.path.join(d, "nibble_mma.cuh"))
    assert os.path.isfile(os.path.join(d, "ucode_mma_small.cuh"))


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


def test_ucode_entries_run_the_tensor_core_body_and_refuse_simt(tmp_path):
    """pb and paired have no SIMT body in the sources: every variant's
    u-code entries run the tensor-core body, and asking for the simt
    variant with a u-code layout raises (before any card is needed)."""
    for v in ("base", "simt"):
        d = vs.write_variant(v, str(tmp_path))
        for src in vs.UCODE_SOURCES:
            with open(os.path.join(d, src)) as f:
                assert "sm::dispatch_ucode<" in f.read()
    assert set(vs.UCODE) <= set(vs.ENTRIES)
    for layout in vs.UCODE:
        with pytest.raises(ValueError, match="parent"):
            vs.run(["base", "simt"], [1], [layout])


def test_parent_variant_copies_another_csrc_as_it_is(tmp_path):
    """The parent variant takes the sources of another csrc directory
    without the rules, and needs one."""
    other = tmp_path / "other"
    other.mkdir()
    for f in os.listdir(_build.CSRC):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(_build.CSRC, f)) as a:
                (other / f).write_text(a.read() + "// another commit\n")
    d = vs.write_variant("parent", str(tmp_path / "v"), str(other))
    for f in sorted(set(vs.SOURCES + vs.UCODE_SOURCES + vs.RULE_HEADERS)):
        with open(os.path.join(d, f)) as b:
            assert b.read() == (other / f).read_text()
    with pytest.raises(ValueError, match="--parent"):
        vs.write_variant("parent", str(tmp_path / "v"))


def test_ksplit_and_u3_layouts_run_the_tensor_core_body(tmp_path):
    """Every variant copies the split-K source, whose entry runs the
    small-m body with the split switched on, and the u3 entry runs its
    codes policy; u3 and ksplit4 have no simt body."""
    for v in ("base", "tiles"):
        d = vs.write_variant(v, str(tmp_path))
        with open(os.path.join(d, vs.KSPLIT_SOURCE)) as f:
            assert "sm::launch_ks<" in f.read()
        with open(os.path.join(d, "rowpair_decode_matmul.cu")) as f:
            assert "sm::dispatch_u3(" in f.read()
    assert {"u3", "ksplit4"} <= set(vs.ENTRIES)
    for layout in ("u3", "ksplit4"):
        with pytest.raises(ValueError, match="parent"):
            vs.run(["base", "simt"], [1], [layout])


def test_bfp_and_moe_layouts_run_the_tensor_core_body(tmp_path):
    """Every variant copies K10's and K4/K5's sources, whose entries launch
    the small-m body with their codes policies (so every rule of the
    header reaches them), and both layouts refuse the simt variant: their
    SIMT bodies are timed as the parent variant of a commit that ran
    them."""
    for v in ("base", "wn2"):
        d = vs.write_variant(v, str(tmp_path))
        with open(os.path.join(d, "bfp_decode_matmul.cu")) as f:
            text = f.read()
        assert "sm::launch_nt<" in text and "BfpCodes" in text
        assert "nibble_decode.cuh" not in text
        with open(os.path.join(d, "moe_decode_matmul.cu")) as f:
            text = f.read()
        assert "launch_nt<T, MoeCodes<NSETS>>" in text
        with open(os.path.join(d, vs.HEADER)) as f:
            assert "GATHER" in f.read()
    assert {"bfp", "moe"} <= set(vs.ENTRIES)
    assert set(vs.ROWMAP_SOURCES) == {vs.ENTRIES[k][0] + ".cu"
                                      for k in ("bfp", "moe")}
    for layout in ("bfp", "moe"):
        with pytest.raises(ValueError, match="parent"):
            vs.run(["base", "simt"], [1], [layout])


def test_moe_sums_cover_a_mixtral_step():
    """The MoE timing covers Mixtral-8x7B's two expert linears at every
    layer (64 calls a step) at the main path's rows: decode (R = 2), 8
    tokens and a 31-token sparse prefill."""
    assert sum(vs.MOE_CALLS.values()) == 64
    assert {s[0] for s in vs.MOE_SHAPES} == set(vs.MOE_CALLS)
    assert vs.MOE_R == (2, 16, 62)
