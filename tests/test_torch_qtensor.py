"""The port's nibble-layout QuantizedTensor and dense decode against the
JAX package: planes bit-equal, dense weights bit-equal in f32."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.codebooks import e8p12 as je8p
from quip_for_all_tpu.ops import dequant_xla as jdx
from quip_for_all_tpu.ops import qtensor as jqt

from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.codebooks import e8p12 as te8p
from quip_for_all_tpu_torch.ops import dequant as tdq
from quip_for_all_tpu_torch.ops import qtensor as tqt
from quip_for_all_tpu_torch.utils.safetensors_io import load_file

pytestmark = pytest.mark.fast

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "e8p12")


@pytest.mark.parametrize("fn", ["abs_grid_raw", "abs_grid_bytes",
                                "packed_abs_grid", "full_grid"])
def test_e8p12_grids_equal(fn):
    a, b = getattr(je8p, fn)(), getattr(te8p, fn)()
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("cb", ["E8P12", "E8P12RVQ4B", "E8P12RVQ3B", "D4",
                                "HI"])
def test_decode_affine_rows_equal(cb):
    rs = 1 / 3.45 if "RVQ" in cb else -1.0
    assert tqt.decode_affine(cb, rs) == jqt.decode_affine(cb, rs)


def test_golden_planes_bit_equal():
    tensors = load_file(os.path.join(GOLDEN, "model.safetensors"))
    names = sorted(k for k in tensors if k.endswith(".Qidxs"))
    assert len(names) == 7
    for name in names:
        packed = tensors[name]
        q_out, q_in = packed.shape[0], packed.shape[1] * 8
        j = jqt.from_checkpoint_idxs(jget_codebook("E8P12"), packed, q_out,
                                     q_in)
        t = tqt.from_checkpoint_idxs(get_codebook("E8P12"), packed, q_out,
                                     q_in, device="cpu")
        assert t.planes["w0"].dtype == torch.int32
        assert np.array_equal(t.planes["w0"].numpy(),
                              np.asarray(j.planes["w0"])), name
        # and back to the checkpoint array, bit-exactly
        assert np.array_equal(tqt.to_checkpoint_idxs(t), packed), name


@pytest.mark.parametrize("shape", [(128, 384), (256, 1024), (64, 8)])
def test_random_code_planes_and_decode_bit_equal(shape):
    q_out, q_in = shape
    rng = np.random.default_rng(q_in)
    raw = rng.integers(0, 1 << 16, (q_out, q_in // 8)).astype(np.int32)
    j = jqt.from_raw_idxs(jget_codebook("E8P12"), raw, q_out, q_in)
    t = tqt.from_raw_idxs(get_codebook("E8P12"), raw, q_out, q_in,
                          device="cpu")
    assert np.array_equal(t.planes["w0"].numpy(), np.asarray(j.planes["w0"]))
    assert t.group_cols == j.group_cols
    assert np.array_equal(tqt.to_raw_idxs(t), raw)
    Wj = np.asarray(jdx.decode_weights(j, dtype=jnp.float32))
    Wt = tdq.decode_weights(t, dtype=torch.float32).numpy()
    assert Wt.shape == (q_out, q_in) and np.array_equal(Wt, Wj)


def test_two_plane_decode_bit_equal():
    rng = np.random.default_rng(3)
    planes = {f"w{i}": rng.integers(0, 1 << 32, (128, 128), dtype=np.uint64)
              .astype(np.uint32).view(np.int32) for i in range(2)}
    j = jqt.QuantizedTensor({k: jnp.asarray(v) for k, v in planes.items()},
                            "E8P12RVQ4B", 128, 1024, 1 / 3.45)
    t = tqt.QuantizedTensor({k: torch.from_numpy(v)
                             for k, v in planes.items()},
                            "E8P12RVQ4B", 128, 1024, 1 / 3.45)
    Wj = np.asarray(jdx.decode_weights(j, dtype=jnp.float32))
    Wt = tdq.decode_weights(t, dtype=torch.float32).numpy()
    assert np.array_equal(Wt, Wj)


def test_bit31_word_decodes_nibble7_unsigned():
    """>> on int32 is arithmetic; nibble 7 of 0xF0000000 must be 15."""
    word = np.array([[0xF0000000, 0x80000000, 0x7FFFFFFF]],
                    dtype=np.uint32).view(np.int32)
    w = torch.from_numpy(word)
    nibs = tdq.nibble_planes(w)
    assert nibs[7].tolist() == [[15.0, 8.0, 7.0]]
    assert nibs[6].tolist() == [[0.0, 0.0, 15.0]]
    t = tqt.QuantizedTensor({"w0": torch.nn.functional.pad(w, (0, 125))},
                            "E8P12", 1, 24)
    W = tdq.decode_weights(t, dtype=torch.float32)
    assert W[0, 7].item() == 0.5 * 15 - 2.75
    assert W[0, 15].item() == 0.5 * 8 - 2.75


def test_unported_layouts_and_codebooks_raise():
    with pytest.raises(ValueError, match="not in"):
        tqt.QuantizedTensor({}, "E8P12", 128, 128, layout="u4")
    with pytest.raises(ValueError, match="Invalid codebook"):
        get_codebook("E8P12RVQ5B")
    # every codebook is ported; the u-code layouts take E8P12 codewords only
    assert get_codebook("D4").id == "D4"
    with pytest.raises(ValueError, match="takes"):
        tqt.resolve_layout("D4", "u3", 128)
