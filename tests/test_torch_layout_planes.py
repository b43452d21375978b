"""The port's bfp, sw2/sw4 and paired runtime layouts against the JAX
package: planes bit-equal to JAX ``from_raw_idxs(layout=...)`` (the sw
int16/int8 dtypes and bfp's 3-D planes included), exact round trips and
re-layouts, and dense weights bit-equal to JAX ``decode_weights`` in f32.

Shapes: (256, 2048) fills whole plane tiles (Gp 256); (128, 1376*8) is the
``down_proj`` width, where the nibble planes pad 1376 groups to 1408 and
the paired planes to 1536 (Wp 128, 12 parity fields)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.ops import dequant_xla as jdx
from quip_for_all_tpu.ops import qtensor as jqt

from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.ops import dequant as tdq
from quip_for_all_tpu_torch.ops import qtensor as tqt

pytestmark = pytest.mark.fast

SHAPES = [(256, 2048), (128, 1376 * 8)]
CASES = [("E8P12", "bfp"), ("E8P12", "sw2"), ("E8P12", "sw4"),
         ("E8P12RVQ4B", "bfp"), ("E8P12RVQ4B", "sw2"),
         ("E8P12RVQ4B", "sw4"), ("E8P12RVQ4B", "paired")]
DTYPES = {"bfp": torch.int32, "sw2": torch.int16, "sw4": torch.int8,
          "paired": torch.int32}


def _raw(cb, q_out, q_in, seed):
    rng = np.random.default_rng(seed)
    if cb == "E8P12":
        return rng.integers(0, 1 << 16, (q_out, q_in // 8)).astype(np.int32)
    return (rng.integers(0, 1 << 62, (q_out, q_in // 8), dtype=np.uint64)
            .astype(np.uint32).view(np.int32))


def _both(cb, layout, q_out, q_in, seed=0):
    raw = _raw(cb, q_out, q_in, seed)
    j = jqt.from_raw_idxs(jget_codebook(cb), raw, q_out, q_in, layout=layout)
    t = tqt.from_raw_idxs(get_codebook(cb), raw, q_out, q_in, device="cpu",
                          layout=layout)
    return raw, j, t


def _equal_planes(t, j):
    assert sorted(t.planes) == sorted(j.planes)
    for k, v in j.planes.items():
        assert t.planes[k].numpy().dtype == np.asarray(v).dtype, k
        assert np.array_equal(t.planes[k].numpy(), np.asarray(v)), k


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cb,layout", CASES)
def test_planes_bit_equal_to_jax(cb, layout, shape):
    _, j, t = _both(cb, layout, *shape)
    assert t.layout == j.layout == layout
    assert all(v.dtype == DTYPES[layout] for v in t.planes.values())
    _equal_planes(t, j)
    assert (t.split, t.group_cols) == (j.split, j.group_cols)
    assert t.opt_resid_scale == j.opt_resid_scale


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cb,layout", CASES)
def test_round_trips_and_relayouts_exact(cb, layout, shape):
    """to_raw_idxs and the checkpoint array invert the planes; the re-layout
    to nibble equals JAX's (from_bfp / from_subword / paired_to_nibble) and
    the nibble -> bfp / sw re-layouts invert it."""
    raw, j, t = _both(cb, layout, *shape, seed=1)
    assert np.array_equal(tqt.to_raw_idxs(t), raw)
    ck = tqt.to_checkpoint_idxs(t)
    assert np.array_equal(ck, jqt.to_checkpoint_idxs(j))
    back = tqt.from_checkpoint_idxs(get_codebook(cb), ck, *shape,
                                    device="cpu", layout=layout)
    for k in t.planes:
        assert torch.equal(back.planes[k], t.planes[k]), k
    conv_j = {"bfp": jqt.from_bfp, "paired": jqt.paired_to_nibble}.get(
        layout, jqt.from_subword)
    tn = tqt.to_nibble(t)
    assert tn.layout == "nibble"
    _equal_planes(tn, conv_j(j))
    if layout != "paired":
        again = tqt.relayout(tn, layout)
        for k in t.planes:
            assert torch.equal(again.planes[k], t.planes[k]), k


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cb,layout", CASES)
def test_dense_decode_bit_equal_to_jax(cb, layout, shape):
    _, j, t = _both(cb, layout, *shape, seed=3)
    Wj = np.asarray(jdx.decode_weights(j, dtype=jnp.float32))
    Wt = tdq.decode_weights(t, dtype=torch.float32).numpy()
    assert Wt.shape == shape and np.array_equal(Wt, Wj)


@pytest.mark.parametrize("shape", SHAPES)
def test_paired_random_bits_relayout_and_decode(shape):
    """Random-bit paired planes under the masks of the JAX package's random
    models (u0 up to 3, u1 up to 3, every parity bit random): the re-layout
    to nibble and the dense decode equal JAX's."""
    q_out, q_in = shape
    rng = np.random.default_rng(4)
    Gp = -(-(q_in // 8) // 256) * 256
    cols = {"w0": (Gp, 0xBBBBBBBB), "w1": (Gp // 2, 0x55555555),
            "w2": (tqt.paired_wp(Gp), 0xFFFFFFFF)}
    planes = {k: (rng.integers(0, 1 << 32, (q_out, c), dtype=np.uint64)
                  & mask).astype(np.uint32).view(np.int32)
              for k, (c, mask) in cols.items()}
    j = jqt.QuantizedTensor({k: jnp.asarray(v) for k, v in planes.items()},
                            "E8P12RVQ4B", q_out, q_in, 1 / 3.45,
                            layout="paired")
    t = tqt.QuantizedTensor({k: torch.from_numpy(v)
                             for k, v in planes.items()},
                            "E8P12RVQ4B", q_out, q_in, 1 / 3.45,
                            layout="paired")
    _equal_planes(tqt.paired_to_nibble(t), jqt.paired_to_nibble(j))
    Wj = np.asarray(jdx.decode_weights(j, dtype=jnp.float32))
    assert np.array_equal(tdq.decode_weights(t, dtype=torch.float32).numpy(),
                          Wj)


def test_paired_parity_width_matches_jax():
    assert [tqt.paired_wp(g) for g in range(256, 4097, 128)] == [
        jqt.paired_wp(g) for g in range(256, 4097, 128)]
    assert tqt.paired_wp(1536) == 128 and tqt.paired_wp(2304) == 256


def test_new_layout_choices_are_checked():
    E8P, RVQ = get_codebook("E8P12"), get_codebook("E8P12RVQ4B")
    raw = _raw("E8P12", 3, 64, seed=6)
    cpu = dict(device="cpu")
    with pytest.raises(ValueError, match="takes E8P12RVQ4B"):
        tqt.from_raw_idxs(E8P, raw, 3, 64, layout="paired", **cpu)
    with pytest.raises(ValueError, match="odd"):
        tqt.from_raw_idxs(E8P, raw, 3, 64, layout="bfp", **cpu)
    # sw and paired keep rows apart: any q_out
    assert tqt.from_raw_idxs(E8P, raw, 3, 64, layout="sw4",
                             **cpu).planes["w0"].dtype == torch.int8
    rraw = _raw("E8P12RVQ4B", 3, 64, seed=7)
    assert tqt.from_raw_idxs(RVQ, rraw, 3, 64, layout="paired",
                             **cpu).group_cols == 256
    qt = tqt.from_raw_idxs(RVQ, rraw, 3, 64, layout="paired", **cpu)
    with pytest.raises(ValueError, match="decode_affine"):
        qt.decode_affine
    assert tqt.from_raw_idxs(E8P, raw, 3, 64, layout="sw2",
                             **cpu).decode_affine == ((0.5, -2.75),)
