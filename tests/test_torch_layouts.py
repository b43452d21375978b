"""The port's row-pair runtime layouts (u3 for E8P12, pb for E8P12RVQ4B) and
the RVQ4B nibble planes against the JAX package: planes bit-equal to JAX
``from_raw_idxs(layout=...)``, exact round trips, exact re-layouts to
nibble (also on random-bit planes, whose u reaches 6 and 7), and dense
weights bit-equal to JAX ``decode_weights`` in f32.

Shapes: (256, 512) fills whole plane tiles; (128, 1376*8) is the
``down_proj`` width, where u3 pads 1376 groups to 1536 with 12 parity
fields and pb pads to 1408 with a ragged last parity field (PL = 256)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.ops import dequant_xla as jdx
from quip_for_all_tpu.ops import qtensor as jqt
from quip_for_all_tpu.utils.random_quantized import random_plane_shapes

from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.ops import dequant as tdq
from quip_for_all_tpu_torch.ops import qtensor as tqt

pytestmark = pytest.mark.fast

SHAPES = [(256, 512), (128, 1376 * 8)]
# (codebook, layout): the cases this port serves beyond E8P12 nibble
CASES = [("E8P12", "u3"), ("E8P12RVQ4B", "pb"), ("E8P12RVQ4B", "nibble")]


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


def _random_bits(cb, layout, q_out, q_in, seed):
    rng = np.random.default_rng(seed)
    shapes = random_plane_shapes(cb, layout, q_out, q_in)
    planes = {k: rng.integers(-(1 << 31), 1 << 31, s, dtype=np.int64)
              .astype(np.int32) for k, s in shapes.items()}
    ors = 1 / 3.45 if cb == "E8P12RVQ4B" else -1.0
    j = jqt.QuantizedTensor({k: jnp.asarray(v) for k, v in planes.items()},
                            cb, q_out, q_in, ors, layout=layout)
    t = tqt.QuantizedTensor({k: torch.from_numpy(v)
                             for k, v in planes.items()},
                            cb, q_out, q_in, ors, layout=layout)
    return j, t


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cb,layout", CASES)
def test_planes_bit_equal_to_jax(cb, layout, shape):
    _, j, t = _both(cb, layout, *shape)
    assert t.layout == j.layout == layout
    assert sorted(t.planes) == sorted(j.planes)
    for k in j.planes:
        assert t.planes[k].dtype == torch.int32
        assert np.array_equal(t.planes[k].numpy(), np.asarray(j.planes[k])), k
    assert t.group_cols == j.group_cols
    assert t.opt_resid_scale == j.opt_resid_scale


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cb,layout", CASES)
def test_raw_and_checkpoint_round_trip(cb, layout, shape):
    raw, j, t = _both(cb, layout, *shape, seed=1)
    assert np.array_equal(tqt.to_raw_idxs(t), raw)
    ck = tqt.to_checkpoint_idxs(t)
    assert np.array_equal(ck, jqt.to_checkpoint_idxs(j))
    back = tqt.from_checkpoint_idxs(get_codebook(cb), ck, *shape,
                                    device="cpu", layout=layout)
    for k in t.planes:
        assert torch.equal(back.planes[k], t.planes[k]), k


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cb,layout", CASES[:2])
def test_to_nibble_exact_on_random_bits(cb, layout, shape):
    """Random-bit planes (the JAX random builders' u3/pb planes): the
    re-layout to nibble equals JAX's and decodes to the same weights."""
    j, t = _random_bits(cb, layout, *shape, seed=2)
    conv_t = tqt.u3_to_nibble if layout == "u3" else tqt.pb_to_nibble
    conv_j = jqt.u3_to_nibble if layout == "u3" else jqt.pb_to_nibble
    tn, jn = conv_t(t), conv_j(j)
    assert tn.layout == "nibble" and sorted(tn.planes) == sorted(jn.planes)
    for k in jn.planes:
        assert np.array_equal(tn.planes[k].numpy(), np.asarray(jn.planes[k]))
    W = tdq.decode_weights(t, dtype=torch.float32)
    Wn = tdq.decode_weights(tn, dtype=torch.float32)
    if layout == "u3":
        assert torch.equal(W, Wn)
    else:      # rs*(2*hi + b) against alpha1*nib1: f32 orders differ
        assert float((W - Wn).abs().max()) <= 1e-6 * float(W.abs().max())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cb,layout", CASES)
def test_dense_decode_bit_equal_to_jax(cb, layout, shape):
    _, j, t = _both(cb, layout, *shape, seed=3)
    Wj = np.asarray(jdx.decode_weights(j, dtype=jnp.float32))
    Wt = tdq.decode_weights(t, dtype=torch.float32).numpy()
    assert Wt.shape == shape and np.array_equal(Wt, Wj)


@pytest.mark.parametrize("cb,layout", CASES[:2])
def test_dense_decode_of_random_bits_bit_equal_to_jax(cb, layout):
    j, t = _random_bits(cb, layout, 128, 1376 * 8, seed=4)
    Wj = np.asarray(jdx.decode_weights(j, dtype=jnp.float32))
    assert np.array_equal(tdq.decode_weights(t, dtype=torch.float32).numpy(),
                          Wj)


def test_rvq4b_codebook_record_matches_jax():
    t, j = get_codebook("E8P12RVQ4B"), jget_codebook("E8P12RVQ4B")
    assert (t.id, t.codesz, t.packsz, t.opt_resid_scale) == (
        j.id, j.codesz, j.packsz, j.opt_resid_scale)
    assert get_codebook("E8P12RVQ4B", 0.3).opt_resid_scale == 0.3
    assert get_codebook("E8P12RVQ4B", -1).opt_resid_scale == 1 / 3.45
    assert np.array_equal(t.grid(), j.grid())
    raw = _raw("E8P12RVQ4B", 16, 64, seed=5)
    assert np.array_equal(t.unpack_idxs(t.pack_idxs(raw)), raw)
    assert np.array_equal(t.pack_idxs(raw), j.pack_idxs(raw))
    Wt = t.decode(torch.from_numpy(raw)).numpy()
    Wj = np.asarray(j.decode(jnp.asarray(raw)))
    assert np.array_equal(Wt, Wj)


def test_layout_choice_is_checked():
    E8P, RVQ = get_codebook("E8P12"), get_codebook("E8P12RVQ4B")
    raw = _raw("E8P12", 4, 64, seed=6)
    cpu = dict(device="cpu")
    assert tqt.from_raw_idxs(E8P, raw, 4, 64, **cpu).layout == "nibble"
    with pytest.raises(ValueError, match="takes E8P12RVQ4B"):
        tqt.from_raw_idxs(E8P, raw, 4, 64, layout="pb", **cpu)
    with pytest.raises(ValueError, match="takes E8P12,"):
        tqt.from_raw_idxs(RVQ, raw, 4, 64, layout="u3", **cpu)
    with pytest.raises(ValueError, match="odd"):
        tqt.from_raw_idxs(E8P, raw[:3], 3, 64, layout="u3", **cpu)
    with pytest.raises(ValueError, match="not in"):
        tqt.from_raw_idxs(E8P, raw, 4, 64, layout="u4", **cpu)
    qt = tqt.from_raw_idxs(E8P, raw, 4, 64, layout="u3", **cpu)
    with pytest.raises(ValueError, match="decode_affine"):
        qt.decode_affine
