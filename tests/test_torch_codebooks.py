"""The D4, HI and E8P12RVQ3B codebooks in the port: the golden reference-
schema fixtures through the port's loader and forward (as
tests/test_golden_reference.py holds the JAX loader), also with the right
epilogue on; grids and index packing bit for bit against the JAX package;
planes from raw codes against the JAX package's; the bfp / sw2 / sw4
re-layouts held to the nibble words; the u-code layouts refusing them.

Tolerances: the golden maps rel < 2e-4 in f32 (the fixture's f64
reference against an f32 runtime, as the JAX test); a re-layout's twin
output equal to the nibble twin's within 1e-5 of the max (f32 x: products
exact, sums in another order).
"""
import os

import numpy as np
import pytest
import torch

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.codebooks.d4 import d4_grid as jd4_grid
from quip_for_all_tpu.codebooks.e8p12_rvq3 import e81b_grid as je81b_grid
from quip_for_all_tpu.codebooks.e8p12_rvq3 import \
    e81b_grid_packed as je81b_packed
from quip_for_all_tpu.codebooks.hi import hi_grid as jhi_grid
from quip_for_all_tpu.ops import qtensor as jqt

from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.codebooks.d4 import d4_grid
from quip_for_all_tpu_torch.codebooks.e8p12_rvq3 import (e81b_grid,
                                                         e81b_grid_packed)
from quip_for_all_tpu_torch.codebooks.hi import hi_grid
from quip_for_all_tpu_torch.models.llama import set_right_in_kernel
from quip_for_all_tpu_torch.ops import fused_matmul as tfm
from quip_for_all_tpu_torch.ops import qtensor as tqt
from quip_for_all_tpu_torch.ops.dequant import decode_weights
from quip_for_all_tpu_torch.utils.checkpoint import load_quantized

pytestmark = pytest.mark.fast

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
NEW = ["D4", "HI", "E8P12RVQ3B"]
N_CODES = {"D4": 256, "HI": 16, "E8P12RVQ3B": 1 << 24}


@pytest.mark.parametrize("right", [False, True])
@pytest.mark.parametrize("cb", ["d4", "hi", "e8p12rvq3b"])
def test_golden_layer_maps(cb, right):
    """q_proj (128 -> 128: B 128 in the epilogue) and down_proj (256 ->
    128) full linear maps against the committed expected maps."""
    cfg, model, qcfg = load_quantized(os.path.join(GOLDEN, cb),
                                      device="cpu")
    assert qcfg["codebook"].lower() == cb
    set_right_in_kernel(model, right)
    exp = np.load(os.path.join(GOLDEN, cb, "expected.npz"))
    blk = model.layers[0]
    for role, lin in (("q_proj", blk["self_attn"]["q_proj"]),
                      ("down_proj", blk["mlp"]["down_proj"])):
        assert lin.right_in_kernel == right
        got = lin(torch.eye(lin.in_features),
                  compute_dtype=torch.float32).numpy()
        want = exp[role]
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
        assert rel < 2e-4, (cb, role, rel)


def test_grids_match_jax_bit_for_bit():
    assert np.array_equal(d4_grid(), jd4_grid())
    assert np.array_equal(hi_grid(), jhi_grid())
    assert np.array_equal(e81b_grid(), je81b_grid())
    assert np.array_equal(e81b_grid_packed(), je81b_packed())
    for name in NEW:
        assert np.array_equal(get_codebook(name).grid(),
                              jget_codebook(name).grid())


def _raw(name, q_out, q_in, seed):
    cb = get_codebook(name)
    rng = np.random.default_rng(seed)
    return rng.integers(0, N_CODES[name], (q_out, q_in // cb.codesz)
                        ).astype(np.int32)


@pytest.mark.parametrize("name", NEW)
def test_pack_unpack_and_planes_match_jax(name):
    q_out, q_in = 128, 512
    raw = _raw(name, q_out, q_in, seed=1)
    cb, jcb = get_codebook(name), jget_codebook(name)
    assert cb.codesz == jcb.codesz and cb.packsz == jcb.packsz
    assert cb.opt_resid_scale == getattr(jcb, "opt_resid_scale", -1.0)
    packed = cb.pack_idxs(raw)
    assert packed.dtype == jcb.pack_idxs(raw).dtype
    assert np.array_equal(packed, jcb.pack_idxs(raw))
    assert np.array_equal(cb.unpack_idxs(packed), jcb.unpack_idxs(packed))
    assert np.array_equal(cb.unpack_idxs(packed), raw)
    t = tqt.from_raw_idxs(cb, raw, q_out, q_in, device="cpu")
    j = jqt.from_raw_idxs(jcb, raw, q_out, q_in)
    assert sorted(t.planes) == sorted(j.planes)
    for k in t.planes:
        assert np.array_equal(t.planes[k].numpy(), np.asarray(j.planes[k]))
    assert t.decode_affine == j.decode_affine
    assert np.array_equal(tqt.to_raw_idxs(t), raw)
    assert np.array_equal(tqt.to_checkpoint_idxs(t),
                          jqt.to_checkpoint_idxs(j))


@pytest.mark.parametrize("layout", ["bfp", "sw2", "sw4"])
@pytest.mark.parametrize("name", NEW)
def test_relayouts_hold_to_nibble(name, layout):
    q_out, q_in = 128, 1024
    raw = _raw(name, q_out, q_in, seed=2)
    cb = get_codebook(name)
    tn = tqt.from_raw_idxs(cb, raw, q_out, q_in, device="cpu")
    tl = tqt.from_raw_idxs(cb, raw, q_out, q_in, device="cpu", layout=layout)
    assert tl.layout == layout
    back = tqt.to_nibble(tl)
    for k in tn.planes:
        assert torch.equal(back.planes[k], tn.planes[k])
    assert torch.equal(decode_weights(tl), decode_weights(tn))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, q_in)).astype(np.float32))
    want = tfm.fused_quant_matmul(x, tn).numpy()
    got = tfm.fused_quant_matmul(x, tl).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("layout", ["u3", "pb", "paired"])
@pytest.mark.parametrize("name", NEW)
def test_ucode_layouts_refuse_them(name, layout):
    """u3 holds E8P12 codewords, pb and paired E8P12RVQ4B's: the port
    refuses the others (ValueError), as the JAX package does (it asserts
    the codebook while it builds the planes)."""
    raw = _raw(name, 128, 512, seed=4)
    with pytest.raises(ValueError, match="takes"):
        tqt.from_raw_idxs(get_codebook(name), raw, 128, 512, device="cpu",
                          layout=layout)
    with pytest.raises(AssertionError):
        jqt.from_raw_idxs(jget_codebook(name), raw, 128, 512, layout=layout)
