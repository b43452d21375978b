"""K3, the backward of the fused decode+matmul (ops/fused_matmul.py
``FusedQuantMatmul``, ``fused_decode_matmul_bwd``), against ``jax.grad``
through the JAX package's ``fused_quant_matmul_pre`` (its custom VJP
``_fused_core_bwd``), the forward run in interpret mode as the JAX tests
run it. On the CPU the wrapper takes the plain twin; on a card the kernel
is held against the same twin in tests/test_torch_k3_cuda.py.

The loss is sum(out * probe) for a random probe, so g = probe (rounded to
out's dtype in both packages) and the gradients are dx (m, 8*Gp) in the
grouped lane order and d scale_vec (q_out,).

Tolerance: dx in f32 within 1e-5 * max|ref| (W decodes bit-equal; the
sums over q_out differ in order), in bf16 that plus one bf16 ulp of the
element; d scale_vec (always f32) within 1e-5 * max|ref|.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.ops import dequant_pallas as jdp
from quip_for_all_tpu.ops import qtensor as jqt

from quip_for_all_tpu_torch.codebooks import get_codebook
from quip_for_all_tpu_torch.ops import fused_matmul as tfm
from quip_for_all_tpu_torch.ops import qtensor as tqt

pytestmark = pytest.mark.fast

RS = 1 / 3.45                   # E8P12RVQ4B default residual scale


def bf16_ulp(v: np.ndarray) -> np.ndarray:
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def assert_close(got: np.ndarray, want: np.ndarray, dtype: str):
    tol = 1e-5 * np.abs(want).max()
    if dtype == "bfloat16":
        tol = tol + bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


def _random_planes(q_out, Gp, n_sets, seed):
    rng = np.random.default_rng(seed)
    planes = {f"w{i}": rng.integers(0, 1 << 32, (q_out, Gp), dtype=np.uint64)
              .astype(np.uint32).view(np.int32) for i in range(n_sets)}
    cb = "E8P12" if n_sets == 1 else "E8P12RVQ4B"
    return planes, cb, (-1.0 if n_sets == 1 else RS)


def _inputs(m, q_in, Gp, q_out, split, with_scale, seed):
    """x in the grouped lane order (pad lanes zero), probe, scale."""
    rng = np.random.default_rng(seed + 1000)
    x = rng.standard_normal((m, q_in)).astype(np.float32)
    x = tfm.grouped_permute(torch.from_numpy(x), Gp, split).numpy()
    probe = rng.standard_normal((m, q_out)).astype(np.float32)
    scale = (rng.uniform(0.5, 1.5, q_out).astype(np.float32)
             if with_scale else None)
    return x, probe, scale


def _jax_grads(jt, x, probe, scale, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def loss(x, s):
        out = jdp.fused_quant_matmul_pre(x, jt, scale_vec=s)
        return jnp.sum(out.astype(jnp.float32) * probe)
    xj = jnp.asarray(x).astype(jdt)
    if scale is None:
        return np.asarray(jax.grad(loss)(xj, None).astype(jnp.float32)), None
    dx, ds = jax.grad(loss, argnums=(0, 1))(xj, jnp.asarray(scale))
    return np.asarray(dx.astype(jnp.float32)), np.asarray(ds)


def _port_grads(tt, x, probe, scale, dtype, plain=False):
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    st = (None if scale is None
          else torch.from_numpy(scale).requires_grad_(True))
    out = tfm.fused_quant_matmul_pre(xt, tt, scale_vec=st, plain=plain)
    assert out.dtype == xt.dtype and out.shape == probe.shape
    (out.float() * torch.from_numpy(probe)).sum().backward()
    assert xt.grad.dtype == xt.dtype
    return (xt.grad.float().numpy(),
            None if st is None else st.grad.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_scale", [False, True])
@pytest.mark.parametrize("n_sets", [1, 2])
@pytest.mark.parametrize("m", [1, 5, 40, 64])
def test_k3_twin_matches_jax_grad(m, n_sets, with_scale, dtype):
    """q_in 384: G = 48 groups of Gp = 128, so the pad lanes of dx are
    exercised (zero in both)."""
    q_out, q_in = 128, 384
    planes, cb, ors = _random_planes(q_out, 128, n_sets, m * 7 + n_sets)
    x, probe, scale = _inputs(m, q_in, 128, q_out, 1, with_scale, m)
    jt = jqt.QuantizedTensor({k: jnp.asarray(v) for k, v in planes.items()},
                             cb, q_out, q_in, ors)
    tt = tqt.QuantizedTensor({k: torch.from_numpy(v)
                              for k, v in planes.items()}, cb, q_out, q_in,
                             ors)
    want_dx, want_ds = _jax_grads(jt, x, probe, scale, dtype)
    got_dx, got_ds = _port_grads(tt, x, probe, scale, dtype)
    assert got_dx.shape == want_dx.shape == (m, 8 * 128)
    assert np.all(got_dx.reshape(m, 8, 128)[:, :, q_in // 8:] == 0)
    assert_close(got_dx, want_dx, dtype)
    if with_scale:
        assert_close(got_ds, want_ds, "float32")


@pytest.mark.parametrize("n_sets", [1, 2])
@pytest.mark.parametrize("m", [5, 64])
def test_k3_twin_matches_jax_grad_without_pad_groups(m, n_sets):
    """G = Gp = 128 (q_in 1024) and q_out 256, in bf16 with a scale."""
    q_out, q_in = 256, 1024
    planes, cb, ors = _random_planes(q_out, 128, n_sets, m + n_sets)
    x, probe, scale = _inputs(m, q_in, 128, q_out, 1, True, m)
    jt = jqt.QuantizedTensor({k: jnp.asarray(v) for k, v in planes.items()},
                             cb, q_out, q_in, ors)
    tt = tqt.QuantizedTensor({k: torch.from_numpy(v)
                              for k, v in planes.items()}, cb, q_out, q_in,
                             ors)
    want_dx, want_ds = _jax_grads(jt, x, probe, scale, "bfloat16")
    got_dx, got_ds = _port_grads(tt, x, probe, scale, "bfloat16")
    assert_close(got_dx, want_dx, "bfloat16")
    assert_close(got_ds, want_ds, "float32")


@pytest.mark.parametrize("layout,cb,env", [
    ("u3", "E8P12", None), ("pb", "E8P12RVQ4B", None),
    ("paired", "E8P12RVQ4B", None), ("bfp", "E8P12", "QFA_BFP"),
    ("sw4", "E8P12", "QFA_SPLIT_DECODE")])
def test_k3_relaid_layouts_match_jax_grad(layout, cb, env, monkeypatch):
    """Each layout re-lays to nibble words for K3 and dx comes back in its
    own lane order and Gp (u3 and paired pad Gp to 256: q_in 384 gives
    G = 48 of Gp 256 there, of Gn 128 in nibble words). The JAX side
    picks the layout where its flags name it."""
    if env is not None:
        monkeypatch.setenv(env, "4" if env == "QFA_SPLIT_DECODE" else "1")
    q_out, q_in, m = 128, 384, 12
    rng = np.random.default_rng(5)
    if cb == "E8P12":
        raw = rng.integers(0, 1 << 16, (q_out, q_in // 8)).astype(np.int32)
    else:
        raw = (rng.integers(0, 1 << 62, (q_out, q_in // 8), dtype=np.uint64)
               .astype(np.uint32).view(np.int32))
    jt = jqt.from_raw_idxs(jget_codebook(cb), raw, q_out, q_in, layout=layout)
    tt = tqt.from_raw_idxs(get_codebook(cb), raw, q_out, q_in, device="cpu",
                           layout=layout)
    assert jt.layout == tt.layout == layout
    assert jt.group_cols == tt.group_cols == (
        256 if layout in ("u3", "paired") else 128)
    x, probe, scale = _inputs(m, q_in, tt.group_cols, q_out, tt.split, True,
                              7)
    want_dx, want_ds = _jax_grads(jt, x, probe, scale, "bfloat16")
    got_dx, got_ds = _port_grads(tt, x, probe, scale, "bfloat16")
    assert got_dx.shape == want_dx.shape
    assert_close(got_dx, want_dx, "bfloat16")
    assert_close(got_ds, want_ds, "float32")


def test_plain_route_equals_the_cpu_route():
    """plain=True runs the twins in both directions; on CPU tensors the
    wrappers run them already: the same numbers."""
    planes, cb, ors = _random_planes(128, 128, 2, 3)
    tt = tqt.QuantizedTensor({k: torch.from_numpy(v)
                              for k, v in planes.items()}, cb, 128, 384, ors)
    x, probe, scale = _inputs(9, 384, 128, 128, 1, True, 3)
    a = _port_grads(tt, x, probe, scale, "float32")
    b = _port_grads(tt, x, probe, scale, "float32", plain=True)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_function_only_under_autograd():
    """Without gradients (no_grad, or inputs that need none) the call is
    the plain forward: no autograd node."""
    planes, cb, ors = _random_planes(128, 128, 1, 4)
    tt = tqt.QuantizedTensor({k: torch.from_numpy(v)
                              for k, v in planes.items()}, cb, 128, 384, ors)
    x = torch.randn(3, 1024)
    assert tfm.fused_quant_matmul_pre(x, tt).grad_fn is None
    with torch.no_grad():
        y = tfm.fused_quant_matmul_pre(x.requires_grad_(True), tt)
    assert y.grad_fn is None
    y = tfm.fused_quant_matmul_pre(x, tt)
    assert type(y.grad_fn).__name__ == "FusedQuantMatmulBackward"


def test_bwd_wrapper_rejects_what_the_kernel_does_not_take():
    w = torch.zeros((128, 128), dtype=torch.int32)
    aff = ((0.5, -2.75),)
    g = torch.zeros(4, 128)
    with pytest.raises(TypeError):         # dtype
        tfm.fused_decode_matmul_bwd(g.half(), [w], aff, None, 128, 128)
    with pytest.raises(ValueError):        # non-contiguous g
        tfm.fused_decode_matmul_bwd(torch.zeros(128, 4).T, [w], aff, None,
                                    128, 128)
    with pytest.raises(ValueError):        # three plane sets
        tfm.fused_decode_matmul_bwd(g, [w, w, w], aff * 3, None, 128, 128)
    with pytest.raises(ValueError):        # planes of another q_out
        tfm.fused_decode_matmul_bwd(torch.zeros(4, 64), [w], aff, None, 128,
                                    128)
    with pytest.raises(ValueError):        # G beyond the planes
        tfm.fused_decode_matmul_bwd(g, [w], aff, None, 129, 256)
    with pytest.raises(ValueError):        # split 3
        tfm.fused_decode_matmul_bwd(g, [w], aff, None, 128, 128, 3)
    with pytest.raises(RuntimeError):      # no kernel for this device
        tfm.fused_decode_matmul_bwd(g.to("meta"), [w.to("meta")], aff, None,
                                    128, 128)


def test_cpu_backward_launches_nothing():
    before = (tfm.fused_decode_matmul.launches,
              tfm.fused_decode_matmul_bwd.launches)
    planes, cb, ors = _random_planes(128, 128, 1, 6)
    tt = tqt.QuantizedTensor({k: torch.from_numpy(v)
                              for k, v in planes.items()}, cb, 128, 384, ors)
    x, probe, scale = _inputs(20, 384, 128, 128, 1, True, 6)
    _port_grads(tt, x, probe, scale, "bfloat16")
    assert (tfm.fused_decode_matmul.launches,
            tfm.fused_decode_matmul_bwd.launches) == before
