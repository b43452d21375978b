"""The port's expert-indexed decode+matmul (ops/moe_matmul.py) against the
JAX package's Pallas MoE kernels, run in interpret mode as the JAX tests
run them: K4 (``_make_moe_kernel``) under both grid orders, the forced
tile width and the mantissa-OR convert, and K5 (``QFA_MOE_MERGED``) at
R <= 4. Every JAX variant must give the port's one result.

On the CPU the wrapper takes the plain twin; on a card the kernel is held
against the same twin in tests/test_torch_moe_cuda.py.

Tolerances (as tests/test_torch_fused_matmul.py): products are exact in
f32, so f32 outputs differ only by summation order (1e-5 * max|ref|); a
bf16 output may differ by that plus one bf16 ulp of the element.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.ops import moe_pallas as jmp

from quip_for_all_tpu_torch.ops import moe_matmul as tmm
from quip_for_all_tpu_torch.ops.qtensor import decode_affine

from test_torch_fused_matmul import assert_close

pytestmark = pytest.mark.fast

E, Q_OUT, Q_IN, GP = 16, 256, 384, 128   # G = 48 < Gp: pad lanes exercised
RS = 1 / 3.45                            # E8P12RVQ4B default residual scale
GRID_ENV = {"default": {}, "tiles_inner": {"QFA_MOE_TILES_INNER": "1"},
            "merged": {"QFA_MOE_MERGED": "1"},
            "tn128": {"QFA_MOE_TN": "128"}, "magic": {"QFA_MAGIC_MOE": "1"}}


def _case(R, repeats, n_sets, seed):
    rng = np.random.default_rng(seed)
    planes = {f"w{i}": rng.integers(0, 1 << 32, (E, Q_OUT, GP),
                                    dtype=np.uint64)
              .astype(np.uint32).view(np.int32) for i in range(n_sets)}
    if repeats:
        eids = rng.integers(0, 3, R)          # few experts: many repeats
        eids[0] = eids[-1]
    else:
        eids = rng.permutation(E)[:R]         # distinct, shuffled
    x = rng.standard_normal((R, 8, GP)).astype(np.float32)
    x[:, :, Q_IN // 8:] = 0.0                 # zero pad lanes
    cb, ors = ("E8P12", -1.0) if n_sets == 1 else ("E8P12RVQ4B", RS)
    return planes, eids.astype(np.int32), x.reshape(R, 8 * GP), cb, ors


def _cases():
    for R, repeats in [(1, False), (2, False), (2, True), (5, False),
                       (5, True), (16, False), (16, True)]:
        for grid in ("default", "tiles_inner", "merged"):
            if grid == "merged" and R > jmp._MERGED_MAX_R:
                continue
            for n_sets in (1, 2):
                for dtype in ("float32", "bfloat16"):
                    yield R, repeats, n_sets, grid, dtype
    # tile width and convert knobs, on one batched shape
    for grid in ("tn128", "magic"):
        for n_sets in (1, 2):
            yield 5, True, n_sets, grid, "float32"


@pytest.mark.parametrize("R,repeats,n_sets,grid,dtype", list(_cases()))
def test_plain_twin_matches_pallas_moe(R, repeats, n_sets, grid, dtype,
                                       monkeypatch):
    for k in ("QFA_MOE_TILES_INNER", "QFA_MOE_MERGED", "QFA_MOE_TN",
              "QFA_MAGIC_MOE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in GRID_ENV[grid].items():
        monkeypatch.setenv(k, v)
    # the tile width is read while tracing: trace anew for every variant
    jmp._moe_call.clear_cache()
    planes, eids, x, cb, ors = _case(R, repeats, n_sets,
                                     seed=R * 10 + n_sets + repeats)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jmp.moe_fused_matmul(
        jnp.asarray(x).astype(jdt), jnp.asarray(eids),
        {k: jnp.asarray(v) for k, v in planes.items()}, cb, ors, Q_OUT)
    want = np.asarray(want.astype(jnp.float32))
    jmp._moe_call.clear_cache()

    tdt = getattr(torch, dtype)
    got = tmm.moe_fused_matmul(
        torch.from_numpy(x).to(tdt), torch.from_numpy(eids),
        [torch.from_numpy(planes[k]) for k in sorted(planes)],
        decode_affine(cb, ors), R)
    assert got.dtype == tdt and got.shape == (R, Q_OUT)
    assert_close(got.float().numpy(), want, dtype)


def test_plain_twin_equals_the_dense_kernel_per_row():
    """Row r of the MoE twin is the dense fused twin on expert eids[r] (to
    f32 sum order: the CPU's matmul blocks its sums by row count)."""
    from quip_for_all_tpu_torch.ops.fused_matmul import \
        fused_decode_matmul_ref
    planes, eids, x, cb, ors = _case(5, True, 2, seed=3)
    ps = [torch.from_numpy(planes[k]) for k in sorted(planes)]
    aff = decode_affine(cb, ors)
    xt = torch.from_numpy(x)
    got = tmm.moe_fused_matmul_ref(xt, torch.from_numpy(eids), ps, aff)
    for r, e in enumerate(eids):
        want = fused_decode_matmul_ref(xt[r:r + 1], [p[e] for p in ps], aff)
        assert_close(got[r:r + 1].numpy(), want.numpy(), "float32")


@pytest.mark.parametrize("q_out", [128, 256, 384, 512, 640, 1024, 4096,
                                   28672, 100, 200, 129])
def test_any_q_out_matches_the_jax_xla_route(q_out):
    """The port has one route at every q_out. Where the JAX package's shape
    rule (``_pick_tn``: q_out a multiple of 128) refuses its Pallas kernel,
    it takes the XLA ``_decode_rows_matmul``; the port's wrapper gives the
    same result as that route at every q_out, in f32."""
    from types import SimpleNamespace
    from quip_for_all_tpu.nn.qmoe import _decode_rows_matmul
    rng = np.random.default_rng(q_out)
    gp, R = 4, 3
    planes = {f"w{i}": rng.integers(0, 1 << 32, (4, q_out, gp),
                                    dtype=np.uint64)
              .astype(np.uint32).view(np.int32) for i in range(2)}
    eids = np.array([2, 0, 2], dtype=np.int32)
    x = rng.standard_normal((R, 8 * gp)).astype(np.float32)
    sq = SimpleNamespace(planes={k: jnp.asarray(v) for k, v in planes.items()},
                         codebook_id="E8P12RVQ4B", opt_resid_scale=RS)
    want = np.asarray(_decode_rows_matmul(sq, jnp.asarray(x),
                                          jnp.asarray(eids)))
    got = tmm.moe_fused_matmul(
        torch.from_numpy(x), torch.from_numpy(eids),
        [torch.from_numpy(planes[k]) for k in sorted(planes)],
        decode_affine("E8P12RVQ4B", RS), R)
    assert got.shape == (R, q_out)
    assert_close(got.numpy(), want, "float32")


def test_wrapper_rejects_what_the_kernel_does_not_take():
    w = torch.zeros((4, 128, 128), dtype=torch.int32)
    aff = ((0.5, -2.75),)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):        # width != 8*Gp
        tmm.moe_fused_matmul(torch.zeros(2, 512), ids, [w], aff, 2)
    with pytest.raises(TypeError):         # dtype
        tmm.moe_fused_matmul(torch.zeros(2, 1024, dtype=torch.float16),
                             ids, [w], aff, 2)
    with pytest.raises(ValueError):        # int64 ids
        tmm.moe_fused_matmul(torch.zeros(2, 1024), ids.long(), [w], aff, 2)
    with pytest.raises(ValueError):        # ids of the wrong length
        tmm.moe_fused_matmul(torch.zeros(3, 1024), ids, [w], aff, 2)
    with pytest.raises(ValueError):        # unstacked planes
        tmm.moe_fused_matmul(torch.zeros(2, 1024), ids, [w[0]], aff, 2)
    with pytest.raises(ValueError):        # more experts than the mask
        tmm.moe_fused_matmul(torch.zeros(2, 1024), ids,
                             [torch.zeros((65, 128, 128), dtype=torch.int32)],
                             aff, 2)
    with pytest.raises(ValueError):        # three plane sets
        tmm.moe_fused_matmul(torch.zeros(2, 1024), ids, [w, w, w], aff * 3,
                             2)
    with pytest.raises(ValueError):        # no row bound
        tmm.moe_fused_matmul(torch.zeros(2, 1024), ids, [w], aff, 0)
    with pytest.raises(RuntimeError):      # no kernel for this device
        tmm.moe_fused_matmul(torch.zeros(2, 1024, device="meta"),
                             ids.to("meta"), [w.to("meta")], aff, 2)


def test_cpu_tensors_take_the_plain_twin_and_count_no_launch():
    before = tmm.moe_fused_matmul.launches
    w = torch.zeros((3, 128, 128), dtype=torch.int32)
    w[1] = 0x11111111                        # every nibble of expert 1 is 1
    out = tmm.moe_fused_matmul(torch.ones(2, 1024),
                               torch.tensor([1, 0], dtype=torch.int32),
                               [w], ((0.5, -2.75),), 1)
    assert torch.equal(out[0], torch.full((128,), (0.5 - 2.75) * 1024))
    assert torch.equal(out[1], torch.full((128,), -2.75 * 1024))
    assert tmm.moe_fused_matmul.launches == before


def test_kernel_route_refuses_gradients_as_jax_does():
    """The JAX package's Pallas MoE call has no VJP: ``jax.grad`` through
    it raises NotImplementedError. The port's kernel route raises the same
    error (on the CPU here, before the device branch; on a card in
    tests/test_torch_moe_cuda.py) rather than drop the MoE branch's
    gradient."""
    import jax
    planes, eids, x, cb, ors = _case(2, False, 1, seed=1)
    jplanes = {k: jnp.asarray(v) for k, v in planes.items()}
    with pytest.raises(NotImplementedError):
        jax.grad(lambda xx: jnp.sum(jmp.moe_fused_matmul(
            xx, jnp.asarray(eids), jplanes, cb, ors, Q_OUT)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    before = tmm.moe_fused_matmul.launches
    with pytest.raises(NotImplementedError, match="matmul_impl='plain'"):
        tmm.moe_fused_matmul(xt, torch.from_numpy(eids),
                             [torch.from_numpy(planes["w0"])],
                             decode_affine(cb, ors), 2)
    assert tmm.moe_fused_matmul.launches == before


def test_plain_route_keeps_gradients_as_the_jax_xla_route():
    """``moe_fused_matmul_ref`` (``matmul_impl="plain"``) stays
    differentiable: its dx equals ``jax.grad`` of the JAX package's XLA
    route ``_decode_rows_matmul`` on the same cotangent (f32, 1e-5 of the
    max: sum order)."""
    import jax
    from types import SimpleNamespace
    from quip_for_all_tpu.nn.qmoe import _decode_rows_matmul
    planes, eids, x, cb, ors = _case(5, True, 2, seed=4)
    ct = np.random.default_rng(5).standard_normal((5, Q_OUT)).astype(
        np.float32)
    sq = SimpleNamespace(planes={k: jnp.asarray(v) for k, v in planes.items()},
                         codebook_id=cb, opt_resid_scale=ors)
    want = np.asarray(jax.grad(lambda xx: jnp.sum(
        _decode_rows_matmul(sq, xx, jnp.asarray(eids)) * ct))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tmm.moe_fused_matmul_ref(
        xt, torch.from_numpy(eids),
        [torch.from_numpy(planes[k]) for k in sorted(planes)],
        decode_affine(cb, ors))
    (out * torch.from_numpy(ct)).sum().backward()
    assert_close(xt.grad.numpy(), want, "float32")


def test_no_grad_and_frozen_inputs_keep_the_kernel_route():
    """Decode (``torch.no_grad()``, or an x that needs no gradient) takes
    the kernel route as before: the result is the twin's."""
    planes, eids, x, cb, ors = _case(5, True, 1, seed=6)
    args = (torch.from_numpy(eids), [torch.from_numpy(planes["w0"])],
            decode_affine(cb, ors))
    want = tmm.moe_fused_matmul_ref(torch.from_numpy(x), *args)
    with torch.no_grad():
        got = tmm.moe_fused_matmul(
            torch.from_numpy(x).requires_grad_(True), *args, 5)
    assert torch.equal(got, want)
    assert torch.equal(tmm.moe_fused_matmul(torch.from_numpy(x), *args, 5),
                       want)


def test_tiny_mixtral_lora_loss_raises_below_32_tokens():
    """A LoRA step on a tiny Mixtral at fewer than 32 tokens (the sparse
    route) raises instead of returning adapter gradients without the MoE
    branch; on the plain route the same loss backpropagates and the MoE
    input's adapters (attention) get gradients."""
    import quip_for_all_tpu_torch as qt
    from quip_for_all_tpu_torch.nn.lora import add_lora, \
        collect_lora_trainable
    from quip_for_all_tpu_torch.quantize.lora_train import causal_lm_loss
    # widths that are multiples of 128: the plain route takes every linear
    cfg = qt.tiny_config(arch="mixtral", hidden_size=128,
                         intermediate_size=128, num_key_value_heads=4,
                         num_local_experts=4, num_experts_per_tok=2)
    model = qt.random_quantized_model(cfg, seed=0, dtype=torch.float32,
                                      device="cpu")
    add_lora(model, rank=2, targets=("q_proj", "k_proj", "v_proj", "o_proj"),
             seed=0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 9)))                 # 2 x 8 = 16 tokens
    kw = {"compute_dtype": torch.float32}
    with pytest.raises(NotImplementedError):
        causal_lm_loss(cfg, model, ids, kw)
    loss = causal_lm_loss(cfg, model, ids, dict(kw, matmul_impl="plain"))
    loss.backward()
    flat = collect_lora_trainable(model.layers, "layers")
    grads = {k: v.grad for k, v in flat.items()}
    assert grads and all(g is not None and torch.isfinite(g).all()
                         for g in grads.values())
    # B starts at 0, so dB carries the loss: nonzero in every adapter
    assert all(float(g.abs().max()) > 0 for k, g in grads.items()
               if k.endswith("B"))
