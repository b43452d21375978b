"""The port's checkpoint writer, HF import/export and quantize CLI against
the JAX package's, on directories the tests write themselves:

- ``save_quantized``: every tensor of a port save is the JAX save's (name,
  dtype, shape and bytes), config.json and quantization_config.json are
  the same text, for every family (``tests/torch_family_cases.py``), for
  the five codebooks with per-channel scales and with the table
  transforms, single file and sharded;
- ``load_quantized`` of a port save of a port-quantized model equals the
  model in memory, tensor for tensor;
- ``load_hf_model`` / ``save_hf_model`` for every family: a directory the
  port writes loads in both packages to the same weights, and for llama
  and Mixtral the port writes what the JAX package's ``save_hf_model``
  writes; a path that is not a local directory raises;
- ``cli.quantize --model-path random:tiny --device cpu`` writes what the
  JAX CLI writes.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quip_for_all_tpu.codebooks import get_codebook as jget_codebook
from quip_for_all_tpu.models import llama as JL
from quip_for_all_tpu.models.config import tiny_config as jtiny
from quip_for_all_tpu.ops.qtensor import from_raw_idxs as jfrom_raw
from quip_for_all_tpu.quantize.quantizer import sublayer_groups
from quip_for_all_tpu.utils import checkpoint as jckpt
from quip_for_all_tpu.utils import hf_import as jhf
from quip_for_all_tpu.utils.random_quantized import random_qlinear

import quip_for_all_tpu_torch as qt
from quip_for_all_tpu_torch.data.calibration import synthetic_tokens
from quip_for_all_tpu_torch.models import registry as TR
from quip_for_all_tpu_torch.models.config import tiny_config
from quip_for_all_tpu_torch.models.tree import get_path, set_path
from quip_for_all_tpu_torch.nn.qlinear import QuantLinear
from quip_for_all_tpu_torch.utils import checkpoint as tckpt
from quip_for_all_tpu_torch.utils import hf_import as thf
from quip_for_all_tpu_torch.utils.convert import from_jax_params
from quip_for_all_tpu_torch.utils.safetensors_io import load_file, read_header

import torch_family_cases as fc

pytestmark = pytest.mark.fast


@pytest.fixture(autouse=True)
def one_thread():
    """Many small tensor ops (an LDLQ loop): one thread a test worker, so
    that a parallel test run does not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

QCFG = {"quant_method": "QUiP", "rescale_WH": False, "use_rand": True,
        "codebook": "E8P12", "codesz": 8, "idx_dtype": "torch.int16",
        "merge_suv": False, "per_channel": False, "opt_resid_scale": -1.0,
        "modules_to_not_convert": None, "tp_shards": 1}


def _same_dirs(a, b, close=()):
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b))
    for fn in files:
        pa, pb = os.path.join(a, fn), os.path.join(b, fn)
        if fn.endswith(".json"):
            with open(pa) as f, open(pb) as g:
                assert f.read() == g.read(), fn
            continue
        ha, _ = read_header(pa)
        hb, _ = read_header(pb)
        assert sorted(ha) == sorted(hb), fn
        ta, tb = load_file(pa), load_file(pb)
        for k in ha:
            assert ha[k]["dtype"] == hb[k]["dtype"], k
            assert ta[k].shape == tb[k].shape, k
            if k.endswith(close):
                np.testing.assert_allclose(tb[k], ta[k], rtol=1e-6, atol=0)
            else:
                assert ta[k].tobytes() == tb[k].tobytes(), k


def _qcfg(codebook, **kw):
    cb = jget_codebook(codebook)
    return dict(QCFG, codebook=cb.id, codesz=cb.codesz,
                idx_dtype=f"torch.{cb.idx_dtype.name}", **kw)


@pytest.mark.parametrize("family", sorted(fc.FAMILIES))
def test_save_quantized_is_the_jax_save(family, tmp_path):
    jcfg, jp, tcfg, tm = fc.case(family)
    jckpt.save_quantized(jcfg, jp, QCFG, str(tmp_path / "jax"))
    tckpt.save_quantized(tcfg, tm, QCFG, str(tmp_path / "port"))
    _same_dirs(str(tmp_path / "jax"), str(tmp_path / "port"))


def _random_codes(cb, q_out, q_in, rng):
    n = q_in // cb.codesz
    if cb.id == "E8P12":
        return rng.integers(0, 1 << 16, (q_out, n))
    if cb.id == "E8P12RVQ4B":
        return rng.integers(0, 1 << 32, (q_out, n)).astype(np.uint32).view(
            np.int32)
    if cb.id == "E8P12RVQ3B":
        return rng.integers(0, 1 << 24, (q_out, n)).astype(np.int32)
    return rng.integers(0, 256 if cb.id == "D4" else 16, (q_out, n)
                        ).astype(np.int32)


def _llama_tree(codebook, per_channel, use_rand, seed=0):
    """A tiny JAX llama tree, every linear of the sublayer groups and the
    head quantized with valid random codes of ``codebook``."""
    cfg = jtiny(num_key_value_heads=4)
    cb = jget_codebook(codebook)
    rng = np.random.default_rng(seed)
    params = JL.init_llama_params(cfg, seed=seed)

    def q(lin):
        out_f, in_f = lin["weight"].shape
        p = random_qlinear(cb, in_f, out_f, rng, use_rand=use_rand,
                           dtype=jnp.float32)
        p = dataclasses.replace(p, qweight=jfrom_raw(
            cb, _random_codes(cb, p.q_out, p.q_in, rng), p.q_out, p.q_in,
            layout="nibble"))
        if per_channel:
            p = dataclasses.replace(p, per_channel=True, Wscale=jnp.asarray(
                rng.uniform(0.5, 1.5, p.q_out).astype(np.float32)))
        return p
    for blk in params["layers"]:
        for g in sublayer_groups(cfg):
            for path in g["layers"]:
                set_path(blk, path, q(get_path(blk, path)))
    params["lm_head"] = q(params["lm_head"])
    return cfg, params


@pytest.mark.parametrize("codebook,per_channel,use_rand", [
    ("E8P12", True, True), ("E8P12", False, False), ("D4", False, True),
    ("HI", True, True), ("E8P12RVQ3B", False, True),
    ("E8P12RVQ4B", True, False)])
def test_save_quantized_codebooks(codebook, per_channel, use_rand,
                                  tmp_path):
    jcfg, jp = _llama_tree(codebook, per_channel, use_rand)
    tcfg = tiny_config(num_key_value_heads=4)
    tm = from_jax_params(jp, "cpu", tcfg)
    qcfg = _qcfg(codebook, per_channel=per_channel, use_rand=use_rand)
    jckpt.save_quantized(jcfg, jp, qcfg, str(tmp_path / "jax"))
    tckpt.save_quantized(tcfg, tm, qcfg, str(tmp_path / "port"))
    _same_dirs(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_sharded_save_is_the_jax_save(tmp_path):
    jcfg, jp = _llama_tree("E8P12", False, True)
    tcfg = tiny_config(num_key_value_heads=4)
    tm = from_jax_params(jp, "cpu", tcfg)
    jckpt.save_quantized(jcfg, jp, QCFG, str(tmp_path / "jax"),
                         max_shard_size="60KB")
    tckpt.save_quantized(tcfg, tm, QCFG, str(tmp_path / "port"),
                         max_shard_size="60KB")
    assert "model.safetensors.index.json" in os.listdir(tmp_path / "port")
    _same_dirs(str(tmp_path / "jax"), str(tmp_path / "port"))
    # a later single-file save over it leaves no stale shard behind
    tckpt.save_quantized(tcfg, tm, QCFG, str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == [
        "config.json", "model.safetensors", "quantization_config.json"]


@pytest.mark.parametrize("arch,per_channel", [("llama", False),
                                              ("gpt_neox", False),
                                              ("llama", True)])
def test_load_of_a_port_save_equals_the_model(arch, per_channel, tmp_path):
    """Equal tensor for tensor; a per-channel scale is stored times its
    mean and normalized again at load, so there Wscale and wscale_float
    hold to 1e-6 relative (as in the JAX package)."""
    ckw = {} if arch == "llama" else {"num_key_value_heads": 4}
    cfg = tiny_config(arch=arch, **ckw)
    model = (TR.get_arch(cfg).init_llama_params(cfg, device="cpu")
             if arch == "llama" else
             TR.get_arch(cfg).init_gpt_neox_params(cfg, device="cpu"))
    q = qt.QuipQuantizer(codebook="E8P12", nsamples=8, batch_size=4,
                         quip_tune_iters=0, per_channel=per_channel,
                         quantize_lm_head=True)
    model = q.quantize_model(
        cfg, model, synthetic_tokens(8, 16, cfg.vocab_size, seed=1))
    qt.save_quantized(cfg, model, q.to_dict(), str(tmp_path))
    cfg2, loaded, qcfg = qt.load_quantized(str(tmp_path), device="cpu")
    assert cfg2 == cfg and qcfg == q.to_dict()
    a, b = model.state_dict(), loaded.state_dict()
    assert list(a) == list(b)
    for k in a:
        if k.endswith("Wscale"):
            torch.testing.assert_close(b[k], a[k], rtol=1e-6, atol=0)
        else:
            assert torch.equal(a[k], b[k]), k
    for (n, x), (_, y) in zip(model.named_modules(), loaded.named_modules()):
        if isinstance(x, QuantLinear):
            assert (x.per_channel, x.K_left, x.K_right) == (
                y.per_channel, y.K_left, y.K_right), n
            assert y.wscale_float == pytest.approx(
                x.wscale_float, rel=1e-6 if per_channel else 0), n


@pytest.mark.parametrize("family", sorted(fc.FAMILIES) + ["llama",
                                                          "mixtral"])
def test_hf_import_agrees_with_jax(family, tmp_path):
    if family in ("llama", "mixtral"):
        kw = {"num_local_experts": 4} if family == "mixtral" else {}
        tcfg = tiny_config(arch=family, **kw)
    else:
        tcfg = fc.configs(family)[1]
    init = (TR.get_arch(tcfg).init_llama_params
            if tcfg.arch in ("llama", "mixtral", "baichuan") else getattr(
                TR.get_arch(tcfg), f"init_{tcfg.arch}_params"))
    model = init(tcfg, seed=2, device="cpu")
    d = str(tmp_path / "hf")
    thf.save_hf_model(tcfg, model, d)
    cfg_t, got = thf.load_hf_model(d, device="cpu")
    cfg_j, jparams = jhf.load_hf_model(d)
    # QWen's HF config implies its qkv bias (attention_bias reads True)
    assert cfg_t == dataclasses.replace(
        tcfg, attention_bias=cfg_t.attention_bias if tcfg.arch == "qwen"
        else tcfg.attention_bias)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    want = from_jax_params(jparams, "cpu", tcfg)
    for ref in (want, model):
        a, b = ref.state_dict(), got.state_dict()
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    if family in ("llama", "mixtral"):
        jcfg = jtiny(arch=family, **kw)
        jhf.save_hf_model(jcfg, JL.init_llama_params(jcfg, seed=2),
                          str(tmp_path / "jax"))
        ta = load_file(os.path.join(d, "model.safetensors"))
        tb = load_file(str(tmp_path / "jax" / "model.safetensors"))
        assert sorted(ta) == sorted(tb)
        for k in ta:
            assert ta[k].tobytes() == tb[k].tobytes(), k


def test_hf_import_is_local_only(tmp_path):
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        thf.load_hf_model("meta-llama/Llama-2-7b-hf", device="cpu")
    with pytest.raises(FileNotFoundError, match="not a local directory"):
        thf.load_hf_model(str(tmp_path / "missing"), device="cpu")


def test_cli_quantize_writes_the_jax_files(tmp_path):
    """The same files, names, dtypes and shapes; every tensor's bytes
    equal except Wscale, which the two packages reduce in other orders
    (within 1e-6 relative, the rule of ``quantize_layer``'s test); with
    ``--tp-shards 2`` too (block-diagonal transforms, ``tp_shards`` in
    the config). ``--ft-pp 2`` with a finetune runs on two ranks
    (``tests/test_torch_ft_pp.py``); in a process of no group and no
    torchrun environment it says so."""
    from quip_for_all_tpu.cli import quantize as jcli
    from quip_for_all_tpu_torch.cli import quantize as tcli
    args = ["--model-path", "random:tiny", "--nsamples", "8", "--seqlen",
            "32", "--batch-size", "4", "--quip-tune-iters", "1",
            "--seed", "1"]
    jcli.main(args + ["--save-dir", str(tmp_path / "jax")])
    tcli.main(args + ["--save-dir", str(tmp_path / "port"), "--device",
                      "cpu"])
    _same_dirs(str(tmp_path / "jax"), str(tmp_path / "port"),
               close=("Wscale",))
    tp = ["--tp-shards", "2"]
    jcli.main(args + tp + ["--save-dir", str(tmp_path / "jax2")])
    tcli.main(args + tp + ["--save-dir", str(tmp_path / "port2"),
                           "--device", "cpu"])
    _same_dirs(str(tmp_path / "jax2"), str(tmp_path / "port2"),
               close=("Wscale",))
    assert tckpt.load_quant_config(str(tmp_path / "port2"))[
        "tp_shards"] == 2
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        tcli.main(args + ["--save-dir", str(tmp_path / "x"), "--device",
                          "cpu", "--ft-pp", "2", "--ft-epochs", "1"])
