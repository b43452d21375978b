"""Rules of the port that no parity test sees: it imports neither JAX nor
the JAX package, its entry points refuse to run without a card unless
asked for the CPU, and its random model holds valid E8P12 words."""
import ast
import os

import numpy as np
import pytest
import torch

import quip_for_all_tpu_torch as qt
from quip_for_all_tpu_torch.ops.dequant import nibble_planes
from quip_for_all_tpu_torch.utils.random_quantized import random_e8p_planes

pytestmark = pytest.mark.fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    pkg = os.path.join(REPO, "quip_for_all_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    # run on the card's machine, which has no JAX
    yield os.path.join(REPO, "tests", "test_torch_kernel_cuda.py")
    yield os.path.join(REPO, "tests", "test_torch_moe_cuda.py")
    yield os.path.join(REPO, "tests", "test_torch_rowpair_cuda.py")
    yield os.path.join(REPO, "tests", "test_torch_layout_cuda.py")
    yield os.path.join(REPO, "tests", "test_torch_k3_cuda.py")
    yield os.path.join(REPO, "tests", "test_torch_microbench_cuda.py")
    yield os.path.join(REPO, "tests", "test_torch_serving_cuda.py")
    yield os.path.join(REPO, "tests", "test_torch_right_cuda.py")
    yield os.path.join(REPO, "tests", "test_torch_quantize_cuda.py")


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax_and_no_jax_package():
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    # the LoRA slice's modules are among those scanned
    for mod in ("nn/lora.py", "quantize/lora_train.py", "cli/finetune_lora.py",
                "data/calibration.py", "utils/safetensors_io.py",
                "ops/fused_matmul.py",
                # the microbenchmarks
                "tools/_timing.py", "tools/microbench_kernel.py",
                "tools/microbench_decode.py", "tools/microbench_split.py",
                "tools/microbench_tn.py", "tools/microbench_bfp.py",
                # the serving path
                "runtime/graphs.py", "runtime/serving.py", "cli/generate.py",
                "cli/eval_ppl.py",
                # the registry and the other families
                "models/registry.py", "models/tree.py", "models/gpt2.py",
                "models/gpt_neox.py", "models/opt.py", "models/falcon.py",
                "models/phi.py", "models/gptj.py", "models/qwen.py",
                "quantize/quantizer.py",
                # quantization
                "codebooks/base.py", "quantize/hessian.py",
                "quantize/ldlq.py", "quantize/quip.py",
                "quantize/finetune.py", "utils/hf_import.py",
                "cli/quantize.py"):
        assert os.path.join("quip_for_all_tpu_torch", mod) in scanned, mod
    bad = []
    for path in _port_sources():
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "quip_for_all_tpu", "flax"):
                bad.append((os.path.relpath(path, REPO), name))
    assert not bad, bad


def test_port_keeps_its_own_assets():
    pkg = os.path.join(REPO, "quip_for_all_tpu_torch")
    assert os.path.isfile(os.path.join(pkg, "transforms",
                                       "_hadamard_asset.npz"))
    for src in ("nibble_decode.cuh", "fused_decode_matmul.cu",
                "moe_decode_matmul.cu", "rowpair_decode_matmul.cu",
                "bfp_decode_matmul.cu", "sw_decode_matmul.cu",
                "ksplit_decode_matmul.cu", "paired_decode_matmul.cu",
                "fused_decode_matmul_bwd.cu", "mb_kernel.cu", "mb_tn.cu",
                "mb_decode.cu", "mb_bfp_probe.cu", "nibble_mma.cuh",
                "fused_decode_matmul_tc.cu"):
        assert os.path.isfile(os.path.join(pkg, "csrc", src))


@pytest.mark.parametrize("entry", ["random", "random_u3", "random_mixtral",
                                   "generate", "load", "load_pb", "convert",
                                   "caches", "from_raw_idxs",
                                   "from_checkpoint_idxs", "random_paired",
                                   "train_lora", "load_lora", "import_peft",
                                   "cli_finetune_lora", "microbench_kernel",
                                   "microbench_decode", "microbench_split",
                                   "microbench_tn", "microbench_bfp",
                                   "generate_stream", "perplexity",
                                   "serving", "caches_int8", "cli_generate",
                                   "cli_eval_ppl", "random_family",
                                   "generate_family", "init_llama",
                                   "init_family", "quantize_layer",
                                   "pack_to_qlinear", "quantize_model",
                                   "quantize_model_to_card",
                                   "load_hf_model", "cli_quantize",
                                   "cli_quantize_hf"])
def test_entry_points_default_to_the_card(entry, monkeypatch, tmp_path):
    """Called without device=, every entry point raises on a machine with
    no CUDA — never a silent fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = qt.tiny_config()
    from quip_for_all_tpu_torch.quantize import lora_train
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "random":
            qt.random_quantized_model(cfg)
        elif entry == "random_u3":
            qt.random_quantized_model(cfg, layout="u3")
        elif entry == "random_family":
            qt.random_quantized_model(qt.tiny_config(
                arch="gpt_neox", num_key_value_heads=4))
        elif entry == "generate_family":
            gcfg = qt.tiny_config(arch="gpt2", num_key_value_heads=4,
                                  tie_word_embeddings=True)
            model = qt.random_quantized_model(gcfg, device="cpu")
            qt.generate(gcfg, model, torch.zeros((1, 3), dtype=torch.long),
                        2)
        elif entry == "random_mixtral":
            qt.random_quantized_model(qt.tiny_config(
                arch="mixtral", num_local_experts=4))
        elif entry == "generate":
            model = qt.random_quantized_model(cfg, device="cpu")
            qt.generate(cfg, model, torch.zeros((1, 3), dtype=torch.long), 2)
        elif entry == "load":
            qt.load_quantized(os.path.join(REPO, "tests", "golden", "e8p12"))
        elif entry == "load_pb":
            qt.load_quantized(os.path.join(REPO, "tests", "golden",
                                           "e8p12rvq4b"), layout="pb")
        elif entry == "convert":
            qt.from_jax_params({"embed_tokens": {"weight": np.zeros((2, 2))}})
        elif entry in ("from_raw_idxs", "from_checkpoint_idxs"):
            from quip_for_all_tpu_torch.codebooks import get_codebook
            from quip_for_all_tpu_torch.ops import qtensor as Q
            codes = np.zeros((128, 16), dtype=np.int32)
            if entry == "from_checkpoint_idxs":
                codes = codes.astype(np.int16)
            getattr(Q, entry)(get_codebook("E8P12"), codes, 128, 128)
        elif entry == "random_paired":
            qt.random_quantized_model(cfg, "E8P12RVQ4B", layout="paired")
        elif entry == "train_lora":
            lora_train.train_lora(cfg, qt.random_quantized_model(
                cfg, device="cpu"), np.zeros((4, 9), dtype=np.int32))
        elif entry in ("load_lora", "import_peft"):
            getattr(lora_train, entry)(qt.random_quantized_model(
                cfg, device="cpu"), str(tmp_path))
        elif entry.startswith("microbench_"):
            import importlib
            importlib.import_module(
                f"quip_for_all_tpu_torch.tools.{entry}").main([])
        elif entry == "generate_stream":
            from quip_for_all_tpu_torch.runtime.generate import \
                generate_stream
            model = qt.random_quantized_model(cfg, device="cpu")
            next(generate_stream(cfg, model, torch.zeros((1, 3),
                                                         dtype=torch.long), 2))
        elif entry == "perplexity":
            from quip_for_all_tpu_torch.runtime.generate import perplexity
            perplexity(cfg, qt.random_quantized_model(cfg, device="cpu"),
                       np.zeros((1, 8), dtype=np.int64))
        elif entry == "serving":
            from quip_for_all_tpu_torch.runtime.serving import ServingEngine
            ServingEngine(cfg, qt.random_quantized_model(cfg, device="cpu"))
        elif entry == "caches_int8":
            from quip_for_all_tpu_torch.runtime.generate import \
                init_kv_caches
            init_kv_caches(cfg, 1, 8, quantized=True)
        elif entry in ("cli_generate", "cli_eval_ppl"):
            import importlib
            importlib.import_module(
                f"quip_for_all_tpu_torch.cli.{entry[4:]}").main([
                    "--model-path", os.path.join(REPO, "tests", "golden",
                                                 "e8p12"),
                    "--dataset" if entry == "cli_eval_ppl" else "--prompt",
                    "synthetic" if entry == "cli_eval_ppl" else "hi"])
        elif entry == "init_llama":
            qt.init_llama_params(cfg)
        elif entry == "init_family":
            from quip_for_all_tpu_torch.models import opt
            opt.init_opt_params(qt.tiny_config(arch="opt",
                                               num_key_value_heads=4))
        elif entry in ("quantize_layer", "pack_to_qlinear"):
            from quip_for_all_tpu_torch.codebooks import get_codebook
            from quip_for_all_tpu_torch.quantize import quip
            eye = np.eye(16, dtype=np.float32)
            args = (eye, eye, get_codebook("D4"), quip.QuantConfig(),
                    np.random.default_rng(0))
            if entry == "quantize_layer":
                quip.quantize_layer(*args)
            else:
                attrs, _ = quip.quantize_layer(*args, device="cpu")
                quip.pack_to_qlinear(attrs, get_codebook("D4"))
        elif entry == "quantize_model":
            # the user's path: a dense model made on the default device
            qt.QuipQuantizer(codebook="E8P12").quantize_model(
                cfg, qt.init_llama_params(cfg),
                np.zeros((4, 8), dtype=np.int32))
        elif entry == "quantize_model_to_card":
            # a model on the CPU sent to the card: refused, not kept there
            qt.QuipQuantizer(codebook="E8P12").quantize_model(
                cfg, qt.init_llama_params(cfg, device="cpu"),
                np.zeros((4, 8), dtype=np.int32), device="cuda")
        elif entry == "load_hf_model":
            qt.save_hf_model(cfg, qt.init_llama_params(cfg, device="cpu"),
                             str(tmp_path))
            qt.load_hf_model(str(tmp_path))
        elif entry in ("cli_quantize", "cli_quantize_hf"):
            from quip_for_all_tpu_torch.cli import quantize
            path = "random:tiny"
            if entry == "cli_quantize_hf":
                path = str(tmp_path / "hf")
                qt.save_hf_model(cfg, qt.init_llama_params(
                    cfg, device="cpu"), path)
            quantize.main(["--model-path", path, "--save-dir",
                           str(tmp_path / "out"), "--nsamples", "4",
                           "--seqlen", "8"])
        elif entry == "cli_finetune_lora":
            from quip_for_all_tpu_torch.cli import finetune_lora
            finetune_lora.main(["--model-path", os.path.join(
                REPO, "tests", "golden", "e8p12"), "--save-dir",
                str(tmp_path)])
        else:
            from quip_for_all_tpu_torch.runtime.generate import \
                init_kv_caches
            init_kv_caches(cfg, 1, 8)


def test_random_model_emits_valid_e8p_words():
    gen = torch.Generator().manual_seed(0)
    w = random_e8p_planes(256, 1024, gen, "cpu")
    assert w.dtype == torch.int32 and w.shape == (256, 128)
    nibs = torch.stack(nibble_planes(w), dim=-1).to(torch.int64)
    assert int(nibs.max()) <= 11
    # nib = 2u + 1 - parity: the low bit (1 - parity) is shared by all 8
    low = nibs & 1
    assert torch.all(low == low[..., :1])
    # and every word decodes back to an E8P12 code
    from quip_for_all_tpu_torch.ops.qtensor import QuantizedTensor, \
        to_raw_idxs
    to_raw_idxs(QuantizedTensor({"w0": w}, "E8P12", 256, 1024))


def test_random_model_is_seeded_and_fusable():
    cfg = qt.ModelConfig(vocab_size=256, hidden_size=128,
                         intermediate_size=384, num_hidden_layers=1,
                         num_attention_heads=4, num_key_value_heads=4)
    a = qt.random_quantized_model(cfg, seed=3, device="cpu",
                                  quantize_head=True)
    b = qt.random_quantized_model(cfg, seed=3, device="cpu",
                                  quantize_head=True)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    f = qt.fuse_for_inference(cfg, a)
    assert sorted(f.layers[0]["self_attn"].keys()) == ["o_proj", "qkv_proj"]
    assert sorted(f.layers[0]["mlp"].keys()) == ["down_proj", "gateup_proj"]
    assert f.layers[0]["mlp"]["gateup_proj"].right_uniform


def test_graph_runner_counts_every_kernel_wrapper():
    """A replay adds its capture's launches to the wrappers that
    ``runtime/graphs.py`` ``kernel_wrappers`` lists: every wrapper in
    ``ops/`` that counts launches must be among them, or its replayed
    launches would go uncounted."""
    import importlib
    import pkgutil
    from quip_for_all_tpu_torch import ops
    from quip_for_all_tpu_torch.runtime.graphs import kernel_wrappers
    found = set()
    for m in pkgutil.iter_modules(ops.__path__):
        mod = importlib.import_module(f"{ops.__name__}.{m.name}")
        found |= {id(f) for f in vars(mod).values()
                  if callable(f) and hasattr(f, "launches")}
    listed = {id(f) for f in kernel_wrappers().values()}
    assert found and found == listed
