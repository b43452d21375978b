"""The serving path on a card: ``generate``'s decode steps replayed as CUDA
graphs (one per attention bucket) against the same step body run eagerly,
the graphs' launch counts (the wrappers' counts against the kernels a
profiler trace sees), seeded sampling, a capture that must fail, and
``ServingEngine`` on the card against the engine on the CPU. This file
imports neither JAX nor the JAX package (the card's machine has no JAX),
so it runs there without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_serving_cuda.py

Without a card every test skips. Graphed and eager loops run the same
kernels in the same order on the same card, so their ids and logits are
held bit for bit; the card against the CPU (f32, tiny model) holds ids.
"""
import copy

import numpy as np
import pytest
import torch

import quip_for_all_tpu_torch as qt
from quip_for_all_tpu_torch.runtime import generate as G
from quip_for_all_tpu_torch.runtime.graphs import StepRunner, kernel_wrappers
from quip_for_all_tpu_torch.runtime.serving import ServingEngine
from quip_for_all_tpu_torch.tools._timing import traced_launches

pytestmark = [pytest.mark.fast, pytest.mark.cuda]

DIMS = dict(vocab_size=256, hidden_size=128, intermediate_size=384,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=2048)


@pytest.fixture(scope="module")
def models():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = qt.ModelConfig(**DIMS)
    cpu = qt.fuse_for_inference(cfg, qt.random_quantized_model(
        cfg, seed=0, dtype=torch.float32, quantize_head=True, device="cpu"))
    return cfg, cpu, copy.deepcopy(cpu).to("cuda")


def _run(cfg, model, graphs, prompt, new, **kw):
    kw = dict(dict(cache_len=64, dtype=torch.float32), **kw)
    return G._generate(cfg, model, prompt, new, device="cuda",
                       return_logits=True, graphs=graphs, **kw)


@pytest.mark.parametrize("kv_quantized", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 2])
def test_graphed_loop_equals_eager_loop_bitwise(models, B, dtype,
                                                kv_quantized):
    cfg, _, gpu = models
    prompt = torch.from_numpy(np.random.default_rng(B).integers(
        0, 256, (B, 12))).cuda()
    a, la, ra = _run(cfg, gpu, True, prompt, 10, dtype=dtype,
                     kv_quantized=kv_quantized)
    b, lb, rb = _run(cfg, gpu, False, prompt, 10, dtype=dtype,
                     kv_quantized=kv_quantized)
    assert ra.replays == 9 and ra.captures == 1 and rb.captures == 0
    assert torch.equal(a, b)
    assert torch.equal(torch.stack(la), torch.stack(lb))


def test_one_graph_per_bucket_touched(models):
    """cache_len 1024, prompt 250, 12 new: buckets 256 and 512."""
    cfg, _, gpu = models
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (1, 250))).cuda()
    out, _, runner = _run(cfg, gpu, True, prompt, 12, cache_len=1024)
    assert sorted(runner.graphs) == [256, 512]
    assert runner.captures == runner.warmups == 2 and runner.replays == 11
    ref, _, _ = _run(cfg, gpu, False, prompt, 12, cache_len=1024)
    assert torch.equal(out, ref)


def test_launch_counts_add_replays(models):
    """K1's count after a graphed generate: the prefill, each warm-up
    step and each replayed step, (4 layers' linears + head) apiece."""
    cfg, _, gpu = models
    k1 = kernel_wrappers()["fused_decode_matmul"]
    per_step = 4 * cfg.num_hidden_layers + 1
    before = k1.launches
    _, _, runner = _run(cfg, gpu, True, torch.arange(12)[None].cuda(), 10)
    assert k1.launches - before == per_step * (1 + runner.warmups
                                               + runner.replays)


def test_trace_sees_the_counted_launches(models, tmp_path):
    """The kernels a profiler trace sees ran on the card equal what the
    wrappers counted, replays included: a graphed generate (K1 at m = 1)
    and a serving run (prefill chunks of 2 x 32 rows on K2, decode steps
    of 2 rows on K1)."""
    cfg, _, gpu = models
    wrappers = kernel_wrappers()
    made = {}

    def traced(fn):
        before = {k: f.launches for k, f in wrappers.items()}
        seen = traced_launches(fn, str(tmp_path / "trace.json"))
        return seen, {k: wrappers[k].launches - before[k] for k in seen}

    def generate():
        made["runner"] = _run(cfg, gpu, True, torch.arange(12)[None].cuda(),
                              10)[2]

    def serve():
        eng = made["engine"] = ServingEngine(
            cfg, gpu, max_batch=2, cache_len=64, dtype=torch.float32,
            prefill_chunk=32, decode_chunk=4, device="cuda")
        for n in (20, 40):
            eng.add_request(np.arange(n) % 256, 6)
        eng.run()
    seen, counted = traced(generate)
    assert made["runner"].replays == 9
    assert seen == counted and counted["fused_decode_matmul"] > 0
    seen, counted = traced(serve)
    assert made["engine"].runner.replays > 0
    assert seen == counted
    assert counted["fused_decode_matmul"] > 0
    assert counted["fused_decode_matmul_tc"] > 0


def test_same_seed_same_sampled_ids(models):
    cfg, _, gpu = models
    prompt = torch.arange(12)[None].cuda()

    def run(seed):
        return qt.generate(cfg, gpu, prompt, 12, generator=torch.Generator(
            "cuda").manual_seed(seed), temperature=0.8, top_k=20,
            cache_len=64, dtype=torch.float32)
    assert torch.equal(run(3), run(3))
    assert run(3).shape == (1, 24)


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_serving_on_card_matches_cpu(models, kv_quantized):
    cfg, cpu, gpu = models
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n) for n in (5, 17, 30, 9)]
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, "cuda")):
        eng = ServingEngine(cfg, model, max_batch=2, cache_len=64,
                            dtype=torch.float32, prefill_chunk=8,
                            decode_chunk=4, device=dev,
                            kv_quantized=kv_quantized,
                            linear_kw={"compute_dtype": torch.float32})
        rids = [eng.add_request(p, 7) for p in prompts]
        res = eng.run()
        outs.append([res[r] for r in rids])
        if dev == "cuda":
            assert eng.runner.captures >= 2 and eng.runner.replays > 0
    for a, b in zip(*outs):
        assert np.array_equal(a, b)


def test_failed_capture_raises(models):
    buf = torch.zeros((), device="cuda")
    runner = StepRunner(torch.device("cuda"), [buf])

    def body():
        buf.add_(1)
        if buf.item() > 1e9:      # a host read: not capturable
            buf.zero_()
    with pytest.raises(RuntimeError):
        runner.run("k", body, 2)
